"""The port's convex placement tier against the reference's, on the CPU.

Kernel level: the plain `convex.convex_eval` (the plain version of
csrc/convex_solve.cu plus the torch rounding, verdict, greedy baseline
and selection) against the reference's jitted `convex_eval` on XLA's CPU
backend, on tests/test_convex.py's fuzzed clusters, bench.py
`_convex_run`'s fragmented cluster at 2,000 nodes, a quota budget,
distinct hosts, an affinity boost, count 0 and a count above capacity, a
homogeneous fleet and tolerances down to 1e-9. Tolerances: placements,
fit verdicts and convex_won equal; iterations equal at tolerances >=
1e-6; the objective gap within atol 1e-6 (both sides sum in float32 in
different orders: XLA's blocked reduction against the kernel's cluster
tree, so the gap's last bits differ; below float32 noise, at 1e-9, the
iteration count may differ too, ROADMAP Queue 3).

Scheduler level: one eval through the reference's Harness and the
port's (`use_device("cpu")`), every id from a seeded `os.urandom` so both
sides mint the same ones, under scheduler_algorithm "convex": alloc maps,
the plan's fit verdict, the convex gauges and counters, and explain
records equal (a second task group declining on both sides); the kill
switch and the NOMAD_SOLVER_CONVEX force; the declines (cache disabled)
placing classically on both sides; the namespace quota; one device
round trip per convex eval; and a fault at `solver.dispatch.convex`,
which the port raises (counted, fed to the breaker) where the reference
demotes to the classic ladder.
"""
import random
import types

import jax
import numpy as np
import pytest
import torch

import nomad_tpu.faults as ref_faults
import nomad_tpu.mock as ref_mock
import nomad_tpu.structs as ref_structs
from nomad_tpu.metrics import metrics as ref_metrics
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.scheduler import new_scheduler as ref_new_scheduler
from nomad_tpu.solver import backend as ref_backend
from nomad_tpu.solver import convex as ref_convex
from nomad_tpu.solver import explain as ref_explain
from nomad_tpu.solver import kernels as ref_kernels
from nomad_tpu.solver import microbatch as ref_microbatch
from nomad_tpu.solver import state_cache as ref_cache

import nomad_tpu_torch.faults as port_faults
import nomad_tpu_torch.mock as port_mock
import nomad_tpu_torch.structs as port_structs
from nomad_tpu_torch.faults import FaultError
from nomad_tpu_torch.metrics import metrics as port_metrics
from nomad_tpu_torch.scheduler import Harness as PortHarness
from nomad_tpu_torch.scheduler import new_scheduler as port_new_scheduler
from nomad_tpu_torch.solver import backend as port_backend
from nomad_tpu_torch.solver import convex, cuda_kernels, kernels
from nomad_tpu_torch.solver import explain as port_explain
from nomad_tpu_torch.solver import state_cache as port_cache
from nomad_tpu_torch.solver.device import use_device
from nomad_tpu_torch.solver.kernels import NUM_XR
from nomad_tpu_torch.testing import (
    CONVEX_CASES, convex_case, convex_fixture, convex_fuzz_cluster,
    seeded_urandom,
)

REF = types.SimpleNamespace(
    mock=ref_mock, structs=ref_structs, metrics=ref_metrics,
    Harness=RefHarness, new_scheduler=ref_new_scheduler,
    explain=ref_explain, backend=ref_backend, cache=ref_cache,
    faults=ref_faults)
PORT = types.SimpleNamespace(
    mock=port_mock, structs=port_structs, metrics=port_metrics,
    Harness=PortHarness, new_scheduler=port_new_scheduler,
    explain=port_explain, backend=port_backend, cache=port_cache,
    faults=port_faults)
SIDES = (REF, PORT)

GAP_ATOL = 1e-6         # float32 sums in two orders (module docstring)
GAP_RTOL = 1e-6
# and, at equal iteration counts, within GAP_ULPS units in the last place
# of the final objective f_new, scaled as the gap is: the gap is
# |f_old - f_new| / (1 + |f_new|), and each objective is a float32 sum
# whose last bits follow the order of summation (up to 4 units apart on
# these fixtures)
GAP_ULPS = 4


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("NOMAD_SOLVER_CONVEX", raising=False)
    monkeypatch.delenv("NOMAD_STATE_CACHE", raising=False)
    monkeypatch.delenv("NOMAD_EXPLAIN", raising=False)
    prev, threads = use_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    ref_microbatch.reset()
    for side in SIDES:
        side.faults.clear()
        side.backend.reset()
        side.cache.reset()
        side.explain.configure(enabled=None)
        side.explain.reset()
    yield
    for side in SIDES:
        side.faults.clear()
        side.backend.reset()
        side.cache.reset()
        side.explain.configure(enabled=None)
        side.explain.reset()
    ref_microbatch.reset()
    torch.set_num_threads(threads)
    use_device(prev)


# ------------------------------------------------------ the solve itself

_REF_FNS: dict = {}


def _ref_fn(spread: bool):
    fn = _REF_FNS.get(spread)
    if fn is None:
        fn = _REF_FNS[spread] = jax.jit(lambda *a: ref_convex.convex_eval(
            *a, spread_algorithm=spread, n_classes=0))
    return fn


def _args(cap, used, feasible, coll, ask, count, *, fairness=0.05,
          budget=float(2 ** 30), max_iters=200, tol=1e-4, mpn=2 ** 30,
          aff=None) -> tuple:
    b = cap.shape[0]
    aff = np.zeros(b, np.float32) if aff is None else aff
    return (cap, used, np.arange(b, dtype=np.int32), np.ones(b, bool), ask,
            np.int32(count), feasible, np.int32(mpn), aff, coll,
            np.zeros(b, np.int32), np.bool_(False), np.int32(max_iters),
            np.float32(tol), np.float32(fairness), np.float32(budget))


def _final_objective(solved, job_collisions, fairness, spread) -> float:
    """f(x) of the solve's final iterate: the f_new its gap divides by."""
    x, _, cost = solved[:3]
    return float(convex._objective(
        x, cost, convex.curvature(spread), job_collisions.to(torch.float32),
        torch.tensor(np.float32(fairness))))


def _gap_close(got_gap, want_gap, f_new) -> None:
    np.testing.assert_allclose(got_gap, want_gap, atol=GAP_ATOL,
                               rtol=GAP_RTOL)
    f = abs(np.float32(f_new))
    unit = float(np.spacing(f)) / (1.0 + float(f))
    ulps = round(abs(float(got_gap) - float(want_gap)) / unit)
    assert ulps <= GAP_ULPS, (got_gap, want_gap, f_new, ulps)


def _both(case, spread=False, **kw) -> tuple:
    """(reference's outputs, port's outputs) as numpy, one inputs set;
    the port's tuple carries its final objective f_new as a sixth
    item."""
    args = _args(*case, **kw)
    want = jax.device_get(_ref_fn(spread)(*args))
    targs = [torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
             else a for a in args]
    f_new = []

    def solve(*a, **k):
        solved = convex.convex_solve_ref(*a, **k)
        # a[4], a[10]: job_collisions, fairness_weight
        f_new.append(_final_objective(solved, a[4], a[10], spread))
        return solved
    got = convex.to_host(convex.convex_eval(
        *targs, spread_algorithm=spread, solve=solve))
    return want, got + (f_new[0],)


def _assert_parity(want, got, iterations: bool = True) -> None:
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[4] == bool(want[4])
    if iterations:
        assert got[2] == int(want[2])
    if got[2] == int(want[2]):
        _gap_close(got[3], float(want[3]), got[5])
    else:                         # below float32 noise: both loops stopped
        np.testing.assert_allclose(got[3], float(want[3]), atol=GAP_ATOL,
                                   rtol=GAP_RTOL)


@pytest.mark.parametrize("spread", [False, True],
                         ids=["binpack", "spread"])
def test_fuzzed_clusters_match_reference(spread):
    """tests/test_convex.py's acceptance differential's ten clusters."""
    rng = np.random.default_rng(20260806)
    for _ in range(10):
        case = convex_fuzz_cluster(rng)
        count = int(rng.integers(1, 80))
        want, got = _both(case, spread, count=count)
        _assert_parity(want, got)
        assert got[4], "convex lost to greedy on a fuzzed cluster"


@pytest.mark.parametrize("seed,count,fairness", [
    (7, 40, 0.05), (11, 40, 0.05), (13, 60, 2.0), (13, 60, 0.0)])
def test_fuzz_seeds_match_reference(seed, count, fairness):
    """The reference tests' other seeds: determinism (7), quota (11) and
    the fairness weight moving stacked load (13)."""
    case = convex_fuzz_cluster(np.random.default_rng(seed))
    if seed == 13:
        cap, used, _, _, ask = case
        coll = np.zeros(128, np.int32)
        coll[:64] = 6
        case = (cap, used, np.ones(128, bool), coll, ask)
    want, got = _both(case, count=count, fairness=fairness)
    _assert_parity(want, got)


@pytest.mark.parametrize("spread", [False, True],
                         ids=["binpack", "spread"])
@pytest.mark.parametrize("fairness", [0.0, 0.05, 0.5])
@pytest.mark.parametrize("tol", [1e-4, 1e-6])
def test_bench_fragmented_cluster_matches_reference(spread, fairness, tol):
    """bench.py `_convex_run`'s cluster (seed 1910) at 2,000 nodes in the
    2,048 bucket, count 3,000."""
    cap, used, feasible, coll, ask, count = convex_case(2_000, 2_048)
    want, got = _both((cap, used, feasible, coll, ask), spread,
                      count=count, fairness=fairness, tol=tol)
    _assert_parity(want, got)
    assert got[0].sum() == count


@pytest.mark.parametrize("spread", [False, True],
                         ids=["binpack", "spread"])
@pytest.mark.parametrize("fairness", [0.0, 0.05, 0.5])
def test_tolerance_below_float32_noise(spread, fairness):
    """At 1e-9 the loop runs until the objective stops moving: the same
    placements; the iteration count follows each side's sum order (2 to
    4 on either side here, equal in one of the six cells, ROADMAP Queue
    3), the gap is 0 or float32 noise."""
    cap, used, feasible, coll, ask, count = convex_case(2_000, 2_048)
    want, got = _both((cap, used, feasible, coll, ask), spread,
                      count=count, fairness=fairness, tol=1e-9)
    _assert_parity(want, got, iterations=False)
    assert 1 <= got[2] <= 200 and 1 <= int(want[2]) <= 200


def test_quota_budget_caps_the_placement():
    case = convex_fuzz_cluster(np.random.default_rng(11))
    want, got = _both(case, count=40, budget=5.0)
    _assert_parity(want, got)
    assert got[0].sum() == 5 and got[1].all()


@pytest.mark.parametrize("spread", [False, True],
                         ids=["binpack", "spread"])
def test_distinct_hosts_caps_each_node_at_one(spread):
    case = convex_fuzz_cluster(np.random.default_rng(21))
    want, got = _both(case, spread, count=70, mpn=1)
    _assert_parity(want, got)
    assert got[0].max() == 1


def test_affinity_boost_matches_reference():
    rng = np.random.default_rng(23)
    case = convex_fuzz_cluster(rng)
    aff = np.where(rng.random(128) < 0.3,
                   rng.uniform(-0.5, 0.5, 128), 0.0).astype(np.float32)
    want, got = _both(case, count=50, aff=aff)
    _assert_parity(want, got)


@pytest.mark.parametrize("count", [0, 100_000], ids=["zero", "above_cap"])
def test_count_edges_match_reference(count):
    case = convex_fuzz_cluster(np.random.default_rng(29))
    want, got = _both(case, count=count)
    _assert_parity(want, got)
    if count == 0:
        assert got[0].sum() == 0
    else:
        cap, used, feasible, _, ask = case
        u = kernels.instance_capacity(*(torch.from_numpy(a) for a in (
            cap, used, ask, feasible)))
        assert got[0].sum() == int(u.sum())


@pytest.mark.parametrize("count", [37, 129])
def test_homogeneous_fleet_breaks_ties_by_index(count):
    """Identical nodes get bit-identical iterates: the remainder goes to
    the lowest node indices, as the stable sort orders them."""
    cap = np.zeros((64, NUM_XR), np.float32)
    cap[:] = (4_000.0, 8_192.0, 500_000.0, 12_001.0, 10_000.0)
    used = np.zeros_like(cap)
    used[:, 0], used[:, 1] = 1_000.0, 2_048.0
    ask = np.zeros(NUM_XR, np.float32)
    ask[:3] = (250.0, 512.0, 300.0)
    case = (cap, used, np.ones(64, bool), np.zeros(64, np.int32), ask)
    want, got = _both(case, count=count)
    _assert_parity(want, got)
    assert got[0].sum() == count


@pytest.mark.parametrize("name", CONVEX_CASES)
def test_card_fixtures_match_reference(name):
    """The fixtures the card tests and chip_smoke.py hold the kernel to,
    plain version against the reference (iterations below 1e-6 aside)."""
    cap, used, feas, coll, ask, count, kw = convex_fixture(name)
    want, got = _both(
        (cap, used, feas, coll, ask), kw["spread_algorithm"], count=count,
        fairness=kw["fairness_weight"], budget=kw["quota_budget"],
        max_iters=kw["max_iters"], tol=kw["tolerance"],
        mpn=kw["max_per_node"], aff=kw["affinity_boost"])
    _assert_parity(want, got, iterations=kw["tolerance"] >= 1e-6)


def test_placement_objective_matches_reference():
    cap, used, feasible, coll, ask, count = convex_case(2_000, 2_048)
    want, _ = _both((cap, used, feasible, coll, ask), count=count)
    placed = np.asarray(want[0])
    greedy = np.asarray(ref_kernels.fill_greedy_binpack(
        cap, used, ask, np.int32(count), feasible, np.int32(2 ** 30)))
    for x in (placed, greedy):
        for spread in (False, True):
            w = ref_convex.placement_objective(cap, used, ask, x, coll,
                                               spread, 0.05)
            g = convex.placement_objective(cap, used, ask, x, coll,
                                           spread, 0.05)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6,
                                           atol=1e-6)


def test_kernel_wrappers_run_the_plain_version_on_cpu_tensors():
    """cuda_kernels.convex_solve and convex_eval_fused on CPU tensors are
    the plain versions, output for output."""
    cap, used, feasible, coll, ask, count = convex_case(300, 512)
    t = torch.from_numpy
    solve_args = (t(cap), t(used), t(ask), t(feasible), t(coll),
                  torch.zeros(512), count, 2 ** 30, 200, 1e-4, 0.05,
                  float(2 ** 30))
    for a, b in zip(cuda_kernels.convex_solve(*solve_args),
                    convex.convex_solve_ref(*solve_args)):
        assert torch.equal(a, b)
    args = _args(cap, used, feasible, coll, ask, count)
    targs = tuple(t(a) if isinstance(a, np.ndarray) else a for a in args)
    got = convex.to_host(cuda_kernels.convex_eval_fused(*targs))
    want = convex.to_host(convex.convex_eval(*targs))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_gather_rows_matches_reference():
    rng = np.random.default_rng(31)
    cap = rng.random((64, NUM_XR)).astype(np.float32)
    used = rng.random((64, NUM_XR)).astype(np.float32)
    idx = rng.permutation(64)[:40].astype(np.int32)
    idx = np.pad(idx, (0, 24))
    valid = np.arange(64) < 40
    want = ref_kernels.gather_rows(cap, used, idx, valid)
    got = kernels.gather_rows(*(torch.from_numpy(a) for a in (
        cap, used, idx, valid)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_greedy_fill_takes_a_device_count_without_a_host_read():
    """`_greedy_fill` takes the budget as a 0-dim int32 tensor (no host
    read) and places exactly what the host count places."""
    cap, used, feasible, _, ask, count = convex_case(300, 512)
    t = torch.from_numpy
    capacity, key = kernels._greedy_key(*kernels.score_capacity_ref(
        t(cap), t(used), t(ask), t(feasible)), 2 ** 30)
    for n in (0, 1, count, 10 ** 6):
        want = kernels._greedy_fill(capacity, key, n)
        got = kernels._greedy_fill(capacity, key,
                                   torch.tensor(n, dtype=torch.int32))
        assert torch.equal(got, want) and got.dtype == torch.int32


def test_tree_sum_is_the_kernels_order():
    """The documented order: per thread in index order, then halving over
    lanes, warps and blocks — checked against a direct loop."""
    rng = np.random.default_rng(37)
    v = rng.random(20_000).astype(np.float32)
    pad = np.zeros(3 * convex.SUM_THREADS, np.float32)
    pad[:v.size] = v
    acc = pad.reshape(3, convex.SUM_THREADS)
    part = (acc[0] + acc[1]) + acc[2]
    t = part.reshape(convex.SUM_CTAS, convex.SUM_WARPS, 32)
    for axis in (2, 1, 0):
        while t.shape[axis] > 1:
            h = t.shape[axis] // 2
            t = np.take(t, range(h), axis=axis) + \
                np.take(t, range(h, 2 * h), axis=axis)
    assert convex.tree_sum(torch.from_numpy(v)).item() == t.item()


# ------------------------------------------------ whole evals, both sides

# name -> (seed, nodes, count, cpu MHz, mem MB, prefill instances);
# "two_groups" adds a second task group, whose solve sees the first's
# placements in the plan: no resident twins, so both sides decline it
SCENARIOS = {
    "depth": (3, 24, 40, 250, 128, 0),
    "depth_prefilled": (5, 32, 60, 300, 256, 20),
    "depth_wide": (9, 40, 100, 500, 512, 30),
    "greedy": (7, 16, 1, 250, 128, 0),
    "two_groups": (11, 24, 30, 250, 128, 0),
}


def _job(side, name, count, cpu, mem, groups=1):
    job = side.mock.batch_job()
    job.id = job.name = name
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    t = tg.tasks[0]
    t.resources.cpu = cpu
    t.resources.memory_mb = mem
    t.resources.networks = []
    for i in range(1, groups):
        extra = tg.copy()
        extra.name = f"{tg.name}-{i}"
        job.task_groups.append(extra)
    return job


def _run(side, name, algorithm="convex", fault=None, **config):
    """One scenario on one side: a heterogeneous fleet, optionally a
    prefill job, then the measured eval (with `fault`, a fault plan,
    installed for it alone); every id from a seeded byte stream.
    -> (harness, job)."""
    seed, n_nodes, count, cpu, mem, prefill = SCENARIOS[name]
    with seeded_urandom(seed):
        random.seed(seed)
        rng = np.random.default_rng(seed)
        h = side.Harness()
        h.state.set_scheduler_config(
            h.get_next_index(), side.structs.SchedulerConfiguration(
                scheduler_algorithm=algorithm, **config))
        for _ in range(n_nodes):
            n = side.mock.node()
            n.node_resources.cpu.cpu_shares = int(
                rng.choice([4000, 8000, 16000]))
            n.node_resources.memory.memory_mb = int(
                rng.choice([8192, 16384, 65536]))
            n.compute_class()
            h.state.upsert_node(h.get_next_index(), n)
        jobs = [_job(side, "prefill", prefill, 700, 900)] if prefill else []
        jobs.append(_job(side, "cx-job", count, cpu, mem,
                         groups=2 if name == "two_groups" else 1))
        for job in jobs:
            h.state.upsert_job(h.get_next_index(), job)
            ev = side.structs.Evaluation(id=f"{job.id}-ev", job_id=job.id,
                                         type=job.type)
            if fault is not None and job is jobs[-1]:
                side.faults.install(fault)
            try:
                h.process(lambda s, p, j=job: side.new_scheduler(
                    j.type, s, p), ev)
            finally:
                side.faults.clear()
    return h, jobs[-1]


def _alloc_map(h, job) -> dict:
    return {a.name: a.node_id
            for a in h.state.allocs_by_job("default", job.id)}


def _counters(side, *names) -> dict:
    return {n: side.metrics.counter(f"nomad.solver.{n}") for n in names}


def _moved(side, before: dict) -> dict:
    return {n: side.metrics.counter(f"nomad.solver.{n}") - v
            for n, v in before.items()}


CVX = ("dispatch.convex", "convex.won", "convex.fell_back")


def _both_evals(name, algorithm="convex", **config) -> list:
    """[reference's, port's] eval records; the port's carries "f_new",
    the final objective of its last convex solve (the one the gap gauge
    reports)."""
    out = []
    f_new = []
    finish = convex.finish

    def spy(cap, used, ask, feasible, job_collisions, max_per_node, solved,
            fairness_weight, spread_algorithm, greedy=None):
        f_new.append(_final_objective(solved, job_collisions,
                                      fairness_weight, spread_algorithm))
        return finish(cap, used, ask, feasible, job_collisions,
                      max_per_node, solved, fairness_weight,
                      spread_algorithm, greedy=greedy)
    for side in SIDES:
        side.explain.reset()
        c0 = _counters(side, *CVX)
        with pytest.MonkeyPatch.context() as mp:
            if side is PORT:
                mp.setattr(convex, "finish", spy)
            h, job = _run(side, name, algorithm, **config)
        gauges = side.metrics.snapshot()["gauges"]
        verdict = getattr(h.plans[-1], "solver_verdict", None) or {}
        out.append({
            "allocs": _alloc_map(h, job),
            "verdict": {r: a.tobytes()
                        for r, a in verdict.get("rows", {}).items()},
            "records": [{k: v for k, v in r.items() if k != "tier"}
                        for r in side.explain.recent(16)],
            "counters": _moved(side, c0),
            "iterations": gauges.get("nomad.solver.convex.iterations"),
            "gap": gauges.get("nomad.solver.convex.objective_gap"),
            "status": h.evals[-1].status,
            "f_new": f_new[-1] if f_new else None,
        })
        side.backend.reset()
        side.cache.reset()
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_convex_eval_places_what_the_reference_places(name):
    """Under "convex" the port's placements, explain records (tier
    aside), convex counters and gauges equal the reference's — and
    differ from the classic placement wherever the convex solve won
    with other nodes."""
    want, got = _both_evals(name)
    assert got["allocs"] == want["allocs"] and got["allocs"]
    assert got["status"] == want["status"] == "complete"
    # the plan carries the convex solve's fit verdict, row for row
    assert got["verdict"] == want["verdict"] and got["verdict"]
    assert got["records"] == want["records"] and got["records"]
    assert got["counters"] == want["counters"]
    assert got["counters"]["dispatch.convex"] >= 1
    if name == "two_groups":      # the second group declined, both sides
        assert got["counters"]["dispatch.convex"] == 1
    assert got["iterations"] == want["iterations"]
    _gap_close(got["gap"], want["gap"], got["f_new"])
    if name != "greedy":
        classic = _both_evals(name, algorithm="tpu-batch")[1]
        assert classic["allocs"] != got["allocs"], \
            "the scenario does not tell convex from the classic route"


def test_kill_switch_places_classically_on_both_sides():
    want, got = _both_evals("depth_prefilled", solver_convex_enabled=False)
    assert got["allocs"] == want["allocs"]
    assert got["counters"]["dispatch.convex"] == 0 == \
        want["counters"]["dispatch.convex"]
    classic = _both_evals("depth_prefilled", algorithm="tpu-batch")[1]
    assert got["allocs"] == classic["allocs"]


@pytest.mark.parametrize("force,algorithm,engages", [
    ("0", "convex", False), ("1", "tpu-batch", True)])
def test_env_force_overrides_the_algorithm(monkeypatch, force, algorithm,
                                           engages):
    monkeypatch.setenv("NOMAD_SOLVER_CONVEX", force)
    want, got = _both_evals("depth", algorithm=algorithm)
    assert got["allocs"] == want["allocs"]
    assert (got["counters"]["dispatch.convex"] > 0) is engages
    assert (want["counters"]["dispatch.convex"] > 0) is engages


def test_disabled_cache_declines_to_the_classic_route(monkeypatch):
    """No resident twins (NOMAD_STATE_CACHE=0): both sides decline the
    convex route and place as the classic route does."""
    monkeypatch.setenv("NOMAD_STATE_CACHE", "0")
    want, got = _both_evals("depth")
    assert got["allocs"] == want["allocs"]
    assert got["counters"]["dispatch.convex"] == 0 == \
        want["counters"]["dispatch.convex"]
    monkeypatch.delenv("NOMAD_STATE_CACHE")
    classic = _both_evals("depth", algorithm="tpu-batch")[1]
    assert got["allocs"] == classic["allocs"]


def test_namespace_quota_caps_the_budget_on_both_sides():
    want, got = _both_evals("depth", solver_convex_namespace_quota=25)
    assert got["allocs"] == want["allocs"]
    assert got["counters"] == want["counters"]
    free = _both_evals("depth")[1]
    assert got["allocs"] != free["allocs"]


@pytest.fixture
def card(monkeypatch):
    """The card's chain on the CPU: solves select the `cuda` tier, whose
    wrappers run their plain versions on CPU tensors."""
    monkeypatch.setattr(port_backend, "tier", lambda: "cuda")
    port_backend.reset()


def test_one_device_round_trip_per_convex_eval(card):
    """On the card's chain a convex eval touches the device once: no
    twin gather (the solve gathers behind its own launch), one solve,
    explain on the host — the reference's contract too."""
    name = "nomad.solver.device_round_trips"
    skip = [side.metrics.sample_count(name) for side in SIDES]
    want, got = _both_evals("depth")
    assert got["allocs"] == want["allocs"]
    for side, n in zip(SIDES, skip):
        assert side.metrics.sample_count(name) > n
    assert port_metrics.percentile(name, 0.0, skip=skip[1]) == 1
    assert port_metrics.percentile(name, 1.0, skip=skip[1]) == 1
    assert ref_metrics.percentile(name, 1.0, skip=skip[0]) <= 1


def test_faulted_convex_dispatch_raises_where_the_reference_demotes(
        monkeypatch):
    """Kept by rule: a device error in the convex dispatch is counted
    (`dispatch_errors.convex` and the tier's), fed to the breaker and
    raised out of the eval, with nothing committed; the reference
    demotes to its classic ladder and commits the never-convex map."""
    monkeypatch.setattr(port_backend, "BREAKER_THRESHOLD", 1)
    fault = {"solver.dispatch.convex": {"mode": "raise"}}
    h, job = _run(REF, "depth", fault=fault)
    demoted = _alloc_map(h, job)
    REF.backend.reset()
    REF.cache.reset()
    monkeypatch.setenv("NOMAD_SOLVER_CONVEX", "0")
    h, job = _run(REF, "depth")
    assert demoted == _alloc_map(h, job) and demoted
    monkeypatch.delenv("NOMAD_SOLVER_CONVEX")
    c0 = _counters(PORT, "dispatch_errors.convex", "dispatch_errors.torch",
                   "dispatch.convex")
    placed = []
    real = PORT.Harness.submit_plan

    def submit(self, plan):
        placed.extend(a for allocs in plan.node_allocation.values()
                      for a in allocs)
        return real(self, plan)
    monkeypatch.setattr(PORT.Harness, "submit_plan", submit)
    with pytest.raises(FaultError):
        _run(PORT, "depth", fault=fault)
    assert placed == [], "the faulted eval committed placements"
    assert _moved(PORT, c0) == {"dispatch_errors.convex": 1,
                                "dispatch_errors.torch": 1,
                                "dispatch.convex": 0}
    assert port_backend.breaker().state("torch") == "open"
    PORT.backend.reset()
    PORT.cache.reset()
    _run(PORT, "depth")             # healthy: the hook sees its commit
    assert len(placed) == SCENARIOS["depth"][2]


@pytest.mark.parametrize("exc", [
    cuda_kernels.KernelBuildError("nvcc exited 1"),
    ValueError("a bug in the solve")], ids=["build_error", "bug"])
def test_convex_build_error_or_bug_raises_and_feeds_nothing(card,
                                                            monkeypatch,
                                                            exc):
    """On the card's chain a kernel that does not build, or a bug, raises
    out of the convex eval untouched: no dispatch error counted, the
    breaker untouched, nothing solved another way."""
    def broken(*a, **kw):
        raise exc
    monkeypatch.setattr(cuda_kernels, "convex_eval_fused", broken)
    port_backend.reset()
    c0 = _counters(PORT, "dispatch_errors", "dispatch.convex",
                   "dispatch.torch", "dispatch.cuda")
    with pytest.raises(type(exc)):
        _run(PORT, "depth")
    assert set(_moved(PORT, c0).values()) == {0}
    assert port_backend.breaker().state("cuda") == "closed"
