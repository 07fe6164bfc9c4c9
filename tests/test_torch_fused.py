"""The port's whole-eval fused route against the reference's, on the CPU.

Kernel level: the plain `kernels.fused_eval_depth` / `fused_eval_greedy`
(what the gather entries of csrc/depth_curve.cu and csrc/
score_capacity.cu, the torch tails and csrc/fit_verdict.cu compute on a
card) against the reference's jitted programs on XLA's CPU backend, at
buckets 64 and 1,024 with the eval's rows shuffled through a larger twin
pair: dense and on the sampled grid, under the spread algorithm, with
max_per_node 1, with explain classes 0 and 4. Tolerance: none —
placements, fit verdicts and explain outputs equal exactly. A seeded row
where `used + k * ask` rounds differently as one fused multiply-add and
as a product then a sum pins the verdict's rounding to the reference's
compiled one.

Scheduler level, on seeded fleets (ids from a seeded `os.urandom`, so
both packages mint the same ones): placements with fusion on equal those
with fusion off in the port and the reference's with fusion on, at counts
1, 6 and 48, explain on and off; the pipelined lifecycle is untouched by
the knob; a fused eval on the card's chain counts one device round trip
and the unfused route more; the plan carries the verdict and the applier
takes its fast path with results equal to the unfused run's; the fused
micro-batch window coalesces and equals the direct solves; and a device
error in the fused dispatch raises out of the eval, counted and fed to
the breaker, with nothing committed and nothing solved on the CPU.
"""
import random
import threading
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
from nomad_tpu_torch.server.fsm import NomadFSM, RaftLog
from nomad_tpu_torch.server.plan_apply import Planner
from nomad_tpu_torch.solver import backend as port_backend
from nomad_tpu_torch.solver import cuda_kernels, kernels, microbatch
from nomad_tpu_torch.solver import explain as port_explain
from nomad_tpu_torch.solver import state_cache as port_cache
from nomad_tpu_torch.solver.device import use_device
from nomad_tpu_torch.solver.kernels import DEPTH_GRID, NUM_XR
from nomad_tpu_torch.testing import seeded_urandom

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


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("NOMAD_SOLVER_FUSED", "NOMAD_SOLVER_CONVEX",
                "NOMAD_STATE_CACHE", "NOMAD_EXPLAIN"):
        monkeypatch.delenv(var, raising=False)
    prev, threads = use_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    for side in SIDES:
        side.faults.clear()
        side.backend.reset()
        side.cache.reset()
        side.explain.configure(enabled=None)
        side.explain.reset()
    ref_microbatch.reset()
    microbatch.reset()
    yield
    for side in SIDES:
        side.faults.clear()
        side.backend.reset()
        side.cache.reset()
        side.explain.configure(enabled=None)
        side.explain.reset()
    ref_microbatch.reset()
    microbatch.reset()
    torch.set_num_threads(threads)
    use_device(prev)


# ------------------------------------------------- the programs themselves

def _twins(seed: int, n_res: int):
    """A resident twin pair of `n_res` rows: mixed node sizes, some rows
    part full."""
    rng = np.random.default_rng(seed)
    cap = np.zeros((n_res, NUM_XR), np.float32)
    cap[:, 0] = rng.choice([2_000, 4_000, 8_000, 16_000], n_res)
    cap[:, 1] = rng.choice([4_096, 8_192, 16_384], n_res)
    cap[:, 2] = 100_000
    cap[:, 3] = 12_001
    cap[:, 4] = 10_000
    used = (cap * rng.uniform(0.0, 0.7, (n_res, 1))).astype(np.float32)
    used[:, 2:] = 0
    return cap, used


def _eval_cols(seed: int, bucket: int, n_live: int, n_res: int):
    """One eval's columns over `bucket` rows, `n_live` of them live and
    read through a shuffled idx from the twins."""
    rng = np.random.default_rng(seed + 1)
    idx = np.zeros(bucket, np.int32)
    idx[:n_live] = rng.permutation(n_res)[:n_live]
    valid = np.zeros(bucket, bool)
    valid[:n_live] = True
    feasible = valid & (rng.random(bucket) > 0.1)
    coll = np.where(valid, rng.integers(0, 3, bucket), 0).astype(np.int32)
    aff = np.where(rng.random(bucket) < 0.3,
                   rng.uniform(-1, 1, bucket), 0).astype(np.float32)
    jitter = rng.random(bucket, dtype=np.float32)
    cls = np.where(valid, rng.integers(-1, 4, bucket), -1).astype(np.int32)
    ask = np.zeros(NUM_XR, np.float32)
    ask[:3] = (250.0, 512.0, 300.0)
    return idx, valid, ask, feasible, coll, aff, jitter, cls


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_REF_JIT: dict = {}


def _ref_fn(kernel: str, **statics):
    key = (kernel,) + tuple(sorted(statics.items()))
    fn = _REF_JIT.get(key)
    if fn is None:
        impl = (ref_kernels.fused_eval_depth if kernel == "depth"
                else ref_kernels.fused_eval_greedy)
        fn = _REF_JIT[key] = jax.jit(lambda *a: impl(*a, **statics))
    return fn


def _equal(got: tuple, want: tuple) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# name -> (bucket, live rows, twin rows, count, k_max, grid, spread,
#          max_per_node, jitter_samples)
DEPTH_CASES = {
    "dense_64": (64, 50, 80, 40, 64, False, False, 2 ** 30, 0.0),
    "grid_64": (64, 60, 64, 6, 8, True, False, 2 ** 30, 1.5),
    "spread_64": (64, 40, 100, 30, 32, False, True, 2 ** 30, 0.0),
    "mpn1_64": (64, 64, 64, 20, 8, False, False, 1, 0.0),
    "dense_1024": (1024, 1000, 1500, 2000, 128, False, False, 2 ** 30, 0.0),
    "grid_spread_1024": (1024, 700, 1024, 300, 128, True, True, 2 ** 30,
                         2.5),
}


@pytest.mark.parametrize("n_classes", [0, 4])
@pytest.mark.parametrize("name", list(DEPTH_CASES))
def test_fused_eval_depth_matches_reference(name, n_classes):
    bucket, n_live, n_res, count, k_max, on_grid, spread, mpn, samples = \
        DEPTH_CASES[name]
    cap_res, used_res = _twins(11, n_res)
    idx, valid, ask, feas, coll, aff, jitter, cls = _eval_cols(
        11, bucket, n_live, n_res)
    grid = tuple(g for g in DEPTH_GRID if g <= k_max) if on_grid else None
    args = (cap_res, used_res, idx, valid, ask, np.int32(count), feas, coll,
            np.int32(count), aff, np.int32(mpn), jitter, np.float32(1.5),
            np.float32(samples), cls, np.bool_(mpn == 1))
    want = _ref_fn("depth", k_max=k_max, spread_algorithm=spread,
                   depth_grid=grid, n_classes=n_classes)(*args)
    got = kernels.fused_eval_depth(
        *(_t(a) for a in args[:5]), count, *(_t(a) for a in args[6:8]),
        count, _t(aff), mpn, _t(jitter), 1.5, samples, _t(cls), mpn == 1,
        k_max=k_max, spread_algorithm=spread, depth_grid=grid,
        n_classes=n_classes)
    _equal(got, want)
    placed = np.asarray(want[0])
    assert 0 < placed.sum() <= count
    assert not placed[~valid].any()
    assert np.asarray(want[1])[placed > 0].all()


@pytest.mark.parametrize("n_classes", [0, 4])
@pytest.mark.parametrize("bucket,n_live,count,mpn", [
    (64, 50, 1, 2 ** 30), (64, 64, 200, 1), (1024, 900, 5000, 2 ** 30)])
def test_fused_eval_greedy_matches_reference(bucket, n_live, count, mpn,
                                             n_classes):
    cap_res, used_res = _twins(23, bucket + 40)
    idx, valid, ask, feas, coll, aff, jitter, cls = _eval_cols(
        23, bucket, n_live, bucket + 40)
    args = (cap_res, used_res, idx, valid, ask, np.int32(count), feas,
            np.int32(mpn), cls, np.bool_(mpn == 1), coll)
    want = _ref_fn("greedy", n_classes=n_classes)(*args)
    got = kernels.fused_eval_greedy(
        *(_t(a) for a in args[:5]), count, _t(feas), mpn, _t(cls), mpn == 1,
        _t(coll), n_classes=n_classes)
    _equal(got, want)
    assert 0 < np.asarray(want[0]).sum() <= count


def test_card_wrappers_run_the_plain_programs_on_cpu_tensors():
    """Given CPU tensors the card's wrappers are the plain versions; the
    gather entries' plain producers equal the classic producers on
    gather_rows' output."""
    cap_res, used_res = _twins(5, 96)
    idx, valid, ask, feas, coll, aff, jitter, cls = _eval_cols(5, 64, 60, 96)
    t = [_t(a) for a in (cap_res, used_res, idx, valid, ask, feas, coll, aff,
                         jitter, cls)]
    cr, ur, ti, tv, ta, tf, tc, taff, tj, tcls = t
    got = cuda_kernels.fused_eval_depth(cr, ur, ti, tv, ta, 20, tf, tc, 20,
                                        taff, 2 ** 30, tj, 1.0, 0.0, tcls,
                                        False, k_max=32)
    want = kernels.fused_eval_depth(cr, ur, ti, tv, ta, 20, tf, tc, 20, taff,
                                    2 ** 30, tj, 1.0, 0.0, tcls, False,
                                    k_max=32)
    _equal(got, want)
    cap, used = kernels.gather_rows(cr, ur, ti, tv)
    lanes = cuda_kernels.depth_curve_gather(
        cr, ur, ti[None], tv[None], ta[None], tf[None], tc[None], (20,),
        taff[None], (2 ** 30,), k_max=32)
    solo = kernels.depth_curve_ref(cap, used, ta, tf, tc, 20, taff, k_max=32)
    _equal([x[0] for x in lanes], solo)
    _equal(cuda_kernels.score_capacity_gather(cr, ur, ti, tv, ta, tf, 3),
           kernels._greedy_key(*kernels.score_capacity_ref(cap, used, ta,
                                                           tf), 3))
    placed = got[0]
    _equal(cuda_kernels.fit_verdict(cr, ur, ti, tv, ta, placed),
           (placed, kernels.fused_fit_verdict(cap, used, ta, placed)))
    _equal(cuda_kernels.fused_to_host(*got), [g.numpy() for g in got])


# a seeded row (float32 bits) where used + k * ask rounds to one side of
# cap + FIT_EPS as one fused multiply-add and to the other as a product
# then a sum; found by a seeded search over random rows (numpy
# default_rng(7)), kept as bits so the case never drifts
FMA_ROW = {"used": 0x451C3CDA, "ask": 0x43A1826D, "cap": 0x465CC1F0, "k": 36}


def _bits(x: int) -> np.float32:
    return np.array([x], np.uint32).view(np.float32)[0]


def test_verdict_rounds_as_the_reference_program_does():
    """The boundary row: the reference's jitted fused program (XLA's CPU
    backend contracts the verdict's multiply-add) fits it; two roundings
    would not. The port's fused verdict, its plain kernel version and the
    whole fused eval say what the reference's program says."""
    u, a, c = (_bits(FMA_ROW[k]) for k in ("used", "ask", "cap"))
    k = FMA_ROW["k"]
    assert np.float32(np.float32(k) * a) + u > c + np.float32(1e-3), \
        "two roundings must put the row over capacity"
    b = 8
    cap = np.zeros((b, NUM_XR), np.float32)
    used = np.zeros_like(cap)
    cap[:, 0] = 1.0                 # only row 3 can take an instance
    cap[:, 1:] = 1e6
    cap[3, 0], used[3, 0] = c, u
    ask = np.zeros(NUM_XR, np.float32)
    ask[0], ask[1] = a, 1.0
    idx = np.arange(b, dtype=np.int32)
    valid = np.ones(b, bool)
    placed = np.zeros(b, np.int32)
    placed[3] = k
    want = np.asarray(jax.jit(ref_kernels.plan_fit_verdict)(
        cap, used, ask, placed))
    assert want[3], "the reference's compiled verdict fits the row"
    assert not kernels.plan_fit_verdict(
        _t(cap), _t(used), _t(ask), _t(placed))[3], \
        "the eager two-rounding verdict must not"
    np.testing.assert_array_equal(
        kernels.fused_fit_verdict(_t(cap), _t(used), _t(ask),
                                  _t(placed)).numpy(), want)
    np.testing.assert_array_equal(
        kernels.fit_verdict_ref(_t(cap), _t(used), _t(idx), _t(valid),
                                _t(ask), _t(placed)).numpy(), want)
    feas = np.ones(b, bool)
    coll = np.zeros(b, np.int32)
    cls = np.zeros(b, np.int32)
    args = (cap, used, idx, valid, ask, np.int32(k), feas,
            np.int32(2 ** 30), cls, np.bool_(False), coll)
    ref = _ref_fn("greedy", n_classes=2)(*args)
    got = kernels.fused_eval_greedy(*(_t(x) for x in args[:5]), k,
                                    _t(feas), 2 ** 30, _t(cls), False,
                                    _t(coll), n_classes=2)
    _equal(got, ref)
    assert int(np.asarray(ref[0])[3]) == k and bool(np.asarray(ref[1])[3])


# --------------------------------------------------------- whole evals

def _fleet(side, h, n_nodes: int, rng) -> None:
    for i in range(n_nodes):
        n = side.mock.node()
        n.id = f"node-{i:04d}"
        n.name = f"fu-{i}"
        n.node_resources.cpu.cpu_shares = int(rng.choice([4000, 8000]))
        n.node_resources.memory.memory_mb = int(rng.choice([8192, 16384]))
        n.compute_class()
        h.state.upsert_node(h.get_next_index(), n)


def _job(side, name: str, count: int, cpu=250, mem=128):
    job = side.mock.batch_job()
    job.id = job.name = name
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    t = tg.tasks[0]
    t.resources.networks = []
    t.resources.cpu = cpu
    t.resources.memory_mb = mem
    return job


def _run(side, count: int, seed: int = 1234, n_nodes: int = 16,
         **config):
    """One seeded eval of `count` instances on one side. -> (harness,
    job)."""
    with seeded_urandom(seed):
        random.seed(seed)
        h = side.Harness()
        h.state.set_scheduler_config(
            h.get_next_index(), side.structs.SchedulerConfiguration(
                scheduler_algorithm="tpu-batch", **config))
        _fleet(side, h, n_nodes, np.random.default_rng(seed))
        job = _job(side, f"fu-job-{count}", count)
        h.state.upsert_job(h.get_next_index(), job)
        ev = side.structs.Evaluation(id=f"fu-ev-{count}", job_id=job.id,
                                     type=job.type)
        h.process(lambda s, p: side.new_scheduler(job.type, s, p), ev)
    return h, job


def _alloc_map(h, job) -> dict:
    allocs = h.state.allocs_by_job("default", job.id)
    assert len(allocs) == job.task_groups[0].count
    return {a.name: a.node_id for a in allocs}


def _c(side, name: str) -> int:
    return side.metrics.counter(name)


@pytest.mark.parametrize("explain", ["1", "0"])
@pytest.mark.parametrize("count", [1, 6, 48])
def test_fused_on_places_what_fused_off_and_the_reference_place(
        monkeypatch, count, explain):
    """Greedy (count 1), the jittered grid (6) and the dense curve (48):
    the port's fused route places exactly what its classic route places
    and what the reference's fused route places; explain records equal
    the reference's, tier aside."""
    monkeypatch.setenv("NOMAD_EXPLAIN", explain)
    f_ref = _c(REF, "nomad.solver.dispatch.fused")
    f_port = _c(PORT, "nomad.solver.dispatch.fused.torch")
    maps, records = [], []
    for side in SIDES:
        h, job = _run(side, count)
        maps.append(_alloc_map(h, job))
        records.append([{k: v for k, v in r.items() if k != "tier"}
                        for r in side.explain.recent(16)])
    assert _c(REF, "nomad.solver.dispatch.fused") > f_ref
    assert _c(PORT, "nomad.solver.dispatch.fused.torch") == f_port + 1, \
        "the port's fused route never engaged"
    assert maps[1] == maps[0]
    assert records[1] == records[0]
    assert bool(records[1]) is (explain == "1")
    PORT.cache.reset()
    PORT.backend.reset()
    monkeypatch.setenv("NOMAD_SOLVER_FUSED", "0")
    f_port = _c(PORT, "nomad.solver.dispatch.fused")
    h, job = _run(PORT, count)
    assert _c(PORT, "nomad.solver.dispatch.fused") == f_port
    assert _alloc_map(h, job) == maps[1]


def test_config_kill_switch_turns_the_route_off(monkeypatch):
    """SchedulerConfiguration.solver_fused_enabled=False: the classic
    route serves, same placements; NOMAD_SOLVER_FUSED=1 forces it back
    on over the config."""
    f0 = _c(PORT, "nomad.solver.dispatch.fused")
    h, job = _run(PORT, 6, solver_fused_enabled=False)
    assert _c(PORT, "nomad.solver.dispatch.fused") == f0
    off = _alloc_map(h, job)
    PORT.cache.reset()
    monkeypatch.setenv("NOMAD_SOLVER_FUSED", "1")
    h, job = _run(PORT, 6, solver_fused_enabled=False)
    assert _c(PORT, "nomad.solver.dispatch.fused") == f0 + 1
    assert _alloc_map(h, job) == off
    assert port_backend.fused_enabled(None) is True


def _pipelined(side, eval_id: str):
    random.seed(4321)
    with seeded_urandom(4321):
        h = side.Harness()
        h.state.set_scheduler_config(
            h.get_next_index(), side.structs.SchedulerConfiguration(
                scheduler_algorithm="tpu-batch", plan_pipeline_min_count=16,
                plan_pipeline_chunks=2))
        _fleet(side, h, 16, np.random.default_rng(4321))
        job = _job(side, "fu-pipe-job", 64, cpu=100, mem=64)
        h.state.upsert_job(h.get_next_index(), job)
        ev = side.structs.Evaluation(id=eval_id, job_id=job.id,
                                     type=job.type)
        h.process(lambda s, p: side.new_scheduler(job.type, s, p), ev)
    return _alloc_map(h, job)


def test_pipelined_route_is_untouched_by_the_fused_knob(monkeypatch):
    """The pipelined lifecycle keeps its chunked classic route with
    fusion on (it rides the resident twins through a gather at
    dispatch): no fused dispatch, placements equal with the knob off and
    to the reference's."""
    p0 = _c(PORT, "nomad.plan.pipeline.evals")
    f0 = _c(PORT, "nomad.solver.dispatch.fused")
    t0 = _c(PORT, "nomad.solver.state_cache.twin_dispatches")
    on = _pipelined(PORT, "fu-pipe-eval")
    assert _c(PORT, "nomad.plan.pipeline.evals") == p0 + 1
    assert _c(PORT, "nomad.solver.dispatch.fused") == f0
    assert _c(PORT, "nomad.solver.state_cache.twin_dispatches") > t0
    assert on == _pipelined(REF, "fu-pipe-eval")
    PORT.cache.reset()
    PORT.backend.reset()
    monkeypatch.setenv("NOMAD_SOLVER_FUSED", "0")
    assert _pipelined(PORT, "fu-pipe-eval") == on


@pytest.fixture
def card(monkeypatch):
    """The card's chain on the CPU: solves select the `cuda` tier, whose
    wrappers run their plain versions on CPU tensors."""
    monkeypatch.setattr(port_backend, "tier", lambda: "cuda")
    port_backend.reset()


def test_fused_eval_counts_one_round_trip(card):
    name = "nomad.solver.device_round_trips"
    skip = port_metrics.sample_count(name)
    f0 = _c(PORT, "nomad.solver.dispatch.fused.cuda")
    _run(PORT, 48)
    assert _c(PORT, "nomad.solver.dispatch.fused.cuda") == f0 + 1
    assert port_metrics.sample_count(name) > skip
    assert port_metrics.percentile(name, 0.0, skip=skip) == 1
    assert port_metrics.percentile(name, 1.0, skip=skip) == 1


def test_unfused_route_counts_more_round_trips(card, monkeypatch):
    """With fusion off the classic card route pays the state cache's
    gather and the solve: two round trips. (The twins live on the CPU
    here, so the cache is let gather for the card's tier.)"""
    monkeypatch.setenv("NOMAD_SOLVER_FUSED", "0")
    real = port_cache.TensorCache._device_pair_locked
    monkeypatch.setattr(port_cache.TensorCache, "_device_pair_locked",
                        lambda self, tier: real(self, ""))
    name = "nomad.solver.device_round_trips"
    skip = port_metrics.sample_count(name)
    _run(PORT, 48)
    assert port_metrics.percentile(name, 1.0, skip=skip) >= 2


class _Shim:
    """The planner interface a server worker provides, over the real
    applier applying each plan inline (a batch of one)."""

    def __init__(self, planner, state):
        self.planner, self.state = planner, state
        self.plans = []

    def submit_plan(self, plan):
        self.plans.append(plan)
        return self.planner.apply_plan(plan)

    def update_eval(self, ev):
        self.state.upsert_evals(self.state.latest_index() + 1, [ev])

    def create_eval(self, ev):
        self.state.upsert_evals(self.state.latest_index() + 1, [ev])

    def refresh_snapshot(self, old):
        return self.state.snapshot()


def _applied(count: int) -> tuple:
    """A seeded eval through the port's scheduler and its real plan
    applier. -> (alloc map, the plan's verdict rows, the store's usage
    rows of the placed nodes)."""
    with seeded_urandom(77):
        random.seed(77)
        fsm = NomadFSM()
        s = fsm.state
        s.set_scheduler_config(1, port_structs.SchedulerConfiguration(
            scheduler_algorithm="tpu-batch"))
        rng = np.random.default_rng(77)
        for i in range(16):
            n = port_mock.node()
            n.id = f"node-{i:04d}"
            n.node_resources.cpu.cpu_shares = int(rng.choice([4000, 8000]))
            n.compute_class()
            s.upsert_node(2 + i, n)
        job = _job(PORT, "fu-apply-job", count)
        s.upsert_job(s.latest_index() + 1, job)
        ev = port_structs.Evaluation(id="fu-apply-ev", namespace="default",
                                     job_id=job.id, type=job.type,
                                     priority=job.priority)
        s.upsert_evals(s.latest_index() + 1, [ev])
        shim = _Shim(Planner(RaftLog(fsm), s), s)
        port_new_scheduler(job.type, s.snapshot(), shim).process(ev)
    allocs = {a.name: a.node_id for a in s.allocs_by_job("default", job.id)}
    assert len(allocs) == count
    view = s.usage.view()
    sv = shim.plans[-1].solver_verdict or {}
    placed_rows = {view.row[nid] for nid in allocs.values()}
    return allocs, set(sv.get("rows", {})), placed_rows, view.used.tobytes()


def test_verdict_is_stamped_and_feeds_the_applier_fast_path(monkeypatch):
    """A fused eval's plan carries the verdict over its placed rows at
    the solve's journal version; the applier takes the fast path for
    them and commits what the unfused eval commits."""
    c0 = _c(PORT, "nomad.plan.verdict_fastpath")
    allocs, rows, placed_rows, usage = _applied(48)
    fast = _c(PORT, "nomad.plan.verdict_fastpath") - c0
    assert rows == placed_rows and rows
    assert fast == len(placed_rows)
    PORT.cache.reset()
    PORT.backend.reset()
    monkeypatch.setenv("NOMAD_SOLVER_FUSED", "0")
    c0 = _c(PORT, "nomad.plan.verdict_fastpath")
    assert _applied(48) == (allocs, set(), placed_rows, usage)
    assert _c(PORT, "nomad.plan.verdict_fastpath") == c0


# ------------------------------------------------------ the fused window

def _lane_args(twins, seed: int, count: int):
    idx, valid, ask, feas, coll, aff, jitter, cls = _eval_cols(
        seed, 64, 56, twins[0].shape[0])
    return twins + (idx, valid, ask, np.int32(count), feas, coll,
                    np.int32(count), aff, np.int32(2 ** 30), jitter,
                    np.float32(1.0), np.float32(0.0), cls, np.bool_(False))


def test_fused_window_coalesces_and_equals_the_direct_solves(monkeypatch):
    """Two concurrent fused depth evals over one twin pair ride ONE
    window (one lanes launch on a card); each lane's (placed, fit) equals
    its direct fused eval, the port's and the reference's."""
    monkeypatch.setattr(port_backend, "BATCH_MAX_COUNT", 64)
    cap, used = _twins(3, 80)
    twins = (_t(cap), _t(used))
    lanes = [_lane_args(twins, 30 + i, 12) for i in range(2)]
    microbatch.configure(enabled=True, window_s=0.5)
    microbatch.broker_in_flight(2)
    tier, run = port_backend.select_fused("depth", 64, count=12, k_max=16)
    assert tier == "batch"
    d0 = _c(PORT, "nomad.solver.microbatch.dispatches")
    b0 = _c(PORT, "nomad.solver.dispatch.fused.batch")
    outs, errs = [None, None], []

    def worker(i):
        try:
            outs[i] = run(*lanes[i])
        except BaseException as e:      # noqa: BLE001 — surfaced below
            errs.append(e)
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errs, errs
    assert _c(PORT, "nomad.solver.microbatch.dispatches") == d0 + 1
    assert _c(PORT, "nomad.solver.dispatch.fused.batch") == b0 + 2
    for i, out in enumerate(outs):
        args = lanes[i]
        direct = kernels.fused_eval_depth(
            *(torch.as_tensor(a) for a in args[:5]), 12,
            *(torch.as_tensor(a) for a in args[6:8]), 12,
            torch.as_tensor(args[9]), 2 ** 30, torch.as_tensor(args[11]),
            1.0, 0.0, None, False, k_max=16)
        _equal(out, direct)
        ref = _ref_fn("depth", k_max=16, spread_algorithm=False,
                      depth_grid=None, n_classes=0)(
            cap, used, *args[2:])
        _equal(out, ref)
        assert int(out[0].sum()) == 12


def test_fused_window_of_one_runs_the_solo_solve(monkeypatch):
    monkeypatch.setattr(port_backend, "BATCH_MAX_COUNT", 64)
    cap, used = _twins(4, 64)
    args = _lane_args((_t(cap), _t(used)), 40, 9)
    microbatch.configure(enabled=True, window_s=0.01)
    microbatch.broker_in_flight(2)
    _, run = port_backend.select_fused("depth", 64, count=9, k_max=16)
    s0 = _c(PORT, "nomad.solver.microbatch.solo")
    f0 = _c(PORT, "nomad.solver.dispatch.fused.torch")
    out = run(*args)
    assert _c(PORT, "nomad.solver.microbatch.solo") == s0 + 1
    assert _c(PORT, "nomad.solver.dispatch.fused.torch") == f0 + 1
    want = _ref_fn("depth", k_max=16, spread_algorithm=False,
                   depth_grid=None, n_classes=0)(cap, used, *args[2:])
    _equal(out, want)


# ---------------------------------------------------------- device errors

def test_faulted_fused_dispatch_raises_and_commits_nothing(monkeypatch,
                                                          card):
    """Kept by rule: a device error in the fused dispatch is counted
    (`dispatch_errors.fused` and the tier's), fed to the breaker and
    raised out of the eval, with nothing committed and no solve on the
    CPU; the reference re-solves through its classic ladder instead."""
    monkeypatch.setattr(port_backend, "BREAKER_THRESHOLD", 1)
    names = ("nomad.solver.dispatch_errors.fused",
             "nomad.solver.dispatch_errors.cuda",
             "nomad.solver.dispatch.fused", "nomad.solver.dispatch.torch",
             "nomad.solver.dispatch.cuda")
    c0 = {n: _c(PORT, n) for n in names}
    placed = []
    real = PORT.Harness.submit_plan

    def submit(self, plan):
        placed.extend(a for allocs in plan.node_allocation.values()
                      for a in allocs)
        return real(self, plan)
    monkeypatch.setattr(PORT.Harness, "submit_plan", submit)
    port_faults.install({"solver.dispatch.fused": {"mode": "raise"}})
    try:
        with pytest.raises(FaultError):
            _run(PORT, 6)
    finally:
        port_faults.clear()
    assert placed == [], "the faulted eval committed placements"
    moved = {n: _c(PORT, n) - v for n, v in c0.items()}
    assert moved == {"nomad.solver.dispatch_errors.fused": 1,
                     "nomad.solver.dispatch_errors.cuda": 1,
                     "nomad.solver.dispatch.fused": 0,
                     "nomad.solver.dispatch.torch": 0,
                     "nomad.solver.dispatch.cuda": 0}
    assert port_backend.breaker().state("cuda") == "open"
