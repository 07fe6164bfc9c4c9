"""The port's placement explainability against the reference's, on the CPU.

Each scenario of tests/test_explain.py's `build_and_run` — greedy with an
irregular constraint, jittered depth, partial depth, distinct hosts, node
classes, plus the scan (a spread stanza, a distinct_property cap) — is
built on both sides from the same seeds: `random` for the scheduler,
numpy for the fleet and a seeded `os.urandom` for every id, so nodes,
jobs, evals and allocations carry the same ids. Each eval then runs
through the reference's scheduler and the port's (`use_device("cpu")`),
and the test holds:

  * placed allocations' metrics (nodes evaluated, filter reasons, score
    metadata, scores) and `failed_tg_allocs` equal, field for field;
  * the explain records (`ExplainRecord.as_dict()`) equal, apart from
    the tier name;
  * placements identical with explain on and off; NOMAD_EXPLAIN=0
    records nothing;
  * preemption's stage-5 counts equal;
  * the torch `explain_reduce` bit-equal to `reduce_numpy`, and to the
    reference's jitted reduce on seeded inputs — on a rounding boundary
    the jitted reduce (a contracted multiply-add on XLA's CPU backend)
    differs, and the port follows `reduce_numpy`, which the reference
    runs for every host-resident result;
  * a pipelined eval's record (over the summed chunks) equal.
"""
import dataclasses
import random
import types

import jax  # noqa: F401  (the reference runs on the CPU backend)
import numpy as np
import pytest
import torch

import nomad_tpu.mock as ref_mock
import nomad_tpu.structs as ref_structs
from nomad_tpu.metrics import metrics as ref_metrics
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.scheduler import new_scheduler as ref_new_scheduler
from nomad_tpu.solver import backend as ref_backend
from nomad_tpu.solver import explain as ref_explain
from nomad_tpu.solver import microbatch as ref_microbatch
from nomad_tpu.solver import state_cache as ref_cache
from nomad_tpu.solver.kernels import explain_reduce as ref_explain_reduce

import nomad_tpu_torch.mock as port_mock
import nomad_tpu_torch.structs as port_structs
from nomad_tpu_torch.metrics import metrics as port_metrics
from nomad_tpu_torch.scheduler import Harness as PortHarness
from nomad_tpu_torch.scheduler import new_scheduler as port_new_scheduler
from nomad_tpu_torch.solver import backend as port_backend
from nomad_tpu_torch.solver import explain as port_explain
from nomad_tpu_torch.solver import kernels as port_kernels
from nomad_tpu_torch.solver import state_cache as port_cache
from nomad_tpu_torch.solver.device import use_device
from nomad_tpu_torch.testing import (
    BOUNDARY, explain_boundary_case, explain_case, seeded_urandom,
)

REF = types.SimpleNamespace(
    mock=ref_mock, structs=ref_structs, metrics=ref_metrics,
    Harness=RefHarness, new_scheduler=ref_new_scheduler,
    explain=ref_explain, backend=ref_backend, cache=ref_cache)
PORT = types.SimpleNamespace(
    mock=port_mock, structs=port_structs, metrics=port_metrics,
    Harness=PortHarness, new_scheduler=port_new_scheduler,
    explain=port_explain, backend=port_backend, cache=port_cache)
SIDES = (REF, PORT)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("NOMAD_EXPLAIN", raising=False)
    monkeypatch.delenv("NOMAD_SOLVER_BACKEND", raising=False)
    prev, threads = use_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    ref_microbatch.reset()
    for side in SIDES:
        side.backend.reset()
        side.cache.reset()
        side.explain.configure(enabled=None)
        side.explain.reset()
    yield
    for side in SIDES:
        side.backend.reset()
        side.cache.reset()
        side.explain.configure(enabled=None)
        side.explain.reset()
    ref_microbatch.reset()
    torch.set_num_threads(threads)
    use_device(prev)


# ------------------------------------------------------------- scenarios

# name -> (seed, nodes, count, cpu MHz, mem MB, options)
SCENARIOS = {
    "rejected": (3, 4, 5, 9000, 64, {}),
    "memory_bound": (4, 3, 2, 100, 32768, {}),
    "greedy_constraint": (5, 10, 1, 20000, 64, dict(
        constraint=True, hetero=True, node_class=True)),
    "greedy_constraint_b": (9, 10, 1, 20000, 64, dict(
        constraint=True, hetero=True, node_class=True)),
    "jittered_depth": (6, 16, 2, 20000, 70000, dict(
        hetero=True, node_class=True)),
    "partial_depth": (7, 4, 24, 1900, 512, {}),
    "distinct_hosts": (8, 6, 9, 100, 64, dict(distinct_hosts=True)),
    "placed_score_meta": (31, 5, 4, 300, 128, {}),
    "placed_filter": (33, 8, 2, 100, 64, dict(constraint=True)),
    "classes_placed": (35, 12, 40, 700, 256, dict(
        hetero=True, node_class=True)),
    "spread_scan": (41, 8, 6, 300, 128, dict(spread=True,
                                             node_class=True)),
    "distinct_property_scan": (43, 8, 10, 300, 128, dict(
        distinct_property=True, node_class=True)),
}


def build_and_run(side, seed, n_nodes, count, ask_cpu, ask_mem, *,
                  constraint=False, distinct_hosts=False, hetero=False,
                  node_class=False, spread=False, distinct_property=False,
                  eval_id=None):
    """tests/test_explain.py's build_and_run on one side, every id from a
    seeded byte stream so both sides mint the same ones."""
    with seeded_urandom(seed):
        random.seed(seed)
        rng = np.random.default_rng(seed)
        h = side.Harness()
        h.state.set_scheduler_config(
            h.get_next_index(),
            side.structs.SchedulerConfiguration(
                scheduler_algorithm="tpu-batch"))
        for _ in range(n_nodes):
            n = side.mock.node()
            if hetero:
                n.node_resources.cpu.cpu_shares = int(
                    rng.choice([4000, 16000]))
                n.node_resources.memory.memory_mb = int(
                    rng.choice([8192, 65536]))
            rack = "r1" if rng.random() < 0.5 else "r2"
            n.attributes["custom.rack"] = rack
            if node_class:
                n.node_class = f"class-{rack}"
            n.compute_class()
            h.state.upsert_node(h.get_next_index(), n)
        job = side.mock.batch_job()
        tg = job.task_groups[0]
        tg.count = count
        tg.networks = []
        task = tg.tasks[0]
        task.resources.cpu = ask_cpu
        task.resources.memory_mb = ask_mem
        task.resources.networks = []
        c = side.structs.Constraint
        if constraint:
            tg.constraints = list(tg.constraints) + [c(
                ltarget="${attr.custom.rack}", rtarget="r1", operand="=")]
        if distinct_hosts:
            tg.constraints = list(tg.constraints) + [c(
                operand=side.structs.OP_DISTINCT_HOSTS)]
        if distinct_property:
            tg.constraints = list(tg.constraints) + [c(
                ltarget="${attr.custom.rack}", rtarget="2",
                operand=side.structs.OP_DISTINCT_PROPERTY)]
        if spread:
            job.spreads = [side.structs.Spread(
                attribute="${attr.custom.rack}", weight=100)]
        h.state.upsert_job(h.get_next_index(), job)
        ev = side.structs.Evaluation(id=eval_id or f"explain-ev-{seed}",
                                     job_id=job.id, type=job.type)
        h.process(lambda s, p: side.new_scheduler(job.type, s, p), ev)
    return h, job, tg


def _metric(m) -> dict:
    """An AllocMetric's fields, less the wall-clock allocation time."""
    d = dataclasses.asdict(m)
    d.pop("allocation_time_ns")
    return d


def _outcome(side, h, job, tg) -> dict:
    allocs = h.state.allocs_by_job("default", job.id)
    ev = h.evals[-1]
    failed = ev.failed_tg_allocs.get(tg.name)
    return {
        "placed": {a.name: (a.node_id, _metric(a.metrics))
                   for a in allocs},
        "failed": None if failed is None else _metric(failed),
        "records": [{k: v for k, v in r.items() if k != "tier"}
                    for r in side.explain.recent(16)],
        "blocked": sorted(
            _metric(e.failed_tg_allocs[tg.name]).__repr__()
            for e in h.created_evals
            if e.status == "blocked" and tg.name in e.failed_tg_allocs),
    }


def _both(name, **extra):
    seed, n, count, cpu, mem, opts = SCENARIOS[name]
    out = []
    for side in SIDES:
        side.explain.reset()
        h, job, tg = build_and_run(side, seed, n, count, cpu, mem,
                                   **opts, **extra)
        out.append(_outcome(side, h, job, tg))
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_explain_matches_reference(name):
    want, got = _both(name)
    assert got["placed"] == want["placed"]
    assert got["failed"] == want["failed"]
    assert got["blocked"] == want["blocked"]
    assert got["records"] == want["records"]
    assert got["records"], "the port recorded no explain record"
    _, _, count, _, _, _ = SCENARIOS[name]
    placed = len(got["placed"])
    if placed < count:
        assert got["failed"] is not None
        assert got["failed"]["nodes_evaluated"] > 0
    if placed:
        m = next(iter(got["placed"].values()))[1]
        assert m["score_meta"] and m["scores"]


def test_rejection_carries_dimension_and_ring_record():
    """The acceptance surface of tests/test_explain.py on the port: the
    rejected eval says why, the blocked eval carries the same metric and
    the ring holds the rejected record."""
    seed, n, count, cpu, mem, opts = SCENARIOS["rejected"]
    h, job, tg = build_and_run(PORT, seed, n, count, cpu, mem, **opts)
    m = h.evals[-1].failed_tg_allocs[tg.name]
    assert m.nodes_evaluated == 4 and m.nodes_exhausted == 4
    assert m.dimension_exhausted == {"cpu": 4}
    blocked = [e for e in h.created_evals if e.status == "blocked"]
    assert blocked[0].failed_tg_allocs[tg.name].dimension_exhausted == \
        {"cpu": 4}
    assert any(r["rejected"] and r["dim_exhausted"] == {"cpu": 4}
               and r["tier"] == "torch" for r in port_explain.recent(8))


@pytest.mark.parametrize("name", ["classes_placed", "partial_depth"])
def test_placements_identical_explain_on_off(name):
    seed, n, count, cpu, mem, opts = SCENARIOS[name]

    def run(enabled):
        port_explain.configure(enabled=enabled)
        port_backend.reset()
        port_cache.reset()
        h, job, _ = build_and_run(PORT, seed, n, count, cpu, mem, **opts,
                                  eval_id="bitid-ev")
        return ({a.name: a.node_id
                 for a in h.state.allocs_by_job("default", job.id)},
                h.state.usage.used.tobytes())

    on, off = run(True), run(False)
    assert on == off and on[0]


def test_env_kill_switch_records_nothing(monkeypatch):
    monkeypatch.setenv("NOMAD_EXPLAIN", "0")
    h, job, tg = build_and_run(PORT, 23, 3, 2, 9000, 64)
    assert port_explain.recent(8) == []
    # the rejection carries the host fallback stack's own metric
    m = h.evals[-1].failed_tg_allocs[tg.name]
    assert m.nodes_evaluated == 3 and not m.score_meta


def _preempt_run(side):
    with seeded_urandom(77):
        random.seed(77)
        h = side.Harness()
        h.state.set_scheduler_config(
            h.get_next_index(),
            side.structs.SchedulerConfiguration(
                scheduler_algorithm="tpu-batch",
                preemption_config=side.structs.PreemptionConfig(
                    batch_scheduler_enabled=True)))
        for _ in range(3):
            h.state.upsert_node(h.get_next_index(), side.mock.node())

        def _job(priority, count, cpu):
            job = side.mock.batch_job()
            job.priority = priority
            tg = job.task_groups[0]
            tg.count = count
            tg.networks = []
            task = tg.tasks[0]
            task.resources.cpu = cpu
            task.resources.memory_mb = 128
            task.resources.networks = []
            return job, tg

        for ev_id, (prio, count) in (("preempt-low-ev", (1, 3)),
                                     ("preempt-high-ev", (50, 2))):
            job, tg = _job(prio, count, 3000)
            h.state.upsert_job(h.get_next_index(), job)
            h.process(lambda s, p: side.new_scheduler(job.type, s, p),
                      side.structs.Evaluation(id=ev_id, job_id=job.id,
                                              type=job.type))
    return [{k: v for k, v in r.items() if k != "tier"}
            for r in side.explain.recent(8)
            if r["eval_id"] == "preempt-high-ev" and r["tg"] == tg.name]


def test_preemption_stage_counts_match_reference():
    want, got = _preempt_run(REF), _preempt_run(PORT)
    assert got == want and got
    p = got[0]["preempt"]
    assert p["candidates"] == 3 and p["with_victims"] >= 1 and \
        p["placed"] >= 1


# ------------------------------------------------------------ the reduce

def _boundary_args(n=8):
    """Rows on a float32 rounding boundary (testing.BOUNDARY), the
    boundary re-derived here."""
    args = explain_boundary_case(n)
    u, a, p = BOUNDARY
    post2 = np.float32(np.float32(np.float32(p) * a) + u)
    post1 = np.float32(np.float64(p) * np.float64(a) + np.float64(u))
    assert post1 != post2 and np.float32(post1 + a) > args[0][0, 0]
    assert not np.float32(post2 + a) > args[0][0, 0]
    return args


def _port_reduce(args, n_classes):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args[:7]]
    buf = port_kernels.explain_reduce(*t, bool(args[7]),
                                      n_classes=n_classes)
    assert buf.dtype == torch.int32
    return port_explain.unpack(buf.numpy(), 5, n_classes)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_torch_reduce_bit_equal_to_numpy_and_reference(seed):
    args = explain_case(seed)
    got = _port_reduce(args, 4)
    for want in (port_explain.reduce_numpy(*args, n_classes=4),
                 ref_explain.reduce_numpy(*args, n_classes=4),
                 ref_explain_reduce(*args, n_classes=4)):
        for a, b in zip(got, want):
            assert np.asarray(a).tobytes() == \
                np.asarray(b).astype(np.int32).tobytes()


def test_torch_reduce_on_a_rounding_boundary_follows_numpy():
    """On the boundary rows the port's torch reduce and both numpy
    reduces call the rows fit (two roundings); the reference's jitted
    reduce contracts used + placed * ask into one fused multiply-add on
    XLA's CPU backend and calls them exhausted on cpu."""
    args = _boundary_args()
    got = _port_reduce(args, 2)
    for want in (port_explain.reduce_numpy(*args, n_classes=2),
                 ref_explain.reduce_numpy(*args, n_classes=2)):
        for a, b in zip(got, want):
            assert np.asarray(a).tobytes() == \
                np.asarray(b).astype(np.int32).tobytes()
    assert got[0].tolist() == [8, 0, 0, 8, 8, 8 * 49]
    jitted = [np.asarray(x) for x in ref_explain_reduce(*args, n_classes=2)]
    assert jitted[0].tolist() == [8, 0, 8, 0, 8, 8 * 49]
    assert jitted[1].tolist() == [8, 0, 0, 0, 0]


def test_unpadded_host_route_equals_padded_reduce():
    """dispatch_reduce's host route slices the padding rows off; the
    padded torch reduce over the whole bucket gives the same counts."""
    cap, used, ask, feas, coll, placed, cls, dh = explain_case(7, n=24)
    pad = 8
    gt = types.SimpleNamespace(
        cap=np.pad(cap, ((0, pad), (0, 0))),
        used=np.pad(used, ((0, pad), (0, 0))), ask=ask,
        feasible=np.pad(feas, (0, pad)),
        job_collisions=np.pad(coll, (0, pad)), distinct_hosts=True,
        nodes=[None] * 24, cap_dev=None, used_dev=None)
    ids = np.pad(cls, (0, pad), constant_values=-1)
    host = port_explain.dispatch_reduce(gt, np.pad(placed, (0, pad)), ids,
                                        4)
    full = _port_reduce((gt.cap, gt.used, ask, gt.feasible,
                         gt.job_collisions, np.pad(placed, (0, pad)), ids,
                         dh), 4)
    for a, b in zip(host, full):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# -------------------------------------------------------------- pipelined

def test_pipelined_eval_record_matches_reference():
    """A pipelined eval (3 chunks) on the 200-node bench fleet with
    explain on (the fleet's config turns it off; the override turns it
    back on, on both sides): the record over the summed chunks, and the
    placed allocs' metrics, equal the reference's."""
    import test_torch_pipeline as tp
    ref, port = tp._clusters(tp.PIPELINE_ON)
    out = {}
    for side, pside, fsm in ((REF, tp.REF, ref), (PORT, tp.PORT, port)):
        side.explain.configure(enabled=True)
        planner = pside.plan_apply.Planner(pside.RaftLog(fsm), fsm.state)
        c0 = side.metrics.counter("nomad.plan.pipeline.evals")
        side.explain.reset()
        job = tp._mk_job(pside, "pipe-explain", 600)
        with seeded_urandom(5):
            tp._run(pside, fsm, planner, job, "pipe-explain-eval")
        assert side.metrics.counter("nomad.plan.pipeline.evals") == c0 + 1
        allocs = fsm.state.allocs_by_job("default", job.id)
        out[id(side)] = (
            {a.name: (a.node_id, _metric(a.metrics)) for a in allocs},
            [{k: v for k, v in r.items() if k != "tier"}
             for r in side.explain.recent(4)])
    want, got = out[id(REF)], out[id(PORT)]
    assert len(got[0]) == 600
    assert got == want
    assert got[1] and got[1][0]["placed_total"] == 600
