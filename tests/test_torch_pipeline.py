"""The port's pipelined plan lifecycle (nomad_tpu_torch/solver/placer.py)
against the reference's, on the CPU.

A 200-node cluster is built in the JAX package's FSM with pinned node
ids and carried into the port's FSM with `carry.load_cluster`, as in
tests/test_torch_slice.py. With plan_pipeline_min_count=1 and
plan_pipeline_chunks=3, dense-regime batch jobs (m = 2·count/200 > 3)
run pipelined on both sides under the same eval ids — chunked solves fed
forward by the usage update, chunk plans through the real plan applier —
once with every plan applied inline and once through a live applier
thread. The committed alloc -> node maps and the pipeline counters must
be identical.

Also ported from tests/test_differential.py: the cases that stay serial
(distinct_hosts, one chunk, NOMAD_PLAN_PIPELINE=0) and the concurrent
writer between chunk commits; plus the usage update's bits against the
reference's, and a device error in a chunk raising out of the eval.
"""
import random
import types

import numpy as np
import jax  # noqa: F401  (the reference runs on the CPU backend)
import pytest
import torch

import nomad_tpu.mock as ref_mock
import nomad_tpu.structs as ref_structs
from nomad_tpu.api_codec import to_api
from nomad_tpu.metrics import metrics as ref_metrics
from nomad_tpu.scheduler import new_scheduler as ref_new_scheduler
from nomad_tpu.server import plan_apply as ref_plan_apply
from nomad_tpu.server.fsm import NomadFSM as RefFSM, RaftLog as RefRaftLog
from nomad_tpu.solver import placer as ref_placer
from nomad_tpu.solver import state_cache as ref_cache

import nomad_tpu_torch.mock as port_mock
import nomad_tpu_torch.structs as port_structs
from nomad_tpu_torch.carry import load_cluster
from nomad_tpu_torch.metrics import metrics as port_metrics
from nomad_tpu_torch.scheduler import new_scheduler as port_new_scheduler
from nomad_tpu_torch.server import plan_apply as port_plan_apply
from nomad_tpu_torch.server.fsm import NomadFSM as PortFSM
from nomad_tpu_torch.server.fsm import RaftLog as PortRaftLog
from nomad_tpu_torch.solver import backend as port_backend
from nomad_tpu_torch.solver import placer as port_placer
from nomad_tpu_torch.solver import state_cache as port_cache
from nomad_tpu_torch.solver.cuda_kernels import KernelLaunchError
from nomad_tpu_torch.solver.device import use_device

REF = types.SimpleNamespace(
    mock=ref_mock, structs=ref_structs, metrics=ref_metrics,
    new_scheduler=ref_new_scheduler, plan_apply=ref_plan_apply,
    FSM=RefFSM, RaftLog=RefRaftLog, cache=ref_cache)
PORT = types.SimpleNamespace(
    mock=port_mock, structs=port_structs, metrics=port_metrics,
    new_scheduler=port_new_scheduler, plan_apply=port_plan_apply,
    FSM=PortFSM, RaftLog=PortRaftLog, cache=port_cache)

N_NODES = 200
PIPELINE_ON = {"plan_pipeline_min_count": 1, "plan_pipeline_chunks": 3}
# dense-regime counts: 600 splits 200/200/200, 334 splits 112/111/111
JOBS = (("pipe-a", 600), ("pipe-b", 334))
COUNTERS = ("nomad.plan.pipeline.evals", "nomad.plan.pipeline.chunks")
WAIT_S = 30.0


@pytest.fixture(autouse=True)
def _cpu():
    prev, threads = use_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    port_backend.reset()
    for side in (REF, PORT):
        side.cache.reset()
    yield
    for side in (REF, PORT):
        side.cache.reset()
    torch.set_num_threads(threads)
    use_device(prev)
    port_backend.reset()


class _Shim:
    """The planner interface a server worker provides (bench.py's
    _WorkerShim): plans go through the applier thread's queue while it
    runs, else they apply inline; chunk plans through submit_plan_async
    either way."""

    def __init__(self, side, planner, state):
        self.side = side
        self.planner = planner
        self.state = state
        self._submitted = []            # (plan, result or pending)

    def _queue_alive(self) -> bool:
        t = getattr(self.planner, "_thread", None)
        return t is not None and t.is_alive()

    def submit_plan(self, plan):
        if self._queue_alive():
            result = self.planner.submit_plan(plan, timeout=WAIT_S)
        else:
            result = self.planner.apply_plan(plan)
        self._submitted.append((plan, result))
        return result

    def submit_plan_async(self, plan):
        if self._queue_alive():
            pending = self.planner.submit_plan_async(plan)
        else:
            pending = self.side.plan_apply._PendingPlan(plan)
            try:
                pending.respond(self.planner.apply_plan(plan), None)
            except Exception as e:      # noqa: BLE001 — report to caller
                pending.respond(None, str(e))
        self._submitted.append((plan, pending))
        return pending

    @property
    def submissions(self):
        """(plan, result) of every submit, chunk plans resolved (the
        placer waits out every pending before its eval returns)."""
        out = []
        for plan, r in self._submitted:
            if isinstance(r, self.side.plan_apply._PendingPlan):
                r, _ = r.wait(WAIT_S)
            out.append((plan, r))
        return out

    def update_eval(self, ev):
        self.state.upsert_evals(self.state.latest_index() + 1, [ev])

    def create_eval(self, ev):
        self.state.upsert_evals(self.state.latest_index() + 1, [ev])

    def refresh_snapshot(self, old):
        return self.state.snapshot()


def _mk_node(mock, i, rng):
    """The bench fleet's node recipe (bench.py _mk_node), id pinned."""
    n = mock.node()
    n.id = f"pipe-node-{i:06d}"
    n.name = f"bench-{i}"
    n.node_class = f"c{int(rng.integers(0, 4))}"
    n.datacenter = "dc1" if i % 2 == 0 else "dc2"
    n.node_resources.cpu.cpu_shares = int(
        rng.choice([4_000, 8_000, 16_000, 32_000]))
    n.node_resources.memory.memory_mb = int(
        rng.choice([8_192, 16_384, 32_768, 65_536]))
    n.node_resources.disk.disk_mb = 500_000
    return n


def _mk_job(side, job_id, count, cpu=250, mem=512):
    job = side.mock.batch_job()
    job.id = job.name = job_id
    job.datacenters = ["dc1", "dc2"]
    tg = job.task_groups[0]
    tg.count = count
    tg.ephemeral_disk.size_mb = 300
    task = tg.tasks[0]
    task.resources.cpu = cpu
    task.resources.memory_mb = mem
    task.resources.networks = []
    tg.networks = []
    return job


def _clusters(config_kwargs, n_nodes=N_NODES):
    """(ref fsm, port fsm): the reference's cluster and the port's copy
    of it, carried as API JSON."""
    cfg = ref_structs.SchedulerConfiguration(
        scheduler_algorithm="tpu-batch", placement_explain_enabled=False,
        **config_kwargs)
    ref = RefFSM()
    ref.state.set_scheduler_config(1, cfg)
    rng = np.random.default_rng(42)
    for i in range(n_nodes):
        ref.state.upsert_node(i + 2, _mk_node(ref_mock, i, rng))
    port = PortFSM()
    load_cluster(port.state, {
        "scheduler_config": to_api(cfg),
        "nodes": [to_api(n) for n in ref.state.iter_nodes()]})
    return ref, port


def _run(side, fsm, planner, job, eval_id):
    """One eval through the scheduler and the real applier -> (shim,
    {alloc name: node id} of the job's live allocs)."""
    s = fsm.state
    s.upsert_job(s.latest_index() + 1, job)
    ev = side.structs.Evaluation(id=eval_id, namespace="default",
                                 job_id=job.id, type="batch", priority=50)
    s.upsert_evals(s.latest_index() + 1, [ev])
    shim = _Shim(side, planner, s)
    side.new_scheduler("batch", s.snapshot(), shim).process(ev)
    return shim, {a.name: a.node_id for a in s.allocs_by_job("default",
                                                               job.id)
                  if not a.terminal_status()}


def _counters(side):
    return {k: side.metrics.counter(k) for k in COUNTERS}


@pytest.mark.parametrize("applier", ["inline", "thread"])
def test_pipelined_eval_places_exactly_like_reference(applier):
    """Pipelined evals commit the reference's alloc -> node map, chunk by
    chunk through the real applier, and count the same chunks."""
    ref, port = _clusters(PIPELINE_ON)
    out = {}
    for side, fsm in ((REF, ref), (PORT, port)):
        planner = side.plan_apply.Planner(side.RaftLog(fsm), fsm.state)
        if applier == "thread":
            planner.start()
        try:
            c0 = _counters(side)
            maps = {}
            for job_id, count in JOBS:
                shim, maps[job_id] = _run(side, fsm, planner,
                                          _mk_job(side, job_id, count),
                                          f"pipe-eval-{job_id}")
                assert len(maps[job_id]) == count
                # chunk plans + the eval's own final plan
                assert len(shim.submissions) == \
                    PIPELINE_ON["plan_pipeline_chunks"]
            c1 = _counters(side)
        finally:
            planner.stop()
        view = fsm.state.usage.view()
        assert not bool((view.used > view.cap + 1e-3).any())
        out[id(side)] = (maps, {k: c1[k] - c0[k] for k in COUNTERS})
    (want, want_c), (got, got_c) = out[id(REF)], out[id(PORT)]
    assert got == want
    assert got_c == want_c == {
        "nomad.plan.pipeline.evals": len(JOBS),
        "nomad.plan.pipeline.chunks": 3 * len(JOBS)}
    # the port's cache served the second eval and fed on every commit
    stats = port_cache.cache().stats()
    assert stats["hits"] >= 1 and stats["twins_device"] == "cpu"


def _distinct_hosts(side, job):
    job.constraints.append(side.structs.Constraint(
        operand=side.structs.OP_DISTINCT_HOSTS))


@pytest.mark.parametrize("case", ["distinct_hosts", "single_chunk",
                                  "env_flag"])
def test_pipeline_stays_serial(monkeypatch, case):
    """distinct_hosts (max_per_node=1 binds per SOLVE, so chunks could
    stack same-job instances), plan_pipeline_chunks=1 and
    NOMAD_PLAN_PIPELINE=0 all keep the eval serial — on both sides, with
    the same placements."""
    cfg = dict(PIPELINE_ON)
    if case == "single_chunk":
        cfg["plan_pipeline_chunks"] = 1
    if case == "env_flag":
        monkeypatch.setenv("NOMAD_PLAN_PIPELINE", "0")
    count = 150 if case == "distinct_hosts" else 600
    ref, port = _clusters(cfg)
    maps = {}
    for side, fsm in ((REF, ref), (PORT, port)):
        planner = side.plan_apply.Planner(side.RaftLog(fsm), fsm.state)
        job = _mk_job(side, f"serial-{case}", count)
        if case == "distinct_hosts":
            _distinct_hosts(side, job)
        c0 = _counters(side)
        shim, maps[id(side)] = _run(side, fsm, planner, job,
                                    f"serial-eval-{case}")
        assert _counters(side) == c0, f"{case}: the eval took the pipeline"
        assert len(shim.submissions) == 1
        assert len(maps[id(side)]) == count
        if case == "distinct_hosts":
            assert len(set(maps[id(side)].values())) == count
    assert maps[id(PORT)] == maps[id(REF)]


def _uniform_fsms(cfg, n_nodes=9):
    """(ref fsm, port fsm) with n_nodes UNIFORM mock nodes (3900 usable
    cpu / 7936 usable mem each), ids pinned."""
    out = []
    for side in (REF, PORT):
        fsm = side.FSM()
        s = fsm.state
        s.set_scheduler_config(1, side.structs.SchedulerConfiguration(
            scheduler_algorithm="tpu-batch", **cfg))
        for i in range(n_nodes):
            n = side.mock.node()
            n.id = f"uni-node-{i:04d}"
            n.name = f"uni-{i}"
            s.upsert_node(2 + i, n)
        out.append(fsm)
    return out


def _hog_for(side, state):
    """A full-node competitor alloc on a node with no allocs yet."""
    hog = side.mock.batch_job()
    hog.id = hog.name = "hog"
    t = hog.task_groups[0].tasks[0]
    t.resources.cpu = 3900
    t.resources.memory_mb = 512
    t.resources.networks = []
    hog.task_groups[0].networks = []
    empty = next(n for n in state.iter_nodes()
                 if not state.allocs_by_node(n.id))
    return side.mock.alloc_for(hog, empty)


def _concurrent_writer_run(side, fsm, pipelined: bool):
    """9 uniform nodes x 10 tasks each, count=90 (every node is needed):
    a hog alloc lands on a still-empty node after the first apply
    (pipelined: after chunk 1 of 3 commits; serial: before the one plan
    applies), so a later chunk / the one plan must be partly rejected
    and the eval must refresh and retry."""
    class InjectingPlanner(side.plan_apply.Planner):
        fired = False
        applies = 0

        def apply_plan(self, plan):
            if not self.fired and self.applies == (1 if pipelined else 0):
                s = self.state
                s.upsert_allocs(s.latest_index() + 1, [_hog_for(side, s)])
                self.fired = True
            self.applies += 1
            return super().apply_plan(plan)

    random.seed(1234)
    s = fsm.state
    planner = InjectingPlanner(side.RaftLog(fsm), s)
    job = _mk_job(side, "ordering", 90, cpu=390, mem=512)
    shim, placed = _run(side, fsm, planner, job, "ordering-eval")
    assert planner.fired, "interleaved write never fired"
    view = s.usage.view()
    assert not bool((view.used > view.cap + 1e-3).any())
    rejected = sum(len(r.rejected_nodes) for _, r in shim.submissions
                   if r is not None)
    status = sorted(e.status for e in s.evals_by_job("default", "ordering")
                    if e.status)
    hog_live = any(a.job_id == "hog" and not a.terminal_status()
                   for a in s.iter_allocs())
    return len(placed), rejected, status, hog_live, placed


def test_concurrent_writer_between_chunks_matches_reference():
    """A concurrent write between chunk commits: the applier's latest-
    state re-check rejects the colliding placements and the eval
    refreshes and retries — the port gives the reference's committed
    count, rejections and eval disposition (and placements), pipelined
    and serial alike, and pipelined equals serial."""
    obs = {}
    for pipelined in (True, False):
        cfg = dict(PIPELINE_ON) if pipelined \
            else {"plan_pipeline_enabled": False}
        ref_fsm, port_fsm = _uniform_fsms(cfg)
        want = _concurrent_writer_run(REF, ref_fsm, pipelined)
        got = _concurrent_writer_run(PORT, port_fsm, pipelined)
        assert got == want, f"pipelined={pipelined}: {got[:4]} != {want[:4]}"
        obs[pipelined] = got[:4]
    assert obs[True][1] >= 1, f"no rejection surfaced: {obs[True]}"
    assert obs[True] == obs[False]


@pytest.mark.parametrize("inputs", ["resources", "random_floats"])
def test_usage_update_bits_against_reference(inputs):
    """The port's usage update is the reference's expression, each step
    rounded to float32. On resource-shaped inputs (integer MHz/MB asks
    and usage, as every node and job here) both sides are exact and the
    bits agree. On arbitrary float32 inputs XLA's CPU backend contracts
    u + p*a into one fused multiply-add (one rounding) where the port
    rounds the product and the sum separately: the port matches numpy's
    separately rounded expression bit for bit, the reference matches the
    once-rounded float64 value, and the two differ."""
    rng = np.random.default_rng(20261017)
    n = 4096
    p = rng.integers(0, 300, n).astype(np.int32)
    c = rng.integers(0, 5, n).astype(np.int32)
    if inputs == "resources":
        u = rng.integers(0, 60_000, (n, 5)).astype(np.float32)
        a = np.array([250, 512, 300, 0, 0], np.float32)
    else:
        u = (rng.random((n, 5)) * 1e4).astype(np.float32)
        a = (rng.random(5) * 1e3).astype(np.float32)
    ru, rc = ref_placer._usage_update(u, c, p, a)
    ru, rc = np.asarray(ru), np.asarray(rc)
    tu, tc = port_placer._usage_update(
        torch.from_numpy(u), torch.from_numpy(c), torch.from_numpy(p),
        torch.from_numpy(a))
    tu, tc = tu.numpy(), tc.numpy()
    assert tu.dtype == np.float32 and tc.dtype == np.int32
    np.testing.assert_array_equal(tc, rc)
    two_roundings = u + p[:, None].astype(np.float32) * a[None, :]
    assert tu.tobytes() == two_roundings.tobytes()
    if inputs == "resources":
        assert tu.tobytes() == ru.tobytes()
    else:
        once = (u.astype(np.float64) + p[:, None].astype(np.float64)
                * a[None, :].astype(np.float64)).astype(np.float32)
        assert ru.tobytes() == once.tobytes()
        assert int((tu != ru).sum()) > 0


@pytest.mark.parametrize("where", ["dispatch", "materialize"])
def test_device_error_in_a_chunk_raises_out_of_the_eval(monkeypatch, where):
    """A device error in chunk 2 of 3 — at its launch or when its result
    reaches the host — raises out of the eval naming the chunk, and the
    chunks before it resolve before the error leaves the placer."""
    _, port = _clusters(PIPELINE_ON, n_nodes=60)
    planner = port_plan_apply.Planner(PortRaftLog(port), port.state)
    if where == "dispatch":
        tier, fn = port_backend.select("depth", 64, k_max=128)
        calls = []

        def flaky(*a, **kw):
            calls.append(1)
            if len(calls) == 3:
                raise KernelLaunchError("depth_curve kernel launch failed: "
                                        "cudaError_t 719")
            return fn(*a, **kw)
        monkeypatch.setattr(port_backend, "select",
                            lambda *a, **kw: (tier, flaky))
    else:
        real = port_placer._Chunk.numpy
        seen = []

        def numpy(self):
            seen.append(1)
            if len(seen) == 3:
                raise torch.OutOfMemoryError("CUDA out of memory")
            return real(self)
        monkeypatch.setattr(port_placer._Chunk, "numpy", numpy)
    planner.start()
    try:
        with pytest.raises(port_placer.PipelineChunkError,
                           match="chunk 2 of 3"):
            _run(PORT, port, planner, _mk_job(PORT, "boom", 180),
                 "boom-eval")
    finally:
        planner.stop()
    placed = port.state.allocs_by_job("default", "boom")
    # dispatch: nothing was submitted; materialize: chunks 0 and 1 are
    # committed (60 each), nothing of chunk 2
    assert len(placed) == (0 if where == "dispatch" else 120)
