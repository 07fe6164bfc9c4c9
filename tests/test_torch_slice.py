"""The port's whole placement slice against the reference, on the CPU.

One ~200-node cluster is built in the JAX package's FSM with pinned node
ids, exported as API JSON and carried into nomad_tpu_torch's FSM with
`carry.load_cluster`. The same jobs then run on both sides under the same
eval ids — scheduler → placer → solve → serial plan applier → FSM commit
— and the committed alloc-name → node-id maps must be identical for:

  * a 200-task batch job (m = 2·200/200 > 3: the dense depth curve),
  * a small job (m < 3: the sampled depth grid, jittered),
  * a count-1 job (the greedy score/capacity solve),
  * a job with a `spread` stanza over the datacenters (the chunked scan),
  * a job under `distinct_property ${meta.rack}` at 6 per rack, deep
    enough that a scan step places two instances at once (the scan, its
    host-side quota trim and the host fallback for what the trim drops),
  * a 2,000-task job at 5 MHz / 8 MB, too deep for the [N, K] depth
    curve (k_max > 512: the scan),
  * a priority-20 job that fills every node, then a priority-80 job that
    fits nowhere (the batched preemption pass): the same preempted
    allocation ids on both sides.

Allocation ids are random (os.urandom); each job runs on both sides from
the same seeded byte stream, so the two sides mint the same ids, and a
victim chosen among identical allocations is the same one.

The spread job is also held to its properties: every instance placed, no
node overcommitted, the datacenters even.
"""
import numpy as np
import jax  # noqa: F401  (the reference runs on the CPU backend)
import pytest
import torch

import nomad_tpu.mock as ref_mock
from nomad_tpu.api_codec import to_api
from nomad_tpu.metrics import metrics as ref_metrics
from nomad_tpu.server.fsm import NomadFSM as RefFSM, RaftLog as RefRaftLog
from nomad_tpu.server.plan_apply import Planner as RefPlanner
from nomad_tpu.scheduler import new_scheduler as ref_new_scheduler
from nomad_tpu import structs as ref_structs

import nomad_tpu_torch.mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.carry import load_cluster
from nomad_tpu_torch.metrics import metrics as port_metrics
from nomad_tpu_torch.scheduler import new_scheduler as port_new_scheduler
from nomad_tpu_torch.server import NomadFSM as PortFSM, Planner as PortPlanner
from nomad_tpu_torch.server.fsm import RaftLog as PortRaftLog
from nomad_tpu_torch.solver import backend as port_backend
from nomad_tpu_torch.solver.device import use_device
from nomad_tpu_torch.testing import fill_count, seeded_urandom

N_NODES = 200
N_RACKS = 50
# (job id, count, cpu MHz, mem MB, shape, kernel the port runs); the
# filler's count (None) is what fills every node, read off the usage view
JOBS = (
    ("dense", 200, 250, 512, "", "depth"),
    ("grid", 60, 250, 512, "", "depth"),
    ("greedy", 1, 500, 1024, "", "greedy"),
    ("spread", 20, 300, 256, "spread", "chunked"),
    ("distinct", 280, 100, 128, "distinct", "chunked"),
    ("deep", 2000, 5, 8, "", "chunked"),
    ("filler", None, 2000, 4096, "low", "depth"),
    ("preempt", 30, 2000, 4096, "high", "depth"),
)


def _mk_node(mock, i, rng):
    """The bench fleet's node recipe (bench.py _mk_node), id pinned."""
    n = mock.node()
    n.id = f"slice-node-{i:06d}"
    n.name = f"bench-{i}"
    n.node_class = f"c{int(rng.integers(0, 4))}"
    n.datacenter = "dc1" if i % 2 == 0 else "dc2"
    n.meta["rack"] = f"r{i % N_RACKS}"
    n.node_resources.cpu.cpu_shares = int(
        rng.choice([4_000, 8_000, 16_000, 32_000]))
    n.node_resources.memory.memory_mb = int(
        rng.choice([8_192, 16_384, 32_768, 65_536]))
    n.node_resources.disk.disk_mb = 500_000
    return n


def _mk_job(mock, structs, job_id, count, cpu, mem, shape):
    job = mock.batch_job()
    job.id = job.name = job_id
    job.priority = {"low": 20, "high": 80}.get(shape, 50)
    job.datacenters = ["dc1", "dc2"]
    tg = job.task_groups[0]
    tg.count = count
    tg.ephemeral_disk.size_mb = 300
    task = tg.tasks[0]
    task.resources.cpu = cpu
    task.resources.memory_mb = mem
    task.resources.networks = []
    tg.networks = []
    if shape == "spread":
        job.spreads = [structs.Spread(attribute="${node.datacenter}",
                                      weight=100)]
    if shape == "distinct":
        tg.constraints = [structs.Constraint(
            ltarget="${meta.rack}", rtarget="6",
            operand=structs.OP_DISTINCT_PROPERTY)]
    return job


class _Shim:
    """The planner interface a server worker provides, over the real
    serial applier (as bench.py's _WorkerShim does inline)."""

    def __init__(self, planner, state):
        self.planner = planner
        self.state = state

    def submit_plan(self, plan):
        return self.planner.apply_plan(plan)

    def update_eval(self, ev):
        self.state.upsert_evals(self.state.latest_index() + 1, [ev])

    def create_eval(self, ev):
        self.state.upsert_evals(self.state.latest_index() + 1, [ev])

    def refresh_snapshot(self, old):
        return self.state.snapshot()


def _run(fsm, planner, new_scheduler, structs, metrics, job):
    """One eval -> (alloc name -> node id of the job's allocations, ids
    of the allocations it preempted, its host-fallback placements)."""
    s = fsm.state
    s.upsert_job(s.latest_index() + 1, job)
    ev = structs.Evaluation(id=f"slice-eval-{job.id}", namespace="default",
                            job_id=job.id, type="batch", priority=50)
    s.upsert_evals(s.latest_index() + 1, [ev])
    evicted = {a.id for a in s.iter_allocs() if a.desired_status == "evict"}
    fallback = metrics.counter("nomad.solver.placements_host_fallback")
    sched = new_scheduler("batch", s.snapshot(), _Shim(planner, s))
    sched.process(ev)
    placed = {a.name: a.node_id for a in s.iter_allocs()
              if a.job_id == job.id}
    preempted = {a.id for a in s.iter_allocs()
                 if a.desired_status == "evict" and a.id not in evicted}
    return placed, preempted, \
        metrics.counter("nomad.solver.placements_host_fallback") - fallback


def _kernel_counters():
    return {f"{k}.{t}": port_metrics.counter(f"nomad.solver.kernel.{k}.{t}")
            for k in ("depth", "greedy", "chunked") for t in ("torch", "cuda")}


@pytest.fixture(scope="module")
def slice_run():
    # one intra-op thread: the suite runs several workers side by side
    prev, threads = use_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    port_backend.reset()
    try:
        cfg_kw = dict(scheduler_algorithm="tpu-batch",
                      plan_pipeline_enabled=False,
                      placement_explain_enabled=False)
        ref = RefFSM()
        ref_cfg = ref_structs.SchedulerConfiguration(
            preemption_config=ref_structs.PreemptionConfig(
                batch_scheduler_enabled=True), **cfg_kw)
        ref.state.set_scheduler_config(1, ref_cfg)
        rng = np.random.default_rng(42)
        for i in range(N_NODES):
            ref.state.upsert_node(i + 2, _mk_node(ref_mock, i, rng))
        docs = {"scheduler_config": to_api(ref_cfg),
                "nodes": [to_api(n) for n in ref.state.iter_nodes()]}
        port = PortFSM()
        load_cluster(port.state, docs)
        views = (ref.state.usage.view(), port.state.usage.view())

        ref_planner = RefPlanner(RefRaftLog(ref), ref.state)
        port_planner = PortPlanner(PortRaftLog(port), port.state)
        out = {}
        for seed, (job_id, count, cpu, mem, shape, _) in enumerate(JOBS):
            if count is None:
                count = fill_count(ref.state.usage.view(), cpu, mem)
            before = _kernel_counters()
            with seeded_urandom(seed):
                want = _run(ref, ref_planner, ref_new_scheduler,
                            ref_structs, ref_metrics,
                            _mk_job(ref_mock, ref_structs, job_id, count,
                                    cpu, mem, shape))
            with seeded_urandom(seed):
                got = _run(port, port_planner, port_new_scheduler,
                           port_structs, port_metrics,
                           _mk_job(port_mock, port_structs, job_id, count,
                                   cpu, mem, shape))
            after = _kernel_counters()
            out[job_id] = (want, got, {k: after[k] - before[k]
                                       for k in after}, count)
        yield views, port, out, ref
    finally:
        torch.set_num_threads(threads)
        use_device(prev)
        port_backend.reset()


def test_carried_cluster_has_identical_usage_views(slice_run):
    (ref_view, port_view), _, _, _ = slice_run
    assert port_view.row == ref_view.row
    np.testing.assert_array_equal(port_view.cap, ref_view.cap)
    np.testing.assert_array_equal(port_view.used, ref_view.used)
    assert port_view.cap.shape[0] >= N_NODES


@pytest.mark.parametrize("job", JOBS, ids=[j[0] for j in JOBS])
def test_port_places_exactly_like_reference(slice_run, job):
    job_id, _, _, _, _, kernel = job
    _, _, out, _ = slice_run
    (want, want_pre, want_fb), (got, got_pre, got_fb), moved, count = \
        out[job_id]
    assert len(want) == count
    assert got == want
    assert got_pre == want_pre
    assert got_fb == want_fb
    # the port solved it with its plain (CPU) tier, never the card's
    assert moved[f"{kernel}.torch"] == 1
    assert not any(v for k, v in moved.items() if k.endswith(".cuda"))


def test_spread_job_meets_its_placement_properties(slice_run):
    """The scan's spread placement: all placed, nothing overcommitted,
    datacenters even — solved by the chunked scan, not the host stack."""
    _, port, out, _ = slice_run
    _, (got, _, fallback), moved, count = out["spread"]
    assert len(got) == count
    assert moved["chunked.torch"] == 1 and fallback == 0
    dc = {n.id: n.datacenter for n in port.state.iter_nodes()}
    by_dc = {"dc1": 0, "dc2": 0}
    for node_id in got.values():
        by_dc[dc[node_id]] += 1
    assert by_dc["dc1"] == by_dc["dc2"] == count // 2
    view = port.state.usage.view()
    assert not bool((view.used > view.cap + 1e-3).any())


def test_distinct_property_job_keeps_its_rack_quota(slice_run):
    """At most 6 instances per rack, every instance placed, and the scan
    placed them (what its quota trim drops goes to the host stack)."""
    _, port, out, _ = slice_run
    _, (got, _, fallback), moved, count = out["distinct"]
    assert len(got) == count
    assert moved["chunked.torch"] == 1
    assert fallback < count
    rack = {n.id: n.meta["rack"] for n in port.state.iter_nodes()}
    per_rack: dict = {}
    for node_id in got.values():
        per_rack[rack[node_id]] = per_rack.get(rack[node_id], 0) + 1
    assert max(per_rack.values()) <= 6


def test_preemption_evicts_the_low_priority_filler(slice_run):
    """The priority-80 job fits only by preemption: every instance
    placed by the batched pass (no host fallback), each displacing
    allocations of the priority-20 filler only, and no node left over
    capacity."""
    _, port, out, _ = slice_run
    _, (got, preempted, fallback), _, count = out["preempt"]
    assert len(got) == count and fallback == 0
    assert len(preempted) == count
    jobs = {a.id: a.job_id for a in port.state.iter_allocs()}
    assert {jobs[i] for i in preempted} == {"filler"}
    view = port.state.usage.view()
    assert not bool((view.used > view.cap + 1e-3).any())


def test_port_state_after_all_jobs_matches_usage_invariants(slice_run):
    """Every live committed alloc is in the port's usage view: the
    committed used matrix is the sum of the placed asks, row by row, and
    preempted allocations no longer count."""
    _, port, _, _ = slice_run
    view = port.state.usage.view()
    asks = {job_id: (cpu, mem) for job_id, _, cpu, mem, _, _ in JOBS}
    want = np.zeros((view.cap.shape[0], 2), np.float64)
    for a in port.state.iter_allocs():
        if a.desired_status != "evict":
            want[view.row[a.node_id]] += asks[a.job_id]
    np.testing.assert_allclose(view.used[:, :2], want)


def test_carry_loads_jobs_and_allocs_bit_equal(slice_run):
    """The reference's state after all the evals — nodes, jobs and
    allocations — carried into a fresh port store gives the same usage
    view, row for row, and the same allocations."""
    _, _, out, ref = slice_run
    docs = {"nodes": [to_api(n) for n in ref.state.iter_nodes()],
            "jobs": [to_api(j) for j in ref.state.iter_jobs()],
            "allocs": [to_api(a) for a in ref.state.iter_allocs()]}
    fresh = PortFSM()
    load_cluster(fresh.state, docs)
    want, got = ref.state.usage.view(), fresh.state.usage.view()
    assert got.row == want.row
    np.testing.assert_array_equal(got.cap, want.cap)
    np.testing.assert_array_equal(got.used, want.used)
    assert {a.id: a.node_id for a in fresh.state.iter_allocs()} == \
        {a.id: a.node_id for a in ref.state.iter_allocs()}
    assert len(docs["allocs"]) == sum(r[3] for r in out.values())
