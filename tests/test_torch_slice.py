"""The port's whole placement slice against the reference, on the CPU.

One ~200-node cluster is built in the JAX package's FSM with pinned node
ids, exported as API JSON and carried into nomad_tpu_torch's FSM with
`carry.load_cluster`. The same jobs then run on both sides under the same
eval ids — scheduler → placer → solve → serial plan applier → FSM commit
— and the committed alloc-name → node-id maps must be identical for:

  * a 200-task batch job (m = 2·200/200 > 3: the dense depth curve),
  * a small job (m < 3: the sampled depth grid, jittered),
  * a count-1 job (the greedy score/capacity solve).

A fourth job carries a `spread` stanza. The reference solves it with the
chunked XLA scan; the port hands it to the host GenericStack, so the
two maps may differ. It is held to its properties instead: every
instance placed, no node overcommitted, the datacenters even.
"""
import numpy as np
import jax  # noqa: F401  (the reference runs on the CPU backend)
import pytest
import torch

import nomad_tpu.mock as ref_mock
from nomad_tpu.api_codec import to_api
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

N_NODES = 200
# (job id, count, cpu MHz, mem MB, spread stanza, kernel the port runs)
JOBS = (
    ("dense", 200, 250, 512, False, "depth"),
    ("grid", 60, 250, 512, False, "depth"),
    ("greedy", 1, 500, 1024, False, "greedy"),
    ("spread", 20, 300, 256, True, None),
)


def _mk_node(mock, i, rng):
    """The bench fleet's node recipe (bench.py _mk_node), id pinned."""
    n = mock.node()
    n.id = f"slice-node-{i:06d}"
    n.name = f"bench-{i}"
    n.node_class = f"c{int(rng.integers(0, 4))}"
    n.datacenter = "dc1" if i % 2 == 0 else "dc2"
    n.node_resources.cpu.cpu_shares = int(
        rng.choice([4_000, 8_000, 16_000, 32_000]))
    n.node_resources.memory.memory_mb = int(
        rng.choice([8_192, 16_384, 32_768, 65_536]))
    n.node_resources.disk.disk_mb = 500_000
    return n


def _mk_job(mock, structs, job_id, count, cpu, mem, spread):
    job = mock.batch_job()
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
    if spread:
        job.spreads = [structs.Spread(attribute="${node.datacenter}",
                                      weight=100)]
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


def _run(fsm, planner, new_scheduler, structs, job):
    s = fsm.state
    s.upsert_job(s.latest_index() + 1, job)
    ev = structs.Evaluation(id=f"slice-eval-{job.id}", namespace="default",
                            job_id=job.id, type="batch", priority=50)
    s.upsert_evals(s.latest_index() + 1, [ev])
    sched = new_scheduler("batch", s.snapshot(), _Shim(planner, s))
    sched.process(ev)
    return {a.name: a.node_id for a in s.iter_allocs()
            if a.job_id == job.id}


def _kernel_counters():
    return {f"{k}.{t}": port_metrics.counter(f"nomad.solver.kernel.{k}.{t}")
            for k in ("depth", "greedy") for t in ("torch", "cuda")}


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
        ref_cfg = ref_structs.SchedulerConfiguration(**cfg_kw)
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
        for job_id, count, cpu, mem, spread, _ in JOBS:
            before = _kernel_counters()
            want = _run(ref, ref_planner, ref_new_scheduler, ref_structs,
                        _mk_job(ref_mock, ref_structs, job_id, count, cpu,
                                mem, spread))
            got = _run(port, port_planner, port_new_scheduler,
                       port_structs,
                       _mk_job(port_mock, port_structs, job_id, count,
                               cpu, mem, spread))
            after = _kernel_counters()
            out[job_id] = (want, got, {k: after[k] - before[k]
                                       for k in after})
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


@pytest.mark.parametrize("job", [j for j in JOBS if not j[4]],
                         ids=[j[0] for j in JOBS if not j[4]])
def test_port_places_exactly_like_reference(slice_run, job):
    job_id, count, _, _, _, kernel = job
    _, _, out, _ = slice_run
    want, got, moved = out[job_id]
    assert len(want) == count
    assert got == want
    # the port solved it with its plain (CPU) tier, never the card's
    assert moved[f"{kernel}.torch"] == 1
    assert moved["depth.cuda"] == moved["greedy.cuda"] == 0


def test_spread_job_meets_its_placement_properties(slice_run):
    """The host-stack fallback's spread placement: all placed, nothing
    overcommitted, datacenters even — and no solver kernel ran."""
    _, port, out, _ = slice_run
    _, got, moved = out["spread"]
    count = [j for j in JOBS if j[0] == "spread"][0][1]
    assert len(got) == count
    assert not any(moved.values())
    dc = {n.id: n.datacenter for n in port.state.iter_nodes()}
    by_dc = {"dc1": 0, "dc2": 0}
    for node_id in got.values():
        by_dc[dc[node_id]] += 1
    assert by_dc["dc1"] == by_dc["dc2"] == count // 2
    view = port.state.usage.view()
    assert not bool((view.used > view.cap + 1e-3).any())


def test_port_state_after_all_jobs_matches_usage_invariants(slice_run):
    """Every committed alloc is in the port's usage view: the committed
    used matrix is the sum of the placed asks, row by row."""
    _, port, out, _ = slice_run
    view = port.state.usage.view()
    asks = {job_id: (cpu, mem) for job_id, _, cpu, mem, _, _ in JOBS}
    want = np.zeros((view.cap.shape[0], 2), np.float64)
    for job_id, (_, got, _) in out.items():
        for node_id in got.values():
            want[view.row[node_id]] += asks[job_id]
    np.testing.assert_allclose(view.used[:, :2], want)


def test_carry_loads_jobs_and_allocs_bit_equal(slice_run):
    """The reference's state after all four evals — nodes, jobs and
    allocations — carried into a fresh port store gives the same usage
    view, row for row, and the same allocations."""
    _, _, _, ref = slice_run
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
    assert len(docs["allocs"]) == sum(j[1] for j in JOBS)
