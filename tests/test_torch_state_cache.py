"""The port's card-resident state cache (nomad_tpu_torch/solver/
state_cache.py) against the reference's cache and against a fresh view,
on the CPU: port counterparts of tests/test_state_cache.py.

Every test drives the SAME operations through a reference store and a
port store (pinned node and alloc ids) and requires the port's gathered
tensors to be byte-equal to the port view's fresh rows AND to the
reference cache's gather. The port solves on the CPU here
(use_device("cpu")), so its twins are CPU tensors: they must equal the
host mirrors bit for bit after every advance.
"""
import random
import types

import numpy as np
import pytest
import torch

import nomad_tpu.faults as ref_faults
import nomad_tpu.mock as ref_mock
import nomad_tpu.structs as ref_structs
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.scheduler import new_scheduler as ref_new_scheduler
from nomad_tpu.server.fsm import NomadFSM as RefFSM
from nomad_tpu.server.fsm import PlanApplyRequest as RefPAR
from nomad_tpu.server.fsm import RaftLog as RefRaftLog
from nomad_tpu.server.plan_apply import Planner as RefPlanner
from nomad_tpu.solver import state_cache as ref_cache
from nomad_tpu.state import StateStore as RefStore
from nomad_tpu.state import usage_index as ref_usage_index

import nomad_tpu_torch.faults as port_faults
import nomad_tpu_torch.mock as port_mock
import nomad_tpu_torch.structs as port_structs
from nomad_tpu_torch.metrics import metrics as port_metrics
from nomad_tpu_torch.scheduler import Harness as PortHarness
from nomad_tpu_torch.scheduler import new_scheduler as port_new_scheduler
from nomad_tpu_torch.server import plan_apply as port_plan_apply
from nomad_tpu_torch.server.fsm import NomadFSM as PortFSM
from nomad_tpu_torch.server.fsm import PlanApplyRequest as PortPAR
from nomad_tpu_torch.server.fsm import RaftLog as PortRaftLog
from nomad_tpu_torch.server.plan_apply import Planner as PortPlanner
from nomad_tpu_torch.solver import backend as port_backend
from nomad_tpu_torch.solver import state_cache as port_cache
from nomad_tpu_torch.solver.device import use_device
from nomad_tpu_torch.state import StateStore as PortStore
from nomad_tpu_torch.state import usage_index as port_usage_index

REF = types.SimpleNamespace(
    mock=ref_mock, structs=ref_structs, Store=RefStore, PAR=RefPAR,
    FSM=RefFSM, RaftLog=RefRaftLog, Planner=RefPlanner, faults=ref_faults,
    cache=ref_cache, Harness=RefHarness, new_scheduler=ref_new_scheduler,
    usage_index=ref_usage_index)
PORT = types.SimpleNamespace(
    mock=port_mock, structs=port_structs, Store=PortStore, PAR=PortPAR,
    FSM=PortFSM, RaftLog=PortRaftLog, Planner=PortPlanner,
    faults=port_faults, cache=port_cache, Harness=PortHarness,
    new_scheduler=port_new_scheduler, usage_index=port_usage_index)
SIDES = (REF, PORT)


@pytest.fixture(autouse=True)
def _fresh_cache():
    prev, threads = use_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    port_backend.reset()
    for side in SIDES:
        side.cache.reset()
        side.faults.clear()
    yield
    for side in SIDES:
        side.cache.reset()
        side.faults.clear()
    torch.set_num_threads(threads)
    use_device(prev)
    port_backend.reset()


# ------------------------------------------------------------------ helpers

def _mk_alloc(side, alloc_id, node_id, job_id="j1", cpu=100, mem=128):
    s = side.structs
    return s.Allocation(
        id=alloc_id, namespace="default", eval_id=f"ev-{alloc_id}",
        name=f"{job_id}.web[0]", job_id=job_id, task_group="web",
        node_id=node_id, node_name=node_id, desired_status="run",
        client_status="pending",
        allocated_resources=s.AllocatedResources(
            shared=s.AllocatedSharedResources(disk_mb=150),
            tasks={"t": s.AllocatedTaskResources(cpu_shares=cpu,
                                                 memory_mb=mem)}))


def _mk_node(side, i, cpu=None):
    n = side.mock.node()
    n.id = f"node-{i:04d}"
    n.name = f"sc-{i}"
    if cpu is not None:
        n.node_resources.cpu.cpu_shares = cpu
    return n


def _seed_stores(n_nodes):
    """{side: store} with the same pinned nodes, and the next index."""
    stores = {}
    for side in SIDES:
        store = side.Store()
        store.set_scheduler_config(1, side.structs.SchedulerConfiguration(
            scheduler_algorithm="tpu-batch"))
        for i in range(n_nodes):
            store.upsert_node(2 + i, _mk_node(side, i))
        stores[id(side)] = store
    return (lambda side: stores[id(side)]), 2 + n_nodes


def _port_twins_match_mirrors(msg=""):
    """The port's CPU twins equal its host mirrors bit for bit; padding
    rows are zero."""
    c = port_cache.cache()
    cap_dev, used_dev = c.twins()
    assert used_dev is not None, f"no twins {msg}"
    assert used_dev.device.type == "cpu"
    n = c.cap.shape[0]
    assert used_dev.shape[0] >= n
    assert used_dev[:n].numpy().tobytes() == c.used.tobytes(), msg
    assert cap_dev[:n].numpy().tobytes() == c.cap.tobytes(), msg
    assert not bool(used_dev[n:].any()) and not bool(cap_dev[n:].any())


def _assert_parity(store_of, rng=None, msg=""):
    """The port cache's gather is byte-equal to the port view's fresh
    rows and to the reference cache's gather; its counts equal the
    store's; its CPU twins equal its mirrors. -> the port view."""
    got = {}
    for side in SIDES:
        view = store_of(side).snapshot().usage
        n = view.cap.shape[0]
        perm = (np.arange(n, dtype=np.int64) if rng is None
                else np.random.default_rng(rng).permutation(n))
        g = side.cache.gather(view, perm.astype(np.int64))
        assert g is not None, msg
        assert g.cap.tobytes() == view.cap[perm].tobytes(), \
            f"cap diverged {msg}"
        assert g.used.tobytes() == view.used[perm].tobytes(), \
            f"used diverged {msg}"
        assert side.cache.cache().version <= view.version, msg
        assert np.array_equal(side.cache.cache().counts[:n], view.counts)
        got[id(side)] = (g, view)
    (gr, _), (gp, view) = got[id(REF)], got[id(PORT)]
    assert gp.cap.tobytes() == gr.cap.tobytes(), f"port != ref {msg}"
    assert gp.used.tobytes() == gr.used.tobytes(), f"port != ref {msg}"
    _port_twins_match_mirrors(msg)
    return view


# ------------------------------------------------ randomized replay parity

def test_randomized_plan_stream_is_bit_identical():
    """A randomized stream of plan commits, stops, preemptions, node
    add/drain/down/deregister and client failures, through both stores:
    after every step the port's tensors match a fresh rebuild and the
    reference's cache byte for byte."""
    rng = np.random.default_rng(20260803)
    store_of, idx = _seed_stores(24)
    node_ids = [f"node-{i:04d}" for i in range(24)]
    next_node = len(node_ids)
    live: list[tuple] = []      # (alloc id, node id, job id, cpu, mem)
    seq = 0
    _assert_parity(store_of, 1, "after seed")
    for step in range(120):
        op = int(rng.integers(0, 10))
        if op <= 4 or not live:             # plan apply: fresh placements
            placements = []
            for _ in range(int(rng.integers(1, 6))):
                seq += 1
                placements.append((
                    f"alloc-{seq:05d}",
                    node_ids[int(rng.integers(0, len(node_ids)))],
                    f"job-{int(rng.integers(0, 5))}",
                    int(rng.choice([50, 100, 250])),
                    int(rng.choice([64, 128, 256]))))
            stops = []
            if live and rng.random() < 0.4:
                stops.append(live.pop(int(rng.integers(0, len(live)))))
            preempted = []
            if live and rng.random() < 0.2:
                preempted.append(live.pop(int(rng.integers(0, len(live)))))
            for side in SIDES:
                def done(a, desired):
                    out = _mk_alloc(side, *a)
                    out.desired_status = desired
                    out.client_status = "complete"
                    return out
                store_of(side).upsert_plan_results(idx, side.PAR(
                    alloc_updates=[done(a, "stop") for a in stops],
                    alloc_placements=[_mk_alloc(side, *a)
                                      for a in placements],
                    alloc_preemptions=[done(a, "evict")
                                       for a in preempted]))
            live.extend(placements)
        elif op == 5:                        # client-side failure
            a = live.pop(int(rng.integers(0, len(live))))
            for side in SIDES:
                failed = _mk_alloc(side, *a)
                failed.client_status = "failed"
                store_of(side).update_allocs_from_client(idx, [failed])
        elif op == 6:                        # node add (epoch bump)
            for side in SIDES:
                store_of(side).upsert_node(idx, _mk_node(side, next_node))
            node_ids.append(f"node-{next_node:04d}")
            next_node += 1
        elif op == 7:                        # drain flip
            node_id = node_ids[int(rng.integers(0, len(node_ids)))]
            on = rng.random() < 0.5
            for side in SIDES:
                store_of(side).update_node_drain(
                    idx, node_id,
                    side.structs.DrainStrategy(deadline_sec=60) if on
                    else None, True)
        elif op == 8:                        # node down/up
            node_id = node_ids[int(rng.integers(0, len(node_ids)))]
            status = "down" if rng.random() < 0.5 else "ready"
            for side in SIDES:
                store_of(side).update_node_status(idx, node_id, status, 0.0)
        elif len(node_ids) > 8:              # deregister (epoch bump)
            node_id = node_ids.pop(int(rng.integers(0, len(node_ids))))
            for side in SIDES:
                store_of(side).delete_node(idx, [node_id])
            live = [a for a in live if a[1] != node_id]
        idx += 1
        _assert_parity(store_of, step, f"after step {step}")
    stats = port_cache.cache().stats()
    assert stats["version"] > 0 and stats["rows"] >= 24
    assert stats["twins_device"] == "cpu"


def test_twins_equal_host_mirrors_after_every_advance():
    """Plans committed through the port's real applier advance the cache
    on the commit hook (note_commit), with no eval in between: after
    every commit the CPU twins equal the host mirrors and a fresh view,
    and a bucket-padded device gather returns exactly the host rows."""
    fsm = PortFSM()
    s = fsm.state
    s.set_scheduler_config(1, port_structs.SchedulerConfiguration(
        scheduler_algorithm="tpu-batch"))
    for i in range(10):
        s.upsert_node(2 + i, _mk_node(PORT, i))
    planner = PortPlanner(PortRaftLog(fsm), s)
    view = s.snapshot().usage
    rows = np.arange(view.cap.shape[0], dtype=np.int64)
    assert port_cache.gather(view, rows) is not None      # seed
    rng = np.random.default_rng(11)
    for step in range(12):
        plan = port_structs.Plan(eval_id=f"ev-{step}", priority=50,
                                 snapshot_index=s.latest_index())
        for j in range(int(rng.integers(1, 4))):
            node_id = f"node-{int(rng.integers(0, 10)):04d}"
            plan.node_allocation.setdefault(node_id, []).append(
                _mk_alloc(PORT, f"a-{step}-{j}", node_id,
                          cpu=int(rng.choice([50, 100, 250]))))
        v0 = port_cache.cache().version
        planner.apply_plan(plan)
        c = port_cache.cache()
        assert c.version > v0, f"commit {step} did not advance the cache"
        _port_twins_match_mirrors(f"after commit {step}")
        view = s.snapshot().usage
        assert c.used.tobytes() == view.used.tobytes()
        perm = rng.permutation(view.cap.shape[0]).astype(np.int64)
        g = port_cache.gather(view, perm, bucket=16, tier="torch")
        n = len(perm)
        assert g.used_dev.shape == (16, view.used.shape[1])
        assert g.used_dev[:n].numpy().tobytes() == g.used.tobytes()
        assert g.cap_dev[:n].numpy().tobytes() == g.cap.tobytes()
        assert not bool(g.used_dev[n:].any())
    # a tier that solves elsewhere gets no device pair
    g = port_cache.gather(s.snapshot().usage, perm, bucket=16, tier="cuda")
    assert g.used_dev is None and g.cap_dev is None


def test_stale_snapshot_served_from_ring_generation():
    """A snapshot older than the cache head is served from a displaced
    generation, byte-exact, on both sides."""
    store_of, idx = _seed_stores(12)
    _assert_parity(store_of)
    old = {id(side): store_of(side).snapshot().usage for side in SIDES}
    for side in SIDES:
        store_of(side).upsert_plan_results(idx, side.PAR(
            alloc_placements=[_mk_alloc(side, "a-0", "node-0000"),
                              _mk_alloc(side, "a-3", "node-0003")]))
    _assert_parity(store_of)
    ring0 = port_metrics.counter("nomad.solver.state_cache.ring_hits")
    got = {}
    for side in SIDES:
        v = old[id(side)]
        rows = np.arange(v.cap.shape[0], dtype=np.int64)
        g = side.cache.gather(v, rows)
        assert g.cap.tobytes() == v.cap[rows].tobytes()
        assert g.used.tobytes() == v.used[rows].tobytes()
        got[id(side)] = g.used.tobytes()
    assert got[id(PORT)] == got[id(REF)]
    assert port_metrics.counter("nomad.solver.state_cache.ring_hits") == \
        ring0 + 1


def test_journal_trim_gap_falls_back_to_rebuild(monkeypatch):
    """Evicting journal entries past the cache's cursor gives a clean
    reseed (a miss), never a silent divergence."""
    for side in SIDES:
        monkeypatch.setattr(side.usage_index.DeltaLog, "MAX", 8)
        monkeypatch.setattr(side.usage_index.DeltaLog, "KEEP", 4)
    store_of, idx = _seed_stores(10)
    _assert_parity(store_of, 5)
    before = port_metrics.counter("nomad.solver.state_cache.reseeds")
    for burst in range(6):
        for side in SIDES:
            store_of(side).upsert_plan_results(idx, side.PAR(
                alloc_placements=[
                    _mk_alloc(side, f"a-{burst}-{i}", f"node-{i:04d}")
                    for i in range(5)]))
        idx += 1
    _assert_parity(store_of, 5, "after trim burst")
    assert port_metrics.counter("nomad.solver.state_cache.reseeds") > before


def _grow_capacity(store_of, idx):
    for side in SIDES:
        store_of(side).upsert_node(idx, _mk_node(side, 2, cpu=8000))


def _restore(store_of, idx):
    """Each side's store becomes a restored copy of itself (a new usage
    stream: a new uid)."""
    restored = {}
    for side in SIDES:
        fsm = side.FSM()
        fsm.state = store_of(side)
        fsm2 = side.FSM()
        fsm2.restore_bytes(fsm.snapshot_bytes())
        assert fsm2.state.usage.uid != store_of(side).usage.uid
        restored[id(side)] = fsm2.state
    return lambda side: restored[id(side)]


@pytest.mark.parametrize("change", [_grow_capacity, _restore],
                         ids=["capacity_change", "restore"])
def test_node_set_change_reseeds(change):
    """A capacity change (epoch bump) and a snapshot restore (new uid)
    both reseed the cache; the reseeded tensors stay exact."""
    store_of, idx = _seed_stores(10)
    for side in SIDES:
        store_of(side).upsert_plan_results(idx, side.PAR(
            alloc_placements=[_mk_alloc(side, "a-1", "node-0001"),
                              _mk_alloc(side, "a-4", "node-0004")]))
    view0 = _assert_parity(store_of)
    before = port_metrics.counter("nomad.solver.state_cache.reseeds")
    store_of = change(store_of, idx + 1) or store_of
    view1 = _assert_parity(store_of, msg="after the change")
    assert (view1.uid, view1.epoch) != (view0.uid, view0.epoch)
    assert port_metrics.counter("nomad.solver.state_cache.reseeds") == \
        before + 1


def _disabled_view(monkeypatch):
    monkeypatch.setenv("NOMAD_STATE_CACHE", "0")
    store = PortStore()
    for i in range(8):
        store.upsert_node(2 + i, _mk_node(PORT, i))
    return store.snapshot().usage


def _unversioned_view(monkeypatch):
    return port_usage_index.UsageView({}, np.zeros((4, 5), np.float32),
                                      np.zeros((4, 5), np.float32))


@pytest.mark.parametrize("make_view", [_disabled_view, _unversioned_view],
                         ids=["disabled", "unversioned"])
def test_cache_stays_out_of_the_way(monkeypatch, make_view):
    """NOMAD_STATE_CACHE=0, and views without a versioning stamp (uid 0,
    plain test fakes): gather returns None and the cache stays empty."""
    view = make_view(monkeypatch)
    rows = np.arange(view.cap.shape[0], dtype=np.int64)
    assert port_cache.gather(view, rows, bucket=8, tier="torch") is None
    assert port_cache.cache().stats()["rows"] == 0


# ------------------------------------------------- placement differential

def _run_placements(side, count: int, eval_id: str, n_nodes: int = 16):
    """One fixed-seed scheduler run; -> {alloc name: node id}."""
    random.seed(1234)
    h = side.Harness()
    h.state.set_scheduler_config(
        h.get_next_index(),
        side.structs.SchedulerConfiguration(scheduler_algorithm="tpu-batch"))
    for i in range(n_nodes):
        h.state.upsert_node(h.get_next_index(), _mk_node(side, i))
    job = side.mock.batch_job()
    job.id = job.name = f"sc-job-{count}"
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    tg.tasks[0].resources.networks = []
    tg.tasks[0].resources.cpu = 250
    tg.tasks[0].resources.memory_mb = 128
    h.state.upsert_job(h.get_next_index(), job)
    ev = side.structs.Evaluation(id=eval_id, job_id=job.id, type=job.type)
    h.process(lambda s, p: side.new_scheduler(job.type, s, p), ev)
    allocs = h.state.allocs_by_job("default", job.id)
    assert len(allocs) == count
    return {a.name: a.node_id for a in allocs}


@pytest.mark.parametrize("count", [6, 48])
def test_placements_identical_cache_on_vs_off(monkeypatch, count):
    """Cache-served evals place EXACTLY what view-built evals place, and
    what the reference places, in the jittered sampled-grid regime
    (count 6 on 16 nodes) and the deterministic full-curve regime
    (count 48, m > 3)."""
    want = _run_placements(REF, count, f"sc-eval-{count}")
    hits0 = port_cache.cache().stats()["hits"]
    with_cache = _run_placements(PORT, count, f"sc-eval-{count}")
    stats = port_cache.cache().stats()
    assert stats["rows"] > 0 and stats["twins_device"] == "cpu", \
        "cache never engaged"
    assert stats["hits"] + stats["misses"] > hits0
    port_cache.reset()
    monkeypatch.setenv("NOMAD_STATE_CACHE", "0")
    without = _run_placements(PORT, count, f"sc-eval-{count}")
    assert port_cache.cache().stats()["rows"] == 0
    assert with_cache == without == want


def test_second_eval_hits_without_rebuild():
    """Steady state: evals after the first are served by a journal
    advance (a hit), never a reseed."""
    random.seed(99)
    h = PortHarness()
    h.state.set_scheduler_config(
        h.get_next_index(),
        port_structs.SchedulerConfiguration(scheduler_algorithm="tpu-batch"))
    for i in range(12):
        h.state.upsert_node(h.get_next_index(), _mk_node(PORT, i))
    for j in range(3):
        job = port_mock.batch_job()
        job.id = job.name = f"hit-job-{j}"
        tg = job.task_groups[0]
        tg.count = 4
        tg.networks = []
        tg.tasks[0].resources.networks = []
        h.state.upsert_job(h.get_next_index(), job)
        before = port_metrics.counter("nomad.solver.state_cache.misses")
        hits = port_cache.cache().stats()["hits"]
        ev = port_structs.Evaluation(job_id=job.id, type=job.type)
        h.process(lambda s, p: port_new_scheduler(job.type, s, p), ev)
        after = port_metrics.counter("nomad.solver.state_cache.misses")
        if j > 0:
            assert after == before, "steady-state eval re-seeded the cache"
            assert port_cache.cache().stats()["hits"] > hits
    assert len(h.state.allocs_by_job("default", "hit-job-2")) == 4


# ------------------------------------------------------------------ chaos

@pytest.mark.parametrize("site", ["planner.apply", "raft.apply"])
def test_failed_commit_never_moves_the_cache(site):
    """A fault at the plan applier or at the raft commit commits nothing:
    the cache neither advances nor diverges, on either side, and the
    retried plan's commit replays cleanly."""
    planners, plans, stores = {}, {}, {}
    for side in SIDES:
        fsm = side.FSM()
        s = fsm.state
        s.set_scheduler_config(1, side.structs.SchedulerConfiguration(
            scheduler_algorithm="tpu-batch"))
        for i in range(10):
            s.upsert_node(2 + i, _mk_node(side, i))
        stores[id(side)] = s
        planners[id(side)] = side.Planner(side.RaftLog(fsm), s)
        plan = side.structs.Plan(eval_id="chaos-eval", priority=50,
                                 snapshot_index=s.latest_index())
        plan.node_allocation = {"node-0000": [
            _mk_alloc(side, "chaos-alloc", "node-0000")]}
        plans[id(side)] = plan
    store_of = lambda side: stores[id(side)]   # noqa: E731
    _assert_parity(store_of, msg="pre-chaos")
    v_before = port_cache.cache().version
    spec = ({"planner.apply": {"mode": "nth_call", "n": 1, "times": 1}}
            if site == "planner.apply"
            else {"raft.apply": {"mode": "raise", "times": 1}})
    for side in SIDES:
        side.faults.install(dict(spec))
        with pytest.raises(side.faults.FaultError):
            planners[id(side)].apply_plan(plans[id(side)])
        assert not store_of(side).allocs, "failed apply leaked allocations"
    _assert_parity(store_of, msg="after the failed commit")
    assert port_cache.cache().version == v_before
    for side in SIDES:
        result = planners[id(side)].apply_plan(plans[id(side)])
        assert result.alloc_index > 0 and len(store_of(side).allocs) == 1
    view = _assert_parity(store_of, msg="after the recovery commit")
    assert port_cache.cache().version == view.version


def test_older_epoch_snapshot_never_rolls_the_cache_back():
    """A worker holding a pre-churn snapshot is served from its own view,
    not by reseeding the shared cache backward."""
    store_of, idx = _seed_stores(10)
    old = store_of(PORT).snapshot().usage
    for side in SIDES:
        store_of(side).upsert_node(idx, _mk_node(side, 9999))  # epoch bump
    new = _assert_parity(store_of, msg="post-churn")
    epoch_after = port_cache.cache().stats()["epoch"]
    stale0 = port_metrics.counter("nomad.solver.state_cache.stale")
    rows = np.arange(old.cap.shape[0], dtype=np.int64)
    got = port_cache.gather(old, rows, bucket=16, tier="torch")
    assert got.cap.tobytes() == old.cap[rows].tobytes()
    assert got.used.tobytes() == old.used[rows].tobytes()
    assert got.used_dev is None             # no twins for a stale view
    assert port_cache.cache().stats()["epoch"] == epoch_after
    assert port_metrics.counter("nomad.solver.state_cache.stale") == \
        stale0 + 1
    assert new.epoch > old.epoch


def test_note_commit_row_race_is_refused_not_corrupting():
    """note_commit reads epoch/version without the store lock; journal
    entries for rows past the cache arrays (a node register raced in)
    make the advance refuse — never IndexError, never a partial batch."""
    store_of, idx = _seed_stores(8)
    _assert_parity(store_of)
    for side in SIDES:
        s = store_of(side)
        s.upsert_node(idx, _mk_node(side, 99))
        s.upsert_plan_results(idx + 1, side.PAR(
            alloc_placements=[_mk_alloc(side, "race", "node-0099")]))
    for side in SIDES:
        c = side.cache.cache()
        version = c.version
        c._epoch = store_of(side).usage.epoch   # force the raced check past
        side.cache.note_commit(store_of(side))  # must not raise
        assert c.version == version, "a raced batch was applied"
        c._epoch = -1
    _assert_parity(store_of, msg="after the raced note_commit")


def test_fork_views_never_touch_the_shared_cache():
    """Dry-run forks (uid 0) bypass the cache instead of evicting the
    live stream's resident state."""
    store_of, idx = _seed_stores(10)
    _assert_parity(store_of)
    before = port_cache.cache().stats()
    fork = store_of(PORT).fork()
    fork.upsert_plan_results(idx, PortPAR(
        alloc_placements=[_mk_alloc(PORT, "dry", "node-0000")]))
    fview = fork.snapshot().usage
    assert fview.uid == 0
    rows = np.arange(fview.cap.shape[0], dtype=np.int64)
    assert port_cache.gather(fview, rows, bucket=16, tier="torch") is None
    assert port_cache.cache().stats() == before
    _assert_parity(store_of, msg="live stream after fork activity")


# --------------------------------------------------- the applier's hooks

def test_plan_apply_copy_feeds_and_reads_the_cache(monkeypatch):
    """The port's byte-for-byte copy of plan_apply.py finds the port's
    cache: its evaluate pass gathers the plan's rows through
    state_cache.gather, and every commit batch ends in note_commit."""
    assert port_plan_apply.__file__.endswith(
        "nomad_tpu_torch/server/plan_apply.py")
    calls = []
    real_gather, real_note = port_cache.gather, port_cache.note_commit

    def gather(view, rows, *a, **kw):
        out = real_gather(view, rows, *a, **kw)
        calls.append(("gather", view.uid, sorted(int(r) for r in rows),
                      out is not None))
        return out

    def note_commit(store):
        calls.append(("note_commit", store.usage.version))
        return real_note(store)

    monkeypatch.setattr(port_cache, "gather", gather)
    monkeypatch.setattr(port_cache, "note_commit", note_commit)
    fsm = PortFSM()
    s = fsm.state
    s.set_scheduler_config(1, port_structs.SchedulerConfiguration(
        scheduler_algorithm="tpu-batch"))
    for i in range(6):
        s.upsert_node(2 + i, _mk_node(PORT, i))
    planner = PortPlanner(PortRaftLog(fsm), s)
    row = s.usage.view().row
    for k, node_id in enumerate(("node-0002", "node-0005")):
        plan = port_structs.Plan(eval_id=f"hook-{k}", priority=50,
                                 snapshot_index=s.latest_index())
        plan.node_allocation = {node_id: [
            _mk_alloc(PORT, f"hook-{k}", node_id)]}
        planner.apply_plan(plan)
        assert calls[-2][0] == "gather" and calls[-2][2] == [row[node_id]]
        assert calls[-2][3], "the evaluate pass's gather found no cache"
        assert calls[-1] == ("note_commit", s.usage.version)
    # the second commit's evaluate pass was a hit on the first's feed
    assert port_cache.cache().stats()["hits"] >= 1
    _port_twins_match_mirrors("after the hooked commits")


def test_standby_feed_and_reseed_follow_the_reference():
    """The follower-side feed adopts an empty cache and advances it with
    the store's commits; another store's feed leaves it alone; a leader
    reseed is warm for the tracked store and pays a full reseed for
    another — outcome for outcome the reference's, bits equal."""
    store_of, idx = _seed_stores(8)
    other_of, _ = _seed_stores(8)
    for side in SIDES:
        side.cache.standby_feed(store_of(side))         # adopt + seed
        side.cache.standby_feed(other_of(side))         # not the owner
        store_of(side).upsert_plan_results(idx, side.PAR(
            alloc_placements=[_mk_alloc(side, "fed", "node-0003")]))
        side.cache.standby_feed(store_of(side))         # advance
    c = port_cache.cache()
    view = store_of(PORT).snapshot().usage
    assert (c.stats()["uid"], c.version) == (view.uid, view.version)
    assert c.used.tobytes() == view.used.tobytes()
    assert c.used.tobytes() == ref_cache.cache().used.tobytes()
    _port_twins_match_mirrors("after the standby feed")
    outcomes = {}
    for side in SIDES:
        outcomes[id(side)] = (side.cache.reseed(store_of(side)),
                              side.cache.reseed(other_of(side)),
                              side.cache.reseed(other_of(side)))
    assert outcomes[id(PORT)] == outcomes[id(REF)] == (
        {"warm": True, "rows": 8}, {"warm": False, "rows": 8},
        {"warm": True, "rows": 8})
    _assert_parity(other_of, msg="after the reseeds")
