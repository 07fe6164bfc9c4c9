"""The port's in-process server against the reference's, on the CPU.

`nomad_tpu_torch.server.Server` is a copy of the reference's (one line
names the port's backend module). Both run the same scenarios from the
same seeded os.urandom stream, so they mint the same eval and alloc ids
and their schedulers shuffle alike; with one worker each, every step
ends in the same committed state:

  * a batch job, a spread service job, a job too large to place whole
    (its blocked eval), a forced node drain (its migrations) and a
    deregister: alloc name -> node maps, eval statuses and the blocked
    evals' counts equal after each step;
  * four workers on eight contending jobs, with the batch tier off (its
    default) and on: everything placed, no node over capacity;
  * a device error on the card's chain (tests/test_torch_ladder.py's
    seam) nacks the eval; the broker redelivers it, and past the delivery
    limit the eval lands in the failed queue; no solve runs on the CPU;
  * the solver warmup drives every solve through its chain when forced
    below its floor, and a restart's establishment reseeds the state
    cache and warms under NOMAD_AOT_WARMUP=1;
  * Job.Register over the socket RPC is answered;
  * the operator debug bundle has the reference's keys;
  * the copied applier's in-flight signal is the micro-batcher's.

Every wait is bounded by a deadline and every server is shut down in a
`finally`.
"""
import time

import jax  # noqa: F401  (the reference runs on the CPU backend)
import numpy as np
import pytest
import torch

import nomad_tpu.mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.server import Server as RefServer
from nomad_tpu.solver import backend as ref_backend
from nomad_tpu.solver import microbatch as ref_microbatch

import nomad_tpu_torch.mock as port_mock
from nomad_tpu_torch import faults as port_faults
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.metrics import metrics
from nomad_tpu_torch.server import Server as PortServer
from nomad_tpu_torch.server.plan_apply import Planner
from nomad_tpu_torch.solver import backend, microbatch, state_cache
from nomad_tpu_torch.solver.device import use_device
from nomad_tpu_torch.testing import seeded_urandom

N_NODES = 24
DEADLINE_S = 30.0


@pytest.fixture(autouse=True)
def _clean():
    prev, threads = use_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    for mod in (backend, ref_backend, microbatch, ref_microbatch):
        mod.reset()
    state_cache.reset()
    port_faults.clear()
    yield
    port_faults.clear()
    for mod in (backend, ref_backend, microbatch, ref_microbatch):
        mod.reset()
    state_cache.reset()
    torch.set_num_threads(threads)
    use_device(prev)


def _wait(fn, what: str, timeout: float = DEADLINE_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _quiet(srv) -> bool:
    """No eval queued, delivered or pending, and no plan in the applier."""
    st = srv.eval_broker.stats
    return (st["total_ready"] == 0 and st["total_unacked"] == 0
            and st.get("total_pending", 0) == 0
            and srv.planner.queue.depth() == 0
            and all(e.status != "pending" for e in srv.state.iter_evals()))


def _settle(srv) -> None:
    """Quiet twice, a beat apart: a worker between dequeue and ack, or a
    watcher's eval on its way, shows up in between."""
    def settled():
        if not _quiet(srv):
            return False
        time.sleep(0.15)
        return _quiet(srv)
    _wait(settled, "the server to go quiet")


def _server(Server, structs, workers: int = 1):
    srv = Server(num_workers=workers, gc_interval=9999)
    # no client heartbeats here: keep the registered nodes up
    srv.heartbeats.min_ttl = 3600.0
    srv.start()
    srv.set_scheduler_configuration(structs.SchedulerConfiguration(
        scheduler_algorithm="tpu-batch"))
    return srv


def _mk_node(mock, i, rng):
    n = mock.node()
    n.id = f"srv-node-{i:06d}"
    n.name = f"srv-{i}"
    n.node_class = f"c{i % 3}"
    n.datacenter = f"dc{i % 3 + 1}"
    n.node_resources.cpu.cpu_shares = int(rng.choice([4_000, 8_000]))
    n.node_resources.memory.memory_mb = int(rng.choice([8_192, 16_384]))
    return n


def _mk_job(mock, structs, job_id, kind, count, cpu, mem, spread=False):
    job = mock.batch_job() if kind == "batch" else mock.job()
    job.id = job.name = job_id
    job.datacenters = ["dc1", "dc2", "dc3"]
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    task = tg.tasks[0]
    task.resources.cpu = cpu
    task.resources.memory_mb = mem
    task.resources.networks = []
    if spread:
        job.spreads = [structs.Spread(attribute="${node.datacenter}",
                                      weight=100)]
    return job


def _digest(srv) -> dict:
    s = srv.state
    return {
        "allocs": {a.name: a.node_id for a in s.iter_allocs()
                   if a.desired_status == "run"},
        "evals": sorted((e.id, e.job_id, e.triggered_by, e.status)
                        for e in s.iter_evals()),
        "blocked": dict(srv.blocked_evals.stats),
    }


def _scenario(Server, mock, structs) -> list:
    """Every step's digest, one worker, ids from the caller's seeded
    os.urandom block."""
    srv = _server(Server, structs)
    out = []
    try:
        rng = np.random.default_rng(7)
        for i in range(N_NODES):
            srv.node_register(_mk_node(mock, i, rng))
        _settle(srv)
        steps = (
            ("batch-a", "batch", 40, 500, 256, False),
            ("web", "service", 12, 250, 128, True),
            ("huge", "batch", 400, 2_000, 4_096, False),
        )
        for job_id, kind, count, cpu, mem, spread in steps:
            srv.job_register(_mk_job(mock, structs, job_id, kind, count,
                                     cpu, mem, spread))
            _settle(srv)
            out.append((job_id, _digest(srv)))
        # drain the node with the most web allocs, forced: every alloc on
        # it migrates at the drainer's next poll. The drain's own evals
        # run with the drainer held, then its poll marks the migrations
        # and their evals move them: one order on both sides (left free,
        # the poll lands before or after the worker takes the drain's
        # evals, and the two orders place differently)
        web = [a.node_id for a in srv.state.allocs_by_job("default", "web")]
        target = max(sorted(set(web)), key=web.count)
        srv.drainer.stop()
        srv.node_update_drain(target, structs.DrainStrategy(deadline_sec=-1))
        _settle(srv)
        srv.drainer.start()
        _wait(lambda: all(
            a.desired_transition.should_migrate()
            for a in srv.state.allocs_by_node(target)
            if not a.terminal_status()), "the drain's migrations")
        _settle(srv)
        out.append(("drain", _digest(srv)))
        srv.job_deregister("default", "batch-a")
        _settle(srv)
        out.append(("deregister", _digest(srv)))
    finally:
        srv.shutdown()
    return out


def test_one_worker_server_matches_the_reference_step_by_step():
    with seeded_urandom(11):
        want = _scenario(RefServer, ref_mock, ref_structs)
    with seeded_urandom(11):
        got = _scenario(PortServer, port_mock, port_structs)
    assert [s for s, _ in got] == [s for s, _ in want]
    for (step, w), (_, g) in zip(want, got):
        assert g["allocs"] == w["allocs"], step
        assert g["evals"] == w["evals"], step
        assert g["blocked"] == w["blocked"], step
    final = dict(want)
    # the scenario did what it says: a blocked eval, migrations, a stop
    assert final["huge"]["blocked"]["total_blocked"] >= 1
    assert any(t == "node-drain" for _, _, t, _ in final["drain"]["evals"])
    assert not any(n.startswith("batch-a.")
                   for n in final["deregister"]["allocs"])


@pytest.mark.parametrize("ceiling", [0, 2048], ids=["solo", "batch"])
def test_four_workers_place_contending_jobs_without_overcommit(monkeypatch,
                                                               ceiling):
    """With the batch tier off (its default ceiling) and on: every job
    placed whole, no node over capacity; the tier taken only when on."""
    monkeypatch.setattr(backend, "BATCH_MAX_COUNT", ceiling)

    def batched() -> float:
        return metrics.counter("nomad.solver.microbatch.dispatches") + \
            metrics.counter("nomad.solver.microbatch.solo")
    batched0 = batched()
    srv = _server(PortServer, port_structs, workers=4)
    try:
        rng = np.random.default_rng(3)
        for i in range(40):
            srv.node_register(_mk_node(port_mock, i, rng))
        ids = []
        for j in range(8):
            job = _mk_job(port_mock, port_structs, f"conc-{j}", "batch", 30,
                          250, 256)
            ids.append(srv.job_register(job)["eval_id"])
        _wait(lambda: all(
            (ev := srv.state.eval_by_id(i)) is not None
            and ev.status == "complete" for i in ids), "8 evals complete")
        for j in range(8):
            live = [a for a in srv.state.allocs_by_job("default", f"conc-{j}")
                    if a.desired_status == "run"]
            assert len(live) == 30, j
        view = srv.state.usage.view()
        assert not (view.used > view.cap + 1e-3).any()
        assert (batched() > batched0) == (ceiling > 0)
    finally:
        srv.shutdown()


@pytest.fixture
def card(monkeypatch):
    """The card's chain on the CPU: solves select the `cuda` tier, whose
    wrappers run their plain versions on CPU tensors."""
    monkeypatch.setattr(backend, "tier", lambda: "cuda")
    backend.reset()


def _cpu_solves() -> float:
    return metrics.counter("nomad.solver.dispatch.torch")


@pytest.mark.parametrize("times", [1, -1], ids=["once", "always"])
def test_device_error_nacks_the_eval_and_the_broker_redelivers(card, times):
    srv = _server(PortServer, port_structs)
    try:
        srv.eval_broker.initial_nack_delay = 0.02
        srv.eval_broker.subsequent_nack_delay = 0.02
        rng = np.random.default_rng(5)
        for i in range(N_NODES):
            srv.node_register(_mk_node(port_mock, i, rng))
        fails0 = metrics.counter("nomad.worker.eval_failures")
        errs0 = metrics.counter("nomad.solver.dispatch_errors.cuda")
        dead0 = metrics.counter("nomad.broker.dead_letter")
        cpu0 = _cpu_solves()
        port_faults.install({"solver.dispatch.cuda": {
            "mode": "raise", "times": times}})
        job = _mk_job(port_mock, port_structs, "faulted", "batch", 20, 500,
                      256)
        eval_id = srv.job_register(job)["eval_id"]
        if times == 1:
            # nacked once, redelivered, committed
            _wait(lambda: srv.state.eval_by_id(eval_id).status ==
                  "complete", "the redelivered eval to complete")
            assert len(srv.state.allocs_by_job("default", job.id)) == 20
            assert metrics.counter("nomad.worker.eval_failures") - \
                fails0 == 1
            assert metrics.counter(
                "nomad.solver.dispatch_errors.cuda") - errs0 == 1
        else:
            limit = srv.eval_broker.delivery_limit
            # every delivery raises: nacked up to the limit, then the
            # failed queue, where the leader's reaper fails the eval
            _wait(lambda: metrics.counter("nomad.broker.dead_letter") >
                  dead0, "the dead letter")
            _wait(lambda: srv.state.eval_by_id(eval_id).status == "failed",
                  "the reaper to fail the eval")
            assert metrics.counter("nomad.worker.eval_failures") - \
                fails0 == limit
            assert not srv.state.allocs_by_job("default", job.id)
        assert _cpu_solves() == cpu0
    finally:
        port_faults.clear()
        srv.shutdown()
        backend.reset()


@pytest.mark.parametrize("seam", ["torch", "card"])
def test_warmup_drives_every_solve_through_its_chain(request, monkeypatch,
                                                     seam):
    """backend.warmup below the floor only when forced: the depth curve
    dense and on the grid for each k_max, greedy, the chunked scan and a
    window, each through its chain without an error, and with no config
    or a "convex" one (the reference's rule) one convex eval per spread
    setting; =0 disables it."""
    if seam == "card":
        request.getfixturevalue("card")
    assert backend.warmup(64)["skipped"]
    monkeypatch.setenv("NOMAD_AOT_WARMUP", "1")
    errors0 = metrics.counter("nomad.solver.warmup.errors")
    cpu0 = _cpu_solves()
    convex0 = metrics.counter("nomad.solver.dispatch.convex")
    out = backend.warmup(64)
    assert not out["skipped"] and out["artifacts"] == 11
    assert out["bucket"] == 64
    assert metrics.counter("nomad.solver.dispatch.convex") == convex0 + 2
    batch = port_structs.SchedulerConfiguration(
        scheduler_algorithm="tpu-batch")
    assert backend.warmup(64, cfg=batch)["artifacts"] == 9
    assert metrics.counter("nomad.solver.warmup.errors") == errors0
    assert (_cpu_solves() > cpu0) == (seam == "torch")
    monkeypatch.setenv("NOMAD_AOT_WARMUP", "0")
    assert backend.warmup(4096)["skipped"]


def test_establish_reseeds_and_warms_when_forced(monkeypatch):
    """A restart over a snapshot: establishment reseeds the state cache
    and runs the solver warmup, below the 256-node floor only under
    NOMAD_AOT_WARMUP=1; the next eval places on the warm cache."""
    srv = _server(PortServer, port_structs)
    try:
        rng = np.random.default_rng(5)
        for i in range(12):
            srv.node_register(_mk_node(port_mock, i, rng))
        snap = srv.snapshot_save()
    finally:
        srv.shutdown()
    monkeypatch.setenv("NOMAD_AOT_WARMUP", "1")
    logs: list = []
    srv = PortServer(num_workers=1, gc_interval=9999, logger=logs.append)
    srv.heartbeats.min_ttl = 3600.0
    srv.snapshot_restore(snap)
    srv.start()
    try:
        _wait(lambda: any("solver warmup compiled 9 artifacts" in m
                          for m in list(logs)), "the establish warmup")
        assert any("state cache reseeded for 12 nodes" in m for m in logs)
        assert state_cache.cache().stats()["rows"] == 12
        srv.set_scheduler_configuration(port_structs.SchedulerConfiguration(
            scheduler_algorithm="tpu-batch"))
        job = _mk_job(port_mock, port_structs, "warm-job", "batch", 20, 250,
                      256)
        eval_id = srv.job_register(job)["eval_id"]
        _wait(lambda: (ev := srv.state.eval_by_id(eval_id)) is not None
              and ev.status == "complete", "the eval after the restart")
        assert len(srv.state.allocs_by_job("default", "warm-job")) == 20
    finally:
        srv.shutdown()


def test_job_register_over_the_socket_rpc_is_answered():
    from nomad_tpu_torch.rpc import RpcClient
    srv = PortServer(num_workers=1, gc_interval=9999)
    srv.heartbeats.min_ttl = 3600.0
    srv.rpc_listen()
    srv.start()
    try:
        with RpcClient([srv.rpc_addr]) as cli:
            for i in range(4):
                cli.call("Node.Register", _mk_node(
                    port_mock, i, np.random.default_rng(i)))
            job = _mk_job(port_mock, port_structs, "rpc-job", "batch", 3,
                          100, 64)
            out = cli.call("Job.Register", job)
        assert out["eval_id"]
        _wait(lambda: (ev := srv.state.eval_by_id(out["eval_id"]))
              is not None and ev.status == "complete", "the rpc job's eval")
        assert len(srv.state.allocs_by_job("default", "rpc-job")) == 3
    finally:
        srv.shutdown()


def test_debug_bundle_keys_equal_the_references():
    bundles = []
    for Server in (RefServer, PortServer):
        srv = Server(num_workers=0, gc_interval=9999)
        srv.start()
        try:
            bundles.append(srv.operator_debug_bundle())
        finally:
            srv.shutdown()
    ref, port = bundles
    assert sorted(port) == sorted(ref)
    for block in ("DeviceRuntime", "Mesh", "Breakers", "Meta", "Rpc"):
        assert sorted(port[block]) == sorted(ref[block]), block
    assert port["Mesh"]["Shards"] == 1
    assert port["DeviceRuntime"]["mesh"] == {"sharded": False, "devices": 1}
    assert set(port["DeviceRuntime"]["compile_cache"]) == \
        set(ref["DeviceRuntime"]["compile_cache"])


def test_applier_in_flight_signal_is_the_micro_batchers():
    assert Planner._expected_in_flight() == 0
    microbatch.eval_started()
    microbatch.eval_started()
    try:
        assert Planner._expected_in_flight() == 2 == microbatch.concurrency()
        microbatch.broker_in_flight(5)
        assert Planner._expected_in_flight() == 5
    finally:
        microbatch.reset()
