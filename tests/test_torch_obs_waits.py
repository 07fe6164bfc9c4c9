"""The port's timers for the time no layer timer saw (obs/timing.py), on
the CPU: the broker's and the plan queue's waits, a client update and
its FSM apply, the state store's contended lock, the CPU seconds of the
solve and of the scheduler's invoke, the solve's host syncs, the eval
count the benchmark divides by, the tracer's clock against
torch.profiler's, and the benchmark's readers of each timer."""
import threading
import time

import pytest
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.metrics import metrics
from nomad_tpu_torch.obs import trace
from nomad_tpu_torch.scheduler import Harness, new_scheduler
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.server.eval_broker import EvalBroker
from nomad_tpu_torch.server.fsm import NomadFSM, RaftLog
from nomad_tpu_torch.server.plan_apply import Planner
from nomad_tpu_torch.solver import backend, state_cache
from nomad_tpu_torch.solver.device import use_device
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.structs import Evaluation, Plan, SchedulerConfiguration

from portbench.lib import layers, spec

INVOKE = "nomad.worker.invoke_scheduler_"
HOLD_S = 0.05


@pytest.fixture(autouse=True)
def _cpu():
    prev = use_device("cpu")
    backend.reset()
    state_cache.reset()
    trace.take_leaked()
    yield
    use_device(prev)
    assert not trace.take_leaked()


@pytest.fixture(params=[True, False], ids=["traced", "untraced"])
def tracer_on(request, monkeypatch):
    monkeypatch.setattr(trace.tracer, "_enabled", request.param)
    return request.param


def _sample(name):
    s = metrics.samples.get(name)
    return (s.total, s.sum) if s else (0, 0.0)


def _delta(name, before):
    n, total = _sample(name)
    return n - before[0], total - before[1]


# ------------------------------------------------------------ the broker


def test_an_eval_held_in_the_broker_reads_its_wait(tracer_on):
    broker = EvalBroker()
    broker.set_enabled(True)
    try:
        ev = Evaluation(job_id="held", type="batch", priority=50)
        b0 = _sample("nomad.broker.wait")
        broker.enqueue(ev)
        time.sleep(HOLD_S)
        got, token = broker.dequeue(["batch"], timeout=1.0)
        assert got.id == ev.id
        n, waited = _delta("nomad.broker.wait", b0)
        assert n == 1 and waited >= HOLD_S
        broker.ack(ev.id, token)
        if tracer_on:
            trace.end_eval(ev.id, "ok", owner=id(broker))
            spans = [s for s in trace.get(ev.id)["spans"]
                     if s["name"] == "broker.wait"]
            assert len(spans) == 1 and spans[0]["dur"] >= HOLD_S
    finally:
        broker.set_enabled(False)


def test_a_delayed_eval_waits_from_its_first_enqueue():
    broker = EvalBroker()
    broker.set_enabled(True)
    try:
        ev = Evaluation(job_id="later", type="batch", priority=50,
                        wait_sec=HOLD_S)
        b0 = _sample("nomad.broker.wait")
        broker.enqueue(ev)
        got, token = broker.dequeue(["batch"], timeout=2.0)
        assert got is not None and got.id == ev.id
        n, waited = _delta("nomad.broker.wait", b0)
        assert n == 1 and waited >= HOLD_S
        broker.ack(got.id, token)
    finally:
        broker.set_enabled(False)


# ---------------------------------------------------------- the applier


def test_a_plan_queued_behind_a_paused_applier_reads_its_wait():
    fsm = NomadFSM()
    planner = Planner(RaftLog(fsm), fsm.state)
    planner.queue.set_enabled(True)     # queued, no applier thread yet
    q0 = _sample("nomad.plan.queue_wait")
    pending = planner.submit_plan_async(Plan(eval_id="q", priority=50))
    time.sleep(HOLD_S)
    planner.start()
    try:
        _, err = pending.wait(10.0)
        assert pending.event.is_set() and err is None
    finally:
        planner.stop()
    n, waited = _delta("nomad.plan.queue_wait", q0)
    assert n == 1 and waited >= HOLD_S


# ------------------------------------------------------------ the store


def _holder(s, held, trying):
    """A thread that takes the store's lock and keeps it HOLD_S past the
    moment the reader says it is about to read."""
    def run():
        with s._lock:
            held.set()
            trying.wait(5.0)
            time.sleep(HOLD_S)
    t = threading.Thread(target=run)
    t.start()
    held.wait(5.0)
    return t


def test_a_contended_acquisition_reads_its_wait_once():
    s = StateStore()
    held, trying = threading.Event(), threading.Event()
    c0 = _sample("nomad.state.lock_wait")
    with s._lock:                         # uncontended, then re-entered
        with s._lock:
            s.latest_index()
    assert _delta("nomad.state.lock_wait", c0) == (0, 0.0)
    t = _holder(s, held, trying)
    trying.set()
    s.latest_index()                      # blocks behind the holder
    t.join(5.0)
    n, waited = _delta("nomad.state.lock_wait", c0)
    assert not t.is_alive() and n == 1 and waited >= 0.8 * HOLD_S


def test_the_contended_wait_lands_on_the_current_span():
    s = StateStore()
    held, trying = threading.Event(), threading.Event()
    root = trace.begin_root("lock.probe")
    with trace.use(root):
        with trace.span("probe.read"):
            t = _holder(s, held, trying)
            trying.set()
            s.latest_index()
    root.end()
    t.join(5.0)
    rec = trace.get(root.trace_id)
    span = next(x for x in rec["spans"] if x["name"] == "probe.read")
    assert span["attrs"]["lock_wait_s"] >= 0.8 * HOLD_S


def test_condition_wait_releases_and_restores_a_lock_taken_twice():
    s = StateStore()
    got = {}

    def waiter():
        with s._lock:
            with s._lock:
                snap = s.snapshot_min_index(1, timeout=5.0)
                got["index"] = snap.latest_index()
                got["owned"] = s._lock._is_owned()
            got["still"] = s._lock._is_owned()
        got["free"] = not s._lock._is_owned()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(HOLD_S)
    # the waiter holds the lock twice: its wait must have released both
    # levels, or this write blocks until the waiter's timeout
    t0 = time.perf_counter()
    s.upsert_node(1, mock.node())
    assert time.perf_counter() - t0 < 2.0
    t.join(5.0)
    assert got == {"index": 1, "owned": True, "still": True, "free": True}
    assert s._lock.acquire(blocking=False)
    s._lock.release()


# ------------------------------------------------ a server's whole eval


def _server():
    srv = Server(num_workers=1, gc_interval=9999)
    srv.heartbeats.min_ttl = 3600.0
    srv.start()
    srv.set_scheduler_configuration(
        SchedulerConfiguration(scheduler_algorithm="tpu-batch"))
    for _ in range(8):
        srv.node_register(mock.node())
    return srv


def _batch_job(count):
    job = mock.batch_job()
    job.task_groups[0].count = count
    job.task_groups[0].networks = []
    job.task_groups[0].tasks[0].resources.networks = []
    return job


def _wait_complete(srv, eval_id, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ev = srv.state.eval_by_id(eval_id)
        if ev is not None and ev.status == "complete":
            return
        time.sleep(0.02)
    raise AssertionError(f"eval {eval_id[:8]} did not complete")


def _sums(names):
    return {k: _sample(k) for k in names}


def test_a_server_eval_and_its_client_update_read_their_timers():
    srv = _server()
    try:
        job = _batch_job(5)
        names = ["nomad.client.update_alloc", "nomad.fsm.alloc_client_update",
                 "nomad.worker.invoke_cpu", "nomad.solver.solve",
                 "nomad.solver.solve_cpu", "nomad.broker.wait",
                 "nomad.plan.queue_wait", INVOKE + "batch"]
        b0 = _sums(names)
        _wait_complete(srv, srv.job_register(job)["eval_id"])
        allocs = srv.state.allocs_by_job("default", job.id)
        assert len(allocs) == 5
        done = []
        for a in allocs:
            a = a.copy()
            a.client_status = "complete"
            done.append(a)
        out = srv.node_update_allocs(done)
        for eval_id in out["eval_ids"]:
            _wait_complete(srv, eval_id)
        d = {k: _delta(k, b0[k]) for k in names}
        client, fsm = d["nomad.client.update_alloc"], \
            d["nomad.fsm.alloc_client_update"]
        assert client[0] == fsm[0] == 1
        assert client[1] >= fsm[1] > 0
        # the register eval and the follow-up
        invoked = d[INVOKE + "batch"]
        assert invoked[0] == 2 == d["nomad.worker.invoke_cpu"][0]
        assert 0 < d["nomad.worker.invoke_cpu"][1] <= invoked[1]
        assert 0 < d["nomad.solver.solve_cpu"][1] <= \
            d["nomad.solver.solve"][1]
        assert d["nomad.broker.wait"][0] == 2
        assert d["nomad.plan.queue_wait"][0] >= 1
        # the follow-up eval's trace links to the client update's root
        rec = trace.get(out["eval_ids"][0])
        assert rec is not None
        root = next(s for s in rec["spans"] if s["parent"] == "")
        assert root["links"]
        update = trace.get(root["links"][0][0])
        assert update["name"] == "client.update_alloc"
        assert any(s["name"] == "fsm.apply" and
                   s["attrs"].get("type") == "alloc_client_update"
                   for s in update["spans"])
    finally:
        srv.shutdown()


def test_a_roots_parts_are_recorded_with_it():
    """A window of the registry that counts a client update's FSM apply
    counts the client update too: the root's nested samples land right
    after its own."""
    from nomad_tpu_torch.obs import timing
    p0, r0 = _sample("test.part"), _sample("test.whole")
    with timing.timed("test.whole", "test.whole", root=True):
        with timing.timed("test.part", "test.part"):
            time.sleep(0.001)
        assert _delta("test.part", p0)[0] == 0
    part, whole = _delta("test.part", p0), _delta("test.whole", r0)
    assert part[0] == whole[0] == 1 and whole[1] >= part[1] > 0
    with timing.timed("test.part", "test.part"):
        pass
    assert _delta("test.part", p0)[0] == 2


def test_no_sample_but_the_per_type_timers_counts_as_an_eval():
    """portbench's Window counts evals by the invoke timers' prefix: no
    other name the port writes may start with it."""
    srv = _server()
    try:
        probe = layers.Probe(metrics)
        job = _batch_job(3)
        _wait_complete(srv, srv.job_register(job)["eval_id"])
        probe.close()
    finally:
        srv.shutdown()
    types = {"batch", "service", "system", "sysbatch", "_core"}
    seen = [k for k in metrics.samples if k.startswith(INVOKE)]
    assert seen and all(k[len(INVOKE):] in types for k in seen), seen
    assert layers.Window(probe).evals_processed() == 1
    # and in the source: one writer of the prefix, the worker's per-type
    # f-string
    import ast
    from pathlib import Path
    root = Path(__file__).resolve().parents[1] / "nomad_tpu_torch"
    writers = []
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    node.value.startswith(INVOKE):
                writers.append((path.name, node.value))
    assert writers == [("worker.py", INVOKE)], writers


# ----------------------------------------------------------- host syncs


def _harness(**cfg):
    h = Harness()
    h.state.set_scheduler_config(
        h.get_next_index(),
        SchedulerConfiguration(scheduler_algorithm="tpu-batch", **cfg))
    return h


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
def test_one_device_sample_per_host_sync(pipelined):
    n_nodes, count = (64, 400) if pipelined else (16, 6)
    h = _harness(plan_pipeline_min_count=1 if pipelined else 100_000,
                 plan_pipeline_chunks=4)
    for _ in range(n_nodes):
        h.state.upsert_node(h.get_next_index(), mock.node())
    job = _batch_job(count)
    h.state.upsert_job(h.get_next_index(), job)
    d0 = _sample("nomad.solver.device")
    c0 = metrics.counter("nomad.plan.pipeline.chunks")
    s0 = _sums(["nomad.solver.solve", "nomad.solver.solve_cpu"])
    h.process(lambda s, p: new_scheduler(job.type, s, p),
              Evaluation(job_id=job.id, type=job.type))
    assert len(h.state.allocs_by_job("default", job.id)) == count
    chunks = metrics.counter("nomad.plan.pipeline.chunks") - c0
    assert chunks == (4 if pipelined else 0)
    assert _delta("nomad.solver.device", d0)[0] == (4 if pipelined else 1)
    solve = _delta("nomad.solver.solve", s0["nomad.solver.solve"])
    cpu = _delta("nomad.solver.solve_cpu", s0["nomad.solver.solve_cpu"])
    # the serial solve; the pipelined dispatch and each chunk's wait
    assert solve[0] == cpu[0] == (5 if pipelined else 1)
    assert 0 < cpu[1] <= solve[1]


# ----------------------------------------------------------- the clocks


def test_a_span_around_a_torch_op_contains_its_profiler_event():
    """The tracer's span starts (time.time()) and torch.profiler's event
    stamps (start_ns(), which portbench/lib/devtrace.py reads) are on one
    clock."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(256, 256)
    root = trace.begin_root("clock.probe")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.use(root), trace.span("probe.mm"):
            time.sleep(0.002)
            torch.mm(a, a)
            time.sleep(0.002)
    root.end()
    span = next(s for s in trace.get(root.trace_id)["spans"]
                if s["name"] == "probe.mm")
    lo, hi = span["ts"] * 1e9, (span["ts"] + span["dur"]) * 1e9
    events = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert events
    assert all(lo <= s and e <= hi for s, e in events), (lo, hi, events)


# ------------------------------------------------------- the readers


class _Sample:
    def __init__(self, vals):
        self.vals = list(vals)

    @property
    def sum(self):
        return sum(self.vals)

    @property
    def total(self):
        return len(self.vals)

    def raw_window(self, skip):
        return self.vals[skip:]


def _window(after: dict) -> layers.Window:
    from types import SimpleNamespace
    reg = SimpleNamespace(samples={INVOKE + "batch": _Sample([9.0])},
                          counters={})
    probe = layers.Probe(reg)
    for k, v in after.items():
        reg.samples.setdefault(k, _Sample([])).vals.extend(v)
    probe.close()
    return layers.Window(probe)


READERS = {
    "broker_wait_ms": "nomad.broker.wait",
    "plan_queue_wait_ms": "nomad.plan.queue_wait",
    "client_update_ms": "nomad.client.update_alloc",
    "fsm_client_update_ms": "nomad.fsm.alloc_client_update",
    "store_lock_wait_ms": "nomad.state.lock_wait",
    "sched_invoke_cpu_ms": "nomad.worker.invoke_cpu",
    "solve_cpu_ms": "nomad.solver.solve_cpu",
    "device_wait_ms": "nomad.solver.device",
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_reader_gives_its_timer_per_eval(metric):
    reader = spec.metric_reader(metric)
    w = _window({INVOKE + "batch": [0.1, 0.1, 0.1, 0.1],
                 READERS[metric]: [0.010, 0.030]})
    assert reader.read(w) == pytest.approx(40.0 / 4)
    # no eval processed in the window: nothing
    assert reader.read(_window({READERS[metric]: [0.5]})) is None


def test_store_lock_wait_reads_zero_with_evals_and_no_contention():
    reader = spec.metric_reader("store_lock_wait_ms")
    assert reader.read(_window({INVOKE + "batch": [0.1]})) == 0.0
    other = spec.metric_reader("broker_wait_ms")
    assert other.read(_window({INVOKE + "batch": [0.1]})) is None


def test_the_readers_are_the_benchmarks_metrics():
    bench = spec.load_benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["source"] == "program_span" and "workloads" not in m
        assert m["moves"] == "placements_per_s"
