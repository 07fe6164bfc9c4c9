"""Eval-stream micro-batching in the port, on the CPU: the cases of
tests/test_microbatch.py against nomad_tpu_torch, and the lane solve
against the reference's.

  * two concurrent depth solves coalesce into ONE window and each gets
    back its solo solve, bit for bit (the plain tier, and the card's
    chain through its CPU seam, where the window's wrapper runs its
    plain version);
  * a window launches only its live lanes, and a row of the one depth
    tail gives the same placements alone and in any window;
  * a lone eval never takes the batch tier, and a window that closes
    with one lane runs the solo chain;
  * the port's eval broker pushes its in-flight count to the batcher;
  * the window knob hot-reloads through the scheduler config, which
    validates it;
  * the port's lane solve equals the reference's coalesced window
    (MicroBatcher on the same lanes) and the reference's solo solves;
  * a device error in a window is counted once, feeds the breaker and
    raises on every lane;
  * kernel launch counts survive concurrent workers.
"""
import random
import threading

import jax  # noqa: F401  (the reference runs on the CPU backend)
import numpy as np
import pytest
import torch

from nomad_tpu.solver import backend as ref_backend
from nomad_tpu.solver import microbatch as ref_microbatch

from nomad_tpu_torch import faults, mock
from nomad_tpu_torch.metrics import metrics
from nomad_tpu_torch.scheduler import Harness, new_scheduler
from nomad_tpu_torch.solver import backend, kernels, microbatch
from nomad_tpu_torch.solver.device import use_device
from nomad_tpu_torch.structs import (
    Evaluation, SCHED_ALG_TPU, SchedulerConfiguration,
)

DEPTH_GRID_64 = tuple(g for g in kernels.DEPTH_GRID if g <= 64)


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    prev, threads = use_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(backend, "BATCH_MAX_COUNT", 2048)
    backend.reset()
    microbatch.reset()
    microbatch.configure(enabled=True, window_s=0.5)
    faults.clear()
    yield
    faults.clear()
    backend.reset()
    microbatch.reset()
    microbatch.configure(enabled=True, window_s=0.008)
    torch.set_num_threads(threads)
    use_device(prev)


@pytest.fixture
def card(monkeypatch):
    """The card's chain on the CPU (tests/test_torch_ladder.py's seam)."""
    monkeypatch.setattr(backend, "tier", lambda: "cuda")
    backend.reset()


def _lane(n, count, seed, grid=None):
    """One depth solve's normalized args (numpy), seeded: its own ask,
    count, usage, affinities and jitter."""
    rng = np.random.default_rng(seed)
    cap = np.zeros((n, 5), np.float32)
    cap[:, 0] = rng.choice([4000.0, 8000.0, 16000.0], n)
    cap[:, 1] = rng.choice([8192.0, 16384.0], n)
    cap[:, 2] = 100_000.0
    used = np.floor(cap * rng.uniform(0.0, 0.6, (n, 5))).astype(np.float32)
    ask = np.zeros(5, np.float32)
    ask[0], ask[1] = rng.integers(100, 900), rng.integers(64, 1024)
    feas = rng.random(n) > 0.1
    coll = rng.integers(0, 3, n).astype(np.int32)
    aff = np.where(rng.random(n) < 0.2, rng.uniform(-1, 1, n),
                   0).astype(np.float32)
    jitter = rng.random(n, dtype=np.float32)
    m = 0.0 if grid is None else float(rng.uniform(0.5, 3.0))
    return (cap, used, ask, np.int32(count), feas, coll,
            np.int32(count + 3), aff, np.int32(2 if seed % 3 == 0 else 2 ** 30),
            jitter, np.float32(1.5), np.float32(m))


def _concurrently(fn, args_list) -> list:
    """fn(*args) on one thread per args tuple, all in flight at once
    (microbatch.eval_started for each); -> results, or the exceptions."""
    out: list = [None] * len(args_list)

    def call(i):
        try:
            out[i] = fn(*args_list[i])
        except BaseException as e:   # noqa: BLE001 — returned to the test
            out[i] = e

    for _ in args_list:
        microbatch.eval_started()
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(args_list))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        for _ in args_list:
            microbatch.eval_finished()
    return out


@pytest.mark.parametrize("seam", ["torch", "card"])
@pytest.mark.parametrize("grid", [None, DEPTH_GRID_64],
                         ids=["dense", "grid"])
def test_coalesced_window_matches_the_solo_solves(request, seam, grid):
    if seam == "card":
        request.getfixturevalue("card")
    lanes = [_lane(512, c, s, grid) for s, c in enumerate((40, 300, 7))]
    _, solo_fn = backend.select("depth", 512, k_max=64, depth_grid=grid)
    expected = [np.asarray(solo_fn(*a)) for a in lanes]
    microbatch.eval_started()
    microbatch.eval_started()
    name, _ = backend.select("depth", 512, count=40, k_max=64,
                             depth_grid=grid)
    microbatch.eval_finished()
    microbatch.eval_finished()
    assert name == "batch"
    d0 = metrics.counter("nomad.solver.microbatch.dispatches")
    s0 = metrics.counter("nomad.solver.microbatch.solo")

    def solve(*a):
        _, fn = backend.select("depth", 512, count=int(a[3]), k_max=64,
                               depth_grid=grid)
        return np.asarray(fn(*a))

    out = _concurrently(solve, lanes)
    assert metrics.counter("nomad.solver.microbatch.dispatches") == d0 + 1
    assert metrics.counter("nomad.solver.microbatch.solo") == s0
    for got, want, a in zip(out, expected, lanes):
        assert int(want.sum()) == int(a[3])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seam", ["torch", "card"])
def test_a_window_launches_only_its_lanes(request, monkeypatch, seam):
    """Three coalesced solves make a window of three lanes: nothing is
    padded to LANES (a launch takes any lane count)."""
    from nomad_tpu_torch.solver import cuda_kernels
    if seam == "card":
        request.getfixturevalue("card")
    mod = cuda_kernels if seam == "card" else kernels
    real, shapes = mod.fill_depth_lanes, []

    def recording(cap, *a, **kw):
        shapes.append(tuple(cap.shape))
        return real(cap, *a, **kw)
    monkeypatch.setattr(mod, "fill_depth_lanes", recording)
    lanes = [_lane(256, c, s) for s, c in enumerate((20, 30, 40))]

    def solve(*a):
        _, fn = backend.select("depth", 256, count=int(a[3]))
        return np.asarray(fn(*a))

    out = _concurrently(solve, lanes)
    assert shapes == [(3, 256, 5)]
    assert [int(o.sum()) for o in out] == [20, 30, 40]


def test_depth_tail_row_does_not_depend_on_its_window():
    """The one depth tail over [L, N]: a row gives the same placements
    alone (host scalars), in a window of equal settings (host scalars)
    and in a window of mixed settings ([L, 1] columns)."""
    rng = np.random.default_rng(7)
    n = 300
    d = torch.from_numpy(rng.uniform(0.1, 1.0, (4, n)).astype(np.float32))
    d[:, ::7] = -float("inf")
    k = torch.from_numpy(rng.integers(1, 6, (4, n)).astype(np.int32))
    c = k + torch.from_numpy(rng.integers(0, 4, (4, n)).astype(np.int32))
    u = torch.from_numpy(rng.random((4, n), dtype=np.float32))
    d[1], k[1], c[1] = d[0], k[0], c[0]
    alone = kernels._depth_order_take_one(d[0], k[0], c[0], 400, u[0], 1.5,
                                          2.5)
    same = kernels._depth_order_take(d[:2], k[:2], c[:2], (400, 400),
                                     u[:2], (1.5, 1.5), (2.5, 2.5))
    mixed = kernels._depth_order_take(d, k, c, (400, 90, 1, 0), u,
                                      (1.5, 0.5, 1.5, 1.0),
                                      (2.5, 0.0, 1.0, 0.0))
    assert int(alone.sum()) == 400
    assert torch.equal(same[0], alone) and torch.equal(mixed[0], alone)
    for row, (cnt, sc, m) in enumerate(((90, 0.5, 0.0), (1, 1.5, 1.0),
                                        (0, 1.0, 0.0)), start=1):
        assert torch.equal(mixed[row], kernels._depth_order_take_one(
            d[row], k[row], c[row], cnt, u[row], sc, m)), row


def test_solo_eval_never_batches():
    """With one eval in flight the depth solve keeps its solo tier; the
    batcher itself sends a lone request to the solo chain."""
    microbatch.eval_started()
    try:
        name, fn = backend.select("depth", 256, count=10)
        assert name == "torch"
        d0 = metrics.counter("nomad.solver.microbatch.dispatches")
        s0 = metrics.counter("nomad.solver.microbatch.solo")
        calls = []
        out = microbatch.solve(("depth",), None,
                               lambda *a: calls.append(a) or fn(*a),
                               _lane(256, 10, 3))
    finally:
        microbatch.eval_finished()
    assert int(np.asarray(out).sum()) == 10 and len(calls) == 1
    assert metrics.counter("nomad.solver.microbatch.dispatches") == d0
    assert metrics.counter("nomad.solver.microbatch.solo") == s0 + 1


def test_a_window_of_one_runs_the_solo_chain():
    """Two evals in flight, one solve: the window closes with one lane
    and the solo chain serves it (the reference would solve on the host)."""
    microbatch.configure(enabled=True, window_s=0.02)
    microbatch.eval_started()
    microbatch.eval_started()
    try:
        name, fn = backend.select("depth", 256, count=10)
        assert name == "batch"
        s0 = metrics.counter("nomad.solver.microbatch.solo")
        out = np.asarray(fn(*_lane(256, 10, 4)))
    finally:
        microbatch.eval_finished()
        microbatch.eval_finished()
    assert int(out.sum()) == 10
    assert metrics.counter("nomad.solver.microbatch.solo") == s0 + 1


def test_broker_inflight_is_a_concurrency_signal():
    from nomad_tpu_torch.server.eval_broker import EvalBroker
    broker = EvalBroker()
    broker.set_enabled(True)
    try:
        evs = []
        for i in range(2):
            ev = Evaluation(job_id=f"job-{i}", type="batch", priority=50)
            broker.enqueue(ev)
            evs.append(ev)
        assert microbatch.concurrency() == 0
        _, t1 = broker.dequeue(["batch"], timeout=1.0)
        assert microbatch.concurrency() == 1
        ev2, t2 = broker.dequeue(["batch"], timeout=1.0)
        assert microbatch.concurrency() == 2
        broker.ack(evs[0].id, t1)
        assert microbatch.concurrency() == 1
        broker.ack(ev2.id, t2)
        assert microbatch.concurrency() == 0
    finally:
        broker.set_enabled(False)


def test_window_knob_hot_reloads_through_scheduler_config():
    random.seed(99)
    h = Harness()
    h.state.set_scheduler_config(
        h.get_next_index(),
        SchedulerConfiguration(scheduler_algorithm=SCHED_ALG_TPU,
                               eval_batch_window_ms=12.0))
    for _ in range(6):
        h.state.upsert_node(h.get_next_index(), mock.node())

    def run_one(job_id):
        job = mock.batch_job()
        job.id = job.name = job_id
        tg = job.task_groups[0]
        tg.count = 2
        tg.networks = []
        tg.tasks[0].resources.networks = []
        h.state.upsert_job(h.get_next_index(), job)
        ev = Evaluation(job_id=job.id, type=job.type)
        h.process(lambda s, p: new_scheduler(job.type, s, p), ev)

    run_one("hot-a")
    assert microbatch.window_s() == pytest.approx(0.012)
    assert microbatch.enabled()
    h.state.set_scheduler_config(
        h.get_next_index(),
        SchedulerConfiguration(scheduler_algorithm=SCHED_ALG_TPU,
                               eval_batch_window_ms=20.0,
                               eval_batch_enabled=False))
    run_one("hot-b")
    assert microbatch.window_s() == pytest.approx(0.020)
    assert not microbatch.enabled()
    # a disabled batcher keeps every solve on its solo tier
    microbatch.eval_started()
    microbatch.eval_started()
    try:
        assert backend.select("depth", 256, count=10)[0] == "torch"
    finally:
        microbatch.eval_finished()
        microbatch.eval_finished()


def test_scheduler_config_validates_batch_and_pipeline_knobs():
    cfg = SchedulerConfiguration(eval_batch_window_ms=-1.0)
    assert "eval_batch_window_ms" in cfg.validate()
    cfg = SchedulerConfiguration(plan_pipeline_chunks=0)
    assert "plan_pipeline_chunks" in cfg.validate()
    cfg = SchedulerConfiguration(plan_pipeline_min_count=-5)
    assert "plan_pipeline_min_count" in cfg.validate()
    assert SchedulerConfiguration().validate() == ""


@pytest.mark.parametrize("grid", [None, DEPTH_GRID_64],
                         ids=["dense", "grid"])
def test_lane_solve_equals_the_references_window(grid):
    """The reference's MicroBatcher on six lanes (its vmapped program,
    padded to 8) against the port's lane solve on the same six lanes (a
    launch takes any lane count: no padding), and both against the
    reference's solo solves."""
    lanes = [_lane(512, c, s, grid)
             for s, c in enumerate((40, 300, 7, 120, 900, 1))]
    inner = ref_backend._build("depth", "xla", jax.devices(), 64, 256,
                               False, grid)
    host = ref_backend._on_host(inner)
    reqs = [ref_microbatch._Request(a) for a in lanes]
    try:
        ref_microbatch._batcher._run_batch(("depth", 64, False, grid), inner,
                                           host, reqs)
    finally:
        ref_microbatch.reset()
    from nomad_tpu_torch.solver.tensorize import stack_lanes
    lanes_fn = backend._lanes_fn(False, 64, False, grid)
    got = lanes_fn(*stack_lanes(lanes, backend._ARG_DTYPES["depth"])).numpy()
    assert got.shape == (len(lanes), 512)
    for i, (a, r) in enumerate(zip(lanes, reqs)):
        solo = np.asarray(host(*a))
        np.testing.assert_array_equal(np.asarray(r.out), solo, err_msg=str(i))
        np.testing.assert_array_equal(got[i], solo, err_msg=str(i))
        assert int(got[i].sum()) == int(a[3])


def test_device_error_in_a_window_raises_on_every_lane(card):
    faults.install({"solver.microbatch.dispatch": {"mode": "raise",
                                                   "times": 1}})
    errs0 = metrics.counter("nomad.solver.dispatch_errors.batch")
    cpu0 = metrics.counter("nomad.solver.dispatch.torch")
    lanes = [_lane(256, c, s) for s, c in enumerate((20, 30, 40))]

    def solve(*a):
        _, fn = backend.select("depth", 256, count=int(a[3]))
        return fn(*a)

    out = _concurrently(solve, lanes)
    assert all(isinstance(o, faults.FaultError) for o in out), out
    assert metrics.counter("nomad.solver.dispatch_errors.batch") == errs0 + 1
    assert metrics.counter("nomad.solver.dispatch.torch") == cpu0
    # the breaker saw it; the next healthy window closes it again
    assert backend.breaker()._tiers["batch"]["failures"]
    out = _concurrently(solve, lanes)
    assert [int(np.asarray(o).sum()) for o in out] == [20, 30, 40]
    assert backend.breaker().state("batch") == "closed"


def test_launch_counts_survive_concurrent_workers():
    """Scheduler workers launch kernels from several threads at once: no
    launch count may be lost (cuda_kernels._launched counts under a
    lock). More threads than cores, with a short switch interval."""
    import sys
    from nomad_tpu_torch.solver import cuda_kernels
    before = cuda_kernels.LAUNCHES["depth_curve_lanes"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def launch():
        for _ in range(2_000):
            cuda_kernels._launched("depth_curve_lanes", 0)
    threads = [threading.Thread(target=launch) for _ in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert cuda_kernels.LAUNCHES["depth_curve_lanes"] - before == 32_000
    cuda_kernels.LAUNCHES["depth_curve_lanes"] = before
