"""The port's dispatch chain and its health breaker, on the CPU — the
counterparts of tests/test_faults.py's breaker and ladder tests, for a
port whose card work never moves to the CPU.

The reference demotes a failed tier down its ladder to a host floor. The
port has one rung per solve device: a classified device error is
counted, fed to the tier's breaker and raised out of the solve, and
nothing is served on the host. The breaker only observes (it opens after
repeated device errors or at once on device loss, closes on the next
success, and never skips the card). On the CPU the card's `cuda` rung is
a test seam (`backend.tier` patched to "cuda"): the hand-kernel wrappers
run their plain versions on CPU tensors, so faults fired at
`solver.dispatch.cuda` and `device.lost.d0` drive the real chain. Errors
that are not device errors (a bug, a kernel that does not build, no
card) raise untouched and never feed the breaker.
"""
import random
import time
import types

import jax  # noqa: F401  (the reference runs on the CPU backend)
import numpy as np
import pytest
import torch

import nomad_tpu.mock as ref_mock
import nomad_tpu.structs as ref_structs
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.scheduler import new_scheduler as ref_new_scheduler
from nomad_tpu.solver import backend as ref_backend
from nomad_tpu.solver import microbatch as ref_microbatch

import nomad_tpu_torch.faults as port_faults
import nomad_tpu_torch.mock as port_mock
import nomad_tpu_torch.structs as port_structs
from nomad_tpu_torch.faults import FaultError
from nomad_tpu_torch.metrics import metrics
from nomad_tpu_torch.scheduler import Harness as PortHarness
from nomad_tpu_torch.scheduler import new_scheduler as port_new_scheduler
from nomad_tpu_torch.solver import backend, cuda_kernels, state_cache
from nomad_tpu_torch.solver import placer as port_placer
from nomad_tpu_torch.solver.backend import TierBreaker
from nomad_tpu_torch.solver.cuda_kernels import (
    KernelBuildError, KernelLaunchError,
)
from nomad_tpu_torch.solver.device import use_device

REF = types.SimpleNamespace(
    mock=ref_mock, structs=ref_structs, Harness=RefHarness,
    new_scheduler=ref_new_scheduler)
PORT = types.SimpleNamespace(
    mock=port_mock, structs=port_structs, Harness=PortHarness,
    new_scheduler=port_new_scheduler)


@pytest.fixture(autouse=True)
def _clean():
    prev, threads = use_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    port_faults.clear()
    backend.reset()
    ref_backend.reset()
    ref_microbatch.reset()
    state_cache.reset()
    yield
    port_faults.clear()
    backend.reset()
    ref_backend.reset()
    ref_microbatch.reset()
    state_cache.reset()
    torch.set_num_threads(threads)
    use_device(prev)


@pytest.fixture
def card(monkeypatch):
    """The card's chain on the CPU: solves select the `cuda` tier, whose
    wrappers run their plain versions on CPU tensors."""
    monkeypatch.setattr(backend, "tier", lambda: "cuda")
    backend.reset()


@pytest.fixture
def _fast_breaker(monkeypatch):
    monkeypatch.setattr(backend, "BREAKER_THRESHOLD", 2)
    monkeypatch.setattr(backend, "BREAKER_WINDOW_S", 10.0)


def _depth_args(n, count, seed=0):
    """tests/test_solver_backend.py's depth args, as numpy."""
    rng = np.random.default_rng(seed)
    cap = np.zeros((n, 5), np.float32)
    cap[:, 0] = rng.choice([4000.0, 8000.0, 16000.0], n)
    cap[:, 1] = rng.choice([8192.0, 16384.0], n)
    cap[:, 2] = 100_000.0
    used = np.floor(cap * rng.uniform(0.0, 0.5, (n, 5))).astype(np.float32)
    ask = np.zeros(5, np.float32)
    ask[0], ask[1] = 500, 256
    feas = np.ones(n, bool)
    feas[::7] = False
    coll = np.zeros(n, np.int32)
    coll[:n // 4] = 1
    jitter = np.random.default_rng(seed + 1).random(n, dtype=np.float32)
    return (cap, used, ask, np.int32(count), feas, coll, np.int32(count),
            np.zeros(n, np.float32), np.int32(2 ** 30), jitter,
            np.float32(1.5), np.float32(0.0))


def _counters(*names) -> dict:
    return {k: metrics.counter(f"nomad.solver.{k}") for k in names}


def _moved(before: dict) -> dict:
    return {k: metrics.counter(f"nomad.solver.{k}") - v
            for k, v in before.items()}


def _plain_depth(args):
    """The torch tier's answer for `args` (the plain version)."""
    _, fn = backend.select("depth", args[0].shape[0], k_max=16)
    return np.asarray(fn(*args))


# ----------------------------------------------------------- the chain

def test_cpu_request_keeps_the_single_torch_rung():
    name, fn = backend.select("depth", 512, k_max=16)
    assert name == "torch"
    port_faults.install({"solver.dispatch.torch": {"mode": "raise"}})
    c0 = _counters("dispatch_errors.torch", "dispatch.host")
    with pytest.raises(FaultError):
        fn(*_depth_args(512, 40, seed=1))
    assert _moved(c0) == {"dispatch_errors.torch": 1, "dispatch.host": 0}


def test_card_device_error_raises_out_of_the_solve(card):
    """The card's chain has one rung: a faulted dispatch is counted and
    raised, and no other tier serves the solve."""
    args = _depth_args(512, 40, seed=3)
    name, fn = backend.select("depth", 512, k_max=16)
    assert name == "cuda"
    want = np.asarray(fn(*args))
    port_faults.install({"solver.dispatch.cuda": {"mode": "raise",
                                                  "times": 1}})
    c0 = _counters("dispatch_errors.cuda", "dispatch.cuda", "dispatch.host",
                   "dispatch.torch")
    with pytest.raises(FaultError):
        fn(*args)
    assert _moved(c0) == {"dispatch_errors.cuda": 1, "dispatch.cuda": 0,
                          "dispatch.host": 0, "dispatch.torch": 0}
    np.testing.assert_array_equal(np.asarray(fn(*args)), want)
    assert metrics.counter("nomad.solver.dispatch.cuda") == \
        c0["dispatch.cuda"] + 1


def test_device_errors_open_the_breaker_which_never_skips_the_card(
        card, _fast_breaker):
    """Every faulted call reaches the card and raises (nothing is
    short-circuited to another tier); the breaker opens at the threshold
    and the next healthy solve closes it."""
    args = _depth_args(512, 300, seed=3)
    _, fn = backend.select("depth", 512, k_max=16)
    want = np.asarray(fn(*args))
    port_faults.install({"solver.dispatch.cuda": {"mode": "raise"}})
    c0 = _counters("tier_breaker_opened.cuda", "tier_breaker_closed.cuda",
                   "dispatch_errors.cuda")
    states = []
    for _ in range(3):
        with pytest.raises(FaultError):
            fn(*args)
        states.append(backend.breaker().state("cuda"))
    assert port_faults.fired("solver.dispatch.cuda") == 3
    assert states == ["closed", "open", "open"]
    port_faults.clear()
    np.testing.assert_array_equal(np.asarray(fn(*args)), want)
    assert backend.breaker().state("cuda") == "closed"
    assert _moved(c0) == {"tier_breaker_opened.cuda": 1,
                          "tier_breaker_closed.cuda": 1,
                          "dispatch_errors.cuda": 3}


def test_async_dispatch_defers_breaker_success(card, monkeypatch):
    """Under async_dispatch() a result not yet on the host proves
    nothing: the chain records no success (that would wipe the failure
    window); the materialize site does."""
    monkeypatch.setattr(backend, "BREAKER_THRESHOLD", 3)
    monkeypatch.setattr(backend, "BREAKER_WINDOW_S", 10.0)
    b = backend.breaker()
    args = _depth_args(512, 40, seed=1)
    _, fn = backend.select("depth", 512, k_max=16)
    b.record_failure("cuda")
    b.record_failure("cuda")
    with backend.async_dispatch():
        out = fn(*args)                 # healthy dispatch, unproven
    assert isinstance(out, torch.Tensor)
    b.record_failure("cuda")            # 3rd failure within the window
    assert b.state("cuda") == "open"
    out.numpy()
    backend.breaker_record("cuda", ok=True)      # the materialize site
    assert b.state("cuda") == "closed"
    # OUTSIDE async_dispatch the chain ends at the host copy and records
    # success itself
    b.record_failure("cuda")
    b.record_failure("cuda")
    fn(*args)
    b.record_failure("cuda")
    assert b.state("cuda") == "closed"


def test_finish_runs_inside_the_chain_and_its_device_error_raises(card):
    """The caller's `finish` (the solve's one host sync) runs inside the
    chain: a device error there — an asynchronous one surfacing at the
    copy — is counted and raised like one at the launch."""
    args = _depth_args(256, 30, seed=5)
    _, fn = backend.select("depth", 256, k_max=16)
    calls = []

    def finish(placed):
        calls.append(1)
        raise torch.OutOfMemoryError("CUDA out of memory")
    c0 = _counters("dispatch_errors.cuda", "dispatch.cuda")
    with pytest.raises(torch.OutOfMemoryError):
        fn(*args, finish=finish)
    assert len(calls) == 1
    assert _moved(c0) == {"dispatch_errors.cuda": 1, "dispatch.cuda": 0}
    assert backend.breaker()._tiers["cuda"]["failures"]


# ------------------------------------------------------- the breaker

def test_breaker_opens_at_the_threshold_and_closes_on_success(
        _fast_breaker):
    b = TierBreaker()
    assert b.state("cuda") == "closed"
    b.record_failure("cuda")
    assert b.state("cuda") == "closed"          # below threshold
    b.record_failure("cuda")
    assert b.state("cuda") == "open"
    b.record_failure("cuda")                    # open stays open
    assert b.state("cuda") == "open"
    b.record_success("cuda")
    assert b.state("cuda") == "closed"
    b.record_failure("cuda")                    # the window starts afresh
    assert b.state("cuda") == "closed"


def test_breaker_window_prunes_stale_failures(monkeypatch):
    monkeypatch.setattr(backend, "BREAKER_THRESHOLD", 3)
    monkeypatch.setattr(backend, "BREAKER_WINDOW_S", 0.05)
    b = TierBreaker()
    b.record_failure("cuda")
    b.record_failure("cuda")
    time.sleep(0.07)                            # both age out
    b.record_failure("cuda")
    assert b.state("cuda") == "closed"


# ----------------------------------------------------- error classes

@pytest.mark.parametrize("exc,kind", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "device_loss"),
    (RuntimeError("CUDA error: unspecified launch failure"), "device_loss"),
    (RuntimeError("CUDA error: device-side assert triggered"),
     "device_loss"),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"),
     "device_loss"),
    (RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or "
                  "unavailable"), "device_loss"),
    (KernelLaunchError("depth_curve kernel launch failed: cudaError_t 700",
                       700), "device_loss"),
    (KernelLaunchError("depth_curve kernel launch failed: cudaError_t 719",
                       719), "device_loss"),
    (KernelLaunchError("chunked_scan kernel launch failed: cudaError_t 2",
                       2), "transient"),
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
     "transient"),
    (FaultError("solver.dispatch.cuda"), "transient"),
    (port_faults.DeviceLostError("device.lost.d0"), "device_loss"),
], ids=["illegal-address", "launch-failure", "assert", "ecc", "unavailable",
        "code-700", "code-719", "code-2", "oom", "fault", "injected-loss"])
def test_classify_device_error(exc, kind):
    assert backend.classify_device_error(exc) == kind


def test_device_error_types_leave_out_bugs_and_build_errors():
    errs = backend.device_error_types()
    for exc in (FaultError("x"), KernelLaunchError("y", 700),
                torch.OutOfMemoryError("z")):
        assert isinstance(exc, errs)
    for exc in (RuntimeError("a bug"), KernelBuildError("nvcc exited 1"),
                ValueError("shape"), MemoryError("host")):
        assert not isinstance(exc, errs)


@pytest.mark.parametrize("exc", [
    KernelBuildError("CUDA kernel build failed: nvcc exited 1"),
    ValueError("a bug in the solve"),
], ids=["build-error", "bug"])
def test_non_device_errors_raise_every_call_and_never_feed_the_breaker(
        card, monkeypatch, exc):
    """A kernel that does not build, or a bug, raises out of every solve,
    BREAKER_THRESHOLD + 1 times over: it is not counted, never opens the
    breaker, and nothing is served elsewhere."""
    real = backend._build

    def build(kernel, tier, *a, **kw):
        real(kernel, tier, *a, **kw)

        def broken(*args):
            raise exc
        return broken
    monkeypatch.setattr(backend, "_build", build)
    backend.reset()
    _, fn = backend.select("depth", 256, k_max=16)
    c0 = _counters("dispatch_errors", "tier_breaker_opened",
                   "dispatch.cuda", "dispatch.host", "dispatch.torch")
    for _ in range(backend.BREAKER_THRESHOLD + 1):
        with pytest.raises(type(exc)):
            fn(*_depth_args(256, 20))
        assert backend.breaker().state("cuda") == "closed"
    assert not any(_moved(c0).values()), _moved(c0)
    assert not backend.breaker()._tiers.get("cuda", {}).get("failures")


def test_missing_nvcc_is_a_build_error(monkeypatch):
    monkeypatch.setattr(cuda_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_kernels.os.path, "exists", lambda p: False)
    with pytest.raises(KernelBuildError, match="nvcc not found"):
        cuda_kernels._nvcc()


def test_no_card_and_no_cpu_request_raises_before_any_ladder(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    use_device("cuda:0")
    c0 = _counters("dispatch_errors")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.select("depth", 256, k_max=16)
    assert _moved(c0) == {"dispatch_errors": 0}


def test_device_loss_opens_the_breaker_at_once_and_drops_twins(card):
    """An injected loss at the cuda rung's `device.lost.d0` site raises
    out of the solve, opens the breaker on the first failure (no
    threshold) and drops the state cache's twins; the next healthy solve
    still runs on the card and closes it."""
    args = _depth_args(256, 30, seed=6)
    _, fn = backend.select("depth", 256, k_max=16)
    want = np.asarray(fn(*args))
    cache = state_cache.cache()
    cache._cap_dev = torch.zeros(1)             # stand-in twins
    cache._used_dev = torch.zeros(1)
    port_faults.install({"device.lost.d0": {"mode": "raise", "times": 1}})
    c0 = _counters("device_loss.cuda", "tier_breaker_opened.device_loss",
                   "dispatch.cuda")
    with pytest.raises(port_faults.DeviceLostError):
        fn(*args)
    assert backend.breaker().state("cuda") == "open"
    assert cache.twins() == (None, None)
    np.testing.assert_array_equal(np.asarray(fn(*args)), want)
    assert backend.breaker().state("cuda") == "closed"
    assert _moved(c0) == {"device_loss.cuda": 1,
                          "tier_breaker_opened.device_loss": 1,
                          "dispatch.cuda": 1}


# ---------------------------------------------------- the state cache

def _cache_view(n=12):
    fsm_state = PORT.Harness().state
    for i in range(n):
        node = port_mock.node()
        node.id = f"sc-node-{i:03d}"
        fsm_state.upsert_node(i + 1, node)
    return fsm_state.snapshot().usage


@pytest.mark.parametrize("exc,dropped", [
    (torch.OutOfMemoryError("CUDA out of memory"), False),
    (KernelLaunchError("index kernel failed: cudaError_t 700", 700), True),
], ids=["transient", "device-loss"])
def test_gather_device_error_raises_and_feeds_the_breaker(
        monkeypatch, exc, dropped):
    """A device error in the twin gather raises out of the eval (the
    eval never falls back to the host copies), feeds the breaker, and on
    device loss drops the twins; the next gather serves twins again."""
    view = _cache_view()
    rows = np.arange(view.cap.shape[0])[::-1].copy()
    cache = state_cache.cache()
    assert cache.gather(view, rows, bucket=16, tier="torch").cap_dev \
        is not None
    real = torch.index_select

    def boom(*a, **kw):
        raise exc
    monkeypatch.setattr(torch, "index_select", boom)
    c0 = _counters("device_loss", "dispatch_errors.torch")
    with pytest.raises(type(exc)):
        cache.gather(view, rows, bucket=16, tier="torch")
    monkeypatch.setattr(torch, "index_select", real)
    assert (cache.twins() == (None, None)) == dropped
    assert _moved(c0) == {"device_loss": int(dropped),
                          "dispatch_errors.torch": 1}
    g = cache.gather(view, rows, bucket=16, tier="torch")
    np.testing.assert_array_equal(g.cap_dev[:len(rows)].numpy(),
                                  view.cap[rows])
    np.testing.assert_array_equal(g.used_dev[:len(rows)].numpy(),
                                  view.used[rows])


def test_seed_device_error_raises_and_feeds_the_breaker(monkeypatch):
    """A device error while seeding the twins raises out of the gather
    (no gather falls back to the host copies) and leaves no twins; the
    next gather seeds them."""
    view = _cache_view()
    rows = np.arange(view.cap.shape[0])
    cache = state_cache.cache()
    real = state_cache._upload

    def boom(a, dev):
        raise torch.OutOfMemoryError("CUDA out of memory")
    monkeypatch.setattr(state_cache, "_upload", boom)
    c0 = _counters("dispatch_errors.torch")
    with pytest.raises(torch.OutOfMemoryError):
        cache.gather(view, rows, bucket=16, tier="torch")
    assert cache.twins() == (None, None)
    assert _moved(c0) == {"dispatch_errors.torch": 1}
    monkeypatch.setattr(state_cache, "_upload", real)
    g = cache.gather(view, rows, bucket=16, tier="torch")
    np.testing.assert_array_equal(g.cap_dev[:len(rows)].numpy(),
                                  view.cap[rows])


# --------------------------------------------------- whole evals, faulted

def _stream_eval(side, count, eval_id, job_tag, n_nodes=16, **config):
    """One pinned-id eval (test_faults' _det_stream_run on either side),
    set up but not run -> (harness, run)."""
    random.seed(1234)
    h = side.Harness()
    h.state.set_scheduler_config(
        h.get_next_index(),
        side.structs.SchedulerConfiguration(
            scheduler_algorithm="tpu-batch", **config))
    for i in range(n_nodes):
        n = side.mock.node()
        n.id = f"node-{i:04d}"
        n.name = f"chaos-{i}"
        h.state.upsert_node(h.get_next_index(), n)
    job = side.mock.batch_job()
    job.id = job.name = f"chaos-job-{job_tag}"
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    t = tg.tasks[0]
    t.resources.networks = []
    t.resources.cpu = 250
    t.resources.memory_mb = 128
    h.state.upsert_job(h.get_next_index(), job)
    ev = side.structs.Evaluation(id=eval_id, job_id=job.id, type=job.type)

    def run():
        h.process(lambda s, p: side.new_scheduler(job.type, s, p), ev)
        placed: dict[str, int] = {}
        for a in h.state.allocs_by_job("default", job.id):
            placed[a.node_id] = placed.get(a.node_id, 0) + 1
        return placed, h.evals[-1].status
    return h, job, run


@pytest.mark.parametrize("count", [6, 48, 1],
                         ids=["jittered", "depth", "greedy"])
def test_faulted_serial_eval_raises_and_commits_nothing(card, count):
    """On the card's chain a healthy eval commits the reference's map; the
    same eval with its dispatch faulted raises out of the scheduler and
    commits nothing — it is never re-solved on the host."""
    _, _, ref_run = _stream_eval(REF, count, "acc-eval", "acc")
    _, _, run = _stream_eval(PORT, count, "acc-eval", "acc")
    got = run()
    assert got == ref_run() and got[1] == "complete"
    h, job, run = _stream_eval(PORT, count, "acc-eval", "acc")
    port_faults.install({"solver.dispatch.cuda": {"mode": "raise"}})
    c0 = _counters("dispatch_errors.cuda", "dispatch.host")
    with pytest.raises(FaultError):
        run()
    assert h.state.allocs_by_job("default", job.id) == []
    assert _moved(c0) == {"dispatch_errors.cuda": 1, "dispatch.host": 0}


def test_pipeline_chunk_error_feeds_the_breaker(monkeypatch):
    """A device error when a pipelined chunk's result reaches the host
    is counted and fed to the breaker before PipelineChunkError leaves
    the eval; healthy chunks record success at the same site."""
    cfg = dict(plan_pipeline_min_count=1, plan_pipeline_chunks=3)
    monkeypatch.setattr(backend, "BREAKER_THRESHOLD", 1)
    backend.breaker().record_failure("torch")
    assert backend.breaker().state("torch") == "open"
    _, _, run = _stream_eval(PORT, 30, "pipe-eval-1", "pipe", **cfg)
    assert run()[1] == "complete"
    assert backend.breaker().state("torch") == "closed"
    real_numpy = port_placer._Chunk.numpy
    seen = []

    def numpy(self):
        seen.append(1)
        if len(seen) == 3:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return real_numpy(self)
    monkeypatch.setattr(port_placer._Chunk, "numpy", numpy)
    _, _, run = _stream_eval(PORT, 30, "pipe-eval-2", "pipe", **cfg)
    c0 = _counters("dispatch_errors.torch", "dispatch.host")
    with pytest.raises(port_placer.PipelineChunkError, match="chunk 2 of 3"):
        run()
    assert _moved(c0) == {"dispatch_errors.torch": 1, "dispatch.host": 0}
    assert backend.breaker().state("torch") == "open"


def _deep_run(side, eval_id):
    """A job too deep for the depth curve on 5 nodes: the chunked scan,
    asked past one solve's cover (256 steps x the 8-row bucket), so the
    placer runs a second solve carrying the state of the first."""
    random.seed(99)
    h = side.Harness()
    h.state.set_scheduler_config(
        h.get_next_index(),
        side.structs.SchedulerConfiguration(
            scheduler_algorithm="tpu-batch",
            placement_explain_enabled=True))
    for i in range(5):
        n = side.mock.node()
        n.id = f"deep-node-{i:04d}"
        n.name = f"deep-{i}"
        h.state.upsert_node(h.get_next_index(), n)
    job = side.mock.batch_job()
    job.id = job.name = "deep-job"
    tg = job.task_groups[0]
    tg.count = 3000
    tg.networks = []
    t = tg.tasks[0]
    t.resources.networks = []
    t.resources.cpu = 5
    t.resources.memory_mb = 8
    h.state.upsert_job(h.get_next_index(), job)
    ev = side.structs.Evaluation(id=eval_id, job_id=job.id, type=job.type)
    h.process(lambda s, p: side.new_scheduler(job.type, s, p), ev)
    placed: dict[str, int] = {}
    for a in h.state.allocs_by_job("default", job.id):
        placed[a.node_id] = placed.get(a.node_id, 0) + 1
    return placed, h.evals[-1].status


def test_scan_refill_matches_reference():
    """The scan asked past one solve's cover: the second solve continues
    from the first's state on the device (only the placement total
    reached the host between them) and the eval commits the reference's
    map."""
    want = _deep_run(REF, "deep-eval")
    c0 = _counters("dispatch.torch")
    got = _deep_run(PORT, "deep-eval")
    assert got == want and sum(got[0].values()) == 3000
    assert _moved(c0)["dispatch.torch"] >= 2


def test_scan_refill_device_error_raises(card):
    """The scan's second solve faulted on the card's chain: the eval
    raises and nothing is committed."""
    port_faults.install({"solver.dispatch.cuda": {
        "mode": "nth_call", "n": 2, "times": 1}})
    with pytest.raises(FaultError):
        _deep_run(PORT, "deep-eval")
    assert port_faults.fired("solver.dispatch.cuda") == 1
