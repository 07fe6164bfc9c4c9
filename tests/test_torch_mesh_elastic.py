"""The port's elastic mesh on the CPU: 8 virtual shards
(`device.use_devices(["cpu"] * 8)`), the `device.lost.d<N>` fault sites
raising the port's DeviceLostError at the dispatch seams, so the whole
detect -> quarantine -> rebuild -> evacuate -> replay path runs without a
card. Counterparts of tests/test_mesh_elastic.py case by case (the
reference runs on the 8 JAX CPU devices tests/conftest.py forces, and
where a case compares placements the reference's run is the oracle too):

  * a lost shard is QUARANTINED and the mesh rebuilds over the survivors
    at a bumped generation, non-power-of-two remainders included (7 of
    8: every bucket re-pads to a multiple of 7);
  * the in-flight solve REPLAYS its identical inputs at the new
    generation: placements bit-identical to an undisturbed run, zero
    evals lost, at most one replay a bump (sharding.MAX_REPLAYS caps a
    cascade);
  * the state cache's sharded twins EVACUATE (salvage read, re-seed over
    the survivors) with the journal cursor kept: twin bits stay equal to
    a never-failed oracle;
  * a loss opens the breaker at once, a transient rides the threshold;
  * concurrent detection of one loss costs ONE rebuild;
  * losing EVERY shard raises: nothing moves to the CPU that was not
    asked to (the reference keeps the raw device set and its host floor).

The reference's `test_device_lost_error_is_xla_runtime_error_shaped`
becomes test_device_lost_error_is_a_runtime_error (the port raises no
XlaRuntimeError). Its slow-tier four-of-eight sweep runs here at full
length (it takes a few seconds on the CPU).
"""
import random
import threading

import numpy as np
import pytest
import torch

import nomad_tpu.faults as ref_faults
from nomad_tpu.solver import backend as ref_backend
from nomad_tpu.solver import buckets as ref_buckets
from nomad_tpu.solver import microbatch as ref_microbatch
from nomad_tpu.solver import sharding as ref_sharding
from nomad_tpu.solver import state_cache as ref_state_cache

import nomad_tpu_torch.faults as faults
import nomad_tpu_torch.mock as mock
import nomad_tpu_torch.structs as structs
from nomad_tpu_torch.metrics import metrics
from nomad_tpu_torch.scheduler import Harness, new_scheduler
from nomad_tpu_torch.solver import backend, buckets, device, kernels
from nomad_tpu_torch.solver import microbatch, sharding, state_cache
from nomad_tpu_torch.solver import placer as placer_mod
from nomad_tpu_torch.solver.kernels import NUM_XR
from nomad_tpu_torch.solver.state_cache import cache
from nomad_tpu_torch.testing import seeded_urandom

from test_torch_sharding import _depth_args, _mk_alloc, _seed_store, _t

SHARDS = 8


def _reset():
    faults.clear()
    sharding.reset()
    backend.reset()
    state_cache.reset()
    microbatch.reset()
    ref_faults.clear()
    ref_sharding.reset()
    ref_buckets._reset_shards()
    ref_backend.reset()
    ref_state_cache.reset()
    ref_microbatch.reset()


@pytest.fixture(autouse=True)
def _mesh(monkeypatch):
    """Elastic tests QUARANTINE shards: the mesh, the buckets and the
    caches are restored after each, or later tests inherit a torn mesh."""
    prev_dev = device.use_device("cpu")
    prev_devs = device.use_devices(["cpu"] * SHARDS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(backend, "SHARD_MIN_NODES", 8)
    monkeypatch.setattr(ref_backend, "SHARD_MIN_NODES", 8)
    _reset()
    yield
    device.use_devices(prev_devs)
    device.use_device(prev_dev)
    _reset()
    torch.set_num_threads(threads)


def _solo_depth(args, k_max):
    return kernels.fill_depth(
        *(_t(a) for a in args[:3]), int(args[3]), _t(args[4]), _t(args[5]),
        int(args[6]), _t(args[7]), max_per_node=int(args[8]), k_max=k_max,
        order_jitter=_t(args[9]), jitter_scale=float(args[10]),
        jitter_samples=float(args[11])).numpy()


# -------------------------------------------------- loss classification

def test_device_lost_error_is_a_runtime_error():
    err = faults.device_lost_error_type()("device.lost.d3")
    assert err.device_id == 3
    assert isinstance(err, backend.device_error_types())
    assert isinstance(err, RuntimeError)
    assert backend.classify_device_error(err) == "device_loss"
    assert backend.classify_device_error(
        faults.FaultError("solver.dispatch.sharded")) == "transient"
    assert backend.classify_device_error(
        RuntimeError("CUDA error: an illegal memory access was "
                     "encountered")) == "device_loss"


def test_device_lost_sites_default_their_exc():
    faults.install({"device.lost.d5": {"mode": "nth_call", "n": 1,
                                       "times": 1}})
    with pytest.raises(faults.device_lost_error_type()) as ei:
        faults.fire("device.lost.d5")
    assert ei.value.device_id == 5


def test_breaker_opens_immediately_on_device_loss_only():
    br = backend.TierBreaker()
    br.record_failure("sharded")
    assert br.state("sharded") == "closed"
    br.record_failure("sharded", device_loss=True)
    assert br.state("sharded") == "open"
    br.reset_tier("sharded")
    assert br.state("sharded") == "closed"
    for _ in range(backend.BREAKER_THRESHOLD):
        br.record_failure("batch")
    assert br.state("batch") == "open"


# ------------------------------------------- loss mid-solve: replay

def test_single_device_loss_mid_solve_replays_bit_identically():
    args = _depth_args(512, 40, seed=5)
    name, fn = backend.select("depth", 512, k_max=16)
    assert name == "sharded"
    want = fn(*args).numpy()
    assert want.sum() == 40
    ref_want = np.asarray(ref_backend.select("depth", 512, k_max=16)[1](
        *args))
    np.testing.assert_array_equal(want, ref_want)

    r0 = metrics.counter("nomad.mesh.replays")
    faults.install({"device.lost.d3": {"mode": "after", "n": 1,
                                       "times": 1}})
    _, fn2 = backend.select("depth", 512, k_max=16)
    got = fn2(*args).numpy()
    faults.clear()

    np.testing.assert_array_equal(got, want)
    assert sharding.generation() == 1
    assert sharding.quarantined() == frozenset({3})
    assert metrics.counter("nomad.mesh.replays") == r0 + 1
    assert len(sharding.healthy_devices()) == 7
    assert sharding.mesh().ids == (0, 1, 2, 4, 5, 6, 7)
    assert buckets.node_bucket(100) % 7 == 0
    name3, _ = backend.select("depth", buckets.node_bucket(500), k_max=16)
    assert name3 == "sharded"


def test_multi_device_loss_cascade_replays_until_survivors():
    """Two shards die back to back: the first replay's dispatch loses a
    second. 336 rows split over 8, 7 and 6 shards, so each replay stays
    on the (shrinking) mesh; the verdict is still bit-identical."""
    args = _depth_args(336, 24, seed=9)
    _, fn = backend.select("depth", 336, k_max=8)
    want = fn(*args).numpy()
    r0 = metrics.counter("nomad.mesh.replays")
    faults.install({
        "device.lost.d1": {"mode": "after", "n": 1, "times": 1},
        "device.lost.d4": {"mode": "after", "n": 1, "times": 1},
    })
    _, fn2 = backend.select("depth", 336, k_max=8)
    got = fn2(*args).numpy()
    faults.clear()
    np.testing.assert_array_equal(got, want)
    assert sharding.quarantined() == frozenset({1, 4})
    assert sharding.generation() == 2
    assert metrics.counter("nomad.mesh.replays") >= r0 + 2
    assert len(sharding.healthy_devices()) == 6
    assert buckets.node_bucket(100) % 6 == 0


def test_a_real_loss_in_a_shards_launch_quarantines_that_shard(
        monkeypatch):
    """A kernel launch error with a sticky CUDA code (700, an illegal
    address; no injected device id) raised by shard 2's launch names
    shard 2: it is quarantined, and the replay on the survivors places
    as the undisturbed run."""
    from nomad_tpu_torch.solver import cuda_kernels
    args = _depth_args(336, 24, seed=4)
    _, fn = backend.select("depth", 336, k_max=8)
    want = fn(*args).numpy()
    real = cuda_kernels.depth_curve
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise cuda_kernels.KernelLaunchError(
                "depth_curve kernel launch failed: cudaError_t 700", 700)
        return real(*a, **kw)

    monkeypatch.setattr(cuda_kernels, "depth_curve", flaky)
    got = backend.select("depth", 336, k_max=8)[1](*args).numpy()
    np.testing.assert_array_equal(got, want)
    assert sharding.quarantined() == frozenset({2})
    assert sharding.generation() == 1


def test_replays_stop_at_max_replays(monkeypatch):
    """A cascade longer than MAX_REPLAYS raises the loss instead of
    replaying without end."""
    monkeypatch.setattr(sharding, "MAX_REPLAYS", 2)
    args = _depth_args(336, 24, seed=9)
    faults.install({f"device.lost.d{d}": {"mode": "after", "n": 1,
                                          "times": 1}
                    for d in (1, 2, 3, 4)})
    _, fn = backend.select("depth", 336, k_max=8)
    with pytest.raises(faults.device_lost_error_type()):
        fn(*args)
    assert sharding.generation() == 3
    assert sharding.quarantined() == frozenset({1, 2, 3})


def test_loss_replay_uses_host_args_not_dead_device_buffers():
    store, nodes, idx = _seed_store(24)
    n = len(nodes)
    bucket = buckets.node_bucket(n)
    rows = np.arange(n, dtype=np.int64)
    got = state_cache.gather(store.snapshot().usage, rows, bucket=bucket,
                             tier="sharded")
    assert sharding.is_node_sharded(got.cap_dev)
    args = _depth_args(bucket, 6, seed=3)
    _, fn = backend.select("depth", bucket, k_max=8)
    want = fn(*args).numpy()
    # the replay must read host_args: the twins' blocks are poisoned
    poisoned = tuple(sharding.NodeSharded(
        [torch.full_like(b, float("nan")) for b in t.blocks], t.mesh)
        for t in (got.cap_dev, got.used_dev))
    faults.install({"device.lost.d2": {"mode": "after", "n": 1,
                                       "times": 1}})
    out = fn(*poisoned, *args[2:], host_args=args).numpy()
    faults.clear()
    np.testing.assert_array_equal(out, want)
    assert sharding.generation() == 1


# --------------------------------------- loss inside the state cache

def test_loss_during_scatter_replay_evacuates_twins():
    store, nodes, idx = _seed_store(24)
    n = len(nodes)
    rows = np.arange(n, dtype=np.int64)
    state_cache.gather(store.snapshot().usage, rows,
                       bucket=buckets.node_bucket(n))
    assert sharding.is_node_sharded(cache()._used_dev)
    ev0 = metrics.counter("nomad.solver.state_cache.evacuations")
    misses0 = metrics.counter("nomad.solver.state_cache.misses")
    r0 = metrics.counter("nomad.mesh.replays")
    faults.install({"device.lost.d5": {"mode": "after", "n": 1,
                                       "times": 1}})
    store.upsert_allocs(idx, [_mk_alloc(nodes[0].id),
                              _mk_alloc(nodes[5].id)])
    view = store.snapshot().usage
    got = state_cache.gather(view, rows, bucket=buckets.node_bucket(n))
    fired = faults.fired("device.lost.d5")
    faults.clear()
    assert got is not None and fired == 1
    tc = cache()
    assert sharding.generation() == 1
    assert metrics.counter("nomad.solver.state_cache.evacuations") == ev0 + 1
    assert sharding.is_node_sharded(tc._used_dev)
    assert len(tc._used_dev.blocks) == 7
    assert tc._bucket % 7 == 0
    assert tc._gen == sharding.generation()
    dev_used = sharding.to_host(tc._used_dev)
    assert dev_used[:n].tobytes() == view.used.tobytes()
    assert not dev_used[n:].any()
    assert metrics.counter("nomad.solver.state_cache.misses") == misses0
    # the advance replayed once on the evacuated twins
    assert metrics.counter("nomad.mesh.replays") == r0 + 1
    assert metrics.snapshot()["gauges"].get(
        "nomad.mesh.evacuation_seconds") is not None


def test_loss_during_device_gather_serves_host_bits():
    store, nodes, idx = _seed_store(20)
    n = len(nodes)
    rows = np.arange(n, dtype=np.int64)
    bucket = buckets.node_bucket(n)
    state_cache.gather(store.snapshot().usage, rows, bucket=bucket,
                       tier="sharded")
    faults.install({"device.lost.d6": {"mode": "after", "n": 1,
                                       "times": 1}})
    view = store.snapshot().usage
    got = state_cache.gather(view, rows, bucket=bucket, tier="sharded")
    faults.clear()
    assert got is not None
    assert got.cap_dev is None and got.used_dev is None
    assert got.cap.tobytes() == view.cap[rows].tobytes()
    assert got.used.tobytes() == view.used[rows].tobytes()
    assert sharding.generation() == 1
    assert sharding.quarantined() == frozenset({6})
    # the evacuated twins serve the next gather, over 7 shards
    bucket7 = buckets.node_bucket(n)
    got2 = state_cache.gather(view, rows, bucket=bucket7, tier="sharded")
    assert len(got2.cap_dev.blocks) == 7
    assert sharding.to_host(got2.used_dev)[:n].tobytes() == \
        view.used[rows].tobytes()


def test_stale_generation_twins_are_declined_by_dev_mats():
    from nomad_tpu_torch.solver.tensorize import GroupTensors
    z = np.zeros((8, NUM_XR), np.float32)
    gt = GroupTensors(
        nodes=[], cap=z, used=z.copy(), feasible=np.ones(8, bool),
        ask=np.zeros(NUM_XR, np.float32),
        job_collisions=np.zeros(8, np.int32), distinct_hosts=False,
        cap_dev=torch.zeros(8, NUM_XR), used_dev=torch.zeros(8, NUM_XR),
        gen=sharding.generation())
    assert placer_mod.SolverPlacer._dev_mats(gt, "torch") is not None
    sharding.rebuild("test", lost_device_ids=(0,))
    assert placer_mod.SolverPlacer._dev_mats(gt, "torch") is None


def test_mesh_snapshot_pins_bucket_and_selection_together():
    snap = sharding.snapshot()
    assert snap.shards == 8
    padded = buckets.node_bucket(100, shards=snap.shards)
    sharding.rebuild("test", lost_device_ids=(7,))
    assert buckets.node_bucket(100) % 7 == 0
    # selection under the stale snapshot re-snapshots: the 8-multiple
    # bucket does not divide 7 survivors, so the solve is solo
    args = _depth_args(padded, 10, seed=11)
    name, fn = backend.select("depth", padded, k_max=8, mesh_snap=snap)
    assert name == "torch"
    assert int(fn(*args).sum()) == 10


# ------------------------------------------------- warmup + idempotence

def test_loss_during_aot_warmup_rebuilds_and_completes(monkeypatch):
    monkeypatch.setenv("NOMAD_AOT_WARMUP", "1")
    faults.install({"device.lost.d6": {"mode": "after", "n": 2,
                                       "times": 1}})
    res = backend.warmup(512, k_maxes=(8,))
    faults.clear()
    # the depth regimes, greedy, the scan and the window, the fused
    # depth pair and greedy (sharded, over sharded twins), the convex
    # pair: every artifact built despite the loss
    assert res["artifacts"] == 10
    assert metrics.counter("nomad.solver.warmup.errors") == 0
    assert sharding.generation() >= 1
    assert 6 in sharding.quarantined()


def test_generation_bump_idempotent_under_thread_hammer():
    g0 = sharding.generation()
    barrier = threading.Barrier(4)

    def blame_same():
        barrier.wait()
        sharding.rebuild("test", lost_device_ids=(2,),
                         observed_generation=g0)

    threads = [threading.Thread(target=blame_same) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sharding.generation() == g0 + 1
    assert sharding.quarantined() == frozenset({2})
    g1 = sharding.generation()
    barrier2 = threading.Barrier(3)

    def blame(dev):
        barrier2.wait()
        sharding.rebuild("test", lost_device_ids=(dev,),
                         observed_generation=g1)

    threads = [threading.Thread(target=blame, args=(d,)) for d in (4, 5, 6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sharding.generation() == g1 + 3
    assert sharding.quarantined() == frozenset({2, 4, 5, 6})
    assert len(sharding.healthy_devices()) == 4
    assert buckets.node_bucket(100) % 4 == 0
    m = sharding.mesh()
    assert m is not None and m.size == 4


def test_launch_hammer_during_loss_loses_zero_solves():
    args = {i: _depth_args(256, 16, seed=20 + i) for i in range(4)}
    _, fn = backend.select("depth", 256, k_max=8)
    want = {i: fn(*args[i]).numpy() for i in range(4)}
    faults.install({"device.lost.d0": {"mode": "after", "n": 3,
                                       "times": 1}})
    outs: dict = {}
    errs: list = []
    barrier = threading.Barrier(4)

    def worker(i):
        try:
            barrier.wait()
            _, f = backend.select("depth", 256, k_max=8)
            outs[i] = f(*args[i]).numpy()
        except Exception as e:      # noqa: BLE001 — surface to the test
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    faults.clear()
    assert not errs, errs
    assert len(outs) == 4
    for i in range(4):
        np.testing.assert_array_equal(outs[i], want[i])
    assert sharding.generation() == 1
    assert sharding.quarantined() == frozenset({0})
    assert sharding.mesh().lead == torch.device("cpu")


# ------------------------------------- sharded-vs-solo parity + stream

def test_sharded_vs_solo_bit_parity_after_evacuation():
    store, nodes, idx = _seed_store(24)
    n = len(nodes)
    rows = np.arange(n, dtype=np.int64)
    state_cache.gather(store.snapshot().usage, rows,
                       bucket=buckets.node_bucket(n))
    faults.install({"device.lost.d1": {"mode": "after", "n": 1,
                                       "times": 1}})
    store.upsert_allocs(idx, [_mk_alloc(nodes[2].id)])
    view = store.snapshot().usage
    state_cache.gather(view, rows, bucket=buckets.node_bucket(n))
    faults.clear()
    assert sharding.generation() == 1

    bucket = buckets.node_bucket(n)             # a 7-survivor multiple
    assert bucket % 7 == 0
    got = state_cache.gather(view, rows, bucket=bucket, tier="sharded")
    assert sharding.is_node_sharded(got.cap_dev)
    assert len(got.cap_dev.blocks) == 7
    args = _depth_args(bucket, 6, seed=3)
    cap = np.zeros((bucket, NUM_XR), np.float32)
    cap[:n] = got.cap
    used = np.zeros((bucket, NUM_XR), np.float32)
    used[:n] = got.used
    feas = np.zeros(bucket, bool)
    feas[:n] = True
    solo_args = (cap, used) + args[2:4] + (feas,) + args[5:]
    name, fn = backend.select("depth", bucket, k_max=8)
    assert name == "sharded"
    sharded_out = fn(got.cap_dev, got.used_dev, *args[2:4], feas,
                     *args[5:], host_args=solo_args).numpy()
    solo_out = _solo_depth(solo_args, 8)
    np.testing.assert_array_equal(sharded_out, solo_out)


def _stream_eval(count, eval_id, job_tag, fused=True, n_nodes=16):
    """One pinned-id eval through the full scheduler path."""
    with seeded_urandom(1234):
        random.seed(1234)
        h = Harness()
        h.state.set_scheduler_config(
            h.get_next_index(), structs.SchedulerConfiguration(
                scheduler_algorithm="tpu-batch",
                solver_fused_enabled=fused))
        for i in range(n_nodes):
            nd = mock.node()
            nd.id = f"node-{i:04d}"
            nd.name = f"mesh-{i}"
            h.state.upsert_node(h.get_next_index(), nd)
        job = mock.batch_job()
        job.id = job.name = f"mesh-job-{job_tag}"
        tg = job.task_groups[0]
        tg.count = count
        tg.networks = []
        t = tg.tasks[0]
        t.resources.networks = []
        t.resources.cpu = 250
        t.resources.memory_mb = 128
        h.state.upsert_job(h.get_next_index(), job)
        ev = structs.Evaluation(id=eval_id, job_id=job.id, type=job.type)
        h.process(lambda s, p: new_scheduler(job.type, s, p), ev)
    placed: dict[str, int] = {}
    for a in h.state.allocs_by_job("default", job.id):
        placed[a.node_id] = placed.get(a.node_id, 0) + 1
    return placed, h.evals[-1].status


@pytest.mark.parametrize("fused", [True, False])
def test_eval_stream_survives_generation_bump_bit_identically(fused):
    counts = [24, 48, 16, 48]
    ref = [_stream_eval(c, f"mesh-eval-{i}", f"{i}", fused)
           for i, c in enumerate(counts)]
    _reset()
    r0 = metrics.counter("nomad.mesh.replays")
    faults.install({"device.lost.d2": {"mode": "after", "n": 2,
                                       "times": 1}})
    got = [_stream_eval(c, f"mesh-eval-{i}", f"{i}", fused)
           for i, c in enumerate(counts)]
    fired = faults.fired("device.lost.d2")
    faults.clear()
    for i, ((placed_ref, _), (placed_got, status)) in enumerate(
            zip(ref, got)):
        assert status == "complete", f"eval {i} lost to the shard's death"
        assert sum(placed_got.values()) == counts[i]
        assert placed_got == placed_ref, i
    assert fired == 1
    assert sharding.generation() >= 1
    assert 2 in sharding.quarantined()
    assert metrics.counter("nomad.mesh.replays") >= r0 + 1


def test_window_loses_its_lead_shard_and_replays(monkeypatch):
    """A coalesced window whose lead shard dies: the mesh rebuilds, the
    identical window replays at the new generation on the new first
    shard, and every lane gets its solo placements."""
    from test_torch_sharding import _concurrently
    monkeypatch.setattr(backend, "BATCH_MAX_COUNT", 2048)
    microbatch.configure(enabled=True, window_s=0.05)
    lanes = [_depth_args(64, c, seed=30 + c) for c in (10, 20, 30)]
    _, solo = backend.select("depth", 64, k_max=64)
    want = [solo(*a).numpy() for a in lanes]
    r0 = metrics.counter("nomad.mesh.replays")
    faults.install({"device.lost.d0": {"mode": "after", "n": 1,
                                       "times": 1}})

    def solve(*a):
        _, fn = backend.select("depth", 64, count=int(a[3]), k_max=64)
        return fn(*a).numpy()

    out = _concurrently(solve, lanes)
    faults.clear()
    for got, w in zip(out, want):
        assert not isinstance(got, BaseException), got
        np.testing.assert_array_equal(got, w)
    assert sharding.quarantined() == frozenset({0})
    assert sharding.lead_id() == 1
    assert metrics.counter("nomad.mesh.replays") >= r0 + 1


def test_debug_bundle_mesh_block_shape():
    sharding.rebuild("operator", lost_device_ids=(1,))
    d = sharding.describe()
    assert d == {"Generation": 1, "QuarantinedDevices": [1],
                 "HealthyDevices": 7, "Shards": 7, "AxisName": "nodes"}
    ref_sharding.rebuild("operator", lost_device_ids=(1,))
    assert ref_sharding.describe() == d
    from nomad_tpu_torch.obs import devruntime
    layout = devruntime._mesh_layout()
    assert layout["devices"] == 7 and layout["device_ids"] == \
        [0, 2, 3, 4, 5, 6, 7]


# --------------------------------------------- every shard lost: raise

def test_losing_every_shard_raises_and_solves_nothing_on_the_cpu():
    """The reference keeps its raw device set and a host floor; the port
    raises from the first solve once every shard is quarantined."""
    sharding.rebuild("test", lost_device_ids=range(SHARDS))
    assert sharding.lost() and sharding.mesh() is None
    t0 = metrics.counter("nomad.solver.dispatch.torch")
    for kernel in ("depth", "greedy", "chunked"):
        with pytest.raises(sharding.MeshLostError):
            backend.select(kernel, 512)
    with pytest.raises(sharding.MeshLostError):
        backend.select_fused("depth", 512)
    with pytest.raises(sharding.MeshLostError):
        _stream_eval(8, "lost-ev", "lost")
    assert metrics.counter("nomad.solver.dispatch.torch") == t0
    assert cache().twins() == (None, None)


def test_kill_four_of_eight_under_sustained_stream():
    """Four of eight shards die one at a time under a sustained solve
    stream: zero solves lost, four generation bumps, buckets track every
    survivor count, every solve equal to its solo solve."""
    faults.install({
        f"device.lost.d{d}": {"mode": "after", "n": 5 + 4 * i, "times": 1}
        for i, d in enumerate((1, 3, 5, 7))})
    errs: list = []
    for step in range(40):
        try:
            bucket = buckets.node_bucket(200)
            args = _depth_args(bucket, 12, seed=step)
            _, fn = backend.select("depth", bucket, k_max=8)
            out = fn(*args).numpy()
            assert out.sum() == 12
            np.testing.assert_array_equal(out, _solo_depth(args, 8))
        except Exception as e:      # noqa: BLE001 — surface to the test
            errs.append((step, e))
    faults.clear()
    assert not errs, errs
    assert sharding.quarantined() == frozenset({1, 3, 5, 7})
    assert sharding.generation() == 4
    assert len(sharding.healthy_devices()) == 4
