"""The rest of the mesh, on 8 virtual CPU shards against the reference's 8
JAX CPU devices: micro-batch windows split over the shards, the
eval-batched greedy, and a lost shard in a sharded scan, a sharded convex
solve or a split window.

  * A classic window whose lane count divides over the shards splits its
    lanes (sharding.lane_sharding, sharding.split_lanes): each shard
    solves its lanes with one lane solve, and each lane equals its solo
    solve and the reference's. A lane count that does not divide runs
    solo on the first shard (lane_sharding is None).
  * A fused window over node-sharded twins runs each shard's gather
    entry over the lanes' rows it owns (sharding.sharded_fused_lanes):
    each lane equals the sharded fused program on that lane alone and the
    reference's.
  * Such a window fires every shard's device.lost.d<N> site, and a loss
    replays it on the survivors.
  * sharding.sharded_eval_batch_fill_greedy on 2 eval groups x 4 shards
    against the reference's on a (2, 4) JAX mesh ("evals", "nodes").
  * A loss in a sharded scan or a sharded convex solve replays on the
    survivors with the same result; every shard lost raises and solves
    nothing on the CPU.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import nomad_tpu.faults as ref_faults
from nomad_tpu.solver import backend as ref_backend
from nomad_tpu.solver import buckets as ref_buckets
from nomad_tpu.solver import kernels as ref_kernels
from nomad_tpu.solver import microbatch as ref_microbatch
from nomad_tpu.solver import sharding as ref_sharding
from nomad_tpu.solver import state_cache as ref_state_cache

from nomad_tpu_torch import faults
from nomad_tpu_torch.metrics import metrics
from nomad_tpu_torch.solver import backend, convex, device, kernels
from nomad_tpu_torch.solver import microbatch, sharding, state_cache
from nomad_tpu_torch.solver.kernels import NUM_XR
from nomad_tpu_torch.testing import chunked_case, convex_fixture
from test_torch_sharding import _concurrently, _depth_args, _t

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
    prev_dev = device.use_device("cpu")
    prev_devs = device.use_devices(["cpu"] * SHARDS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(backend, "SHARD_MIN_NODES", 8)
    monkeypatch.setattr(ref_backend, "SHARD_MIN_NODES", 8)
    monkeypatch.setattr(backend, "BATCH_MAX_COUNT", 2048)
    _reset()
    yield
    device.use_devices(prev_devs)
    device.use_device(prev_dev)
    _reset()
    torch.set_num_threads(threads)


def _ref_depth(args, k_max):
    return np.asarray(ref_kernels.fill_depth(
        *args[:8], max_per_node=args[8], k_max=k_max,
        order_jitter=args[9], jitter_scale=args[10],
        jitter_samples=args[11]))


class _Spy:
    """Counts sharding.split_lanes calls and the shards each one used."""

    def __init__(self, monkeypatch):
        self.shards = []
        real = sharding.split_lanes

        def spy(m, lanes_fn, parts):
            self.shards.append(m.size)
            return real(m, lanes_fn, parts)
        monkeypatch.setattr(sharding, "split_lanes", spy)


def _all_sites():
    return {f"device.lost.d{i}": {"mode": "delay", "delay_ms": 0.0}
            for i in range(SHARDS)}


# ------------------------------------------------- classic windows

@pytest.mark.parametrize("n_lanes", [8, 16])
def test_classic_window_splits_its_lanes_over_the_shards(monkeypatch,
                                                         n_lanes):
    """8 (one a shard) or 16 lanes (two a shard): one split window, every
    shard's loss site fired, every lane equal to its solo solve and to
    the reference's fill_depth on it."""
    microbatch.configure(enabled=True, window_s=2.0)
    spy = _Spy(monkeypatch)
    lanes = [_depth_args(64, 5 + 3 * i, seed=40 + i)
             for i in range(n_lanes)]
    _, solo = backend.select("depth", 64, k_max=32)
    want = [solo(*a).numpy() for a in lanes]

    def solve(*a):
        name, fn = backend.select("depth", 64, count=int(a[3]), k_max=32)
        assert name == "batch"
        return fn(*a).numpy()

    faults.install(_all_sites())
    d0 = metrics.counter("nomad.solver.microbatch.dispatches")
    try:
        out = _concurrently(solve, lanes)
        fired = {i: faults.fired(f"device.lost.d{i}") for i in range(SHARDS)}
    finally:
        faults.clear()
    assert metrics.counter("nomad.solver.microbatch.dispatches") > d0
    assert spy.shards and set(spy.shards) == {SHARDS}
    assert all(n >= 1 for n in fired.values()), fired
    for a, got, w in zip(lanes, out, want):
        assert not isinstance(got, BaseException), got
        assert got.tobytes() == w.tobytes()
        np.testing.assert_array_equal(got, _ref_depth(a, 32))


def test_lane_sharding_is_none_where_the_lanes_do_not_divide():
    assert sharding.lane_sharding(8).size == SHARDS
    assert sharding.lane_sharding(16).size == SHARDS
    assert sharding.lane_sharding(3) is None
    sharding.rebuild("test", lost_device_ids=(5, 6, 7, 1, 2))
    m = sharding.mesh()
    assert m.size == 3
    assert sharding.lane_sharding(8) is None
    assert sharding.lane_sharding(6).size == 3
    # the reference's rule, on its 8 devices
    assert ref_sharding.lane_sharding(8) is not None
    assert ref_sharding.lane_sharding(3) is None


def test_split_window_loses_a_shard_and_replays_on_the_survivors(
        monkeypatch):
    """Shard 3 is lost as the split window launches: the mesh rebuilds to
    7 shards, 8 lanes no longer divide, and the identical window replays
    solo on the first shard; every lane still equals its solo solve."""
    microbatch.configure(enabled=True, window_s=2.0)
    spy = _Spy(monkeypatch)
    lanes = [_depth_args(64, 4 + i, seed=60 + i) for i in range(8)]
    _, solo = backend.select("depth", 64, k_max=16)
    want = [solo(*a).numpy() for a in lanes]
    r0 = metrics.counter("nomad.mesh.replays")
    faults.install({"device.lost.d3": {"mode": "nth_call", "n": 1,
                                       "times": 1}})

    def solve(*a):
        _, fn = backend.select("depth", 64, count=int(a[3]), k_max=16)
        return fn(*a).numpy()

    try:
        out = _concurrently(solve, lanes)
        assert faults.fired("device.lost.d3") == 1
    finally:
        faults.clear()
    for got, w in zip(out, want):
        assert not isinstance(got, BaseException), got
        np.testing.assert_array_equal(got, w)
    assert sharding.quarantined() == frozenset({3})
    assert metrics.counter("nomad.mesh.replays") >= r0 + 1
    assert spy.shards == []     # the loss fired before the split launched


# --------------------------------------------------- fused windows

def _fused_lane(seed, bucket, n_res, count):
    rng = np.random.default_rng(seed)
    n_live = bucket * 3 // 4
    idx = np.zeros(bucket, np.int32)
    idx[:n_live] = rng.permutation(n_res)[:n_live]
    valid = np.zeros(bucket, bool)
    valid[:n_live] = True
    feas = valid.copy()
    feas[::9] = False
    ask = np.zeros(NUM_XR, np.float32)
    ask[0], ask[1] = 250, 512
    return (idx, valid, ask, np.int32(count), feas,
            rng.integers(0, 2, bucket).astype(np.int32), np.int32(count),
            np.zeros(bucket, np.float32), np.int32(2 ** 30),
            rng.random(bucket, dtype=np.float32), np.float32(1.5),
            np.float32(0.0), np.zeros(bucket, np.int32), np.bool_(False))


def test_fused_window_over_sharded_twins_runs_each_shards_gather(
        monkeypatch):
    """8 fused depth evals over one pair of node-sharded twins coalesce
    into one window that launches each shard's gather entry over the
    lanes' rows it owns: every lane equals the sharded fused program on
    it alone and the reference's sharded fused program, placements and
    verdict."""
    microbatch.configure(enabled=True, window_s=2.0)
    rng = np.random.default_rng(3)
    n_res, bucket = 256, 128
    cap = np.zeros((n_res, NUM_XR), np.float32)
    cap[:, 0] = rng.choice([2000, 4000, 8000], n_res)
    cap[:, 1] = rng.choice([4096, 8192, 16384], n_res)
    cap[:, 2:] = (100_000, 12_001, 1_000)
    used = np.zeros_like(cap)
    used[:, 0] = rng.choice([0, 500, 1500], n_res)
    m = sharding.mesh()
    twins = (sharding.put_node_sharded(cap, m),
             sharding.put_node_sharded(used, m))
    lanes = [_fused_lane(70 + i, bucket, n_res, 3 + 5 * i)
             for i in range(8)]
    prog = sharding.sharded_fused(m, "depth", k_max=32)
    want = [tuple(x.numpy() for x in prog(*twins, *lane)) for lane in lanes]
    ref_prog = ref_sharding.sharded_fused(ref_sharding.mesh(), "depth",
                                          k_max=32)
    ref_twins = (ref_sharding.put_node_sharded(cap),
                 ref_sharding.put_node_sharded(used))
    calls = []
    real = sharding._per_shard

    def spy(mm, launch):
        calls.append(mm.size)
        return real(mm, launch)
    monkeypatch.setattr(sharding, "_per_shard", spy)

    def solve(*lane):
        sel = backend.select_fused("depth", bucket, count=int(lane[3]),
                                   k_max=32, sharded_twins=True)
        assert sel[0] == "batch"
        return sel[1](*twins, *lane)

    faults.install(_all_sites())
    b0 = metrics.counter("nomad.solver.dispatch.fused.batch")
    try:
        out = _concurrently(solve, lanes)
        fired = [faults.fired(f"device.lost.d{i}") for i in range(SHARDS)]
    finally:
        faults.clear()
    assert all(n >= 1 for n in fired), fired
    # every lane rode the coalesced window
    assert metrics.counter("nomad.solver.dispatch.fused.batch") == b0 + 8
    # one gather-entry pass and one verdict pass over the mesh a window
    assert calls and all(c == SHARDS for c in calls)
    for lane, got, w in zip(lanes, out, want):
        assert not isinstance(got, BaseException), got
        assert got[0].tobytes() == w[0].tobytes()
        assert got[1].tobytes() == w[1].tobytes()
        ref = ref_prog(*ref_twins, *lane)
        np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1], np.asarray(ref[1]))


# ------------------------------------------- the eval-batched greedy

@pytest.mark.parametrize("count", [1, 40, 300])
def test_eval_batched_greedy_matches_the_reference_on_a_2x4_mesh(count):
    """4 evals over 2 eval groups of 4 shards (the port's 1-D mesh) against
    the reference's on a (2, 4) ("evals", "nodes") mesh: each eval equals
    the reference's and its solo greedy."""
    n_evals, n = 4, 128
    per = [_depth_args(n, count + 7 * e, seed=90 + e)
           for e in range(n_evals)]
    cap = np.stack([a[0] for a in per])
    used = np.stack([a[1] for a in per])
    ask = np.stack([a[2] for a in per])
    counts = np.array([int(a[3]) for a in per], np.int32)
    feas = np.stack([a[4] for a in per])
    got = sharding.sharded_eval_batch_fill_greedy(sharding.mesh(), 2)(
        cap, used, ask, counts, feas)
    assert got.shape == (n_evals, n)
    jm = JaxMesh(np.array(jax.devices()[:8]).reshape(2, 4),
                 ("evals", "nodes"))
    want = np.asarray(ref_sharding.sharded_eval_batch_fill_greedy(jm)(
        cap, used, ask, counts, feas))
    np.testing.assert_array_equal(got.numpy(), want)
    for e in range(n_evals):
        solo = kernels.fill_greedy_binpack(_t(cap[e]), _t(used[e]),
                                           _t(ask[e]), int(counts[e]),
                                           _t(feas[e]))
        assert got[e].numpy().tobytes() == solo.numpy().tobytes()


def test_eval_groups_must_divide_the_shards():
    with pytest.raises(ValueError):
        sharding.sharded_eval_batch_fill_greedy(sharding.mesh(), 3)
    fn = sharding.sharded_eval_batch_fill_greedy(sharding.mesh(), 4)
    assert fn.in_specs == (sharding.EVALS_NODE, sharding.EVALS_NODE,
                           sharding.EVALS, sharding.EVALS,
                           sharding.EVALS_NODE)


# --------------------------------------- a lost shard in a sharded solve

def test_a_loss_in_the_sharded_scan_replays_on_the_survivors():
    args, kw = chunked_case("even_spread")
    n = args[0].shape[0]
    tail = (np.zeros(n, np.int32), np.int32(2 ** 30))
    name, fn = backend.select("chunked", n, max_steps=kw["max_steps"])
    assert name == "sharded"
    want = fn(*args, *tail, finish=lambda out: sharding.to_host(out[0]))
    r0 = metrics.counter("nomad.mesh.replays")
    faults.install({"device.lost.d6": {"mode": "nth_call", "n": 1,
                                       "times": 1}})
    _, fn2 = backend.select("chunked", n, max_steps=kw["max_steps"])
    try:
        got = fn2(*args, *tail, finish=lambda out: sharding.to_host(out[0]))
    finally:
        faults.clear()
    np.testing.assert_array_equal(got, want)
    assert sharding.quarantined() == frozenset({6})
    assert metrics.counter("nomad.mesh.replays") == r0 + 1
    assert int(want.sum()) == int(args[3])


def test_a_loss_in_the_sharded_convex_solve_replays_on_the_survivors():
    cap, used, feas, coll, ask, count, kw = convex_fixture("fuzz_affinity")
    b = cap.shape[0]
    rest = (np.arange(b, dtype=np.int32), np.ones(b, bool), ask,
            np.int32(count), feas, np.int32(kw["max_per_node"]),
            kw["affinity_boost"], coll, np.zeros(b, np.int32),
            np.bool_(False), np.int32(kw["max_iters"]),
            np.float32(kw["tolerance"]), np.float32(kw["fairness_weight"]),
            np.float32(kw["quota_budget"]))
    host = (cap, used) + rest
    name, run = backend.select_convex("greedy", b)
    assert name == "sharded"
    m = sharding.mesh()
    twins = tuple(sharding.put_node_sharded(a, m) for a in (cap, used))
    want = run(*twins, *rest, host_args=host)
    r0 = metrics.counter("nomad.mesh.replays")
    faults.install({"device.lost.d2": {"mode": "nth_call", "n": 1,
                                       "times": 1}})
    _, run2 = backend.select_convex("greedy", b)
    try:
        got = run2(*twins, *rest, host_args=host)
    finally:
        faults.clear()
    # 128 rows do not split over the 7 survivors: the replay runs solo on
    # their first device, and places as the sharded solve did
    solo = convex.to_host(convex.convex_eval(
        *(_t(a) if isinstance(a, np.ndarray) else a for a in host)))
    for g, w, s in zip(got[:2], want[:2], solo[:2]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)
    assert got[4] == want[4]
    assert sharding.quarantined() == frozenset({2})
    assert metrics.counter("nomad.mesh.replays") == r0 + 1


def test_every_shard_lost_raises_and_solves_nothing_on_the_cpu():
    sharding.rebuild("test", lost_device_ids=range(SHARDS))
    t0 = metrics.counter("nomad.solver.dispatch.torch")
    with pytest.raises(sharding.MeshLostError):
        backend.select("chunked", 128)
    with pytest.raises(sharding.MeshLostError):
        backend.select_convex("greedy", 128)
    with pytest.raises(sharding.MeshLostError):
        backend.select("depth", 64, count=4)
    assert metrics.counter("nomad.solver.dispatch.torch") == t0
