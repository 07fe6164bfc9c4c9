"""The port's device mesh (nomad_tpu_torch/solver/sharding.py) against the
reference's, on the CPU: the port's mesh is 8 virtual shards of the CPU
device (`device.use_devices(["cpu"] * 8)`), the reference's the 8 JAX CPU
devices tests/conftest.py forces. The same seeded numpy inputs go through
both packages' sharded functions: placements, capacities, masks and
counts equal exactly, and each port sharded solve equals the port's solo
solve bit for bit. Counterparts of tests/test_sharding.py, case by case,
with the sharded tier's floor (SHARD_MIN_NODES) lowered as the
reference's tests lower it.

Differences from the reference, each pinned here:
  * a fault on the sharded rung raises out of the solve (and feeds the
    breaker, which only observes) where the reference demotes to its xla
    tier: card work never moves down a ladder (backend.py);
  * the micro-batcher's windows are not padded to a fixed lane count, so
    a window splits its lanes over the mesh only where its live lane
    count divides over the shards; else it runs solo on the mesh's first
    device (test_windows_run_solo_on_the_first_shard; the split windows
    are tests/test_torch_mesh_windows.py's);
  * the chunked scan and the convex solve take the sharded tier at the
    buckets the mesh takes (test_scan_and_convex_stay_solo_on_the_mesh;
    their parity with the reference's sharded_place_chunked and
    sharded_convex: tests/test_torch_sharded_scan.py and
    tests/test_torch_sharded_convex.py).
"""
import random
import threading
import time
import types

import numpy as np
import pytest
import torch

import nomad_tpu.faults as ref_faults
import nomad_tpu.mock as ref_mock
import nomad_tpu.structs as ref_structs
from nomad_tpu.metrics import metrics as ref_metrics
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.scheduler import new_scheduler as ref_new_scheduler
from nomad_tpu.solver import backend as ref_backend
from nomad_tpu.solver import buckets as ref_buckets
from nomad_tpu.solver import microbatch as ref_microbatch
from nomad_tpu.solver import placer as ref_placer
from nomad_tpu.solver import sharding as ref_sharding
from nomad_tpu.solver import state_cache as ref_state_cache

import nomad_tpu_torch.faults as port_faults
import nomad_tpu_torch.mock as port_mock
import nomad_tpu_torch.structs as port_structs
from nomad_tpu_torch.metrics import metrics
from nomad_tpu_torch.scheduler import Harness as PortHarness
from nomad_tpu_torch.scheduler import new_scheduler as port_new_scheduler
from nomad_tpu_torch.solver import backend, buckets, device, kernels
from nomad_tpu_torch.solver import microbatch, sharding, state_cache
from nomad_tpu_torch.solver import placer as port_placer
from nomad_tpu_torch.solver.kernels import NUM_XR
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.testing import seeded_urandom

SHARDS = 8

REF = types.SimpleNamespace(mock=ref_mock, structs=ref_structs,
                            Harness=RefHarness,
                            new_scheduler=ref_new_scheduler,
                            backend=ref_backend, metrics=ref_metrics)
PORT = types.SimpleNamespace(mock=port_mock, structs=port_structs,
                             Harness=PortHarness,
                             new_scheduler=port_new_scheduler,
                             backend=backend, metrics=metrics)


def _reset_ref():
    ref_faults.clear()
    ref_sharding.reset()
    ref_buckets._reset_shards()
    ref_backend.reset()
    ref_state_cache.reset()
    ref_microbatch.reset()


def _reset_port():
    port_faults.clear()
    sharding.reset()
    backend.reset()
    state_cache.reset()
    microbatch.reset()


@pytest.fixture(autouse=True)
def _mesh():
    """8 virtual CPU shards for the port, the 8 JAX CPU devices for the
    reference; both worlds restored after."""
    prev_dev = device.use_device("cpu")
    prev_devs = device.use_devices(["cpu"] * SHARDS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _reset_ref()
    _reset_port()
    yield
    _reset_ref()
    device.use_devices(prev_devs)
    device.use_device(prev_dev)
    _reset_port()
    torch.set_num_threads(threads)


@pytest.fixture
def low_floor(monkeypatch):
    """The sharded tier at test sizes on both sides (the reference's tests
    lower the floor the same way)."""
    monkeypatch.setattr(backend, "SHARD_MIN_NODES", 8)
    monkeypatch.setattr(ref_backend, "SHARD_MIN_NODES", 8)


def _depth_args(n, count, seed=0, feas_every=7):
    """tests/test_sharding.py's depth inputs."""
    rng = np.random.default_rng(seed)
    cap = np.zeros((n, NUM_XR), np.float32)
    cap[:, 0] = rng.choice([2000, 4000, 8000], n)
    cap[:, 1] = rng.choice([4096, 8192, 16384], n)
    cap[:, 2] = 100_000
    cap[:, 3] = 12_001
    cap[:, 4] = 1_000
    used = np.zeros_like(cap)
    used[:, 0] = rng.choice([0, 250, 1000], n)
    used[:, 1] = rng.choice([0, 512, 2048], n)
    ask = np.zeros(NUM_XR, np.float32)
    ask[0], ask[1] = 500, 256
    feas = np.ones(n, bool)
    feas[::feas_every] = False
    return (cap, used, ask, np.int32(count), feas,
            rng.integers(0, 2, n).astype(np.int32), np.int32(count),
            np.zeros(n, np.float32), np.int32(2 ** 30),
            rng.random(n, dtype=np.float32), np.float32(1.0),
            np.float32(0.0))


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _mk_alloc(node_id: str, cpu: int = 100, mem: int = 128):
    s = port_structs
    return s.Allocation(
        id=s.new_id(), namespace="default", eval_id=s.new_id(),
        name="j1.web[0]", job_id="j1", task_group="web", node_id=node_id,
        node_name=node_id, desired_status="run", client_status="pending",
        allocated_resources=s.AllocatedResources(
            shared=s.AllocatedSharedResources(disk_mb=150),
            tasks={"t": s.AllocatedTaskResources(cpu_shares=cpu,
                                                 memory_mb=mem)}))


def _seed_store(n_nodes: int):
    store = StateStore()
    store.set_scheduler_config(1, port_structs.SchedulerConfiguration(
        scheduler_algorithm="tpu-batch"))
    idx = 2
    nodes = []
    for i in range(n_nodes):
        n = port_mock.node()
        n.id = f"node-{i:04d}"
        store.upsert_node(idx, n)
        nodes.append(n)
        idx += 1
    return store, nodes, idx


def _twin_host(x) -> np.ndarray:
    return sharding.to_host(x)


# --------------------------------------------------- mesh + layout plumbing

def test_mesh_is_a_process_singleton_over_all_devices():
    m = sharding.mesh()
    assert m is not None and m is sharding.mesh()
    assert m.size == SHARDS == len(ref_sharding.mesh().devices.flat)
    assert m.ids == tuple(range(SHARDS))
    assert all(d.device == torch.device("cpu") for d in m.devices)
    snap = sharding.snapshot()
    assert snap.mesh is m and snap.shards == SHARDS and snap.generation == 0


def test_spec_round_trip_and_introspection():
    x = np.arange(64 * NUM_XR, dtype=np.float32).reshape(64, NUM_XR)
    dev = sharding.put_node_sharded(x)
    assert sharding.is_node_sharded(dev)
    assert sharding.is_node_sharded(dev, sharding.mesh())
    assert len(dev.blocks) == SHARDS and dev.rows == 64 // SHARDS
    assert dev.shape == (64, NUM_XR)
    np.testing.assert_array_equal(_twin_host(dev), x)
    np.testing.assert_array_equal(dev.lead().numpy(), x)
    # the reference's spec on the same array holds the same bits
    ref = ref_sharding.put_node_sharded(x)
    assert ref_sharding.is_node_sharded(ref)
    np.testing.assert_array_equal(np.asarray(ref), _twin_host(dev))
    # host arrays and whole tensors are not node-sharded
    assert not sharding.is_node_sharded(x)
    assert not sharding.is_node_sharded(torch.from_numpy(x))


def test_node_bucket_pads_to_mesh_multiple(monkeypatch):
    assert buckets.node_bucket(100) == ref_buckets.node_bucket(100) == 128
    assert buckets.node_bucket(3) == 8
    # six shards: every bucket a multiple of 6, as the reference's torn pod
    device.use_devices(["cpu"] * 6)
    import jax
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: real(*a, **kw)[:6])
    assert buckets.node_bucket(100) == ref_buckets.node_bucket(100) == 132
    monkeypatch.setattr(jax, "devices", real)
    device.use_devices(["cpu"] * SHARDS)
    assert buckets.node_bucket(100) == 128


def test_single_device_world_demotes_to_solo_tiers(monkeypatch):
    device.use_devices(["cpu"])
    sharding.reset()
    backend.reset()
    assert sharding.mesh() is None
    assert sharding.snapshot().shards == 1
    name, _ = backend.select("depth", backend.SHARD_MIN_NODES)
    assert name == "torch"
    monkeypatch.setenv("NOMAD_SOLVER_BACKEND", "sharded")
    backend.reset()
    name, _ = backend.select("depth", backend.SHARD_MIN_NODES)
    assert name == "torch"              # the forced override demotes too


def test_tier_follows_the_floor_and_the_override(monkeypatch):
    """Sharded from SHARD_MIN_NODES (the reference's 32768) on a dividing
    bucket; solo below it; NOMAD_SOLVER_BACKEND=sharded skips the floor
    and any other forced value keeps every solve solo."""
    floor = backend.SHARD_MIN_NODES
    assert floor == ref_backend.SHARD_MIN_NODES == 32768
    assert backend.select("depth", floor)[0] == "sharded"
    assert backend.select("greedy", floor)[0] == "sharded"
    assert backend.select("depth", floor // 2)[0] == "torch"
    assert backend.select("chunked", floor)[0] == "sharded"
    assert backend.select("chunked", floor // 2)[0] == "torch"
    monkeypatch.setenv("NOMAD_SOLVER_BACKEND", "sharded")
    assert backend.select("depth", 64)[0] == "sharded"
    assert backend.select("depth", 60)[0] == "torch"    # does not divide
    monkeypatch.setenv("NOMAD_SOLVER_BACKEND", "torch")
    assert backend.select("depth", floor)[0] == "torch"


# --------------------------------------------- sharded solves: parity

@pytest.mark.parametrize("count", [1, 40, 600])
def test_sharded_greedy_matches_the_reference_and_the_solo_solve(count):
    args = _depth_args(512, count, seed=3 + count)
    greedy = args[:5] + (np.int32(2 if count == 600 else 2 ** 30),)
    got = sharding.sharded_fill_greedy(sharding.mesh())(*greedy)
    assert got.device == sharding.mesh().lead
    ref = np.asarray(ref_sharding.sharded_fill_greedy(ref_sharding.mesh())(
        *greedy))
    solo = kernels.fill_greedy_binpack(*(_t(a) for a in greedy[:3]),
                                       int(count), _t(greedy[4]),
                                       int(greedy[5])).numpy()
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.numpy().tobytes() == solo.tobytes()
    assert int(got.sum()) == min(count, int(ref.sum()))


@pytest.mark.parametrize("case", ["dense", "grid", "spread", "mpn1",
                                  "jitter", "affinity"])
def test_sharded_depth_matches_the_reference_and_the_solo_solve(case):
    args = list(_depth_args(1024, 300, seed=11))
    k_max, grid, spread = 32, None, False
    if case == "grid":
        grid = tuple(g for g in kernels.DEPTH_GRID if g <= k_max)
    elif case == "spread":
        spread = True
    elif case == "mpn1":
        args[8] = np.int32(1)
    elif case == "jitter":
        args[10], args[11] = np.float32(2.0), np.float32(1.5)
        grid = tuple(g for g in kernels.DEPTH_GRID if g <= k_max)
    elif case == "affinity":
        args[7] = np.random.default_rng(5).uniform(
            -0.5, 0.5, 1024).astype(np.float32)
    args = tuple(args)
    got = sharding.sharded_fill_depth(sharding.mesh(), k_max, spread,
                                      grid)(*args)
    ref = np.asarray(ref_sharding.sharded_fill_depth(
        ref_sharding.mesh(), k_max=k_max, spread_algorithm=spread,
        depth_grid=grid)(*args))
    solo = kernels.fill_depth(
        *(_t(a) for a in args[:3]), int(args[3]), _t(args[4]), _t(args[5]),
        int(args[6]), _t(args[7]), max_per_node=int(args[8]), k_max=k_max,
        spread_algorithm=spread, order_jitter=_t(args[9]),
        jitter_scale=float(args[10]), jitter_samples=float(args[11]),
        depth_grid=grid).numpy()
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.numpy().tobytes() == solo.tobytes()


def _fused_cols(seed: int, bucket: int, n_res: int):
    """One eval's columns over `bucket` rows read through a shuffled idx
    from twins of `n_res` rows (a quarter of the eval rows invalid)."""
    rng = np.random.default_rng(seed)
    cap = np.zeros((n_res, NUM_XR), np.float32)
    cap[:, 0] = rng.choice([2000, 4000, 8000], n_res)
    cap[:, 1] = rng.choice([4096, 8192, 16384], n_res)
    cap[:, 2:] = (100_000, 12_001, 1_000)
    used = np.zeros_like(cap)
    used[:, 0] = rng.choice([0, 500, 1500], n_res)
    used[:, 1] = rng.choice([0, 1024], n_res)
    n_live = bucket * 3 // 4
    idx = np.zeros(bucket, np.int32)
    idx[:n_live] = rng.permutation(n_res)[:n_live]
    valid = np.zeros(bucket, bool)
    valid[:n_live] = True
    feas = valid.copy()
    feas[::9] = False
    ask = np.zeros(NUM_XR, np.float32)
    ask[0], ask[1] = 250, 512
    coll = rng.integers(0, 2, bucket).astype(np.int32)
    aff = np.zeros(bucket, np.float32)
    jitter = rng.random(bucket, dtype=np.float32)
    return cap, used, idx, valid, ask, feas, coll, aff, jitter


@pytest.mark.parametrize("kernel,count", [("depth", 1), ("depth", 200),
                                          ("greedy", 1), ("greedy", 300)])
def test_sharded_fused_matches_the_reference_and_the_solo_program(
        kernel, count):
    """The fused program over sharded twins: each shard's gather entry
    over the rows of idx it owns (the rest masked), the verdict per
    shard; placed and fit equal the reference's sharded program and the
    port's solo program."""
    cap, used, idx, valid, ask, feas, coll, aff, jitter = _fused_cols(
        21 + count, 256, 512)
    m = sharding.mesh()
    twins = (sharding.put_node_sharded(cap, m),
             sharding.put_node_sharded(used, m))
    ref_twins = (ref_sharding.put_node_sharded(cap),
                 ref_sharding.put_node_sharded(used))
    cls = np.zeros(256, np.int32)
    if kernel == "depth":
        tail = (ask, np.int32(count), feas, coll, np.int32(count), aff,
                np.int32(2 ** 30), jitter, np.float32(1.0), np.float32(0.0),
                cls, np.bool_(False))
        ref_fn = ref_sharding.sharded_fused(ref_sharding.mesh(), "depth",
                                            k_max=32)
        fn = sharding.sharded_fused(m, "depth", k_max=32)
        solo = kernels.fused_eval_depth(
            _t(cap), _t(used), _t(idx), _t(valid), _t(ask), count, _t(feas),
            _t(coll), count, _t(aff), 2 ** 30, _t(jitter), 1.0, 0.0,
            _t(cls), False, k_max=32)
    else:
        tail = (ask, np.int32(count), feas, np.int32(2 ** 30), cls,
                np.bool_(False), coll)
        ref_fn = ref_sharding.sharded_fused(ref_sharding.mesh(), "greedy")
        fn = sharding.sharded_fused(m, "greedy")
        solo = kernels.fused_eval_greedy(
            _t(cap), _t(used), _t(idx), _t(valid), _t(ask), count, _t(feas),
            2 ** 30, _t(cls), False, _t(coll))
    placed, fit = fn(*twins, idx, valid, *tail)
    ref = ref_fn(*ref_twins, idx, valid, *tail)
    np.testing.assert_array_equal(placed.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(fit.numpy(), np.asarray(ref[1]))
    assert placed.numpy().tobytes() == solo[0].numpy().tobytes()
    assert fit.numpy().tobytes() == solo[1].numpy().tobytes()
    assert int(placed.sum()) == count


# --------------------------------------------- chained partitioned solves

def test_chained_solves_stay_partitioned_with_no_rescatter(low_floor):
    store, nodes, idx = _seed_store(24)
    n = len(nodes)
    bucket = buckets.node_bucket(n)
    rows = np.arange(n, dtype=np.int64)

    got = state_cache.gather(store.snapshot().usage, rows, bucket=bucket,
                             tier="sharded")
    assert got is not None and got.cap_dev is not None
    assert sharding.is_node_sharded(got.cap_dev)
    assert sharding.is_node_sharded(got.used_dev)
    assert sharding.is_node_sharded(state_cache.cache()._used_dev)

    name, fn = backend.select("depth", bucket, k_max=8)
    assert name == "sharded"
    args = _depth_args(bucket, 6, seed=3)
    placed1 = fn(got.cap_dev, got.used_dev, *args[2:])
    assert int(placed1.sum()) == 6

    misses0 = metrics.counter("nomad.solver.state_cache.misses")
    twin0 = state_cache.cache()._used_dev
    store.upsert_allocs(idx, [_mk_alloc(nodes[0].id),
                              _mk_alloc(nodes[5].id)])
    got2 = state_cache.gather(store.snapshot().usage, rows, bucket=bucket,
                              tier="sharded")
    assert sharding.is_node_sharded(got2.used_dev)
    assert metrics.counter("nomad.solver.state_cache.misses") == misses0, \
        "the advance reseeded instead of replaying the journal"
    twin1 = state_cache.cache()._used_dev
    # the advance touched shard 0 only (rows 0 and 5 of 3-row blocks:
    # blocks 0 and 1): every other block is the same tensor, no re-scatter
    touched = {0 // twin1.rows, 5 // twin1.rows}
    for s in range(SHARDS):
        same = twin1.blocks[s] is twin0.blocks[s]
        assert same == (s not in touched), s
    placed2 = fn(got2.cap_dev, got2.used_dev, *args[2:])
    assert int(placed2.sum()) == 6


def test_per_shard_twins_replay_journal_bit_identically(low_floor):
    """After a stream of commits the partitioned twin holds exactly the
    bits of a fresh view, and of the reference's partitioned twin fed
    the same stream: every touched row routed to its owning shard."""
    from nomad_tpu.state import StateStore as RefStore
    stores = {"port": StateStore(), "ref": RefStore()}
    for key, mod in (("port", port_structs), ("ref", ref_structs)):
        stores[key].set_scheduler_config(1, mod.SchedulerConfiguration(
            scheduler_algorithm="tpu-batch"))
        mk = port_mock if key == "port" else ref_mock
        for i in range(20):
            nd = mk.node()
            nd.id = f"node-{i:04d}"
            stores[key].upsert_node(2 + i, nd)
    n, idx = 20, 22
    bucket = buckets.node_bucket(n)
    rows = np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(9)
    state_cache.gather(stores["port"].snapshot().usage, rows, bucket=bucket)
    ref_state_cache.gather(stores["ref"].snapshot().usage, rows,
                           bucket=bucket)
    for step in range(6):
        picks = [(int(rng.integers(0, n)), int(rng.choice([50, 100, 250])))
                 for _ in range(int(rng.integers(1, 5)))]
        for key, mod in (("port", port_structs), ("ref", ref_structs)):
            allocs = [mod.Allocation(
                id=f"a-{step}-{j}", namespace="default", eval_id="e",
                name="j1.web[0]", job_id="j1", task_group="web",
                node_id=f"node-{r:04d}", node_name=f"node-{r:04d}",
                desired_status="run", client_status="pending",
                allocated_resources=mod.AllocatedResources(
                    shared=mod.AllocatedSharedResources(disk_mb=150),
                    tasks={"t": mod.AllocatedTaskResources(
                        cpu_shares=c, memory_mb=128)}))
                for j, (r, c) in enumerate(picks)]
            stores[key].upsert_allocs(idx, allocs)
        idx += 1
        view = stores["port"].snapshot().usage
        assert state_cache.gather(view, rows, bucket=bucket) is not None
        ref_state_cache.gather(stores["ref"].snapshot().usage, rows,
                               bucket=bucket)
        tc = state_cache.cache()
        assert sharding.is_node_sharded(tc._used_dev)
        dev_used = _twin_host(tc._used_dev)
        assert dev_used[:n].tobytes() == view.used.tobytes(), step
        assert not dev_used[n:].any(), "padding rows must stay zero"
        ref_used = np.asarray(ref_state_cache.cache()._used_dev)
        assert ref_used.tobytes() == dev_used.tobytes(), step


def test_concurrent_sharded_launches_do_not_wedge(low_floor):
    """Workers gathering from the sharded twins while a writer advances
    them at every commit: no wedge, no error, no half-old half-new twin
    (every gathered pair equals the host rows it was served with)."""
    store, nodes, idx = _seed_store(24)
    n = len(nodes)
    bucket = buckets.node_bucket(n)
    rows = np.arange(n, dtype=np.int64)
    state_cache.gather(store.snapshot().usage, rows, bucket=bucket,
                       tier="sharded")
    assert sharding.is_node_sharded(state_cache.cache()._used_dev)
    stop = threading.Event()
    errs: list = []

    def reader():
        try:
            while not stop.is_set():
                got = state_cache.gather(store.snapshot().usage, rows,
                                         bucket=bucket, tier="sharded")
                if got.used_dev is not None:
                    dev = _twin_host(got.used_dev)[:n]
                    if dev.tobytes() != got.used.tobytes():
                        errs.append("a gathered twin disagreed with its "
                                    "host rows")
        except Exception as e:      # noqa: BLE001 — surface to the test
            errs.append(e)

    threads = [threading.Thread(target=reader, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    for step in range(40):
        store.upsert_allocs(idx, [_mk_alloc(nodes[step % n].id)])
        state_cache.note_commit(store)
        idx += 1
    time.sleep(0.2)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs[:3]


# ------------------------------------------------------- faults + breaker

def test_sharded_fault_raises_where_the_reference_demotes(low_floor):
    """A fault on the sharded rung: the reference demotes to its xla tier
    with the same bits; the port raises out of the solve, counts it and
    feeds the breaker (card work never moves down a ladder), and the
    next clean pass equals the reference's demoted result."""
    args = _depth_args(512, 40, seed=5)
    name, fn = backend.select("depth", 512, k_max=16)
    assert name == "sharded"
    ref_name, ref_fn = ref_backend.select("depth", 512, k_max=16)
    assert ref_name == "sharded"
    ref_faults.install({"solver.dispatch.sharded": {"mode": "raise",
                                                    "times": 1}})
    ref_got = np.asarray(ref_fn(*args))
    e0 = metrics.counter("nomad.solver.dispatch_errors.sharded")
    port_faults.install({"solver.dispatch.sharded": {"mode": "raise",
                                                     "times": 1}})
    with pytest.raises(port_faults.FaultError):
        fn(*args)
    assert metrics.counter("nomad.solver.dispatch_errors.sharded") == e0 + 1
    port_faults.clear()
    got = fn(*args).numpy()
    np.testing.assert_array_equal(got, ref_got)
    assert got.sum() == 40


def test_breaker_opens_sharded_tier_after_repeated_faults(low_floor):
    """The breaker opens after BREAKER_THRESHOLD faults, as the
    reference's; the port's only observes, so the open tier is still
    dispatched to and a success closes it."""
    args = _depth_args(256, 10, seed=6)
    _, fn = backend.select("depth", 256, k_max=8)
    port_faults.install({"solver.dispatch.sharded": {
        "mode": "raise", "times": backend.BREAKER_THRESHOLD}})
    for _ in range(backend.BREAKER_THRESHOLD):
        with pytest.raises(port_faults.FaultError):
            fn(*args)
    assert backend.breaker().state("sharded") == "open"
    assert int(fn(*args).sum()) == 10
    assert backend.breaker().state("sharded") == "closed"


# ------------------------------------------------- cross-shard reduces

@pytest.mark.parametrize("k", [1, 16, 64])
def test_cross_shard_top_k_matches_the_reference(k):
    rng = np.random.default_rng(11 + k)
    score = rng.permutation(256).astype(np.float32)
    v, i = sharding.cross_shard_top_k(sharding.mesh(), k)(score)
    rv, ri = ref_sharding.cross_shard_top_k(ref_sharding.mesh(), k)(score)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    order = np.argsort(-score, kind="stable")[:k]
    np.testing.assert_array_equal(i.numpy(), order)


def test_cross_shard_top_k_ties_go_to_the_lower_index():
    score = np.repeat(np.arange(16, dtype=np.float32), 16)[::-1].copy()
    v, i = sharding.cross_shard_top_k(sharding.mesh(), 24)(score)
    np.testing.assert_array_equal(i.numpy(), np.arange(24))
    rv, ri = ref_sharding.cross_shard_top_k(ref_sharding.mesh(), 24)(score)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_sharded_spread_counts_matches_the_reference():
    rng = np.random.default_rng(12)
    n, p = 64, 8
    ids = rng.integers(-1, p, size=(3, n)).astype(np.int32)
    add = rng.integers(0, 4, size=n).astype(np.int32)
    got = sharding.sharded_spread_counts(sharding.mesh(), p)(ids, add)
    ref = np.asarray(ref_sharding.sharded_spread_counts(
        ref_sharding.mesh(), p)(ids, add))
    np.testing.assert_array_equal(got.numpy(), ref)


def _preempt_inputs(c, v, seed):
    rng = np.random.default_rng(seed)
    vr = rng.uniform(10, 300, size=(c, v, NUM_XR)).astype(np.float32)
    vp = rng.integers(10, 60, size=(c, v)).astype(np.int32)
    ask = np.zeros(NUM_XR, np.float32)
    ask[0], ask[1] = 400, 512
    free = rng.uniform(0, 200, size=(c, NUM_XR)).astype(np.float32)
    return vr, vp, ask, free


@pytest.mark.parametrize("c", [24, 29])
def test_sharded_preemption_masks_match_solo_and_the_reference(
        monkeypatch, c):
    """The candidate axis sharded (29 pads to 32 with ineligible
    candidates): masks equal the reference's solo masks and the port's
    solo scan bit for bit; a fault on the sharded rung raises."""
    monkeypatch.setattr(port_placer, "PREEMPT_SHARD_MIN", 1)
    vr, vp, ask, free = _preempt_inputs(c, 4, 13)
    want = np.asarray(ref_placer._preempt_batched()(vr, vp, ask, free,
                                                    np.int32(70)))
    sh0 = metrics.counter("nomad.solver.dispatch.sharded")
    got = port_placer.SolverPlacer._preempt_masks(vr, vp, ask, free,
                                                  np.int32(70))
    assert metrics.counter("nomad.solver.dispatch.sharded") == sh0 + 1
    np.testing.assert_array_equal(got, want)
    solo = kernels.preempt_top_k(_t(vr), _t(vp), _t(ask), _t(free),
                                 70).numpy()
    assert got.tobytes() == solo.tobytes()
    port_faults.install({"solver.dispatch.sharded": {"mode": "raise",
                                                     "times": 1}})
    with pytest.raises(port_faults.FaultError):
        port_placer.SolverPlacer._preempt_masks(vr, vp, ask, free,
                                                np.int32(70))


def test_forced_solo_backend_quarantines_sharded_preemption(monkeypatch):
    monkeypatch.setattr(port_placer, "PREEMPT_SHARD_MIN", 1)
    monkeypatch.setenv("NOMAD_SOLVER_BACKEND", "torch")
    vr, vp, ask, free = _preempt_inputs(16, 3, 14)
    sh0 = metrics.counter("nomad.solver.dispatch.sharded")
    got = port_placer.SolverPlacer._preempt_masks(vr, vp, ask, free,
                                                  np.int32(70))
    assert metrics.counter("nomad.solver.dispatch.sharded") == sh0, \
        "a forced solo backend still launched a sharded preemption scan"
    want = np.asarray(ref_placer._preempt_batched()(vr, vp, ask, free,
                                                    np.int32(70)))
    np.testing.assert_array_equal(got, want)


def test_preemption_below_the_candidate_floor_stays_solo():
    vr, vp, ask, free = _preempt_inputs(16, 3, 15)
    assert port_placer.PREEMPT_SHARD_MIN == ref_placer.PREEMPT_SHARD_MIN
    sh0 = metrics.counter("nomad.solver.dispatch.sharded")
    port_placer.SolverPlacer._preempt_masks(vr, vp, ask, free, np.int32(70))
    assert metrics.counter("nomad.solver.dispatch.sharded") == sh0


# ------------------------------------------------- solo routes on a mesh

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


def test_windows_run_solo_on_the_first_shard(monkeypatch):
    """A window whose lane count does not divide over the shards (3 lanes
    on 8: the reference's `lane_sharding` returns None) is one lane
    launch on the mesh's first device and fires only the first shard's
    device-loss site; its lanes equal their solo solves. Windows whose
    lanes divide split over the shards:
    tests/test_torch_mesh_windows.py."""
    monkeypatch.setattr(backend, "BATCH_MAX_COUNT", 2048)
    microbatch.configure(enabled=True, window_s=0.05)
    lanes = [_depth_args(64, c, seed=8 + c) for c in (20, 30, 40)]
    _, solo = backend.select("depth", 64, k_max=64)
    want = [solo(*a).numpy() for a in lanes]

    def solve(*a):
        name, fn = backend.select("depth", 64, count=int(a[3]), k_max=64)
        assert name == "batch"
        return fn(*a).numpy()

    port_faults.install({"device.lost.d1": {"mode": "raise"},
                         "device.lost.d0": {"mode": "delay",
                                            "delay_ms": 0.0}})
    d0 = metrics.counter("nomad.solver.microbatch.dispatches")
    try:
        out = _concurrently(solve, lanes)
        assert port_faults.fired("device.lost.d1") == 0
        assert port_faults.fired("device.lost.d0") >= 1
    finally:
        port_faults.clear()
    assert metrics.counter("nomad.solver.microbatch.dispatches") > d0
    for got, w in zip(out, want):
        np.testing.assert_array_equal(got, w)


def test_stream_small_solves_ride_batch_tier_on_mesh(monkeypatch):
    """On the mesh a small concurrent depth solve still takes the batch
    tier (the reference checks it before the sharded tier); a solo eval
    takes the solo tier below the floor and the sharded tier above it."""
    monkeypatch.setattr(backend, "BATCH_MAX_COUNT", 2048)
    microbatch.configure(enabled=True, window_s=0.0)
    microbatch.broker_in_flight(4)
    try:
        assert backend.select("depth", 65536, count=1000)[0] == "batch"
    finally:
        microbatch.broker_in_flight(0)
    assert backend.select("depth", 16384, count=1000)[0] == "torch"
    assert backend.select("depth", 65536, count=1000)[0] == "sharded"


def test_scan_and_convex_stay_solo_on_the_mesh(low_floor):
    """The scan and the convex solve stay solo on the mesh only where the
    mesh does not take the bucket (it does not divide over the shards):
    at a bucket it takes both select the sharded tier, as the
    reference's sharded_place_chunked and sharded_convex do (their
    parity: tests/test_torch_sharded_scan.py and
    tests/test_torch_sharded_convex.py)."""
    assert backend.select("chunked", 512)[0] == "sharded"
    assert backend.select_convex("greedy", 512)[0] == "sharded"
    assert backend.select("chunked", 500)[0] == "torch"
    assert backend.select_convex("greedy", 500)[0] == "torch"
    # sharded twins feed the sharded tier alone, solo twins a solo one
    assert backend.select_convex("greedy", 512, twins_device="cpu") is None
    assert backend.select_convex("greedy", 500, twins_device="cpu",
                                 sharded_twins=True) is None


# ---------------------------------------------------- the slice, whole

def _fleet(side, h, n_nodes, rng):
    for i in range(n_nodes):
        nd = side.mock.node()
        nd.id = f"node-{i:04d}"
        nd.name = f"sh-{i}"
        nd.node_resources.cpu.cpu_shares = int(rng.choice([4000, 8000]))
        nd.node_resources.memory.memory_mb = int(rng.choice([8192, 16384]))
        nd.compute_class()
        h.state.upsert_node(h.get_next_index(), nd)


def _eval(side, count, fused, seed=1234, n_nodes=40):
    with seeded_urandom(seed):
        random.seed(seed)
        h = side.Harness()
        h.state.set_scheduler_config(
            h.get_next_index(), side.structs.SchedulerConfiguration(
                scheduler_algorithm="tpu-batch",
                solver_fused_enabled=fused))
        _fleet(side, h, n_nodes, np.random.default_rng(seed))
        job = side.mock.batch_job()
        job.id = job.name = f"sh-job-{count}"
        tg = job.task_groups[0]
        tg.count = count
        tg.networks = []
        t = tg.tasks[0]
        t.resources.networks = []
        t.resources.cpu = 250
        t.resources.memory_mb = 128
        h.state.upsert_job(h.get_next_index(), job)
        ev = side.structs.Evaluation(id=f"sh-ev-{count}", job_id=job.id,
                                     type=job.type)
        h.process(lambda s, p: side.new_scheduler(job.type, s, p), ev)
    allocs = h.state.allocs_by_job("default", job.id)
    assert len(allocs) == count
    return {a.name: a.node_id for a in allocs}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("count", [1, 6, 120])
def test_scheduler_eval_on_the_sharded_tier_matches_the_reference(
        low_floor, count, fused):
    """A GenericScheduler eval at a bucket the mesh takes, on both
    packages' sharded tiers (the fused route over sharded twins, or the
    classic route): alloc for alloc the reference's placements, and the
    port's own solo placements."""
    d0 = metrics.counter("nomad.solver.dispatch.sharded")
    f0 = metrics.counter("nomad.solver.dispatch.fused.sharded")
    r0 = ref_metrics.counter("nomad.solver.dispatch.sharded") + \
        ref_metrics.counter("nomad.solver.dispatch.fused.sharded")
    got = _eval(PORT, count, fused)
    ref = _eval(REF, count, fused)
    assert got == ref
    assert ref_metrics.counter("nomad.solver.dispatch.sharded") + \
        ref_metrics.counter("nomad.solver.dispatch.fused.sharded") > r0
    if fused:
        assert metrics.counter("nomad.solver.dispatch.fused.sharded") > f0
    else:
        assert metrics.counter("nomad.solver.dispatch.sharded") > d0
    # the port's solo solve of the same eval
    state_cache.reset()
    device.use_devices(["cpu"])
    sharding.reset()
    backend.reset()
    assert _eval(PORT, count, fused) == got
