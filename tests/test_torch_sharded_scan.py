"""The port's sharded chunked scan (sharding.sharded_place_chunked over
cuda_kernels.chunked_shard; on the CPU its plain version,
kernels.chunked_shard_ref) against the reference's sharded_place_chunked
on its 8 JAX CPU devices and against the port's solo scan: all four
outputs (placements, usage, spread counts, distinct quotas) bit for bit.

The port runs on 2, 4, 8 and 3 virtual CPU shards (three: the bucket
re-padded to a multiple of 3 with infeasible rows, which no step can
pick); the reference on its 8 devices. Fixtures: testing.chunked_case's
spread stanzas (even and targeted), distinct_property, a deep ask, and the
scan kernel's edges: take 1 a step (rack_capped), exact score ties
across shards (bench_ties), a scan that stops early (done_mid_scan,
nothing_feasible) and a quota driven below 0 within a step. Then a
GenericScheduler service eval with spread, at a bucket the mesh takes,
alloc for alloc against the reference.
"""
import functools
import random

import numpy as np
import pytest
import torch

import nomad_tpu.mock as ref_mock
import nomad_tpu.structs as ref_structs
from nomad_tpu.metrics import metrics as ref_metrics
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.scheduler import new_scheduler as ref_new_scheduler
from nomad_tpu.solver import backend as ref_backend
from nomad_tpu.solver import buckets as ref_buckets
from nomad_tpu.solver import sharding as ref_sharding
from nomad_tpu.solver import state_cache as ref_state_cache

import nomad_tpu_torch.faults as port_faults
import nomad_tpu_torch.mock as port_mock
import nomad_tpu_torch.structs as port_structs
from nomad_tpu_torch.metrics import metrics
from nomad_tpu_torch.scheduler import Harness as PortHarness
from nomad_tpu_torch.scheduler import new_scheduler as port_new_scheduler
from nomad_tpu_torch.solver import backend, device, kernels, microbatch
from nomad_tpu_torch.solver import sharding, state_cache
from nomad_tpu_torch.testing import chunked_case, seeded_urandom

CASES = ("even_spread", "targeted_fractional", "distinct_mpn1",
         "bucket1024", "rack_capped", "bench_ties", "done_mid_scan",
         "nothing_feasible", "quota_below_zero")
SHARD_COUNTS = (2, 4, 8, 3)
# the scan's inputs by position: the node-axis ones pad with rows no step
# can pick (infeasible, no value ids)
NODE_ROWS, NODE_COLS = (0, 1, 4, 5, 12), (7, 13)


def _reset():
    port_faults.clear()
    sharding.reset()
    backend.reset()
    state_cache.reset()
    microbatch.reset()
    ref_sharding.reset()
    ref_buckets._reset_shards()
    ref_backend.reset()
    ref_state_cache.reset()


@pytest.fixture(autouse=True)
def _cpu():
    prev_dev = device.use_device("cpu")
    prev_devs = device.use_devices(None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _reset()
    yield
    device.use_devices(prev_devs)
    device.use_device(prev_dev)
    _reset()
    torch.set_num_threads(threads)


def _shards(n: int):
    device.use_devices(["cpu"] * n)
    sharding.reset()
    backend.reset()
    return sharding.mesh()


def _case(name):
    """testing.chunked_case, plus a distinct_property quota of 2 a value
    that a 25-wide step drives below 0 ("quota_below_zero")."""
    if name != "quota_below_zero":
        return chunked_case(name)
    args, kw = chunked_case("even_spread")
    args = list(args)
    n = args[0].shape[0]
    args[3] = np.int32(100)
    args[13] = (np.arange(n) % 4).astype(np.int32)[None]
    args[14] = np.full((1, 4), 2, np.int32)
    kw = dict(max_steps=4)
    return tuple(args), kw


def _pad(args, rows: int):
    """The scan's args with `rows` more node rows that take nothing."""
    out = list(args)
    for i in NODE_ROWS:
        a = np.asarray(out[i])
        out[i] = np.concatenate([a, np.zeros((rows,) + a.shape[1:],
                                             a.dtype)])
    for i in NODE_COLS:
        a = np.asarray(out[i])
        out[i] = np.concatenate(
            [a, np.full((a.shape[0], rows), -1, a.dtype)], axis=1)
    return tuple(out)


def _host(x) -> np.ndarray:
    return sharding.to_host(x) if isinstance(x, sharding.NodeSharded) \
        else x.numpy()


@functools.lru_cache(maxsize=None)
def _ref(name):
    args, kw = _case(name)
    fn = ref_sharding.sharded_place_chunked(
        ref_sharding.mesh(), max_steps=kw.get("max_steps", 256),
        spread_algorithm=kw.get("spread_algorithm", False))
    n = args[0].shape[0]
    out = fn(*args, np.zeros(n, np.int32),
             np.int32(kw.get("max_per_node", 2 ** 30)))
    return tuple(np.asarray(o) for o in out)


def _solo(args, kw):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         if isinstance(a, np.ndarray) else a for a in args]
    out = kernels.place_chunked(*t, **kw)
    return tuple(o.numpy() for o in out)


@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("name", CASES)
def test_sharded_scan_matches_the_reference_and_the_solo_scan(name, shards):
    args, kw = _case(name)
    n = args[0].shape[0]
    pad = (-n) % shards
    if pad:
        args = _pad(args, pad)
    m = _shards(shards)
    assert m.size == shards
    fn = sharding.sharded_place_chunked(
        m, max_steps=kw.get("max_steps", 256),
        spread_algorithm=kw.get("spread_algorithm", False))
    placed, used, sp, dr = fn(*args, None,
                              np.int32(kw.get("max_per_node", 2 ** 30)))
    assert sharding.is_node_sharded(placed, m)
    assert sharding.is_node_sharded(used, m)
    got = (_host(placed)[:n], _host(used)[:n], sp.numpy(), dr.numpy())
    want = _ref(name)
    solo = _solo(args, kw)
    for i, (g, w, s) in enumerate(zip(got, want, solo)):
        np.testing.assert_array_equal(g, w)
        assert g.tobytes() == (s[:n] if i < 2 else s).tobytes()
    assert int(got[0].sum()) == int(want[0].sum())


def test_every_shard_keeps_the_same_tables_and_stops_with_the_solo_scan():
    """Each shard's copy of the spread counts and distinct quotas ends
    equal, and the steps run equal the solo kernel's stopping rule."""
    args, kw = _case("distinct_mpn1")
    m = _shards(4)
    rows = args[0].shape[0] // 4
    t = [torch.from_numpy(np.ascontiguousarray(a))
         if isinstance(a, np.ndarray) else a for a in args]

    def blk(x):
        return [x[s * rows:(s + 1) * rows] for s in range(4)]

    def col(x):
        return [x[:, s * rows:(s + 1) * rows].contiguous() for s in range(4)]

    out = kernels.chunked_shard_ref(
        blk(t[0]), blk(t[1]), [t[2]] * 4, t[3], blk(t[4]), blk(t[5]), t[6],
        col(t[7]), [t[8]] * 4, [t[9]] * 4, [t[10]] * 4, [t[11]] * 4,
        blk(t[12]), col(t[13]), [t[14]] * 4,
        blk(torch.zeros(rows * 4, dtype=torch.int32)), **kw)
    assert m.size == 4
    for tab in (out[2], out[3]):
        assert all(torch.equal(x, tab[0]) for x in tab)
    solo = kernels.place_chunked(*t, **kw)
    np.testing.assert_array_equal(torch.cat(out[0]).numpy(),
                                  solo[0].numpy())
    # 90 instances, 3 a step, quotas run out: the scan stops at the first
    # step that selects nothing, as the kernels do
    assert 0 < out[4] < kw["max_steps"]


def test_the_plain_wrapper_reports_the_steps_in_its_state():
    """cuda_kernels.chunked_shard on CPU tensors runs the plain version
    and returns the per-shard state with the steps in column 2."""
    from nomad_tpu_torch.solver import cuda_kernels
    args, kw = _case("even_spread")
    t = [torch.from_numpy(np.ascontiguousarray(a))
         if isinstance(a, np.ndarray) else a for a in args]
    r = t[0].shape[0] // 2

    def blk(x):
        return [x[:r], x[r:]]

    def col(x):
        return [x[:, :r].contiguous(), x[:, r:].contiguous()]

    out = cuda_kernels.chunked_shard(
        blk(t[0]), blk(t[1]), [t[2]] * 2, t[3], blk(t[4]), blk(t[5]), t[6],
        col(t[7]), [t[8]] * 2, [t[9]] * 2, [t[10]] * 2, [t[11]] * 2,
        blk(t[12]), col(t[13]), [t[14]] * 2,
        blk(torch.zeros(2 * r, dtype=torch.int32)), **kw)
    assert out[4].shape == (2, 8) and int(out[4][0, 2]) == 60
    assert cuda_kernels.LAUNCHES["chunked_shard"] == 0


# ---------------------------------------------------- the slice, whole

def _spread_eval(side, count, seed=77, n_nodes=48):
    """A service job with a datacenter spread over a 3-datacenter fleet,
    through the side's GenericScheduler; every id from a seeded byte
    stream. -> alloc name -> node id."""
    with seeded_urandom(seed):
        random.seed(seed)
        rng = np.random.default_rng(seed)
        h = side.Harness()
        h.state.set_scheduler_config(
            h.get_next_index(), side.structs.SchedulerConfiguration(
                scheduler_algorithm="tpu-batch",
                solver_fused_enabled=False))
        for i in range(n_nodes):
            nd = side.mock.node()
            nd.id = f"node-{i:04d}"
            nd.name = f"sc-{i}"
            nd.datacenter = f"dc{1 + i % 3}"
            nd.node_resources.cpu.cpu_shares = int(rng.choice([4000, 8000]))
            nd.node_resources.memory.memory_mb = int(
                rng.choice([8192, 16384]))
            nd.compute_class()
            h.state.upsert_node(h.get_next_index(), nd)
        job = side.mock.job()
        job.id = job.name = "sc-web"
        job.datacenters = ["dc1", "dc2", "dc3"]
        job.spreads = [side.structs.Spread(
            attribute="${node.datacenter}", weight=70, spread_target=[
                side.structs.SpreadTarget(value="dc1", percent=50),
                side.structs.SpreadTarget(value="dc2", percent=30),
                side.structs.SpreadTarget(value="dc3", percent=20)])]
        tg = job.task_groups[0]
        tg.count = count
        tg.networks = []
        t = tg.tasks[0]
        t.resources.networks = []
        t.resources.cpu = 250
        t.resources.memory_mb = 128
        h.state.upsert_job(h.get_next_index(), job)
        ev = side.structs.Evaluation(id="sc-ev", job_id=job.id,
                                     type=job.type)
        h.process(lambda s, p: side.new_scheduler(job.type, s, p), ev)
    allocs = h.state.allocs_by_job("default", job.id)
    assert len(allocs) == count
    return {a.name: a.node_id for a in allocs}


def test_service_eval_with_spread_on_the_sharded_scan_matches_the_reference(
        monkeypatch):
    """A GenericScheduler service eval with a targeted datacenter spread at
    a bucket the mesh takes: the port's sharded scan and the reference's
    place alloc for alloc alike, and like the port's solo scan."""
    class Side:
        pass
    ref, port = Side(), Side()
    ref.mock, ref.structs, ref.Harness = ref_mock, ref_structs, RefHarness
    ref.new_scheduler = ref_new_scheduler
    port.mock, port.structs, port.Harness = (port_mock, port_structs,
                                             PortHarness)
    port.new_scheduler = port_new_scheduler
    solo = _spread_eval(port, 40)
    _shards(8)
    monkeypatch.setattr(backend, "SHARD_MIN_NODES", 8)
    monkeypatch.setattr(ref_backend, "SHARD_MIN_NODES", 8)
    d0 = metrics.counter("nomad.solver.kernel.chunked.sharded")
    r0 = ref_metrics.counter("nomad.solver.kernel.chunked.sharded")
    got = _spread_eval(port, 40)
    want = _spread_eval(ref, 40)
    assert metrics.counter("nomad.solver.kernel.chunked.sharded") > d0
    assert ref_metrics.counter("nomad.solver.kernel.chunked.sharded") > r0
    assert got == want
    assert got == solo
