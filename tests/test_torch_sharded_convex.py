"""The port's sharded convex solve (sharding.sharded_convex over
cuda_kernels.convex_eval_sharded_fused; on the CPU its plain version,
convex.convex_eval_sharded with convex_solve_sharded_ref) against the
reference's sharded_convex on its 8 JAX CPU devices and against the
port's solo convex eval.

The sharded solve sums in its own order (convex.sharded_tree_sum: each
shard's block in the solo kernel's tree, then the shard partials), as the
reference's sharded solve sums in GSPMD's: the placements, the verdict
and the won flag equal the reference's and the solo solve's; the
iteration count equals the reference's at the fixtures' 1e-4 tolerance
(below float32 noise, 1e-9, it may not); the final iterate lies within
1e-4 of the solo solve's. Then the counterpart of the reference's
test_sharded_convex_parity_with_solo: a convex eval through the
scheduler, forced onto the sharded tier, places as the solo tier and as
the reference's sharded tier.
"""
import random

import jax
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
from nomad_tpu_torch.solver import backend, convex, device, microbatch
from nomad_tpu_torch.solver import sharding, state_cache
from nomad_tpu_torch.testing import convex_fixture, seeded_urandom

CASES = ("fuzz_quota", "fuzz_distinct", "fuzz_affinity", "fuzz_zero",
         "fuzz_above_cap", "homogeneous", "fuzz_full", "small_spread_deep")
SHARD_COUNTS = (2, 4, 8, 3)


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
def _cpu(monkeypatch):
    monkeypatch.delenv("NOMAD_SOLVER_CONVEX", raising=False)
    monkeypatch.delenv("NOMAD_SOLVER_BACKEND", raising=False)
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


def _args(name, pad: int = 0) -> tuple:
    """convex_eval's positional args for fixture `name`, the bucket padded
    by `pad` rows no solve can use (infeasible, invalid, zero capacity)."""
    cap, used, feas, coll, ask, count, kw = convex_fixture(name)
    b = cap.shape[0]
    aff = kw["affinity_boost"]
    aff = np.zeros(b, np.float32) if aff is None else aff

    def p(a, v=0):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], v, a.dtype)])
    valid = np.ones(b, bool)
    args = (p(cap), p(used), np.arange(b + pad, dtype=np.int32), p(valid),
            ask, np.int32(count), p(feas), np.int32(kw["max_per_node"]),
            p(aff), p(coll), np.zeros(b + pad, np.int32), np.bool_(False),
            np.int32(kw["max_iters"]), np.float32(kw["tolerance"]),
            np.float32(kw["fairness_weight"]),
            np.float32(kw["quota_budget"]))
    return args, kw["spread_algorithm"], kw["tolerance"]


_REF: dict = {}


def _ref(name):
    if name not in _REF:
        args, spread, _ = _args(name)
        fn = ref_sharding.sharded_convex(ref_sharding.mesh(),
                                         spread_algorithm=spread)
        _REF[name] = jax.device_get(fn(*args))
    return _REF[name]


def _solo(args, spread):
    t = [torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
         else a for a in args]
    return convex.to_host(convex.convex_eval(*t, spread_algorithm=spread))


@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("name", CASES)
def test_sharded_convex_matches_the_reference_and_the_solo_solve(name,
                                                                  shards):
    _, spread, tol = _args(name)
    b = _args(name)[0][0].shape[0]
    args, _, _ = _args(name, pad=(-b) % shards)
    m = _shards(shards)
    twins = tuple(sharding.put_node_sharded(a, m) for a in args[:2])
    placed, fit, iters, gap, won = sharding.sharded_convex(
        m, spread_algorithm=spread)(*twins, *args[2:])
    assert sharding.is_node_sharded(placed, m)
    assert sharding.is_node_sharded(fit, m)
    got = convex.to_host((sharding.at_lead(placed), sharding.at_lead(fit),
                          iters, gap, won))
    want = _ref(name)
    solo = _solo(_args(name)[0], spread)
    np.testing.assert_array_equal(got[0][:b], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][:b], np.asarray(want[1]))
    assert got[4] == bool(want[4])
    if tol >= 1e-4:
        assert got[2] == int(want[2])
    np.testing.assert_array_equal(got[0][:b], solo[0])
    np.testing.assert_array_equal(got[1][:b], solo[1])
    assert got[4] == solo[4]
    assert not got[0][b:].any()


@pytest.mark.parametrize("shards", (2, 4, 8))
@pytest.mark.parametrize("name", ("fuzz_quota", "fuzz_affinity",
                                  "homogeneous", "small_spread_deep"))
def test_sharded_iterate_lies_near_the_solo_iterate(name, shards):
    """The plain sharded solve's final iterate within 1e-4 of the solo
    solve's, and its integral budget equal."""
    cap, used, feas, coll, ask, count, kw = convex_fixture(name)
    b = cap.shape[0]
    r = b // shards
    aff = kw["affinity_boost"]
    aff = np.zeros(b, np.float32) if aff is None else aff
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (cap, used, feas, coll, aff)]
    ask_t = torch.from_numpy(ask)
    tail = (count, kw["max_per_node"], kw["max_iters"], kw["tolerance"],
            kw["fairness_weight"], kw["quota_budget"])
    solo = convex.convex_solve_ref(t[0], t[1], ask_t, t[2], t[3], t[4],
                                   *tail,
                                   spread_algorithm=kw["spread_algorithm"])

    def blk(x):
        return [x[s * r:(s + 1) * r] for s in range(shards)]
    got = convex.convex_solve_sharded_ref(
        blk(t[0]), blk(t[1]), [ask_t] * shards, blk(t[2]), blk(t[3]),
        blk(t[4]), *tail, spread_algorithm=kw["spread_algorithm"])
    np.testing.assert_allclose(torch.cat(got[0]).numpy(), solo[0].numpy(),
                               atol=1e-4, rtol=0)
    assert torch.equal(torch.cat(got[1]), solo[1])
    assert torch.equal(torch.cat(got[2]), solo[2])
    assert int(got[3]) == int(solo[3])


def _define(v: np.ndarray, shards: int) -> np.ndarray:
    """sharded_tree_sum by its definition, in numpy float32: each block's
    tree_sum, then the partials pairwise by halving (S a power of two) or
    left to right."""
    parts = [convex.tree_sum(torch.from_numpy(b)).numpy()
             for b in np.split(v, shards, axis=-1)]
    if shards & (shards - 1) == 0:
        while len(parts) > 1:
            h = len(parts) // 2
            parts = [np.float32(parts[i] + parts[i + h]) for i in range(h)]
        return parts[0]
    acc = parts[0]
    for p in parts[1:]:
        acc = np.float32(acc + p)
    return acc


@pytest.mark.parametrize("shards", (1, 2, 3, 4, 8))
def test_sharded_tree_sum_is_its_definition(shards):
    rng = np.random.default_rng(5 + shards)
    v = (rng.standard_normal((3, 24 * 8192 // 8)) * 1e3).astype(np.float32)
    got = convex.sharded_tree_sum(torch.from_numpy(v), shards).numpy()
    want = _define(v, shards)
    assert got.tobytes() == want.tobytes()
    if shards == 1:
        assert got.tobytes() == convex.tree_sum(
            torch.from_numpy(v)).numpy().tobytes()
    # the blocks' form (as the solve sums them) is the same order
    blocks = list(torch.from_numpy(v).chunk(shards, dim=-1))
    assert convex._block_sum(blocks, "cpu").numpy().tobytes() == \
        got.tobytes()


def test_sharded_tree_sum_orders_differ_from_the_solo_tree():
    """The sharded order is its own: on these rows its sum and the solo
    tree's differ in their last bits (why the tests hold the placements,
    not the iterates' bits, to the solo solve)."""
    rng = np.random.default_rng(9)
    v = torch.from_numpy(rng.uniform(0, 1e4, 3 * 8192 + 8).astype(
        np.float32))
    assert not torch.equal(convex.sharded_tree_sum(v, 8),
                           convex.tree_sum(v))


# ---------------------------------------------------- the slice, whole

class _Side:
    def __init__(self, mock, structs, harness, new_scheduler):
        self.mock, self.structs = mock, structs
        self.Harness, self.new_scheduler = harness, new_scheduler


REF = _Side(ref_mock, ref_structs, RefHarness, ref_new_scheduler)
PORT = _Side(port_mock, port_structs, PortHarness, port_new_scheduler)


def _convex_eval(side, count, seed=48, n_nodes=40):
    """One convex eval through the side's scheduler over a heterogeneous
    fleet; every id from a seeded byte stream. -> alloc name -> node."""
    with seeded_urandom(seed):
        random.seed(seed)
        rng = np.random.default_rng(seed)
        h = side.Harness()
        h.state.set_scheduler_config(
            h.get_next_index(), side.structs.SchedulerConfiguration(
                scheduler_algorithm="convex"))
        for i in range(n_nodes):
            nd = side.mock.node()
            nd.id = f"cx-node-{i:04d}"
            nd.node_resources.cpu.cpu_shares = int(
                rng.choice([4000, 8000, 16000]))
            nd.node_resources.memory.memory_mb = int(
                rng.choice([8192, 16384, 65536]))
            nd.compute_class()
            h.state.upsert_node(h.get_next_index(), nd)
        job = side.mock.batch_job()
        job.id = job.name = "cx-shard-job"
        tg = job.task_groups[0]
        tg.count = count
        tg.networks = []
        t = tg.tasks[0]
        t.resources.networks = []
        t.resources.cpu = 250
        t.resources.memory_mb = 128
        h.state.upsert_job(h.get_next_index(), job)
        ev = side.structs.Evaluation(id="cx-shard-eval", job_id=job.id,
                                     type=job.type)
        h.process(lambda s, p: side.new_scheduler(job.type, s, p), ev)
    return {a.name: a.node_id
            for a in h.state.allocs_by_job("default", job.id)}


def test_sharded_convex_parity_with_solo(monkeypatch):
    """Counterpart of the reference's test of the same name: forced onto
    the sharded tier, the convex eval consumes the partitioned twins in
    place and places as the solo convex eval, and as the reference's
    forced-sharded eval."""
    solo = _convex_eval(PORT, 48)
    _shards(8)
    state_cache.reset()
    monkeypatch.setenv("NOMAD_SOLVER_BACKEND", "sharded")
    c0 = metrics.counter("nomad.solver.dispatch.convex.sharded")
    r0 = ref_metrics.counter("nomad.solver.dispatch.convex.sharded")
    shard = _convex_eval(PORT, 48)
    assert metrics.counter("nomad.solver.dispatch.convex.sharded") > c0, \
        "the sharded convex route never engaged"
    assert state_cache.cache().stats()["twins_sharded"]
    want = _convex_eval(REF, 48)
    assert ref_metrics.counter("nomad.solver.dispatch.convex.sharded") > r0
    assert len(shard) == 48
    assert shard == solo
    assert shard == want
