"""The port's CUDA kernels against their plain PyTorch versions, on a card.

The kernels have no CPU mode, so every test here is marked `cuda` and
skips where torch.cuda.is_available() is false. The file imports neither
jax nor the JAX package, so it also runs on a machine with a card and no
JAX (tests/conftest.py pins JAX, hence --noconftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

chip_smoke.py runs the same comparisons at the main path's full size.
"""
import numpy as np
import pytest
import torch

from nomad_tpu_torch.solver import convex, cuda_kernels, kernels
from nomad_tpu_torch.testing import (
    CONVEX_CASES, SCAN_CASES, chunked_case, convex_fixture, split_solves,
)

NUM_XR = 5
ATOL = 1e-4
GRID128 = tuple(g for g in kernels.DEPTH_GRID if g <= 128)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _inputs(dev, n=3_000, seed=3):
    """A ragged node axis (not a multiple of any block size)."""
    rng = np.random.default_rng(seed)
    cap = np.zeros((n, NUM_XR), np.float32)
    cap[:, 0] = rng.choice([4_000, 8_000, 16_000, 32_000], n)
    cap[:, 1] = rng.choice([8_192, 16_384, 32_768, 65_536], n)
    cap[:, 2] = 500_000
    cap[:, 3] = 12_001
    cap[:, 4] = 1_000
    used = np.zeros_like(cap)
    used[:, 0] = np.floor(cap[:, 0] * rng.random(n) * 0.7)
    used[:, 1] = np.floor(cap[:, 1] * rng.random(n) * 0.7)
    feas = rng.random(n) > 0.1
    coll = (rng.random(n) < 0.2).astype(np.int32)
    aff = np.where(rng.random(n) < 0.2, rng.uniform(-1, 1, n),
                   0.0).astype(np.float32)
    ask = np.array([250, 512, 300, 0, 0], np.float32)

    def t(a):
        return torch.from_numpy(a).to(dev)
    return t(cap), t(used), t(ask), t(feas), t(coll), t(aff)


def _check_depth_curve(args, kw):
    before = cuda_kernels.LAUNCHES["depth_curve"]
    d_k, k_k, c_k = cuda_kernels.depth_curve(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["depth_curve"] == before + 1
    d_p, k_p, c_p = kernels.depth_curve_ref(*args, **kw)
    assert torch.equal(c_k, c_p)
    fin = torch.isfinite(d_p)
    assert torch.equal(torch.isfinite(d_k), fin)
    assert float((d_k[fin] - d_p[fin]).abs().max()) <= ATOL
    assert torch.equal(k_k[fin], k_p[fin])


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [None, GRID128], ids=["dense", "grid"])
@pytest.mark.parametrize("mpn", [2 ** 30, 1], ids=["free", "distinct"])
def test_depth_curve_kernel_matches_plain(dev, grid, mpn):
    cap, used, ask, feas, coll, aff = _inputs(dev)
    _check_depth_curve((cap, used, ask, feas, coll, 5_000, aff),
                       dict(max_per_node=mpn, k_max=128, depth_grid=grid))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [None, GRID128], ids=["dense", "grid"])
def test_depth_curve_kernel_spread_matches_plain(dev, grid):
    cap, used, ask, feas, coll, aff = _inputs(dev)
    _check_depth_curve((cap, used, ask, feas, coll, 5_000, aff),
                       dict(k_max=128, spread_algorithm=True,
                            depth_grid=grid))


@pytest.mark.cuda
def test_depth_curve_kernel_k512_matches_plain(dev):
    """A small ask, so capacities pass 128 and the walk crosses every
    depth chunk up to 512."""
    cap, used, _, feas, coll, aff = _inputs(dev, n=1_000)
    ask = torch.tensor([50, 64, 0, 0, 0], dtype=torch.float32, device=dev)
    args = (cap, used, ask, feas, coll, 5_000, aff)
    _, _, c_p = kernels.depth_curve_ref(*args, k_max=512)
    assert int(c_p.max()) > 512
    _check_depth_curve(args, dict(k_max=512))


@pytest.mark.cuda
def test_score_capacity_kernel_matches_plain(dev):
    cap, used, ask, feas, _, _ = _inputs(dev, n=5_001)
    before = cuda_kernels.LAUNCHES["score_capacity"]
    c_k, s_k = cuda_kernels.score_capacity_fused(cap, used, ask, feas)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["score_capacity"] == before + 1
    c_p, s_p = kernels.score_capacity_ref(cap, used, ask, feas)
    assert torch.equal(c_k, c_p)
    assert float((s_k - s_p).abs().max()) <= ATOL
    for count in (1, 4_000):
        assert torch.equal(
            cuda_kernels.fill_greedy_binpack_fused(cap, used, ask, count,
                                                   feas),
            kernels.fill_greedy_binpack(cap, used, ask, count, feas))


@pytest.mark.cuda
@pytest.mark.parametrize("count,mpn", [(1, 2 ** 30), (4_000, 2 ** 30),
                                       (4_000, 1)])
def test_fused_greedy_entry_matches_plain(dev, count, mpn):
    """One launch of the kernel's greedy entry: the clamped capacity and
    sort key equal kernels._greedy_key's, the placements the plain
    fill's."""
    cap, used, ask, feas, _, _ = _inputs(dev, n=5_001)
    before = cuda_kernels.LAUNCHES["score_capacity"]
    got = cuda_kernels.fill_greedy_binpack_fused(cap, used, ask, count, feas,
                                                 max_per_node=mpn)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["score_capacity"] == before + 1
    assert torch.equal(got, kernels.fill_greedy_binpack(
        cap, used, ask, count, feas, max_per_node=mpn))
    c_k, key_k = cuda_kernels._launch_score_capacity(cap, used, ask, feas,
                                                     False, True, mpn)
    c_p, key_p = kernels._greedy_key(
        *kernels.score_capacity_ref(cap, used, ask, feas), mpn)
    assert torch.equal(c_k, c_p)
    assert float((key_k - key_p).abs().max()) <= ATOL


@pytest.mark.cuda
def test_wrapper_refuses_a_non_contiguous_cuda_tensor(dev):
    cap, used, ask, feas, coll, aff = _inputs(dev, n=64)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.score_capacity_fused(cap.t().contiguous().t(), used,
                                          ask, feas)
    with pytest.raises(TypeError, match="dtype"):
        cuda_kernels.depth_curve(cap, used, ask, feas, coll.long(), 10, aff)


def _scan_inputs(dev, n=3_000, seed=5):
    """The chunked scan's inputs on a ragged node axis: two spread
    stanzas (targeted over 3 values with fractional weights, even over 40
    with some values missing), one distinct_property stanza, affinity and
    collisions. -> (args in place_chunked's positional order, d_active)."""
    cap, used, ask, feas, coll, aff = _inputs(dev, n=n, seed=seed)
    rng = np.random.default_rng(seed)
    sp_ids = np.stack([rng.integers(0, 3, n),
                       np.where(rng.random(n) < 0.1, -1,
                                rng.integers(0, 40, n))]).astype(np.int32)
    sp_counts = np.full((2, 64), -1, np.int32)
    sp_counts[0, :3] = 0
    sp_counts[1, :40] = rng.integers(0, 3, 40)
    sp_desired = np.full((2, 64), -1.0, np.float32)
    sp_desired[0, :3] = [2_000.0, 1_200.0, 800.0]
    sp_mode = np.array([1, 0], np.int32)
    sp_weights = np.array([0.7, 0.3], np.float32)
    dp_ids = rng.integers(-1, 100, (1, n)).astype(np.int32)
    dp_rem = rng.integers(0, 4, (1, 128)).astype(np.int32)

    def t(a):
        return torch.from_numpy(a).to(dev)
    args = (cap, used, ask, 4_000, feas, coll, 4_000, t(sp_ids),
            t(sp_counts), t(sp_desired), t(sp_mode), t(sp_weights), aff,
            t(dp_ids), t(dp_rem))
    return args, t(dp_rem[:, 0] >= 0)


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [False, True], ids=["binpack", "spread"])
def test_chunked_step_kernel_matches_plain(dev, spread):
    """One step's score, bit for bit, -inf on the same nodes."""
    args, d_active = _scan_inputs(dev)
    placed = (torch.arange(args[0].shape[0], device=dev) % 3 == 0).to(
        torch.int32)
    step = args[:3] + (args[4], args[5], placed, 2, args[6]) + args[7:] + \
        (d_active,)
    before = cuda_kernels.LAUNCHES["chunked_step"]
    got = cuda_kernels.chunked_step(*step, spread_algorithm=spread)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["chunked_step"] == before + 1
    want = kernels.chunked_step_ref(*step, spread_algorithm=spread)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()
    assert bool(torch.isfinite(want).any())


def _launches():
    return dict(cuda_kernels.LAUNCHES)


def _assert_scans_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [False, True], ids=["binpack", "spread"])
def test_place_chunked_kernel_matches_plain(dev, spread):
    """The whole scan in one launch of the scan kernel against the plain
    scan on the card: placements, usage, spread counts and quotas
    bit-equal; no step-kernel launch."""
    args, _ = _scan_inputs(dev)
    before = _launches()
    got = cuda_kernels.place_chunked(*args, spread_algorithm=spread)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["chunked_scan"] == \
        before["chunked_scan"] + 1
    assert cuda_kernels.LAUNCHES["chunked_step"] == before["chunked_step"]
    want = kernels.place_chunked(*args, spread_algorithm=spread)
    _assert_scans_equal(got, want)
    assert int(got[0].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCAN_CASES)
def test_scan_kernel_matches_plain_scan_on_every_case(dev, name):
    """Every chunked-scan fixture (nomad_tpu_torch/testing.py: the CPU
    tests' cases against the reference, and the kernel's edges: chunk 1,
    nothing feasible, done mid-scan, max_per_node 1, a split ask, buckets
    8, 1,024 and 65,536), run as the placer runs it (split_solves): the
    kernel, one launch per solve, bit-equal to the plain scan on the
    card."""
    args, kw = chunked_case(name)
    args = tuple(torch.from_numpy(np.asarray(a)).to(dev)
                 if isinstance(a, np.ndarray) else int(a) for a in args)
    solves = []

    def scan(*a, **k):
        solves.append(1)
        return cuda_kernels.place_chunked(*a, **k)
    before = _launches()
    got = split_solves(scan, args, kw)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["chunked_scan"] - before["chunked_scan"] \
        == len(solves)
    assert cuda_kernels.LAUNCHES["chunked_step"] == before["chunked_step"]
    want = split_solves(kernels.place_chunked, args, kw)
    _assert_scans_equal(got, want)
    if name == "split":
        assert len(solves) > 1


@pytest.mark.cuda
def test_scan_kernel_reports_its_steps(dev):
    """The kernel stops at the first step that selects nothing, and at
    remaining 0: ties_run_out runs out of capacity mid-scan."""
    args, kw = chunked_case("ties_run_out")
    args = tuple(torch.from_numpy(np.asarray(a)).to(dev)
                 if isinstance(a, np.ndarray) else int(a) for a in args)
    out = cuda_kernels.chunked_scan(*args, **kw)
    steps = int(out[4])
    assert 0 < steps < kw["max_steps"]
    _assert_scans_equal(out[:4], kernels.place_chunked(*args, **kw))


@pytest.mark.cuda
def test_preempt_top_k_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(4)
    c, v = 500, 16
    res = np.floor(rng.random((c, v, 5)) * [4_000, 8_192, 2_000, 20, 200]
                   ).astype(np.float32)
    prio = rng.choice([10, 20, 50, 90], (c, v)).astype(np.int32)
    ask = np.array([2_000, 4_096, 300, 2, 50], np.float32)
    free = np.floor(rng.random((c, 5)) * ask).astype(np.float32)
    args = [torch.from_numpy(a) for a in (res, prio, ask, free)]
    want = kernels.preempt_top_k(*args, 60)
    got = kernels.preempt_top_k(*[a.to(dev) for a in args], 60)
    assert torch.equal(got.cpu(), want)
    assert bool(want.any())


# ------------------------------------------------ the placement path

def _cluster(n_nodes=200, seed=7, **config):
    """A port FSM with the bench fleet's node recipe (ids pinned) and its
    real plan applier."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import NomadFSM, Planner
    from nomad_tpu_torch.server.fsm import RaftLog
    from nomad_tpu_torch.structs import SchedulerConfiguration
    rng = np.random.default_rng(seed)
    fsm = NomadFSM()
    s = fsm.state
    s.set_scheduler_config(1, SchedulerConfiguration(
        scheduler_algorithm="tpu-batch", **config))
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"cuda-node-{i:06d}"
        n.name = f"bench-{i}"
        n.node_class = f"c{int(rng.integers(0, 4))}"
        n.datacenter = "dc1" if i % 2 == 0 else "dc2"
        n.node_resources.cpu.cpu_shares = int(
            rng.choice([4_000, 8_000, 16_000, 32_000]))
        n.node_resources.memory.memory_mb = int(
            rng.choice([8_192, 16_384, 32_768, 65_536]))
        n.node_resources.disk.disk_mb = 500_000
        s.upsert_node(i + 2, n)
    return fsm, Planner(RaftLog(fsm), s)


class _Shim:
    def __init__(self, planner, state):
        self.planner = planner
        self.state = state

    def submit_plan(self, plan):
        return self.planner.apply_plan(plan)

    def submit_plan_async(self, plan):
        from nomad_tpu_torch.server.plan_apply import _PendingPlan
        pending = _PendingPlan(plan)
        pending.respond(self.planner.apply_plan(plan), None)
        return pending

    def update_eval(self, ev):
        self.state.upsert_evals(self.state.latest_index() + 1, [ev])

    def create_eval(self, ev):
        self.state.upsert_evals(self.state.latest_index() + 1, [ev])

    def refresh_snapshot(self, old):
        return self.state.snapshot()


def _run_job(fsm, planner, job_id, count):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler import new_scheduler
    from nomad_tpu_torch.structs import Evaluation
    s = fsm.state
    job = mock.batch_job()
    job.id = job.name = job_id
    tg = job.task_groups[0]
    tg.count = count
    tg.ephemeral_disk.size_mb = 300
    tg.tasks[0].resources.cpu = 250
    tg.tasks[0].resources.memory_mb = 512
    tg.tasks[0].resources.networks = []
    tg.networks = []
    s.upsert_job(s.latest_index() + 1, job)
    ev = Evaluation(id=f"cuda-eval-{job_id}", namespace="default",
                    job_id=job_id, type="batch", priority=50)
    s.upsert_evals(s.latest_index() + 1, [ev])
    new_scheduler("batch", s.snapshot(), _Shim(planner, s)).process(ev)
    return {a.name: a.node_id for a in s.allocs_by_job("default", job_id)}


@pytest.mark.cuda
def test_pipelined_eval_places_alike_on_the_card_and_the_cpu(dev):
    """A 600-task dense-regime job pipelined in 3 chunks on a 200-node
    cluster: 3 depth-curve launches on the card, and the same alloc ->
    node map as the plain tier's on the CPU."""
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import backend, state_cache
    from nomad_tpu_torch.solver.device import use_device
    cfg = {"plan_pipeline_min_count": 1, "plan_pipeline_chunks": 3}
    maps = {}
    try:
        for where in ("cuda:0", "cpu"):
            use_device(where)
            backend.reset()
            state_cache.reset()
            fsm, planner = _cluster(**cfg)
            before = cuda_kernels.LAUNCHES["depth_curve"]
            chunks = metrics.counter("nomad.plan.pipeline.chunks")
            maps[where] = _run_job(fsm, planner, "pipe", 600)
            assert metrics.counter("nomad.plan.pipeline.chunks") == \
                chunks + 3
            if where == "cuda:0":
                assert cuda_kernels.LAUNCHES["depth_curve"] == before + 3
    finally:
        use_device("cuda:0")
        backend.reset()
        state_cache.reset()
    assert len(maps["cuda:0"]) == 600
    assert maps["cuda:0"] == maps["cpu"]


@pytest.mark.cuda
def test_state_cache_twins_live_on_the_card_after_a_commit(dev):
    """After an eval's commit the cache's twins are on cuda:0, advanced
    by the commit hook to exactly the committed usage."""
    from nomad_tpu_torch.solver import state_cache
    state_cache.reset()
    fsm, planner = _cluster(n_nodes=50)
    _run_job(fsm, planner, "twins", 40)
    stats = state_cache.cache().stats()
    assert stats["twins_device"] == "cuda:0"
    view = fsm.state.usage.view()
    assert stats["version"] == view.version
    cap_dev, used_dev = state_cache.cache().twins()
    assert used_dev.device == torch.device("cuda:0")
    n = view.cap.shape[0]
    assert used_dev[:n].cpu().numpy().tobytes() == view.used.tobytes()
    assert cap_dev[:n].cpu().numpy().tobytes() == view.cap.tobytes()
    assert not bool(used_dev[n:].any())
    state_cache.reset()


def _reduce_on(dev, args, n_classes):
    from nomad_tpu_torch.solver import explain
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in args[:7]]
    buf = kernels.explain_reduce(*t, bool(args[7]), n_classes=n_classes)
    assert buf.device == dev and buf.dtype == torch.int32
    return explain.unpack(buf.cpu().numpy(), NUM_XR, n_classes)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["seed0", "seed1", "bucket", "boundary"])
def test_explain_reduce_on_the_card_matches_numpy(dev, case):
    """The explain reduce's torch ops on the card give reduce_numpy's
    bits: seeded inputs, the 16,384 bucket, and rows on a float32
    rounding boundary of used + placed * ask (two roundings on both)."""
    from nomad_tpu_torch.solver import explain
    from nomad_tpu_torch.testing import explain_boundary_case, explain_case
    if case == "boundary":
        args, ncls = explain_boundary_case(), 2
    elif case == "bucket":
        args, ncls = explain_case(7, n=16_384, n_classes=8), 8
    else:
        args, ncls = explain_case(int(case[-1])), 4
    got = _reduce_on(dev, args, ncls)
    want = explain.reduce_numpy(*args, n_classes=ncls)
    for a, b in zip(got, want):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.cuda
def test_injected_fault_on_the_card_raises_and_is_counted(dev):
    """A fault at `solver.dispatch.cuda` raises out of the card's solve:
    one dispatch error, no kernel launch and nothing served on the CPU;
    the next solve launches the kernel and places as before."""
    from nomad_tpu_torch import faults
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import backend
    backend.reset()
    cap, used, ask, feas, coll, aff = (t.cpu().numpy()
                                       for t in _inputs(dev))
    args = (cap, used, ask, np.int32(5_000), feas, coll, np.int32(5_000),
            aff, np.int32(2 ** 30), None, np.float32(0.5), np.float32(0.0))
    name, fn = backend.select("depth", cap.shape[0], k_max=128)
    assert name == "cuda"
    want = fn(*args)
    faults.install({"solver.dispatch.cuda": {"mode": "raise", "times": 1}})
    try:
        e0 = metrics.counter("nomad.solver.dispatch_errors.cuda")
        t0 = metrics.counter("nomad.solver.dispatch.torch")
        launches = cuda_kernels.LAUNCHES["depth_curve"]
        with pytest.raises(faults.FaultError):
            fn(*args)
        assert cuda_kernels.LAUNCHES["depth_curve"] == launches
        got = fn(*args)
    finally:
        faults.clear()
        backend.reset()
    assert cuda_kernels.LAUNCHES["depth_curve"] == launches + 1
    assert metrics.counter("nomad.solver.dispatch_errors.cuda") == e0 + 1
    assert metrics.counter("nomad.solver.dispatch.torch") == t0
    assert int(got.sum()) == 5_000 and torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_build_error_on_the_card_never_feeds_the_breaker(
        dev, monkeypatch):
    """A kernel that does not build raises out of every card solve,
    BREAKER_THRESHOLD + 1 times over, uncounted, with the breaker
    closed."""
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import backend

    def broken(*a, **kw):
        raise cuda_kernels.KernelBuildError("CUDA kernel build failed")
    monkeypatch.setattr(cuda_kernels, "fill_depth_fused", broken)
    backend.reset()
    cap, used, ask, feas, coll, aff = (t.cpu().numpy()
                                       for t in _inputs(dev))
    args = (cap, used, ask, np.int32(5_000), feas, coll, np.int32(5_000),
            aff, np.int32(2 ** 30), None, np.float32(0.5), np.float32(0.0))
    try:
        _, fn = backend.select("depth", cap.shape[0], k_max=128)
        e0 = metrics.counter("nomad.solver.dispatch_errors")
        for _ in range(backend.BREAKER_THRESHOLD + 1):
            with pytest.raises(cuda_kernels.KernelBuildError):
                fn(*args)
            assert backend.breaker().state("cuda") == "closed"
        assert metrics.counter("nomad.solver.dispatch_errors") == e0
    finally:
        backend.reset()


def _lane_inputs(dev, n_lanes=8, n=3_000):
    """Stacked lanes, each with its own usage, ask and scalars; the last
    two are count-0 clones of lane 0 (lanes that place nothing)."""
    cols = [_inputs(dev, n=n, seed=10 + lane) for lane in range(n_lanes - 2)]
    cols += [cols[0]] * 2
    cap, used, ask, feas, coll, aff = (torch.stack(c).contiguous()
                                       for c in zip(*cols))
    ask[:, 0] = torch.tensor([250, 500, 100, 900, 300, 50, 250, 250],
                             dtype=torch.float32, device=dev)[:n_lanes]
    counts = [5_000, 40, 700, 1, 2_000, 300, 0, 0][:n_lanes]
    desired = [c + 7 for c in counts]
    mpn = [2 ** 30, 1, 2 ** 30, 3, 2 ** 30, 2 ** 30, 2 ** 30, 2 ** 30]
    return cap, used, ask, feas, coll, aff, counts, desired, mpn[:n_lanes]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [None, GRID128], ids=["dense", "grid"])
def test_depth_curve_lanes_equal_solo_launches_and_plain(dev, grid):
    cap, used, ask, feas, coll, aff, counts, desired, mpn = \
        _lane_inputs(dev)
    kw = dict(k_max=128, depth_grid=grid)
    before = cuda_kernels.LAUNCHES["depth_curve_lanes"]
    d_l, k_l, c_l = cuda_kernels.depth_curve_lanes(
        cap, used, ask, feas, coll, desired, aff, mpn, **kw)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["depth_curve_lanes"] == before + 1
    for lane in range(cap.shape[0]):
        d_s, k_s, c_s = cuda_kernels.depth_curve(
            cap[lane], used[lane], ask[lane], feas[lane], coll[lane],
            desired[lane], aff[lane], max_per_node=mpn[lane], **kw)
        assert torch.equal(d_l[lane].view(torch.int32),
                           d_s.view(torch.int32)), lane
        assert torch.equal(k_l[lane], k_s) and torch.equal(c_l[lane], c_s)
    d_p, k_p, c_p = kernels.depth_curve_lanes_ref(
        cap, used, ask, feas, coll, desired, aff, mpn, **kw)
    assert torch.equal(c_l, c_p)
    fin = torch.isfinite(d_p)
    assert torch.equal(torch.isfinite(d_l), fin)
    assert float((d_l[fin] - d_p[fin]).abs().max()) <= ATOL
    assert torch.equal(k_l[fin], k_p[fin])


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [None, GRID128], ids=["dense", "grid"])
def test_fill_depth_lanes_equals_solo_fill_depth_fused(dev, grid):
    cap, used, ask, feas, coll, aff, counts, desired, mpn = \
        _lane_inputs(dev)
    n_lanes, n = cap.shape[:2]
    jitter = torch.rand((n_lanes, n), generator=torch.Generator().manual_seed(
        5)).to(dev)
    scales = [0.5, 1.5, 0.5, 1.0, 0.5, 2.0, 0.5, 0.5]
    samples = [0.0, 0.0, 1.7, 0.0, 2.5, 0.0, 0.0, 0.0] if grid else \
        [0.0] * n_lanes
    out = cuda_kernels.fill_depth_lanes(
        cap, used, ask, counts, feas, coll, desired, aff, mpn,
        order_jitter=jitter, jitter_scales=scales, jitter_samples=samples,
        k_max=128, depth_grid=grid)
    plain = kernels.fill_depth_lanes(
        cap, used, ask, counts, feas, coll, desired, aff, mpn,
        order_jitter=jitter, jitter_scales=scales, jitter_samples=samples,
        k_max=128, depth_grid=grid)
    for lane in range(n_lanes):
        solo = cuda_kernels.fill_depth_fused(
            cap[lane], used[lane], ask[lane], counts[lane], feas[lane],
            coll[lane], desired[lane], aff[lane], max_per_node=mpn[lane],
            order_jitter=jitter[lane], jitter_scale=scales[lane],
            jitter_samples=samples[lane], k_max=128, depth_grid=grid)
        assert torch.equal(out[lane], solo), lane
        assert int(out[lane].sum()) == int(plain[lane].sum())
    assert not out[n_lanes - 2:].any()


@pytest.mark.cuda
def test_depth_curve_takes_at_most_a_windows_lanes(dev):
    """One launch takes 1..BATCH_LANES lanes (the largest window); a
    solo solve is one lane, counted as a solo launch."""
    cap, used, ask, feas, coll, aff, counts, desired, mpn = \
        _lane_inputs(dev, n=64)
    n_lanes = cuda_kernels.MAX_LANES + 1
    wide = [t[:1].expand(n_lanes, *t.shape[1:]).contiguous()
            for t in (cap, used, ask, feas, coll, aff)]
    with pytest.raises(ValueError, match="lanes"):
        cuda_kernels.depth_curve_lanes(
            *wide[:5], desired[:1] * n_lanes, wide[5], mpn[:1] * n_lanes)
    before = dict(cuda_kernels.LAUNCHES)
    cuda_kernels.depth_curve(cap[0], used[0], ask[0], feas[0], coll[0],
                             desired[0], aff[0], max_per_node=mpn[0])
    assert cuda_kernels.LAUNCHES["depth_curve"] == before["depth_curve"] + 1
    assert cuda_kernels.LAUNCHES["depth_curve_lanes"] == \
        before["depth_curve_lanes"]


def _convex_inputs(name, dev):
    """CONVEX_CASES[name] as convex_solve's and convex_eval's args on
    `dev`."""
    cap, used, feas, coll, ask, count, kw = convex_fixture(name)
    b = cap.shape[0]
    aff = kw["affinity_boost"]
    aff = np.zeros(b, np.float32) if aff is None else aff

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    solve = (t(cap), t(used), t(ask), t(feas), t(coll), t(aff), count,
             kw["max_per_node"], kw["max_iters"], kw["tolerance"],
             kw["fairness_weight"], kw["quota_budget"])
    evals = (t(cap), t(used), t(np.arange(b, dtype=np.int32)),
             t(np.ones(b, bool)), t(ask), count, t(feas),
             kw["max_per_node"], t(aff), t(coll), None, False,
             kw["max_iters"], kw["tolerance"], kw["fairness_weight"],
             kw["quota_budget"])
    return solve, evals, kw["spread_algorithm"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONVEX_CASES)
def test_convex_solve_kernel_matches_plain(dev, name):
    """The convex-solve kernel returns the plain version's iterate, u,
    cost, budget, iteration count and gap bit for bit (both sum in the
    kernel's cluster order), in one launch; the whole eval on the card
    (kernel, K2's greedy entry, torch tail) places as the plain eval:
    placements, fit and convex_won equal, iterations equal, the gap
    within 1e-6."""
    solve, evals, spread = _convex_inputs(name, dev)
    before = cuda_kernels.LAUNCHES["convex_solve"]
    got = cuda_kernels.convex_solve(*solve, spread_algorithm=spread)
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["convex_solve"] == before + 1
    want = convex.convex_solve_ref(*solve, spread_algorithm=spread)
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    k0 = dict(cuda_kernels.LAUNCHES)
    card = convex.to_host(cuda_kernels.convex_eval_fused(
        *evals, spread_algorithm=spread))
    assert cuda_kernels.LAUNCHES["convex_solve"] == k0["convex_solve"] + 1
    assert cuda_kernels.LAUNCHES["score_capacity"] == \
        k0["score_capacity"] + 1
    plain = convex.to_host(convex.convex_eval(*evals,
                                              spread_algorithm=spread))
    np.testing.assert_array_equal(card[0], plain[0])
    np.testing.assert_array_equal(card[1], plain[1])
    assert card[2] == plain[2] and card[4] == plain[4]
    np.testing.assert_allclose(card[3], plain[3], atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_greedy_fill_reads_a_device_count_without_a_sync(dev):
    """The greedy tail takes the convex budget as a 0-dim device tensor
    with no host sync, and places what the host count places."""
    cap, used, ask, feas, _, _ = _inputs(dev)
    capacity, key = cuda_kernels._launch_score_capacity(
        cap, used, ask, feas, False, True, 2 ** 30)
    for count in (0, 1, 777, 10 ** 6):
        want = kernels._greedy_fill(capacity, key, count)
        budget = torch.tensor(count, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = kernels._greedy_fill(capacity, key, budget)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(got, want)
        assert torch.equal(
            cuda_kernels.fill_greedy_binpack_fused(cap, used, ask, count,
                                                   feas),
            kernels.fill_greedy_binpack(cap, used, ask, count, feas))


def _raft_leader(servers, timeout=60.0):
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        led = [s for s in servers if s.raft_node.is_leader()]
        if len(led) == 1 and led[0].is_leader and \
                led[0]._established_term == led[0].raft_node.current_term:
            return led[0]
        time.sleep(0.01)
    raise AssertionError("no established raft leader")


def _raft_placed(srv, job_id, count, timeout=60.0) -> bool:
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len([a for a in srv.state.allocs_by_job("default", job_id)
                if a.desired_status == "run"]) == count:
            return True
        time.sleep(0.01)
    return False


@pytest.mark.cuda
def test_raft_cluster_places_on_the_card_and_reseeds_after_a_crash(
        dev, tmp_path, monkeypatch):
    """Three port servers on the in-memory network, a durable WAL each:
    a job placed through the leader on the card; after the leader's
    crash the new leader's establishment reseeds the state cache on the
    card, its twins equal to a fresh reseed's, and it places the next
    job there."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.rpc.virtual import VirtualNetwork
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.solver import backend, state_cache
    from nomad_tpu_torch.structs import SchedulerConfiguration
    from nomad_tpu_torch.testing import park_follower_workers

    monkeypatch.setenv("NOMAD_AOT_WARMUP", "1")
    backend.reset()
    state_cache.reset()
    net = VirtualNetwork(seed=4)
    servers = []
    try:
        for i in range(3):
            s = Server(num_workers=1, gc_interval=9999)
            s.heartbeats.min_ttl = 3600.0
            s.rpc_listen_virtual(net, f"c{i}")
            servers.append(s)
        peers = {f"c{i}": s.rpc_addr for i, s in enumerate(servers)}
        for i, s in enumerate(servers):
            s.enable_raft(f"c{i}", peers, data_dir=str(tmp_path / f"c{i}"),
                          seed=4000 + i, election_timeout=(1.2, 2.4),
                          heartbeat_interval=0.15)
            s.start()
            park_follower_workers(s)
        leader = _raft_leader(servers)
        leader.set_scheduler_configuration(SchedulerConfiguration(
            scheduler_algorithm="tpu-batch"))
        for _ in range(48):
            leader.node_register(mock.node())

        def job(job_id, count):
            j = mock.batch_job()
            j.id = j.name = job_id
            tg = j.task_groups[0]
            tg.count = count
            tg.networks = []
            tg.tasks[0].resources.networks = []
            return j
        cpu0 = metrics.counter("nomad.solver.dispatch.torch")
        launches0 = cuda_kernels.LAUNCHES["depth_curve"]
        leader.job_register(job("card-a", 40))
        assert _raft_placed(leader, "card-a", 40)
        assert cuda_kernels.LAUNCHES["depth_curve"] > launches0

        net.crash(leader.raft_node.node_id)
        rest = [s for s in servers if s is not leader]
        new = _raft_leader(rest)
        cache = state_cache.cache()
        st = cache.stats()
        assert st["uid"] == new.state.usage.uid and st["rows"] == 48
        assert st["twins_device"] == str(dev)
        cap_w, used_w = (t.clone() for t in cache.twins())
        cache.reset()
        state_cache.reseed(new.state)
        cap_f, used_f = cache.twins()
        assert torch.equal(cap_w, cap_f) and torch.equal(used_w, used_f)
        new.job_register(job("card-b", 30))
        assert _raft_placed(new, "card-b", 30)
        assert metrics.counter("nomad.solver.dispatch.torch") == cpu0
    finally:
        for s in servers:
            s.shutdown()
        backend.reset()
        state_cache.reset()
