"""The port's kernel modules against the reference, on the CPU.

Each case feeds the same seeded numpy inputs to the JAX package (the
Pallas kernels in interpret mode, plus the XLA programs in
solver/kernels.py) and to nomad_tpu_torch's plain versions and kernel
wrappers. Integer outputs (capacities, depths, placements) must be
exactly equal; scores and densities agree to atol 1e-4 (float32 pow and
prefix sums round in different places in the two frameworks).

The kernels themselves only run on a card: tests/test_torch_cuda.py
compares each kernel with its plain version there (it imports no jax, so
it runs on the card's machine) and skips here.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nomad_tpu.solver import kernels as ref_kernels
from nomad_tpu.solver import pallas_kernels as ref_pallas
from nomad_tpu_torch.solver import cuda_kernels, kernels
from nomad_tpu_torch.solver.device import use_device

NUM_XR = 5
ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _cpu_solves():
    # one intra-op thread: the suite runs several workers side by side
    prev, threads = use_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    use_device(prev)


def _cluster(n, seed=0, used_cpu=1000, used_mem=2048):
    rng = np.random.default_rng(seed)
    cap = np.zeros((n, NUM_XR), np.float32)
    cap[:, 0] = rng.choice([2000, 4000, 8000], n)
    cap[:, 1] = rng.choice([4096, 8192, 16384], n)
    cap[:, 2] = 100_000
    cap[:, 3] = 12_001
    cap[:, 4] = 1_000
    used = np.zeros_like(cap)
    used[:, 0] = rng.integers(0, used_cpu, n)
    used[:, 1] = rng.integers(0, used_mem, n)
    return cap, used


def _depth_args(n, count, seed=0, jitter_samples=0.0, max_per_node=2 ** 30,
                aff_seed=None):
    """The reference's depth fixture (tests/test_solver_backend.py
    _depth_args) as numpy, optionally with an affinity column."""
    cap, used = _cluster(n, seed)
    ask = np.zeros(NUM_XR, np.float32)
    ask[0], ask[1] = 500, 256
    feas = np.ones(n, bool)
    feas[::7] = False
    coll = np.zeros(n, np.int32)
    coll[: n // 4] = 1
    aff = np.zeros(n, np.float32)
    if aff_seed is not None:
        r = np.random.default_rng(aff_seed)
        aff = np.where(r.random(n) < 0.3, r.uniform(-1, 1, n),
                       0.0).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    jitter = rng.random(n, dtype=np.float32)
    return dict(cap=cap, used=used, ask=ask, count=count, feasible=feas,
                coll=coll, desired=count, aff=aff,
                max_per_node=max_per_node, jitter=jitter, scale=1.5,
                js=jitter_samples)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_curve(a, k_max, depth_grid):
    """The Pallas depth-curve kernel's (d_star, k_star, k_cap), run in
    interpret mode: the reference wrapper, eagerly, with its shared tail
    swapped for one that hands back the producer's outputs."""
    captured = {}

    def take(d_star, k_star, k_cap, *rest):
        captured["out"] = (np.asarray(d_star), np.asarray(k_star),
                           np.asarray(k_cap))
        return k_star

    saved = ref_kernels._depth_order_take
    ref_kernels._depth_order_take = take
    try:
        ref_pallas.fill_depth_fused.__wrapped__(
            jnp.asarray(a["cap"]), jnp.asarray(a["used"]),
            jnp.asarray(a["ask"]), jnp.int32(a["count"]),
            jnp.asarray(a["feasible"]), jnp.asarray(a["coll"]),
            jnp.int32(a["desired"]), jnp.asarray(a["aff"]),
            max_per_node=jnp.int32(a["max_per_node"]),
            order_jitter=jnp.asarray(a["jitter"]),
            jitter_scale=jnp.float32(a["scale"]),
            jitter_samples=jnp.float32(a["js"]), k_max=k_max,
            depth_grid=depth_grid, interpret=True)
    finally:
        ref_kernels._depth_order_take = saved
    return captured["out"]


def _ref_fill_depth(a, k_max, depth_grid, pallas: bool):
    args = (jnp.asarray(a["cap"]), jnp.asarray(a["used"]),
            jnp.asarray(a["ask"]), jnp.int32(a["count"]),
            jnp.asarray(a["feasible"]), jnp.asarray(a["coll"]),
            jnp.int32(a["desired"]), jnp.asarray(a["aff"]))
    kw = dict(max_per_node=jnp.int32(a["max_per_node"]),
              order_jitter=jnp.asarray(a["jitter"]),
              jitter_scale=jnp.float32(a["scale"]),
              jitter_samples=jnp.float32(a["js"]), k_max=k_max,
              depth_grid=depth_grid)
    if pallas:
        return np.asarray(ref_pallas.fill_depth_fused(*args, **kw,
                                                      interpret=True))
    return np.asarray(ref_kernels.fill_depth(*args, **kw))


def _port_depth(fn, a, k_max, depth_grid):
    return fn(_t(a["cap"]), _t(a["used"]), _t(a["ask"]), a["count"],
              _t(a["feasible"]), _t(a["coll"]), a["desired"], _t(a["aff"]),
              max_per_node=a["max_per_node"], order_jitter=_t(a["jitter"]),
              jitter_scale=a["scale"], jitter_samples=a["js"], k_max=k_max,
              depth_grid=depth_grid)


GRID16 = tuple(g for g in kernels.DEPTH_GRID if g <= 16)
GRID128 = tuple(g for g in kernels.DEPTH_GRID if g <= 128)

# (name, n, count, seed, jitter_samples, max_per_node, k_max, grid, aff)
DEPTH_CASES = [
    ("dense", 300, 200, 11, 0.0, 2 ** 30, 16, None, None),
    ("jittered", 300, 25, 13, 0.8, 2 ** 30, 16, None, None),
    ("max_per_node_1", 64, 30, 17, 0.0, 1, 16, None, None),
    ("grid_jittered", 300, 40, 21, 0.8, 2 ** 30, 16, GRID16, None),
    ("grid_det", 300, 150, 22, 0.0, 2 ** 30, 16, GRID16, None),
    ("ragged_dense_k128", 1000, 3000, 5, 0.0, 2 ** 30, 128, None, None),
    ("ragged_grid_k128", 333, 90, 6, 1.2, 2 ** 30, 128, GRID128, None),
    ("affinity", 257, 120, 8, 0.0, 2 ** 30, 32, None, 9),
]


@pytest.mark.parametrize("case", DEPTH_CASES, ids=[c[0] for c in DEPTH_CASES])
def test_depth_curve_matches_pallas_kernel(case):
    """depth_curve_ref == the Pallas producer: k_star and k_cap exactly,
    d_star to atol 1e-4 with the same -inf (no depth fits) rows."""
    _, n, count, seed, js, mpn, k_max, grid, aff = case
    a = _depth_args(n, count, seed, js, mpn, aff)
    want_d, want_k, want_c = _ref_curve(a, k_max, grid)
    d, k, c = kernels.depth_curve_ref(
        _t(a["cap"]), _t(a["used"]), _t(a["ask"]), _t(a["feasible"]),
        _t(a["coll"]), a["desired"], _t(a["aff"]),
        max_per_node=a["max_per_node"], k_max=k_max, depth_grid=grid)
    d, k, c = d.numpy(), k.numpy(), c.numpy()
    np.testing.assert_array_equal(c, want_c)
    np.testing.assert_array_equal(np.isfinite(d), np.isfinite(want_d))
    fin = np.isfinite(d)
    np.testing.assert_allclose(d[fin], want_d[fin], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(k[fin], want_k[fin])


@pytest.mark.parametrize("case", DEPTH_CASES, ids=[c[0] for c in DEPTH_CASES])
def test_fill_depth_placements_match_reference(case):
    """Port fill_depth (and the kernel wrapper on CPU tensors, which runs
    the plain version) places exactly like the reference's XLA program
    and its Pallas kernel."""
    _, n, count, seed, js, mpn, k_max, grid, aff = case
    a = _depth_args(n, count, seed, js, mpn, aff)
    want = _ref_fill_depth(a, k_max, grid, pallas=False)
    np.testing.assert_array_equal(
        _ref_fill_depth(a, k_max, grid, pallas=True), want)
    got = _port_depth(kernels.fill_depth, a, k_max, grid)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    cuda_kernels.reset_launches()
    wrapped = _port_depth(cuda_kernels.fill_depth_fused, a, k_max, grid)
    np.testing.assert_array_equal(wrapped.numpy(), want)
    assert cuda_kernels.LAUNCHES["depth_curve"] == 0
    assert int(got.sum()) == min(count, int(want.sum()))
    if mpn == 1:
        assert int(got.max()) <= 1


# (name, n, seed, ask cpu/mem/disk, feasible share, spread)
SCORE_CASES = [
    ("ragged_700", 700, 3, (250, 512, 300), 0.9, False),
    ("bucket_1024", 1024, 4, (100, 128, 0), 1.0, False),
    ("spread_333", 333, 7, (400, 700, 300), 0.8, True),
]


@pytest.mark.parametrize("case", SCORE_CASES, ids=[c[0] for c in SCORE_CASES])
def test_score_capacity_matches_pallas_kernel(case):
    """score_capacity_ref == the Pallas score/capacity kernel: capacity
    exactly, score to atol 1e-4 (-1 where nothing fits)."""
    _, n, seed, ask3, share, spread = case
    cap, used = _cluster(n, seed, used_cpu=1500, used_mem=2000)
    ask = np.zeros(NUM_XR, np.float32)
    ask[:3] = ask3
    feas = np.random.default_rng(seed).random(n) < share
    c_want, s_want = ref_pallas.score_capacity_fused(
        jnp.asarray(cap), jnp.asarray(used), jnp.asarray(ask),
        jnp.asarray(feas), spread=spread, interpret=True)
    c, s = kernels.score_capacity_ref(_t(cap), _t(used), _t(ask), _t(feas),
                                      spread=spread)
    assert c.dtype == torch.int32 and s.dtype == torch.float32
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_want))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), atol=ATOL,
                               rtol=0)
    # the XLA pair the reference holds its kernel against, too
    c_x = ref_kernels.instance_capacity(jnp.asarray(cap), jnp.asarray(used),
                                        jnp.asarray(ask), jnp.asarray(feas))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_x))


# (name, n, seed, count, feasible share, max_per_node)
GREEDY_CASES = [
    ("fill_900", 900, 5, 3000, 1.0, 2 ** 30),
    ("ragged_701", 701, 6, 1, 0.85, 2 ** 30),
    ("distinct_hosts", 300, 7, 120, 0.9, 1),
    ("overask", 200, 8, 10 ** 6, 0.7, 2 ** 30),
]


@pytest.mark.parametrize("case", GREEDY_CASES,
                         ids=[c[0] for c in GREEDY_CASES])
def test_fill_greedy_placements_match_reference(case):
    """Port fill_greedy_binpack and the kernel wrapper on CPU tensors
    place exactly like the reference's XLA program and Pallas kernel."""
    _, n, seed, count, share, mpn = case
    cap, used = _cluster(n, seed, used_cpu=1500, used_mem=2000)
    ask = np.zeros(NUM_XR, np.float32)
    ask[0], ask[1] = 100, 128
    feas = np.random.default_rng(seed).random(n) < share
    jargs = (jnp.asarray(cap), jnp.asarray(used), jnp.asarray(ask),
             jnp.int32(count), jnp.asarray(feas))
    want = np.asarray(ref_kernels.fill_greedy_binpack(
        *jargs, max_per_node=jnp.int32(mpn)))
    np.testing.assert_array_equal(np.asarray(
        ref_pallas.fill_greedy_binpack_fused(
            *jargs, max_per_node=jnp.int32(mpn), interpret=True)), want)
    targs = (_t(cap), _t(used), _t(ask), count, _t(feas))
    got = kernels.fill_greedy_binpack(*targs, max_per_node=mpn)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    cuda_kernels.reset_launches()
    wrapped = cuda_kernels.fill_greedy_binpack_fused(*targs,
                                                     max_per_node=mpn)
    np.testing.assert_array_equal(wrapped.numpy(), want)
    assert cuda_kernels.LAUNCHES["score_capacity"] == 0


def test_plan_fit_verdict_matches_reference():
    cap, used = _cluster(300, 12)
    ask = np.zeros(NUM_XR, np.float32)
    ask[0], ask[1] = 500, 900
    placed = np.random.default_rng(12).integers(0, 12, 300).astype(np.int32)
    want = np.asarray(ref_kernels.plan_fit_verdict(
        jnp.asarray(cap), jnp.asarray(used), jnp.asarray(ask),
        jnp.asarray(placed)))
    got = kernels.plan_fit_verdict(_t(cap), _t(used), _t(ask), _t(placed))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < 300
    assert kernels.FIT_EPS == ref_kernels.FIT_EPS
    assert kernels.DEPTH_GRID == ref_kernels.DEPTH_GRID


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """On a CUDA tensor a wrapper launches or raises; the shape/dtype
    checks run before any launch, so they are testable without a card
    through a tensor that claims the wrong dtype."""
    cap = torch.zeros((4, NUM_XR), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels._check_rows(cap, cap, torch.zeros(NUM_XR),
                                 torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError, match="dtype"):
        cuda_kernels._check(cap.double(), "cap", torch.float32,
                            (4, NUM_XR), cap.device)
    with pytest.raises(ValueError, match="shape"):
        cuda_kernels._check(cap[:, :3], "cap", torch.float32,
                            (4, NUM_XR), cap.device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels._check(cap.t().contiguous().t(), "cap",
                            torch.float32, (4, NUM_XR), cap.device)
