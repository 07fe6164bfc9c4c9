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

from nomad_tpu_torch.solver import cuda_kernels, kernels

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


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [None, GRID128], ids=["dense", "grid"])
@pytest.mark.parametrize("mpn", [2 ** 30, 1], ids=["free", "distinct"])
def test_depth_curve_kernel_matches_plain(dev, grid, mpn):
    cap, used, ask, feas, coll, aff = _inputs(dev)
    args = (cap, used, ask, feas, coll, 5_000, aff)
    kw = dict(max_per_node=mpn, k_max=128, depth_grid=grid)
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
def test_wrapper_refuses_a_non_contiguous_cuda_tensor(dev):
    cap, used, ask, feas, coll, aff = _inputs(dev, n=64)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.score_capacity_fused(cap.t().contiguous().t(), used,
                                          ask, feas)
    with pytest.raises(TypeError, match="dtype"):
        cuda_kernels.depth_curve(cap, used, ask, feas, coll.long(), 10, aff)
