"""The port's batched preemption pass (kernels.preempt_top_k over a
leading candidate axis) against the JAX package's preempt_top_k under
jax.jit(jax.vmap(...)), as the reference's placer runs it, on the CPU at
one torch thread. The victim masks must be equal, with no tolerance.

The rows cover what can move a mask: priority ties and distance ties
(the stable sort), pad victims (priority 2**20, never eligible), rows
with no deficit (nothing taken), rows where no victim is eligible, the
float32 key `priority * 1e6 + distance` that swallows small distances
from priority 17 on, victim axes past 16 (XLA's blocked prefix sum), and
a pair of victims whose order only the distance's fused multiply-adds
decide.
"""
import numpy as np
import jax
import pytest
import torch

from nomad_tpu.solver import kernels as ref_kernels
from nomad_tpu_torch.solver import kernels

PAD_PRIO = 2 ** 20


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref_batched():
    return jax.jit(jax.vmap(ref_kernels.preempt_top_k,
                            in_axes=(0, 0, None, 0, None)))


def _rows(seed, c, v, integer, job_prio=60):
    """Seeded candidate rows: victims with mixed priorities (ties, some
    above the job's), pad columns, and free capacity from ample (no
    deficit) to short."""
    rng = np.random.default_rng(seed)
    scale = np.array([4_000, 8_192, 2_000, 20, 200], np.float32)
    res = rng.random((c, v, 5)).astype(np.float32) * scale
    if integer:
        res = np.floor(res)
    # duplicate victims: exact distance ties inside a row
    dup = rng.random((c, v)) < 0.3
    res[dup] = res[:, :1].repeat(v, axis=1)[dup]
    prio = rng.choice([0, 5, 10, 20, 20, 50, 70], (c, v)).astype(np.int32)
    n_live = rng.integers(0, v + 1, c)
    prio[np.arange(v)[None, :] >= n_live[:, None]] = PAD_PRIO
    res[prio == PAD_PRIO] = 0.0
    ask = np.array([2_000, 4_096, 300, 2, 50], np.float32)
    free = (rng.random((c, 5)) * 1.2 * ask).astype(np.float32)
    if integer:
        free = np.floor(free)
    free[::7] = ask * 2                        # no deficit
    prio[3::11] = 90                           # nothing eligible
    return res, prio, ask, free, job_prio


def _compare(ref_batched, res, prio, ask, free, job_prio):
    want = np.asarray(ref_batched(res, prio, ask, free, np.int32(job_prio)))
    got = kernels.preempt_top_k(torch.from_numpy(res),
                                torch.from_numpy(prio),
                                torch.from_numpy(ask),
                                torch.from_numpy(free), job_prio).numpy()
    np.testing.assert_array_equal(got, want)
    return want


@pytest.mark.parametrize("v", [4, 16, 32, 64])
@pytest.mark.parametrize("integer", [True, False], ids=["mb_mhz", "float"])
def test_preempt_top_k_matches_reference(ref_batched, v, integer):
    rows = _rows(v * 2 + int(integer), 96, v, integer)
    want = _compare(ref_batched, *rows)
    assert want.any() and not want.all(axis=1).all()


def test_high_priority_keys_swallow_distance_like_reference(ref_batched):
    """At priority >= 17 the float32 key cannot tell distances below its
    spacing apart: ties then fall to victim order, as in the
    reference."""
    res, prio, ask, free, _ = _rows(3, 64, 8, integer=False)
    prio = np.where(prio == PAD_PRIO, PAD_PRIO, 40).astype(np.int32)
    _compare(ref_batched, res, prio, ask, free, 95)


def test_distance_fma_pair(ref_batched):
    """Two victims of one priority whose distances are equal when each
    square and sum is rounded on its own, and ordered by the fused
    multiply-add chain the reference compiles: the second victim is the
    nearer one."""
    res = np.array([[[638.885986328125, 2847.692138671875,
                      940.9341430664062, 0.9077333807945251,
                      67.8759994506836],
                     [777.9242553710938, 7506.486328125, 885.6959838867188,
                      1.452126145362854, 88.41362762451172]]], np.float32)
    ask = np.array([2_000, 4_096, 300, 3, 50], np.float32)
    free = np.full((1, 5), 1e9, np.float32)
    free[0, 0] = ask[0] - 1                    # one victim covers it
    prio = np.zeros((1, 2), np.int32)
    want = _compare(ref_batched, res, prio, ask, free, 50)
    assert want.tolist() == [[False, True]]


def test_float32_prefix_sum_decides_enough(ref_batched):
    """Victims ordered by priority whose float32 running sum stays one
    short of the deficit (1 + 2**24 rounds back to 2**24) while a wider
    accumulator would reach it: the reference takes no victim."""
    res = np.zeros((1, 3, 5), np.float32)
    res[0, :, 0] = [1.0, 2.0 ** 24, 1.0]
    prio = np.array([[0, 1, 2]], np.int32)
    ask = np.array([2_000, 0, 0, 0, 0], np.float32)
    free = np.zeros((1, 5), np.float32)
    free[0, 0] = ask[0] - (2.0 ** 24 + 2.0)     # deficit 2**24 + 2
    want = _compare(ref_batched, res, prio, ask, free, 50)
    assert not want.any()


def test_prefix_sum_follows_xla_blocks():
    """_xla_prefix_sum against jnp.cumsum on float inputs whose sums round
    differently in different orders, at lengths inside and past a
    block."""
    rng = np.random.default_rng(9)
    for v in (5, 16, 17, 40, 300):
        x = (rng.standard_normal((3, v, 5)) * 1_000).astype(np.float32)
        want = np.asarray(jax.vmap(lambda a: jax.numpy.cumsum(a, axis=0))(x))
        got = kernels._xla_prefix_sum(torch.from_numpy(x)).numpy()
        assert got.tobytes() == want.tobytes(), v
