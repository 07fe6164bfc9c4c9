"""The port's chunked scan (kernels.place_chunked and its plain step)
against the JAX package's place_chunked, on the CPU at one torch thread.

Seeded numpy inputs go through both; every output — placements, final
usage (bit for bit), spread counts and distinct quotas — must be equal,
with no tolerance. The cases cover what can move a placement: score ties
(bench-like integer resources), multi-instance steps (count above
max_steps), targeted spreads with fractional weights, missing spread
values, distinct_property quotas, affinity and collisions under the
spread algorithm, a carried-over `placed_init`, and a pair of nodes
whose order only the reference's fused multiply-add decides.
"""
import numpy as np
import jax  # noqa: F401  (the reference runs on the CPU backend)
import pytest
import torch

from nomad_tpu.solver import kernels as ref_kernels
from nomad_tpu_torch.solver import kernels

BENCH_CPU = (4_000, 8_000, 16_000, 32_000)
BENCH_MEM = (8_192, 16_384, 32_768, 65_536)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fleet(rng, n, integer=True, fill=0.5):
    cap = np.zeros((n, 5), np.float32)
    cap[:, 0] = rng.choice(BENCH_CPU, n)
    cap[:, 1] = rng.choice(BENCH_MEM, n)
    cap[:, 2] = 500_000
    cap[:, 3] = 100
    cap[:, 4] = 1_000
    used = np.zeros_like(cap)
    frac = rng.random((n, 2)).astype(np.float32) * fill
    used[:, :2] = cap[:, :2] * frac
    if integer:
        used = np.floor(used)
    return cap, used


def _no_spread(n):
    return (np.full((1, n), -1, np.int32), np.full((1, 2), -1, np.int32),
            np.full((1, 2), -1.0, np.float32), np.full(1, -1, np.int32),
            np.zeros(1, np.float32))


def _no_distinct(n):
    return np.full((1, n), -1, np.int32), np.full((1, 2), -1, np.int32)


def _targeted(rng, n, values, percents, count, weight, sum_weights):
    """One targeted stanza over `values` (id per node by rng), lowered as
    tensorize._lower_spreads lowers it."""
    ids = rng.integers(0, len(values), n).astype(np.int32)
    p = max(2, 1 << (len(values) - 1).bit_length())
    counts = np.full(p, -1, np.int32)
    counts[:len(values)] = 0
    desired = np.full(p, -1.0, np.float32)
    desired[:len(values)] = [pc / 100.0 * count for pc in percents]
    return ids, counts, desired, 1, weight / sum_weights


def _case(name):
    """-> (args tuple in the reference's positional order, kwargs)."""
    rng = np.random.default_rng(CASES.index(name) + 11)
    n = 128
    ask = np.array([250, 512, 300, 0, 0], np.float32)
    feas = rng.random(n) > 0.1
    coll = np.zeros(n, np.int32)
    aff = np.zeros(n, np.float32)
    sp = _no_spread(n)
    dp = _no_distinct(n)
    kw = dict(max_steps=64)
    desired_count = 10
    if name == "even_spread":
        cap, used = _fleet(rng, n)
        count = 300                                  # 5 per step
        ids = rng.integers(0, 3, n).astype(np.int32)
        sp = (ids[None], np.array([[4, 0, 2, -1]], np.int32),
              np.full((1, 4), -1.0, np.float32), np.array([0], np.int32),
              np.ones(1, np.float32))
    elif name == "targeted_fractional":
        cap, used = _fleet(rng, n)
        count = 200
        ids, counts, desired, mode, w = _targeted(
            rng, n, ("dc1", "dc2", "dc3"), (50, 30, 20), count, 70, 100)
        sp = (ids[None], counts[None], desired[None],
              np.array([mode], np.int32), np.array([w], np.float32))
    elif name == "two_stanzas_missing":
        cap, used = _fleet(rng, n, integer=False)
        ask = np.array([251.5, 517.25, 300, 0, 0], np.float32)
        count = 150
        ids0, counts0, desired0, _, w0 = _targeted(
            rng, n, ("a", "b", "c"), (50, 30, 20), count, 70, 100)
        ids0[rng.random(n) < 0.15] = -1              # value missing
        ids1 = rng.integers(0, 7, n).astype(np.int32)
        ids1[rng.random(n) < 0.1] = -1
        counts1 = np.full(8, -1, np.int32)
        counts1[:7] = rng.integers(0, 3, 7)
        pad = np.full(8, -1, np.int32)
        pad[:4] = counts0
        dpad = np.full(8, -1.0, np.float32)
        dpad[:4] = desired0
        sp = (np.stack([ids0, ids1]), np.stack([pad, counts1]),
              np.stack([dpad, np.full(8, -1.0, np.float32)]),
              np.array([1, 0], np.int32), np.array([w0, 0.3], np.float32))
    elif name == "distinct_mpn1":
        cap, used = _fleet(rng, n)
        count = 90
        ids = rng.integers(0, 12, n).astype(np.int32)
        ids[rng.random(n) < 0.1] = -1
        rem = np.full((2, 16), -1, np.int32)
        rem[0, :] = 0
        rem[0, :12] = rng.integers(0, 6, 12)
        dp = (np.stack([ids, np.full(n, -1, np.int32)]), rem)
        kw.update(max_per_node=1, max_steps=32)      # 3 per step
    elif name == "affinity_collisions_spread_alg":
        cap, used = _fleet(rng, n, integer=False)
        count = 120
        coll = (rng.integers(0, 4, n) * (rng.random(n) < 0.4)).astype(
            np.int32)
        aff = np.where(rng.random(n) < 0.3, rng.uniform(-1, 1, n),
                       0.0).astype(np.float32)
        desired_count = 7
        kw.update(spread_algorithm=True)
    elif name == "bench_ties":
        # the bench fleet empty: 16 node shapes, exact score ties everywhere
        cap, _ = _fleet(rng, n)
        used = np.zeros_like(cap)
        count = 700
        ids = (np.arange(n) % 3).astype(np.int32)
        rack = (np.arange(n) % 10).astype(np.int32)
        sp = (np.stack([ids, rack]),
              np.stack([np.array([0, 0, 0, -1] + [-1] * 12, np.int32),
                        np.array([0] * 10 + [-1] * 6, np.int32)]),
              np.stack([np.array([350, 210, 140, -1] + [-1] * 12,
                                 np.float32), np.full(16, -1.0, np.float32)]),
              np.array([1, 0], np.int32),
              np.array([0.7, 0.3], np.float32))
    elif name == "fma_tie":
        # two nodes only the fused multiply-add of base and anti orders:
        # rounded separately, node 0 would score higher
        n = 8
        cap = np.zeros((n, 5), np.float32)
        cap[:2] = [8_000, 16_384, 500_000, 100, 1_000]
        used = np.zeros_like(cap)
        used[0, :2] = [3897.56005859375, 3293.0244140625]
        used[1, :2] = [1715.9468994140625, 3386.6640625]
        feas = np.arange(n) < 2
        coll = np.array([2, 1] + [0] * 6, np.int32)
        aff = np.zeros(n, np.float32)
        sp, dp = _no_spread(n), _no_distinct(n)
        count, desired_count = 1, 7
        kw = dict(max_steps=1)
    else:
        raise AssertionError(name)
    args = (cap, used, ask, np.int32(count), feas, coll,
            np.int32(desired_count)) + tuple(sp) + (aff,) + tuple(dp)
    return args, kw


CASES = ("even_spread", "targeted_fractional", "two_stanzas_missing",
         "distinct_mpn1", "affinity_collisions_spread_alg", "bench_ties",
         "fma_tie")


def _torch(args):
    return tuple(torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
                 else int(a) for a in args)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert g.numpy().tobytes() == w.tobytes()


@pytest.mark.parametrize("name", CASES)
def test_place_chunked_matches_reference(name):
    args, kw = _case(name)
    want = ref_kernels.place_chunked(*args, **kw)
    got = kernels.place_chunked(*_torch(args), **kw)
    _assert_equal(got, want)
    assert int(got[0].sum()) > 0


def test_fma_tie_picks_the_node_the_fused_sum_prefers():
    """The case's point: the single rounding of base + anti puts node 1
    first, two roundings would put node 0 first."""
    args, kw = _case("fma_tie")
    placed = np.asarray(ref_kernels.place_chunked(*args, **kw)[0])
    assert placed[:2].tolist() == [0, 1]
    t = _torch(args)
    d_active = torch.zeros(1, dtype=torch.bool)
    step = (t[0], t[1], t[2], t[4], t[5], torch.zeros(8, dtype=torch.int32),
            2 ** 30, 7) + t[7:12] + (t[12], t[13], t[14], d_active)
    score = kernels.chunked_step_ref(*step)
    assert float(score[1]) > float(score[0])
    raw = kernels.score_fit(t[0][:2], t[1][:2] + t[2][None, :])
    anti = -(t[5][:2].float() + 1.0) / torch.tensor(7.0)
    two = raw * kernels._INV_MAX_SCORE + anti
    assert float(two[0]) >= float(two[1])


def test_placed_init_carries_over_like_reference():
    """An ask split across two solves, the second fed the first's
    placements, usage, spread counts and quotas."""
    args, kw = _case("bench_ties")
    args = args[:3] + (np.int32(400),) + args[4:]
    want = ref_kernels.place_chunked(*args, **kw)
    got = kernels.place_chunked(*_torch(args), **kw)
    _assert_equal(got, want)
    again = list(args)
    again[1], again[3] = np.asarray(want[1]), np.int32(300)
    again[8] = np.asarray(want[2])
    want2 = ref_kernels.place_chunked(*again, placed_init=want[0], **kw)
    t = list(_torch(args))
    t[1], t[3], t[8] = got[1], 300, got[2]
    got2 = kernels.place_chunked(*t, placed_init=got[0], **kw)
    _assert_equal(got2, want2)
    assert int(got2[0].sum()) == 700


def test_scan_stops_after_the_steps_that_place_everything():
    """A step with nothing left to place changes no state, so the loop
    reads `remaining` after ceil(count/chunk) steps and stops at 0; the
    reference runs all max_steps and ends in the same state."""
    args, kw = _case("even_spread")
    want = ref_kernels.place_chunked(*args, **kw)
    calls = []

    def step(*a, **k):
        calls.append(1)
        return kernels.chunked_step_ref(*a, **k)
    t = _torch(args)
    got = kernels._place_chunked_loop(step, *t, 2 ** 30, kw["max_steps"],
                                      False, None)
    _assert_equal(got, want)
    chunk = -(-int(args[3]) // kw["max_steps"])
    assert len(calls) == -(-int(args[3]) // chunk) < kw["max_steps"]


def test_fma_f32_rounds_once():
    """_fma_f32 against exact rational arithmetic on float32 triples,
    including products that need more than float64's 53 bits."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    a = rng.standard_normal(4_000).astype(np.float32)
    b = (rng.standard_normal(4_000) * 1e-3).astype(np.float32)
    c = (rng.standard_normal(4_000) * 1e3).astype(np.float32)
    got = kernels._fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        # the float32 nearest the exact value (ties to even)
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        near = [v for v, e in zip(cands, errs) if e == best]
        if len(near) == 2:
            near = [v for v in near
                    if int(np.array(v).view(np.int32)) % 2 == 0]
        assert g == near[0]


def test_web_spread_at_proxy_scale_matches_reference():
    """chip_smoke.py's web job (5,000 instances, datacenters targeted
    50/30/20 under weight 70, racks even under weight 30, dc by i % 3 and
    rack by i % 100) on an empty 2,500-node bench fleet: the scan places
    20 instances a step, and the port matches the reference bit for bit.
    The spread blocks are soft preferences: the reference itself lands
    each datacenter up to ~2% of the job off its target, the figure
    chip_smoke.py's tolerance rests on."""
    n, bucket, count = 2_500, 4_096, 5_000
    rng = np.random.default_rng(42)
    cap = np.zeros((bucket, 5), np.float32)
    cap[:n, 0] = rng.choice(BENCH_CPU, n)
    cap[:n, 1] = rng.choice(BENCH_MEM, n)
    cap[:n, 2:] = [500_000, 100, 1_000]
    ask = np.array([250, 512, 300, 0, 0], np.float32)
    feas = np.arange(bucket) < n
    ids = np.full((2, bucket), -1, np.int32)
    ids[0, :n] = np.arange(n) % 3
    ids[1, :n] = np.arange(n) % 100
    counts = np.full((2, 128), -1, np.int32)
    counts[0, :3] = 0
    counts[1, :100] = 0
    desired = np.full((2, 128), -1.0, np.float32)
    desired[0, :3] = [2_500, 1_500, 1_000]
    args = (cap, np.zeros_like(cap), ask, np.int32(count), feas,
            np.zeros(bucket, np.int32), np.int32(count), ids, counts,
            desired, np.array([1, 0], np.int32),
            np.array([0.7, 0.3], np.float32), np.zeros(bucket, np.float32),
            np.full((1, bucket), -1, np.int32), np.full((1, 2), -1, np.int32))
    want = ref_kernels.place_chunked(*args)
    got = kernels.place_chunked(*_torch(args))
    _assert_equal(got, want)
    by_dc = got[2][0, :3].numpy()
    racks = got[2][1, :100].numpy()
    assert int(by_dc.sum()) == count
    miss = np.abs(by_dc - desired[0, :3])
    assert 1 < miss.max() <= 0.025 * count
    assert racks.max() - racks.min() <= 25
