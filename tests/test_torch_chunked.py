"""The port's chunked scan (kernels.place_chunked and its plain step)
against the JAX package's place_chunked, on the CPU at one torch thread.

Seeded numpy inputs go through both; every output — placements, final
usage (bit for bit), spread counts and distinct quotas — must be equal,
with no tolerance. The cases cover what can move a placement: score ties
(bench-like integer resources), multi-instance steps (count above
max_steps), targeted spreads with fractional weights, missing spread
values, distinct_property quotas, affinity and collisions under the
spread algorithm, a carried-over `placed_init`, a pair of nodes
whose order only the reference's fused multiply-add decides, ties whose
capacity runs out mid-scan, and the scan kernel's edges (chunk 1,
nothing feasible, max_per_node 1, a split ask, small buckets). The
selection key and the kernel's exit rule have tests of their own. The
fixtures live in nomad_tpu_torch/testing.py, which the card's tests and
chip_smoke.py share.
"""
import numpy as np
import jax  # noqa: F401  (the reference runs on the CPU backend)
import pytest
import torch

from nomad_tpu.solver import kernels as ref_kernels
from nomad_tpu_torch.solver import kernels
from nomad_tpu_torch.testing import (BENCH_CPU, BENCH_MEM, CHUNKED_CASES,
                                     EDGE_CASES, chunked_case, split_solves)

# the cases live in the port's testing module, so the card's
# tests and chip_smoke.py (which have no JAX) run the same fixtures
_case = chunked_case
CASES = CHUNKED_CASES


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


@pytest.mark.parametrize("name", [c for c in EDGE_CASES
                                  if c != "bucket65536"])
def test_scan_edge_cases_match_reference(name):
    """The scan kernel's edge fixtures through the plain scan: chunk 1
    (rack_capped), nothing feasible, remaining reaching 0 mid-scan,
    max_per_node 1, an ask split across solves, the 8 and 1,024 buckets
    (65,536 runs on the card: tests/test_torch_cuda.py). Each runs as the
    placer runs it (split_solves), on both sides."""
    args, kw = _case(name)
    want = split_solves(ref_kernels.place_chunked, args, kw)
    got = split_solves(kernels.place_chunked, _torch(args), kw)
    _assert_equal(got, want)


def test_chunked_key_orders_as_the_stable_descending_sort():
    """The selection key (kernels.chunked_key, the scan kernel's rule) on
    tie-heavy scores holding +0.0, -0.0, -inf, subnormals and the float32
    extremes: unique, and ordering the nodes exactly as
    torch.sort(descending=True, stable=True) does (-0.0 equal to +0.0)."""
    rng = np.random.default_rng(9)
    pool = np.array([0.0, -0.0, -np.inf, 1.5, -1.5, 1e-40, -1e-40, 3.4e38,
                     -3.4e38, 0.25, np.nextafter(np.float32(0.25),
                                                 np.float32(1)), -0.25],
                    np.float32)
    s = torch.from_numpy(np.concatenate([
        rng.choice(pool, 3_000),
        rng.standard_normal(1_000).astype(np.float32)]))
    key = kernels.chunked_key(s)
    assert key.dtype == torch.int64
    assert int(torch.unique(key).numel()) == s.numel()
    want = torch.sort(s, descending=True, stable=True).indices
    assert torch.equal(torch.argsort(key, descending=True), want)
    zeros = (s == 0).nonzero().view(-1)
    assert bool((s[zeros].view(torch.int32) < 0).any())   # -0.0 present


@pytest.mark.parametrize("name", ["ties_run_out", "nothing_feasible",
                                  "mpn1", "distinct_mpn1"])
def test_plain_scan_ends_where_its_first_empty_step_leaves_it(name):
    """The scan kernel stops at the first step that selects nothing; the
    plain loop runs on to max_steps. Each step it runs after that one
    changes nothing: its returns equal the state that first empty step
    left (the state the kernel returns), bit for bit."""
    args, kw = _case(name)
    before = []                  # (placed, used, counts, quotas) per step

    def step(*a, **k):
        before.append((a[5], a[1], a[9], a[15]))
        return kernels.chunked_step_ref(*a, **k)
    got = kernels._place_chunked_loop(
        step, *_torch(args), kw.get("max_per_node", 2 ** 30),
        kw["max_steps"], kw.get("spread_algorithm", False), None)
    assert len(before) == kw["max_steps"]          # the loop ran on
    empty = next(t for t in range(1, len(before))
                 if int(before[t][0].sum()) == int(before[t - 1][0].sum()))
    assert empty < kw["max_steps"] - 1             # the exit is mid-scan
    for g, w in zip(got, before[empty]):
        assert g.dtype == w.dtype
        assert g.numpy().tobytes() == w.numpy().tobytes()
    assert int(got[0].sum()) < int(args[3])


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
