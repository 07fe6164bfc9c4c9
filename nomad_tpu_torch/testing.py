"""Helpers shared by the port's tests and chip_smoke.py."""
from __future__ import annotations

import contextlib
import os

import numpy as np


@contextlib.contextmanager
def seeded_urandom(seed):
    """os.urandom from a seeded stream for the block's length: two runs of
    one eval, each in such a block with the same seed, mint the same
    allocation ids."""
    rng = np.random.default_rng(seed)
    real = os.urandom
    os.urandom = lambda n: rng.bytes(n)
    try:
        yield
    finally:
        os.urandom = real


def fill_count(view, cpu, mem) -> int:
    """Instances of (cpu MHz, mem MB) that fit on a usage view's free
    capacity, node by node."""
    free = view.cap[:, :2] - view.used[:, :2]
    return int(np.floor(np.min(free / np.array([cpu, mem], np.float32),
                               axis=1)).clip(min=0).sum())


# ------------------------------------------------ chunked-scan fixtures
#
# Seeded numpy inputs of place_chunked, shared by the CPU tests (against
# the JAX package's place_chunked), the card tests and chip_smoke.py
# (the scan kernel against the plain scan). chunked_case(name) -> (args in
# place_chunked's positional order, kwargs).

BENCH_CPU = (4_000, 8_000, 16_000, 32_000)
BENCH_MEM = (8_192, 16_384, 32_768, 65_536)


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


def _racks(n, live, count, racks=100, cap_per_rack=None):
    """Datacenters targeted 50/30/20 (weight 0.7) and racks even (0.3) by
    node index, as the service path lays them out; with `cap_per_rack`,
    a distinct_property quota per rack instead of the spreads."""
    on = np.arange(n) < live
    dc = np.where(on, np.arange(n) % 3, -1).astype(np.int32)
    rack = np.where(on, np.arange(n) % racks, -1).astype(np.int32)
    p = max(2, 1 << (racks - 1).bit_length())
    if cap_per_rack is not None:
        rem = np.zeros((1, p), np.int32)
        rem[0, :racks] = cap_per_rack
        return _no_spread(n), (rack[None], rem)
    counts = np.full((2, p), -1, np.int32)
    counts[0, :3] = 0
    counts[1, :racks] = 0
    desired = np.full((2, p), -1.0, np.float32)
    desired[0, :3] = [0.5 * count, 0.3 * count, 0.2 * count]
    sp = (np.stack([dc, rack]), counts, desired, np.array([1, 0], np.int32),
          np.array([0.7, 0.3], np.float32))
    return sp, _no_distinct(n)


def chunked_case(name):
    """-> (args tuple in the reference's positional order, kwargs)."""
    rng = np.random.default_rng(SCAN_CASES.index(name) + 11)
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
    elif name == "ties_run_out":
        # the bench fleet empty (16 shapes: exact ties) under an ask it
        # cannot hold: 79 a step until the capacity runs out mid-scan
        cap, _ = _fleet(rng, n)
        used = np.zeros_like(cap)
        ask = np.array([2_000, 4_096, 300, 0, 0], np.float32)
        count = 5_000
        rack = (np.arange(n) % 10).astype(np.int32)
        sp = (rack[None], np.array([[0] * 10 + [-1] * 6], np.int32),
              np.full((1, 16), -1.0, np.float32), np.array([0], np.int32),
              np.ones(1, np.float32))
    elif name == "rack_capped":
        # chunk 1, 150 steps: the service path's rack-capped job
        n, live = 1_024, 700
        cap, used = _fleet(rng, n)
        feas = np.arange(n) < live
        count = 150
        sp, dp = _racks(n, live, count, cap_per_rack=2)
        aff, coll = np.zeros(n, np.float32), np.zeros(n, np.int32)
        kw = dict(max_steps=256)
    elif name == "nothing_feasible":
        cap, used = _fleet(rng, n)
        feas = np.zeros(n, bool)
        count = 300
    elif name == "done_mid_scan":
        # remaining reaches 0 after 60 of 64 steps (5 a step)
        n, live = 1_024, 900
        cap, used = _fleet(rng, n)
        feas = np.arange(n) < live
        count = 300
        sp, dp = _racks(n, live, count)
        aff, coll = np.zeros(n, np.float32), np.zeros(n, np.int32)
    elif name == "mpn1":
        cap, used = _fleet(rng, n)
        count = 400                                  # 25 a step
        coll = (rng.random(n) < 0.3).astype(np.int32)
        kw = dict(max_steps=16, max_per_node=1)
    elif name.startswith("bucket") or name == "split":
        # "split": 5,120 instances over 1,024 nodes at max_steps 4, more
        # than one solve covers (split_solves carries them over)
        n = 1_024 if name == "split" else int(name[len("bucket"):])
        live = max(n * 5 // 8, 1)
        cap, used = _fleet(rng, n)
        feas = (np.arange(n) < live) & (rng.random(n) > 0.05)
        count = min(8 * live, 20_000)
        sp, _ = _racks(n, live, count, racks=min(100, n))
        racks = min(100, n)
        p = max(2, 1 << (racks - 1).bit_length())
        rem = np.zeros((1, p), np.int32)
        rem[0, :racks] = rng.integers(count // racks, 2 * count // racks + 2,
                                      racks)
        dp = (sp[0][1:2].copy(), rem)
        coll = (rng.random(n) < 0.2).astype(np.int32)
        aff = np.where(rng.random(n) < 0.2, rng.uniform(-1, 1, n),
                       0.0).astype(np.float32)
        kw = dict(max_steps=4 if name == "split" else 256)
    else:
        raise AssertionError(name)
    args = (cap, used, ask, np.int32(count), feas, coll,
            np.int32(desired_count)) + tuple(sp) + (aff,) + tuple(dp)
    return args, kw


# held against the JAX package's place_chunked on the CPU (each places)
CHUNKED_CASES = ("even_spread", "targeted_fractional", "two_stanzas_missing",
                 "distinct_mpn1", "affinity_collisions_spread_alg",
                 "bench_ties", "fma_tie", "ties_run_out")
# the scan kernel's edges: chunk 1, nothing feasible, done mid-scan,
# max_per_node 1, an ask split across solves, the node buckets 8, 1,024
# and 65,536 (run every case through split_solves)
EDGE_CASES = ("rack_capped", "nothing_feasible", "done_mid_scan", "mpn1",
              "split", "bucket8", "bucket1024", "bucket65536")
SCAN_CASES = CHUNKED_CASES + EDGE_CASES


def split_solves(place, args, kw):
    """An ask above max_steps * min(N, 256) split across solves as
    placer._scan_dispatch splits it: each solve fed the last one's
    placements (`placed_init`), usage, spread counts and quotas. `place`
    is a place_chunked; args in its positional order. -> the last
    solve's four returns."""
    args = list(args)
    count = int(args[3])
    cover = int(kw.get("max_steps", 256)) * min(args[0].shape[0], 256)
    left, last, placed = count, 0, kw.get("placed_init")
    kw = {k: v for k, v in kw.items() if k != "placed_init"}
    while True:
        out = place(*args[:3], min(left, cover), *args[4:], **kw,
                    placed_init=placed)
        placed, args[1], args[8], args[14] = out
        if left <= cover:
            return out
        total = int(placed.sum())
        left = count - total
        if left <= 0 or total == last:
            return out
        last = total


# ------------------------------------------------------ explain fixtures
#
# Seeded numpy inputs of kernels.explain_reduce in its positional order
# (cap, used, ask, feasible, collisions, placed, class_ids,
# distinct_hosts), shared by the CPU tests, the card tests and
# chip_smoke.py.

def explain_case(seed=0, n=16, n_classes=4):
    """tests/test_explain.py's reduce inputs: random float usage on a
    two-size fleet, a fifth infeasible, collisions, up to 2 placed per
    row, class ids in [-1, n_classes)."""
    rng = np.random.default_rng(seed)
    cap = np.zeros((n, 5), np.float32)
    cap[:, 0] = rng.choice([2000.0, 4000.0], n)
    cap[:, 1] = rng.choice([4096.0, 8192.0], n)
    cap[:, 2] = 50_000.0
    used = (cap * rng.uniform(0.0, 0.9, (n, 5))).astype(np.float32)
    ask = np.zeros(5, np.float32)
    ask[0], ask[1] = 1500.0, 2048.0
    feas = rng.random(n) > 0.2
    coll = rng.integers(0, 2, n).astype(np.int32)
    placed = rng.integers(0, 3, n).astype(np.int32)
    cls = rng.integers(-1, n_classes, n).astype(np.int32)
    return (cap, used, ask, feas, coll, placed, cls, np.bool_(True))


# a float32 rounding boundary of used + placed * ask (found by a seeded
# search): rounded twice (the product, then the sum) the row lands
# exactly one ask below cap; rounded once it overflows cap
BOUNDARY = (np.float32(948.94366), np.float32(4.6004515), np.int32(49))


def explain_boundary_case(n=8):
    """Every row on BOUNDARY: the two-rounding reduce calls each row fit,
    a once-rounded (fused multiply-add) one calls it exhausted on cpu."""
    u, a, p = BOUNDARY
    cap = np.full((n, 5), 1e6, np.float32)
    used = np.zeros((n, 5), np.float32)
    ask = np.zeros(5, np.float32)
    ask[0] = a
    cap[:, 0] = np.float32(np.float32(np.float32(p) * a) + u) + a
    used[:, 0] = u
    placed = np.full(n, p, np.int32)
    cls = np.arange(n, dtype=np.int32) % 2
    return (cap, used, ask, np.ones(n, bool), np.zeros(n, np.int32),
            placed, cls, np.bool_(False))


# ------------------------------------------------------- convex fixtures

def convex_case(n=10_000, bucket=16_384, seed=1910, count=3_000):
    """bench.py `_convex_run`'s fragmented cluster (seed 1910): uniform
    caps, beta-skewed usage (most nodes part-full, a tail nearly
    exhausted), 5% infeasible, same-job collisions 0..3; n live rows in
    a `bucket`-row solve (padding rows zero and infeasible), as the
    placer pads. -> (cap, used, feasible, coll, ask, count)."""
    rng = np.random.default_rng(seed)
    cap = np.zeros((bucket, 5), np.float32)
    cap[:n] = (4_000.0, 8_192.0, 500_000.0, 12_001.0, 10_000.0)
    used = np.zeros_like(cap)
    used[:n, 0] = (rng.beta(2, 3, n) * 3_900).astype(np.float32)
    used[:n, 1] = (rng.beta(2, 3, n) * 8_000).astype(np.float32)
    used[:n, 2] = (rng.beta(2, 5, n) * 400_000).astype(np.float32)
    feasible = np.zeros(bucket, bool)
    feasible[:n] = rng.random(n) > 0.05
    coll = np.zeros(bucket, np.int32)
    coll[:n] = rng.integers(0, 4, n)
    ask = np.zeros(5, np.float32)
    ask[:3] = (250.0, 512.0, 300.0)
    return cap, used, feasible, coll, ask, count


def convex_fuzz_cluster(rng, b=128):
    """tests/test_convex.py's fragmented cluster of `b` rows: uniform
    caps, beta-skewed usage, 10% infeasible, random same-job collisions.
    -> (cap, used, feasible, coll, ask)."""
    cap = np.zeros((b, 5), np.float32)
    cap[:] = (4_000.0, 8_192.0, 500_000.0, 12_001.0, 10_000.0)
    used = np.zeros_like(cap)
    used[:, 0] = (rng.beta(2, 3, b) * 3_900).astype(np.float32)
    used[:, 1] = (rng.beta(2, 3, b) * 8_000).astype(np.float32)
    used[:, 2] = (rng.beta(2, 5, b) * 400_000).astype(np.float32)
    feasible = rng.random(b) > 0.1
    coll = rng.integers(0, 4, b).astype(np.int32)
    ask = np.zeros(5, np.float32)
    ask[:3] = (250.0, 512.0, 300.0)
    return cap, used, feasible, coll, ask


# the convex solve's fixtures for the card tests and chip_smoke.py: the
# kernel against the plain version. The bench_* cases are the main
# path's shape (10,000 nodes, 16,384 rows); small_spread_deep runs all
# 200 iterations (the objective keeps moving by float32 noise)
CONVEX_CASES = ("bench_binpack", "bench_spread", "bench_binpack_deep",
                "bench_spread_deep", "fuzz_quota", "fuzz_distinct",
                "fuzz_affinity", "fuzz_zero", "fuzz_above_cap",
                "homogeneous", "small_spread_deep")


def convex_fixture(name):
    """-> (cap, used, feasible, coll, ask, count, kw): convex_eval's
    inputs for CONVEX_CASES[name]; kw holds spread_algorithm, tolerance,
    max_iters, fairness_weight, quota_budget, max_per_node and
    affinity_boost (None: zeros)."""
    kw = dict(spread_algorithm=name.endswith(("spread", "spread_deep")),
              tolerance=1e-9 if name.endswith("deep") else 1e-4,
              max_iters=200, fairness_weight=0.05,
              quota_budget=float(2 ** 30), max_per_node=2 ** 30,
              affinity_boost=None)
    if name.startswith("bench"):
        return (*convex_case(), kw)
    if name == "small_spread_deep":
        return (*convex_case(100, 128, count=300), kw)
    if name == "homogeneous":
        cap = np.zeros((64, 5), np.float32)
        cap[:] = (4_000.0, 8_192.0, 500_000.0, 12_001.0, 10_000.0)
        used = np.zeros_like(cap)
        used[:, 0], used[:, 1] = 1_000.0, 2_048.0
        ask = np.zeros(5, np.float32)
        ask[:3] = (250.0, 512.0, 300.0)
        return (cap, used, np.ones(64, bool), np.zeros(64, np.int32), ask,
                37, kw)
    rng = np.random.default_rng(41)
    case = convex_fuzz_cluster(rng)
    count = {"fuzz_zero": 0, "fuzz_above_cap": 100_000}.get(name, 60)
    if name == "fuzz_quota":
        kw["quota_budget"] = 5.0
    if name == "fuzz_distinct":
        kw["max_per_node"] = 1
    if name == "fuzz_affinity":
        kw["affinity_boost"] = np.where(
            rng.random(128) < 0.3, rng.uniform(-0.5, 0.5, 128),
            0.0).astype(np.float32)
    return (*case, count, kw)
