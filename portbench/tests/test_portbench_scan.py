"""The reference of the chunked scan (scan.py): its rules on hand-sized
inputs, its one rounding of the fused multiply-add, its order of draws,
and, at 200 nodes in 8 racks on 6 seeds, the port's plain scan placing
what it places, node by node."""
from fractions import Fraction

import numpy as np
import pytest

from portbench.lib import fleet, placement, reference, scan
from portbench.lib.reference import LIVE

F32 = np.float32
ASK = np.asarray([250, 512, 300], F32)


def _round_f32(x: Fraction) -> F32:
    """The float32 nearest the exact `x`, ties to even."""
    f = F32(float(x))
    best = f
    for g in (np.nextafter(f, F32(np.inf)), np.nextafter(f, F32(-np.inf))):
        d, db = abs(Fraction(float(g)) - x), abs(Fraction(float(best)) - x)
        if d < db or (d == db and int(g.view(np.int32)) % 2 == 0):
            best = g
    return best


def test_the_fused_multiply_add_rounds_once():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 18, 4000).astype(F32)
    c = -(rng.integers(1, 40, 4000).astype(F32) + F32(1.0)) / F32(600.0)
    c[::3] = F32(0.0)
    got = scan.fma(a, scan.INV_MAX_SCORE, c)
    want = [_round_f32(Fraction(float(x)) * Fraction(float(
        scan.INV_MAX_SCORE)) + Fraction(float(z))) for x, z in zip(a, c)]
    assert (got == np.asarray(want, F32)).all()
    # 1 + 2**-24 + 2**-60: float64 rounds it to a float32 tie, which a
    # second rounding takes down to 1; the one rounding takes it up
    x = F32(1.0) + F32(2.0 ** -23)
    y = -(2.0 ** -24) + 2.0 ** -60
    assert F32(float(x) + y) == F32(1.0)
    assert scan.fma(x, F32(1.0), y) == x


def _greedy_loop(cap, used, ask, count, feas, coll, desired, ids, counts):
    """Sequential greedy, one instance at a time, node by node in scalar
    float32: the stack's choice of the best node for each instance."""
    used = used.copy()
    counts = counts.copy()
    placed = np.zeros(len(cap), np.int64)
    for _ in range(count):
        best, best_s = -1, None
        for i in range(len(cap)):
            per = min(np.floor((cap[i, d] - used[i, d]) / ask[d])
                      for d in range(3))
            if not feas[i] or per < 1:
                continue
            u = used[i] + ask
            p = [F32(10.0 ** float(F32(1.0) - u[d] / cap[i, d]))
                 for d in range(2)]
            fit = min(max(F32(20.0) - (p[0] + p[1]), F32(0.0)), F32(18.0))
            held = coll[i] + placed[i]
            anti = -(F32(held) + F32(1.0)) / F32(desired) if held else \
                F32(0.0)
            total = scan.fma(F32(fit), scan.INV_MAX_SCORE, anti)[()]
            terms = 1 + (held > 0)
            if counts.max() > 0:
                lo, hi, c = counts.min(), counts.max(), counts[ids[i]]
                if c != lo:
                    sp = F32(-1.0) if lo == 0 else F32(lo - c) / F32(lo)
                else:
                    sp = F32(-1.0) if lo == hi else F32(1.0) if lo == 0 \
                        else F32(hi - lo) / F32(lo)
                total, terms = F32(total + sp), terms + 1
            s = F32(total / F32(terms))
            if best_s is None or s > best_s:
                best, best_s = i, s
        if best < 0:
            break
        used[best] += ask
        placed[best] += 1
        counts[ids[best]] += 1
    return placed


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_at_one_instance_a_step_the_scan_is_sequential_greedy(seed):
    rng = np.random.default_rng(seed)
    n, racks = 24, 5
    cap = np.tile(np.asarray([4000, 8192, 10000], F32), (n, 1))
    used = (rng.integers(0, 8, n)[:, None] * ASK[None, :]).astype(F32)
    feas = rng.random(n) > 0.1
    coll = rng.integers(0, 2, n)
    ids = np.arange(n) % racks
    counts = np.bincount(ids, coll, racks).astype(np.int64)
    want = _greedy_loop(cap, used, ASK, 40, feas, coll, 60, ids, counts)
    got = scan.solve(cap, used, ASK, 40, feas, coll, 60,
                     [scan.Stanza(ids, counts)])
    assert got.tolist() == want.tolist()


def test_the_first_step_has_no_spread_term():
    assert scan.spread_term([scan.Stanza([0, 1, 1, 2], [0, 0, 0])],
                            4).tolist() == [0.0] * 4
    # so the first instance goes where it goes with no stanza at all
    cap = np.tile(np.asarray([4000, 8192, 10000], F32), (6, 1))
    used = (np.asarray([0, 3, 1, 5, 2, 0])[:, None] * ASK).astype(F32)
    feas = np.ones(6, bool)
    coll = np.zeros(6, np.int64)
    spread = scan.solve(cap, used, ASK, 1, feas, coll, 1,
                        [scan.Stanza([0, 1, 2, 0, 1, 2], [0, 0, 0])])
    plain = scan.solve(cap, used, ASK, 1, feas, coll, 1, [])
    assert spread.tolist() == plain.tolist() == [0, 0, 0, 1, 0, 0]


def test_the_even_boost_follows_spread_go():
    # every value holds as many: the most a node can lose
    assert scan.even_boost(np.asarray([2, 2, 2])).tolist() == [-1.0] * 3
    # min 0: an empty value gains the most, one above it loses the most
    assert scan.even_boost(np.asarray([0, 1, 2])).tolist() == \
        [1.0, -1.0, -1.0]
    # above the least: (min - count) / min; at it: (max - min) / min
    assert scan.even_boost(np.asarray([2, 3, 5])).tolist() == \
        [1.5, -0.5, -1.5]
    # nothing placed: no term
    assert scan.even_boost(np.asarray([0, 0])).tolist() == [0.0, 0.0]
    # a node with no value loses the most, placed or not
    assert scan.spread_term([scan.Stanza([-1, 0], [0, 0])], 2).tolist() \
        == [-1.0, 0.0]


def test_the_targeted_boost():
    got = scan.targeted_boost(np.asarray([1, 1, 0]),
                              np.asarray([3, 1, -1], F32), F32(0.5))
    assert got.tolist() == [F32(F32(1.0) / F32(3.0) * F32(0.5)), -0.5, -1.0]
    st = scan.lower(["r0", "r1", "r2", ""], {"r1": 2},
                    {"attribute": "${meta.rack}", "weight": 30,
                     "targets": {"r0": 50}}, 60.0, 10)
    # r0 is asked half of 10; the rest is the desired count of the others
    assert st.ids.tolist() == [0, 1, 2, -1]
    assert st.counts.tolist() == [0, 2, 0]
    assert st.desired.tolist() == [5.0, 5.0, 5.0]
    assert st.weight == F32(0.5)
    full = scan.lower(["r0", "r1"], {}, {"attribute": "a", "weight": 1,
                                        "targets": {"r0": 100}}, 1.0, 4)
    assert full.desired.tolist() == [4.0, -1.0]


def test_ties_go_to_the_lower_row():
    score = np.asarray([1, 2, 2, 2, -np.inf, 2], F32)
    assert scan.best(score, 2).tolist() == [1, 2]
    assert scan.best(score, 9).tolist() == [1, 2, 3, 5, 0]
    cap = np.tile(np.asarray([4000, 8192, 10000], F32), (8, 1))
    used = np.zeros_like(cap)
    got = scan.solve(cap, used, ASK, 3, np.ones(8, bool),
                     np.zeros(8, np.int64), 3,
                     [scan.Stanza([0, 0, 1, 1, 2, 2, 3, 3], [0] * 4)])
    # all alike: the first row, then the first of the racks left empty
    assert got.tolist() == [1, 0, 1, 0, 1, 0, 0, 0]


def test_the_order_of_draws_is_pinned():
    """The scan route's node axis for one eval id: the stack's shuffle of
    12 nodes, then the solver's permutation (scan.py's docstring)."""
    perm, _ = placement.streams("pinned-eval", 12)
    assert perm.tolist() == [8, 4, 7, 2, 9, 3, 10, 0, 1, 5, 6, 11]


def test_what_the_reference_does_not_cover_is_refused():
    cap = np.tile(np.asarray([4000, 8192, 10000], F32), (8, 1))
    with pytest.raises(ValueError):
        scan.solve(cap, np.zeros_like(cap), ASK, 256 * 8 + 1,
                   np.ones(8, bool), np.zeros(8, np.int64), 1, [])
    rec = {"spread": {"attribute": "${meta.rack}", "weight": 50}}
    assert placement._scan_route(rec, "tpu-batch")
    assert not placement._scan_route({}, "tpu-batch")
    for bad in ({"distinct_property": "${meta.rack}"},
                {"affinities": [{"attribute": "x"}]}):
        with pytest.raises(ValueError):
            placement._scan_route(dict(rec, **bad), "tpu-batch")
    with pytest.raises(ValueError):
        placement._scan_route(rec, "spread")


def _port_scan(cap, used, count, feas, coll, desired, ids, counts,
               desired_by_value, mode):
    import torch
    from nomad_tpu_torch.solver import kernels
    t = torch.from_numpy
    n, p = len(cap), len(counts)
    placed, *_ = kernels.place_chunked(
        t(cap), t(used), t(ASK), count, t(feas), t(coll.astype(np.int32)),
        desired, t(ids[None, :].astype(np.int32)),
        t(counts[None, :].astype(np.int32)),
        t(np.asarray(desired_by_value, F32)[None, :]),
        t(np.asarray([mode], np.int32)), t(np.ones(1, F32)),
        t(np.zeros(n, F32)), t(np.full((1, n), -1, np.int32)),
        t(np.full((1, 2), -1, np.int32)), max_steps=256)
    assert p == counts.shape[0]
    return placed.numpy().astype(np.int64)


@pytest.mark.parametrize("seed", range(6))
def test_the_ports_plain_scan_places_what_the_reference_places(seed):
    """200 nodes in 8 racks (a few with no rack, a few infeasible, some
    holding the job already) padded to 256 rows; asks from 40 to 700
    instances, so 1 to 3 a step; even spreads on four seeds, targeted on
    two."""
    rng = np.random.default_rng([seed, 21])
    n, live, racks = 256, 200, 8
    cap = np.zeros((n, 3), F32)
    cap[:live, 0] = rng.choice([3900, 7900], live)
    cap[:live, 1] = rng.choice([7936, 15872], live)
    cap[:live, 2] = 98304
    used = np.zeros((n, 3), F32)
    used[:live] = rng.integers(0, 12, live)[:, None] * \
        np.asarray([300, 640, 500], F32)
    feas = np.zeros(n, bool)
    feas[:live] = rng.random(live) > 0.05
    coll = np.zeros(n, np.int64)
    coll[:live] = rng.integers(0, 3, live) * (rng.random(live) < 0.2)
    ids = np.full(n, -1)
    ids[:live] = np.arange(live) % racks
    ids[rng.choice(live, 4, replace=False)] = -1
    counts = np.bincount(ids[ids >= 0], coll[ids >= 0], racks).astype(
        np.int64)
    count = [40, 300, 700, 257, 513, 650][seed]
    desired = count + int(coll.sum())
    if seed < 4:
        want_by_value, mode, stanza = [-1.0] * racks, 0, \
            scan.Stanza(ids, counts)
    else:
        want_by_value = [desired * 0.3, desired * 0.1] + \
            [desired * 0.6 / 6] * 6
        mode = 1
        stanza = scan.Stanza(ids, counts, want_by_value, 1.0)
    port = _port_scan(cap, used, count, feas, coll, desired, ids, counts,
                      want_by_value, mode)
    ref = scan.solve(cap, used, ASK, count, feas, coll, desired, [stanza])
    assert ref.sum() == count
    assert ref.tolist() == port.tolist()


SPEC = {"nodes": 16, "cpu_mhz_choices": [4100], "memory_mb_choices": [8448],
        "disk_mb": 10100, "reserved": {"cpu_mhz": 100, "memory_mb": 256,
                                       "disk_mb": 100},
        "datacenters": ["dc1"], "racks": 4, "node_classes": 1}


def _judge(counts):
    fl = fleet.make(SPEC, 5)
    jobs = {"s": {"type": "service", "count": 6, "cpu_mhz": 250,
                  "memory_mb": 512, "disk_mb": 300, "datacenters": ["dc1"],
                  "spread": {"attribute": "${meta.rack}", "weight": 100}}}
    a = reference.Allocs()
    a.ids, a.job, a.eval_id, a.preempted_by = ["x0"], ["s"], ["e0"], [""]
    a.name, a.row = np.asarray([0]), np.asarray([5])    # rack r1
    a.create, a.end = np.asarray([3]), np.asarray([LIVE])
    a.evicted = np.zeros(1, bool)
    p = placement.Pass("e1", 4, "s")
    p.add([(fl.ids[r], k) for r, k in counts.items()])
    row_of = {nid: i for i, nid in enumerate(fl.ids)}
    return placement.judge(fl, a, jobs, [p], row_of, placement.UNSTATED, 0,
                           1)


def test_judge_sends_a_spread_pass_to_the_scan():
    """A second pass of a job with one instance live in rack r1: the
    scan's choice is judged whole, nodes of one rack alike, of two not."""
    fl = fleet.make(SPEC, 5)
    cap = fl.capacity().astype(F32)
    used = np.zeros_like(cap)
    used[5] = ASK
    coll = np.zeros(16, np.int64)
    coll[5] = 1
    perm, _ = placement.streams("e1", 16)
    ids = np.asarray([int(fl.rack[r][1:]) for r in perm])
    want = scan.solve(cap[perm], used[perm], ASK, 5, np.ones(16, bool),
                      coll[perm], 6, [scan.Stanza(ids, [0, 1, 0, 0])])
    counts = {int(perm[i]): int(k) for i, k in enumerate(want) if k}
    # the racks end even, counting the live instance in r1
    held = np.bincount([int(fl.rack[r][1:]) for r in counts],
                       list(counts.values()), 4) + [0, 1, 0, 0]
    assert held.max() - held.min() <= 1
    assert _judge(counts) == {"misplaced": 0, "compared": 5, "passes": 1}
    # rows 0, 4, 8, 12 are rack r0, alike but for r1's row 5
    r0 = [r for r in counts if fl.rack[r] == "r0"][0]
    twin = next(r for r in (0, 4, 8, 12) if r not in counts)
    moved = dict(counts)
    moved[twin] = moved.pop(r0)
    assert _judge(moved)["misplaced"] == 0
    other = next(r for r in (1, 9, 13) if r not in counts)   # rack r1
    moved = dict(counts)
    moved[other] = moved.pop(r0)
    assert _judge(moved)["misplaced"] == counts[r0]
