"""The plain reference of the chunked scan: where tpu-batch puts the
instances of a job with a spread stanza, node by node, in NumPy and
float32.

It follows the scheduler's published rules, and imports nothing of the
program:

  * a step scores every candidate node as the mean of the score terms
    present (rank.go's mean of scores):
      - the binpack fit with the candidate placed (funcs.go's
        ScoreFitBinPack over cpu and memory), times float32(1/18);
      - job anti-affinity, -(collisions + 1) / desired, where the node
        holds instances of the job (rank.go:536). The binpack term and
        this one are added in one fused multiply-add, rounded once;
      - the spread: over the stanzas, the even-spread boost
        (spread.go:178, evenSpreadScoreBoost) or the targeted boost
        (desired - (count + 1)) / desired * weight, -1 for a node with
        no value for the attribute (or no desired count for it); the
        weights normalised by their sum. A total of exactly 0 is absent
        from the mean, as spread.go appends the score only when it is
        non-zero;
  * a node is out where its capacity is spent or it holds max_per_node
    instances of the job;
  * each step places ceil(count / 256) instances (at most min(N, 256)),
    one a node, on the best nodes by (score descending, node row
    ascending), then updates usage, collisions and the counts of each
    spread value; at most 256 steps, stopping once nothing is left to
    place or no node can take one. At one instance a step this is the
    sequential greedy stack.

Even spread, from the counts of every value in the stanza's universe (0
for a value that holds none): nothing placed yet gives 0; a node whose
value holds more than the least count gives (min - count) / min, or -1
where min is 0; a node at the least count gives -1 where every value
holds as many (min == max), +1 where min is 0, else (max - min) / min.
Quotients of counts are taken in float32.

The order of the eval's draws on the scan route (the generic scheduler
and the solver's prep): the eval's `random.Random(eval_id)` shuffles a
copy of the ready nodes (the stack's shuffle: it advances the stream,
the solver reads the nodes in registration order); its next
getrandbits(64) seeds numpy's default_rng, whose permutation(n) is the
node axis; nothing more is drawn (the depth route's jitter seed is drawn
on that route only). The axis is padded with empty rows to a power of
two (at least 8). placement.streams gives the first two draws.

Not covered, each a ValueError (placement.judge routes a pass here):
distinct_property, affinities, the `spread` scheduler algorithm, and an
ask larger than one solve covers (256 steps of min(N, 256)).
"""
from __future__ import annotations

import math

import numpy as np

F32 = np.float32
MAX_STEPS = 256
TOP = 256                       # the best nodes a step chooses among
MAX_PER_NODE = 2 ** 30
BINPACK_MAX_SCORE = F32(18.0)
INV_MAX_SCORE = F32(1.0) / BINPACK_MAX_SCORE
BIG = F32(1e9)
IMPLICIT = "*"
# the node attributes the fleet table holds, by their interpolation
ATTRIBUTES = {"${meta.rack}": "rack", "${node.datacenter}": "dc"}


class Stanza:
    """One spread stanza on the node axis: `ids` i64[N], each node's value
    (an index into the universe; -1 where the node has none); `counts`
    i64[P], the instances of the job on each value; `desired` f32[P]
    (None for an even spread), each value's desired count, -1 where it
    has none; `weight`, the stanza's share of the weights."""

    __slots__ = ("ids", "counts", "desired", "weight")

    def __init__(self, ids, counts, desired=None, weight: float = 1.0):
        self.ids = np.asarray(ids, np.int64)
        self.counts = np.asarray(counts, np.int64).copy()
        self.desired = None if desired is None else \
            np.asarray(desired, F32)
        self.weight = F32(weight)


def lower(values: list, live: dict, spread: dict, weight_sum: float,
          total: int) -> Stanza:
    """A stanza from each node's value of the attribute (`values`, "" for
    none), the job's live instances on each value (`live`), the record's
    spread ({"attribute", "weight", optionally "targets": {value:
    percent}}) and the job's count (`total`). The universe is every value
    a node holds and every value holding an instance. A target's desired
    count is its percent of `total`; where the targets ask for less than
    `total`, the rest is the desired count of every other value."""
    universe = sorted({v for v in values if v} | set(live))
    index = {v: i for i, v in enumerate(universe)}
    ids = [index[v] if v else -1 for v in values]
    counts = [int(live.get(v, 0)) for v in universe]
    desired = None
    targets = spread.get("targets") or {}
    if targets:
        want = {v: p / 100.0 * total for v, p in targets.items()}
        got = sum(want.values())
        if 0 < got < total:
            want[IMPLICIT] = total - got
        desired = [want.get(v, want.get(IMPLICIT, -1.0)) for v in universe]
    w = spread["weight"] / weight_sum if weight_sum else 0.0
    return Stanza(ids, counts, desired, w)


def fma(a, b, c) -> np.ndarray:
    """float32 a * b + c, rounded once. The product of two float32s is
    exact in float64; their sum with c is rounded to odd there (its exact
    error from Knuth's two-sum), so that the rounding to float32 is the
    one rounding of the exact result."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    bits = s.view(np.int64)
    odd = (bits & 1) == 1
    nudge = (err != 0) & ~odd
    s = np.where(nudge, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)),
                 s)
    return s.astype(F32)


def fit_score(cap: np.ndarray, used: np.ndarray) -> np.ndarray:
    """ScoreFitBinPack over cpu and memory, f32 in [0, 18]."""
    safe = np.where(cap[:, :2] > 0, cap[:, :2], F32(1.0))
    free = F32(1.0) - used[:, :2] / safe
    p = np.power(10.0, free.astype(np.float64)).astype(F32)
    return np.clip(F32(20.0) - (p[:, 0] + p[:, 1]), F32(0.0),
                   BINPACK_MAX_SCORE)


def instances(cap: np.ndarray, used: np.ndarray,
              ask: np.ndarray) -> np.ndarray:
    """How many more instances of `ask` each node holds (AllocsFit),
    i64."""
    pos = ask > 0
    per = np.where(pos[None, :], np.floor((cap - used) /
                                          np.where(pos, ask, F32(1.0))), BIG)
    return np.maximum(per.min(axis=1), F32(0.0)).astype(np.int64)


def even_boost(counts: np.ndarray) -> np.ndarray:
    """evenSpreadScoreBoost for a node on each value, f32[P], from the
    counts of every value of the universe."""
    if not len(counts) or counts.max() <= 0:
        return np.zeros(len(counts), F32)
    lo, hi = int(counts.min()), int(counts.max())
    div = F32(max(lo, 1))
    if lo == 0:
        above = np.full(len(counts), F32(-1.0))
    else:
        above = (F32(lo) - counts.astype(F32)) / div
    at_min = F32(-1.0) if lo == hi else F32(1.0) if lo == 0 else \
        F32(hi - lo) / div
    return np.where(counts == lo, at_min, above).astype(F32)


def targeted_boost(counts: np.ndarray, desired: np.ndarray,
                   weight) -> np.ndarray:
    """The targeted boost for a node on each value, f32[P]: -1 where the
    value has no desired count."""
    with np.errstate(divide="ignore", invalid="ignore"):
        b = ((desired - (counts.astype(F32) + F32(1.0))) / desired) * \
            F32(weight)
    return np.where(desired > 0, b, F32(-1.0)).astype(F32)


def spread_term(stanzas: list, n: int) -> np.ndarray:
    """The spread total of each node, f32[N], the stanzas summed in
    order."""
    total = np.zeros(n, F32)
    for st in stanzas:
        by_value = even_boost(st.counts) if st.desired is None else \
            targeted_boost(st.counts, st.desired, st.weight)
        node = np.where(st.ids >= 0, by_value[np.maximum(st.ids, 0)],
                        F32(-1.0)) if len(by_value) else \
            np.full(n, F32(-1.0))
        total = (total + node.astype(F32)).astype(F32)
    return total


def best(score: np.ndarray, k: int) -> np.ndarray:
    """The rows of the k best finite scores, by (score descending, row
    ascending)."""
    ok = np.flatnonzero(np.isfinite(score))
    if len(ok) <= k:
        return ok[np.lexsort((ok, -score[ok]))]
    s = score[ok]
    cut = np.partition(s, len(s) - k)[len(s) - k]       # the k-th best
    above = ok[s > cut]
    tied = ok[s == cut][:k - len(above)]
    pick = np.concatenate([above, tied])
    return pick[np.lexsort((pick, -score[pick]))]


def solve(cap, used, ask, count: int, feasible, coll, desired: int,
          stanzas: list, max_per_node: int = MAX_PER_NODE,
          max_steps: int = MAX_STEPS) -> np.ndarray:
    """Instances per row (rows in the eval's shuffled, padded order) for
    one solve of the scan that places `count` instances. `cap`, `used`
    f32[N, 3] (cpu, memory, disk); `ask` f32[3]; `coll` the job's
    instances on each node; `desired` the job's count; `stanzas` the
    spread stanzas (Stanza), each counting every value's instances."""
    feasible = np.asarray(feasible, bool)
    n = feasible.shape[0]
    top = min(n, TOP)
    if count > max_steps * top:
        raise ValueError(f"an ask of {count} is more than one solve of the "
                         f"scan covers ({max_steps} x {top})")
    chunk = min(max(math.ceil(count / max_steps), 1), top)
    # an infeasible row never takes an instance: the steps run over the
    # feasible rows alone, in row order, and the counts of each stanza's
    # values are those of the whole axis
    live = np.flatnonzero(feasible)
    cap = np.asarray(cap, F32)[live]
    used = np.asarray(used, F32)[live]
    ask = np.asarray(ask, F32)
    coll = np.asarray(coll, np.int64)[live]
    stanzas = [Stanza(st.ids[live], st.counts, st.desired, st.weight)
               for st in stanzas]
    limit = min(int(max_per_node), MAX_PER_NODE)
    div = F32(max(int(desired), 1))
    placed = np.zeros(len(live), np.int64)
    room = instances(cap, used, ask)
    fit = fit_score(cap, used + ask[None, :])

    def base(rows):
        held = coll[rows] + placed[rows]
        anti = -(held.astype(F32) + F32(1.0)) / div
        return fma(fit[rows], INV_MAX_SCORE,
                   np.where(held > 0, anti, F32(0.0)))

    binpack_anti = base(np.arange(len(live)))
    anti_on = (coll > 0).astype(F32)
    left = int(count)
    for _ in range(max_steps):
        if left <= 0:
            break
        spread = spread_term(stanzas, len(live))
        on = spread != 0
        total = (binpack_anti + np.where(on, spread, F32(0.0))).astype(F32)
        terms = F32(1.0) + anti_on + on.astype(F32)
        score = np.where((room > 0) & (placed < limit), total / terms,
                         -np.inf)
        sel = best(score, min(left, chunk))
        if not len(sel):
            break
        used[sel] += ask
        placed[sel] += 1
        left -= len(sel)
        room[sel] = instances(cap[sel], used[sel], ask)
        fit[sel] = fit_score(cap[sel], used[sel] + ask[None, :])
        binpack_anti[sel] = base(sel)
        anti_on[sel] = F32(1.0)
        for st in stanzas:
            v = st.ids[sel]
            np.add.at(st.counts, v[v >= 0], 1)
    out = np.zeros(n, np.int64)
    out[live] = placed
    return out
