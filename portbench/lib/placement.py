"""The plain reference of the solve layer: where tpu-batch's binpack puts
each eval's instances, node by node, in NumPy.

It works each placement out again from the fleet table, the job record
and the allocations committed up to the plan's snapshot index (capacity
less reserve, usage, the job's own instances on each node), and follows
the scheduler's published rules:

  * the candidate nodes are the fleet's nodes in the job's datacenters,
    in the order they were registered;
  * the eval's random stream is Python's `random.Random(eval_id)`: the
    generic stack shuffles the candidate list with it, then the solver
    draws a 64-bit seed for its permutation of the node axis and, for a
    depth solve, one for the order jitter (numpy's default_rng);
  * the node axis is padded to a power of two (at least 8);
  * one instance: the sequential greedy binpack, best score first, each
    node to its capacity; more: the depth solve (the per-node density
    curve of the binpack score with job anti-affinity, then the
    Efraimidis-Spirakis order over the density ranking, each node to
    its depth, with the take capped at ceil(m) + 1 in the jittered
    regime), as `fill_depth` of the scheduler defines it, in float32
    with the same operation order;
  * a pipelined eval (at least `plan_pipeline_min_count` instances in the
    deterministic regime) solves in `plan_pipeline_chunks` chunks, each on
    the usage the chunks before it left.

A pass of a job whose record has a spread goes to the chunked scan, as
the placer routes it: scan.py works it out.

The eval id and the snapshot index are the program's: the reference
follows the program's random stream and the state it planned from, and
works out everything else itself. It imports nothing of the program.
"""
from __future__ import annotations

import math
import random

import numpy as np

from . import scan

F32 = np.float32
BINPACK_MAX_SCORE = F32(18.0)
MAX_PER_NODE = 2 ** 30
BIG = F32(1e9)
DEPTH_GRID = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192,
              256, 384, 512)
NODE_BUCKET_FLOOR = 8
# judge's `pipeline` where the configuration does not state the pipeline
UNSTATED = "unstated"


def node_bucket(n: int) -> int:
    return max(NODE_BUCKET_FLOOR, 1 << (max(n, 1) - 1).bit_length())


def streams(eval_id: str, n: int) -> tuple:
    """-> (perm [n], depth-jitter seed): the eval's draws, in the order
    the scheduler takes them."""
    rng = random.Random(eval_id)
    rng.shuffle(list(range(n)))             # the stack's shuffle
    perm = np.random.default_rng(rng.getrandbits(64)).permutation(n)
    return perm, rng.getrandbits(64)


def _pow10(x: np.ndarray) -> np.ndarray:
    return np.power(10.0, x.astype(np.float64)).astype(F32)


def _prefix_sum(x: np.ndarray) -> np.ndarray:
    """Left-to-right float32 running sum along axis 1."""
    out = np.empty_like(x)
    acc = x[:, 0].copy()
    out[:, 0] = acc
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
        out[:, k] = acc
    return out


def _score(cap: np.ndarray, used: np.ndarray) -> np.ndarray:
    """The binpack score over cpu and memory, in [0, 18]."""
    safe = np.where(cap[:, :2] > 0, cap[:, :2], F32(1.0))
    p = _pow10(F32(1.0) - used[:, :2] / safe)
    return np.clip(F32(20.0) - (p[:, 0] + p[:, 1]), F32(0.0),
                   BINPACK_MAX_SCORE)


def greedy(cap, used, ask, count: int, feasible) -> np.ndarray:
    """One-instance solves: best score with the instance placed first,
    each node to its capacity (a stable sort keeps the row order)."""
    pos = ask > 0
    per = np.where(pos[None, :], np.floor((cap - used) /
                                          np.where(pos, ask, F32(1.0))), BIG)
    capacity = np.where(feasible, per.min(axis=1), F32(0.0))
    capacity = np.maximum(capacity, F32(0.0)).astype(np.int64)
    score = np.where(capacity > 0, _score(cap, used + ask[None, :]),
                     F32(-1.0))
    order = np.argsort(-score, kind="stable")
    c = capacity[order]
    prior = np.cumsum(c) - c
    placed = np.zeros(len(c), np.int64)
    placed[order] = np.minimum(np.maximum(count - prior, 0), c)
    return placed


def depth_curve(cap, used, ask, feasible, coll, desired: int, k_max: int,
                grid) -> tuple:
    """-> (d_star f32[N], k_star i64[N], k_cap i64[N]): each node's best
    density of the binpack score with anti-affinity over depths 1..k_max
    (or the grid, integrated by trapezoids), its first best depth, and
    its capacity. An infeasible row fits no depth: -inf, the first
    depth, 0; only the feasible rows are worked out."""
    j = np.asarray(grid if grid is not None else range(1, k_max + 1), F32)
    rows = np.flatnonzero(feasible)
    d_star = np.full(len(feasible), -np.inf, F32)
    k_star = np.full(len(feasible), int(j[0]), np.int64)
    k_cap = np.zeros(len(feasible), np.int64)
    if len(rows):
        d, k, kc = _curve(cap[rows], used[rows], ask, coll[rows], desired,
                          j, grid is not None)
        d_star[rows], k_star[rows], k_cap[rows] = d, k, kc
    return d_star, k_star, k_cap


def _curve(cap, used, ask, coll, desired: int, j, trapezoids: bool
           ) -> tuple:
    """depth_curve over feasible rows."""
    pos = ask > 0
    per = np.where(pos[None, :],
                   np.floor((cap - used + F32(1e-6)) /
                            np.where(pos, ask, F32(1.0))[None, :]), BIG)
    capacity = np.maximum(per.min(axis=1), F32(0.0))
    fits = j[None, :] <= capacity[:, None]
    safe = np.where(cap[:, :2] > 0, cap[:, :2], F32(1.0))
    used_j = used[:, None, :2] + j[None, :, None] * ask[None, None, :2]
    p = _pow10(F32(1.0) - used_j / safe[:, None, :])
    raw = F32(20.0) - (p[..., 0] + p[..., 1])
    base = np.clip(raw, F32(0.0), BINPACK_MAX_SCORE) / BINPACK_MAX_SCORE
    before = coll[:, None].astype(F32) + (j[None, :] - F32(1.0))
    anti = -(before + F32(1.0)) / F32(max(int(desired), 1))
    anti_on = before > 0
    s = (base + np.where(anti_on, anti, F32(0.0)) + F32(0.0)) / \
        (F32(1.0) + anti_on.astype(F32) + F32(0.0))
    sz = np.where(fits, s, F32(0.0))
    if trapezoids:
        gaps = j[1:] - j[:-1]
        trap = (sz[:, 1:] + sz[:, :-1]) * F32(0.5) * gaps[None, :]
        F = np.concatenate([sz[:, :1], sz[:, :1] + _prefix_sum(trap)],
                           axis=1)
    else:
        F = _prefix_sum(sz)
    density = np.where(fits, F, F32(-np.inf)) / j[None, :]
    return (density.max(axis=1), j[density.argmax(axis=1)].astype(np.int64),
            np.minimum(capacity, MAX_PER_NODE).astype(np.int64))


def depth_take(d_star, k_star, k_cap, count: int, jitter, scale: float,
               samples: float) -> np.ndarray:
    """The order and the take: E-S order over the density ranking (no
    noise where `samples` <= 0), each node to its depth, capped at
    ceil(samples) + 1 where jittered; what is left deepens the nodes
    taken, best first."""
    samples = float(F32(samples))
    det = samples <= 0.0
    cap_take = MAX_PER_NODE if det else int(math.ceil(samples)) + 1
    k_star = np.minimum(k_star, max(cap_take, 1))
    fin = np.isfinite(d_star)
    k_star = np.where(fin, k_star, 0)
    rank = np.argsort(np.argsort(-d_star, kind="stable"), kind="stable")
    n_fin = max(int(fin.sum()), 1)
    base_w = F32(2.0) * (n_fin - rank).astype(F32) + F32(1.0)
    if det:
        gumbel = np.zeros(len(d_star), F32)
    else:
        u = np.clip(jitter, F32(1e-9), F32(1.0 - 1e-9))
        gumbel = np.log(-np.log(u))
    with np.errstate(invalid="ignore"):      # rows past n_fin: masked
        key = gumbel - F32(scale) * np.log(base_w)
    key = np.where(fin, key, F32(np.inf))
    order = np.argsort(key, kind="stable")
    ks = k_star[order]
    prior = np.cumsum(ks) - ks
    take = np.minimum(np.maximum(count - prior, 0), ks)
    placed = np.zeros(len(d_star), np.int64)
    placed[order] = take
    left = count - int(placed.sum())
    room = np.where(take > 0, k_cap[order] - take, 0)
    prior_r = np.cumsum(room) - room
    placed[order] += np.minimum(np.maximum(left - prior_r, 0), room)
    return placed


def solve(cap, used, ask, count: int, feasible, coll, desired: int,
          jitter_seed: int, batch: bool, pipeline: dict) -> np.ndarray:
    """Instances per row (rows in the eval's shuffled, padded order) for
    one pass of an eval that places `count` instances."""
    n_pad = cap.shape[0]
    pos = ask > 0
    use_depth = count > 1 or bool(coll.any())
    if not use_depth:
        return greedy(cap, used, ask, count, feasible)
    free = np.maximum(cap - used, F32(0.0))
    per = np.floor(np.min(np.where(pos[None, :],
                                   free / np.where(pos, ask, F32(1.0)),
                                   np.inf), axis=1))[feasible]
    deepest = int(per.max()) if per.size else 0
    k_needed = max(1, min(deepest, count))
    k_max = max(8, 1 << (k_needed - 1).bit_length())
    if k_max > 512:
        raise ValueError("a solve too deep for the depth curve")
    n_feas = max(int(np.count_nonzero(feasible)), 1)
    width = 2.0 if batch else max(2.0, float(np.ceil(np.log2(
        max(n_feas, 2)))))
    m = width * count / n_feas
    jitter = np.random.default_rng(jitter_seed).random(n_pad,
                                                       dtype=np.float32)
    if m > 3.0:
        scale, samples, grid = 1.0, 0.0, None
    else:
        scale = float(np.clip((width - 1.0) + max(m - 1.0, 0.0), 1.0, 8.0))
        samples = m
        grid = tuple(g for g in DEPTH_GRID if g <= k_max) or (1,)
    if grid is None and pipeline and count >= pipeline["min_count"] \
            and pipeline["chunks"] >= 2:
        chunks = pipeline["chunks"]
        sizes = [count // chunks + (1 if i < count % chunks else 0)
                 for i in range(chunks)]
        total = np.zeros(n_pad, np.int64)
        used, coll = used.copy(), coll.copy()
        for c in (s for s in sizes if s > 0):
            d, k, kc = depth_curve(cap, used, ask, feasible, coll, desired,
                                   k_max, None)
            placed = depth_take(d, k, kc, c, jitter, scale, samples)
            total += placed
            used = used + placed[:, None].astype(F32) * ask[None, :]
            coll = coll + placed
        return total
    d, k, kc = depth_curve(cap, used, ask, feasible, coll, desired, k_max,
                           grid)
    return depth_take(d, k, kc, count, jitter, scale, samples)


def misplaced(program: np.ndarray, reference: np.ndarray,
              alike: np.ndarray = None) -> int:
    """Instances the program put on a node beyond what the reference
    puts there. With `alike` (a class id per node: nodes whose every
    input to the solve is the same), nodes of one class may trade
    places: each class's counts are compared sorted, so only a choice
    that the score tells apart counts."""
    if alike is None:
        return int(np.maximum(program - reference, 0).sum())
    p = program[np.lexsort((program, alike))]
    r = reference[np.lexsort((reference, alike))]
    return int(np.maximum(p - r, 0).sum())


class Pass:
    """One pass of an eval as the program proposed it: every plan it
    submitted from one snapshot (a pipelined eval's chunk plans and its
    final plan), as instances per node id."""

    __slots__ = ("eval_id", "snapshot_index", "job_id", "counts")

    def __init__(self, eval_id: str, snapshot_index: int, job_id: str):
        self.eval_id, self.snapshot_index, self.job_id = \
            eval_id, int(snapshot_index), job_id
        self.counts: dict = {}

    def add(self, counts) -> None:
        for nid, c in counts:
            self.counts[nid] = self.counts.get(nid, 0) + int(c)


def group(proposals: list) -> list:
    """[(eval_id, snapshot_index, job_id, [(node_id, count)])] in the
    order the plans were submitted -> [Pass], in first-seen order."""
    passes: dict = {}
    for eid, snap, job, counts in proposals:
        p = passes.get((eid, snap))
        if p is None:
            p = passes[(eid, snap)] = Pass(eid, snap, job)
        p.add(counts)
    return list(passes.values())


def _spread_stanza(fleet, rec: dict, cand: np.ndarray, rows: np.ndarray,
                   n_pad: int, live_rows: np.ndarray) -> scan.Stanza:
    """The record's spread on the eval's padded node axis: each row's
    value, and the job's live instances on each value at the snapshot,
    as the property set counts them."""
    sp = rec["spread"]
    attr = scan.ATTRIBUTES.get(sp["attribute"])
    if attr is None:
        raise ValueError(f"the fleet table holds no {sp['attribute']}")
    of = getattr(fleet, attr)
    live: dict = {}
    for r in live_rows.tolist():
        if of[r]:
            live[of[r]] = live.get(of[r], 0) + 1
    # the universe: every value of a candidate node and of a live one
    st = scan.lower([of[r] for r in cand.tolist()], live, sp,
                    float(sp["weight"]), int(rec["count"]))
    by_row = dict(zip(cand.tolist(), st.ids.tolist()))
    st.ids = np.asarray([by_row[r] for r in rows.tolist()]
                        + [-1] * (n_pad - len(rows)), np.int64)
    return st


def _scan_route(rec: dict, algorithm: str) -> bool:
    """Whether the placer sends the job's passes to the chunked scan; a
    ValueError for what the scan's reference does not cover."""
    if rec.get("distinct_property") or rec.get("affinities"):
        raise ValueError("the reference covers no distinct_property and "
                         "no affinity")
    if algorithm == "spread":
        raise ValueError("the reference covers the binpack algorithms only")
    return bool(rec.get("spread"))


def judge(fleet, allocs, jobs: dict, passes: list, row_of: dict,
          pipeline, sample: int, seed: int,
          algorithm: str = "tpu-batch") -> dict:
    """Work out again each sampled pass of a job the records know, and
    count the instances the program put where the reference does not,
    node by node up to an exchange of nodes alike in every input.
    -> {"misplaced": instances, "compared": instances, "passes": n}.
    `sample` 0 compares every pass; else that many, drawn from the seed,
    with the pass of the most instances always in. `pipeline` is
    UNSTATED where the configuration does not state the plan pipeline:
    a binpack pass then raises ValueError (a scan pass is never
    pipelined)."""
    todo = [p for p in passes if p.job_id in jobs and p.counts]
    if sample and len(todo) > sample:
        big = max(range(len(todo)), key=lambda i: sum(todo[i].counts.values()))
        rest = [i for i in range(len(todo)) if i != big]
        pick = np.random.default_rng([seed, 7]).choice(
            len(rest), sample - 1, replace=False)
        todo = [todo[big]] + [todo[rest[i]] for i in sorted(pick)]
    cap64 = fleet.capacity()
    cap = cap64.astype(F32)
    n_fleet = len(fleet)
    codes = {j: i for i, j in enumerate(sorted(jobs))}
    job_code = np.fromiter((codes.get(j, -1) for j in allocs.job), np.int64,
                           len(allocs))
    asks = np.asarray([[jobs[j]["cpu_mhz"], jobs[j]["memory_mb"],
                        jobs[j]["disk_mb"]] if j in jobs else [0, 0, 0]
                       for j in allocs.job], np.float64).reshape(-1, 3)
    known = allocs.row >= 0
    out = {"misplaced": 0, "compared": 0, "passes": 0}
    for p in todo:
        rec = jobs[p.job_id]
        s = p.snapshot_index
        live = known & (allocs.create <= s) & (allocs.end > s)
        used = np.stack([np.bincount(allocs.row[live], asks[live, d],
                                     n_fleet) for d in range(3)], axis=1)
        mine = job_code == codes[p.job_id]
        coll = np.bincount(allocs.row[live & mine], minlength=n_fleet)
        count = int(rec["count"]) - int((mine & (allocs.create <= s)).sum())
        dcs = set(rec["datacenters"])
        cand = np.asarray([i for i in range(n_fleet) if fleet.dc[i] in dcs],
                          np.int64)
        perm, jseed = streams(p.eval_id, len(cand))
        rows = cand[perm]
        n_pad = node_bucket(len(rows))
        pad = n_pad - len(rows)
        c = np.pad(cap[rows], ((0, pad), (0, 0)))
        u = np.pad(used[rows].astype(F32), ((0, pad), (0, 0)))
        feas = np.pad(np.ones(len(rows), bool), (0, pad))
        co = np.pad(coll[rows], (0, pad))
        ask = np.asarray([rec["cpu_mhz"], rec["memory_mb"], rec["disk_mb"]],
                         F32)
        on_scan = _scan_route(rec, algorithm)
        stanza = _spread_stanza(fleet, rec, cand, rows, n_pad,
                                allocs.row[live & mine]) if on_scan else None
        want = np.zeros(n_fleet, np.int64)
        if count > 0:
            if on_scan:
                placed = scan.solve(c, u, ask, count, feas, co,
                                    int(rec["count"]), [stanza])
            elif pipeline is UNSTATED:
                raise ValueError("the configuration states no plan "
                                 "pipeline for a binpack pass")
            else:
                placed = solve(c, u, ask, count, feas, co, int(rec["count"]),
                               jseed, rec["type"] == "batch", pipeline)
            want[rows] = placed[:len(rows)]
        got = np.zeros(n_fleet, np.int64)
        for nid, k in p.counts.items():
            r = row_of.get(nid, -1)
            if r < 0:
                out["misplaced"] += k
                continue
            got[r] += k
        # nodes alike in capacity, usage, the job's own instances and,
        # on the scan, the spread's value score alike; which of them the
        # random order puts first is no part of the score (and a float32
        # tie there is no fault)
        inputs = np.concatenate([cap64[cand], used[cand],
                                 coll[cand, None]], axis=1)
        if on_scan:
            value = np.empty(n_fleet, np.int64)
            value[rows] = stanza.ids[:len(rows)]
            inputs = np.concatenate([inputs, value[cand, None]], axis=1)
        alike = np.unique(inputs, axis=0, return_inverse=True)[1].ravel()
        out["misplaced"] += int(np.delete(got, cand).sum())
        out["misplaced"] += misplaced(got[cand], want[cand], alike)
        out["compared"] += int(got.sum())
        out["passes"] += 1
    return out
