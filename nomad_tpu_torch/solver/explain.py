"""Placement explainability: per-(eval, task group) elimination
attribution computed as a byproduct of the batched solve. Counterpart of
nomad_tpu/solver/explain.py (all of it but the sharded route, which waits
for the multi-device port).

The host scheduler explains every placement decision — `AllocMetric`
records nodes evaluated, constraint-filtered, dimension-exhausted and
per-node score metadata. This module keeps the per-stage feasibility
reductions the solve already computes instead of discarding them and
materializes them into real `AllocMetric` objects feeding
`failed_tg_allocs`, blocked evals and the placed allocs' metrics.

Stage model (the host iterator stack's elimination order —
FeasibilityWrapper -> DistinctHosts -> BinPack fit, feasible.go/rank.go):

  1. irregular walk  host-side: the SAME checker objects the GenericStack
                     chains run per node (class-cached), recording their
                     filter reasons into a scratch AllocMetric (the placer
                     swaps it in around build_group_tensors); cached-
                     ineligible repeats count "computed class ineligible"
                     exactly like FeasibilityWrapper.
  2. eligibility     the journaled taint/eligibility column: nodes masked
                     here count "node ineligible".
  3. distinct_hosts  pre-solve collisions (state + plan) host-side, plus
                     post-solve placements (a placed row with
                     distinct_hosts is what the host's failing re-walk
                     filters as OP_DISTINCT_HOSTS).
  4. resource fit    `reduce_numpy` (the numpy version of
                     kernels.explain_reduce, same bits): per-node binding
                     dimension at post-solve usage, reduced to
                     per-dimension and per-node-class exhaustion counts,
                     plus top-k score metadata for the winning rows. It
                     runs on the host once the placement vector has
                     crossed at the solve's one sync, on the card as on
                     the CPU: on the H100 that beat the torch reduce
                     enqueued behind the solve (chip_smoke.py's explain
                     phase times both; PERF.md). It never touches the
                     placement math: placements are identical with
                     explain on or off.
  5. preemption      candidacy counts from the batched victim scan
                     (placer._preempt_batch).

Records land in a bounded process-wide ring (`recent()`) for the operator
debug bundle, and the owning scheduler keeps them per task group so a
host-fallback failure attaches the solve's AllocMetric instead of the
fallback stack's last walk.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from typing import Optional

import numpy as np

from ..metrics import metrics
from ..structs import AllocMetric, OP_DISTINCT_HOSTS

# how many winning rows keep score metadata
EXPLAIN_TOPK = 8

# extended-resource axis -> the host oracle's dimension names
# (ComparableResources.superset returns cpu/memory/disk; ports and
# bandwidth surface via NetworkIndex on the host path)
DIM_NAMES = ("cpu", "memory", "disk", "ports", "bandwidth exceeded")

REASON_CLASS_INELIGIBLE = "computed class ineligible"
REASON_NODE_INELIGIBLE = "node ineligible"

_lock = threading.Lock()
_ring: deque = deque(maxlen=256)
_enabled_override: Optional[bool] = None
_UNSET = object()


def configure(enabled=_UNSET, capacity: Optional[int] = None) -> None:
    """Test/bench control surface. `enabled` True/False overrides
    config+env; None restores config-driven resolution; omitted leaves
    the override untouched (the placer's per-eval capacity hot-reload
    must not clobber a bench leg's override)."""
    global _enabled_override, _ring
    with _lock:
        if capacity is not None and capacity != _ring.maxlen:
            _ring = deque(_ring, maxlen=max(1, int(capacity)))
    if enabled is not _UNSET:
        _enabled_override = enabled


def enabled(cfg=None) -> bool:
    """Config + env resolution: SchedulerConfiguration
    .placement_explain_enabled (hot-reloadable), NOMAD_EXPLAIN=0/1
    force-overrides, configure(enabled=) beats both (bench legs)."""
    if _enabled_override is not None:
        return _enabled_override
    env = os.environ.get("NOMAD_EXPLAIN", "")
    if env == "0":
        return False
    if env == "1":
        return True
    return bool(getattr(cfg, "placement_explain_enabled", True))


def reset() -> None:
    with _lock:
        _ring.clear()


def note(record: "ExplainRecord") -> None:
    """Retain a completed record in the bounded ring (newest-N) for the
    operator debug bundle."""
    with _lock:
        _ring.append(record)
    metrics.incr("nomad.solver.explain.records")


def recent(limit: int = 64) -> list[dict]:
    with _lock:
        records = list(_ring)[-limit:]
    return [r.as_dict() for r in reversed(records)]


class ExplainRecord:
    """One (eval, task group) solve's elimination attribution."""

    __slots__ = (
        "eval_id", "job_id", "tg", "nodes_total", "irregular",
        "elig_filtered", "dh_pre", "dh_pre_classes", "classes",
        "n_feasible", "dh_post", "nodes_exhausted", "nodes_fit",
        "placed_nodes", "placed_total", "dim_exhausted", "class_exhausted",
        "class_dh_post", "score_meta", "tier", "kernel", "rejected",
        "preempt_candidates", "preempt_with_victims", "preempt_placed",
    )

    def __init__(self, eval_id: str = "", job_id: str = "", tg: str = ""):
        self.eval_id = eval_id
        self.job_id = job_id
        self.tg = tg
        self.nodes_total = 0
        self.irregular: Optional[AllocMetric] = None   # stage-1 scratch
        self.elig_filtered = 0
        self.dh_pre = 0
        self.dh_pre_classes: dict[str, int] = {}
        self.classes: list[str] = []                   # class-id universe
        self.n_feasible = 0
        self.dh_post = 0
        self.nodes_exhausted = 0
        self.nodes_fit = 0
        self.placed_nodes = 0
        self.placed_total = 0
        self.dim_exhausted: dict[str, int] = {}
        self.class_exhausted: dict[str, int] = {}
        self.class_dh_post: dict[str, int] = {}
        self.score_meta: list[dict] = []
        self.tier = ""
        self.kernel = ""
        self.rejected = False
        self.preempt_candidates = 0
        self.preempt_with_victims = 0
        self.preempt_placed = 0

    # ------------------------------------------------------- device stage

    def absorb_reduce(self, out, gt, placed) -> None:
        """Fold the reduce's host-resident outputs — the (counts,
        dim_exhausted, class_exh, class_dh) tuple — into the record. The
        winning rows' score metadata derives host-side from the
        materialized `placed` vector and the host solve inputs — a few
        numpy ops over placed rows only."""
        counts, dim_exh, class_exh, class_dh = \
            (np.asarray(x) for x in out)
        self.n_feasible = int(counts[0])
        self.dh_post = int(counts[1])
        self.nodes_exhausted = int(counts[2])
        self.nodes_fit = int(counts[3])
        self.placed_nodes = int(counts[4])
        self.placed_total = int(counts[5])
        self.dim_exhausted = {
            DIM_NAMES[i]: int(c) for i, c in enumerate(dim_exh) if c}
        self.class_exhausted = {
            self.classes[i]: int(c) for i, c in enumerate(class_exh)
            if c and i < len(self.classes)}
        self.class_dh_post = {
            self.classes[i]: int(c) for i, c in enumerate(class_dh)
            if c and i < len(self.classes)}
        self.score_meta = topk_score_meta(
            gt.cap, gt.used, gt.ask, placed, gt.nodes)

    # -------------------------------------------------------- AllocMetric

    def failed_metric(self, nodes_available: Optional[dict] = None
                      ) -> AllocMetric:
        """Materialize a real AllocMetric for a FAILED placement — the
        counts a fresh host iterator-stack walk over the identical
        cluster produces (held to that walk by tests/test_explain.py, and
        to the reference's record by tests/test_torch_explain.py)."""
        m = self.irregular.copy() if self.irregular is not None \
            else AllocMetric()
        m.nodes_evaluated = self.nodes_total
        if nodes_available is not None:
            m.nodes_available = dict(nodes_available)
        if self.elig_filtered:
            m.nodes_filtered += self.elig_filtered
            m.constraint_filtered[REASON_NODE_INELIGIBLE] = \
                m.constraint_filtered.get(REASON_NODE_INELIGIBLE, 0) + \
                self.elig_filtered
        dh = self.dh_pre + self.dh_post
        if dh:
            m.nodes_filtered += dh
            m.constraint_filtered[OP_DISTINCT_HOSTS] = \
                m.constraint_filtered.get(OP_DISTINCT_HOSTS, 0) + dh
            for klass, c in self.dh_pre_classes.items():
                m.class_filtered[klass] = m.class_filtered.get(klass, 0) + c
            for klass, c in self.class_dh_post.items():
                m.class_filtered[klass] = m.class_filtered.get(klass, 0) + c
        m.nodes_exhausted = self.nodes_exhausted
        m.dimension_exhausted = dict(self.dim_exhausted)
        m.class_exhausted = dict(self.class_exhausted)
        m.score_meta = list(self.score_meta)
        return m

    def enrich_placed_metric(self, m: AllocMetric) -> AllocMetric:
        """Attach the solve-level attribution to the shared metrics
        object stamped onto PLACED allocations (the `alloc status`
        surface): nodes-evaluated, the irregular walk's filter counts
        (diverted into the scratch metric with explain on — they must
        not vanish from placed allocs), and the winning rows' score
        metadata. Mutates and returns `m` (the placer's per-TG copy)."""
        m.nodes_evaluated = max(m.nodes_evaluated, self.nodes_total)
        if self.irregular is not None:
            m.nodes_filtered += self.irregular.nodes_filtered
            for reason, c in self.irregular.constraint_filtered.items():
                m.constraint_filtered[reason] = \
                    m.constraint_filtered.get(reason, 0) + c
            for klass, c in self.irregular.class_filtered.items():
                m.class_filtered[klass] = \
                    m.class_filtered.get(klass, 0) + c
        if self.score_meta:
            m.score_meta = list(self.score_meta)
            for sm in self.score_meta:
                m.scores[f"{sm['node_id']}.binpack"] = \
                    sm["normalized_score"]
        return m

    def as_dict(self) -> dict:
        return {
            "eval_id": self.eval_id, "job_id": self.job_id, "tg": self.tg,
            "rejected": self.rejected,
            "tier": self.tier, "kernel": self.kernel,
            "nodes_total": self.nodes_total,
            "nodes_filtered": (self.irregular.nodes_filtered
                               if self.irregular is not None else 0)
            + self.elig_filtered + self.dh_pre + self.dh_post,
            "constraint_filtered": dict(
                self.irregular.constraint_filtered)
            if self.irregular is not None else {},
            "elig_filtered": self.elig_filtered,
            "distinct_hosts_filtered": self.dh_pre + self.dh_post,
            "n_feasible": self.n_feasible,
            "nodes_exhausted": self.nodes_exhausted,
            "nodes_fit": self.nodes_fit,
            "placed_nodes": self.placed_nodes,
            "placed_total": self.placed_total,
            "dim_exhausted": dict(self.dim_exhausted),
            "class_exhausted": dict(self.class_exhausted),
            "score_meta": list(self.score_meta),
            "preempt": {"candidates": self.preempt_candidates,
                        "with_victims": self.preempt_with_victims,
                        "placed": self.preempt_placed},
        }


# ---------------------------------------------------------- class lowering

def class_ids_for(nodes, bucket: int) -> tuple[np.ndarray, list[str]]:
    """Lower node classes to a padded id column for the histogram: ids
    i32[bucket] (-1 = empty class / padding row) + the id->class
    universe. The universe is bounded by distinct node classes (an
    operator-controlled dimension), never by node count. Classless
    clusters short-circuit after one cheap attribute sweep."""
    ids = np.full(bucket, -1, np.int32)
    raw = [node.node_class for node in nodes]
    if not any(raw):
        return ids, []
    classes: dict[str, int] = {}
    for i, klass in enumerate(raw):
        if klass:
            cid = classes.get(klass)
            if cid is None:
                cid = classes[klass] = len(classes)
            ids[i] = cid
    return ids, list(classes)


def class_pad(n_classes: int) -> int:
    from .buckets import pow2
    return pow2(n_classes, 2)


# ----------------------------------------------------- winning-row scores

def topk_score_meta(cap, used, ask, placed, nodes,
                    k: int = EXPLAIN_TOPK) -> list[dict]:
    """Binpack score metadata for the top-k placed rows, at post-solve
    usage — the kernel score formula replayed in numpy over the
    `placed > 0` rows only (a handful of rows, on the host)."""
    placed = np.asarray(placed)
    n = len(nodes)
    sel = np.flatnonzero(placed[:n] > 0)
    if sel.size == 0:
        return []
    cap_s = np.asarray(cap)[sel, :2].astype(np.float64)
    post = np.asarray(used)[sel, :2] + \
        placed[sel, None].astype(np.float64) * np.asarray(ask)[None, :2]
    safe = np.where(cap_s > 0, cap_s, 1.0)
    tot = np.sum(np.power(10.0, 1.0 - post / safe), axis=1)
    score = np.clip(20.0 - tot, 0.0, 18.0) / 18.0
    order = np.argsort(-score, kind="stable")[:k]
    return [{"node_id": nodes[int(sel[i])].id,
             "scores": {"binpack": round(float(score[i]), 6)},
             "normalized_score": round(float(score[i]), 6)}
            for i in order]


# ------------------------------------------------------------ the reduce

def reduce_numpy(cap, used, ask, feasible, collisions, placed, class_ids,
                 distinct_hosts, n_classes: int = 2) -> tuple:
    """The numpy version of kernels.explain_reduce — the same formula in
    float32, each product and sum rounded on its own, bit-identical
    outputs as a tuple (counts, dim_exhausted, class_exhausted,
    class_dh). Serves every solve (dispatch_reduce)."""
    placed_i = np.asarray(placed).astype(np.int32)
    cap = np.asarray(cap, np.float32)
    used = np.asarray(used, np.float32)
    ask = np.asarray(ask, np.float32)
    # post-solve usage without a full outer product: placements touch a
    # handful of rows, so copy + sparse update beats two dense passes
    placed_rows = np.flatnonzero(placed_i)
    if placed_rows.size:
        post = used.copy()
        post[placed_rows] += placed_i[placed_rows, None].astype(
            np.float32) * ask[None, :]
    else:
        post = used
    coll_post = np.asarray(collisions) + placed_i
    feas = np.asarray(feasible, bool)
    dh = feas & bool(distinct_hosts) & (coll_post > 0)
    cand = feas & ~dh
    n_dims = cap.shape[1]
    # first-failing-dim attribution as a short column loop (R' = 5)
    dim_exh = np.zeros(n_dims, np.int32)
    prior = np.zeros(cap.shape[0], bool)
    any_over = np.zeros(cap.shape[0], bool)
    for r in range(n_dims):
        over_r = post[:, r] + ask[r] > cap[:, r]
        dim_exh[r] = np.count_nonzero(over_r & ~prior & cand)
        prior |= over_r
        any_over |= over_r
    exh = cand & any_over
    cls = np.asarray(class_ids)
    class_exh = np.zeros(n_classes, np.int32)
    class_dh = np.zeros(n_classes, np.int32)
    if (cls >= 0).any():
        for c in range(n_classes):
            cmask = cls == c
            class_exh[c] = np.count_nonzero(cmask & exh)
            class_dh[c] = np.count_nonzero(cmask & dh)
    fit = cand & ~exh
    counts = np.array([feas.sum(), dh.sum(), exh.sum(), fit.sum(),
                       (placed_i > 0).sum(), placed_i.sum()], np.int32)
    return counts, dim_exh, class_exh, class_dh


def unpack(buf, n_dims: int, n_classes: int) -> tuple:
    """kernels.explain_reduce's int32 buffer (host-resident) -> the
    (counts, dim_exhausted, class_exhausted, class_dh) tuple."""
    buf = np.asarray(buf)
    d = 6 + n_dims
    return buf[:6], buf[6:d], buf[d:d + n_classes], \
        buf[d + n_classes:d + 2 * n_classes]


def dispatch_reduce(gt, placed, class_ids: np.ndarray, n_classes_pad: int):
    """Run the reduce for one solve over its placement vector on the
    host: `reduce_numpy` on the unpadded rows (padding rows are
    infeasible with zero placements: they contribute nothing) -> the
    (counts, dim_exhausted, class_exhausted, class_dh) tuple."""
    n = len(gt.nodes)
    return reduce_numpy(gt.cap[:n], gt.used[:n], gt.ask, gt.feasible[:n],
                        gt.job_collisions[:n], np.asarray(placed)[:n],
                        class_ids[:n], np.bool_(bool(gt.distinct_hosts)),
                        n_classes=n_classes_pad)
