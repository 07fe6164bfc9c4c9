"""Host-side lowering: objects -> dense tensors for the solver.

This is the critical contract of the dual representation (SURVEY.md §7.1):
irregular things (attribute maps, regexp/version constraints, port bitmaps)
are resolved HERE, once per (eval, task group), into flat arrays; the device
only ever sees f32/i32 matrices and boolean masks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..structs import (
    Allocation, Node, TaskGroup, DEFAULT_MAX_DYNAMIC_PORT,
    DEFAULT_MIN_DYNAMIC_PORT, OP_DISTINCT_HOSTS,
)
from .buckets import node_bucket, pow2 as _pow2
from .kernels import NUM_XR, XR_CPU, XR_DISK, XR_MBITS, XR_MEM, XR_PORTS

DYN_PORT_SPAN = DEFAULT_MAX_DYNAMIC_PORT - DEFAULT_MIN_DYNAMIC_PORT + 1


@dataclasses.dataclass
class GroupTensors:
    """Per-(eval, task group) solver input. cap_dev/used_dev are set when
    the state cache served this eval: bucket-padded device twins of
    cap/used (same values, already resident), which the placer hands to
    device-tier dispatches instead of paying a fresh h2d transfer. They
    are dropped whenever the host copies diverge (in-plan corrections)."""
    nodes: list[Node]                  # row i of every array is nodes[i]
    cap: np.ndarray                    # f32[N, R'] usable capacity
    used: np.ndarray                   # f32[N, R'] proposed utilization
    feasible: np.ndarray               # bool[N] irregular-constraint verdicts
    ask: np.ndarray                    # f32[R'] per-instance claim
    job_collisions: np.ndarray         # i32[N] same job+tg proposed allocs
    distinct_hosts: bool
    cap_dev: object = None             # f32[B, R'] device twin (or None)
    used_dev: object = None            # f32[B, R'] device twin (or None)
    gen: Optional[int] = None          # mesh generation the twins ride
                                       # (ISSUE 14: placer._dev_mats
                                       # declines stale-generation twins)
    # the convex route's resident twins (cap_res, used_res), whole and
    # ungathered, + the view row index per node and the usage-journal
    # version the twins' bits reflect — the convex solve gathers its
    # rows behind its own launch and the plan applier's verdict fast
    # path trusts the version stamp. Dropped (like the dev twins)
    # whenever the host copies diverge via in-plan corrections.
    resident: object = None
    rows: Optional[np.ndarray] = None  # i64[N] view row per node
    version: int = -1                  # journal version of resident bits
    uid: int = 0
    epoch: int = -1
    # explain stage attribution (ISSUE 11), populated only when the
    # placer lowers with explain=True: counts of nodes eliminated by
    # the taint/eligibility mask and the pre-solve distinct-hosts
    # collision filter — the two stages _build_* folds into `feasible`
    # that a host iterator walk attributes separately. None = explain off.
    ex_stages: Optional[dict] = None


# (node.id, node.modify_index) -> capacity row. node_capacity_row is pure
# in the node and was recomputed for every row of every eval on the
# object-walk path (ISSUE 4 satellite); the store stamps modify_index on
# every node upsert, so the key invalidates exactly when the node changes.
# Rows are frozen so an accidental caller mutation fails loudly instead of
# corrupting every later eval's capacity.
_CAP_ROW_MEMO: dict[tuple, np.ndarray] = {}
_CAP_ROW_MEMO_MAX = 65_536


def node_capacity_row(node: Node) -> np.ndarray:
    """Usable capacity (total − node reservation) in extended layout.
    Memoized by (node.id, node.modify_index) — returns a read-only row;
    copy before mutating."""
    key = (node.id, node.modify_index)
    row = _CAP_ROW_MEMO.get(key)
    if row is not None:
        return row
    row = np.zeros(NUM_XR, np.float32)
    res, rsv = node.node_resources, node.reserved_resources
    row[XR_CPU] = max(0, res.cpu.cpu_shares - rsv.cpu_shares)
    row[XR_MEM] = max(0, res.memory.memory_mb - rsv.memory_mb)
    row[XR_DISK] = max(0, res.disk.disk_mb - rsv.disk_mb)
    row[XR_PORTS] = DYN_PORT_SPAN
    row[XR_MBITS] = sum(n.mbits for n in res.networks) or 0
    row.flags.writeable = False
    if len(_CAP_ROW_MEMO) >= _CAP_ROW_MEMO_MAX:
        _CAP_ROW_MEMO.clear()           # rare full flush beats an LRU chain
    _CAP_ROW_MEMO[key] = row
    return row


def alloc_usage_row(alloc: Allocation) -> np.ndarray:
    row = np.zeros(NUM_XR, np.float32)
    c = alloc.comparable_resources()
    mem_claim = c.memory_max_mb if c.memory_max_mb > c.memory_mb else c.memory_mb
    row[XR_CPU] = c.cpu_shares
    row[XR_MEM] = mem_claim
    row[XR_DISK] = c.disk_mb
    ports = 0
    mbits = 0
    res = alloc.allocated_resources
    nets = list(res.shared.networks)
    for tr in res.tasks.values():
        nets.extend(tr.networks)
    for net in nets:
        mbits += net.mbits
        ports += len(net.dynamic_ports)
        ports += sum(1 for p in net.reserved_ports
                     if DEFAULT_MIN_DYNAMIC_PORT <= p.value
                     <= DEFAULT_MAX_DYNAMIC_PORT)
    row[XR_PORTS] = ports
    row[XR_MBITS] = mbits
    return row


def group_ask_row(tg: TaskGroup) -> np.ndarray:
    """Per-instance claim vector for one task group."""
    row = np.zeros(NUM_XR, np.float32)
    row[XR_DISK] = tg.ephemeral_disk.size_mb
    for net in tg.networks:
        row[XR_PORTS] += len(net.dynamic_ports)
        row[XR_MBITS] += net.mbits
    for task in tg.tasks:
        r = task.resources
        row[XR_CPU] += r.cpu
        mem = r.memory_max_mb if r.memory_max_mb > r.memory_mb else r.memory_mb
        row[XR_MEM] += mem
        for net in r.networks:
            row[XR_PORTS] += len(net.dynamic_ports)
            row[XR_MBITS] += net.mbits
    return row


@dataclasses.dataclass
class SpreadTensors:
    """All spread stanzas lowered for the chunked kernel (ref
    scheduler/spread.go SpreadIterator; SURVEY hard part 2)."""
    ids: np.ndarray        # i32[S, N] value id per node (-1 missing)
    counts: np.ndarray     # i32[S, P] running usage (-1 pad columns)
    desired: np.ndarray    # f32[S, P] desired count per value (-1 none)
    mode: np.ndarray       # i32[S] 0=even 1=targeted -1=pad
    weights: np.ndarray    # f32[S] weight/sum_weights


@dataclasses.dataclass
class DistinctTensors:
    """distinct_property constraints lowered to per-value quotas (ref
    scheduler/feasible.go:604 + propertyset.go)."""
    ids: np.ndarray        # i32[D, N] value id per node (-1 missing)
    remaining: np.ndarray  # i32[D, P]; remaining[d, 0] < 0 marks pad stanza


def _lower_spreads(ctx, job, tg, spreads, nodes) -> SpreadTensors:
    """Mirror SpreadIterator._compute_spread_info + next() inputs."""
    from ..scheduler.feasible import resolve_target
    from ..scheduler.propertyset import PropertySet
    IMPLICIT = "*"
    n = len(nodes)
    s_count = _pow2(len(spreads))
    if not spreads:
        return SpreadTensors(
            ids=np.full((1, n), -1, np.int32),
            counts=np.full((1, 2), -1, np.int32),
            desired=np.full((1, 2), -1.0, np.float32),
            mode=np.full(1, -1, np.int32),
            weights=np.zeros(1, np.float32))
    # desired-count info per attribute; job spreads override tg spreads for
    # duplicate attributes (SpreadIterator._compute_spread_info iteration
    # order: tg first, job last-write-wins)
    total = tg.count
    sum_weights = sum(s.weight for s in spreads)
    infos: dict[str, tuple[int, dict[str, float]]] = {}
    for spread in spreads:
        desired: dict[str, float] = {}
        sum_desired = 0.0
        for st in spread.spread_target:
            d = (st.percent / 100.0) * total
            desired[st.value] = d
            sum_desired += d
        if 0 < sum_desired < total:
            desired[IMPLICIT] = total - sum_desired
        infos[spread.attribute] = (spread.weight, desired)

    per_stanza = []
    max_p = 2
    for spread in spreads:
        ps = PropertySet(ctx, job)
        ps.set_target_attribute(spread.attribute, tg.name)
        counts_map = ps.used_counts()
        _, desired = infos[spread.attribute]
        node_vals = []
        for node in nodes:
            val, ok = resolve_target(spread.attribute, node)
            node_vals.append(str(val) if ok and val is not None else None)
        universe = sorted(set(counts_map)
                          | {k for k in desired if k != IMPLICIT}
                          | {v for v in node_vals if v is not None})
        vid = {v: i for i, v in enumerate(universe)}
        per_stanza.append((spread, counts_map, desired, node_vals, vid,
                           universe))
        max_p = max(max_p, len(universe))
    p_count = _pow2(max_p, 2)

    ids = np.full((s_count, n), -1, np.int32)
    counts = np.full((s_count, p_count), -1, np.int32)
    desired_arr = np.full((s_count, p_count), -1.0, np.float32)
    mode = np.full(s_count, -1, np.int32)
    weights = np.zeros(s_count, np.float32)
    for s, (spread, counts_map, desired, node_vals, vid, universe) in \
            enumerate(per_stanza):
        for i, v in enumerate(node_vals):
            if v is not None:
                ids[s, i] = vid[v]
        for p, v in enumerate(universe):
            counts[s, p] = counts_map.get(v, 0)
            if desired:
                desired_arr[s, p] = desired.get(v, desired.get(IMPLICIT,
                                                               -1.0))
        mode[s] = 1 if desired else 0
        weights[s] = (spread.weight / sum_weights) if sum_weights else 0.0
    return SpreadTensors(ids=ids, counts=counts, desired=desired_arr,
                         mode=mode, weights=weights)


def _lower_distinct(ctx, property_sets, nodes) -> DistinctTensors:
    from ..scheduler.feasible import resolve_target
    n = len(nodes)
    d_count = _pow2(len(property_sets))
    ids = np.full((d_count, n), -1, np.int32)
    remaining = np.full((d_count, 2), -1, np.int32)
    if not property_sets:
        return DistinctTensors(ids=ids, remaining=remaining)
    max_p = 2
    per = []
    for ps in property_sets:
        counts_map = ps.used_counts() if not ps.error else {}
        node_vals = []
        for node in nodes:
            val, ok = resolve_target(ps.target_attribute, node)
            node_vals.append(str(val) if ok and val is not None else None)
        universe = sorted(set(counts_map)
                          | {v for v in node_vals if v is not None})
        per.append((ps, counts_map, node_vals,
                    {v: i for i, v in enumerate(universe)}, universe))
        max_p = max(max_p, len(universe))
    p_count = _pow2(max_p, 2)
    remaining = np.full((d_count, p_count), -1, np.int32)
    for d, (ps, counts_map, node_vals, vid, universe) in enumerate(per):
        if ps.error:
            # invalid constraint: every node fails (propertyset.go error
            # path) — active stanza, all ids -1
            remaining[d, :] = 0
            continue
        for i, v in enumerate(node_vals):
            if v is not None:
                ids[d, i] = vid[v]
        remaining[d, :] = 0
        for p, v in enumerate(universe):
            remaining[d, p] = max(0, ps.allowed_count
                                  - counts_map.get(v, 0))
    return DistinctTensors(ids=ids, remaining=remaining)


def _lower_affinities(ctx, affinities, nodes) -> np.ndarray:
    """Static per-node affinity boost (ref rank.go:650
    NodeAffinityIterator): irregular operator matching resolves host-side
    once per (eval, tg); the device only sees the f32[N] result."""
    from ..scheduler.feasible import check_constraint, resolve_target
    n = len(nodes)
    out = np.zeros(n, np.float32)
    if not affinities:
        return out
    sum_weight = sum(abs(a.weight) for a in affinities)
    if not sum_weight:
        return out
    for i, node in enumerate(nodes):
        total = 0.0
        for aff in affinities:
            lval, lok = resolve_target(aff.ltarget, node)
            rval, rok = resolve_target(aff.rtarget, node)
            if check_constraint(ctx, aff.operand, lval, rval, lok, rok):
                total += float(aff.weight)
        norm = total / sum_weight
        out[i] = norm / 100.0 if abs(norm) > 1 else norm
    return out


def _explain_stages(nodes, walk, elig_ok, dh_pre) -> dict:
    """Fold the per-stage masks into the counts the AllocMetric
    materialization needs: eligibility-mask eliminations among walk
    survivors, pre-solve distinct-hosts eliminations among eligible
    survivors, with a per-node-class histogram for the latter (the host
    DistinctHostsIterator records class_filtered per node)."""
    classes: dict[str, int] = {}
    for i in np.flatnonzero(dh_pre):
        klass = nodes[int(i)].node_class
        if klass:
            classes[klass] = classes.get(klass, 0) + 1
    return {
        "elig_filtered": int(np.count_nonzero(walk & ~elig_ok)),
        "dh_pre": int(np.count_nonzero(dh_pre)),
        "dh_pre_classes": classes,
    }


def build_group_tensors(ctx, job, tg: TaskGroup, nodes: list[Node],
                        feasible_fn, count: int = None,
                        explain: bool = False) -> GroupTensors:
    """Lower one task group's placement problem.

    Fast path: read the store's incrementally-maintained dense cap/used
    matrices (state/usage_index.py) and apply the in-plan delta sparsely —
    O(N·R') array ops + O(plan) instead of an O(allocs) object walk per
    eval (VERDICT r1 weak #1). Falls back to the object walk for states
    without a usage view (plain test fakes). `count` (instances asked,
    when the caller knows it) feeds the backend's small-solve tier
    routing so the device gather is only paid for tiers that consume it.
    """
    view = getattr(ctx.state, "usage", None)
    if view is not None:
        try:
            return _build_dense(ctx, job, tg, nodes, feasible_fn, view,
                                count=count, explain=explain)
        except KeyError:
            pass        # node missing from the index: recompute from objects
    return _build_from_objects(ctx, job, tg, nodes, feasible_fn,
                               explain=explain)


def _build_dense(ctx, job, tg: TaskGroup, nodes: list[Node], feasible_fn,
                 view, count: int = None,
                 explain: bool = False) -> GroupTensors:
    from ..state.usage_index import alloc_usage_tuple
    from . import backend, state_cache
    n = len(nodes)
    row = view.row
    rows = np.fromiter((row[node.id] for node in nodes), np.int64, count=n)
    # the state cache serves versioned views: host copies of the SAME bits
    # a fresh view gather yields (the bit-identity contract), plus bucket-
    # padded twins on the solve device for the dispatch. Unversioned views
    # (plain test fakes) and a disabled cache take the view path. Under
    # the "convex" algorithm the cache hands back the resident twins
    # instead (no gather launches): the convex solve gathers the eval's
    # rows itself, as the reference's does.
    cfg = getattr(ctx, "scheduler_config", None)
    cvx = cfg is not None and backend.convex_enabled(
        cfg, cfg.effective_scheduler_algorithm())
    cached = state_cache.gather(view, rows, bucket=node_bucket(n),
                                tier=backend.tier(), resident=cvx)
    gen = None
    resident = None
    res_version, res_uid, res_epoch = -1, 0, -1
    if cached is not None:
        cap, used = cached.cap, cached.used
        cap_dev, used_dev = cached.cap_dev, cached.used_dev
        gen = cached.gen
        resident = cached.resident
        res_version = cached.version
        res_uid, res_epoch = cached.uid, cached.epoch
    else:
        cap = view.cap[rows]                   # fancy index => fresh arrays
        used = view.used[rows]
        cap_dev = used_dev = None
    pos = {node.id: i for i, node in enumerate(nodes)}

    # sparse in-plan correction: state allocs − plan stops/preemptions +
    # plan placements (the dense ProposedAllocs, ref scheduler/context.go:120)
    plan = ctx.plan
    collisions = np.zeros(n, np.int32)
    stopped_ids: set[str] = set()
    placed_ids: set[str] = set()
    if plan is not None:
        for node_id, stops in list(plan.node_update.items()) + \
                list(plan.node_preemptions.items()):
            i = pos.get(node_id)
            for a in stops:
                stopped_ids.add(a.id)
                if i is None:
                    continue
                existing = ctx.state.alloc_by_id(a.id)
                if existing is not None and not existing.terminal_status() \
                        and existing.node_id == node_id:
                    used[i] -= alloc_usage_tuple(existing)
                    used_dev = None     # host copy diverged from the twin
                    resident = None
        for node_id, placed in plan.node_allocation.items():
            i = pos.get(node_id)
            for a in placed:
                placed_ids.add(a.id)
                if i is None:
                    continue
                existing = ctx.state.alloc_by_id(a.id)
                if existing is not None and not existing.terminal_status() \
                        and existing.id not in stopped_ids \
                        and existing.node_id == node_id:
                    used[i] -= alloc_usage_tuple(existing)   # in-place update
                used[i] += alloc_usage_tuple(a)
                used_dev = None         # host copy diverged from the twin
                resident = None
                if a.job_id == job.id and a.task_group == tg.name:
                    collisions[i] += 1

    # same-job collisions from state: only this job's allocs, via the
    # job index — O(job allocs), not O(all allocs). Plan placements replace
    # their same-id state twins (ref context.go:120 ProposedAllocs), so
    # in-place-updated allocs must not count twice.
    for a in ctx.state.allocs_by_job(job.namespace, job.id):
        if a.task_group != tg.name or a.terminal_status() or \
                a.id in stopped_ids or a.id in placed_ids:
            continue
        i = pos.get(a.node_id)
        if i is not None:
            collisions[i] += 1

    feasible = np.fromiter((feasible_fn(node) for node in nodes), bool,
                           count=n)
    walk = feasible.copy() if explain else None

    # taint mask (ISSUE 10): AND the journaled eligibility column into
    # feasibility. Candidates are normally pre-filtered by node.ready()
    # so this is a no-op — but it makes the solver's verdict independent
    # of host-side filtering (bit-parity with the ready() oracle is
    # pinned in tests/test_node_storm.py), and it is the seam flap
    # damping and future unfiltered-candidate paths mask through.
    elig = getattr(view, "elig", None)
    elig_ok = None
    if elig is not None:
        elig_ok = elig[rows] > 0.5
        feasible &= elig_ok

    distinct_hosts = any(c.operand == OP_DISTINCT_HOSTS
                         for c in list(job.constraints) + list(tg.constraints))
    ex_stages = None
    if explain:
        if elig_ok is None:
            elig_ok = np.ones(n, bool)
        dh_pre = feasible & (collisions > 0) if distinct_hosts \
            else np.zeros(n, bool)
        ex_stages = _explain_stages(nodes, walk, elig_ok, dh_pre)
        # class-id column for the device histogram, gathered VECTORIZED
        # from the usage index (a per-node python walk here serialized
        # the GIL across the whole stream — ISSUE 11 overhead contract)
        class_col = getattr(view, "class_col", None)
        if class_col is not None:
            ex_stages["class_ids"] = class_col[rows]
            ex_stages["class_names"] = list(
                getattr(view, "class_names", ()) or ())
    if distinct_hosts:
        feasible &= collisions == 0

    return GroupTensors(
        nodes=nodes, cap=cap, used=used, feasible=feasible,
        ask=group_ask_row(tg), job_collisions=collisions,
        distinct_hosts=distinct_hosts,
        cap_dev=cap_dev, used_dev=used_dev, gen=gen, ex_stages=ex_stages,
        resident=resident, rows=rows, version=res_version,
        uid=res_uid, epoch=res_epoch,
    )


def _build_from_objects(ctx, job, tg: TaskGroup, nodes: list[Node],
                        feasible_fn, explain: bool = False) -> GroupTensors:
    """Object-walk fallback: derives everything from proposed_allocs.

    feasible_fn(node) -> bool runs the irregular host-side checks (constraint
    operators, drivers, volumes, devices) — typically the stack's
    FeasibilityWrapper drained per class, so cost is O(classes), not O(N).
    """
    n = len(nodes)
    cap = np.zeros((n, NUM_XR), np.float32)
    used = np.zeros((n, NUM_XR), np.float32)
    feasible = np.zeros(n, bool)
    collisions = np.zeros(n, np.int32)

    distinct_hosts = any(c.operand == OP_DISTINCT_HOSTS
                         for c in list(job.constraints) + list(tg.constraints))

    walk = np.zeros(n, bool)
    for i, node in enumerate(nodes):
        cap[i] = node_capacity_row(node)
        feasible[i] = walk[i] = feasible_fn(node)
        proposed = ctx.proposed_allocs(node.id)
        for alloc in proposed:
            used[i] += alloc_usage_row(alloc)
            if alloc.job_id == job.id and alloc.task_group == tg.name:
                collisions[i] += 1
        if distinct_hosts and collisions[i] > 0:
            feasible[i] = False

    ex_stages = None
    if explain:
        dh_pre = walk & (collisions > 0) if distinct_hosts \
            else np.zeros(n, bool)
        ex_stages = _explain_stages(nodes, walk, np.ones(n, bool), dh_pre)

    return GroupTensors(
        nodes=nodes,
        cap=cap,
        used=used,
        feasible=feasible,
        ask=group_ask_row(tg),
        job_collisions=collisions,
        distinct_hosts=distinct_hosts,
        ex_stages=ex_stages,
    )


def stack_lanes(lane_args: list, dtypes: dict) -> tuple:
    """Column-stack a window's normalized arg tuples into ONE batched arg
    tuple of len(lane_args) rows on the solve device (ref
    tensorize.stack_lanes, less its padding to a fixed lane count): the
    positions in `dtypes` (position -> dtype: the signature's arrays,
    numpy or tensors such as the state cache's twins) stack into
    [L, ...] tensors, every other position (a per-lane scalar) into a
    list of L host scalars. A column that is None in every lane stays
    None; the queue key keeps None and array columns apart."""
    from .device import solve_device
    dev = solve_device()
    cols = []
    for i in range(len(lane_args[0])):
        vals = [r[i] for r in lane_args]
        if all(v is None for v in vals):
            cols.append(None)
        elif i not in dtypes:
            cols.append([v.item() if hasattr(v, "item") else v
                         for v in vals])
        else:
            cols.append(torch.stack([
                v.to(device=dev, dtype=dtypes[i])
                if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v)).to(
                    device=dev, dtype=dtypes[i]) for v in vals]))
    return tuple(cols)
