"""Scheduler utilities (ref scheduler/util.go): tainted nodes, task-updated
detection, in-place vs destructive update classification.
"""
from __future__ import annotations

from typing import Optional

from ..structs import (
    Allocation, AllocatedResources, AllocatedTaskResources, Job, Node,
    TaskGroup, ALLOC_CLIENT_LOST, ALLOC_CLIENT_RUNNING,
    ALLOC_CLIENT_UNKNOWN, ALLOC_DESIRED_STOP, DESC_NODE_TAINTED,
)


def tainted_nodes(state, allocs: list[Allocation]) -> dict[str, Optional[Node]]:
    """Map of node_id -> Node for nodes that are tainted (down, draining,
    disconnected or GC'd) among the allocs' nodes (ref util.go taintedNodes).
    GC'd nodes map to None."""
    out: dict[str, Optional[Node]] = {}
    for alloc in allocs:
        if alloc.node_id in out:
            continue
        node = state.node_by_id(alloc.node_id)
        if node is None:
            out[alloc.node_id] = None
            continue
        if node.terminal_status() or node.drain or \
           node.scheduling_eligibility == "ineligible":
            out[alloc.node_id] = node
    return out


def ready_nodes_in_dcs(state, datacenters: list[str]
                       ) -> tuple[list[Node], dict[str, int]]:
    """Ready nodes in the given DCs plus per-DC availability counts
    (ref util.go readyNodesInDCs)."""
    ready = []
    by_dc: dict[str, int] = {}
    dcs = set(datacenters)
    for node in state.iter_nodes():
        if not node.ready():
            continue
        if node.datacenter not in dcs:
            continue
        ready.append(node)
        by_dc[node.datacenter] = by_dc.get(node.datacenter, 0) + 1
    return ready, by_dc


def retry_max(max_attempts: int, fn, reset_fn=None) -> bool:
    """Retry fn up to max attempts; reset_fn() True resets the counter
    (ref util.go retryMax)."""
    attempts = 0
    while attempts < max_attempts:
        if fn():
            return True
        if reset_fn is not None and reset_fn():
            attempts = 0
        else:
            attempts += 1
    return False


def progress_made(result) -> bool:
    """Did the plan application make any progress? (ref util.go progressMade)"""
    return result is not None and (
        result.node_update or result.node_allocation or
        result.deployment is not None or result.deployment_updates)


def tasks_updated(job_a: Job, job_b: Job, group: str) -> bool:
    """Would moving from job_a to job_b for this group require a destructive
    update? (ref util.go tasksUpdated) — any change to driver/config/env/
    resources/networks/volumes etc."""
    a = job_a.lookup_task_group(group)
    b = job_b.lookup_task_group(group)
    if a is None or b is None:
        return True
    if len(a.tasks) != len(b.tasks):
        return True
    if _networks_updated(a.networks, b.networks):
        return True
    if a.volumes != b.volumes:
        return True
    if a.ephemeral_disk != b.ephemeral_disk:
        return True
    for at in a.tasks:
        bt = b.lookup_task(at.name)
        if bt is None:
            return True
        if at.driver != bt.driver or at.user != bt.user:
            return True
        if at.config != bt.config or at.env != bt.env:
            return True
        if at.meta != bt.meta:
            return True
        if at.artifacts != bt.artifacts or at.templates != bt.templates:
            return True
        if at.volume_mounts != bt.volume_mounts:
            return True
        ar, br = at.resources, bt.resources
        if (ar.cpu, ar.cores, ar.memory_mb, ar.memory_max_mb) != \
           (br.cpu, br.cores, br.memory_mb, br.memory_max_mb):
            return True
        if _networks_updated(ar.networks, br.networks):
            return True
        if [d.name for d in ar.devices] != [d.name for d in br.devices] or \
           [d.count for d in ar.devices] != [d.count for d in br.devices]:
            return True
        if at.lifecycle != bt.lifecycle:
            return True
    return False


def _networks_updated(a, b) -> bool:
    if len(a) != len(b):
        return True
    for na, nb in zip(a, b):
        if na.mode != nb.mode or na.mbits != nb.mbits:
            return True
        if [(p.label, p.value, p.to) for p in na.reserved_ports] != \
           [(p.label, p.value, p.to) for p in nb.reserved_ports]:
            return True
        if [(p.label, p.to) for p in na.dynamic_ports] != \
           [(p.label, p.to) for p in nb.dynamic_ports]:
            return True
    return False


def generic_alloc_update_fn(ctx, eval_obj, job: Job):
    """Returns fn(alloc, new_job, tg) -> (ignore, destructive, inplace_alloc)
    (ref util.go genericAllocUpdateFn)."""

    def update_fn(existing: Allocation, new_job: Job, new_tg: TaskGroup):
        # Same job definition => ignore
        if existing.job is not None and \
           existing.job.version == new_job.version and \
           existing.job.create_index == new_job.create_index:
            return True, False, None

        # Task-level changes => destructive
        if existing.job is not None and \
           tasks_updated(existing.job, new_job, new_tg.name):
            return False, True, None

        # In-place candidate: re-check the node still fits with the updated
        # (count-insensitive) definition
        node = ctx.state.node_by_id(existing.node_id)
        if node is None:
            return False, True, None

        proposed = [a for a in ctx.proposed_allocs(existing.node_id)
                    if a.id != existing.id]
        from ..structs import allocs_fit
        new_alloc = existing.copy()
        new_alloc.job = None  # normalized to plan job on append
        fit, _, _ = allocs_fit(node, proposed + [new_alloc])
        if not fit:
            return False, True, None
        return False, False, new_alloc

    return update_fn


def update_non_terminal_allocs_to_lost(plan, tainted: dict[str, Optional[Node]],
                                       allocs: list[Allocation],
                                       job=None, now: float = 0.0) -> None:
    """Mark non-terminal allocs on down nodes as lost in the plan
    (ref generic_sched.go:350 updateNonTerminalAllocsToLost via util).

    Disconnect-eligible allocs (group sets max_client_disconnect and the
    window hasn't expired) are skipped — the reconciler rides them out
    as `unknown` instead; stopping them here would race the attribute
    update in the same plan (ref Nomad gates this on
    supportsDisconnectedClients). `now` is the eval's clock — callers
    pass the same timestamp the reconciler uses so both ends of the
    disconnect window agree (0 falls back to wall clock)."""
    import time as _time
    # callers inject the eval clock; bare wall clock is the documented
    # fallback contract above
    now = now or _time.time()   # nomadlint: disable=DET001 — spec fallback
    for alloc in allocs:
        node = tainted.get(alloc.node_id, "absent")
        if node == "absent":
            continue
        if node is not None and not node.terminal_status():
            continue  # only down/GC'd nodes strand allocs as lost
        if alloc.terminal_status():
            continue
        tg = job.lookup_task_group(alloc.task_group) if job else None
        window = getattr(tg, "max_client_disconnect_sec", None) if tg \
            else None
        if window and alloc.client_status in (ALLOC_CLIENT_RUNNING,
                                              ALLOC_CLIENT_UNKNOWN):
            since = alloc.disconnected_at or now
            if now < since + window:
                continue          # the reconciler handles the window
        plan.append_stopped_alloc(alloc, DESC_NODE_TAINTED,
                                  client_status=ALLOC_CLIENT_LOST)
