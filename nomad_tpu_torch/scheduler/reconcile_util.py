"""Reconciler set algebra (ref scheduler/reconcile_util.go): allocSet
filters and the alloc-name index."""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..structs import (
    Allocation, Deployment, Job, Node, TaskGroup,
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED, ALLOC_CLIENT_LOST,
    ALLOC_CLIENT_RUNNING, ALLOC_CLIENT_UNKNOWN,
    ALLOC_DESIRED_EVICT, ALLOC_DESIRED_STOP, alloc_name, alloc_name_index,
)

AllocSet = dict[str, Allocation]

# Window within which a future reschedule time counts as "now"
# (ref reconcile.go rescheduleWindowSize = 1s... actually util)
RESCHEDULE_WINDOW_SEC = 5.0


def alloc_matrix(job: Optional[Job], allocs: list[Allocation]
                 ) -> dict[str, AllocSet]:
    """Group allocs by task group, seeding groups from the job
    (ref reconcile_util.go:107 newAllocMatrix)."""
    m: dict[str, AllocSet] = {}
    for a in allocs:
        m.setdefault(a.task_group, {})[a.id] = a
    if job is not None:
        for tg in job.task_groups:
            m.setdefault(tg.name, {})
    return m


def difference(a: AllocSet, *others: AllocSet) -> AllocSet:
    out = dict(a)
    for o in others:
        for k in o:
            out.pop(k, None)
    return out


def union(*sets: AllocSet) -> AllocSet:
    out: AllocSet = {}
    for s in sets:
        out.update(s)
    return out


def from_keys(a: AllocSet, keys) -> AllocSet:
    return {k: a[k] for k in keys if k in a}


def name_set(a: AllocSet) -> set[str]:
    return {alloc.name for alloc in a.values()}


def name_order(a: AllocSet) -> list[Allocation]:
    return sorted(a.values(), key=lambda x: x.name)


def filter_by_terminal(a: AllocSet) -> AllocSet:
    """Remove terminal allocs (ref reconcile_util.go filterByTerminal)."""
    return {k: v for k, v in a.items() if not v.terminal_status()}


def filter_by_tainted(a: AllocSet, tainted: dict[str, Optional[Node]]
                      ) -> tuple[AllocSet, AllocSet, AllocSet]:
    """(untainted, migrate, lost) — ref reconcile_util.go:217."""
    untainted: AllocSet = {}
    migrate: AllocSet = {}
    lost: AllocSet = {}
    for aid, alloc in a.items():
        if alloc.terminal_status():
            untainted[aid] = alloc
            continue
        if alloc.desired_transition.should_migrate():
            migrate[aid] = alloc
            continue
        if alloc.node_id not in tainted:
            untainted[aid] = alloc
            continue
        node = tainted[alloc.node_id]
        if node is None or node.terminal_status():
            lost[aid] = alloc
            continue
        untainted[aid] = alloc
    return untainted, migrate, lost


def split_disconnecting(tg, lost: AllocSet, now: float
                        ) -> tuple[AllocSet, AllocSet]:
    """(disconnecting, still_lost) — graceful client disconnection (ref
    1.3 reconcile_util.go filterByTainted 'disconnecting' + Allocation.
    Expired): with max_client_disconnect set, a running alloc on a down
    node rides out the window as `unknown` instead of being lost."""
    window = getattr(tg, "max_client_disconnect_sec", None)
    if not window:
        return {}, lost
    disconnecting: AllocSet = {}
    still_lost: AllocSet = {}
    for aid, alloc in lost.items():
        # only RUNNING work rides out the window: a pending alloc (tasks
        # never started) reschedules normally, and restoring it to
        # "running" on reconnect would misstate its health
        if alloc.client_status not in (ALLOC_CLIENT_RUNNING,
                                       ALLOC_CLIENT_UNKNOWN):
            still_lost[aid] = alloc
            continue
        since = alloc.disconnected_at or now
        if now < since + window:
            disconnecting[aid] = alloc
        else:
            still_lost[aid] = alloc          # window expired -> lost
    return disconnecting, still_lost


def split_reconnecting(untainted: AllocSet) -> tuple[AllocSet, AllocSet]:
    """(reconnecting, rest) — allocs still marked `unknown` whose node is
    no longer tainted: the client came back inside the window (ref 1.3
    reconcile.go reconcileReconnecting)."""
    reconnecting: AllocSet = {}
    rest: AllocSet = {}
    for aid, alloc in untainted.items():
        if alloc.client_status == ALLOC_CLIENT_UNKNOWN and \
                not alloc.server_terminal_status():
            reconnecting[aid] = alloc
        else:
            rest[aid] = alloc
    return reconnecting, rest


def should_filter(alloc: Allocation, is_batch: bool) -> tuple[bool, bool]:
    """(untainted, ignore) — ref reconcile_util.go shouldFilter."""
    if is_batch:
        if alloc.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT):
            if alloc.ran_successfully():
                return True, False
            return False, True
        if alloc.client_status != ALLOC_CLIENT_FAILED:
            return True, False
        return False, False
    # service
    if alloc.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT):
        return False, True
    if alloc.client_status in (ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_LOST):
        return False, True
    return False, False


def update_by_reschedulable(alloc: Allocation, now: float, eval_id: str,
                            deployment: Optional[Deployment]
                            ) -> tuple[bool, bool, float]:
    """(reschedule_now, reschedule_later, when) — ref reconcile_util.go
    updateByReschedulable."""
    if deployment is not None and alloc.deployment_id == deployment.id and \
       deployment.active() and not alloc.desired_transition.should_migrate() \
       and not bool(alloc.desired_transition.reschedule):
        return False, False, 0.0
    now_flag = False
    if alloc.desired_transition.should_force_reschedule():
        now_flag = True
    when, eligible = alloc.next_reschedule_time()
    if eligible and (alloc.follow_up_eval_id == eval_id or
                     when - now <= RESCHEDULE_WINDOW_SEC):
        return True, False, when
    if now_flag:
        return True, False, now
    if eligible and not alloc.follow_up_eval_id:
        return False, True, when
    return False, False, 0.0


@dataclasses.dataclass
class DelayedRescheduleInfo:
    alloc_id: str
    alloc: Allocation
    reschedule_time: float


def filter_by_rescheduleable(a: AllocSet, is_batch: bool, now: float,
                             eval_id: str, deployment: Optional[Deployment]
                             ) -> tuple[AllocSet, AllocSet,
                                        list[DelayedRescheduleInfo]]:
    """(untainted, reschedule_now, reschedule_later) — ref
    reconcile_util.go:257."""
    untainted: AllocSet = {}
    reschedule_now: AllocSet = {}
    reschedule_later: list[DelayedRescheduleInfo] = []
    for aid, alloc in a.items():
        # already replaced
        if alloc.next_allocation and alloc.terminal_status():
            continue
        is_untainted, ignore = should_filter(alloc, is_batch)
        if is_untainted:
            untainted[aid] = alloc
        if is_untainted or ignore:
            continue
        now_flag, later_flag, when = update_by_reschedulable(
            alloc, now, eval_id, deployment)
        if now_flag:
            reschedule_now[aid] = alloc
        else:
            untainted[aid] = alloc
            if later_flag:
                reschedule_later.append(DelayedRescheduleInfo(aid, alloc, when))
    return untainted, reschedule_now, reschedule_later


def filter_by_deployment(a: AllocSet, deployment_id: str
                         ) -> tuple[AllocSet, AllocSet]:
    """(part of deployment, not part) — ref reconcile_util.go."""
    match: AllocSet = {}
    nonmatch: AllocSet = {}
    for aid, alloc in a.items():
        if alloc.deployment_id == deployment_id:
            match[aid] = alloc
        else:
            nonmatch[aid] = alloc
    return match, nonmatch


def delay_by_stop_after_client_disconnect(lost: AllocSet
                                          ) -> list[DelayedRescheduleInfo]:
    """Lost allocs whose group sets stop_after_client_disconnect get a delayed
    stop instead of an immediate one (ref reconcile_util.go)."""
    out = []
    for alloc in lost.values():
        if alloc.job is None:
            continue
        tg = alloc.job.lookup_task_group(alloc.task_group)
        if tg is None or tg.stop_after_client_disconnect_sec is None:
            continue
        when = alloc.last_event_time() + tg.stop_after_client_disconnect_sec
        out.append(DelayedRescheduleInfo(alloc.id, alloc, when))
    return out


class AllocNameIndex:
    """Tracks which alloc name indexes are in use (ref reconcile_util.go
    newAllocNameIndex + bitmapFrom)."""

    def __init__(self, job_id: str, task_group: str, count: int,
                 in_use: AllocSet):
        self.job_id = job_id
        self.task_group = task_group
        self.count = count
        self.used: set[int] = set()
        for alloc in in_use.values():
            idx = alloc_name_index(alloc.name)
            if idx >= 0:
                self.used.add(idx)

    def _name(self, idx: int) -> str:
        return alloc_name(self.job_id, self.task_group, idx)

    def highest(self, n: int) -> set[str]:
        """The n highest used names, removing them from the index."""
        out: set[str] = set()
        for idx in sorted(self.used, reverse=True):
            if len(out) >= n:
                break
            out.add(self._name(idx))
            self.used.discard(idx)
        return out

    def unset_index(self, idx: int) -> None:
        self.used.discard(idx)

    def next(self, n: int) -> list[str]:
        """Next n free names within [0, count), overflowing past count."""
        if not self.used:
            # fresh job: every index is free — mint in one comprehension
            # (a 50k-instance job calls this once with n == count)
            prefix = f"{self.job_id}.{self.task_group}["
            self.used.update(range(n))
            return [f"{prefix}{i}]" for i in range(n)]
        out: list[str] = []
        for idx in range(self.count):
            if len(out) == n:
                return out
            if idx not in self.used:
                out.append(self._name(idx))
                self.used.add(idx)
        idx = self.count
        while len(out) < n:
            if idx not in self.used:
                out.append(self._name(idx))
                self.used.add(idx)
            idx += 1
        return out

    def next_canaries(self, n: int, existing: AllocSet,
                      destructive: AllocSet) -> list[str]:
        """Canary names: prefer indexes of destructive updates, then free
        indexes, then indexes past count (ref NextCanaries)."""
        out: list[str] = []
        existing_names = name_set(existing)
        destructive_idx = sorted({alloc_name_index(a.name)
                                  for a in destructive.values()} - {-1})
        for idx in destructive_idx:
            if len(out) == n:
                return out
            nm = self._name(idx)
            if nm not in existing_names:
                out.append(nm)
                self.used.add(idx)
        for idx in range(self.count):
            if len(out) == n:
                return out
            if idx not in self.used:
                nm = self._name(idx)
                if nm not in existing_names:
                    out.append(nm)
                    self.used.add(idx)
        idx = self.count
        while len(out) < n:
            out.append(self._name(idx))
            idx += 1
        return out
