"""The allocation reconciler (ref scheduler/reconcile.go): diffs desired
(job) against actual (allocs) into place/stop/migrate/in-place/destructive/
canary sets, driving deployments and reschedules. Pure set algebra — no
placement decisions here; that's the stack/solver's job.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..structs import (
    Allocation, Deployment, DeploymentState, DeploymentStatusUpdate,
    DesiredUpdates, Evaluation, Job, Node, TaskGroup, new_deployment,
    ALLOC_CLIENT_LOST, ALLOC_CLIENT_RUNNING, ALLOC_CLIENT_UNKNOWN,
    DESC_CANARY, DESC_MIGRATING, DESC_NOT_NEEDED,
    DESC_RESCHEDULED, DEPLOYMENT_STATUS_FAILED, DEPLOYMENT_STATUS_PAUSED,
    DEPLOYMENT_STATUS_PENDING, DEPLOYMENT_STATUS_RUNNING,
    DEPLOYMENT_STATUS_SUCCESSFUL, DEPLOYMENT_STATUS_CANCELLED,
    EVAL_STATUS_PENDING, TRIGGER_FAILED_FOLLOW_UP, TRIGGER_MAX_DISCONNECT,
    JOB_TYPE_BATCH,
)
from .reconcile_util import (
    AllocNameIndex, AllocSet, DelayedRescheduleInfo, alloc_matrix, difference,
    delay_by_stop_after_client_disconnect, filter_by_deployment,
    filter_by_rescheduleable, filter_by_tainted, filter_by_terminal, from_keys,
    name_order, name_set, split_disconnecting, split_reconnecting, union,
)

DESC_DEPLOYMENT_CANCELLED = "cancelled because job is stopped or newer version"
DESC_UNKNOWN = "alloc is unknown since its node is disconnected"
DESC_RECONNECTED = "replacement stopped: original alloc reconnected"
DESC_RECONNECT_EXPIRED = "alloc reconnected after max_client_disconnect"
DESC_RECONNECT_OK = "alloc reconnected within max_client_disconnect"
DESC_RECONNECT_OUTDATED = "reconnected alloc is an outdated job version"
DESC_DUP_NAME = "duplicate name slot holder"


def _rank_name_slot_holders(group: list) -> list:
    """Order duplicate holders of one name slot best-first: live before
    terminal, then highest job version, then the earliest-created (the
    true original). Shared by the reconnect same-pass dedup and the
    computeStop convergent cleanup so the keeper policy can't diverge."""
    return sorted(group, key=lambda p: (
        p[1].terminal_status(),
        -(p[1].job.version if p[1].job else 0),
        p[1].create_index))


@dataclasses.dataclass(slots=True)
class AllocPlaceResult:
    """One placement the scheduler must make (ref reconcile_util.go
    allocPlaceResult)."""
    name: str
    task_group: TaskGroup
    previous_alloc: Optional[Allocation] = None
    reschedule: bool = False
    canary: bool = False
    lost: bool = False
    downgrade_non_canary: bool = False
    min_job_version: int = 0


@dataclasses.dataclass(slots=True)
class AllocStopResult:
    alloc: Allocation
    client_status: str = ""
    status_description: str = ""
    follow_up_eval_id: str = ""


@dataclasses.dataclass(slots=True)
class AllocDestructiveResult:
    place_name: str
    place_task_group: TaskGroup
    stop_alloc: Allocation
    stop_status_description: str = "alloc is being updated due to job update"


@dataclasses.dataclass
class ReconcileResults:
    """ref reconcile.go reconcileResults"""
    deployment: Optional[Deployment] = None
    deployment_updates: list[DeploymentStatusUpdate] = dataclasses.field(
        default_factory=list)
    place: list[AllocPlaceResult] = dataclasses.field(default_factory=list)
    destructive_update: list[AllocDestructiveResult] = dataclasses.field(
        default_factory=list)
    inplace_update: list[Allocation] = dataclasses.field(default_factory=list)
    stop: list[AllocStopResult] = dataclasses.field(default_factory=list)
    attribute_updates: dict[str, Allocation] = dataclasses.field(
        default_factory=dict)
    desired_tg_updates: dict[str, DesiredUpdates] = dataclasses.field(
        default_factory=dict)
    desired_followup_evals: dict[str, list[Evaluation]] = dataclasses.field(
        default_factory=dict)


class AllocReconciler:
    """ref reconcile.go:40 allocReconciler"""

    def __init__(self, alloc_update_fn: Callable, batch: bool, job_id: str,
                 job: Optional[Job], deployment: Optional[Deployment],
                 existing_allocs: list[Allocation],
                 tainted_nodes: dict[str, Optional[Node]], eval_id: str,
                 eval_priority: int, now: float):
        self.alloc_update_fn = alloc_update_fn
        self.batch = batch
        self.job_id = job_id
        self.job = job
        self.deployment = deployment.copy() if deployment else None
        self.old_deployment: Optional[Deployment] = None
        self.existing_allocs = existing_allocs
        self.tainted = tainted_nodes
        self.eval_id = eval_id
        self.eval_priority = eval_priority
        self.now = now
        self.deployment_paused = False
        self.deployment_failed = False
        self.result = ReconcileResults()

    # ------------------------------------------------------------- compute

    def compute(self) -> ReconcileResults:
        """ref reconcile.go:189 Compute"""
        # parameterized/periodic PARENTS never place — children do. The
        # register path already skips eval creation for parents (ref
        # job_endpoint.go:365); treating a stray parent eval as stopped
        # makes that invariant defensive rather than upstream-only.
        stopped = self.job is None or self.job.stopped() or \
            self.job.is_parameterized() or self.job.is_periodic()
        if not stopped:
            self._cancel_unneeded_deployments()

        if self.deployment is not None:
            self.deployment_paused = self.deployment.status in (
                DEPLOYMENT_STATUS_PAUSED, DEPLOYMENT_STATUS_PENDING)
            self.deployment_failed = \
                self.deployment.status == DEPLOYMENT_STATUS_FAILED

        m = alloc_matrix(self.job if not stopped else None,
                         self.existing_allocs)

        if stopped:
            self._handle_stop(m)
            if self.deployment is not None and self.deployment.active():
                self.result.deployment_updates.append(DeploymentStatusUpdate(
                    deployment_id=self.deployment.id,
                    status=DEPLOYMENT_STATUS_CANCELLED,
                    status_description=DESC_DEPLOYMENT_CANCELLED))
            return self.result

        complete = True
        for group, allocs in m.items():
            if not self._compute_group(group, allocs):
                complete = False

        # deployment completion
        if self.deployment is not None and complete and \
           self.deployment.status == DEPLOYMENT_STATUS_RUNNING:
            self.result.deployment_updates.append(DeploymentStatusUpdate(
                deployment_id=self.deployment.id,
                status=DEPLOYMENT_STATUS_SUCCESSFUL,
                status_description="deployment completed successfully"))
        return self.result

    def _cancel_unneeded_deployments(self) -> None:
        """ref reconcile.go cancelUnneededDeployments"""
        d = self.deployment
        if d is None:
            return
        if d.job_version != self.job.version or \
           d.job_create_index != self.job.create_index:
            if d.active():
                self.result.deployment_updates.append(DeploymentStatusUpdate(
                    deployment_id=d.id,
                    status=DEPLOYMENT_STATUS_CANCELLED,
                    status_description=DESC_DEPLOYMENT_CANCELLED))
            self.old_deployment = d
            self.deployment = None
        elif not d.active():
            self.old_deployment = d
            self.deployment = None

    def _handle_stop(self, m: dict[str, AllocSet]) -> None:
        for group, allocs in m.items():
            desired = self.result.desired_tg_updates.setdefault(
                group, DesiredUpdates())
            untainted, migrate, lost = filter_by_tainted(allocs, self.tainted)
            live = filter_by_terminal(untainted)
            self._mark_stop(live, "", DESC_NOT_NEEDED)
            self._mark_stop(migrate, "", DESC_NOT_NEEDED)
            self._mark_stop(lost, ALLOC_CLIENT_LOST, DESC_NOT_NEEDED)
            desired.stop += len(live) + len(migrate) + len(lost)

    def _mark_stop(self, allocs: AllocSet, client_status: str,
                   desc: str) -> None:
        for alloc in allocs.values():
            self.result.stop.append(AllocStopResult(
                alloc=alloc, client_status=client_status,
                status_description=desc))

    def _mark_delayed(self, allocs: AllocSet, client_status: str, desc: str,
                      followup: dict[str, str]) -> None:
        for alloc in allocs.values():
            self.result.stop.append(AllocStopResult(
                alloc=alloc, client_status=client_status,
                status_description=desc,
                follow_up_eval_id=followup.get(alloc.id, "")))

    # ------------------------------------------------------ per-group logic

    def _compute_group(self, group: str, all_allocs: AllocSet) -> bool:
        """ref reconcile.go:346 computeGroup"""
        desired = self.result.desired_tg_updates.setdefault(
            group, DesiredUpdates())
        tg = self.job.lookup_task_group(group)

        if tg is None:
            # group removed: stop everything
            untainted, migrate, lost = filter_by_tainted(all_allocs, self.tainted)
            live = filter_by_terminal(untainted)
            self._mark_stop(live, "", DESC_NOT_NEEDED)
            self._mark_stop(migrate, "", DESC_NOT_NEEDED)
            self._mark_stop(lost, ALLOC_CLIENT_LOST, DESC_NOT_NEEDED)
            desired.stop += len(live) + len(migrate) + len(lost)
            return True

        # deployment state for the group
        dstate: Optional[DeploymentState] = None
        existing_deployment = False
        if self.deployment is not None and group in self.deployment.task_groups:
            dstate = self.deployment.task_groups[group]
            existing_deployment = True
        if not existing_deployment:
            dstate = DeploymentState()
            if tg.update is not None:
                dstate.auto_revert = tg.update.auto_revert
                dstate.auto_promote = tg.update.auto_promote
                dstate.progress_deadline_sec = tg.update.progress_deadline_sec

        # old terminal batch allocs are ignored
        all_allocs, ignored = self._filter_old_terminal_allocs(all_allocs)
        desired.ignore += len(ignored)

        canaries, all_allocs = self._handle_group_canaries(all_allocs,
                                                           desired, tg)

        untainted, migrate, lost = filter_by_tainted(all_allocs, self.tainted)

        # graceful client disconnection (ref 1.3 reconcile_util.go
        # disconnecting/reconnecting + reconcile.go reconcileReconnecting):
        # with max_client_disconnect, a running alloc on a down node rides
        # out the window as `unknown` (replacement placed alongside);
        # if the client returns inside the window the original wins and
        # the replacement stops.
        disconnecting, lost = split_disconnecting(tg, lost, self.now)
        reconnecting, untainted = split_reconnecting(untainted)
        self._handle_disconnecting(tg, group, disconnecting)
        untainted = self._handle_reconnecting(tg, group, reconnecting,
                                              untainted)

        untainted, reschedule_now, reschedule_later = filter_by_rescheduleable(
            untainted, self.batch, self.now, self.eval_id, self.deployment)

        lost_later = delay_by_stop_after_client_disconnect(lost)
        lost_later_evals = self._create_timeout_later_evals(lost_later, group)

        self._handle_delayed_reschedules(reschedule_later, group)

        # name-slot membership as a fixed-shape masked tensor (ISSUE 15):
        # the twin's selection ops are field-exact with AllocNameIndex
        # (fuzz-pinned); NOMAD_RECONCILE_TENSOR=0 restores the set walk
        from .reconcile_tensor import make_name_index
        name_index = make_name_index(
            self.job_id, group, tg.count,
            union(untainted, migrate, reschedule_now, lost))

        canary_state = (dstate is not None and dstate.desired_canaries != 0
                        and not dstate.promoted)
        stop = self._compute_stop(tg, name_index, untainted, migrate, lost,
                                  canaries, canary_state, lost_later_evals)
        desired.stop += len(stop)
        untainted = difference(untainted, stop)

        ignore, inplace, destructive = self._compute_updates(tg, untainted)
        desired.ignore += len(ignore)
        desired.in_place_update += len(inplace)
        if not existing_deployment:
            dstate.desired_total += len(destructive) + len(inplace)

        if canary_state:
            untainted = difference(untainted, canaries)

        # canary requirement
        strategy = tg.update
        canaries_promoted = dstate is not None and dstate.promoted
        require_canary = (len(destructive) != 0 and strategy is not None and
                          strategy.canary > 0 and
                          len(canaries) < strategy.canary and
                          not canaries_promoted)
        if require_canary:
            dstate.desired_canaries = strategy.canary
        if require_canary and not self.deployment_paused and \
           not self.deployment_failed:
            number = strategy.canary - len(canaries)
            desired.canary += number
            for nm in name_index.next_canaries(number, canaries, destructive):
                self.result.place.append(AllocPlaceResult(
                    name=nm, canary=True, task_group=tg))

        canary_state = (dstate is not None and dstate.desired_canaries != 0
                        and not dstate.promoted)
        limit = self._compute_limit(tg, untainted, destructive, migrate,
                                    canary_state)

        place: list[AllocPlaceResult] = []
        if len(lost_later) == 0:
            place = self._compute_placements(
                tg, name_index, untainted, migrate, reschedule_now,
                canary_state, lost)
            if not existing_deployment:
                dstate.desired_total += len(place)

        deployment_place_ready = (not self.deployment_paused and
                                  not self.deployment_failed and
                                  not canary_state)
        if deployment_place_ready:
            desired.place += len(place)
            self.result.place.extend(place)
            self._mark_stop(reschedule_now, "", DESC_RESCHEDULED)
            desired.stop += len(reschedule_now)
            limit -= min(len(place), limit)
        else:
            if lost:
                allowed = min(len(lost), len(place))
                desired.place += allowed
                self.result.place.extend(place[:allowed])
            if reschedule_now:
                for p in place:
                    prev = p.previous_alloc
                    if p.reschedule and not (
                            self.deployment_failed and prev is not None and
                            self.deployment is not None and
                            self.deployment.id == prev.deployment_id):
                        self.result.place.append(p)
                        desired.place += 1
                        self.result.stop.append(AllocStopResult(
                            alloc=prev, status_description=DESC_RESCHEDULED))
                        desired.stop += 1

        if deployment_place_ready:
            n = min(len(destructive), limit)
            desired.destructive_update += n
            desired.ignore += len(destructive) - n
            for alloc in name_order(destructive)[:n]:
                self.result.destructive_update.append(AllocDestructiveResult(
                    place_name=alloc.name, place_task_group=tg,
                    stop_alloc=alloc))
        else:
            desired.ignore += len(destructive)

        # migrations
        desired.migrate += len(migrate)
        for alloc in name_order(migrate):
            self.result.stop.append(AllocStopResult(
                alloc=alloc, status_description=DESC_MIGRATING))
            self.result.place.append(AllocPlaceResult(
                name=alloc.name, task_group=tg, previous_alloc=alloc,
                canary=(alloc.deployment_status.canary
                        if alloc.deployment_status else False),
                downgrade_non_canary=(canary_state and not (
                    alloc.deployment_status and alloc.deployment_status.canary)),
                min_job_version=alloc.job.version if alloc.job else 0))

        # create deployment if needed
        updating_spec = bool(destructive) or bool(self.result.inplace_update)
        had_running = any(
            a.job is not None and a.job.version == self.job.version and
            a.job.create_index == self.job.create_index
            for a in all_allocs.values())
        if not existing_deployment and strategy is not None and \
           strategy.rolling() and dstate.desired_total != 0 and \
           (not had_running or updating_spec):
            if self.deployment is None:
                self.deployment = new_deployment(self.job, self.now)
                self.result.deployment = self.deployment
            self.deployment.task_groups[group] = dstate

        complete = (len(destructive) + len(inplace) + len(place) +
                    len(migrate) + len(reschedule_now) +
                    len(reschedule_later) == 0 and not require_canary)
        if complete and self.deployment is not None:
            ds = self.deployment.task_groups.get(group)
            if ds is not None:
                if ds.healthy_allocs < max(ds.desired_total,
                                           ds.desired_canaries) or \
                   (ds.desired_canaries > 0 and not ds.promoted):
                    complete = False
        return complete

    # ---------------------------------------------------------- sub-steps

    def _filter_old_terminal_allocs(self, all_allocs: AllocSet
                                    ) -> tuple[AllocSet, AllocSet]:
        """ref reconcile.go filterOldTerminalAllocs (batch only)"""
        if not self.batch:
            return all_allocs, {}
        filtered = dict(all_allocs)
        ignored: AllocSet = {}
        for aid, alloc in list(filtered.items()):
            older = (alloc.job is not None and
                     (alloc.job.version < self.job.version or
                      alloc.job.create_index < self.job.create_index))
            if older and alloc.terminal_status():
                del filtered[aid]
                ignored[aid] = alloc
        return filtered, ignored

    def _handle_group_canaries(self, all_allocs: AllocSet,
                               desired: DesiredUpdates, tg
                               ) -> tuple[AllocSet, AllocSet]:
        """ref reconcile.go handleGroupCanaries"""
        stop_ids: list[str] = []
        if self.old_deployment is not None:
            for ds in self.old_deployment.task_groups.values():
                if not ds.promoted:
                    stop_ids.extend(ds.placed_canaries)
        if self.deployment is not None and \
           self.deployment.status == DEPLOYMENT_STATUS_FAILED:
            for ds in self.deployment.task_groups.values():
                if not ds.promoted:
                    stop_ids.extend(ds.placed_canaries)
        stop_set = from_keys(all_allocs, stop_ids)
        self._mark_stop(stop_set, "", DESC_NOT_NEEDED)
        desired.stop += len(stop_set)
        all_allocs = difference(all_allocs, stop_set)

        canaries: AllocSet = {}
        if self.deployment is not None:
            canary_ids: list[str] = []
            for ds in self.deployment.task_groups.values():
                canary_ids.extend(ds.placed_canaries)
            canaries = from_keys(all_allocs, canary_ids)
            untainted, migrate, lost = filter_by_tainted(canaries, self.tainted)
            # 1.3 analog: a canary on a disconnected node rides the
            # max_client_disconnect window like any other alloc — it is
            # LEFT in the group set so the disconnect split marks it
            # unknown, and its absence from `canaries` makes the canary
            # top-up place a replacement; on reconnect the generic
            # name-slot logic stops the replacement.
            _disconnecting, lost = split_disconnecting(tg, lost, self.now)
            self._mark_stop(migrate, "", DESC_MIGRATING)
            self._mark_stop(lost, ALLOC_CLIENT_LOST, "alloc lost")
            canaries = untainted
            all_allocs = difference(all_allocs, migrate, lost)
        return canaries, all_allocs

    def _compute_limit(self, tg: TaskGroup, untainted: AllocSet,
                       destructive: AllocSet, migrate: AllocSet,
                       canary_state: bool) -> int:
        """ref reconcile.go:671 computeLimit"""
        if tg.update is None or not tg.update.rolling() or \
           len(destructive) + len(migrate) == 0:
            return tg.count
        if self.deployment_paused or self.deployment_failed:
            return 0
        if canary_state:
            return 0
        limit = tg.update.max_parallel
        if self.deployment is not None:
            part_of, _ = filter_by_deployment(untainted, self.deployment.id)
            for alloc in part_of.values():
                if alloc.deployment_status is not None and \
                   alloc.deployment_status.is_unhealthy():
                    return 0
                if not (alloc.deployment_status is not None and
                        alloc.deployment_status.is_healthy()):
                    limit -= 1
        return max(0, limit)

    def _compute_placements(self, tg: TaskGroup, name_index: AllocNameIndex,
                            untainted: AllocSet, migrate: AllocSet,
                            reschedule: AllocSet, canary_state: bool,
                            lost: AllocSet) -> list[AllocPlaceResult]:
        """ref reconcile.go:717 computePlacements"""
        place: list[AllocPlaceResult] = []
        for alloc in reschedule.values():
            place.append(AllocPlaceResult(
                name=alloc.name, task_group=tg, previous_alloc=alloc,
                reschedule=True,
                canary=(alloc.deployment_status.canary
                        if alloc.deployment_status else False),
                downgrade_non_canary=(canary_state and not (
                    alloc.deployment_status and alloc.deployment_status.canary)),
                min_job_version=alloc.job.version if alloc.job else 0))
        existing = len(untainted) + len(migrate) + len(reschedule)
        # a lost alloc's name slot may ALREADY be covered: an unknown
        # original that rode the max_client_disconnect window got a
        # same-name replacement placed beside it — when it finally goes
        # lost (window expiry / repeat node-down), replacing it again
        # would double-fill the slot (two live non-canary holders). Only
        # possible through the 1.3 disconnect flow; plain lost names are
        # never held by untainted allocs.
        held = {a.name for s in (untainted, migrate, reschedule)
                for a in s.values()}
        for alloc in lost.values():
            if existing >= tg.count:
                break
            if alloc.name in held:
                continue
            existing += 1
            place.append(AllocPlaceResult(
                name=alloc.name, task_group=tg, previous_alloc=alloc,
                reschedule=False, lost=True,
                canary=(alloc.deployment_status.canary
                        if alloc.deployment_status else False),
                downgrade_non_canary=(canary_state and not (
                    alloc.deployment_status and alloc.deployment_status.canary)),
                min_job_version=alloc.job.version if alloc.job else 0))
        if existing < tg.count:
            # fresh slots are uniform except for the name: batch-stamp
            # them (a 50k-instance job mints 50k results here — dataclass
            # __init__ frames were a visible slice of reconcile)
            from ..structs.fastbatch import stamp_batch
            names = name_index.next(tg.count - existing)
            place.extend(stamp_batch(
                AllocPlaceResult, len(names),
                shared={"task_group": tg,
                        "downgrade_non_canary": canary_state},
                varying={"name": names}))
        return place

    def _compute_stop(self, tg: TaskGroup, name_index: AllocNameIndex,
                      untainted: AllocSet, migrate: AllocSet, lost: AllocSet,
                      canaries: AllocSet, canary_state: bool,
                      followup_evals: dict[str, str]) -> AllocSet:
        """ref reconcile.go:777 computeStop"""
        stop: AllocSet = {}
        stop.update(lost)
        self._mark_delayed(lost, ALLOC_CLIENT_LOST, "alloc lost",
                           followup_evals)

        if canary_state:
            untainted = difference(untainted, canaries)

        # convergent duplicate-name cleanup: historical churn (disconnect
        # replacements, same-pass reconnects, lost-of-unknown) can leave
        # two live holders of one name slot even when the total is within
        # count — and once present, a duplicate self-propagates (each
        # holder gets its own migrate/lost replacement). Stop the extras
        # (keep highest job version, then the earliest-created) so every
        # pass strictly reduces duplication; the freed coverage is placed
        # under a FRESH name by computePlacements.
        by_name: dict = {}
        for aid, alloc in untainted.items():
            by_name.setdefault(alloc.name, []).append((aid, alloc))
        dups = [g for g in by_name.values() if len(g) > 1]
        if dups:
            untainted = dict(untainted)
            for group in dups:
                for aid, alloc in _rank_name_slot_holders(group)[1:]:
                    if alloc.terminal_status():
                        continue
                    stop[aid] = alloc
                    self.result.stop.append(AllocStopResult(
                        alloc=alloc, status_description=DESC_DUP_NAME))
                    untainted.pop(aid, None)

        remove = len(untainted) + len(migrate) - tg.count
        if remove <= 0:
            return stop

        untainted = filter_by_terminal(untainted)

        # prefer stopping duplicates of promoted canary names
        if not canary_state and canaries:
            canary_names = name_set(canaries)
            for aid, alloc in list(difference(untainted, canaries).items()):
                if alloc.name in canary_names:
                    stop[aid] = alloc
                    self.result.stop.append(AllocStopResult(
                        alloc=alloc, status_description=DESC_NOT_NEEDED))
                    untainted.pop(aid, None)
                    remove -= 1
                    if remove == 0:
                        return stop

        # prefer stopping migrating allocs
        if migrate:
            from .reconcile_tensor import make_name_index
            m_index = make_name_index(self.job_id, tg.name, tg.count,
                                      dict(migrate))
            remove_names = m_index.highest(remove)
            for aid, alloc in list(migrate.items()):
                if alloc.name not in remove_names:
                    continue
                self.result.stop.append(AllocStopResult(
                    alloc=alloc, status_description=DESC_NOT_NEEDED))
                migrate.pop(aid)
                stop[aid] = alloc
                from ..structs import alloc_name_index as _ani
                name_index.unset_index(_ani(alloc.name))
                remove -= 1
                if remove == 0:
                    return stop

        # stop highest-indexed names
        remove_names = name_index.highest(remove)
        for aid, alloc in list(untainted.items()):
            if alloc.name in remove_names:
                stop[aid] = alloc
                self.result.stop.append(AllocStopResult(
                    alloc=alloc, status_description=DESC_NOT_NEEDED))
                untainted.pop(aid)
                remove -= 1
                if remove == 0:
                    return stop

        # duplicate names fallback
        for aid, alloc in list(untainted.items()):
            stop[aid] = alloc
            self.result.stop.append(AllocStopResult(
                alloc=alloc, status_description=DESC_NOT_NEEDED))
            untainted.pop(aid)
            remove -= 1
            if remove == 0:
                return stop
        return stop

    def _compute_updates(self, tg: TaskGroup, untainted: AllocSet
                         ) -> tuple[AllocSet, AllocSet, AllocSet]:
        """ref reconcile.go:887 computeUpdates"""
        ignore: AllocSet = {}
        inplace: AllocSet = {}
        destructive: AllocSet = {}
        for aid, alloc in untainted.items():
            ignore_change, destructive_change, inplace_alloc = \
                self.alloc_update_fn(alloc, self.job, tg)
            if ignore_change:
                ignore[aid] = alloc
            elif destructive_change:
                destructive[aid] = alloc
            else:
                inplace[aid] = alloc
                if inplace_alloc is not None:
                    self.result.inplace_update.append(inplace_alloc)
        return ignore, inplace, destructive

    def _handle_delayed_reschedules(self, infos: list[DelayedRescheduleInfo],
                                    tg_name: str) -> None:
        """Batched follow-up evals for later reschedules
        (ref reconcile.go:911 handleDelayedReschedules)."""
        self._create_followup_evals(infos, tg_name, mark_followup=True)

    def _create_timeout_later_evals(self, infos: list[DelayedRescheduleInfo],
                                    tg_name: str,
                                    trigger: str = TRIGGER_FAILED_FOLLOW_UP
                                    ) -> dict[str, str]:
        return self._create_followup_evals(infos, tg_name,
                                           mark_followup=False,
                                           trigger=trigger)

    # ------------------------------------ graceful client disconnection

    def _handle_disconnecting(self, tg, group: str,
                              disconnecting: dict) -> None:
        """Mark newly-disconnected allocs `unknown` (plan attribute
        update stamping disconnected_at) and schedule the expiry eval
        that turns them lost if the client never returns (ref 1.3
        reconcile.go appendUnknownUpdates + createTimeoutLaterEvals)."""
        if not disconnecting:
            return
        window = tg.max_client_disconnect_sec or 0.0
        infos = []
        for aid, alloc in disconnecting.items():
            since = alloc.disconnected_at
            if alloc.client_status != ALLOC_CLIENT_UNKNOWN or not since:
                updated = alloc.copy()
                updated.client_status = ALLOC_CLIENT_UNKNOWN
                updated.client_description = DESC_UNKNOWN
                updated.disconnected_at = since = self.now
                self.result.attribute_updates[aid] = updated
                # expiry eval only on the FIRST (marking) pass —
                # re-evals during the window would pile up duplicates
                infos.append(DelayedRescheduleInfo(
                    alloc_id=aid, alloc=alloc,
                    reschedule_time=since + window))
        self._create_timeout_later_evals(infos, group,
                                         trigger=TRIGGER_MAX_DISCONNECT)
        desired = self.result.desired_tg_updates.setdefault(
            group, DesiredUpdates())
        desired.ignore += len(disconnecting)

    def _handle_reconnecting(self, tg, group: str, reconnecting: dict,
                             untainted: dict) -> dict:
        """The client returned: inside the window the ORIGINAL alloc
        wins its name slot back and any replacement stops; PAST the
        window the original is expired — it stops and the replacement
        keeps the slot (ref 1.3 reconcile.go reconcileReconnecting,
        which stops Expired originals rather than churning the workload
        back onto a flapping node)."""
        if not reconnecting:
            return untainted
        desired = self.result.desired_tg_updates.setdefault(
            group, DesiredUpdates())
        window = tg.max_client_disconnect_sec or 0.0
        fresh: dict = {}
        for aid, alloc in reconnecting.items():
            since = alloc.disconnected_at
            if since and self.now >= since + window:
                # reconnected too late: the replacement won
                self.result.stop.append(AllocStopResult(
                    alloc=alloc, client_status=ALLOC_CLIENT_LOST,
                    status_description=DESC_RECONNECT_EXPIRED))
                desired.stop += 1
            elif alloc.job is not None and self.job is not None and (
                    alloc.job.version < self.job.version or
                    alloc.job.create_index < self.job.create_index):
                # the job was UPDATED while the client was away: the
                # stale original stops and the (newer-version)
                # replacement keeps the slot — restoring the original
                # would mislabel old task config as the new version,
                # since placements/updates normalize alloc.job to the
                # plan job (ref reconcileReconnecting: reconnecting
                # allocs needing an update are stopped, newer pickers
                # keep the highest job version)
                self.result.stop.append(AllocStopResult(
                    alloc=alloc,
                    status_description=DESC_RECONNECT_OUTDATED))
                desired.stop += 1
            else:
                fresh[aid] = alloc
        # the original AND its window-replacement can both have gone
        # unknown (second node-down) and reconnect in the SAME pass —
        # each looks like "the original", so without a per-name pick
        # both restore and double-fill the slot. Keep one per name:
        # highest job version, then the earliest-created (the true
        # original) — the reference's reconnecting picker default.
        by_name: dict = {}
        for aid, alloc in fresh.items():
            by_name.setdefault(alloc.name, []).append((aid, alloc))
        for name, group in by_name.items():
            if len(group) == 1:
                continue
            for aid, alloc in _rank_name_slot_holders(group)[1:]:
                self.result.stop.append(AllocStopResult(
                    alloc=alloc, status_description=DESC_RECONNECTED))
                desired.stop += 1
                del fresh[aid]
        originals_by_name = {a.name: aid for aid, a in fresh.items()}
        for aid, alloc in list(untainted.items()):
            orig = originals_by_name.get(alloc.name)
            if orig is None or aid == orig or \
                    alloc.server_terminal_status():
                # already desired-stop needs nothing; a client-FAILED
                # replacement still needs the stop so it can't flow into
                # reschedule_now beside the reconnected original (ref
                # gates on ServerTerminalStatus)
                continue
            # a replacement placed during the disconnect: stop it
            self.result.stop.append(AllocStopResult(
                alloc=alloc, client_status="",
                status_description=DESC_RECONNECTED))
            desired.stop += 1
            del untainted[aid]
        for aid, alloc in fresh.items():
            # flip back to running: the client's change-driven sync won't
            # re-push an unchanged status, and the alloc was running when
            # it went unknown (a task that actually died surfaces as a
            # NEW failed update, which does sync)
            updated = alloc.copy()
            updated.client_status = ALLOC_CLIENT_RUNNING
            updated.client_description = DESC_RECONNECT_OK
            updated.disconnected_at = 0.0
            self.result.attribute_updates[aid] = updated
            untainted[aid] = updated
        return untainted

    def _create_followup_evals(self, infos: list[DelayedRescheduleInfo],
                               tg_name: str, mark_followup: bool,
                               trigger: str = TRIGGER_FAILED_FOLLOW_UP
                               ) -> dict[str, str]:
        if not infos:
            return {}
        infos = sorted(infos, key=lambda i: i.reschedule_time)
        # batch into 5s windows (ref batchedFailedAllocWindowSize)
        window = 5.0
        evals: list[Evaluation] = []
        alloc_to_eval: dict[str, str] = {}
        cur_eval: Optional[Evaluation] = None
        cur_end = 0.0
        for info in infos:
            if cur_eval is None or info.reschedule_time > cur_end:
                cur_eval = Evaluation(
                    namespace=self.job.namespace if self.job else "default",
                    priority=self.eval_priority,
                    type=self.job.type if self.job else "service",
                    triggered_by=trigger,
                    job_id=self.job_id,
                    status=EVAL_STATUS_PENDING,
                    wait_until_unix=info.reschedule_time)
                cur_end = info.reschedule_time + window
                evals.append(cur_eval)
            alloc_to_eval[info.alloc_id] = cur_eval.id
        self.result.desired_followup_evals.setdefault(tg_name, []).extend(evals)
        if mark_followup:
            for info in infos:
                updated = info.alloc.copy()
                updated.follow_up_eval_id = alloc_to_eval[info.alloc_id]
                self.result.attribute_updates[updated.id] = updated
        return alloc_to_eval
