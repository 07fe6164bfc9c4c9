"""Generic scheduler for service and batch jobs
(ref scheduler/generic_sched.go).

Process(eval) -> plan(s) submitted through the Planner interface. The
placement loop delegates to the GenericStack (CPU oracle) or to the TPU
batched solver when SchedulerConfiguration.scheduler_algorithm == "tpu-batch"
(the SURVEY.md north star: same reconciler, same plan semantics, batched
scoring).
"""
from __future__ import annotations

import random
import time
from typing import Optional

from ..structs import (
    AllocatedResources, Allocation,
    AllocDeploymentStatus, Evaluation, Job, Plan, PlanAnnotations,
    DesiredUpdates, DESC_CANARY, DESC_NODE_TAINTED,
    EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED, JOB_TYPE_BATCH,
    JOB_TYPE_SERVICE, TRIGGER_MAX_PLANS, TRIGGER_PREEMPTION,
    TRIGGER_RETRY_FAILED_ALLOC, new_id, SCHED_ALG_CONVEX, SCHED_ALG_TPU,
    skeleton_for,
)
from ..metrics import metrics
from ..obs import trace
from .context import EvalContext
from .reconcile import AllocReconciler, AllocPlaceResult
from .stack import GenericStack, SelectOptions
from .util import (
    generic_alloc_update_fn, ready_nodes_in_dcs, tainted_nodes,
    update_non_terminal_allocs_to_lost,
)

MAX_SERVICE_SCHEDULE_ATTEMPTS = 5   # ref generic_sched.go:18
MAX_BATCH_SCHEDULE_ATTEMPTS = 2     # ref generic_sched.go:22

BLOCKED_EVAL_MAX_PLAN_DESC = "created due to placement conflicts"
BLOCKED_EVAL_FAILED_PLACEMENTS_DESC = "created to place remaining allocations"


class SetStatusError(Exception):
    def __init__(self, err: str, eval_status: str):
        super().__init__(err)
        self.eval_status = eval_status


class GenericScheduler:
    """ref generic_sched.go:58"""

    def __init__(self, state, planner, batch: bool, logger=None):
        self.state = state          # snapshot (scheduler State interface)
        self.planner = planner      # Planner interface
        self.batch = batch
        self.logger = logger

        self.eval: Optional[Evaluation] = None
        self.job: Optional[Job] = None
        self.plan: Optional[Plan] = None
        self.plan_result = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[GenericStack] = None
        self.solver = None          # TPU batch solver, created lazily

        self.deployment = None
        self.blocked: Optional[Evaluation] = None
        self.failed_tg_allocs: dict[str, object] = {}
        # per-TG explain records from the tensor solve (ISSUE 11): the
        # placer registers one per solved task group so a failed
        # placement attaches the device-derived AllocMetric
        self.solver_explains: dict[str, object] = {}
        self.queued_allocs: dict[str, int] = {}
        self.followup_evals: dict[str, list[Evaluation]] = {}
        # set by the pipelined placer when an intermediate chunk plan
        # under-committed (optimistic-concurrency rejection mid-pipeline):
        # the pass must refresh state and retry, the same contract as a
        # partial commit of a serial plan
        self._pipeline_partial = False
        # per-scheduler ResourceSkeleton pool (structs/respool.py): the
        # host placement path shares each TG's immutable disk-only row
        # instead of minting one per allocation
        self._skel: dict = {}

    # ------------------------------------------------------------- process

    def process(self, eval: Evaluation) -> None:
        """ref generic_sched.go:125 Process"""
        self.eval = eval
        limit = (MAX_BATCH_SCHEDULE_ATTEMPTS if self.batch
                 else MAX_SERVICE_SCHEDULE_ATTEMPTS)
        try:
            success = self._retry_max(limit, self._process)
        except SetStatusError as e:
            self._set_status(e.eval_status, str(e))
            return
        if not success:
            # exceeded plan attempts: requeue as blocked
            blocked = eval.create_blocked_eval({}, True, "", self.failed_tg_allocs)
            blocked.triggered_by = TRIGGER_MAX_PLANS
            blocked.status_description = BLOCKED_EVAL_MAX_PLAN_DESC
            self.planner.create_eval(blocked)
            self._set_status(EVAL_STATUS_FAILED, "maximum attempts reached")
            return
        self._set_status(EVAL_STATUS_COMPLETE, "")

    def _retry_max(self, limit: int, fn) -> bool:
        attempts = 0
        while attempts < limit:
            if fn():
                return True
            attempts += 1
            # refresh state to latest on retry (ref worker RefreshIndex)
            self.state = self.planner.refresh_snapshot(self.state)
        return False

    def _process(self) -> bool:
        """One scheduling pass; returns True when done (ref
        generic_sched.go:216 process)."""
        eval = self.eval
        self.job = self.state.job_by_id(eval.namespace, eval.job_id)

        self._pipeline_partial = False
        self.failed_tg_allocs = {}
        self.solver_explains = {}
        self.queued_allocs = {tg.name: 0 for tg in
                              (self.job.task_groups if self.job else [])}
        self.plan = eval.make_plan(self.job)
        self.plan.snapshot_index = self.state.latest_index()

        if not self.batch:
            self.deployment = self.state.latest_deployment_by_job(
                eval.namespace, eval.job_id)
            if self.deployment is not None and not self.deployment.active():
                self.deployment = None

        self.ctx = EvalContext(self.state, self.plan, self.logger)
        # per-eval seeded rng (DET001): the stack's shuffle and the TPU
        # placer's permutation/jitter all draw from this stream, so one
        # (snapshot, eval) replays bit-identically while concurrent
        # workers (distinct eval ids) still decorrelate. str seeds hash
        # via sha512 — stable across processes, unlike hash().
        self.stack = GenericStack(self.batch, self.ctx,
                                  rng=random.Random(eval.id))
        if self.job and not self.job.stopped():
            ready, by_dc = ready_nodes_in_dcs(self.state, self.job.datacenters)
            self.ctx.metrics.nodes_available = by_dc
            self._nodes_by_dc = by_dc
            self.stack.set_nodes(ready)
            self.stack.set_job(self.job)
            self._ready_nodes = ready
        else:
            self._ready_nodes = []
            self._nodes_by_dc = {}

        # compute the changes
        if not self._compute_job_allocs():
            return False

        # if any placements failed, create/update a blocked eval
        if self.failed_tg_allocs and self.blocked is None:
            self.blocked = eval.create_blocked_eval(
                self.ctx.eligibility.get_classes(),
                self.ctx.eligibility.has_escaped(),
                self.ctx.eligibility.quota_reached,
                self.failed_tg_allocs)
            self.blocked.status_description = BLOCKED_EVAL_FAILED_PLACEMENTS_DESC
            self.planner.create_eval(self.blocked)

        # create follow-up evals for delayed reschedules
        for evals in self.followup_evals.values():
            for ev in evals:
                self.planner.create_eval(ev)

        eval.queued_allocations = dict(self.queued_allocs)

        if self.plan.is_no_op():
            # an intermediate pipelined chunk may have under-committed even
            # when the FINAL plan carries nothing: refresh and retry, the
            # same contract as a partial commit of a serial plan
            return not self._pipeline_partial

        if self.plan.annotations is not None:
            # resolved now that placement filled the plan (ref
            # structs.go PlanAnnotations.PreemptedAllocs)
            self.plan.annotations.preempted_allocs = [
                a.id for allocs in self.plan.node_preemptions.values()
                for a in allocs]
        result = self.planner.submit_plan(self.plan)
        self.plan_result = result
        if result is None:
            return False

        # partial application handling (ref generic_sched.go:317)
        full, expected, actual = result.full_commit(self.plan)
        if not full:
            if result.is_no_op():
                return False
            # progress was made; retry for the rest
            return False
        # the final plan committed fully, but a pipelined intermediate
        # chunk may have been rejected by the applier's latest-state
        # re-check: those placements never landed, so refresh and retry
        # exactly as a serial partial commit would
        return not self._pipeline_partial

    # ----------------------------------------------------- compute allocs

    def _compute_job_allocs(self) -> bool:
        """ref generic_sched.go:332 computeJobAllocs"""
        eval = self.eval
        allocs = self.state.allocs_by_job(eval.namespace, eval.job_id)
        tainted = tainted_nodes(self.state, allocs)

        # reschedule/disconnect windows are wall-clock by SPEC (the
        # reference compares against real time everywhere)
        now = time.time()   # nomadlint: disable=DET001 — spec wall clock
        update_non_terminal_allocs_to_lost(self.plan, tainted, allocs,
                                           job=self.job, now=now)

        update_fn = generic_alloc_update_fn(self.ctx, eval, self.job)
        reconciler = AllocReconciler(
            alloc_update_fn=update_fn,
            batch=self.batch,
            job_id=eval.job_id,
            job=self.job,
            deployment=self.deployment,
            existing_allocs=allocs,
            tainted_nodes=tainted,
            eval_id=eval.id,
            eval_priority=eval.priority,
            now=now)
        with metrics.measure("nomad.scheduler.reconcile"), \
                trace.span("scheduler.reconcile"):
            results = reconciler.compute()
        self.followup_evals = results.desired_followup_evals

        if eval.annotate_plan:
            self.plan.annotations = PlanAnnotations(
                desired_tg_updates=results.desired_tg_updates)

        # add stops to the plan
        for stop in results.stop:
            self.plan.append_stopped_alloc(
                stop.alloc, stop.status_description, stop.client_status,
                stop.follow_up_eval_id)

        # attribute updates (follow-up eval id markers)
        for alloc in results.attribute_updates.values():
            self.plan.append_alloc(alloc, None)

        # in-place updates
        for alloc in results.inplace_update:
            self.plan.append_alloc(alloc, None)

        # deployment changes
        if results.deployment is not None:
            self.plan.deployment = results.deployment
        self.plan.deployment_updates = results.deployment_updates

        # queued allocations per tg
        for tg_name, du in results.desired_tg_updates.items():
            self.queued_allocs[tg_name] = self.queued_allocs.get(tg_name, 0) + \
                du.place + du.destructive_update

        # nothing to place?
        destructive = results.destructive_update
        place = results.place
        if not place and not destructive:
            return True

        return self._compute_placements(destructive, place)

    def _compute_placements(self, destructive, place) -> bool:
        """Place missing allocations (ref generic_sched.go:472
        computePlacements). Delegates to the TPU solver when configured."""
        algorithm = self.ctx.scheduler_config.effective_scheduler_algorithm()
        if algorithm in (SCHED_ALG_TPU, SCHED_ALG_CONVEX):
            # the convex algorithm rides the same tensor placer; its
            # solves route through the convex tier (backend.select_convex)
            # and demote to the identical greedy ladder on any failure
            try:
                from ..solver import SolverPlacer
            except ImportError:
                pass  # solver unavailable: fall back to the generic stack
            else:
                placer = SolverPlacer(self)
                return placer.compute_placements(destructive, place)

        deployment_id = ""
        if self.deployment is not None and self.deployment.active():
            deployment_id = self.deployment.id
        if self.plan.deployment is not None:
            deployment_id = self.plan.deployment.id

        # byDC availability metrics are set already; iterate placements
        for missing in list(destructive) + list(place):
            if isinstance(missing, AllocPlaceResult):
                tg = missing.task_group
                name = missing.name
                prev = missing.previous_alloc
                is_destructive = False
            else:
                tg = missing.place_task_group
                name = missing.place_name
                prev = missing.stop_alloc
                is_destructive = True

            # stop the old destructive alloc first so its resources free up
            # (atomic place/stop pairing, ref reconcile_util.go:13-17)
            if is_destructive:
                self.plan.append_stopped_alloc(
                    prev, missing.stop_status_description)

            # check job still requires this tg
            if self.job.lookup_task_group(tg.name) is None:
                continue

            # canary gate: non-canary placements run at the downgraded
            # job version (old resources/constraints, ref :500)
            tg, place_job, place_dep_id = self.resolve_placement_job(
                missing, tg, deployment_id)
            if place_job is not None:
                self.stack.set_job(place_job)

            options = SelectOptions(alloc_name=name)
            if prev is not None:
                penalty = {prev.node_id}
                if prev.reschedule_tracker:
                    for ev in prev.reschedule_tracker.events:
                        penalty.add(ev.prev_node_id)
                options.penalty_node_ids = penalty
                # sticky ephemeral disk => prefer previous node
                if tg.ephemeral_disk.sticky and not (
                        isinstance(missing, AllocPlaceResult) and missing.lost):
                    node = self.state.node_by_id(prev.node_id)
                    if node is not None:
                        options.preferred_nodes = [node]

            option = self._select_next_option(tg, options)
            if place_job is not None:
                self.stack.set_job(self.job)        # restore after select
            # per-DC availability survives the per-select metric reset
            # (ref generic_sched.go computePlacements re-sets NodesAvailable)
            self.ctx.metrics.nodes_available = dict(self._nodes_by_dc)
            if option is not None:
                self._handle_preemptions(option)
                # per-alloc wrapper kept (the ranked task_resources vary
                # per option) — accepted PERF001 remnant, see
                # .nomadlint-baseline.json; the shared row is pooled
                resources = AllocatedResources(
                    tasks=dict(option.task_resources),
                    shared=option.alloc_resources or
                    skeleton_for(self._skel, tg, False).shared_total.shared)
                alloc = Allocation(
                    id=new_id(),
                    namespace=self.eval.namespace,
                    eval_id=self.eval.id,
                    name=name,
                    job_id=self.eval.job_id,
                    task_group=tg.name,
                    metrics=self.ctx.metrics.copy(),
                    node_id=option.node.id,
                    node_name=option.node.name,
                    deployment_id=place_dep_id,
                    allocated_resources=resources,
                    desired_status="run",
                    client_status="pending",
                )
                canary = isinstance(missing, AllocPlaceResult) and missing.canary
                if prev is not None:
                    alloc.previous_allocation = prev.id
                    if isinstance(missing, AllocPlaceResult) and missing.reschedule:
                        self._update_reschedule_tracker(alloc, prev)
                if place_dep_id and canary:
                    alloc.deployment_status = AllocDeploymentStatus(canary=True)
                    if self.plan.deployment is not None:
                        ds = self.plan.deployment.task_groups.get(tg.name)
                        if ds is not None:
                            ds.placed_canaries.append(alloc.id)
                self.plan.append_alloc(alloc, place_job)
            else:
                # failed placement: restore the stop we optimistically made
                if is_destructive:
                    self.plan.pop_update(prev)
                    self.queued_allocs[tg.name] = \
                        self.queued_allocs.get(tg.name, 0) - 1
                self.failed_tg_allocs[tg.name] = self.ctx.metrics.copy()
        return True

    def _downgraded_job_for_placement(self, tg_name: str,
                                      min_job_version: int):
        """-> (deployment_id, job) of the latest promoted/non-canaried
        job version — the version a non-canary placement must run at
        while canaries gate the new version (ref generic_sched.go:434
        downgradedJobForPlacement). Cached per (tg, min_version) for the
        eval: the result is snapshot-invariant, and a canary-gated job
        losing a node resolves it once per group, not once per alloc."""
        cache = getattr(self, "_downgrade_cache", None)
        if cache is None:
            cache = self._downgrade_cache = {}
        key = (tg_name, min_job_version)
        if key in cache:
            return cache[key]
        out = self._downgraded_job_uncached(tg_name, min_job_version)
        cache[key] = out
        return out

    def _downgraded_job_uncached(self, tg_name: str, min_job_version: int):
        ns, job_id = self.job.namespace, self.job.id
        deployments = list(self.state.deployments_by_job(ns, job_id))
        deployments.sort(key=lambda d: d.job_version, reverse=True)
        for d in deployments:
            ds = d.task_groups.get(tg_name)
            # zero desired_canaries: that version rolled without canaries
            if ds is not None and (ds.promoted or ds.desired_canaries == 0):
                return d.id, self.state.job_by_version(ns, job_id,
                                                       d.job_version)
        # latest stable version may predate any deployment (no update
        # stanza => no deployment record)
        job = self.state.job_by_version(ns, job_id, min_job_version)
        if job is not None and job.update is None:
            return "", job
        return "", None

    def resolve_placement_job(self, missing, tg, deployment_id: str):
        """-> (tg, job_override, deployment_id) honoring the reconciler's
        downgrade_non_canary flag: while a canary gate is up, non-canary
        placements (migrations, lost replacements, scale-ups) run at the
        old job version, with the old group's resources and constraints
        (ref generic_sched.go:500). job_override is None when the plan
        job applies."""
        from .reconcile import AllocPlaceResult
        if not (isinstance(missing, AllocPlaceResult) and
                missing.downgrade_non_canary):
            return tg, None, deployment_id
        did, djob = self._downgraded_job_for_placement(
            tg.name, missing.min_job_version)
        if djob is not None and djob.version >= missing.min_job_version:
            dtg = djob.lookup_task_group(tg.name)
            if dtg is not None:
                # `did` verbatim, INCLUDING empty (ref :500 assigns dID
                # as-is): attaching an old-version placement to the
                # current canary deployment would pollute its
                # placed/healthy accounting and progress deadline
                return dtg, djob, did
        if self.ctx.logger:
            self.ctx.logger(
                f"sched: no downgraded job version for {tg.name}; "
                f"placing at the latest")
        return tg, None, deployment_id

    def _select_next_option(self, tg, options: SelectOptions):
        """ref generic_sched.go:773 selectNextOption — retry with preemption
        when enabled."""
        option = self.stack.select(tg, options)
        if option is None:
            cfg = self.ctx.scheduler_config.preemption_config
            enabled = (cfg.batch_scheduler_enabled if self.batch
                       else cfg.service_scheduler_enabled)
            if enabled:
                options.preempt = True
                option = self.stack.select(tg, options)
        return option

    def _handle_preemptions(self, option) -> None:
        """ref generic_sched.go:795 handlePreemptions"""
        if not option.preempted_allocs:
            return
        # the preempting alloc id isn't known yet; use eval id marker
        for victim in option.preempted_allocs:
            self.plan.append_preempted_alloc(victim, self.eval.id)

    def _update_reschedule_tracker(self, alloc: Allocation,
                                   prev: Allocation) -> None:
        """ref generic_sched.go updateRescheduleTracker"""
        from ..structs import RescheduleEvent, RescheduleTracker
        events = []
        if prev.reschedule_tracker:
            events = list(prev.reschedule_tracker.events)
        events.append(RescheduleEvent(
            # event timestamps are observability data, not decisions
            # nomadlint: disable=DET001 — spec wall clock
            reschedule_time_unix=time.time(),
            prev_alloc_id=prev.id,
            prev_node_id=prev.node_id))
        # keep bounded history (ref structs.go maxPastRescheduleEvents = 5)
        alloc.reschedule_tracker = RescheduleTracker(events=events[-5:])

    # ------------------------------------------------------------- status

    def _set_status(self, status: str, desc: str) -> None:
        ev = self.eval.copy()
        ev.status = status
        ev.status_description = desc
        if self.blocked is not None:
            ev.blocked_eval = self.blocked.id
        ev.failed_tg_allocs = dict(self.failed_tg_allocs)
        ev.queued_allocations = dict(self.queued_allocs)
        self.planner.update_eval(ev)
