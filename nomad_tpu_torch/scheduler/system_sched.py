"""System/sysbatch scheduler: one alloc of each task group on every feasible
node (ref scheduler/scheduler_system.go).
"""
from __future__ import annotations

import time
from typing import Optional

from ..structs import (
    AllocatedResources, AllocatedSharedResources, Allocation, Evaluation,
    Job, Plan, DESC_NODE_TAINTED, DESC_NOT_NEEDED,
    ALLOC_CLIENT_LOST, EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED,
    JOB_TYPE_SYSBATCH, alloc_name, new_id,
)
from .context import EvalContext
from .stack import SystemStack, SelectOptions
from .util import ready_nodes_in_dcs, tainted_nodes, tasks_updated

MAX_SYSTEM_SCHEDULE_ATTEMPTS = 5


class SystemScheduler:
    """ref scheduler_system.go:27"""

    def __init__(self, state, planner, sysbatch: bool = False, logger=None):
        self.state = state
        self.planner = planner
        self.sysbatch = sysbatch
        self.logger = logger
        self.eval: Optional[Evaluation] = None
        self.job: Optional[Job] = None
        self.plan: Optional[Plan] = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[SystemStack] = None
        self.failed_tg_allocs: dict[str, object] = {}
        self.queued_allocs: dict[str, int] = {}

    def process(self, eval: Evaluation) -> None:
        self.eval = eval
        attempts = 0
        while attempts < MAX_SYSTEM_SCHEDULE_ATTEMPTS:
            done = self._process()
            if done:
                ev = eval.copy()
                ev.status = EVAL_STATUS_COMPLETE
                ev.failed_tg_allocs = dict(self.failed_tg_allocs)
                ev.queued_allocations = dict(self.queued_allocs)
                self.planner.update_eval(ev)
                return
            attempts += 1
            self.state = self.planner.refresh_snapshot(self.state)
        ev = eval.copy()
        ev.status = EVAL_STATUS_FAILED
        ev.status_description = "maximum attempts reached"
        self.planner.update_eval(ev)

    def _process(self) -> bool:
        eval = self.eval
        self.job = self.state.job_by_id(eval.namespace, eval.job_id)
        self.plan = eval.make_plan(self.job)
        self.plan.snapshot_index = self.state.latest_index()
        self.ctx = EvalContext(self.state, self.plan, self.logger)
        self.stack = SystemStack(self.ctx, self.sysbatch)
        self.failed_tg_allocs = {}
        self.queued_allocs = {}

        if self.job and not self.job.stopped():
            nodes, by_dc = ready_nodes_in_dcs(self.state, self.job.datacenters)
            self.ctx.metrics.nodes_available = by_dc
            self.stack.set_job(self.job)
        else:
            nodes = []

        allocs = self.state.allocs_by_job(eval.namespace, eval.job_id)
        tainted = tainted_nodes(self.state, allocs)

        # index existing allocs by (node, tg)
        existing: dict[tuple[str, str], Allocation] = {}
        for a in allocs:
            key = (a.node_id, a.task_group)
            cur = existing.get(key)
            if cur is None or cur.create_index < a.create_index:
                existing[key] = a

        node_ids = {n.id for n in nodes}
        stopped = self.job is None or self.job.stopped()

        # stop allocs on nodes that are no longer eligible / down / gone
        for (node_id, tg_name), a in existing.items():
            if a.terminal_status():
                continue
            if stopped or self.job.lookup_task_group(tg_name) is None:
                self.plan.append_stopped_alloc(a, DESC_NOT_NEEDED)
                continue
            if node_id in tainted:
                node = tainted[node_id]
                if node is None or node.terminal_status():
                    self.plan.append_stopped_alloc(
                        a, DESC_NODE_TAINTED, client_status=ALLOC_CLIENT_LOST)
                elif a.desired_transition.should_migrate():
                    # draining or ineligible but alive: only the drainer's
                    # desired_transition stops system allocs, so
                    # ignore_system_jobs is honored and toggling node
                    # eligibility doesn't kill system workloads (ref
                    # scheduler_system.go diffSystemAllocs defers every
                    # non-terminal tainted node to ShouldMigrate)
                    self.plan.append_stopped_alloc(a, DESC_NODE_TAINTED)
                continue
            if node_id not in node_ids:
                # e.g. datacenter no longer matches
                self.plan.append_stopped_alloc(a, DESC_NOT_NEEDED)

        # place on nodes that lack a live (or, sysbatch, successful) alloc
        if not stopped:
            for tg in self.job.task_groups:
                self.queued_allocs.setdefault(tg.name, 0)
                for node in nodes:
                    a = existing.get((node.id, tg.name))
                    stopped_for_update = None
                    if a is not None:
                        if not a.terminal_status():
                            # update in place / destructive if job changed
                            if a.job is not None and \
                               a.job.version != self.job.version and \
                               tasks_updated(a.job, self.job, tg.name):
                                self.plan.append_stopped_alloc(
                                    a, "alloc is being updated due to job update")
                                stopped_for_update = a
                            else:
                                continue
                        elif self.sysbatch and a.ran_successfully():
                            continue  # sysbatch: done is done
                        elif self.sysbatch and a.terminal_status() and \
                                a.job is not None and \
                                a.job.version == self.job.version:
                            continue  # don't rerun failed sysbatch on same version
                        elif not self.sysbatch and a.server_terminal_status():
                            continue
                    if not self._place_on_node(tg, node):
                        if stopped_for_update is not None:
                            # keep the healthy old version running rather than
                            # stopping it with no replacement
                            self.plan.pop_update(stopped_for_update)
                        self.queued_allocs[tg.name] += 1

        if self.plan.is_no_op():
            return True
        result = self.planner.submit_plan(self.plan)
        if result is None:
            return False
        full, _, _ = result.full_commit(self.plan)
        return full

    def _place_on_node(self, tg, node) -> bool:
        self.stack.set_nodes([node])
        name = alloc_name(self.job.id, tg.name, 0)
        option = self.stack.select(tg, SelectOptions(alloc_name=name))
        if option is None:
            # preemption retry for system jobs
            cfg = self.ctx.scheduler_config.preemption_config
            enabled = (cfg.sysbatch_scheduler_enabled if self.sysbatch
                       else cfg.system_scheduler_enabled)
            if enabled:
                option = self.stack.select(
                    tg, SelectOptions(alloc_name=name, preempt=True))
            if option is None:
                self.failed_tg_allocs[tg.name] = self.ctx.metrics.copy()
                return False
        if option.preempted_allocs:
            for victim in option.preempted_allocs:
                self.plan.append_preempted_alloc(victim, self.eval.id)
        resources = AllocatedResources(
            tasks=dict(option.task_resources),
            shared=option.alloc_resources or AllocatedSharedResources(
                disk_mb=tg.ephemeral_disk.size_mb))
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
            allocated_resources=resources,
            desired_status="run",
            client_status="pending",
        )
        self.plan.append_alloc(alloc, None)
        return True
