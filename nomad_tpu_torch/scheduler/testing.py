"""Scheduler test harness (ref scheduler/testing.go): real state store +
fake Planner capturing plans and applying them to state — the entire
scheduler is exercised as a pure function of (state, eval) -> plan.
"""
from __future__ import annotations

from typing import Optional

from ..state import StateStore
from ..structs import (
    Allocation, Evaluation, Plan, PlanResult, ALLOC_DESIRED_STOP,
)


class _PlanApplyRequest:
    """Shape consumed by StateStore.upsert_plan_results (the
    ApplyPlanResultsRequest analog)."""

    def __init__(self, plan: Plan):
        self.alloc_updates = [a for allocs in plan.node_update.values()
                              for a in allocs]
        self.alloc_placements = [a for allocs in plan.node_allocation.values()
                                 for a in allocs]
        self.alloc_preemptions = [a for allocs in plan.node_preemptions.values()
                                  for a in allocs]
        self.deployment = plan.deployment
        self.deployment_updates = plan.deployment_updates
        self.eval_id = plan.eval_id


class Harness:
    """ref testing.go:43"""

    def __init__(self, state: Optional[StateStore] = None):
        self.state = state or StateStore()
        self.plans: list[Plan] = []
        self.evals: list[Evaluation] = []
        self.created_evals: list[Evaluation] = []
        self.reblocked_evals: list[Evaluation] = []
        self.next_index = 1
        self.reject_plan = False

    def get_next_index(self) -> int:
        idx = self.next_index
        self.next_index += 1
        return idx

    # ---- Planner interface ----

    def submit_plan(self, plan: Plan) -> Optional[PlanResult]:
        self.plans.append(plan)
        if self.reject_plan:
            return PlanResult()
        index = self.get_next_index()
        req = _PlanApplyRequest(plan)
        self.state.upsert_plan_results(index, req)
        return PlanResult(
            node_update=dict(plan.node_update),
            node_allocation=dict(plan.node_allocation),
            node_preemptions=dict(plan.node_preemptions),
            deployment=plan.deployment,
            deployment_updates=plan.deployment_updates,
            alloc_index=index)

    def update_eval(self, eval: Evaluation) -> None:
        self.evals.append(eval)
        # mirror production: the worker persists eval status via Raft
        self.state.upsert_evals(self.get_next_index(), [eval])

    def create_eval(self, eval: Evaluation) -> None:
        self.created_evals.append(eval)

    def reblock_eval(self, eval: Evaluation) -> None:
        self.reblocked_evals.append(eval)

    def refresh_snapshot(self, old_snap):
        return self.state.snapshot()

    # ---- driving ----

    def process(self, scheduler_factory, eval: Evaluation) -> None:
        """Snapshot state and run the scheduler (ref testing.go:270)."""
        snap = self.state.snapshot()
        sched = scheduler_factory(snap, self)
        sched.process(eval)
