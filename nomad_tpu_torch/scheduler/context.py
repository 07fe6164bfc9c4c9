"""Eval context: per-evaluation caches and plan-aware state access
(ref scheduler/context.go).

The critical piece is `proposed_allocs` (context.go:120): the scheduler sees
state allocs MINUS in-plan stops/preemptions PLUS in-plan placements, so that
multiple placements within one eval account for each other — and so the TPU
solver's running-usage updates match (SURVEY.md hard part 1).
"""
from __future__ import annotations

import re
from typing import Optional

from ..structs import (
    Allocation, AllocMetric, Plan, SchedulerConfiguration, Node,
)


class EvalCache:
    """Per-eval regexp/version-constraint caches (ref context.go EvalCache)."""

    def __init__(self):
        self.regexp: dict[str, re.Pattern] = {}
        self.version_constraint: dict[str, object] = {}
        self.semver_constraint: dict[str, object] = {}


# Feasibility-cache verdicts (ref context.go ComputedClassFeasibility)
EVAL_COMPUTED_CLASS_UNKNOWN = 0
EVAL_COMPUTED_CLASS_IGNORE = 1
EVAL_COMPUTED_CLASS_ELIGIBLE = 2
EVAL_COMPUTED_CLASS_INELIGIBLE = 3
EVAL_COMPUTED_CLASS_ESCAPED = 4


class EvalEligibility:
    """Tracks feasibility per computed node class so constraint checks run
    once per *class*, not once per node (ref context.go:190).

    Constraints referencing unique.* attributes "escape" the class system and
    must be checked per node."""

    def __init__(self):
        self.job: dict[str, int] = {}          # class -> verdict
        self.job_escaped = False
        self.tg: dict[str, dict[str, int]] = {}  # tg -> class -> verdict
        self.tg_escaped: dict[str, bool] = {}
        self.quota_reached: str = ""

    def set_job(self, job) -> None:
        self.job_escaped = _constraints_escape(job.constraints)
        for tg in job.task_groups:
            esc = _constraints_escape(tg.constraints)
            if not esc:
                for task in tg.tasks:
                    if _constraints_escape(task.constraints):
                        esc = True
                        break
            self.tg_escaped[tg.name] = esc

    def has_escaped(self) -> bool:
        return self.job_escaped or any(self.tg_escaped.values())

    def job_status(self, klass: str) -> int:
        if self.job_escaped:
            return EVAL_COMPUTED_CLASS_ESCAPED
        if not klass:
            return EVAL_COMPUTED_CLASS_IGNORE
        return self.job.get(klass, EVAL_COMPUTED_CLASS_UNKNOWN)

    def set_job_eligibility(self, eligible: bool, klass: str) -> None:
        if klass:
            self.job[klass] = (EVAL_COMPUTED_CLASS_ELIGIBLE if eligible
                               else EVAL_COMPUTED_CLASS_INELIGIBLE)

    def task_group_status(self, tg: str, klass: str) -> int:
        if self.tg_escaped.get(tg):
            return EVAL_COMPUTED_CLASS_ESCAPED
        if not klass:
            return EVAL_COMPUTED_CLASS_IGNORE
        return self.tg.get(tg, {}).get(klass, EVAL_COMPUTED_CLASS_UNKNOWN)

    def set_task_group_eligibility(self, eligible: bool, tg: str, klass: str) -> None:
        if klass:
            self.tg.setdefault(tg, {})[klass] = (
                EVAL_COMPUTED_CLASS_ELIGIBLE if eligible
                else EVAL_COMPUTED_CLASS_INELIGIBLE)

    def get_classes(self) -> dict[str, bool]:
        """Roll up eligibility per class for blocked-eval unblock hints."""
        out: dict[str, bool] = {}
        for klass, v in self.job.items():
            out[klass] = (v == EVAL_COMPUTED_CLASS_ELIGIBLE)
        for tg_map in self.tg.values():
            for klass, v in tg_map.items():
                if v == EVAL_COMPUTED_CLASS_ELIGIBLE:
                    out[klass] = True
                elif klass not in out:
                    out[klass] = False
        return out


def _constraints_escape(constraints) -> bool:
    for c in constraints:
        for target in (c.ltarget, c.rtarget):
            if "${unique." in target or "${node.unique." in target or \
               "${attr.unique." in target or "${meta.unique." in target:
                return True
    return False


class EvalContext:
    """Holds everything one evaluation's scheduling needs (ref context.go
    EvalContext)."""

    def __init__(self, state, plan: Optional[Plan] = None, logger=None):
        self.state = state                  # StateSnapshot (scheduler State iface)
        self.plan = plan
        self.logger = logger
        self.cache = EvalCache()
        self.eligibility = EvalEligibility()
        self.metrics = AllocMetric()
        self.scheduler_config: SchedulerConfiguration = (
            state.get_scheduler_config() if state is not None
            else SchedulerConfiguration())

    def reset_metrics(self) -> AllocMetric:
        m = self.metrics
        self.metrics = AllocMetric()
        return m

    def regexp(self, pattern: str) -> Optional[re.Pattern]:
        r = self.cache.regexp.get(pattern)
        if r is None:
            try:
                r = re.compile(pattern)
            except re.error:
                return None
            self.cache.regexp[pattern] = r
        return r

    def proposed_allocs(self, node_id: str) -> list[Allocation]:
        """State allocs − plan stops/preemptions + plan placements
        (ref context.go:120 ProposedAllocs)."""
        existing = [a for a in self.state.allocs_by_node(node_id)
                    if not a.terminal_status()]
        if self.plan is None:
            return existing
        remove_ids = {a.id for a in self.plan.node_update.get(node_id, ())}
        remove_ids |= {a.id for a in self.plan.node_preemptions.get(node_id, ())}
        proposed = [a for a in existing if a.id not in remove_ids]
        # plan placements replace same-id allocs (in-place updates)
        placed = self.plan.node_allocation.get(node_id, [])
        placed_ids = {a.id for a in placed}
        proposed = [a for a in proposed if a.id not in placed_ids]
        proposed.extend(placed)
        return proposed
