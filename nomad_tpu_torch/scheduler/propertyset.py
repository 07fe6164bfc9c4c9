"""Property sets: bookkeeping of attribute-value usage across existing and
in-plan allocations (ref scheduler/propertyset.go). Shared by
distinct_property constraints and spread scoring.
"""
from __future__ import annotations

from typing import Optional

from ..structs import Constraint, Node
from .feasible import resolve_target


class PropertySet:
    def __init__(self, ctx, job):
        self.ctx = ctx
        self.job = job
        self.namespace = job.namespace if job else "default"
        self.job_id = job.id if job else ""
        self.tg_name: Optional[str] = None
        self.constraint: Optional[Constraint] = None
        self.target_attribute: str = ""
        self.allowed_count: int = 0
        self.error: str = ""
        # existing usage computed lazily: value -> count
        self._existing: Optional[dict[str, int]] = None

    # ---- configuration (ref propertyset.go SetJobConstraint/SetTGConstraint) ----

    def set_job_constraint(self, constraint: Constraint) -> None:
        self._set_constraint(constraint, None)

    def set_tg_constraint(self, constraint: Constraint, tg_name: str) -> None:
        self._set_constraint(constraint, tg_name)

    def set_target_attribute(self, attribute: str, tg_name: Optional[str] = None
                             ) -> None:
        """Spread path: no count limit, just usage counting."""
        self.target_attribute = attribute
        self.tg_name = tg_name
        self.allowed_count = 0

    def _set_constraint(self, constraint: Constraint,
                        tg_name: Optional[str]) -> None:
        self.constraint = constraint
        self.target_attribute = constraint.ltarget
        self.tg_name = tg_name
        if constraint.rtarget:
            try:
                self.allowed_count = int(constraint.rtarget)
                if self.allowed_count < 1:
                    self.error = "distinct_property constraint value must be >= 1"
            except ValueError:
                self.error = (f"distinct_property constraint value "
                              f"{constraint.rtarget!r} is not an integer")
                self.allowed_count = 1
        else:
            self.allowed_count = 1

    # ---- usage ----

    def _existing_counts(self) -> dict[str, int]:
        if self._existing is not None:
            return self._existing
        counts: dict[str, int] = {}
        allocs = self.ctx.state.allocs_by_job(self.namespace, self.job_id)
        for alloc in allocs:
            if alloc.terminal_status():
                continue
            if self.tg_name is not None and alloc.task_group != self.tg_name:
                continue
            node = self.ctx.state.node_by_id(alloc.node_id)
            if node is None:
                continue
            val, ok = resolve_target(self.target_attribute, node)
            if ok and val is not None:
                counts[str(val)] = counts.get(str(val), 0) + 1
        self._existing = counts
        return counts

    def _plan_deltas(self) -> tuple[dict[str, int], dict[str, int]]:
        """(proposed placements per value, stopped per value) from the plan."""
        placed: dict[str, int] = {}
        stopped: dict[str, int] = {}
        plan = self.ctx.plan
        if plan is None:
            return placed, stopped
        for node_id, allocs in plan.node_allocation.items():
            node = self.ctx.state.node_by_id(node_id)
            if node is None:
                continue
            val, ok = resolve_target(self.target_attribute, node)
            if not (ok and val is not None):
                continue
            for alloc in allocs:
                if alloc.job_id != self.job_id or alloc.namespace != self.namespace:
                    continue
                if self.tg_name is not None and alloc.task_group != self.tg_name:
                    continue
                placed[str(val)] = placed.get(str(val), 0) + 1
        for node_id, allocs in list(plan.node_update.items()) + \
                list(plan.node_preemptions.items()):
            node = self.ctx.state.node_by_id(node_id)
            if node is None:
                continue
            val, ok = resolve_target(self.target_attribute, node)
            if not (ok and val is not None):
                continue
            for alloc in allocs:
                if alloc.job_id != self.job_id or alloc.namespace != self.namespace:
                    continue
                if self.tg_name is not None and alloc.task_group != self.tg_name:
                    continue
                stopped[str(val)] = stopped.get(str(val), 0) + 1
        return placed, stopped

    def used_counts(self) -> dict[str, int]:
        """Combined existing + plan usage per property value
        (ref propertyset.go UsedCounts)."""
        combined = dict(self._existing_counts())
        placed, stopped = self._plan_deltas()
        for v, n in placed.items():
            combined[v] = combined.get(v, 0) + n
        for v, n in stopped.items():
            combined[v] = max(0, combined.get(v, 0) - n)
        return combined

    # ---- verdict (ref propertyset.go SatisfiesDistinctProperties) ----

    def satisfies_distinct_properties(self, node: Node) -> tuple[bool, str]:
        if self.error:
            return False, self.error
        val, ok = resolve_target(self.target_attribute, node)
        if not ok or val is None:
            return False, f"missing property {self.target_attribute!r}"
        used = self.used_counts().get(str(val), 0)
        if used >= self.allowed_count:
            return False, (f"distinct_property: {self.target_attribute}={val} "
                           f"already used {used} times (limit {self.allowed_count})")
        return True, ""
