"""PERF001 — per-item resource construction on the plan hot path.

The plan path (solver placer, generic scheduler placement loop, serial
plan applier) materializes tens of thousands of allocations per eval.
ISSUE 5 moved it to pooled copy-on-write `ResourceSkeleton`s
(structs/respool.py): every instance of a task group shares one immutable
AllocatedResources base, and only tasks with per-alloc sequential state
(ports/devices/cores) get fresh rows. This rule keeps the path from
regressing: constructing `Allocated*Resources` objects — or calling
`copy.deepcopy` — inside a loop on a plan-path module is the O(allocs)
object-tree rebuild the skeleton pool exists to remove.

Legitimately per-alloc constructions (the assigned ports/devices/cores
really differ per instance) carry an inline
`# nomadlint: disable=PERF001` with that justification; anything
accepted-for-now lives in `.nomadlint-baseline.json` with a reason.
"""
from __future__ import annotations

import ast

from .core import Rule, SourceModule, register

_POOLED_TYPES = ("AllocatedResources", "AllocatedTaskResources",
                 "AllocatedSharedResources")

_LOOPS = (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
          ast.GeneratorExp)


@register
class PlanPathPerAllocConstruction(Rule):
    id = "PERF001"
    severity = "error"
    short = ("per-item Allocated*Resources construction or deepcopy "
             "inside a plan-path loop — use the pooled ResourceSkeleton")
    path_markers = ("/solver/placer.py", "/scheduler/generic_sched.py",
                    "/server/plan_apply.py")

    def check(self, mod: SourceModule) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            d = mod.dotted(node.func)
            if d is None:
                continue
            tail = d.rsplit(".", 1)[-1]
            if d != "copy.deepcopy" and tail not in _POOLED_TYPES:
                continue
            if not any(isinstance(a, _LOOPS) for a in mod.ancestors(node)):
                continue
            if d == "copy.deepcopy":
                out.append(mod.finding(
                    self, node,
                    "copy.deepcopy inside a plan-path loop — deep object "
                    "rebuilds scale O(allocs); share the immutable base "
                    "and copy-on-write only what differs"))
            else:
                out.append(mod.finding(
                    self, node,
                    f"{tail}(...) constructed inside a plan-path loop — "
                    f"every TG instance shares one immutable skeleton "
                    f"(structs/respool.py skeleton_for); rebuild only "
                    f"rows carrying per-alloc sequential state"))
        return out
