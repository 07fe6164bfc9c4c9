"""LEAD001 — leader-only state mutation outside a fence-checked context.

The control plane's correctness under failover (ISSUE 6) rests on a
discipline: the in-memory structures only the LEADER may feed — the
eval broker's queues, the plan queue, the solver state-cache commit
feed — are mutated only from code that has checked its leadership (or
carries a fence token the log verifies atomically). A mutation reachable
from a non-leader path re-creates exactly the bug class the fenced-write
machinery closes: a deposed server driving schedulers or tensor state
that the new leader owns.

Flagged calls (by dotted-attribute suffix):
  * `eval_broker.enqueue` / `eval_broker.enqueue_all`
  * `queue.enqueue` (the plan queue)
  * `note_commit` (the state-cache commit feed)

A call is accepted when its enclosing function shows a leadership/fence
marker — it reads `is_leader`, calls `fence_token`/`_still_leader`,
takes or uses a `fence` value, or gates on `_leader_stop` (the leader
lifecycle event). This is a discipline check, not a flow analysis:
intentional sites whose guard lives in a CALLER (e.g. the recovery
barrier's steps, guarded by `_establish_step`) belong in the baseline
with a reason, and queue-gated sites (the plan queue fails pendings
when disabled) use an inline disable with justification.

Scoped to `/server/` — that is where every leader-only structure lives.
"""
from __future__ import annotations

import ast

from .core import Rule, SourceModule, register

# dotted-name suffixes of leader-only mutations
_MUTATIONS = (
    "eval_broker.enqueue",
    "eval_broker.enqueue_all",
    "queue.enqueue",
    "note_commit",
)

# any of these appearing in the enclosing function marks it fence-checked
_MARKER_ATTRS = {"is_leader", "fence_token", "_still_leader",
                 "_leader_stop"}
_MARKER_NAMES = {"fence", "fence_token"}


def _enclosing_function(mod: SourceModule, node: ast.AST):
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _has_fence_marker(fn: ast.AST) -> bool:
    for arg in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
        if arg.arg in _MARKER_NAMES:
            return True
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and node.attr in _MARKER_ATTRS:
            return True
        if isinstance(node, ast.Name) and node.id in _MARKER_NAMES:
            return True
        if isinstance(node, ast.keyword) and node.arg in _MARKER_NAMES:
            return True
    return False


@register
class UnfencedLeaderMutation(Rule):
    id = "LEAD001"
    severity = "error"
    short = ("leader-only state mutation (plan queue / broker enqueue / "
             "state-cache feed) outside a fence-checked context")
    path_markers = ("/server/",)

    def check(self, mod: SourceModule) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = mod.dotted(node.func)
            if dotted is None:
                continue
            hit = next((m for m in _MUTATIONS
                        if dotted == m or dotted.endswith("." + m)), None)
            if hit is None:
                continue
            fn = _enclosing_function(mod, node)
            if fn is not None and _has_fence_marker(fn):
                continue
            where = fn.name if fn is not None else "<module>"
            out.append(mod.finding(
                self, node,
                f"`{dotted}` in {where} mutates leader-only state with no "
                f"leadership/fence marker ({'/'.join(sorted(_MARKER_ATTRS))}"
                f" or a `fence` value) in the enclosing function — check "
                f"leadership, thread a fence token, or baseline/disable "
                f"with justification (docs/FAILOVER.md)"))
        return out
