"""READ001 — park on the broker, don't poll-loop the store (ISSUE 16,
docs/READ_PATH.md "Backpressure rungs").

The read-path contract is that blocking readers park on
`event_broker.wait_for_index(topics, index)`: only writes on the watched
topics wake them. The failure shape this rule patrols is the quiet
re-introduction of store-condvar poll loops — a
`state.block_min_index(...)` (or a `snapshot_min_index` retry) inside a
`while` loop wakes the waiter on EVERY store write cluster-wide, so a
fleet of parked watchers turns each unrelated commit into a thundering
herd re-check. One such loop looks harmless in review; the read-storm
bench only catches the aggregate.

Scope: `/server/` and `/agent/` — the layers that hold reader
connections open. The state store itself (`/state/`) legitimately owns
its condvar, and the broker's own parking primitive is the allowlisted
replacement (it lives in `event_broker.py`, which this rule skips by
path). A genuinely store-scoped wait — e.g. a writer awaiting its own
apply index where no event topic exists — carries the standard inline
`# nomadlint: disable=READ001 — <why>` naming its reason
(docs/STATIC_ANALYSIS.md).
"""
from __future__ import annotations

import ast

from .core import Rule, SourceModule, register

_WAIT_ATTRS = ("block_min_index", "snapshot_min_index")


@register
class ParkOnBroker(Rule):
    id = "READ001"
    severity = "error"
    short = ("store poll-loop (`block_min_index`/`snapshot_min_index` "
             "inside a while loop) in server/agent read paths — every "
             "cluster write wakes the waiter; park on "
             "`event_broker.wait_for_index(topics, index)` instead")
    path_markers = ("/server/", "/agent/")

    @staticmethod
    def _enclosing_loop(mod: SourceModule, node: ast.AST):
        for anc in mod.ancestors(node):
            if isinstance(anc, (ast.While, ast.For)):
                return anc
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return None     # a loop outside this function is not ours
        return None

    def check(self, mod: SourceModule) -> list:
        if mod.path.endswith("event_broker.py"):
            return []           # the broker IS the parking primitive
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not (isinstance(func, ast.Attribute)
                    and func.attr in _WAIT_ATTRS):
                continue
            loop = self._enclosing_loop(mod, node)
            if loop is None:
                continue        # one-shot wait: bounded, not a poll loop
            out.append(mod.finding(
                self, node,
                f"`.{func.attr}(...)` inside a loop re-wakes on every "
                f"store write; park on `event_broker.wait_for_index("
                f"topics, index)` so only the watched topics wake this "
                f"reader, or mark a genuinely store-scoped wait with "
                f"`# nomadlint: disable=READ001 — <why>`"))
        return out
