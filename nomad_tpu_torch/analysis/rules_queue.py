"""QUEUE001 — unbounded growth of a long-lived queue in `/server/`.

ISSUE 8's failure mode in rule form: the control plane's queues (eval
broker heaps, plan queue, event buffers) are the first thing a traffic
burst fills, and a `heappush`/`append` onto a module-level or instance
queue with no cap anywhere in the enclosing function is how "10x load"
becomes "OOM an hour later". The eval broker's depth cap + shed path
and the event broker's per-subscriber `max_pending` are the blessed
patterns; this rule keeps new queue writes honest.

Flagged writes:
  * `heapq.heappush(<module-level name | self.<attr>>, ...)`
  * `self.<attr>.append(...)` / `<module-level name>.append(...)` where
    the attribute/name LOOKS like a queue (contains one of: queue, heap,
    pending, backlog, buffer, waiting, delay, inbox)

A write is accepted when the enclosing function shows a bound:
  * a comparison touching a cap-ish identifier (`cap`, `max*`, `limit`,
    `bound`, `maxlen`, `depth`) or a `len(...)` comparison, or
  * a call to a shed/evict/drop/trim/prune/pop helper (overflow is
    handled by displacement rather than rejection), or
  * a cap-ish parameter threaded into the function.

Deliberate unbounded-looking sites — a deque constructed with `maxlen`
(the bound lives in __init__, invisible here), a queue bounded upstream
— take an inline `# nomadlint: disable=QUEUE001 — <why>` or a baseline
entry with a reason, the standard workflow (docs/STATIC_ANALYSIS.md).
"""
from __future__ import annotations

import ast

from .core import Rule, SourceModule, register

# attribute/name substrings that mark a container as a queue
_QUEUE_NAMES = ("queue", "heap", "pending", "backlog", "buffer",
                "waiting", "delay", "inbox")

# identifier substrings that mark a comparison/parameter as a cap check
_CAP_MARKERS = ("cap", "max", "limit", "bound", "maxlen", "depth")

# callee substrings that mark overflow-by-displacement handling
_SHED_MARKERS = ("shed", "evict", "drop", "trim", "prune", "popleft",
                 "heappop")


def _queueish(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in _QUEUE_NAMES)


def _capish(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in _CAP_MARKERS)


def _module_level_names(mod: SourceModule) -> set:
    out = set()
    for node in mod.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


def _enclosing_function(mod: SourceModule, node: ast.AST):
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _ident_names(node: ast.AST):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr


def _has_cap_check(fn: ast.AST) -> bool:
    for arg in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
        if _capish(arg.arg):
            return True
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            if any(_capish(n) for n in _ident_names(node)):
                return True
            # len(...) compared against anything is a size check
            for side in [node.left] + list(node.comparators):
                if isinstance(side, ast.Call) and \
                        isinstance(side.func, ast.Name) and \
                        side.func.id == "len":
                    return True
        elif isinstance(node, ast.Call):
            callee = node.func
            name = callee.attr if isinstance(callee, ast.Attribute) else \
                callee.id if isinstance(callee, ast.Name) else ""
            if any(m in name.lower() for m in _SHED_MARKERS):
                return True
    return False


@register
class UnboundedQueueGrowth(Rule):
    id = "QUEUE001"
    severity = "error"
    short = ("heappush/append onto a long-lived server queue with no "
             "cap check in the enclosing function (unbounded growth "
             "under burst load)")
    path_markers = ("/server/",)

    def _target(self, mod: SourceModule, node: ast.Call, module_names):
        """(container description, container name) for a flaggable queue
        write, else None."""
        func = node.func
        dotted = mod.dotted(func)
        if dotted in ("heapq.heappush",) or (
                dotted is not None and dotted.endswith(".heappush")):
            if not node.args:
                return None
            tgt = node.args[0]
            # unwrap dict.setdefault(...) feeding the heap: the
            # container is the receiver of setdefault
            if isinstance(tgt, ast.Call) and \
                    isinstance(tgt.func, ast.Attribute) and \
                    tgt.func.attr == "setdefault":
                tgt = tgt.func.value
            if isinstance(tgt, ast.Attribute) and \
                    isinstance(tgt.value, ast.Name) and \
                    tgt.value.id == "self":
                return f"self.{tgt.attr}", tgt.attr
            if isinstance(tgt, ast.Name) and tgt.id in module_names:
                return tgt.id, tgt.id
            return None
        if isinstance(func, ast.Attribute) and func.attr == "append":
            tgt = func.value
            if isinstance(tgt, ast.Attribute) and \
                    isinstance(tgt.value, ast.Name) and \
                    tgt.value.id == "self" and _queueish(tgt.attr):
                return f"self.{tgt.attr}", tgt.attr
            if isinstance(tgt, ast.Name) and tgt.id in module_names \
                    and _queueish(tgt.id):
                return tgt.id, tgt.id
        return None

    def check(self, mod: SourceModule) -> list:
        out = []
        module_names = _module_level_names(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            hit = self._target(mod, node, module_names)
            if hit is None:
                continue
            desc, _name = hit
            fn = _enclosing_function(mod, node)
            if fn is not None and _has_cap_check(fn):
                continue
            where = fn.name if fn is not None else "<module>"
            out.append(mod.finding(
                self, node,
                f"`{desc}` grows in {where} with no cap check in the "
                f"enclosing function — bound it (compare against a "
                f"cap/max/limit, or shed/evict on overflow like "
                f"eval_broker.py), or baseline/disable with a reason "
                f"naming where the bound lives (docs/OVERLOAD.md)"))
        return out
