"""EXC001 — swallowed exceptions in long-lived daemon code.

`except Exception: pass` in server/client/state code hides the first
symptom of every outage: a heartbeat that silently stops re-registering,
an event sink that never fires again, a vault token that never revokes.
The fix is one line: log to the owning component's logger and count it
(`nomad_tpu_torch.metrics.record_swallowed_error`), so operators see a
`nomad.swallowed_errors` counter move instead of nothing at all.

Genuinely best-effort teardown paths (double-kill on shutdown, absent
optional integrations) keep the swallow but must say why inline:
`# nomadlint: disable=EXC001 — <justification>`.
"""
from __future__ import annotations

import ast

from .core import Rule, SourceModule, register

_BROAD = {"Exception", "BaseException"}


def _is_broad(mod: SourceModule, handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:                                   # bare `except:`
        return True
    if isinstance(t, ast.Tuple):
        return any(mod.dotted(e) in _BROAD for e in t.elts)
    return mod.dotted(t) in _BROAD


@register
class SwallowedDaemonException(Rule):
    id = "EXC001"
    severity = "error"
    short = ("`except Exception: pass` in server/client/state daemon "
             "code — log + count via metrics.record_swallowed_error")
    path_markers = ("/server/", "/client/", "/state/")

    def check(self, mod: SourceModule) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(mod, node):
                continue
            if len(node.body) == 1 and isinstance(node.body[0], ast.Pass):
                out.append(mod.finding(
                    self, node,
                    "broad except with a bare `pass` swallows daemon "
                    "errors invisibly — log to the component logger and "
                    "call metrics.record_swallowed_error(), or justify "
                    "with an inline disable"))
        return out
