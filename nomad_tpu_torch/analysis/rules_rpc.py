"""RPC001 — retry discipline at RPC call sites (ISSUE 18).

The partition-tolerant RPC plane centralizes retry policy in
`rpc/retry.RetryPolicy`: bounded rounds, exponential backoff with seeded
jitter, sleeps on the injectable `chrono.Clock`. An ad-hoc retry
anywhere else regresses exactly the failure this PR fixes — during a
partition every caller hot-loops against a dead link (no backoff means a
thundering herd at heal time; raw `time.sleep` means ManualClock
partition sims can't time-compress the wait and the retry schedule
stops being seed-reproducible).

Two shapes are flagged in `client/`, `rpc/`, and `server/` code:

  * **hot retry** — an `except` handler catching a transport error
    (`ConnectionError` / `TimeoutError` / `OSError`) whose body
    IMMEDIATELY re-calls a callable that was also called in the `try`
    body. That is an unbounded zero-backoff retry: route the call
    through a `RetryPolicy`-carrying client instead, or restructure so
    the re-attempt happens on the next (bounded, jittered) loop tick.
    Handlers for the typed consensus errors (`NotLeaderError`,
    `RetryableError` redirects) are inherently exempt — they catch
    different types.
  * **raw-clock retry sleep** — `time.sleep(...)` inside a `while` loop
    that also contains a transport-error handler. The sleep IS the
    retry backoff, so it must ride an injectable clock
    (`self._clock.sleep` / `policy.clock.sleep`) to stay
    deterministic under test; `threading.Event.wait` is fine (it is
    interruptible shutdown plumbing, not backoff).

Inline-disable with justification where a hot re-call is provably
bounded and intentional.
"""
from __future__ import annotations

import ast
from typing import Optional

from .core import Rule, SourceModule, register

# transport-level exception names whose handlers mark a retry context
_TRANSPORT_EXCS = {"ConnectionError", "TimeoutError", "OSError",
                   "socket.timeout"}


def _handler_exc_names(mod: SourceModule, handler: ast.ExceptHandler) -> set:
    """Dotted names of the exception types a handler catches."""
    t = handler.type
    if t is None:
        return set()
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    out = set()
    for e in elts:
        d = mod.dotted(e)
        if d is not None:
            out.add(d)
    return out


def _catches_transport(mod: SourceModule,
                       handler: ast.ExceptHandler) -> bool:
    return bool(_handler_exc_names(mod, handler) & _TRANSPORT_EXCS)


def _called_names(mod: SourceModule, nodes) -> dict:
    """dotted callable name -> first ast.Call node, for every call under
    `nodes`. Calls that only construct an exception being raised
    (`raise FooError(...)`) are skipped — a re-raise wrapping is error
    propagation, not a retry."""
    raised: set = set()
    for root in nodes:
        for node in ast.walk(root):
            if isinstance(node, ast.Raise) and node.exc is not None:
                for sub in ast.walk(node.exc):
                    raised.add(id(sub))
    out: dict = {}
    for root in nodes:
        for node in ast.walk(root):
            if isinstance(node, ast.Call) and id(node) not in raised:
                d = mod.dotted(node.func)
                if d is not None and d not in out:
                    out[d] = node
    return out


@register
class RpcRetryDiscipline(Rule):
    id = "RPC001"
    severity = "error"
    short = ("ad-hoc RPC retry: hot re-call in a transport-error handler "
             "or raw time.sleep backoff in a retry loop")
    path_markers = ("/client/", "/rpc/", "/server/")

    # callables that never represent an RPC re-attempt even when they
    # appear on both sides of a try/except (logging, counters). Matched
    # by final dotted segment so import resolution ("metrics.incr" vs
    # "metrics.metrics.incr") doesn't defeat the list.
    _BENIGN_TAILS = {"print", "len", "str", "repr", "incr", "set_gauge",
                     "record_swallowed_error", "debug", "info", "warning",
                     "error", "exception"}

    def _benign(self, name: str) -> bool:
        return (name.split(".")[-1] in self._BENIGN_TAILS
                or name.startswith("self.logger"))

    def check(self, mod: SourceModule) -> list:
        out = []
        out.extend(self._check_hot_retries(mod))
        out.extend(self._check_raw_sleeps(mod))
        return out

    # ------------------------------------------------------ hot re-call
    def _check_hot_retries(self, mod: SourceModule) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Try):
                continue
            tried = _called_names(mod, node.body)
            if not tried:
                continue
            for handler in node.handlers:
                if not _catches_transport(mod, handler):
                    continue
                recalled = _called_names(mod, handler.body)
                for name, call in recalled.items():
                    if name in tried and not self._benign(name):
                        out.append(mod.finding(
                            self, call,
                            f"transport-error handler immediately "
                            f"re-calls {name}() — an unbounded "
                            f"zero-backoff retry that hot-loops through "
                            f"a partition; use a RetryPolicy-carrying "
                            f"client or defer to the next bounded loop "
                            f"tick"))
                        break       # one finding per handler is enough
        return out

    # -------------------------------------------------- raw sleep in loop
    def _enclosing_while(self, mod: SourceModule,
                         node: ast.AST) -> Optional[ast.While]:
        for anc in mod.ancestors(node):
            if isinstance(anc, ast.While):
                return anc
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return None         # don't escape the defining function
        return None

    def _check_raw_sleeps(self, mod: SourceModule) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if mod.dotted(node.func) != "time.sleep":
                continue
            loop = self._enclosing_while(mod, node)
            if loop is None:
                continue
            handlers = [h for t in ast.walk(loop)
                        if isinstance(t, ast.Try) for h in t.handlers]
            if any(_catches_transport(mod, h) for h in handlers):
                out.append(mod.finding(
                    self, node,
                    "time.sleep() as retry backoff in a transport-error "
                    "retry loop — sleep on the injectable chrono.Clock "
                    "(RetryPolicy.backoff_s + clock.sleep) so partition "
                    "sims can time-compress and replay the schedule"))
        return out
