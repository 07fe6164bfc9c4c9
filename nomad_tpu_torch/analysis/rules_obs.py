"""OBS001/OBS002 — telemetry hygiene: bounded metric-name cardinality,
no discarded measurement contexts, and no silently-dropped rejected
placements.

Two anti-patterns this PR's observability work (ISSUE 7) makes load-
bearing to avoid:

  1. UNBOUNDED METRIC NAMES: interpolating ids, node names, or other
     per-entity strings into a metric NAME (`metrics.incr(f"x.{ev.id}")`)
     grows the registry (and every Prometheus scrape) without bound.
     Bounded dimensions (solver tier, scheduler type, breaker state,
     kernel) are fine as name suffixes or — better — as labels on
     `metrics.observe(...)`; per-entity attribution belongs in TRACE
     ATTRIBUTES (nomad_tpu_torch/obs), which are bounded by the trace store's
     ring. Interpolated expressions are judged by an allowlist of
     known-bounded names; anything else flags. Pre-existing per-site
     fault/swallow counters are baselined with reasons.

  2. DISCARDED MEASUREMENT CONTEXTS: `metrics.measure(...)` and
     `trace.span(...)` return context managers — calling one as a bare
     expression statement (or otherwise never entering it) records
     NOTHING, silently: the classic `measure()` block that exits without
     recording. The call must appear in a `with` item (directly or via
     contextlib combinators).
"""
from __future__ import annotations

import ast

from .core import Rule, SourceModule, register

_NAME_SINKS = ("incr", "add_sample", "set_gauge", "observe", "measure",
               "describe", "timed", "waited")

# interpolated expressions considered bounded-cardinality: solver tiers,
# backend/kernel routing names, scheduler types, breaker states, leader
# barrier steps
_ALLOWED_NAMES = {"tier", "kernel", "backend", "step", "kind", "mode",
                  "state", "sched", "phase", "metric", "stat"}
_ALLOWED_ATTRS = {"type", "platform"}

_CM_SINKS = ("measure", "span", "use", "timed")


def _is_metrics_call(mod: SourceModule, node: ast.Call,
                     sinks) -> str:
    """-> the sink method name when `node` is a metrics/trace call we
    police, else ""."""
    d = mod.dotted(node.func)
    if d is None:
        return ""
    parts = d.split(".")
    if len(parts) < 2 or parts[-1] not in sinks:
        return ""
    owner = parts[-2]
    if owner in ("metrics", "trace", "tracer", "timing") or \
            d.startswith("nomad_tpu_torch.metrics") or \
            d.startswith("nomad_tpu_torch.obs"):
        return parts[-1]
    return ""


def _interp_ok(expr: ast.AST) -> bool:
    """Is one interpolated expression provably bounded? Conversions and
    trivial formatting wrappers unwrap first."""
    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, ast.Name):
        return expr.id in _ALLOWED_NAMES
    if isinstance(expr, ast.Attribute):
        return expr.attr in _ALLOWED_ATTRS or expr.attr in _ALLOWED_NAMES
    return False


@register
class TelemetryHygiene(Rule):
    id = "OBS001"
    severity = "error"
    short = ("unbounded-cardinality metric name (id/node interpolation) "
             "or a measure()/span() context manager that is discarded "
             "without being entered")
    # everywhere: telemetry is written from every layer
    path_markers = ()

    def check(self, mod: SourceModule) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            sink = _is_metrics_call(mod, node, _NAME_SINKS)
            if sink:
                out.extend(self._check_name(mod, node, sink))
            cm = _is_metrics_call(mod, node, _CM_SINKS)
            if cm and cm != "use":
                out.extend(self._check_discarded(mod, node, cm))
        return out

    # ---------------------------------------------------- name cardinality

    def _check_name(self, mod: SourceModule, node: ast.Call,
                    sink: str) -> list:
        name_arg = node.args[0]
        bad = None
        if isinstance(name_arg, ast.JoinedStr):
            for part in name_arg.values:
                if isinstance(part, ast.FormattedValue) and \
                        not _interp_ok(part.value):
                    bad = ast.unparse(part.value)
                    break
        elif isinstance(name_arg, ast.BinOp) and \
                isinstance(name_arg.op, (ast.Add, ast.Mod)):
            # "x." + thing + ".y" / thing + ".y" / "x.%s" % thing — fold
            # the whole chain and judge EVERY non-literal operand (a
            # trailing literal suffix must not launder an id)
            stack, bad = [name_arg], None
            while stack and bad is None:
                node_i = stack.pop()
                if isinstance(node_i, ast.BinOp) and \
                        isinstance(node_i.op, (ast.Add, ast.Mod)):
                    stack.extend((node_i.left, node_i.right))
                elif isinstance(node_i, ast.Tuple):
                    stack.extend(node_i.elts)   # "%s.%s" % (a, b)
                elif not _interp_ok(node_i):
                    bad = ast.unparse(node_i)
        elif isinstance(name_arg, ast.Call) and \
                isinstance(name_arg.func, ast.Attribute) and \
                name_arg.func.attr == "format":
            for a in list(name_arg.args) + \
                    [k.value for k in name_arg.keywords]:
                if not _interp_ok(a):
                    bad = ast.unparse(a)
                    break
        if bad is None:
            return []
        return [mod.finding(
            self, node,
            f"metric name for {sink}() interpolates {bad!r} — an "
            f"unbounded dimension grows the registry and every scrape "
            f"forever; use a bounded label on observe(), a trace "
            f"attribute (nomad_tpu_torch/obs), or allowlist a provably "
            f"bounded name")]

    # ------------------------------------------------ discarded ctx manager

    def _check_discarded(self, mod: SourceModule, node: ast.Call,
                         sink: str) -> list:
        parent = mod.parent(node)
        # with-item (direct or aliased): fine
        if isinstance(parent, ast.withitem):
            return []
        # nested combinators: ExitStack().enter_context(measure(...)),
        # contextlib.nullcontext fallbacks — entered by the wrapper
        if isinstance(parent, ast.Call):
            return []
        if isinstance(parent, ast.Expr):
            return [mod.finding(
                self, node,
                f"{sink}() called as a bare statement — the context "
                f"manager is discarded without being entered, so the "
                f"measurement/span is silently never recorded; wrap the "
                f"timed block in `with ...{sink}(...):`")]
        return []


# ---------------------------------------------------------------- OBS002

# loop-iterable / loop-target markers identifying a walk over placement
# units (the reconciler's AllocPlaceResult / destructive-update shapes)
_PLACEMENT_ITER_MARKERS = ("missings", "leftovers", "destructive",
                           "unplaced")
_PLACEMENT_TARGETS = ("missing",)

# evidence that the enclosing function attaches (or hands off to
# something that attaches) an AllocMetric for rejected work
_ATTACH_ATTRS = ("failed_tg_allocs",)
_ATTACH_CALLS = ("filter_node", "exhausted_node", "fallback",
                 "failed_metric", "explain", "preempt")
_ATTACH_KWARGS = ("metrics",)


@register
class RejectionAttribution(Rule):
    id = "OBS002"
    severity = "error"
    short = ("a scheduler/solver code path walks placement units and can "
             "drop a rejected task without attaching an AllocMetric "
             "(no failed_tg_allocs/metrics write or attributed handoff "
             "in the enclosing function)")
    # the two layers that own placement verdicts; everything else
    # receives AllocMetric objects, it doesn't mint them
    path_markers = ("/scheduler/", "/solver/")

    def check(self, mod: SourceModule) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.For):
                continue
            if not self._is_placement_walk(node):
                continue
            fn = self._enclosing_function(mod, node)
            if fn is None:
                continue
            if self._drops(node) and not self._attaches(fn):
                out.append(mod.finding(
                    self, node,
                    "placement-unit loop can drop a rejected task with "
                    "no AllocMetric attribution in the enclosing "
                    "function — a rejection the operator can never "
                    "explain; write failed_tg_allocs / ctx.metrics (or "
                    "hand off to a fallback/explain path) before "
                    "dropping, or disable with justification"))
        return out

    @staticmethod
    def _enclosing_function(mod: SourceModule, node: ast.AST):
        for anc in mod.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    @staticmethod
    def _is_placement_walk(loop: ast.For) -> bool:
        if isinstance(loop.target, ast.Name) and \
                loop.target.id in _PLACEMENT_TARGETS:
            return True
        try:
            it = ast.unparse(loop.iter).lower()
        except Exception:   # noqa: BLE001 — unparse best-effort
            return False
        return any(m in it for m in _PLACEMENT_ITER_MARKERS)

    @staticmethod
    def _drops(loop: ast.For) -> bool:
        """A unit can leave the loop unplaced: a `continue`, or a bare
        `break` before the collection is exhausted."""
        for sub in ast.walk(loop):
            if isinstance(sub, (ast.Continue, ast.Break)):
                return True
        return False

    @staticmethod
    def _attaches(fn: ast.AST) -> bool:
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Attribute) and \
                    sub.attr in _ATTACH_ATTRS:
                return True
            if isinstance(sub, ast.Call):
                try:
                    d = ast.unparse(sub.func).lower()
                except Exception:   # noqa: BLE001
                    d = ""
                if any(m in d for m in _ATTACH_CALLS):
                    return True
                for kw in sub.keywords:
                    if kw.arg in _ATTACH_KWARGS:
                        return True
        return False
