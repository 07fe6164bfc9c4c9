"""DET001/DET002 — determinism on scheduler/solver decision paths.

Heterogeneity-aware schedulers (Gavel) and placement-policy systems
(Tesserae) both treat scheduler determinism as a correctness property:
identical (snapshot, eval, seed) inputs must give identical placements,
or differential tests, plan-rejection accounting, and incident replay
all lose their footing. The scheduler threads a seeded `random.Random`
through `GenericStack.rng` for exactly this reason.

Flagged inside `nomad_tpu_torch/scheduler/` and `nomad_tpu_torch/solver/`:
  * calls on the process-global `random` module (`random.getrandbits`,
    `random.shuffle`, ...) — shared mutable stream, order-dependent
    across threads and call sites;
  * `random.Random()` with no seed — seeded from OS entropy;
  * `numpy.random.*` global-state calls, and `default_rng()` without a
    seed;
  * `time.time()` — wall clock feeding a decision path. (Wall-clock
    uses that are part of the scheduling SPEC — reschedule windows,
    alloc timestamps — carry an inline disable with that justification;
    `time.monotonic`/`perf_counter` for latency metrics are fine.)
"""
from __future__ import annotations

import ast

from .core import Rule, SourceModule, register


@register
class DecisionPathNondeterminism(Rule):
    id = "DET001"
    severity = "error"
    short = ("global/unseeded RNG or wall clock on a scheduler/solver "
             "decision path")
    # server/heartbeat.py joined the scope with ISSUE 10: every deadline
    # decision there reads the injectable chrono.Clock and the TTL jitter
    # draws from a seeded per-instance Random, so ManualClock storm tests
    # replay bit-identically — a wall-clock or global-RNG regression
    # would silently de-determinize the mass-failure suite.
    # client/client.py joined with ISSUE 18: heartbeat bookkeeping and
    # retry jitter ride the client's injectable clock + seeded rng so
    # partition sims time-compress the disconnect/reconnect cycle
    path_markers = ("/scheduler/", "/solver/", "/server/heartbeat.py",
                    "/client/client.py")

    def check(self, mod: SourceModule) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            d = mod.dotted(node.func)
            if d is None:
                continue
            if d == "random.Random":
                if not node.args:
                    out.append(mod.finding(
                        self, node,
                        "unseeded random.Random() — thread the "
                        "scheduler's seeded rng (GenericStack.rng) or "
                        "seed deterministically"))
            elif d.startswith("random."):
                out.append(mod.finding(
                    self, node,
                    f"{d}() uses the process-global RNG stream — "
                    f"placements stop being a function of (snapshot, "
                    f"eval, seed); use the stack's seeded rng"))
            elif d == "numpy.random.default_rng":
                if not node.args:
                    out.append(mod.finding(
                        self, node,
                        "numpy.random.default_rng() without a seed — "
                        "derive the seed from the eval's rng"))
            elif d.startswith("numpy.random."):
                out.append(mod.finding(
                    self, node,
                    f"{d}() mutates numpy's global RNG state — use a "
                    f"seeded Generator instead"))
            elif d == "time.time":
                out.append(mod.finding(
                    self, node,
                    "time.time() on a decision path makes scheduling "
                    "wall-clock-dependent — inject `now` or use the "
                    "eval's timestamp (disable inline where wall clock "
                    "IS the spec, e.g. reschedule windows)"))
        return out


@register
class CachedTensorMutation(Rule):
    """DET002 — direct mutation of cached cluster tensors outside the
    state cache (ISSUE 4 satellite).

    The versioned tensor cache (nomad_tpu_torch/solver/state_cache.py) and the
    usage index's views hand out arrays whose bits ARE the versioning
    contract: `used` must equal the journal prefix through `version`,
    bit-for-bit, or the incremental path silently diverges from the
    full-rebuild path. Only usage_index.py (the journal writer) and
    state_cache.py (the replayer) may mutate them. Everything else gets
    fancy-index COPIES — mutating those is fine; mutating the resident
    arrays through a view/cache alias is the bug this rule catches:

      * in-place writes through a whole-array alias of a view/cache
        field (`u = snap.usage.used; u[i] -= x`),
      * subscript/augmented writes directly through the field
        (`view.used[r] += d`), or rebinding the field itself,
      * `np.add.at` / `np.subtract.at` targeting either form.
    """

    id = "DET002"
    severity = "error"
    short = ("in-place mutation of cached cluster tensors (usage view / "
             "state cache) outside state_cache")
    path_markers = ("/solver/", "/state/", "/server/", "/scheduler/")
    EXEMPT = ("state/usage_index.py", "solver/state_cache.py")
    FIELDS = {"cap", "used", "counts", "cap_dev", "used_dev", "elig"}
    _INPLACE_CALLS = {"numpy.add.at", "numpy.subtract.at",
                      "numpy.multiply.at", "numpy.divide.at"}

    def applies_to(self, mod: SourceModule) -> bool:
        if any(mod.match_path.endswith(e) for e in self.EXEMPT):
            return False
        return super().applies_to(mod)

    # ---------------------------------------------------------- tracking

    def _is_view_source(self, mod: SourceModule, node: ast.AST) -> bool:
        """Does this expression denote a usage view or the state cache?
        `<x>.usage`, `<x>.usage.view()`, `state_cache.cache()` /
        `cache()` imported from state_cache."""
        if isinstance(node, ast.Attribute) and node.attr == "usage":
            return True
        if isinstance(node, ast.Call):
            d = mod.dotted(node.func)
            if d is None:
                return False
            if d.endswith("state_cache.cache") or d == "state_cache.cache":
                return True
            if d.endswith(".view") and self._is_view_source(
                    mod, node.func.value):
                return True
        return False

    def _tracked_in(self, mod: SourceModule, fn: ast.AST) -> tuple:
        """(view-like names, array-alias names) assigned directly in
        scope `fn` (nested defs are their own scopes — a sibling
        function's alias must not taint this one)."""
        views: set = set()
        arrays: set = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            if self._scope_of(mod, node) is not fn:
                continue
            for t in node.targets:
                if not isinstance(t, ast.Name):
                    continue
                if self._is_view_source(mod, node.value):
                    views.add(t.id)
                elif isinstance(node.value, ast.Attribute) and \
                        node.value.attr in self.FIELDS and \
                        self._target_is_tracked(mod, node.value.value,
                                                views):
                    arrays.add(t.id)    # whole-array alias, not a copy
        return views, arrays

    def _target_is_tracked(self, mod: SourceModule, base: ast.AST,
                           views: set) -> bool:
        """Is `base` (the X in X.used) a view/cache expression?"""
        if isinstance(base, ast.Name) and base.id in views:
            return True
        return self._is_view_source(mod, base)

    def _arg_is_tracked(self, mod: SourceModule, node: ast.AST,
                        views: set, arrays: set) -> bool:
        """Is `node` a cached array — an alias name or `<view>.<field>`?"""
        if isinstance(node, ast.Name):
            return node.id in arrays
        if isinstance(node, ast.Attribute) and node.attr in self.FIELDS:
            return self._target_is_tracked(mod, node.value, views)
        return False

    def _mutates_tracked(self, mod: SourceModule, target: ast.AST,
                         views: set, arrays: set) -> bool:
        # peel subscripts: view.used[r], alias[r], view.used[r][c]
        node = target
        while isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Name):
            # a bare-name REBIND is a fresh local, not a mutation; only
            # subscript stores through an alias hit the resident array
            return node.id in arrays and isinstance(target, ast.Subscript)
        if isinstance(node, ast.Attribute) and node.attr in self.FIELDS:
            return self._target_is_tracked(mod, node.value, views)
        return False

    # ------------------------------------------------------------- check

    def _scope_of(self, mod: SourceModule, node: ast.AST) -> ast.AST:
        for anc in mod.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return mod.tree

    def check(self, mod: SourceModule) -> list:
        out = []
        tracked: dict[int, tuple] = {}      # id(scope) -> (views, arrays)

        def lookup(node: ast.AST) -> tuple:
            """Merged alias tracking from the node's enclosing function
            scope and the module (closure-captured aliases resolve)."""
            views: set = set()
            arrays: set = set()
            for scope in (self._scope_of(mod, node), mod.tree):
                key = id(scope)
                if key not in tracked:
                    tracked[key] = self._tracked_in(mod, scope)
                views |= tracked[key][0]
                arrays |= tracked[key][1]
            return views, arrays

        for node in ast.walk(mod.tree):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            elif isinstance(node, ast.Call):
                d = mod.dotted(node.func)
                if d in self._INPLACE_CALLS and node.args:
                    views, arrays = lookup(node)
                    if self._arg_is_tracked(mod, node.args[0],
                                            views, arrays):
                        out.append(mod.finding(
                            self, node,
                            f"{d}() mutates a cached cluster tensor in "
                            f"place — route deltas through the usage "
                            f"journal / state_cache"))
                continue
            for t in targets:
                views, arrays = lookup(node)
                if self._mutates_tracked(mod, t, views, arrays):
                    out.append(mod.finding(
                        self, node,
                        "write to a cached cluster tensor outside "
                        "state_cache breaks the versioning contract "
                        "— operate on a fancy-index copy, or route "
                        "the delta through the usage journal"))
        return out
