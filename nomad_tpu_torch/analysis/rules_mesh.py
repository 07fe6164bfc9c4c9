"""MESH001 — elastic-mesh hygiene (ISSUE 14, docs/SHARDED_SOLVE.md
"Elasticity").

Two failure shapes, both of which turn a recoverable device loss into a
permanent outage:

  * **Mesh-keyed caches keyed by mesh SHAPE or AXIS NAMES instead of the
    Mesh object or generation** (the PR-9 dead-mesh-wrapper class): a
    rebuilt mesh over 7 survivors of 8 can produce the same `.shape` /
    `.axis_names` as a test double — and an old-generation mesh REUSES
    its key after a rebuild whenever the shard count matches, so the
    cache happily serves executables whose NamedShardings reference the
    DEAD Mesh and every dispatch throws forever. Key on the Mesh object
    (identity changes with every rebuild) or the generation counter —
    `microbatch._batched_fn` and `state_cache._jit` are the blessed
    patterns.

  * **Broad `except` around a sharded dispatch that never consults
    `device_error_types()`**: a bare/`Exception` handler that swallows a
    sharded kernel call without classifying it cannot tell a device LOSS
    (quarantine + rebuild + replay) from a transient (breaker ladder) —
    the loss is eaten, nothing rebuilds, and the dead mesh is retried on
    every subsequent eval. Handlers must either catch
    `backend.device_error_types()` directly or consult the
    classification helpers (`classify_device_error`,
    `note_dispatch_failure`) inside the handler.

Scoped to `/solver/` — that package owns every mesh decision. New
exceptions take the standard inline
`# nomadlint: disable=MESH001 — <why>` with a justification
(docs/STATIC_ANALYSIS.md).
"""
from __future__ import annotations

import ast

from .core import Rule, SourceModule, register

# attribute names whose use inside a cache KEY marks shape-keying
_SHAPE_ATTRS = ("shape", "axis_names", "axis_sizes")

# a value expression "looks like a mesh" when its name chain mentions one
_MESHISH = ("mesh", "m")

# call names that constitute a sharded dispatch for the except check
_DISPATCH_MARKERS = ("shard_map",)

# names whose presence in a handler (or its type expression) proves the
# classification contract is consulted
_CLASSIFY_MARKERS = ("device_error_types", "classify_device_error",
                     "note_dispatch_failure")


def _name_chain(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        parts.append(_name_chain(node.func))
    return ".".join(reversed(parts)).lower()


def _is_meshish(node: ast.AST) -> bool:
    chain = _name_chain(node)
    if not chain:
        return False
    leaf = chain.split(".")[-1]
    return leaf in _MESHISH or "mesh" in chain


def _shape_keyed_mesh_attrs(expr: ast.AST):
    """Attribute nodes like `m.shape` / `mesh.axis_names` inside a key
    expression."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in _SHAPE_ATTRS \
                and _is_meshish(node.value):
            yield node


def _is_sharded_dispatch_call(call: ast.Call) -> bool:
    """Calls that launch a sharded program: the `sharded_*` wrapper
    family (sharding.py's kernel factories and anything following the
    naming convention) plus shard_map itself."""
    name = _name_chain(call.func)
    if not name:
        return False
    leaf = name.split(".")[-1]
    return leaf.startswith("sharded_") or leaf in _DISPATCH_MARKERS


def _mentions_classifier(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and \
                sub.attr in _CLASSIFY_MARKERS:
            return True
        if isinstance(sub, ast.Name) and sub.id in _CLASSIFY_MARKERS:
            return True
    return False


def _handler_is_broad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True                              # bare except
    names = [_name_chain(t).split(".")[-1]
             for t in (handler.type.elts
                       if isinstance(handler.type, ast.Tuple)
                       else [handler.type])]
    return any(n in ("exception", "baseexception") for n in names)


@register
class ElasticMeshHygiene(Rule):
    id = "MESH001"
    severity = "error"
    short = ("mesh-keyed caches keyed by mesh shape/axis-names instead "
             "of the Mesh object or generation (dead-mesh wrappers "
             "survive a rebuild), and broad except around sharded "
             "dispatch that never consults device_error_types() — a "
             "swallowed device loss never rebuilds the mesh")
    path_markers = ("/solver/",)

    # -------------------------------------------------- shape-keyed caches

    def _check_cache_keys(self, mod: SourceModule) -> list:
        out = []
        for node in ast.walk(mod.tree):
            key_exprs = []
            if isinstance(node, ast.Subscript) and \
                    isinstance(mod.parent(node), ast.Assign):
                # cache[key] = ... (store into a subscripted container)
                if mod.parent(node).targets and \
                        node in mod.parent(node).targets:
                    key_exprs.append(node.slice)
            elif isinstance(node, ast.Call):
                leaf = _name_chain(node.func).split(".")[-1]
                if leaf in ("get", "setdefault") and node.args:
                    key_exprs.append(node.args[0])
            for key in key_exprs:
                for attr in _shape_keyed_mesh_attrs(key):
                    out.append(mod.finding(
                        self, attr,
                        f"cache key uses `...{attr.attr}` of a mesh: a "
                        f"REBUILT mesh (device loss, torn pod) can "
                        f"reproduce the same {attr.attr}, so the cache "
                        f"serves executables bound to the DEAD Mesh "
                        f"forever — key on the Mesh OBJECT or the "
                        f"generation counter (sharding.generation) "
                        f"instead"))
        return out

    # ------------------------------------------- unclassified broad except

    def _check_broad_except(self, mod: SourceModule) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Try):
                continue
            dispatches = [
                c for stmt in node.body for c in ast.walk(stmt)
                if isinstance(c, ast.Call) and
                _is_sharded_dispatch_call(c)]
            if not dispatches:
                continue
            for handler in node.handlers:
                if not _handler_is_broad(handler):
                    continue
                if _mentions_classifier(handler):
                    continue
                out.append(mod.finding(
                    self, handler,
                    "broad `except` around a sharded dispatch without "
                    "consulting device_error_types(): a device LOSS is "
                    "swallowed as if transient — nothing quarantines "
                    "the corpse or rebuilds the mesh, and every later "
                    "dispatch throws against it. Catch backend."
                    "device_error_types() (classify via "
                    "note_dispatch_failure/classify_device_error) "
                    "before any broad fallback"))
        return out

    def check(self, mod: SourceModule) -> list:
        return self._check_cache_keys(mod) + self._check_broad_except(mod)
