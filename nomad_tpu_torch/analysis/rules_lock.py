"""LOCK001 — unlocked attribute writes in lock-owning classes.

A class that assigns `self.X = threading.Lock()/RLock()/Condition(...)`
has declared that some of its state is shared across threads. For every
attribute the class itself writes at least once inside a
`with self.<lock>:` block (i.e. state the class demonstrably treats as
lock-guarded), any OTHER plain attribute write outside such a block is a
lost-update hazard — exactly what Go's `-race` flags on the reference's
broker/applier state.

Calibrated exemptions (this is a discipline check, not an alias
analysis):
  * `__init__`, and helpers the class calls ONLY from `__init__`
    (disk-restore/load paths) — construction happens-before publication;
  * methods named `*_locked` — the caller-holds-lock convention (the
    reference's `...Locked` helpers); use the suffix when a helper is
    only ever called under the lock;
  * writes to the lock/condition attributes themselves;
  * attributes never written under the lock anywhere in the class —
    presumed thread-confined or deliberately GIL-atomic (document those
    with an inline `# nomadlint: disable=LOCK001 — why`).
"""
from __future__ import annotations

import ast

from .core import Rule, SourceModule, register

_LOCK_TYPES = {"threading.Lock", "threading.RLock", "threading.Condition"}


def _self_name(fn: ast.AST) -> str:
    args = fn.args.posonlyargs + fn.args.args
    return args[0].arg if args else ""


def _write_targets(stmt: ast.AST):
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    else:
        return []
    out = []
    for t in targets:
        # flatten unpacking: `self.a, self.b = x, y` writes both attrs
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                out.append(e.value if isinstance(e, ast.Starred) else e)
        else:
            out.append(t)
    return out


def _self_attr(node: ast.AST, selfname: str):
    """-> attribute name when `node` is `<self>.<attr>`, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and \
            node.value.id == selfname:
        return node.attr
    return None


@register
class UnlockedSharedWrite(Rule):
    id = "LOCK001"
    severity = "error"
    short = ("attribute write outside `with self._lock` in a class that "
             "guards that attribute elsewhere")

    def check(self, mod: SourceModule) -> list:
        out = []
        for cls in ast.walk(mod.tree):
            if isinstance(cls, ast.ClassDef):
                out.extend(self._check_class(mod, cls))
        return out

    def _methods(self, cls: ast.ClassDef):
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield stmt

    def _guards(self, mod: SourceModule, cls: ast.ClassDef) -> set:
        guards: set = set()
        for method in self._methods(cls):
            selfname = _self_name(method)
            if not selfname:
                continue
            for node in ast.walk(method):
                for tgt in _write_targets(node):
                    attr = _self_attr(tgt, selfname)
                    if attr and isinstance(getattr(node, "value", None),
                                           ast.Call) and \
                            mod.dotted(node.value.func) in _LOCK_TYPES:
                        guards.add(attr)
        return guards

    def _under_guard(self, mod: SourceModule, node: ast.AST,
                     method: ast.AST, selfname: str, guards: set) -> bool:
        """Lexically inside a `with self.<guard>:` within this method."""
        for anc in mod.ancestors(node):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                for item in anc.items:
                    attr = _self_attr(item.context_expr, selfname)
                    if attr in guards:
                        return True
            if anc is method:
                return False
        return False

    def _init_only_helpers(self, cls: ast.ClassDef) -> set:
        """Methods invoked (as self.m(...)) from __init__ and from
        nowhere else in the class — construction-time helpers that
        happen-before publication, same exemption as __init__ itself."""
        called_in_init: set = set()
        called_elsewhere: set = set()
        for method in self._methods(cls):
            selfname = _self_name(method)
            if not selfname:
                continue
            bucket = (called_in_init if method.name == "__init__"
                      else called_elsewhere)
            for node in ast.walk(method):
                if isinstance(node, ast.Call):
                    attr = _self_attr(node.func, selfname)
                    if attr:
                        bucket.add(attr)
        return called_in_init - called_elsewhere

    def _check_class(self, mod: SourceModule, cls: ast.ClassDef) -> list:
        guards = self._guards(mod, cls)
        if not guards:
            return []
        init_only = self._init_only_helpers(cls)
        locked_attrs: set = set()
        unlocked: list = []          # (method, node, attr)
        for method in self._methods(cls):
            selfname = _self_name(method)
            if not selfname:
                continue
            # __init__ is exempt (happens-before publication) but says
            # nothing about discipline, so it neither flags nor marks an
            # attribute as guarded; *_locked helpers run WITH the lock
            # held by convention, so their writes do count as guarded
            init = method.name == "__init__" or method.name in init_only
            held = method.name.endswith("_locked")
            for node in ast.walk(method):
                for tgt in _write_targets(node):
                    attr = _self_attr(tgt, selfname)
                    if attr is None or attr in guards or init:
                        continue
                    if held or self._under_guard(mod, node, method,
                                                 selfname, guards):
                        locked_attrs.add(attr)
                    else:
                        unlocked.append((method, node, attr))
        out = []
        for method, node, attr in unlocked:
            if attr not in locked_attrs:
                continue        # never guarded anywhere: presumed private
            out.append(mod.finding(
                self, node,
                f"{cls.name}.{method.name} writes self.{attr} outside "
                f"`with self.{sorted(guards)[0]}` but the class guards "
                f"that attribute elsewhere — lost-update hazard (rename "
                f"the helper *_locked if the caller holds the lock)"))
        return out
