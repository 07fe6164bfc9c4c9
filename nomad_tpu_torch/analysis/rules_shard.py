"""SHARD001 — a node-axis matrix placed whole on one device where the
mesh's partition is due, and sharded programs whose declared layouts
disagree with their signatures. The port's rewrite of the reference's
SHARD001 (nomad_tpu/analysis/rules_shard.py), which catches
`jax.device_put(cap)` and spec-less `jax.jit` of node matrices: under a
mesh those silently REPLICATE the matrix onto every device, invisible at
10k nodes and an OOM plus a per-eval re-scatter at 100k.

The port's mesh (nomad_tpu_torch/solver/sharding.py) is explicit: a
node-axis tensor on the mesh is a `NodeSharded` of per-shard row blocks,
placed by `sharding.put_node_sharded` / `node_blocks`, and a sharded
program declares one layout per argument and its result with
`@sharding.sharded_program(m, ins=(...), out=...)`. The failure shape is
the same: code that handles the mesh moving a whole node matrix onto one
device (`.to(dev)`, `.cuda()`, `torch.as_tensor(x, device=...)`,
`torch.tensor(x, device=...)`, the upload helpers) — one device then
holds every shard's rows, and the next sharded launch re-scatters them.
`NodeSharded.lead()` is the deliberate, visible form (results meeting on
the mesh's first device) and is not flagged. `solver/sharding.py` and
`solver/state_cache.py` OWN placement decisions and are exempt from that
check.

Flagged (outside sharding.py / state_cache.py), inside a function that
handles the mesh — its body names `mesh`, `NodeSharded`,
`put_node_sharded`, `node_blocks` or `is_node_sharded`:
  * `<node-matrix>.to(...)` / `.cuda(...)`, `torch.as_tensor` /
    `torch.tensor` / `torch.asarray` of a node matrix with a `device=`,
    and `_upload(<node-matrix>, ...)` / `_tensor(<node-matrix>, ...)`.
    A node matrix is a name `cap`, `used`, `cap_*`, `used_*`, `*_dev` or
    `*_res`.

Flagged everywhere (arity, as the reference's in/out_shardings checks):
  * `@sharded_program(..., ins=(...), ...)` whose `ins` tuple length
    differs from the decorated function's positional parameters, or with
    no `ins`;
  * `out=(...)` a tuple whose length differs from the decorated
    function's single statically visible `return (a, b, ...)`.

New sites take an inline `# nomadlint: disable=SHARD001 — <why>`.
"""
from __future__ import annotations

import ast
from typing import Optional

from .core import Rule, SourceModule, register

_EXEMPT_FILES = ("solver/sharding.py", "solver/state_cache.py")

# a function body naming one of these handles the mesh
_MESH_MARKERS = ("mesh", "NodeSharded", "put_node_sharded", "node_blocks",
                 "is_node_sharded")

# helpers that copy an array whole onto one device
_UPLOADERS = ("_upload", "_tensor")
_TENSOR_CTORS = ("torch.as_tensor", "torch.tensor", "torch.asarray")


def _matrixish_name(name: str) -> bool:
    low = name.lower()
    return low in ("cap", "used") or low.endswith(("_dev", "_res")) or \
        low.startswith(("cap_", "used_"))


def _expr_name(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _kw(call: ast.Call, name: str) -> Optional[ast.keyword]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw
    return None


def _handles_mesh(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        name = node.id if isinstance(node, ast.Name) else \
            node.attr if isinstance(node, ast.Attribute) else ""
        if name and (name in _MESH_MARKERS or "mesh" in name.lower()):
            return True
    return False


def _param_names(fn) -> list:
    args = fn.args
    return [a.arg for a in args.posonlyargs + args.args]


def _return_tuple_len(fn) -> Optional[int]:
    lens = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            continue
        if isinstance(node, ast.Return) and node.value is not None:
            lens.add(len(node.value.elts)
                     if isinstance(node.value, ast.Tuple) else -1)
    if len(lens) == 1:
        n = lens.pop()
        return n if n > 0 else None
    return None


def _own_nodes(fn):
    """The nodes of `fn`'s body, nested function bodies excluded (each
    def is judged on its own)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)


@register
class WholeNodeMatrixOnOneDevice(Rule):
    id = "SHARD001"
    severity = "error"
    short = ("a node-axis matrix (cap/used/*_dev/*_res) moved whole onto "
             "one device in mesh-handling code outside sharding.py/"
             "state_cache.py, or a sharded_program whose ins/out layouts "
             "disagree with its signature — one device ends up holding "
             "every shard's rows")

    def _exempt(self, mod: SourceModule) -> bool:
        p = "/" + mod.match_path.lstrip("/")
        return any(p.endswith(e) or ("/" + e) in p for e in _EXEMPT_FILES)

    # ------------------------------------------------ whole-matrix moves

    def _whole_move(self, mod: SourceModule, call: ast.Call) -> str:
        """The matrix name a call moves whole onto one device, or ''."""
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr in ("to", "cuda") \
                and _matrixish_name(_expr_name(func.value)):
            return _expr_name(func.value)
        dotted = mod.dotted(func) or ""
        if call.args and _matrixish_name(_expr_name(call.args[0])):
            if dotted in _TENSOR_CTORS and _kw(call, "device") is not None:
                return _expr_name(call.args[0])
            if _expr_name(func) in _UPLOADERS:
                return _expr_name(call.args[0])
        return ""

    def _check_moves(self, mod: SourceModule) -> list:
        out = []
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _handles_mesh(fn):
                continue
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = self._whole_move(mod, node)
                if name:
                    out.append(mod.finding(
                        self, node,
                        f"`{name}` moved whole onto one device in "
                        f"`{fn.name}`, which handles the mesh: one device "
                        f"then holds every shard's rows and the next "
                        f"sharded launch re-scatters them — place it with "
                        f"sharding.put_node_sharded / node_blocks, read "
                        f"a NodeSharded's `.lead()` where results are "
                        f"meant to meet, or move the decision into "
                        f"sharding.py/state_cache.py"))
        return out

    # -------------------------------------------------- layout arity

    def _check_programs(self, mod: SourceModule) -> list:
        out = []
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in fn.decorator_list:
                if not isinstance(dec, ast.Call) or \
                        _expr_name(dec.func) != "sharded_program":
                    continue
                params = _param_names(fn)
                ins = _kw(dec, "ins")
                if ins is None:
                    out.append(mod.finding(
                        self, dec,
                        f"sharded_program `{fn.name}` declares no `ins` "
                        f"layouts: its {len(params)} arguments' placement "
                        f"is left implicit"))
                elif isinstance(ins.value, ast.Tuple) and \
                        len(ins.value.elts) != len(params):
                    out.append(mod.finding(
                        self, dec,
                        f"ins has {len(ins.value.elts)} layouts but "
                        f"`{fn.name}` takes {len(params)} positional "
                        f"parameters — the program raises on every call"))
                res = _kw(dec, "out")
                if res is not None and isinstance(res.value, ast.Tuple):
                    rlen = _return_tuple_len(fn)
                    if rlen is not None and rlen != len(res.value.elts):
                        out.append(mod.finding(
                            self, dec,
                            f"out has {len(res.value.elts)} layouts but "
                            f"`{fn.name}` returns a {rlen}-tuple"))
        return out

    def check(self, mod: SourceModule) -> list:
        findings = self._check_programs(mod)
        if not self._exempt(mod):
            findings += self._check_moves(mod)
        return findings
