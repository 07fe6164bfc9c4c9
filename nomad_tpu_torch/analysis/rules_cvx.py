"""CVX001 — one-launch discipline in the convex solve path, in torch's
idiom (the id is the reference's, so markers and the catalog read the
same in both packages).

The convex tier's contract on the card is that a solve costs ONE launch
of csrc/convex_solve.cu: every projected-gradient iteration and every
water-filling bisection runs inside the kernel, and the rounding and
greedy baseline behind it are a fixed sequence of torch ops on the same
stream. The failure shape this rule patrols is the obvious refactor:
hoisting the iteration into a Python-level `for`/`while` around tensor
operations or kernel calls ("just N fixed steps", "just to watch
convergence"). That queues launches per iteration and, wherever the
loop's test reads a tensor, syncs the host per iteration — up to
`max_iters` round trips where the contract promises one launch.

Scope: `/solver/convex.py`. A loop is flagged when it holds a `torch.*`
call (less torch's host-side helpers), a call into
`kernels`/`cuda_kernels`, or arithmetic, a comparison or a method call
on a value its function shows to be a tensor (rules_sync.TensorScope).
The plain version's iteration (`convex_solve_ref`, the kernel's
reference on the CPU, never on the card path) and the fixed reduction
tree that reproduces the kernel's summation order carry inline disables
saying so.
"""
from __future__ import annotations

import ast

from .core import Rule, SourceModule, register
from .rules_sync import (
    _DEVICE_MODULES, _HOST_METHODS, _TORCH_HOST, TensorScope,
    outermost_function,
)


def _device_op(scope: TensorScope, node: ast.AST) -> str:
    """-> a description if `node` is a tensor operation, else ''."""
    if isinstance(node, ast.Call):
        d = scope.mod.dotted(node.func) or ""
        if d.startswith("torch.") and not d.startswith(_TORCH_HOST):
            return f"{d}(...)"
        if d.startswith(_DEVICE_MODULES):
            return f"{d}(...)"
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr not in _HOST_METHODS and \
                scope.is_tensor(node.func.value):
            return f".{node.func.attr}(...)"
        return ""
    if isinstance(node, (ast.BinOp, ast.Compare)) and scope.is_tensor(node):
        return "tensor arithmetic"
    return ""


@register
class OneLaunchLoop(Rule):
    id = "CVX001"
    severity = "error"
    short = ("Python-level for/while around tensor operations or kernel "
             "calls in the convex solve path — the iteration belongs in "
             "the one launch of the convex-solve kernel")
    path_markers = ("/solver/convex.py",)

    def check(self, mod: SourceModule) -> list:
        out = []
        scopes: dict = {}
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                continue
            top = outermost_function(mod, node)
            scope = scopes.get(id(top))
            if scope is None:
                scope = scopes[id(top)] = TensorScope(mod, top)
            for sub in ast.walk(node):
                desc = _device_op(scope, sub)
                if desc:
                    kind = "while" if isinstance(node, ast.While) else "for"
                    out.append(mod.finding(
                        self, node,
                        f"Python-level `{kind}` loop wraps the device "
                        f"operation `{desc}` — each iteration queues its "
                        f"own launches (and syncs wherever the loop reads "
                        f"a tensor), breaking the convex tier's one-launch "
                        f"contract; move the iteration into the kernel "
                        f"(or mark a deliberate host loop with "
                        f"`# nomadlint: disable=CVX001 — <why>`)"))
                    break               # one finding per loop
        return out
