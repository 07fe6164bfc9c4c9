"""Device-program rules in torch's idiom: host syncs inside a device
program (JIT001) and kernel libraries built or loaded per call (JIT002).
The ids are the reference's (its jax.jit rules), so markers and the
catalog read the same in both packages.

JIT001 — a device program is a function that promises no host sync
until its caller's one copy to the host: it queues gathers, kernel
launches and torch ops on the card's stream and returns tensors still
on the card (the fused programs `cuda_kernels.fused_eval_depth`,
`fused_eval_depth_lanes`, `fused_eval_greedy`, `convex_eval_fused` and
their torch counterparts in `kernels`/`convex`). Each is named by the
no-op decorator `solver.device.device_program`. Inside one (nested
lambdas and defs included), the host syncs SYNC001 lists are flagged:
`.item()`, `.cpu()`, `.tolist()`, `.numpy()`, `.to("cpu")`,
`.synchronize()`, `np.asarray`/`np.array` of a tensor, and
`float()`/`int()`/`bool()` of a tensor expression. Python scalars the
caller passes in (counts, caps, flags) are host values: converting them
syncs nothing, and the rule only flags what the body shows to be a
tensor.

JIT002 — a kernel library built or loaded inside a function body:
`ctypes.CDLL(...)` (or `ctypes.cdll.LoadLibrary`),
`torch.utils.cpp_extension.load`/`load_inline`, or a `subprocess` call
that runs nvcc. Each call re-links (or re-compiles) the kernel, the
port's version of a `jax.jit` made on every call. Exempt are the
reference's memo idioms: `return <load>(...)` (a factory: the cost is
its caller's, once), a store into a subscripted cache
(`self._fns[key] = ctypes.CDLL(...)`), a `global`/`nonlocal` memo, and a
local the same function then stores into a subscripted cache (the
double-checked loader `cuda_kernels._fn`). Each exemption looks through
wrapper calls taking the load as an argument (`getattr(CDLL(p), sym)`).
The build step behind the memoized loader (`cuda_kernels.build`, which
runs nvcc only for libraries missing from the build directory) carries
an inline disable saying so.
"""
from __future__ import annotations

import ast

from .core import Rule, SourceModule, register
from .rules_sync import TensorScope, host_sync

_PROGRAM_DECORATOR = "device_program"
_LOADERS = {"ctypes.CDLL", "ctypes.cdll.LoadLibrary",
            "torch.utils.cpp_extension.load",
            "torch.utils.cpp_extension.load_inline"}
_SUBPROCESS = {"subprocess.Popen", "subprocess.run", "subprocess.call",
               "subprocess.check_call", "subprocess.check_output"}


def _is_program(mod: SourceModule, fn) -> bool:
    for dec in fn.decorator_list:
        d = mod.dotted(dec.func if isinstance(dec, ast.Call) else dec)
        if d and d.split(".")[-1] == _PROGRAM_DECORATOR:
            return True
    return False


def device_programs(mod: SourceModule):
    """Every function of `mod` decorated as a device program."""
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                _is_program(mod, node):
            yield node


@register
class DeviceProgramHostSync(Rule):
    id = "JIT001"
    severity = "error"
    short = ("host sync (.item(), .cpu(), .tolist(), float() of a tensor, "
             "np.asarray of a tensor) inside a device program")

    def check(self, mod: SourceModule) -> list:
        out = []
        for fn in device_programs(mod):
            scope = TensorScope(mod, fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                desc = host_sync(scope, node)
                if desc:
                    out.append(mod.finding(
                        self, node,
                        f"{desc} inside device program `{fn.name}` waits "
                        f"for the card — keep the value on the card and "
                        f"let the caller's one copy to the host bring it "
                        f"back"))
        return out


def _mentions(node: ast.AST, word: str) -> bool:
    """Does `node` hold a name or string constant containing `word`?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and word in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and word in sub.attr.lower():
            return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and word in sub.value.lower():
            return True
    return False


def _runs_nvcc(call: ast.Call, scope) -> bool:
    """A subprocess call whose arguments show nvcc, directly or through
    one local binding (`cmd = [nvcc, ...]; Popen(cmd)`)."""
    args = list(call.args) + [k.value for k in call.keywords]
    if any(_mentions(a, "nvcc") for a in args):
        return True
    names = {a.id for a in args if isinstance(a, ast.Name)}
    if not names or scope is None:
        return False
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in names
                for t in node.targets) and _mentions(node.value, "nvcc"):
            return True
    return False


@register
class PerCallKernelLoad(Rule):
    id = "JIT002"
    severity = "error"
    short = ("kernel library built or loaded (ctypes.CDLL, cpp_extension."
             "load, nvcc) inside a function body outside a memoized "
             "loader — rebuilds or reloads the kernel every call")

    def _enclosing_scope(self, mod: SourceModule, node: ast.AST):
        """Nearest function the call EXECUTES in; decorators execute in
        the scope enclosing their function, so climb past those."""
        child = node
        for anc in mod.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(child is d for d in anc.decorator_list):
                    child = anc
                    continue
                return anc
            if isinstance(anc, ast.Lambda):
                return anc
            child = anc
        return None

    def _is_memoized(self, mod: SourceModule, call: ast.Call,
                     scope: ast.AST) -> bool:
        node = call
        parent = mod.parent(call)
        while isinstance(parent, ast.Call) and \
                any(node is a for a in parent.args):
            node = parent
            parent = mod.parent(node)
        if isinstance(parent, ast.Return):
            return True                          # factory pattern
        if not isinstance(parent, ast.Assign):
            return False
        names = []
        for tgt in parent.targets:
            if isinstance(tgt, ast.Subscript):
                return True                      # cache store
            if isinstance(tgt, ast.Name):
                names.append(tgt.id)
        if not names:
            return False
        declared: set = set()
        stored: set = set()
        for sub in ast.walk(scope):
            if isinstance(sub, (ast.Global, ast.Nonlocal)):
                declared.update(sub.names)
            elif isinstance(sub, ast.Assign) and \
                    isinstance(sub.value, ast.Name) and \
                    any(isinstance(t, ast.Subscript) for t in sub.targets):
                stored.add(sub.value.id)
        # a global/nonlocal memo, or a local the function caches
        return all(n in declared for n in names) or \
            all(n in stored for n in names)

    def check(self, mod: SourceModule) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            d = mod.dotted(node.func) or ""
            if d not in _LOADERS and d not in _SUBPROCESS:
                continue
            scope = self._enclosing_scope(mod, node)
            if scope is None:                    # module scope: loads once
                continue
            if d in _SUBPROCESS and not _runs_nvcc(node, scope):
                continue
            if self._is_memoized(mod, node, scope):
                continue
            what = "nvcc" if d in _SUBPROCESS else f"{d}(...)"
            out.append(mod.finding(
                self, node,
                f"{what} inside a function body builds or loads a kernel "
                f"library on every call — load it once at module scope, "
                f"return it from a factory, or keep it in a keyed cache "
                f"(cuda_kernels._fn)"))
        return out
