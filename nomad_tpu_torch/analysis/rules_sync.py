"""SYNC001 — single-sync discipline on the solver hot path, in torch's
idiom (the reference's rule keys on numpy/jax call origins and cannot
see a torch sync at all).

The fused-dispatch contract is structural: an eval touches the card
ONCE — its launches queue on one stream, and one copy to the host at
the designated sync seam brings the results back. The failure shape
this rule patrols is the quiet re-introduction of per-eval host syncs:
a `.item()`, `.cpu()`, `.tolist()`, `.numpy()`, `.to("cpu")`,
`.synchronize()` (`torch.cuda.synchronize`, a stream's or an event's),
`np.asarray`/`np.array` of a tensor, or `float()`/`int()`/`bool()` of a
tensor expression dropped into a placer or micro-batcher hot-path
function "just to peek" at a device value waits for the stream and
re-splits the eval into extra host<->card round trips.

Scope: `/solver/placer.py` and `/solver/microbatch.py` — the two modules
whose function bodies run once per eval (or per coalesced window) — and
`/solver/cuda_kernels.py`, the kernel wrappers those solves call: its
host reads are seams too (the fused route's one copy, and the sharded
convex solve's one wait a block of rounds, `convex_solve_sharded`). A
value is a tensor when the function can show it: a `torch.*` call (less
torch's host-side helpers), a call into `kernels`/`cuda_kernels`, a
parameter annotated `torch.Tensor`, a name bound to any of those, or an
expression, method call, attribute or subscript built on one. A value
the function shows to be a numpy array (a `numpy` call, a parameter
annotated `np.ndarray`, a `host*` binding) is already on the host:
`.item()`/`.tolist()` on it sync nothing. Values the function cannot
type stay quiet; the card run (chip_smoke.py's analysis phase, torch's
sync debug mode) reports every sync the card really makes by line, and
fails on one in this scope that carries no marker. Every legitimate
seam — the placer's single copy to the host, the pipelined chunk
collector, the preemption verdict, the micro-batcher's coalesced window,
the fused route's copy, the sharded convex solve's waits — carries
`# nomadlint: disable=SYNC001 — <why>` (analysis/RULES.md).
"""
from __future__ import annotations

import ast

from .core import Rule, SourceModule, register

# method calls that copy to the host (or wait for the card) whatever
# their receiver: torch-only names, or the port's own copy helpers
_ALWAYS_SYNC = ("cpu", "numpy", "synchronize")
# method calls that sync on a tensor and are free on a numpy array
_TENSOR_SYNC = ("item", "tolist")
_MATERIALIZE = {"numpy.asarray", "numpy.array", "numpy.asanyarray"}
_SYNC_BUILTINS = {"float", "int", "bool"}
# attributes and methods of a tensor that are host metadata, not data
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout"}
_HOST_METHODS = {"numel", "dim", "size", "data_ptr", "is_contiguous",
                 "element_size", "stride", "storage_offset", "nbytes",
                 "untyped_storage", "get_device", "is_pinned", "numpy",
                 "tolist", "item"}
# torch's namespaces of host-side helpers (no tensor result)
_TORCH_HOST = ("torch.cuda.", "torch.backends.", "torch.utils.",
               "torch.distributed.", "torch.device", "torch.is_tensor",
               "torch.get_default_dtype", "torch.set_", "torch.manual_seed",
               "torch._C.")
_DEVICE_MODULES = ("kernels.", "cuda_kernels.")


def _annotation_kind(ann) -> str:
    """"tensor" / "numpy" / "" for a parameter annotation."""
    if ann is None:
        return ""
    text = ast.unparse(ann)
    if text.endswith("Tensor"):
        return "tensor"
    if text.endswith("ndarray"):
        return "numpy"
    return ""


def _targets(node: ast.AST):
    """Names bound by an assignment target (tuple targets unpacked)."""
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _targets(e)
    elif isinstance(node, ast.Starred):
        yield from _targets(node.value)


class TensorScope:
    """Which local names of one function hold tensors and which hold
    numpy arrays, as far as the function's own text shows (parameter
    annotations and the assignments in its body; a name bound both ways
    is neither). Nested defs and lambdas share their parent's names."""

    def __init__(self, mod: SourceModule, fn):
        self.mod = mod
        self.tensors: set = set()
        self.arrays: set = set()
        if fn is None:
            return
        for f in ast.walk(fn):
            if not isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            args = f.args
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                kind = _annotation_kind(a.annotation)
                if kind == "tensor":
                    self.tensors.add(a.arg)
                elif kind == "numpy":
                    self.arrays.add(a.arg)
        assigns = [n for n in ast.walk(fn)
                   if isinstance(n, (ast.Assign, ast.AnnAssign))
                   and n.value is not None]
        for _ in range(4):                      # to a fixpoint
            before = (len(self.tensors), len(self.arrays))
            for n in assigns:
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                if self.is_tensor(n.value):
                    kind = self.tensors
                elif self.is_array(n.value):
                    kind = self.arrays
                else:
                    continue
                for t in targets:
                    kind.update(_targets(t))
            if (len(self.tensors), len(self.arrays)) == before:
                break
        both = self.tensors & self.arrays
        self.tensors -= both
        self.arrays -= both

    def _origin(self, func) -> str:
        return self.mod.dotted(func) or ""

    def is_tensor(self, e) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.tensors
        if isinstance(e, ast.Call):
            d = self._origin(e.func)
            if d.startswith("torch."):
                return not d.startswith(_TORCH_HOST)
            if d.startswith(_DEVICE_MODULES):
                return True
            if isinstance(e.func, ast.Attribute):
                return e.func.attr not in _HOST_METHODS and \
                    self.is_tensor(e.func.value)
            return False
        if isinstance(e, ast.Attribute):
            return e.attr not in _STATIC_ATTRS and self.is_tensor(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand)
        if isinstance(e, ast.Compare):
            return any(self.is_tensor(x) for x in [e.left, *e.comparators])
        if isinstance(e, ast.BoolOp):
            return any(self.is_tensor(x) for x in e.values)
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body) or self.is_tensor(e.orelse)
        return False

    def is_array(self, e) -> bool:
        """A numpy array (or another host value) by the function's text:
        a numpy call, a name bound to one, a `host*` name or attribute,
        or a subscript, attribute or arithmetic of those."""
        if isinstance(e, ast.Name):
            return e.id in self.arrays or "host" in e.id.lower()
        if isinstance(e, ast.Call):
            d = self._origin(e.func)
            if d.startswith("numpy."):
                return True
            if isinstance(e.func, ast.Attribute):
                return self.is_array(e.func.value)
            return False
        if isinstance(e, ast.Attribute):
            return "host" in e.attr.lower() or self.is_array(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_array(e.value)
        if isinstance(e, ast.BinOp):
            return (self.is_array(e.left) or self.is_array(e.right)) and \
                not (self.is_tensor(e.left) or self.is_tensor(e.right))
        return False


def _is_cpu(mod: SourceModule, e) -> bool:
    """The literal "cpu", or torch.device("cpu")."""
    if isinstance(e, ast.Constant):
        return e.value == "cpu"
    if isinstance(e, ast.Call) and mod.dotted(e.func) == "torch.device":
        return bool(e.args) and _is_cpu(mod, e.args[0])
    return False


def host_sync(scope: TensorScope, call: ast.Call) -> str:
    """-> a description of the host sync `call` makes, else ''."""
    mod = scope.mod
    func = call.func
    if isinstance(func, ast.Attribute):
        if func.attr in _ALWAYS_SYNC and not call.args:
            if func.attr == "numpy" and scope.is_array(func.value):
                return ""
            return f".{func.attr}()"
        if func.attr in _TENSOR_SYNC and not call.args:
            if scope.is_array(func.value):
                return ""
            return f".{func.attr}()"
        if func.attr == "to":
            dev = [a for a in call.args[:1]] + \
                [k.value for k in call.keywords if k.arg == "device"]
            if any(_is_cpu(mod, a) for a in dev):
                return '.to("cpu")'
    d = mod.dotted(func) or ""
    if d in _MATERIALIZE and call.args and scope.is_tensor(call.args[0]):
        return f"{d.split('.')[-1]}(<tensor>)"
    if d in _SYNC_BUILTINS and len(call.args) == 1 and \
            scope.is_tensor(call.args[0]):
        return f"{d}(<tensor>)"
    return ""


def enclosing_function(mod: SourceModule, node: ast.AST):
    """Nearest enclosing function def (one module walk, each call
    attributed exactly once, nested defs included)."""
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def outermost_function(mod: SourceModule, node: ast.AST):
    """The outermost function def enclosing `node`: its names type the
    lambdas and nested defs inside it."""
    out = None
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out = anc
    return out


@register
class SingleSyncSeam(Rule):
    id = "SYNC001"
    severity = "error"
    short = ("per-eval host sync (.item() / .cpu() / .tolist() / .numpy() "
             "/ .to(\"cpu\") / .synchronize() / np.asarray or float() of a "
             "tensor) on the placer/micro-batcher hot path outside the "
             "designated single-sync seam — extra host<->card round trips")
    path_markers = ("/solver/placer.py", "/solver/microbatch.py",
                    "/solver/cuda_kernels.py")

    def check(self, mod: SourceModule) -> list:
        out = []
        scopes: dict = {}
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = enclosing_function(mod, node)
            if fn is None:
                continue            # module scope: not a per-eval path
            top = outermost_function(mod, node)
            scope = scopes.get(id(top))
            if scope is None:
                scope = scopes[id(top)] = TensorScope(mod, top)
            desc = host_sync(scope, node)
            if not desc:
                continue
            out.append(mod.finding(
                self, node,
                f"{desc} inside hot-path `{fn.name}` synchronizes "
                f"host<->card once per eval — route the value through "
                f"the fused program / the designated single-sync seam, "
                f"or mark the seam with "
                f"`# nomadlint: disable=SYNC001 — <why>`"))
        return out
