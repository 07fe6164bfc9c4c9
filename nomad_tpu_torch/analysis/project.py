"""ProjectIndex: the whole-program substrate behind the ProjectRule pass.

Pass 1 of the analyzer builds ONE of these over every module that
parsed; pass 2 hands it to each ProjectRule. It holds:

  * a qualified def/class table (`mod.func`, `mod.Class.method`) plus an
    approximate call graph: `self.method()` resolves inside the class,
    bare names inside the module, dotted chains through each module's
    import map, and — last resort — a method name that is unique across
    the whole index (minus builtin-container vocabulary) resolves to its
    only definition;
  * per-function lock summaries: every `with <lock>:` acquisition with
    the locks already held at that point (lexical regions; nested
    def/lambda bodies are excluded because they don't run under the
    region), `*_locked` naming treated as entering with the class lock
    held, `threading.Condition(self._lock)` unified with the lock it
    wraps;
  * extracted string registries: `faults.fire/mangle` site names
    (f-string holes and one level of local-variable indirection become
    `*` wildcards), metric names, `SchedulerConfiguration` fields,
    registered lint rule ids;
  * the docs tables the registry-drift rules reconcile against
    (docs/FAULT_INJECTION.md site catalog, the analysis/RULES.md rule
    table, tests/test_torch_analysis.py text), found by walking up from
    the scan roots. No docs found => drift rules stay quiet, so fixture
    trees without a docs/ dir never produce phantom findings.

Everything is approximate by design: resolution failures drop edges
(under-report) rather than guess; the one place we over-approximate —
unique-method-name fallback — is filtered against builtin container
method names so `self.queue.append(...)` never resolves to a WAL.
"""
from __future__ import annotations

import ast
import fnmatch
import os
import re
from typing import Iterable, Optional

from .core import SourceModule

_LOCK_CTORS = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "threading.Condition": "Condition",
}

# attribute names that *look* like locks — identity fallback when the
# constructor isn't visible (injected/imported locks)
_LOCKISH = re.compile(r"(^|_)(lock|rlock|cond|cv|mutex|mu)\d*$")

# names never resolved by the unique-method fallback: builtin container
# vocabulary would otherwise let `self.pending.append(x)` resolve to
# whatever class happens to define the only `append` in the tree
_COMMON_METHODS = (set(dir(list)) | set(dir(dict)) | set(dir(set))
                   | set(dir(str)) | set(dir(tuple)) | set(dir(bytes))
                   | {"acquire", "release", "wait", "notify", "notify_all",
                      "put", "read", "write", "close", "open", "send",
                      "start", "run", "cancel", "result", "submit", "done",
                      "shutdown", "flush", "next", "reset", "stop",
                      # threading.Thread/Event vocabulary: `t.is_alive()`
                      # must never resolve to some class's own is_alive
                      "is_alive", "join", "is_set", "set", "locked",
                      # protocol-ish names too generic for the unique-def
                      # fallback (raft.apply vs an FSM's own apply)
                      "apply"})

_FAULT_FNS = {"fire", "mangle"}
_METRIC_FNS = {"incr", "set_gauge", "add_sample", "observe", "measure",
               "counter"}

_RULE_ID_RE = re.compile(r"^[A-Z]+[0-9]+$")
_DOC_HOLE_RE = re.compile(r"<[^<>|`]*>")


def _self_name(fn) -> str:
    args = fn.args.posonlyargs + fn.args.args
    return args[0].arg if args else ""


def _str_pattern(value: ast.AST, fn_node=None) -> Optional[str]:
    """Literal string -> itself; f-string -> holes become `*`; a bare
    Name -> one level of local-assignment resolution inside `fn_node`."""
    if isinstance(value, ast.Constant) and isinstance(value.value, str):
        return value.value
    if isinstance(value, ast.JoinedStr):
        parts = []
        for v in value.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("*")
        return "".join(parts)
    if isinstance(value, ast.Name) and fn_node is not None:
        for n in ast.walk(fn_node):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name) and \
                    n.targets[0].id == value.id:
                got = _str_pattern(n.value)      # no second indirection
                if got is not None:
                    return got
    return None


def site_match(a: str, b: str) -> bool:
    """Segment-wise match of two dotted site patterns where `*` on
    either side wildcards that segment ("disk.*" ~ "disk.append")."""
    sa, sb = a.split("."), b.split(".")
    if len(sa) != len(sb):
        return False
    return all(fnmatch.fnmatchcase(x, y) or fnmatch.fnmatchcase(y, x)
               for x, y in zip(sa, sb))


class FunctionInfo:
    """One indexed def: where it lives, what it calls (with the lock
    keys held at each call site), and what it acquires."""

    __slots__ = ("qualname", "modname", "cls", "name", "node", "mod",
                 "selfname", "calls", "acquisitions", "entry_holds")

    def __init__(self, qualname, modname, cls, name, node, mod):
        self.qualname = qualname
        self.modname = modname
        self.cls = cls                      # enclosing class name or ""
        self.name = name
        self.node = node
        self.mod = mod
        self.selfname = _self_name(node) if cls else ""
        self.calls = []         # (Call node, held lock keys tuple, dotted)
        self.acquisitions = []  # (lock key, node, held lock keys tuple)
        self.entry_holds = ()   # lock keys held on entry (*_locked)


# the port's rule table and fixture file, relative to the root that
# holds docs/FAULT_INJECTION.md
RULES_DOC = ("nomad_tpu_torch", "analysis", "RULES.md")
FIXTURES = ("tests", "test_torch_analysis.py")


class DocsInfo:
    """The registries' paper half: parsed docs tables + test text."""

    def __init__(self):
        self.root = ""
        self.fault_doc_path = ""          # as reported in findings
        self.fault_rows = []              # (pattern, lineno, raw line)
        self.rules_doc_path = ""
        self.rule_rows = []               # (rule id, lineno, raw line)
        self.test_lint_path = ""
        self.test_lint_text = None        # None = not found

    @classmethod
    def discover(cls, scan_paths: Iterable[str]) -> "DocsInfo":
        """The first ancestor of a scan root holding the fault catalog
        (docs/FAULT_INJECTION.md, which the port's sites share with the
        reference) or the port's rule table (RULES_DOC): both tables and
        the fixture file (FIXTURES) are read under it."""
        info = cls()
        for p in scan_paths:
            cur = os.path.abspath(p)
            if os.path.isfile(cur):
                cur = os.path.dirname(cur)
            for _ in range(12):
                fault = os.path.join(cur, "docs", "FAULT_INJECTION.md")
                rules = os.path.join(cur, *RULES_DOC)
                if os.path.isfile(fault) or os.path.isfile(rules):
                    info.root = cur
                    if os.path.isfile(fault):
                        info._parse_fault(fault)
                    if os.path.isfile(rules):
                        info._parse_rules(rules)
                    tl = os.path.join(cur, *FIXTURES)
                    if os.path.isfile(tl):
                        info.test_lint_path = os.path.relpath(tl)
                        with open(tl, encoding="utf-8") as fh:
                            info.test_lint_text = fh.read()
                    return info
                parent = os.path.dirname(cur)
                if parent == cur:
                    break
                cur = parent
        return info

    def _parse_fault(self, path: str) -> None:
        """Site catalog rows: first backticked cell of each table row in
        the `## Site catalog` section; `<hole>` placeholders -> `*`."""
        self.fault_doc_path = os.path.relpath(path)
        in_section = False
        with open(path, encoding="utf-8") as fh:
            for i, raw in enumerate(fh, 1):
                if raw.startswith("## "):
                    in_section = raw.lower().startswith("## site catalog")
                    continue
                if not in_section:
                    continue
                m = re.match(r"\|\s*`([^`]+)`\s*\|", raw)
                if m and "." in m.group(1):
                    pattern = _DOC_HOLE_RE.sub("*", m.group(1))
                    self.fault_rows.append((pattern, i, raw.strip()))

    def _parse_rules(self, path: str) -> None:
        self.rules_doc_path = os.path.relpath(path)
        with open(path, encoding="utf-8") as fh:
            for i, raw in enumerate(fh, 1):
                m = re.match(r"\|\s*\*\*([A-Z]+[0-9]+)\*\*", raw)
                if m:
                    self.rule_rows.append((m.group(1), i, raw.strip()))


class ProjectIndex:
    """Whole-program view over every scanned module. Built once per
    analysis run (pass 1) and shared by every ProjectRule (pass 2)."""

    def __init__(self, modules: list, scan_paths: Iterable[str] = ()):
        self.modules = list(modules)
        self.module_by_path = {m.path: m for m in self.modules}
        self.functions: dict[str, FunctionInfo] = {}
        self._module_funcs: dict[tuple, str] = {}    # (mod, name) -> qual
        self._class_methods: dict[tuple, str] = {}   # (mod, cls, n) -> qual
        self._by_name: dict[str, list] = {}          # bare name -> [quals]
        self._class_locks: dict[tuple, dict] = {}    # (mod, cls) -> a->key
        self._module_locks: dict[str, dict] = {}     # mod -> name -> key
        self.lock_kinds: dict[str, str] = {}         # key -> Lock/RLock/...
        self.fault_sites = []    # (pattern, SourceModule, node)
        self.metric_names = []   # (pattern, SourceModule, node)
        self.rule_defs = []      # (rule id, SourceModule, ClassDef)
        self.config_classes = [] # (SourceModule, ClassDef)
        self._resolve_cache: dict = {}
        self._acq_cache: dict = {}
        self._blocking_cache: dict = {}
        for mod in self.modules:
            self._index_defs(mod)
        for mod in self.modules:
            self._index_locks(mod)
        for mod in self.modules:
            for fi in self._functions_of(mod):
                self._scan_function(fi)
            self._index_registries(mod)
        self.docs = DocsInfo.discover(scan_paths)

    # ------------------------------------------------------------- def table

    def _index_defs(self, mod: SourceModule) -> None:
        modname = mod.modname
        for stmt in mod.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_def(modname, "", stmt, mod)
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self._add_def(modname, stmt.name, sub, mod)

    def _add_def(self, modname, cls, node, mod) -> None:
        qual = ".".join(x for x in (modname, cls, node.name) if x)
        fi = FunctionInfo(qual, modname, cls, node.name, node, mod)
        self.functions[qual] = fi
        self._by_name.setdefault(node.name, []).append(qual)
        if cls:
            self._class_methods[(modname, cls, node.name)] = qual
        else:
            self._module_funcs[(modname, node.name)] = qual

    def _functions_of(self, mod: SourceModule):
        return [fi for fi in self.functions.values() if fi.mod is mod]

    # ------------------------------------------------------------ lock table

    def _index_locks(self, mod: SourceModule) -> None:
        modname = mod.modname
        # module-level: `_launch_lock = threading.RLock()`
        mlocks: dict[str, str] = {}
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name) and \
                    isinstance(stmt.value, ast.Call):
                kind = _LOCK_CTORS.get(mod.dotted(stmt.value.func) or "")
                if kind:
                    name = stmt.targets[0].id
                    key = f"{modname}.{name}"
                    mlocks[name] = key
                    self.lock_kinds[key] = ("RLock" if kind == "Condition"
                                            and not stmt.value.args
                                            else kind)
        self._module_locks[modname] = mlocks
        # per-class: `self._lock = threading.RLock()`, with
        # `self._cond = threading.Condition(self._lock)` unified to _lock
        for cls in mod.tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            attrs: dict[str, str] = {}
            aliases: list = []          # (cond attr, wrapped attr)
            for node in ast.walk(cls):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Attribute)
                        and isinstance(node.targets[0].value, ast.Name)
                        and isinstance(node.value, ast.Call)):
                    continue
                attr = node.targets[0].attr
                kind = _LOCK_CTORS.get(mod.dotted(node.value.func) or "")
                if not kind:
                    continue
                key = f"{modname}.{cls.name}.{attr}"
                if kind == "Condition" and node.value.args:
                    arg = node.value.args[0]
                    if isinstance(arg, ast.Attribute) and \
                            isinstance(arg.value, ast.Name):
                        aliases.append((attr, arg.attr))
                        continue
                attrs[attr] = key
                self.lock_kinds[key] = ("RLock" if kind == "Condition"
                                        else kind)
            for cond_attr, wrapped in aliases:
                if wrapped in attrs:
                    attrs[cond_attr] = attrs[wrapped]   # same underlying lock
                else:
                    key = f"{modname}.{cls.name}.{cond_attr}"
                    attrs[cond_attr] = key
                    self.lock_kinds[key] = "Condition"
            if attrs:
                self._class_locks[(modname, cls.name)] = attrs

    def _lock_key(self, fi: FunctionInfo, expr: ast.AST) -> Optional[str]:
        """Lock identity of a with-item context expr, or None when the
        expression can't be a lock we know about."""
        mod = fi.mod
        # with self._lock:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                fi.cls and expr.value.id == fi.selfname:
            attrs = self._class_locks.get((fi.modname, fi.cls), {})
            if expr.attr in attrs:
                return attrs[expr.attr]
            if _LOCKISH.search(expr.attr):
                key = f"{fi.modname}.{fi.cls}.{expr.attr}"
                self.lock_kinds.setdefault(key, "unknown")
                return key
            return None
        # with _module_lock: (possibly imported from another module)
        if isinstance(expr, ast.Name):
            mlocks = self._module_locks.get(fi.modname, {})
            if expr.id in mlocks:
                return mlocks[expr.id]
            origin = mod.imports.get(expr.id)
            if origin:
                key = self._match_module_lock(origin)
                if key:
                    return key
                if _LOCKISH.search(origin.rsplit(".", 1)[-1]):
                    self.lock_kinds.setdefault(origin, "unknown")
                    return origin
            return None
        # with sharding._launch_lock: (dotted module attribute)
        dotted = mod.dotted(expr)
        if dotted:
            key = self._match_module_lock(dotted)
            if key:
                return key
            if _LOCKISH.search(dotted.rsplit(".", 1)[-1]) and \
                    not dotted.startswith(fi.selfname + "."):
                self.lock_kinds.setdefault(dotted, "unknown")
                return dotted
        return None

    def _match_module_lock(self, dotted: str) -> Optional[str]:
        """Resolve a dotted lock reference against module-level lock
        tables by module-name suffix ("sharding._launch_lock" ->
        "nomad_tpu_torch.solver.sharding._launch_lock")."""
        if "." not in dotted:
            return None
        prefix, name = dotted.rsplit(".", 1)
        hits = [locks[name] for modname, locks in self._module_locks.items()
                if name in locks and (modname == prefix
                                      or modname.endswith("." + prefix)
                                      or prefix.endswith("." + modname))]
        return hits[0] if len(hits) == 1 else None

    # ------------------------------------------------- function-body scan

    def _scan_function(self, fi: FunctionInfo) -> None:
        if fi.cls and fi.name.endswith("_locked"):
            attrs = self._class_locks.get((fi.modname, fi.cls), {})
            keys = sorted(set(attrs.values()))
            if len(keys) == 1:
                fi.entry_holds = (keys[0],)
            elif "_lock" in attrs:      # convention: _lock is the primary
                fi.entry_holds = (attrs["_lock"],)

        def visit(node, held):
            # nested scopes don't execute under the enclosing lexical
            # region (a closure defined under a lock runs later)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                cur = list(held)
                for item in node.items:
                    visit(item.context_expr, tuple(cur))
                    key = self._lock_key(fi, item.context_expr)
                    if key:
                        fi.acquisitions.append(
                            (key, item.context_expr, tuple(cur)))
                        cur.append(key)
                for stmt in node.body:
                    visit(stmt, tuple(cur))
                return
            if isinstance(node, ast.Call):
                fi.calls.append((node, tuple(held),
                                 fi.mod.dotted(node.func)))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fi.node.body:
            visit(stmt, fi.entry_holds)

    # ------------------------------------------------------------ call graph

    def resolve_call(self, fi: FunctionInfo,
                     dotted: Optional[str]) -> Optional[str]:
        """-> qualname of the called def, or None when unresolvable."""
        if not dotted:
            return None
        cache_key = (fi.qualname, dotted)
        if cache_key in self._resolve_cache:
            return self._resolve_cache[cache_key]
        got = self._resolve_uncached(fi, dotted)
        self._resolve_cache[cache_key] = got
        return got

    def _resolve_uncached(self, fi, dotted) -> Optional[str]:
        parts = dotted.split(".")
        if fi.cls and fi.selfname and parts[0] == fi.selfname:
            if len(parts) == 2:
                q = self._class_methods.get((fi.modname, fi.cls, parts[1]))
                if q:
                    return q
            return self._unique(parts[-1])
        if len(parts) == 1:
            return self._module_funcs.get((fi.modname, parts[0]))
        # dotted chain through the import map: suffix-match the module
        prefix, tail = ".".join(parts[:-1]), parts[-1]
        hits = [q for (mn, n), q in self._module_funcs.items()
                if n == tail and (mn == prefix or mn.endswith("." + prefix)
                                  or prefix.endswith("." + mn))]
        if len(hits) == 1:
            return hits[0]
        if not hits:
            # Class.method via the import map ("EvalBroker.enqueue")
            if len(parts) >= 2:
                cands = [q for (mn, c, n), q in self._class_methods.items()
                         if n == tail and c == parts[-2]]
                if len(cands) == 1:
                    return cands[0]
            return self._unique(tail)
        return None

    def _unique(self, name: str) -> Optional[str]:
        if name in _COMMON_METHODS or name.startswith("__"):
            return None
        quals = self._by_name.get(name, ())
        return quals[0] if len(quals) == 1 else None

    def transitive_acquisitions(self, qualname: str, depth: int = 2) -> dict:
        """lock key -> qualname of the def that acquires it, following
        resolved calls `depth` levels down."""
        cache_key = (qualname, depth)
        if cache_key in self._acq_cache:
            return self._acq_cache[cache_key]
        fi = self.functions.get(qualname)
        out: dict[str, str] = {}
        if fi is not None:
            self._acq_cache[cache_key] = out    # cycle guard
            for key, _, _ in fi.acquisitions:
                out.setdefault(key, qualname)
            if depth > 0:
                for _, _, dotted in fi.calls:
                    callee = self.resolve_call(fi, dotted)
                    if callee and callee != qualname:
                        sub = self.transitive_acquisitions(callee, depth - 1)
                        for key, via in sub.items():
                            out.setdefault(key, via)
        self._acq_cache[cache_key] = out
        return out

    def lock_edges(self, depth: int = 2) -> dict:
        """-> {(held key, acquired key): (FunctionInfo, node, via)} —
        the held-lock -> acquired-lock order relation across the call
        graph, first witness per edge. Self-edges are kept (re-entrancy
        candidates; LOCK002 filters by lock kind)."""
        edges: dict = {}
        for qual in sorted(self.functions):
            fi = self.functions[qual]
            for key, node, held in fi.acquisitions:
                for h in held:
                    edges.setdefault((h, key), (fi, node, ""))
            for node, held, dotted in fi.calls:
                if not held:
                    continue
                callee = self.resolve_call(fi, dotted)
                if not callee:
                    continue
                for key, via in self.transitive_acquisitions(
                        callee, depth - 1).items():
                    for h in held:
                        edges.setdefault((h, key),
                                         (fi, node, f"via {via}()"))
        return edges

    def blocking_chain(self, qualname: str, depth: int = 1,
                       is_blocking=None) -> Optional[str]:
        """Description of a blocking call reachable from `qualname`
        within `depth` further resolved hops, else None."""
        cache_key = (qualname, depth)
        if cache_key in self._blocking_cache:
            return self._blocking_cache[cache_key]
        fi = self.functions.get(qualname)
        got = None
        if fi is not None:
            self._blocking_cache[cache_key] = None   # cycle guard
            for _, _, dotted in fi.calls:
                desc = is_blocking(dotted) if is_blocking else None
                if desc:
                    got = desc
                    break
            if got is None and depth > 0:
                for _, _, dotted in fi.calls:
                    callee = self.resolve_call(fi, dotted)
                    if callee and callee != qualname:
                        sub = self.blocking_chain(callee, depth - 1,
                                                  is_blocking)
                        if sub:
                            got = f"{self.functions[callee].name}() -> {sub}"
                            break
        self._blocking_cache[cache_key] = got
        return got

    # ----------------------------------------------------------- registries

    def _index_registries(self, mod: SourceModule) -> None:
        # faults.fire/mangle sites and metrics.* names, resolved inside
        # their enclosing function (for the local-variable site form)
        for fi in self._functions_of(mod):
            for node, _, dotted in fi.calls:
                if not dotted or not node.args:
                    continue
                parts = dotted.split(".")
                if len(parts) >= 2 and parts[-1] in _FAULT_FNS and \
                        parts[-2] == "faults":
                    pat = _str_pattern(node.args[0], fi.node)
                    if pat:
                        self.fault_sites.append((pat, mod, node))
                elif len(parts) >= 2 and parts[-1] in _METRIC_FNS and \
                        "metrics" in parts[-2]:
                    pat = _str_pattern(node.args[0], fi.node)
                    if pat:
                        self.metric_names.append((pat, mod, node))
        # registered rule classes and the config dataclass
        for cls in mod.tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            if cls.name == "SchedulerConfiguration":
                self.config_classes.append((mod, cls))
            decorated = any(
                (isinstance(d, ast.Name) and d.id == "register")
                or (isinstance(d, ast.Attribute) and d.attr == "register")
                for d in cls.decorator_list)
            if not decorated:
                continue
            for stmt in cls.body:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and stmt.targets[0].id == "id" \
                        and isinstance(stmt.value, ast.Constant) \
                        and isinstance(stmt.value.value, str) \
                        and _RULE_ID_RE.match(stmt.value.value):
                    self.rule_defs.append((stmt.value.value, mod, cls))

    # ---------------------------------------------------------------- debug

    def graph_summary(self) -> dict:
        """The `--graph` dump: enough to debug resolution by eye."""
        call_edges = []
        for qual in sorted(self.functions):
            fi = self.functions[qual]
            for _, _, dotted in fi.calls:
                callee = self.resolve_call(fi, dotted)
                if callee:
                    call_edges.append([qual, callee])
        return {
            "modules": sorted(m.modname for m in self.modules),
            "functions": len(self.functions),
            "call_edges": sorted(map(tuple, set(map(tuple, call_edges)))),
            "locks": {k: self.lock_kinds[k]
                      for k in sorted(self.lock_kinds)},
            "lock_edges": sorted(list(e) for e in self.lock_edges()),
            "fault_sites": sorted({p for p, _, _ in self.fault_sites}),
            "metric_names": sorted({p for p, _, _ in self.metric_names}),
            "rule_ids": sorted({r for r, _, _ in self.rule_defs}),
            "config_fields": sorted(
                f for _, cls in self.config_classes
                for f in config_fields(cls)),
            "docs_root": self.docs.root,
        }


def config_fields(cls: ast.ClassDef) -> list:
    """Annotated field names of a config dataclass, in source order."""
    return [stmt.target.id for stmt in cls.body
            if isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)]


def annotation_name(stmt: ast.AnnAssign) -> str:
    ann = stmt.annotation
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value
    return ""
