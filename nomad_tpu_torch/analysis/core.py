"""nomadlint core: the framework behind `python -m nomad_tpu_torch.analysis`.

The PyTorch/CUDA package's own copy of the analyzer. The bug classes that
bite it are the reference package's, in torch's idiom: host syncs on the
solver's per-eval path and inside device programs, kernel libraries
rebuilt or reloaded per call, unlocked mutation of lock-owning classes,
unseeded randomness on scheduler decision paths, silently swallowed
daemon exceptions — all statically detectable from the AST, so tier-1
runs this analyzer over `nomad_tpu_torch/` (tests/test_torch_analysis.py).

Pieces:
  * `Rule` subclasses register themselves via `@register`; each walks a
    `SourceModule` (parsed tree + import map + parent links) and returns
    `Finding`s.
  * Inline suppression: `# nomadlint: disable=RULE1,RULE2` on the flagged
    line (or on a standalone comment line directly above it) silences
    those rules there. A justification after the rule list is the
    expected style: `# nomadlint: disable=EXC001 — best-effort teardown`.
  * Baseline: a checked-in JSON file of accepted pre-existing findings.
    Entries fingerprint (rule, path, stripped source line) so they
    survive line drift; each carries a human `reason`. Anything not in
    the baseline fails the run.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Iterable, Optional

BASELINE_FILENAME = ".nomadlint-baseline.json"

_SUPPRESS_RE = re.compile(
    r"nomadlint:\s*disable=([A-Z]+[0-9]+(?:\s*,\s*[A-Z]+[0-9]+)*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str           # posix-style, as scanned
    line: int
    col: int
    message: str
    severity: str = "error"
    context: str = ""   # stripped source line — the baseline fingerprint

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} [{self.severity}] {self.message}")

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "severity": self.severity,
                "message": self.message, "context": self.context}


def _scan_imports(tree: ast.AST) -> dict:
    """local name -> dotted origin ("jnp" -> "jax.numpy", "jit" ->
    "jax.jit"). Relative imports keep the bare module tail — rules here
    only dispatch on absolute stdlib/jax/numpy names."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    out[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            mod = (node.module or "").lstrip(".")
            for a in node.names:
                if a.name == "*":
                    continue
                origin = f"{mod}.{a.name}" if mod else a.name
                out[a.asname or a.name] = origin
    return out


@dataclasses.dataclass(frozen=True)
class SuppressionComment:
    """One `# nomadlint: ...` comment as written, for hygiene checks
    (LINT000): the raw text, the rule ids it names, whether any prose
    justification surrounds the marker, and whether the marker parsed
    at all (`malformed` = mentions nomadlint+disable but no rule list
    matched)."""
    line: int
    text: str
    rules: tuple = ()
    justified: bool = False
    malformed: bool = False


def _has_prose(s: str) -> bool:
    """True when `s` contains justification text beyond comment
    punctuation (hash marks, dashes, separators)."""
    return bool(re.sub(r"[#\s—–\-:,.;]+", "", s))


def _suppression_comment(line: int, text: str):
    """-> SuppressionComment for a comment mentioning nomadlint, else
    None. A justification may sit before the marker or after the rule
    list (`# why — nomadlint: disable=X` / `# nomadlint: disable=X — why`)."""
    if "nomadlint" not in text:
        return None
    m = _SUPPRESS_RE.search(text)
    if not m:
        if "disable" in text:
            return SuppressionComment(line, text, malformed=True)
        return None
    rules = tuple(sorted({r.strip() for r in m.group(1).split(",")}))
    justified = _has_prose(text[:m.start()]) or _has_prose(text[m.end():])
    return SuppressionComment(line, text, rules=rules, justified=justified)


def _scan_suppressions(text: str) -> tuple:
    """-> (line number -> set of rule ids disabled there,
           [SuppressionComment records for LINT000]).
    A comment with code before it on the line applies to that line; a
    standalone comment line applies to itself AND the next line (for
    statements too long to carry the marker inline)."""
    out: dict[int, set] = {}
    records: list = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        tokens = []
    if tokens:
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            rec = _suppression_comment(tok.start[0], tok.string)
            if rec is None:
                continue
            records.append(rec)
            if not rec.rules:
                continue
            line = tok.start[0]
            out.setdefault(line, set()).update(rec.rules)
            if tok.line.strip().startswith("#"):        # standalone comment
                out.setdefault(line + 1, set()).update(rec.rules)
        return out, records
    # tokenizer refused the file (it still parsed somehow): raw-line scan
    for i, raw in enumerate(text.splitlines(), 1):
        if "#" not in raw:
            continue
        rec = _suppression_comment(i, raw[raw.index("#"):])
        if rec is None:
            continue
        records.append(rec)
        if not rec.rules:
            continue
        out.setdefault(i, set()).update(rec.rules)
        if raw.strip().startswith("#"):
            out.setdefault(i + 1, set()).update(rec.rules)
    return out, records


class SourceModule:
    """One parsed file: tree with parent links, import map, suppression
    map, and the source lines (for finding context fingerprints).
    `match_path` is the scan-root-anchored path used for rule scoping —
    see analyze_paths; it defaults to `path`."""

    def __init__(self, path: str, text: str, match_path: str = ""):
        self.path = path.replace(os.sep, "/")
        self.match_path = (match_path or path).replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text)
        self.imports = _scan_imports(self.tree)
        self._suppressed, self.suppression_comments = _scan_suppressions(text)
        self._parent: dict[int, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parent[id(child)] = parent

    # ------------------------------------------------------------ traversal

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parent.get(id(node))

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Import-resolved dotted name of a Name/Attribute chain:
        `jnp.asarray` -> "jax.numpy.asarray". Unknown roots keep their
        raw name (so `self.rng.shuffle` -> "self.rng.shuffle")."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(self.imports.get(node.id, node.id))
            return ".".join(reversed(parts))
        return None

    @property
    def modname(self) -> str:
        """Approximate dotted module name derived from match_path
        ("nomad_tpu_torch/server/raft.py" -> "nomad_tpu_torch.server.raft")
        — the namespace the ProjectIndex files this module's defs under."""
        mp = self.match_path
        if mp.endswith(".py"):
            mp = mp[:-3]
        if mp.endswith("/__init__"):
            mp = mp[:-len("/__init__")]
        return mp.strip("/").replace("/", ".")

    # ------------------------------------------------------------- findings

    def source_line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, rule_id: str, lineno: int) -> bool:
        return rule_id in self._suppressed.get(lineno, ())

    def finding(self, rule: "Rule", node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 0)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=rule.id, path=self.path, line=line, col=col,
                       message=message, severity=rule.severity,
                       context=self.source_line(line))


# ------------------------------------------------------------------- rules

class Rule:
    id: str = ""
    severity: str = "error"
    short: str = ""             # one-line description (--list-rules, docs)
    # substring markers a module path must contain for the rule to apply
    # (empty = every file). Fixture tests place files under a matching
    # directory (e.g. tmp/scheduler/bad.py for DET001).
    path_markers: tuple = ()

    def applies_to(self, mod: SourceModule) -> bool:
        if not self.path_markers:
            return True
        # markers match the scan-root-anchored path (scan dir's basename
        # + relative subpath, or parent-dir + name for a direct file
        # arg): ancestors ABOVE the scanned tree never participate, so a
        # checkout under e.g. /home/ci/solver/ can't trip "/solver/",
        # while `cd nomad_tpu_torch/solver && nomadlint placer.py` still does
        p = "/" + mod.match_path.lstrip("/")
        return any(m in p for m in self.path_markers)

    def check(self, mod: SourceModule) -> list:
        raise NotImplementedError


class ProjectRule(Rule):
    """A whole-program rule: runs once per analysis over the memoized
    ProjectIndex (pass 2) instead of once per file. Findings may land on
    any scanned module (inline suppressions still apply, looked up
    through the index) or on a docs file (baseline-only suppression).
    `path_markers`/`applies_to` are not consulted — scope inside
    `check_project` against `mod.match_path` so cross-module findings
    stay possible."""

    def check(self, mod: SourceModule) -> list:   # pragma: no cover
        return []                                 # driver never calls this

    def check_project(self, index) -> list:
        raise NotImplementedError


_REGISTRY: dict[str, Rule] = {}


def register(cls):
    _REGISTRY[cls.id] = cls()
    return cls


def all_rules() -> list:
    return [r for _, r in sorted(_REGISTRY.items())]


# ---------------------------------------------------------------- baseline

def _path_match(entry_path: str, finding_path: str) -> bool:
    """Forgiving comparison: the baseline stores repo-relative posix paths
    but the analyzer may be invoked with absolute or differently-rooted
    paths — match on equality or component-boundary suffix."""
    a = entry_path.replace(os.sep, "/").lstrip("./")
    b = finding_path.replace(os.sep, "/").lstrip("./")
    return a == b or a.endswith("/" + b) or b.endswith("/" + a)


class Baseline:
    """Accepted pre-existing findings. Each entry:
    {"rule": ..., "path": ..., "context": <stripped source line>,
     "reason": <why this finding is accepted>}."""

    def __init__(self, entries: Optional[list] = None, path: str = ""):
        self.entries = entries or []
        self.path = path

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        entries = data["findings"] if isinstance(data, dict) else data
        return cls(entries, path=path)

    @classmethod
    def discover(cls, start: str) -> "Baseline":
        """Walk up from `start` looking for the checked-in baseline file;
        empty baseline when none exists."""
        cur = os.path.abspath(start)
        if os.path.isfile(cur):
            cur = os.path.dirname(cur)
        while True:
            cand = os.path.join(cur, BASELINE_FILENAME)
            if os.path.isfile(cand):
                return cls.load(cand)
            parent = os.path.dirname(cur)
            if parent == cur:
                return cls()
            cur = parent

    def matches(self, f: Finding) -> bool:
        return any(e.get("rule") == f.rule
                   and _path_match(e.get("path", ""), f.path)
                   and e.get("context", "") == f.context
                   for e in self.entries)


# ------------------------------------------------------------------ driver

def _run_file_rules(mod: SourceModule, rules: Optional[list]) -> list:
    out = []
    for rule in (rules if rules is not None else all_rules()):
        if isinstance(rule, ProjectRule) or not rule.applies_to(mod):
            continue
        for f in rule.check(mod):
            if not mod.suppressed(f.rule, f.line):
                out.append(f)
    return out


def _run_project_rules(mods: list, scan_paths: Iterable[str],
                       rules: Optional[list]) -> list:
    """Pass 2: build the ProjectIndex ONCE over every parsed module and
    run each ProjectRule against it. Inline suppressions on scanned
    modules still win; findings on non-module paths (docs tables) can
    only be baselined."""
    project_rules = [r for r in (rules if rules is not None else all_rules())
                     if isinstance(r, ProjectRule)]
    if not project_rules or not mods:
        return []
    from .project import ProjectIndex             # deferred: import cycle
    index = ProjectIndex(mods, scan_paths)
    out = []
    for rule in project_rules:
        for f in rule.check_project(index):
            mod = index.module_by_path.get(f.path)
            if mod is None or not mod.suppressed(f.rule, f.line):
                out.append(f)
    return out


def analyze_source(text: str, path: str = "<string>",
                   rules: Optional[list] = None,
                   match_path: str = "") -> list:
    """Findings for one source text, inline suppressions already applied
    (the baseline is the caller's concern). Project rules run over a
    single-module index with NO docs discovery — LOCK002/LOCK003
    fixtures work standalone, registry-drift rules need a real tree."""
    mod = SourceModule(path, text, match_path=match_path)
    out = _run_file_rules(mod, rules)
    out.extend(_run_project_rules([mod], (), rules))
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def iter_py_files(paths: Iterable[str]) -> Iterable[tuple]:
    """Yield (file_path, match_path): match_path anchors rule scoping at
    the scanned tree — the scan dir's basename plus the relative subpath
    (or parent-dir basename + name for a direct file argument) — so
    directory names ABOVE the invocation never affect path_markers."""
    for p in paths:
        if os.path.isfile(p):
            ap = os.path.abspath(p)
            yield p, os.path.join(os.path.basename(os.path.dirname(ap)),
                                  os.path.basename(ap))
        else:
            anchor = os.path.basename(os.path.abspath(p))
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith((".", "__pycache__")))
                for name in sorted(files):
                    if name.endswith(".py"):
                        full = os.path.join(root, name)
                        yield full, os.path.join(
                            anchor, os.path.relpath(full, p))


def analyze_paths(paths: Iterable[str],
                  rules: Optional[list] = None,
                  project: bool = True) -> tuple:
    """-> (findings, errors): errors are (path, message) pairs for files
    that failed to parse — reported, never silently skipped. Two passes:
    per-file rules as each module parses, then (unless `project=False`,
    the `--changed` fast path) the ProjectRule family over one shared
    ProjectIndex of every module that parsed."""
    findings: list = []
    errors: list = []
    mods: list = []
    paths = list(paths)
    for p in paths:
        # a mistyped/cwd-relative path must not greenlight by scanning
        # nothing (the CLI default "nomad_tpu_torch" exists only at repo root)
        if not os.path.exists(p):
            errors.append((p, "path does not exist — nothing scanned"))
    for path, match_path in iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as fh:
                text = fh.read()
            mod = SourceModule(path, text, match_path=match_path)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append((path, f"{type(e).__name__}: {e}"))
            continue
        mods.append(mod)
        findings.extend(_run_file_rules(mod, rules))
    if project:
        findings.extend(_run_project_rules(mods, paths, rules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, errors
