"""DUR001/DUR002 — durable-storage discipline rules.

DUR001 — raw persistence writes outside the durable-storage helpers.

ISSUE 13 moved every byte the control plane persists behind
`server/durable.py`: CRC-framed WAL appends, crc-enveloped blobs, an
atomically-replaced MANIFEST as the commit point, and the hot-reloadable
fsync discipline (docs/DURABILITY.md). A raw `open(..., "wb")` +
`os.replace` flush that never fsyncs survives SIGKILL but not power
loss (the rename is journaled before the data), and a raw append-mode
log has no frame headers — a torn tail or a stale generation is
silently re-read as truth, the exact crash window the WAL closed.

Flagged inside `server/`, `state/`, and `client/`:
  * `open(..., "ab")` / `os.fdopen(..., "ab")` — an append-mode
    persistence stream with no CRC/index framing; route it through the
    durable module's WAL helpers (or justify why the data is
    loss-tolerant, e.g. task stdout streams);
  * `open(..., "wb")` in a function that also calls
    `os.replace`/`os.rename` but never `os.fsync` — the
    atomic-replace-without-durability shape (`client/state_db.py`'s
    fsync-then-replace flush is the compliant pattern).

`server/durable.py` itself is exempt: it IS the helper module whose
write paths carry the crc/fsync discipline (and the fault sites).

DUR002 — per-entry durable writes inside loops (ISSUE 20).

`DurableRaftDir.append()` takes a LIST of entries and amortizes the
frame writes and the fsync over the whole call — the group-commit
window raft.py stages exists to exploit exactly that. A durable append
or an explicit fsync issued per loop iteration re-serializes the disk:
N iterations pay N fsyncs where one batched call pays one, the shape
whose cost BENCH_r12's fsync ladder measured at 2-4x throughput.
Collect the entries and land them as one `append(start, entries)`
call (or justify the loop with an inline disable — e.g. a recovery
path intentionally re-proving each generation).
"""
from __future__ import annotations

import ast

from .core import Rule, SourceModule, register


@register
class RawPersistenceWrite(Rule):
    id = "DUR001"
    severity = "error"
    short = ("raw persistence write (append-mode log, or atomic-replace "
             "without fsync) outside the durable-storage helpers")
    path_markers = ("/server/", "/state/", "/client/")
    EXEMPT = ("server/durable.py",)

    _OPENERS = ("open", "os.fdopen")
    _REPLACERS = ("os.replace", "os.rename")

    def applies_to(self, mod: SourceModule) -> bool:
        if any(mod.match_path.endswith(e) for e in self.EXEMPT):
            return False
        return super().applies_to(mod)

    # ------------------------------------------------------------ helpers

    @staticmethod
    def _open_mode(node: ast.Call) -> str:
        """The string mode of an open()-ish call, "" when not literal."""
        mode = None
        if len(node.args) >= 2:
            mode = node.args[1]
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
            return mode.value
        return ""

    def _scope_of(self, mod: SourceModule, node: ast.AST) -> ast.AST:
        for anc in mod.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return mod.tree

    def _scope_calls(self, mod: SourceModule, scope: ast.AST) -> tuple:
        """(has_replace, has_fsync) among calls DIRECTLY in `scope`
        (nested defs are their own persistence contexts)."""
        has_replace = has_fsync = False
        for node in ast.walk(scope):
            if not isinstance(node, ast.Call):
                continue
            if self._scope_of(mod, node) is not scope:
                continue
            d = mod.dotted(node.func)
            if d in self._REPLACERS:
                has_replace = True
            elif d == "os.fsync":
                has_fsync = True
        return has_replace, has_fsync

    # -------------------------------------------------------------- check

    def check(self, mod: SourceModule) -> list:
        out = []
        scope_info: dict[int, tuple] = {}
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if mod.dotted(node.func) not in self._OPENERS:
                continue
            mode = self._open_mode(node)
            if "a" in mode and "b" in mode:
                out.append(mod.finding(
                    self, node,
                    "append-mode binary write is a raw WAL with no "
                    "frame CRC/index — route control-plane state "
                    "through server/durable.py (loss-tolerant streams "
                    "carry an inline disable saying so)"))
                continue
            if "w" not in mode or "b" not in mode:
                continue
            scope = self._scope_of(mod, node)
            key = id(scope)
            if key not in scope_info:
                scope_info[key] = self._scope_calls(mod, scope)
            has_replace, has_fsync = scope_info[key]
            if has_replace and not has_fsync:
                out.append(mod.finding(
                    self, node,
                    "atomic-replace flush without os.fsync — the "
                    "rename survives a crash but the data may not; "
                    "fsync before os.replace (see "
                    "client/state_db.py._flush_snapshot) or use "
                    "server/durable.py"))
        return out


@register
class PerEntryDurableWriteInLoop(Rule):
    id = "DUR002"
    severity = "error"
    short = ("per-entry durable append/fsync inside a loop — batch the "
             "entries into one amortized durable call (ISSUE 20)")
    path_markers = ("/server/", "/state/", "/client/")
    EXEMPT = ("server/durable.py",)

    def applies_to(self, mod: SourceModule) -> bool:
        if any(mod.match_path.endswith(e) for e in self.EXEMPT):
            return False
        return super().applies_to(mod)

    @staticmethod
    def _is_durable_append(dotted: str) -> bool:
        """`<something durable>.append(...)` — the receiver chain must
        name the durable handle (self._durable.append, durable.append),
        so plain list.append traffic never matches."""
        parts = dotted.split(".")
        return (len(parts) >= 2 and parts[-1] == "append"
                and any("durable" in p for p in parts[:-1]))

    @staticmethod
    def _is_fsync(dotted: str) -> bool:
        parts = dotted.split(".")
        return dotted == "os.fsync" or parts[-1] == "_fsync"

    def _loop_ancestor(self, mod: SourceModule, node: ast.AST):
        """Nearest enclosing For/While that is NOT across a function
        boundary (a nested def runs on its own clock, not once per
        iteration of the loop that defines it)."""
        for anc in mod.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return None
            if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)):
                return anc
        return None

    def check(self, mod: SourceModule) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            d = mod.dotted(node.func)
            if not d:
                continue
            if not (self._is_durable_append(d) or self._is_fsync(d)):
                continue
            if self._loop_ancestor(mod, node) is None:
                continue
            what = "durable append" if self._is_durable_append(d) \
                else "fsync"
            out.append(mod.finding(
                self, node,
                f"per-entry {what} inside a loop pays one disk sync "
                f"per iteration — collect the frames and land them as "
                f"ONE batched durable call (the group-commit window, "
                f"docs/DURABILITY.md); loops that must re-prove each "
                f"write carry an inline disable saying why"))
        return out
