"""Crash-consistent durable storage for the raft control plane (ISSUE 13).

The reference persists votes, log entries, and FSM snapshots through an
fsync'd store (raft-boltdb) because raft's safety argument ASSUMES
durability: a server that forgets `voted_for` can vote twice in one
term, and a leader that loses an acked entry breaks linearizability.
This module is that store for the port — every byte the consensus layer
puts on disk goes through here, and a crash at any byte of any write is
a recoverable, tested event (tests/test_crash_recovery.py).

On-disk layout of one raft data dir:

    MANIFEST            crc-enveloped {gen, snapshot, log}: THE commit
                        point — replaced atomically, names the current
                        snapshot + log generation. A crash anywhere in
                        a multi-file operation (compaction, snapshot
                        install, conflict rewrite) leaves the OLD
                        manifest naming the OLD consistent pair.
    meta.bin            crc-enveloped {term, voted_for, peers,
                        nonvoters} — atomic-replace per write. Term and
                        vote ride ONE envelope, so a restart remembers
                        both or neither (never a vote without its term).
    snapshot-<g>.bin    crc-enveloped FSM snapshot doc.
    log-<g>.wal         append-only frames, each self-identifying:
                        (crc32, len, index, term) header + payload. A
                        stale log can never be silently re-based at the
                        wrong indexes — frames that don't connect to
                        the snapshot are detected and dropped.

Frame-level recovery rules (the corruption matrix, docs/DURABILITY.md):

  * torn tail (bad frame, nothing valid after it): truncate the file at
    the last valid frame — the classic power-loss shape; only the
    unacked tail write is lost.
  * mid-file damage (bad frame with a structurally valid frame AFTER
    it): the log claims entries this server may have acked/voted on but
    cannot replay — QUARANTINE the whole log (moved aside, never
    deleted) and recover from the snapshot + the leader's
    InstallSnapshot/AppendEntries catch-up.
  * index regression (frame index <= a predecessor's): a LATER write
    superseded the tail (a conflict rewrite that lost the race to a
    crash, then kept appending) — later write wins, earlier suffix
    dropped.
  * frames that don't connect to the snapshot (gap after base_index):
    stale log dropped, snapshot kept.

Fsync discipline rides the hot-reloadable `raft_fsync` knob
(SchedulerConfiguration): `always` fsyncs every append/meta/commit;
`interval` paces appends at `raft_fsync_interval_ms` but still fsyncs
commit points (manifest replace, meta); `never` trusts the page cache.
`NOMAD_RAFT_FSYNC=mode[:interval_ms]` force-overrides for bench legs.

Fault sites (docs/FAULT_INJECTION.md): `disk.append`, `disk.meta`,
`disk.snapshot`, `disk.manifest` run every payload through
`faults.mangle` (so `torn`/`corrupt`/`raise` specs hit the real write
path), and `disk.fsync` fires before each fsync syscall.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import struct
import time
import zlib
from typing import Callable, Optional

from .. import faults
from ..metrics import metrics

MANIFEST = "MANIFEST"
META = "meta.bin"

# frame header: crc32, payload_len, index, term. crc covers the packed
# (len, index, term) trio + the payload, so a frame whose header lies
# about any of the three fails the check like flipped payload bytes do
_FRAME_HDR = struct.Struct(">IIQQ")
_FRAME_CRC_TAIL = struct.Struct(">IQQ")
# single-blob envelope (manifest / meta / snapshot): crc32, len
_ENV_HDR = struct.Struct(">II")

# legacy (pre-WAL) format: length-prefixed pickle frames, no index/crc
_LEGACY_FRAME = struct.Struct(">I")
LEGACY_META = "raft_meta.pickle"
LEGACY_LOG = "raft_log.bin"
LEGACY_SNAP = "raft_snapshot.bin"

# mid-file-damage resync scan bound: a corrupt frame only classifies as
# "mid-file" if a structurally valid frame exists within this window
_SCAN_CAP = 8 << 20


def _envelope(doc) -> bytes:
    blob = pickle.dumps(doc, protocol=pickle.HIGHEST_PROTOCOL)
    return _ENV_HDR.pack(zlib.crc32(blob), len(blob)) + blob


def _read_envelope(path: str):
    """-> doc, or None when missing/short/corrupt (CRC mismatch)."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    if len(raw) < _ENV_HDR.size:
        return None
    crc, ln = _ENV_HDR.unpack_from(raw, 0)
    blob = raw[_ENV_HDR.size:_ENV_HDR.size + ln]
    if len(blob) != ln or zlib.crc32(blob) != crc:
        return None
    try:
        return pickle.loads(blob)
    except Exception:       # noqa: BLE001 — crc passed but unpicklable
        return None


def frame(index: int, term: int, type_: str, payload) -> bytes:
    blob = pickle.dumps((type_, payload), protocol=pickle.HIGHEST_PROTOCOL)
    crc = zlib.crc32(_FRAME_CRC_TAIL.pack(len(blob), index, term) + blob)
    return _FRAME_HDR.pack(crc, len(blob), index, term) + blob


def _parse_frame(raw: bytes, off: int):
    """-> (index, term, type, payload, end_offset) or None when the
    bytes at `off` are not a whole valid frame."""
    if off + _FRAME_HDR.size > len(raw):
        return None
    crc, ln, index, term = _FRAME_HDR.unpack_from(raw, off)
    end = off + _FRAME_HDR.size + ln
    if end > len(raw):
        return None
    blob = raw[off + _FRAME_HDR.size:end]
    if zlib.crc32(_FRAME_CRC_TAIL.pack(ln, index, term) + blob) != crc:
        return None
    try:
        type_, payload = pickle.loads(blob)
    except Exception:       # noqa: BLE001
        return None
    return index, term, type_, payload, end


@dataclasses.dataclass
class DurableLoad:
    """What load() recovered, plus how it had to recover it."""
    snapshot: Optional[dict] = None
    meta: Optional[dict] = None
    entries: list = dataclasses.field(default_factory=list)
    migrated: bool = False              # legacy format converted in place
    quarantined: bool = False           # log/snapshot moved aside (damage)
    tail_truncated_frames: int = 0      # torn-tail frames dropped
    stale_log_dropped: bool = False     # log didn't connect to snapshot


class DurableRaftDir:
    """One raft data dir. NOT thread-safe on its own: RaftNode
    serializes every call under its dedicated disk lock (ISSUE 20 — the
    group committer writes batches outside the state lock, so the state
    lock alone no longer covers this object)."""

    def __init__(self, path: str,
                 policy_fn: Optional[Callable[[], tuple]] = None,
                 logger=None, scope: str = ""):
        self.path = path
        os.makedirs(path, exist_ok=True)
        # -> ("always" | "interval" | "never", interval_seconds)
        self._policy_fn = policy_fn or (lambda: ("always", 0.0))
        self.logger = logger or (lambda msg: None)
        # fault-site scope: with scope="s1" every disk site also fires
        # as `disk.<kind>.s1`, so an in-process cluster fuzzer can tear
        # ONE member's disk while its peers keep writing
        self.scope = scope
        self.gen = 0
        self._snap_name = ""
        self._log_name = ""
        self._log_f = None
        self._next_index = 1            # next append index the dir expects
        self._last_sync = 0.0
        # session counters, surfaced in stats() / the operator debug bundle
        self.fsyncs = 0
        self.appends = 0
        self.manifest_commits = 0
        self.tail_truncated = 0
        self.quarantines = 0
        self.migrated = False
        # append-stream repair state: a failed/torn append leaves
        # suspect bytes at the WAL tail — the next append truncates
        # back to the last known-good size before writing (a process
        # that died instead leaves the torn tail for load() to repair)
        self._dirty_tail = False
        self._good_size = 0

    # ------------------------------------------------------ fault sites

    def _mangle(self, kind: str, data: bytes) -> bytes:
        if self.scope:
            data = faults.mangle(f"disk.{kind}.{self.scope}", data)
        return faults.mangle(f"disk.{kind}", data)

    def _fire(self, kind: str) -> None:
        if self.scope:
            faults.fire(f"disk.{kind}.{self.scope}")
        faults.fire(f"disk.{kind}")

    def _write_mangled(self, f, kind: str, data: bytes) -> None:
        """THE write contract for every durable byte: run the payload
        through the fault site, and on a torn-write spec put the seeded
        prefix on disk (flushed) before propagating the simulated power
        loss — one helper so the fuzzer's crash model can never
        desynchronize across write paths."""
        try:
            data = self._mangle(kind, data)
        except faults.TornWriteError as t:
            f.write(t.prefix)
            f.flush()
            raise
        f.write(data)

    # ------------------------------------------------------------ fsync

    def _policy(self) -> tuple:
        mode, interval = self._policy_fn()
        if mode not in ("always", "interval", "never"):
            mode = "always"
        return mode, max(float(interval), 0.0)

    def _fsync(self, fileobj, commit: bool = False) -> None:
        """Apply the fsync policy to one file. `commit=True` marks a
        commit point (manifest/meta/snapshot): `interval` mode always
        syncs those — pacing is for the append stream — while `never`
        skips even commits (the documented throughput-over-durability
        trade, docs/DURABILITY.md)."""
        mode, interval = self._policy()
        if mode == "never":
            return
        if mode == "interval" and not commit:
            now = time.monotonic()
            if now - self._last_sync < interval:
                return
        self._fire("fsync")
        fileobj.flush()
        os.fsync(fileobj.fileno())
        self._last_sync = time.monotonic()
        self.fsyncs += 1

    def _sync_dir(self) -> None:
        """Journal directory entries (renames/creates) themselves."""
        mode, _ = self._policy()
        if mode == "never":
            return
        self._fire("fsync")
        dfd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self.fsyncs += 1

    # ----------------------------------------------------- atomic blobs

    def _write_blob(self, name: str, doc, kind: str,
                    fsync_commit: bool = True) -> None:
        """crc-envelope `doc` into `name` via tmp + fsync + atomic
        replace + dir sync. The fault site sees the REAL bytes, so torn
        specs leave a short tmp (never a short live file)."""
        data = _envelope(doc)
        tmp = os.path.join(self.path, name + ".tmp")
        final = os.path.join(self.path, name)
        try:
            with open(tmp, "wb") as f:
                self._write_mangled(f, kind, data)
                self._fsync(f, commit=fsync_commit)
            os.replace(tmp, final)
            self._sync_dir()
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # ------------------------------------------------------------- meta

    def save_meta(self, doc: dict) -> None:
        self._write_blob(META, doc, "meta")

    def load_meta(self) -> Optional[dict]:
        return _read_envelope(os.path.join(self.path, META))

    # ------------------------------------------------------------ frames

    def _log_handle(self):
        if self._log_f is None:
            if not self._log_name:
                self._log_name = f"log-{self.gen:08d}.wal"
            # this append-mode open IS the WAL every raw write the
            # DUR001 lint rule flags is supposed to route through
            path = os.path.join(self.path, self._log_name)
            self._log_f = open(path, "ab")
            self._good_size = self._log_f.tell()
        return self._log_f

    def append(self, start_index: int, entries: list) -> None:
        """Append `[(term, type, payload)]` frames at `start_index..`.
        `start_index <= next` is a supersede-append (a conflict rewrite
        that failed durably was rolled forward in memory — the reader's
        index-regression rule resolves it); a GAP is a caller bug."""
        if not entries:
            return
        if start_index > self._next_index:
            raise RuntimeError(
                f"durable log gap: append at {start_index}, expected "
                f"<= {self._next_index}")
        buf = b"".join(frame(start_index + i, term, type_, payload)
                       for i, (term, type_, payload) in enumerate(entries))
        f = self._log_handle()
        if self._dirty_tail:
            # a previous append failed PART-WAY (torn/raised after some
            # bytes hit the file): repair to the last known-good size
            # before writing, or subsequent valid frames after garbage
            # would read as mid-file corruption at the next boot — a
            # process that dies instead leaves the tail for load()
            f.truncate(self._good_size)
            f.seek(self._good_size)
            self._dirty_tail = False
        try:
            self._write_mangled(f, "append", buf)
            f.flush()
            self._fsync(f)
        except BaseException:
            # anything between first byte and fsync leaves the tail
            # suspect (the fsync-failed frame is VALID bytes the caller
            # rolled back in memory — it must not resurrect at restart
            # ahead of a retried write)
            self._dirty_tail = True
            raise
        self.appends += 1
        if len(entries) > 1:
            # group-commit amortization telemetry (ISSUE 20): N frames
            # rode ONE append/sync window — the serial write path would
            # have paid a sync per entry at raft_fsync=always
            metrics.incr("nomad.durable.fsyncs_saved", len(entries) - 1)
        self._good_size = f.tell()
        self._next_index = start_index + len(entries)

    # ----------------------------------------------------- generations

    def commit_generation(self, snapshot_doc: Optional[dict],
                          entries: list, first_index: int) -> None:
        """Replace the (snapshot, log) pair as ONE atomic commit: write
        the new generation's files, then atomically replace MANIFEST.
        `snapshot_doc=None` keeps the current snapshot file (a conflict
        rewrite touches only the log). A crash before the manifest
        replace leaves the previous generation fully intact; partial
        new-generation files are cleaned up (or ignored at load)."""
        g = self.gen + 1
        snap_name = self._snap_name
        log_name = f"log-{g:08d}.wal"
        new_snap = ""
        committed = False
        dir_synced = True
        try:
            if snapshot_doc is not None:
                new_snap = f"snapshot-{g:08d}.bin"
                self._write_blob(new_snap, snapshot_doc, "snapshot")
                snap_name = new_snap
            buf = b"".join(
                frame(first_index + i, term, type_, payload)
                for i, (term, type_, payload) in enumerate(entries))
            tmp_log = os.path.join(self.path, log_name)
            with open(tmp_log, "wb") as f:
                self._write_mangled(f, "append", buf)
                self._fsync(f, commit=True)
            self._sync_dir()
            # THE commit point — inlined (not _write_blob) because the
            # moment os.replace lands, the new generation is LIVE and
            # the failure cleanup below must never touch it: unlinking
            # the files a committed manifest names would turn a
            # transient post-replace error into total state loss
            man_data = _envelope({"gen": g, "snapshot": snap_name,
                                  "log": log_name})
            man_tmp = os.path.join(self.path, MANIFEST + ".tmp")
            try:
                with open(man_tmp, "wb") as f:
                    self._write_mangled(f, "manifest", man_data)
                    self._fsync(f, commit=True)
                os.replace(man_tmp, os.path.join(self.path, MANIFEST))
                committed = True
            except BaseException:
                try:
                    os.unlink(man_tmp)
                except OSError:
                    pass
                raise
            try:
                self._sync_dir()
            except Exception as e:      # noqa: BLE001 — the replace is
                # live; a dir-fsync failure does not un-commit it. Note
                # it, and keep the OLD generation's files below so even
                # a power loss that reverts the un-journaled rename
                # still finds a complete previous generation
                dir_synced = False
                self.logger(f"durable: manifest dir sync failed "
                            f"(commit stands, old generation kept): "
                            f"{e!r}")
        except BaseException:
            if not committed:
                for name in (new_snap, log_name):
                    if name:
                        try:
                            os.unlink(os.path.join(self.path, name))
                        except OSError:
                            pass
            raise
        # committed: retarget the append stream, drop the old generation
        if self._log_f is not None:
            self._log_f.close()
            self._log_f = None
        self._dirty_tail = False        # fresh generation, clean tail
        old_snap, old_log = self._snap_name, self._log_name
        self.gen = g
        self._snap_name = snap_name
        self._log_name = log_name
        self._next_index = first_index + len(entries)
        self.manifest_commits += 1
        if dir_synced:
            for old in (old_log,
                        old_snap if old_snap != snap_name else ""):
                if old:
                    try:
                        os.unlink(os.path.join(self.path, old))
                    except OSError:
                        pass

    # ------------------------------------------------------- quarantine

    def _quarantine_file(self, name: str, reason: str) -> None:
        src = os.path.join(self.path, name)
        # uniquify: a regenerated file name (the log keeps its name
        # within a generation) quarantined a second time must not
        # clobber the earlier forensic copy
        dst = src + ".quarantined"
        n = 1
        while os.path.exists(dst):
            n += 1
            dst = f"{src}.quarantined.{n}"
        try:
            os.replace(src, dst)
        except OSError:
            pass
        self.quarantines += 1
        metrics.incr("nomad.durable.quarantined")
        self.logger(f"durable: quarantined {name} ({reason}) — kept "
                    f"aside for forensics, recovering from "
                    f"snapshot + leader catch-up")

    # ------------------------------------------------------------- load

    def load(self) -> DurableLoad:
        res = DurableLoad()
        man_path = os.path.join(self.path, MANIFEST)
        man = _read_envelope(man_path)
        if man is None:
            if os.path.exists(man_path):
                # a corrupt manifest names nothing: quarantine the whole
                # generation set — the snapshot/log it pointed at cannot
                # be told apart from a half-committed newer pair
                res.quarantined = True
                self._quarantine_file(MANIFEST, "manifest corrupt")
                for name in sorted(os.listdir(self.path)):
                    if name.startswith(("snapshot-", "log-")) and \
                            not name.endswith(".quarantined"):
                        self._quarantine_file(name, "manifest corrupt")
                self._start_empty()
                res.meta = self.load_meta()
                return res
            if self._has_legacy():
                self._migrate_legacy(res)
                man = _read_envelope(man_path)
                if man is None:         # migration found nothing usable
                    self._start_empty()
                    res.meta = self.load_meta()
                    return res
            else:
                self._start_empty()
                return res
        self.gen = int(man.get("gen", 0))
        self._snap_name = man.get("snapshot", "")
        self._log_name = man.get("log", "")
        res.meta = self.load_meta()

        base_index = 0
        if self._snap_name:
            snap = _read_envelope(os.path.join(self.path, self._snap_name))
            if snap is None:
                # the log is based on this snapshot; neither is usable
                res.quarantined = True
                self._quarantine_file(self._snap_name, "snapshot corrupt")
                if self._log_name:
                    self._quarantine_file(self._log_name,
                                          "based on corrupt snapshot")
                self._start_empty()
                return res
            res.snapshot = snap
            base_index = int(snap.get("index", 0))

        if self._log_name:
            self._load_log(res, base_index)
        self._next_index = base_index + len(res.entries) + 1
        return res

    def _load_log(self, res: DurableLoad, base_index: int) -> None:
        path = os.path.join(self.path, self._log_name)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return
        entries: list = []          # (index, term, type, payload)
        off = 0
        valid_end = 0
        damage_at = -1
        gap = False
        while off < len(raw):
            parsed = _parse_frame(raw, off)
            if parsed is None:
                damage_at = off
                break
            idx, term, type_, payload, end = parsed
            if entries and idx <= entries[-1][0]:
                # index regression: a later write supersedes the tail
                # (failed conflict rewrite rolled forward by appends)
                while entries and entries[-1][0] >= idx:
                    entries.pop()
            if idx <= base_index:
                off = valid_end = end       # pre-snapshot remnant
                continue
            expect = entries[-1][0] + 1 if entries else base_index + 1
            if idx > expect:
                gap = True                  # CRC-valid but disconnected
                break
            entries.append((idx, term, type_, payload))
            off = valid_end = end

        if gap:
            # self-identifying frames: a log that does not CONNECT to
            # the snapshot — the old two-file crash window's signature
            # (stale generation under a newer snapshot) — must never be
            # re-based at the wrong indexes. The append discipline can't
            # produce gaps, so nothing past one is replayable either.
            res.stale_log_dropped = True
            res.entries = []
            metrics.incr("nomad.durable.stale_log_dropped")
            self._quarantine_file(self._log_name,
                                  "log disconnected from snapshot")
            self._log_name = f"log-{self.gen:08d}.wal"
            return

        if damage_at >= 0:
            if self._scan_for_frame(raw, damage_at + 1):
                # valid frames exist past the damage: this log claims
                # entries it cannot replay — mid-file corruption
                res.quarantined = True
                res.entries = []
                self._quarantine_file(self._log_name, "mid-file damage")
                self._log_name = f"log-{self.gen:08d}.wal"
                return
            # torn tail: repair the file at the last valid frame
            dropped = 1 if damage_at < len(raw) else 0
            res.tail_truncated_frames += dropped
            self.tail_truncated += dropped
            metrics.incr("nomad.durable.tail_truncated")
            with open(path, "r+b") as f:
                f.truncate(valid_end)
                self._fsync(f, commit=True)
            self.logger(
                f"durable: torn tail in {self._log_name} — truncated "
                f"{len(raw) - valid_end} byte(s) at the last valid frame")
        res.entries = entries

    @staticmethod
    def _scan_for_frame(raw: bytes, start: int) -> bool:
        cap = min(len(raw), start + _SCAN_CAP)
        for off in range(start, cap):
            if _parse_frame(raw, off) is not None:
                return True
        return False

    def _start_empty(self) -> None:
        """Point the manifest at a fresh empty generation (first boot,
        or after a quarantine left nothing replayable)."""
        g = self.gen + 1
        self.gen = g
        self._snap_name = ""
        self._log_name = f"log-{g:08d}.wal"
        self._next_index = 1
        self._write_blob(MANIFEST,
                         {"gen": g, "snapshot": "", "log": self._log_name},
                         "manifest")

    # ------------------------------------------------------------ legacy

    def _has_legacy(self) -> bool:
        return any(os.path.exists(os.path.join(self.path, n))
                   for n in (LEGACY_META, LEGACY_LOG, LEGACY_SNAP))

    def _migrate_legacy(self, res: DurableLoad) -> None:
        """One-shot pre-WAL conversion: read the pickle-framed files the
        old persistence wrote, re-frame them with (index, term, crc)
        headers under a manifest, then drop the legacy files. The
        manifest replace is the migration's commit point too — a crash
        mid-migration leaves the legacy files authoritative and the
        next boot re-runs it."""
        snap = None
        snap_path = os.path.join(self.path, LEGACY_SNAP)
        if os.path.exists(snap_path):
            try:
                with open(snap_path, "rb") as f:
                    snap = pickle.load(f)
            except Exception as e:
                # REFUSE, loudly (the pre-WAL code crashed here too):
                # the legacy log's entries follow the snapshot, so
                # migrating without it would re-base them at index 1 —
                # the silent-divergence artifact this module exists to
                # make impossible. Data is untouched for inspection.
                raise RuntimeError(
                    f"legacy raft snapshot {snap_path} is unreadable "
                    f"({e!r}) — refusing to migrate; inspect or remove "
                    f"the legacy files") from e
        base_index = int(snap["index"]) if snap else 0
        entries = []
        log_path = os.path.join(self.path, LEGACY_LOG)
        if os.path.exists(log_path):
            with open(log_path, "rb") as f:
                raw = f.read()
            off = 0
            while off + _LEGACY_FRAME.size <= len(raw):
                (ln,) = _LEGACY_FRAME.unpack_from(raw, off)
                off += _LEGACY_FRAME.size
                if off + ln > len(raw):
                    break           # legacy torn tail: drop it
                try:
                    term, type_, payload = pickle.loads(raw[off:off + ln])
                except Exception as e:
                    # a COMPLETE frame that fails to decode is damage
                    # the legacy format cannot localize — refuse like
                    # the pre-WAL reader did instead of silently
                    # truncating committed history
                    raise RuntimeError(
                        f"legacy raft log {log_path} is damaged at "
                        f"offset {off} ({e!r}) — refusing to migrate; "
                        f"inspect or remove the legacy files") from e
                entries.append((term, type_, payload))
                off += ln
        meta = None
        meta_path = os.path.join(self.path, LEGACY_META)
        if os.path.exists(meta_path):
            try:
                with open(meta_path, "rb") as f:
                    meta = pickle.load(f)
            except Exception as e:
                # forgetting term/vote re-opens the double-vote hole —
                # refuse rather than migrate to term 0
                raise RuntimeError(
                    f"legacy raft meta {meta_path} is unreadable "
                    f"({e!r}) — refusing to migrate; inspect or remove "
                    f"the legacy files") from e
        if snap is None and not entries and meta is None:
            return
        if meta is not None:
            self.save_meta(meta)
        self.commit_generation(snap, entries, base_index + 1)
        for name in (LEGACY_META, LEGACY_LOG, LEGACY_SNAP):
            try:
                os.unlink(os.path.join(self.path, name))
            except OSError:
                pass
        res.migrated = True
        self.migrated = True
        metrics.incr("nomad.durable.migrations")
        self.logger(f"durable: migrated legacy raft files to "
                    f"generation {self.gen} (base index {base_index}, "
                    f"{len(entries)} log entries)")

    # ------------------------------------------------------------- misc

    def close(self) -> None:
        if self._log_f is not None:
            try:
                self._log_f.close()
            except OSError:
                pass
            self._log_f = None

    def stats(self) -> dict:
        mode, interval = self._policy()
        return {"gen": self.gen, "fsync_mode": mode,
                "fsync_interval_s": interval, "fsyncs": self.fsyncs,
                "appends": self.appends,
                "manifest_commits": self.manifest_commits,
                "tail_truncated": self.tail_truncated,
                "quarantines": self.quarantines,
                "migrated": self.migrated,
                "next_index": self._next_index}
