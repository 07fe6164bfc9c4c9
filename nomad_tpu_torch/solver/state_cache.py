"""Card-resident incremental cluster tensors — the counterpart of
nomad_tpu/solver/state_cache.py, for one card.

Every eval used to re-lower the full snapshot to dense host tensors and
ship them to the card. This cache keeps the cluster's cap/used [N, R']
matrices and the per-node live-alloc count vector:

  * built ONCE from a snapshot's `UsageView` at version i (a miss), then
  * advanced to version j by replaying the usage index's `DeltaLog`
    records — `np.add.at` over the journaled (row, delta) stream, the
    EXACT op and order the store itself uses, so the advanced arrays are
    bit-identical to a fresh view at j (tests/test_torch_state_cache.py
    holds them against the view and against the reference's cache), and
  * mirrored to the solve device as bucket-padded float32 twins: the seed
    is one host-to-device copy; an advance scatter-SETS the touched rows'
    final host values into a NEW tensor, so a steady-state eval's device
    input is one on-device gather instead of a fresh host build + copy.

Keying follows the usage index's versioning contract (usage_index.py):
(uid, epoch) is the node-set fingerprint — any node add/drop/capacity
change or store restore misses and reseeds; `version` orders the delta
stream. On ANY miss, gap (journal trimmed past our cursor), or stale
snapshot the caller falls back to the plain view build, which is the
same bits by construction.

Concurrency: scheduler workers snapshot at slightly different versions,
and the cache can only roll forward. A small ring of displaced `used`
generations (each valid for a version interval) serves the common
"one commit behind" snapshot; anything older falls back (counted as a
miss + `.stale`). All reads/advances happen under one lock; handed-out
host arrays are always fancy-index copies, and nothing outside this
module mutates the resident arrays.

The twins are never written in place: an advance builds the next twin
with an out-of-place `index_copy`, so a reader that captured the
displaced twin (an in-flight eval's gather on the placer thread while
the applier thread advances) keeps reading exactly that version's bits.
Both threads queue on the device's default stream, so the caching
allocator reuses a displaced twin's memory only after the work queued
before its release has run.

The twins live on the solve device (device.solve_device()) and are keyed
by it: a gather on another device than the twins' re-seeds them there
from the host mirrors, so a switch between the card and the CPU never
hands one device's tensors to the other. With no card and no
use_device("cpu") there are no twins; the host mirrors still serve, and
the solve itself raises (backend.select).

`plan_apply.Planner.apply_plan` calls `note_commit` after every raft
commit, so the replay usually runs on the leader-serial applier thread —
off the eval critical path — and the next eval's gather is a pure hit.

A device error while seeding or gathering the twins feeds the backend's
breaker (backend.note_dispatch_failure; a device loss drops the twins)
and raises out of the eval: the eval's solve never leaves the card for
the host copies. One while advancing the twins at a commit drops them
instead (the host mirrors have already advanced, and the commit must
not fail); the next gather seeds them again on the card.

Not ported: the device mesh (sharded twins, evacuation on device loss,
generation bumps). One card has one generation, `GENERATION`.

NOMAD_STATE_CACHE=0 disables the cache entirely (ops escape hatch; the
differential tests also use it to produce the oracle path).
"""
from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from ..metrics import metrics
from . import device as _device
from .buckets import node_bucket

# displaced used-generations kept for stale views: a full complement of
# concurrent scheduler workers can each land one commit between a
# sibling's snapshot and its gather
RING = 16
# the mesh generation every twin rides: one card, no mesh rebuilds
GENERATION = 0


def _device_errors() -> tuple:
    from . import backend
    return backend.device_error_types()


def _note_device_failure(exc: BaseException, dev: torch.device) -> None:
    """A twin seed, advance or gather failed on `dev`: feed the backend's
    breaker for the tier that solves there (a device loss also drops the
    twins)."""
    from . import backend
    backend.note_dispatch_failure(
        "cuda" if dev.type == "cuda" else "torch", exc)


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A tensor on `dev` that owns a copy of `a`. To a card through
    pinned memory without blocking, so the copy queues behind the
    device's work instead of waiting for it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone()


class _Generation:
    """A displaced `used` matrix, valid for views with
    lo <= view.version < hi (arrays reflect exactly the journal prefix
    through version `lo`; `hi` is the first entry version of the advance
    that displaced it)."""

    __slots__ = ("lo", "hi", "used")

    def __init__(self, lo: int, hi: int, used: np.ndarray):
        self.lo = lo
        self.hi = hi
        self.used = used


class GatherResult:
    """One eval's slice of the cached tensors, in eval (shuffled node)
    order. cap/used are fresh host copies (callers may apply in-plan
    corrections in place); cap_dev/used_dev — when the current twins
    served the request — are bucket-padded tensors on the solve device
    ready for dispatch (padding rows zero, exactly like the host np.pad
    path). `gen` is the generation the twins were seeded at."""

    __slots__ = ("cap", "used", "cap_dev", "used_dev", "gen", "resident",
                 "version", "uid", "epoch")

    def __init__(self, cap, used, cap_dev=None, used_dev=None, gen=None):
        self.cap = cap
        self.used = used
        self.cap_dev = cap_dev
        self.used_dev = used_dev
        self.gen = gen
        # resident=True requests: the whole twins (cap, used) with the
        # journal version, uid and epoch their bits reflect
        self.resident = None
        self.version = -1
        self.uid = 0
        self.epoch = -1


class TensorCache:
    def __init__(self):
        # RLock, as the reference's: every twin swap and every journal
        # advance runs under it, re-entrantly from reseed paths
        self._lock = threading.RLock()
        self._uid = 0                   # source UsageIndex identity
        self._epoch = -1                # node-set fingerprint
        self.version = 0                # version of the last applied entry
        self._seq = 0                   # absolute journal cursor
        self.cap: Optional[np.ndarray] = None
        self.used: Optional[np.ndarray] = None
        self.counts: Optional[np.ndarray] = None
        # eligibility-mask column mirror: advanced by taint SET entries in
        # the same journal replay as `used`, so a mass node failure flips
        # schedulability WITHOUT an epoch reseed
        self.elig: Optional[np.ndarray] = None
        self._ring: list[_Generation] = []
        self._bucket = 0                # twin row count (node_bucket)
        self._cap_dev: Optional[torch.Tensor] = None
        self._used_dev: Optional[torch.Tensor] = None
        self._dev: Optional[torch.device] = None    # where the twins live
        self._hits = 0
        self._misses = 0

    # ------------------------------------------------------------- control

    @staticmethod
    def enabled() -> bool:
        return os.environ.get("NOMAD_STATE_CACHE", "") != "0"

    def reset(self) -> None:
        with self._lock:
            self._uid = 0
            self._epoch = -1
            self.version = 0
            self._seq = 0
            self.cap = self.used = self.counts = self.elig = None
            self._ring = []
            self._bucket = 0
            self._cap_dev = self._used_dev = None
            self._dev = None
            self._hits = self._misses = 0

    def stats(self) -> dict:
        with self._lock:
            return {"uid": self._uid, "epoch": self._epoch,
                    "version": self.version, "seq": self._seq,
                    "rows": 0 if self.cap is None else int(self.cap.shape[0]),
                    "generations": len(self._ring),
                    "mesh_generation": GENERATION,
                    "twins_sharded": False,
                    "twins_device": (None if self._used_dev is None
                                     else str(self._dev)),
                    "hits": self._hits, "misses": self._misses,
                    "tainted_rows": (0 if self.elig is None
                                     else int((self.elig < 0.5).sum()))}

    def twins(self) -> tuple:
        """(cap_dev, used_dev) as they stand — None, None without twins.
        For checks; the solve path reads twins through `gather`."""
        with self._lock:
            return self._cap_dev, self._used_dev

    # ------------------------------------------------------------ internals

    def _miss(self, *kinds: str) -> None:
        self._misses += 1
        metrics.incr("nomad.solver.state_cache.misses")
        for kind in kinds:
            metrics.incr(f"nomad.solver.state_cache.{kind}")

    def _hit(self, ring: bool = False) -> None:
        self._hits += 1
        metrics.incr("nomad.solver.state_cache.hits")
        if ring:
            metrics.incr("nomad.solver.state_cache.ring_hits")

    def _seed_locked(self, view) -> None:
        """Full rebuild from the view (the miss path). The seed arrays ARE
        the view's bits, so a seeded cache trivially matches the fallback
        path at this version."""
        self._uid = view.uid
        self._epoch = view.epoch
        self.version = view.version
        self.cap = view.cap.copy()
        self.used = view.used.copy()
        self.counts = (view.counts.copy() if view.counts is not None
                       else np.zeros(view.cap.shape[0], np.int32))
        ve = getattr(view, "elig", None)
        self.elig = (ve.copy() if ve is not None
                     else np.ones(view.cap.shape[0], np.float32))
        self._ring = []
        # journal cursor: first entry past the view's version (entries are
        # version-ordered; post-view entries are few — scan backward)
        floor, entries = view.delta_log.tail
        k = len(entries)
        while k > 0 and entries[k - 1][0] > view.version:
            k -= 1
        self._seq = floor + k
        self._seed_device_locked()
        self._miss("reseeds")

    def _seed_device_locked(self) -> None:
        """The twins, from the host mirrors: one copy each to the solve
        device. No twins when the solve device is a card that is not
        there (device.solve_device raises); the solve reports that."""
        self._cap_dev = self._used_dev = None
        self._dev = None
        try:
            dev = _device.solve_device()
        except RuntimeError:
            return
        n = self.cap.shape[0]
        self._bucket = node_bucket(n)
        pad = ((0, self._bucket - n), (0, 0))
        try:
            cap_dev = _upload(np.pad(self.cap, pad), dev)
            used_dev = _upload(np.pad(self.used, pad), dev)
        except _device_errors() as e:
            _note_device_failure(e, dev)
            raise
        self._cap_dev, self._used_dev = cap_dev, used_dev
        self._dev = dev
        metrics.incr("nomad.solver.state_cache.twin_seeds")

    def drop_twins(self) -> None:
        """Forget the twins (after a device loss): the next gather seeds
        them again."""
        with self._lock:
            self._cap_dev = self._used_dev = None
            self._dev = None

    def _advance_locked(self, target_version: int, log) -> bool:
        """Replay journal entries with version <= target_version from the
        cursor. Returns False on a gap (journal trimmed past the cursor —
        caller reseeds). Only entry versions actually applied move
        `self.version`, so a half-appended batch seen from note_commit can
        never mark unseen deltas as applied. The twin scatter runs before
        any mirror is replaced: if it raises, nothing has moved."""
        floor, entries = log.tail
        start = self._seq - floor
        if start < 0:
            return False                         # gap: trimmed past us
        k = start
        end = len(entries)
        while k < end and entries[k][0] <= target_version:
            k += 1
        if k == start:
            return True                          # nothing to do
        batch = entries[start:k]
        all_rows = np.fromiter((e[1] for e in batch), np.int64,
                               count=len(batch))
        if int(all_rows.max()) >= self.used.shape[0]:
            # a row past our arrays means the node set grew under us — an
            # unlocked note_commit can race a node register + its first
            # alloc between the epoch check and the version read. Nothing
            # is applied; the caller reseeds (gather) or skips (feed).
            return False
        # taint SET entries (None delta) advance the eligibility column;
        # usage deltas advance used/counts
        taints = [e for e in batch if e[2] is None]
        usage = [e for e in batch if e[2] is not None] if taints else batch
        if usage:
            rows = np.fromiter((e[1] for e in usage), np.int64,
                               count=len(usage))
            deltas = np.array([e[2] for e in usage], np.float32)
            cdeltas = np.fromiter((e[3] for e in usage), np.int32,
                                  count=len(usage))
            used = self.used.copy()
            np.add.at(used, rows, deltas)
            self._scatter_device_locked(rows, used)
            # displace the current used generation into the ring (cap is
            # shared: alloc deltas never touch capacity; epoch rebuilds do)
            self._ring.append(_Generation(self.version, usage[0][0],
                                          self.used))
            del self._ring[:-RING]
            self.used = used
            np.add.at(self.counts, rows, cdeltas)
            metrics.incr("nomad.solver.state_cache.delta_rows", len(usage))
        if taints:
            for e in taints:            # in-order SETs: last write wins
                self.elig[e[1]] = e[4]
            metrics.incr("nomad.solver.state_cache.taint_rows",
                         len(taints))
        self._seq = floor + k
        self.version = batch[-1][0]
        return True

    def _scatter_device_locked(self, rows: np.ndarray,
                               used: np.ndarray) -> None:
        """The next `used` twin: the touched rows' FINAL host values
        scatter-SET into a new tensor (out of place — see the module
        doc). Setting final values, not adding deltas, keeps the twin's
        bits equal to the host mirror whatever the order of duplicate
        rows."""
        if self._used_dev is None:
            return
        uniq = np.unique(rows)
        try:
            idx = _upload(uniq, self._dev)
            vals = _upload(used[uniq], self._dev)
            self._used_dev = self._used_dev.index_copy(0, idx, vals)
        except _device_errors() as e:
            # the host mirror advances alone; the twins are stale now
            dev = self._dev
            self._cap_dev = self._used_dev = None
            self._dev = None
            _note_device_failure(e, dev)

    # -------------------------------------------------------------- reading

    def gather(self, view, rows: np.ndarray, bucket: int = 0,
               tier: str = "",
               resident: bool = False) -> Optional[GatherResult]:
        """Serve one eval's (shuffled) node rows from the cache, advancing
        it to the view's version first. Returns None when the cache is
        disabled or the view carries no versioning stamp (plain test
        fakes) — the caller then builds from the view exactly as before.
        A stale view (older than every resident generation) is served
        straight from the view's own arrays and counted as a miss.

        With `bucket` > 0 the current twins' rows are gathered on their
        device too, padded to `bucket` rows, when `tier` (the backend
        tier the caller resolved, "cuda" or "torch") solves on the
        device the twins live on. The twins move to the solve device
        first if they are elsewhere.

        `resident=True` (the reference's `fused` flag, which its convex
        route sets) instead hands back the whole current twins with the
        journal version their bits reflect (`resident`, `version`, `uid`,
        `epoch`), gathering nothing: the convex solve gathers the eval's
        rows behind its own launch. No tier check there; the convex
        selector compares the twins' device with the solve device."""
        if view.uid == 0 or view.delta_log is None or not self.enabled():
            return None
        # the lock covers only version bookkeeping + the journal replay;
        # the per-eval fancy-index copies and the device gather run
        # OUTSIDE it on captured references — once displaced or replaced,
        # generation arrays (host and device) are never mutated again
        dev = res = None
        with self._lock:
            if view.uid == self._uid and view.epoch < self._epoch:
                # a snapshot from BEFORE a node-set change: never roll the
                # shared cache backward for it — the view is the source
                self._miss("stale")
                src_cap, src_used = view.cap, view.used
            else:
                seeded = False
                if view.uid != self._uid or view.epoch != self._epoch or \
                        self.cap is None:
                    self._seed_locked(view)
                    seeded = True
                elif not self._advance_locked(view.version, view.delta_log):
                    self._seed_locked(view)
                    seeded = True
                if view.version >= self.version:
                    if not seeded:  # a reseed already counted its miss
                        self._hit()
                    src_cap, src_used = self.cap, self.used
                    if resident and self.cap is not None:
                        # twin updates are functional: these references
                        # keep exactly this version's bits
                        pair = self._device_pair_locked("")
                        if pair is not None:
                            res = (pair, self.version, self._uid,
                                   self._epoch)
                    elif bucket and self.cap is not None:
                        dev = self._device_pair_locked(tier)
                else:
                    for gen in self._ring:
                        if gen.lo <= view.version < gen.hi:
                            self._hit(ring=True)
                            src_cap, src_used = self.cap, gen.used
                            break
                    else:
                        # older than every generation: view is the source
                        self._miss("stale")
                        src_cap, src_used = view.cap, view.used
        # attribute the cache outcome onto the in-flight solve span: src
        # arrays being the view's == a miss served from the fallback path
        from ..obs import trace
        trace.annotate(cache="miss" if src_cap is view.cap else "hit")
        out = GatherResult(src_cap[rows], src_used[rows])
        if dev is not None:
            out.gen = GENERATION
            out.cap_dev, out.used_dev = self._gather_device(dev, rows,
                                                            bucket)
        if res is not None:
            out.resident, out.version, out.uid, out.epoch = res
            out.gen = GENERATION
        return out

    def _device_pair_locked(self, tier: str) -> Optional[tuple]:
        """(cap twin, used twin) for a device gather by `tier`, moved to
        the solve device first if they live elsewhere; None when there
        are no twins or the tier solves on another kind of device."""
        try:
            want = _device.solve_device()
        except RuntimeError:
            return None         # no card: the solve reports it
        if self._used_dev is None or self._dev != want:
            self._seed_device_locked()
            if self._used_dev is None:
                return None
        if tier and (tier == "cuda") != (self._dev.type == "cuda"):
            return None
        return self._cap_dev, self._used_dev

    @staticmethod
    def _gather_device(dev: tuple, rows: np.ndarray, bucket: int):
        """The eval's rows of each twin, in eval order, into a zeroed
        `bucket`-row tensor: one indexing op per twin."""
        from .. import faults
        from . import roundtrip
        cap_dev, used_dev = dev
        try:
            if cap_dev.device.type == "cuda":
                faults.fire(f"device.lost.d{cap_dev.device.index or 0}")
            roundtrip.note("gather")
            n = len(rows)
            idx = _upload(np.asarray(rows, np.int64), cap_dev.device)
            out = []
            for twin in (cap_dev, used_dev):
                buf = twin.new_zeros((bucket, twin.shape[1]))
                torch.index_select(twin, 0, idx, out=buf[:n])
                out.append(buf)
            return tuple(out)
        except _device_errors() as e:
            _note_device_failure(e, cap_dev.device)
            raise

    # ------------------------------------------------------------- feeding

    def standby_feed(self, store) -> None:
        """FOLLOWER-side passive twin feed (the FSM's on_plan_apply hook
        as replicated plan results land). Ownership rule: an EMPTY cache
        adopts this store (seeding the host arrays AND the twins); a
        cache already tracking this store's usage stream advances it; a
        cache owned by a DIFFERENT store is left alone — the first feeder
        wins, and a later leader's gather reseeds anyway."""
        if not self.enabled():
            return
        usage = getattr(store, "usage", None)
        if usage is None or getattr(usage, "uid", 0) == 0:
            return
        try:
            with self._lock:
                if self._uid != 0 and self.cap is not None:
                    if usage.uid != self._uid \
                            or usage.epoch != self._epoch:
                        return          # another store owns the cache
                    # _advance_locked bounds-checks a racing node
                    # register and refuses rather than corrupting
                    self._advance_locked(usage.version, usage.delta_log)
                    return
            # empty cache: seed from a properly-locked snapshot view,
            # taken OUTSIDE the cache lock — the store lock must never
            # nest inside ours
            view = getattr(store.snapshot(), "usage", None)
            if view is None or view.uid == 0:
                return
            with self._lock:
                if self._uid == 0 or self.cap is None:
                    self._seed_locked(view)
        except Exception as e:  # noqa: BLE001 — feed is best-effort
            from ..metrics import record_swallowed_error
            record_swallowed_error("state_cache.standby_feed", e)

    def reseed(self, store) -> dict:
        """Promotion step of the leadership recovery barrier: make the
        cache authoritative for THIS store before scheduling resumes.
        Warm path — the standby feed already tracks this store's usage
        stream — just replays any journal tail (twins kept). Anything
        else pays the full reseed HERE. Returns {warm, rows}."""
        usage = getattr(store, "usage", None)
        if usage is None or getattr(usage, "uid", 0) == 0 \
                or not self.enabled():
            return {"warm": False, "rows": 0, "skipped": True}
        view = getattr(store.snapshot(), "usage", None)
        if view is None or view.uid == 0:
            return {"warm": False, "rows": 0, "skipped": True}
        with self._lock:
            warm = (view.uid == self._uid and view.epoch == self._epoch
                    and self.cap is not None)
            if warm and self._advance_locked(view.version, view.delta_log):
                metrics.incr("nomad.solver.state_cache.promote_warm")
            else:
                warm = False
                self._seed_locked(view)
            return {"warm": warm, "rows": int(self.cap.shape[0])}

    def note_commit(self, store) -> None:
        """Applier-thread hook (plan_apply): eagerly replay whatever the
        journal holds so the next eval's gather is a pure hit. Advances
        only through entries actually visible — a concurrent writer's
        half-appended batch is picked up by a later advance."""
        if not self.enabled():
            return
        usage = getattr(store, "usage", None)
        if usage is None or getattr(usage, "uid", 0) == 0:
            return
        metrics.incr("nomad.solver.state_cache.commit_feeds")
        try:
            with self._lock:
                if usage.uid != self._uid or usage.epoch != self._epoch \
                        or self.cap is None:
                    return              # let the next eval pay the reseed
                # epoch/version are read without the store lock: a node
                # register can land between them, making the journal
                # reference rows past our arrays — _advance_locked bounds-
                # checks and refuses rather than corrupting; anything else
                # unexpected must never fail the already-committed plan
                self._advance_locked(usage.version, usage.delta_log)
        except Exception as e:  # noqa: BLE001 — feed is best-effort
            from ..metrics import record_swallowed_error
            record_swallowed_error("state_cache.note_commit", e)


_cache = TensorCache()


def cache() -> TensorCache:
    return _cache


# module-level forwarding API (tensorize and plan_apply import these; one
# process-wide cache matches the one-leader, one-card reality)
gather = _cache.gather
note_commit = _cache.note_commit
standby_feed = _cache.standby_feed
reseed = _cache.reseed
reset = _cache.reset
enabled = _cache.enabled
