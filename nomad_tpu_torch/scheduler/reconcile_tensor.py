"""Tensorized reconciler diff (ISSUE 15): the alloc-name slot algebra of
the reconciler — desired-vs-existing set membership, slot counts, and the
stop/place index deltas — as fixed-shape masked numpy tensors instead of
per-alloc python set walks.

The reconciler's hot inner diff is name-slot arithmetic: which of the
task group's `count` desired indices are held by live allocs, which are
free for fresh placements, and which highest-indexed holders must stop
on a scale-down. `AllocNameIndex` modeled that as a python `set[int]`
walked per slot; `TensorNameIndex` below is its FIELD-EXACT twin backed
by a bool membership mask over the pow2-padded desired axis (the same
bucketing discipline the solver's node axis rides, so the mask shapes
are enumerable) plus a small host-side overflow set for indices past the
pad — the unbounded tail the reference's `next()` can mint on scale
races. Selection (`next`, `highest`, `next_canaries`) lowers to
flatnonzero/slice over the mask; the overflow tail and every irregular
policy edge (canaries, disconnects, duplicate-name cleanup) stay
host-side, exactly as ISSUE 15 scopes them.

Equality contract: every public behavior — returned name lists AND the
mutation of the membership state — matches `AllocNameIndex` exactly on
arbitrary inputs; tests/test_fused.py fuzzes the pair op-for-op and
pins full-reconciler field-exactness with the twin on vs off.

NOMAD_RECONCILE_TENSOR=0 disables the twin (the fuzz differential's
oracle switch and the ops escape hatch); `make_name_index` is the one
construction seam the reconciler uses.
"""
from __future__ import annotations

import os

import numpy as np

from ..solver.buckets import pow2
from ..structs import alloc_name, alloc_name_index


def enabled() -> bool:
    return os.environ.get("NOMAD_RECONCILE_TENSOR", "") != "0"


def name_index_array(in_use) -> np.ndarray:
    """Parse every alloc's name-slot index into one i64 vector (the
    membership lowering; -1 = unparseable name, never a member)."""
    if not in_use:
        return np.empty(0, np.int64)
    return np.fromiter((alloc_name_index(a.name) for a in in_use.values()),
                       np.int64, count=len(in_use))


class TensorNameIndex:
    """`AllocNameIndex`'s fixed-shape masked twin: slot membership as a
    bool[P] mask (P = pow2(count)), slot selection as vectorized mask
    ops. Same constructor and method surface; same returned names; same
    membership mutations."""

    __slots__ = ("job_id", "task_group", "count", "_p", "mask",
                 "_overflow")

    def __init__(self, job_id: str, task_group: str, count: int, in_use):
        self.job_id = job_id
        self.task_group = task_group
        self.count = count
        self._p = pow2(max(int(count), 1))
        self.mask = np.zeros(self._p, bool)
        self._overflow: set[int] = set()
        idxs = name_index_array(in_use)
        idxs = idxs[idxs >= 0]
        if len(idxs):
            in_pad = idxs[idxs < self._p]
            self.mask[in_pad] = True
            for i in idxs[idxs >= self._p].tolist():
                self._overflow.add(int(i))

    # ------------------------------------------------------ compatibility

    @property
    def used(self) -> set[int]:
        """The reference's `set[int]` view (read-only materialization —
        mutation goes through the methods below)."""
        return set(np.flatnonzero(self.mask).tolist()) | self._overflow

    def _name(self, idx: int) -> str:
        return alloc_name(self.job_id, self.task_group, idx)

    def _empty(self) -> bool:
        return not self._overflow and not self.mask.any()

    def _has(self, idx: int) -> bool:
        return (self.mask[idx] if idx < self._p
                else idx in self._overflow)

    def _add(self, idx: int) -> None:
        if idx < self._p:
            self.mask[idx] = True
        else:
            self._overflow.add(idx)

    # ------------------------------------------------------------ the API

    def highest(self, n: int) -> set[str]:
        """The n highest used names, removing them from the index —
        overflow indices (all >= P) first, then the mask tail."""
        out: set[str] = set()
        for idx in sorted(self._overflow, reverse=True):
            if len(out) >= n:
                return out
            out.add(self._name(idx))
            self._overflow.discard(idx)
        held = np.flatnonzero(self.mask)
        take = held[::-1][:n - len(out)]
        for idx in take.tolist():
            out.add(self._name(int(idx)))
        self.mask[take] = False
        return out

    def unset_index(self, idx: int) -> None:
        if idx < self._p:
            if idx >= 0:
                self.mask[idx] = False
        else:
            self._overflow.discard(idx)

    def next(self, n: int) -> list[str]:
        """Next n free names within [0, count), overflowing past count."""
        if self._empty():
            # fresh job: every index is free — one vector mint
            prefix = f"{self.job_id}.{self.task_group}["
            if n <= self._p:
                self.mask[:n] = True
            else:
                self.mask[:] = True
                self._overflow.update(range(self._p, n))
            return [f"{prefix}{i}]" for i in range(n)]
        free = np.flatnonzero(~self.mask[:self.count])
        take = free[:n]
        out = [self._name(int(i)) for i in take.tolist()]
        self.mask[take] = True
        idx = self.count
        while len(out) < n:
            if not self._has(idx):
                out.append(self._name(idx))
                self._add(idx)
            idx += 1
        return out

    def next_canaries(self, n: int, existing, destructive) -> list[str]:
        """Canary names: prefer indexes of destructive updates, then free
        indexes, then indexes past count (ref NextCanaries)."""
        out: list[str] = []
        existing_names = {a.name for a in existing.values()}
        d_idx = name_index_array(destructive)
        for idx in np.unique(d_idx[d_idx >= 0]).tolist():
            if len(out) == n:
                return out
            nm = self._name(int(idx))
            if nm not in existing_names:
                out.append(nm)
                self._add(int(idx))
        free = np.flatnonzero(~self.mask[:self.count])
        for idx in free.tolist():
            if len(out) == n:
                return out
            nm = self._name(int(idx))
            if nm not in existing_names:
                out.append(nm)
                self.mask[idx] = True
        idx = self.count
        while len(out) < n:
            out.append(self._name(idx))
            idx += 1
        return out


def make_name_index(job_id: str, task_group: str, count: int, in_use):
    """The reconciler's one construction seam: the masked tensor twin by
    default, the reference python-set index under
    NOMAD_RECONCILE_TENSOR=0 (the differential oracle)."""
    from .reconcile_util import AllocNameIndex
    if enabled():
        return TensorNameIndex(job_id, task_group, count, in_use)
    return AllocNameIndex(job_id, task_group, count, in_use)
