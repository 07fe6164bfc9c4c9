"""Blocked-evals tracker (ref nomad/blocked_evals.go): evals that failed to
place wait here and unblock when capacity changes for a computed node class
they could use (or on any change, for escaped evals).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..metrics import metrics
from ..structs import Evaluation, TRIGGER_MAX_PLANS

# per-tracker capture ceiling (ISSUE 8): blocked evals dedup per job, so
# this only binds when MORE JOBS than this are simultaneously
# unplaceable — at which point capturing further evals just defers the
# same capacity verdict. Overflow drops the lowest-priority capture
# (counted), which simply re-blocks on its next evaluation.
DEFAULT_MAX_CAPTURED = 16_384


class BlockedEvals:
    def __init__(self, enqueue_fn: Callable[[Evaluation], None],
                 max_captured: int = DEFAULT_MAX_CAPTURED):
        self._lock = threading.Lock()
        self._enabled = False
        self.enqueue_fn = enqueue_fn
        self.max_captured = max_captured
        # eval_id -> eval
        self._captured: dict[str, Evaluation] = {}
        # (namespace, job_id) -> eval_id (one blocked eval per job)
        self._by_job: dict[tuple[str, str], str] = {}
        self._escaped: set[str] = set()
        self.stats = {"total_blocked": 0, "total_escaped": 0,
                      "total_unblocked": 0, "total_dropped": 0}

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if not enabled:
                self._captured.clear()
                self._by_job.clear()
                self._escaped.clear()

    def block(self, ev: Evaluation) -> None:
        """ref blocked_evals.go Block"""
        with self._lock:
            if not self._enabled:
                return
            job_key = (ev.namespace, ev.job_id)
            # dedup: keep only the newest blocked eval per job
            old_id = self._by_job.get(job_key)
            if old_id and old_id in self._captured:
                old = self._captured.pop(old_id)
                self._escaped.discard(old_id)
            if self.max_captured > 0 and old_id is None and \
                    len(self._captured) >= self.max_captured:
                # cap (ISSUE 8): drop the lowest-priority capture (the
                # incoming eval included) — counted, never silent
                victim_id = min(self._captured,
                                key=lambda i: self._captured[i].priority)
                if self._captured[victim_id].priority >= ev.priority:
                    metrics.incr("nomad.blocked_evals.dropped")
                    self.stats["total_dropped"] += 1
                    return
                victim = self._captured.pop(victim_id)
                self._escaped.discard(victim_id)
                self._by_job.pop((victim.namespace, victim.job_id), None)
                metrics.incr("nomad.blocked_evals.dropped")
                self.stats["total_dropped"] += 1
            self._captured[ev.id] = ev
            self._by_job[job_key] = ev.id
            if ev.escaped_computed_class or not ev.class_eligibility:
                self._escaped.add(ev.id)
            self.stats["total_blocked"] = len(self._captured)
            self.stats["total_escaped"] = len(self._escaped)

    def untrack(self, namespace: str, job_id: str) -> None:
        """Job updated/deregistered: its blocked eval is obsolete."""
        with self._lock:
            eval_id = self._by_job.pop((namespace, job_id), None)
            if eval_id:
                self._captured.pop(eval_id, None)
                self._escaped.discard(eval_id)
            self.stats["total_blocked"] = len(self._captured)

    def unblock(self, computed_class: str, index: int = 0) -> None:
        """Capacity for `computed_class` changed — release matching evals
        (ref blocked_evals.go Unblock)."""
        to_run: list[Evaluation] = []
        with self._lock:
            if not self._enabled:
                return
            for eval_id in list(self._captured):
                ev = self._captured[eval_id]
                release = False
                if eval_id in self._escaped:
                    release = True
                elif computed_class in ev.class_eligibility:
                    # previously-ineligible classes can't help
                    release = ev.class_eligibility[computed_class]
                else:
                    # unseen class: might help
                    release = True
                if release:
                    to_run.append(ev)
                    del self._captured[eval_id]
                    self._escaped.discard(eval_id)
                    self._by_job.pop((ev.namespace, ev.job_id), None)
            self.stats["total_blocked"] = len(self._captured)
            self.stats["total_unblocked"] += len(to_run)
        for ev in to_run:
            out = ev.copy()
            out.status = "pending"
            out.snapshot_index = index
            self.enqueue_fn(out)

    def unblock_all(self, index: int = 0) -> None:
        with self._lock:
            evals = list(self._captured.values())
            self._captured.clear()
            self._by_job.clear()
            self._escaped.clear()
            self.stats["total_unblocked"] += len(evals)
        for ev in evals:
            out = ev.copy()
            out.status = "pending"
            out.snapshot_index = index
            self.enqueue_fn(out)
