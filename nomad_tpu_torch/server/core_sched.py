"""Core (GC) scheduler (ref nomad/core_sched.go:27): internal `_core` evals
garbage-collect terminal evals/allocs, dead jobs, down nodes and finished
deployments past a GC threshold.

Also owns the dead-letter half of the failed-eval lifecycle (ISSUE 3):
evals that exhaust their broker delivery limit are terminated as failed
and re-tried via a delayed `failed-follow-up` eval whose wait grows with
capped exponential backoff per generation — a permanently-broken eval
backs off to FAILED_EVAL_BACKOFF_CAP_S instead of hot-looping workers,
while a transiently-broken one (device loss, raft hiccup) retries
quickly. Operators can take an eval out of the loop entirely with the
agent's /v1/operator/broker/drain-failed.
"""
from __future__ import annotations

import time

from ..metrics import metrics
from ..structs import (
    Evaluation, CORE_JOB_EVAL_GC, CORE_JOB_JOB_GC, CORE_JOB_NODE_GC,
    CORE_JOB_DEPLOYMENT_GC, CORE_JOB_FAILED_EVAL_REAP, CORE_JOB_FORCE_GC,
    DEPLOYMENT_TERMINAL, JOB_STATUS_DEAD, EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED,
)
from .eval_broker import FAILED_QUEUE
from .fsm import (DEPLOYMENT_DELETE, EVAL_DELETE, EVAL_UPDATE,
                  JOB_DEREGISTER, NODE_DEREGISTER)

# failed-follow-up backoff: base * 2^generation, capped (ref
# nomad/leader.go:782 reapFailedEvaluations, which uses a fixed 1m wait;
# the cap keeps a permanently-failing eval to ~4 retries/hour)
FAILED_EVAL_BACKOFF_BASE_S = 60.0
FAILED_EVAL_BACKOFF_CAP_S = 900.0


def failed_follow_up_wait(ev: Evaluation) -> float:
    """Deterministic capped exponential backoff keyed on the eval's
    follow-up generation (no jitter: determinism is a correctness
    property here, DET001)."""
    gen = min(max(int(ev.failed_follow_ups), 0), 16)
    return min(FAILED_EVAL_BACKOFF_CAP_S,
               FAILED_EVAL_BACKOFF_BASE_S * (2 ** gen))


class CoreScheduler:
    """Processes `_core` evaluations (job_id encodes the GC kind)."""

    def __init__(self, server, eval_gc_threshold: float = 3600.0,
                 job_gc_threshold: float = 4 * 3600.0,
                 node_gc_threshold: float = 24 * 3600.0,
                 deployment_gc_threshold: float = 3600.0):
        self.server = server
        self.eval_gc_threshold = eval_gc_threshold
        self.job_gc_threshold = job_gc_threshold
        self.node_gc_threshold = node_gc_threshold
        self.deployment_gc_threshold = deployment_gc_threshold

    def process(self, ev: Evaluation) -> None:
        """ref core_sched.go Process"""
        kind = ev.job_id
        force = kind == CORE_JOB_FORCE_GC
        if kind in (CORE_JOB_EVAL_GC,) or force:
            self.eval_gc(force)
        if kind in (CORE_JOB_JOB_GC,) or force:
            self.job_gc(force)
        if kind in (CORE_JOB_NODE_GC,) or force:
            self.node_gc(force)
        if kind in (CORE_JOB_DEPLOYMENT_GC,) or force:
            self.deployment_gc(force)
        if kind in (CORE_JOB_FAILED_EVAL_REAP,) or force:
            self.reap_failed_evals()

    def _cutoff(self, threshold: float, force: bool) -> float:
        return time.time() if force else time.time() - threshold

    def reap_failed_evals(self) -> int:
        """Dead-letter consumer (ref leader.go:782 reapFailedEvaluations):
        terminate each dead-lettered eval as failed and emit the delayed
        failed-follow-up with capped exponential backoff. Called every
        leader-loop tick and by `_core`/force-gc evals."""
        broker = self.server.eval_broker
        n = 0
        while True:
            ev, token = broker.dequeue([FAILED_QUEUE], timeout=0.0)
            if ev is None:
                return n
            failed = ev.copy()
            failed.status = EVAL_STATUS_FAILED
            failed.status_description = "evaluation reached delivery limit"
            wait = failed_follow_up_wait(ev)
            follow_up = ev.create_failed_follow_up_eval(wait_sec=wait)
            self.server.raft.apply(EVAL_UPDATE,
                                   {"evals": [failed, follow_up]})
            # count AFTER the commit: a failed apply redelivers the
            # eval and re-reaps it later — counting up front would
            # overstate reaps in the bench robustness block
            metrics.incr("nomad.broker.dead_letter_reaped")
            try:
                broker.ack(ev.id, token)
            except ValueError:
                pass
            n += 1

    def eval_gc(self, force: bool = False) -> int:
        """ref core_sched.go:231 evalGC: terminal evals whose allocs are all
        terminal."""
        state = self.server.state
        cutoff = self._cutoff(self.eval_gc_threshold, force)
        gc_evals, gc_allocs = [], []
        for ev in state.iter_evals():
            if not ev.terminal_status():
                continue
            if ev.modify_time_unix and ev.modify_time_unix > cutoff:
                continue
            allocs = state.allocs_by_eval(ev.id)
            if any(not a.terminal_status() for a in allocs):
                continue
            # batch-job evals are kept while the job lives (rerun protection)
            job = state.job_by_id(ev.namespace, ev.job_id)
            if job is not None and job.type == "batch" and \
               job.status != JOB_STATUS_DEAD and not force:
                continue
            gc_evals.append(ev.id)
            gc_allocs.extend(a.id for a in allocs)
        if gc_evals:
            self.server.raft.apply(EVAL_DELETE, {
                "eval_ids": gc_evals, "alloc_ids": gc_allocs})
        return len(gc_evals)

    def job_gc(self, force: bool = False) -> int:
        """ref core_sched.go:94 jobGC: dead jobs with no live evals/allocs,
        older than the GC threshold (unless forced)."""
        state = self.server.state
        cutoff = self._cutoff(self.job_gc_threshold, force)
        gc = []
        for job in state.iter_jobs():
            if job.status != JOB_STATUS_DEAD:
                continue
            if job.is_periodic() or job.is_parameterized():
                continue
            evals = state.evals_by_job(job.namespace, job.id)
            if any(not e.terminal_status() for e in evals):
                continue
            allocs = state.allocs_by_job(job.namespace, job.id)
            if any(not a.terminal_status() for a in allocs):
                continue
            last_activity = max(
                [job.submit_time] +
                [e.modify_time_unix for e in evals] +
                [a.modify_time_unix for a in allocs])
            if last_activity > cutoff:
                continue
            gc.append(job)
        for job in gc:
            eval_ids = [e.id for e in state.evals_by_job(job.namespace, job.id)]
            alloc_ids = [a.id for a in state.allocs_by_job(job.namespace, job.id)]
            if eval_ids or alloc_ids:
                self.server.raft.apply(EVAL_DELETE, {
                    "eval_ids": eval_ids, "alloc_ids": alloc_ids})
            self.server.raft.apply(JOB_DEREGISTER, {
                "namespace": job.namespace, "job_id": job.id, "purge": True})
        return len(gc)

    def node_gc(self, force: bool = False) -> int:
        """ref core_sched.go:434 nodeGC: down nodes without allocs."""
        state = self.server.state
        cutoff = self._cutoff(self.node_gc_threshold, force)
        gc = []
        for node in state.iter_nodes():
            if not node.terminal_status():
                continue
            if node.status_updated_at > cutoff:
                continue
            if any(not a.terminal_status()
                   for a in state.allocs_by_node(node.id)):
                continue
            gc.append(node.id)
        if gc:
            self.server.raft.apply(NODE_DEREGISTER, {"node_ids": gc})
        return len(gc)

    def deployment_gc(self, force: bool = False) -> int:
        """ref core_sched.go deploymentGC"""
        state = self.server.state
        cutoff = self._cutoff(self.deployment_gc_threshold, force)
        gc = []
        for d in state.iter_deployments():
            if d.status not in DEPLOYMENT_TERMINAL:
                continue
            if d.modify_time_unix and d.modify_time_unix > cutoff:
                continue
            gc.append(d.id)
        if gc:
            self.server.raft.apply(DEPLOYMENT_DELETE, {"deployment_ids": gc})
        return len(gc)
