"""Deployment watcher (ref nomad/deploymentwatcher/deployments_watcher.go:60,
per-deployment deployment_watcher.go): drives rolling updates, canaries,
auto-promote/auto-revert, and progress deadlines.

Health flow: alloc runners report deployment_status through the client sync;
the watcher folds unseen health verdicts into the deployment via
DEPLOYMENT_ALLOC_HEALTH, then evaluates the state machine and emits
follow-up evals so the scheduler places the next max_parallel batch.
"""
from __future__ import annotations

import threading
from typing import Optional

from .. import chrono
from ..structs import (
    Deployment, DeploymentStatusUpdate, Evaluation,
    DEPLOYMENT_STATUS_FAILED, DEPLOYMENT_STATUS_RUNNING,
    DEPLOYMENT_STATUS_SUCCESSFUL, EVAL_STATUS_PENDING,
    TRIGGER_DEPLOYMENT_WATCHER, TRIGGER_ROLLING_UPDATE,
)
from .lifecycle import LoopHandle
from .fsm import (
    DEPLOYMENT_ALLOC_HEALTH, DEPLOYMENT_PROMOTE, DEPLOYMENT_STATUS_UPDATE,
    EVAL_UPDATE, JOB_REGISTER,
)

DESC_PROGRESS_DEADLINE = "Failed due to progress deadline"
DESC_UNHEALTHY_ALLOCS = "Failed due to unhealthy allocations"
DESC_SUCCESSFUL = "Deployment completed successfully"
DESC_AUTO_PROMOTED = "Deployment promoted automatically"
DESC_FAILED_REVERT = ("Failed due to unhealthy allocations - rolling back "
                      "to job version %d")


class DeploymentWatcher:
    def __init__(self, server, poll_interval: float = 0.25,
                 clock: Optional[chrono.Clock] = None):
        self.server = server
        self.poll_interval = poll_interval
        # progress-deadline DECISIONS ride the clock (ISSUE 8 satellite):
        # "the deployment made no progress for progress_deadline_sec" is
        # testable with ManualClock.advance() instead of real sleeps
        self.clock = clock or chrono.REAL
        # explicit start/join lifecycle state (server/lifecycle.py): the
        # handle owns the stop event so set+join and clear+spawn are
        # atomic pairs (a leadership re-acquire can no longer clear the
        # event out from under a mid-join stop and leak a second watcher)
        self._loop = LoopHandle()
        self._stop = self._loop.stop_event
        # deployment_id -> alloc_id -> last folded verdict; a changed verdict
        # (healthy flipping to unhealthy) must be re-processed
        self._seen_health: dict[str, dict[str, bool]] = {}
        self._progress_by: dict[str, float] = {}

    def start(self) -> None:
        self._loop.start(self._run, "deployment-watcher")

    def stop(self) -> None:
        self._loop.stop(timeout=5.0)

    def _run(self) -> None:
        """ref deployments_watcher.go:164 watchDeployments"""
        while not self._stop.wait(self.poll_interval):
            try:
                self.tick()
            except Exception as e:      # noqa: BLE001
                self.server.logger(f"deployment-watcher: {e!r}")

    def tick(self) -> None:
        """One watcher pass over every deployment. Public so bounded-
        wait tests can drive the state machine directly inside their
        poll instead of racing the 0.25s loop on a loaded box (the PR-6
        gossip-promote deflake pattern); an extra concurrent pass is
        harmless — health folding dedups via _seen_health and the
        status updates are idempotent."""
        for d in self.server.state.iter_deployments():
            if d.active():
                self._watch_one(d)
            else:
                self._seen_health.pop(d.id, None)
                self._progress_by.pop(d.id, None)

    # ----------------------------------------------------------- per-deploy

    def _watch_one(self, d: Deployment) -> None:
        state = self.server.state
        seen = self._seen_health.setdefault(d.id, {})
        healthy, unhealthy = [], []
        for alloc in state.allocs_by_job(d.namespace, d.job_id):
            if alloc.deployment_id != d.id:
                continue
            ds = alloc.deployment_status
            if ds is None or ds.healthy is None:
                continue
            if seen.get(alloc.id) == ds.healthy:
                continue
            seen[alloc.id] = ds.healthy
            (healthy if ds.healthy else unhealthy).append(alloc.id)

        made_progress = bool(healthy)
        if healthy or unhealthy:
            self.server.raft.apply(DEPLOYMENT_ALLOC_HEALTH, {
                "deployment_id": d.id, "healthy": healthy,
                "unhealthy": unhealthy, "timestamp": self.clock.time()})
            d = state.deployment_by_id(d.id)
            if d is None or not d.active():
                return

        # progress deadline bookkeeping
        deadline = self._progress_by.get(d.id)
        if deadline is None:
            deadline = self.clock.time() + max(
                (st.progress_deadline_sec or 600.0)
                for st in d.task_groups.values()) if d.task_groups else \
                self.clock.time() + 600.0
            self._progress_by[d.id] = deadline
        if made_progress:
            self._progress_by[d.id] = self.clock.time() + max(
                (st.progress_deadline_sec or 600.0)
                for st in d.task_groups.values())

        # unhealthy allocs fail the deployment (+ auto-revert)
        if unhealthy:
            self._fail(d, DESC_UNHEALTHY_ALLOCS)
            return

        if self.clock.time() >= self._progress_by[d.id] and \
           not self._complete_check(d):
            self._fail(d, DESC_PROGRESS_DEADLINE)
            return

        # auto-promote: every desired canary placed and healthy
        if d.requires_promotion() and d.has_auto_promote():
            if all(st.desired_canaries <= st.healthy_allocs
                   for st in d.task_groups.values()
                   if st.desired_canaries > 0):
                self.promote(d.id)
                return

        # success: all groups promoted (if needed) and fully healthy
        if self._complete_check(d):
            self.server.raft.apply(DEPLOYMENT_STATUS_UPDATE, {
                "update": DeploymentStatusUpdate(
                    deployment_id=d.id,
                    status=DEPLOYMENT_STATUS_SUCCESSFUL,
                    status_description=DESC_SUCCESSFUL)})
            return

        # progress: wake the scheduler to place the next batch
        if made_progress:
            self._create_eval(d, TRIGGER_DEPLOYMENT_WATCHER)

    def _complete_check(self, d: Deployment) -> bool:
        if not d.task_groups:
            return False
        for st in d.task_groups.values():
            if st.desired_canaries > 0 and not st.promoted:
                return False
            if st.healthy_allocs < st.desired_total:
                return False
        return True

    def _fail(self, d: Deployment, desc: str) -> None:
        state = self.server.state
        rollback_job = None
        if any(st.auto_revert for st in d.task_groups.values()):
            current = state.job_by_id(d.namespace, d.job_id)
            if current is not None and d.job_version > 0:
                for version in range(d.job_version - 1, -1, -1):
                    candidate = state.job_by_version(d.namespace, d.job_id,
                                                     version)
                    if candidate is not None and candidate.stable:
                        rollback_job = candidate
                        break
        if rollback_job is not None:
            desc = DESC_FAILED_REVERT % rollback_job.version
        self.server.raft.apply(DEPLOYMENT_STATUS_UPDATE, {
            "update": DeploymentStatusUpdate(
                deployment_id=d.id, status=DEPLOYMENT_STATUS_FAILED,
                status_description=desc)})
        if rollback_job is not None:
            job = rollback_job.copy()
            ev = Evaluation(
                namespace=d.namespace, priority=job.priority, type=job.type,
                triggered_by=TRIGGER_DEPLOYMENT_WATCHER, job_id=d.job_id,
                deployment_id=d.id, status=EVAL_STATUS_PENDING)
            self.server.raft.apply(JOB_REGISTER, {"job": job, "evals": [ev]})
        else:
            self._create_eval(d, TRIGGER_DEPLOYMENT_WATCHER)

    def _create_eval(self, d: Deployment, trigger: str) -> None:
        job = self.server.state.job_by_id(d.namespace, d.job_id)
        if job is None:
            return
        ev = Evaluation(
            namespace=d.namespace, priority=job.priority, type=job.type,
            triggered_by=trigger, job_id=d.job_id, deployment_id=d.id,
            status=EVAL_STATUS_PENDING)
        self.server.raft.apply(EVAL_UPDATE, {"evals": [ev]})

    # ---------------------------------------------------------- public API

    def promote(self, deployment_id: str,
                groups: Optional[list[str]] = None) -> dict:
        """ref deploymentwatcher PromoteDeployment"""
        d = self.server.state.deployment_by_id(deployment_id)
        if d is None:
            raise KeyError(f"deployment {deployment_id} not found")
        for name, st in d.task_groups.items():
            if groups is not None and name not in groups:
                continue
            if st.desired_canaries > 0 and \
               st.healthy_allocs < st.desired_canaries:
                raise ValueError(
                    f"group {name!r}: {st.healthy_allocs}/"
                    f"{st.desired_canaries} canaries healthy")
        ev = None
        job = self.server.state.job_by_id(d.namespace, d.job_id)
        if job is not None:
            ev = Evaluation(
                namespace=d.namespace, priority=job.priority, type=job.type,
                triggered_by=TRIGGER_DEPLOYMENT_WATCHER, job_id=d.job_id,
                deployment_id=d.id, status=EVAL_STATUS_PENDING)
        self.server.raft.apply(DEPLOYMENT_PROMOTE, {
            "deployment_id": deployment_id, "groups": groups, "eval": ev})
        return {"eval_id": ev.id if ev else ""}

    def fail_deployment(self, deployment_id: str) -> dict:
        d = self.server.state.deployment_by_id(deployment_id)
        if d is None:
            raise KeyError(f"deployment {deployment_id} not found")
        self._fail(d, "Deployment marked as failed")
        return {}

    def pause(self, deployment_id: str, paused: bool) -> dict:
        from ..structs import DEPLOYMENT_STATUS_PAUSED
        d = self.server.state.deployment_by_id(deployment_id)
        if d is None:
            raise KeyError(f"deployment {deployment_id} not found")
        status = DEPLOYMENT_STATUS_PAUSED if paused else \
            DEPLOYMENT_STATUS_RUNNING
        self.server.raft.apply(DEPLOYMENT_STATUS_UPDATE, {
            "update": DeploymentStatusUpdate(
                deployment_id=deployment_id, status=status,
                status_description="paused" if paused else "resumed")})
        return {}
