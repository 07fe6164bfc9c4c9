"""Node drainer (ref nomad/drainer/drainer.go:130 NodeDrainer, run:225,
watch_jobs.go, watch_nodes.go, drain_heap.go): migrates allocations off
draining nodes in batches bounded by each group's migrate strategy, force
drains at the deadline, and lifts the drain when the node is empty.
"""
from __future__ import annotations

import threading
from typing import Optional

from .. import chrono
from ..structs import (
    DesiredTransition, Evaluation, EVAL_STATUS_PENDING, JOB_TYPE_SYSTEM,
    TRIGGER_NODE_DRAIN,
)
from .fsm import ALLOC_UPDATE_DESIRED_TRANSITION, NODE_UPDATE_DRAIN
from .lifecycle import LoopHandle


class NodeDrainer:
    def __init__(self, server, poll_interval: float = 0.25,
                 clock: Optional[chrono.Clock] = None):
        self.server = server
        self.poll_interval = poll_interval
        # deadline DECISIONS ride the clock (ISSUE 8 satellite): a
        # ManualClock test advances virtual time past the force deadline
        # instead of sleeping it out; the poll cadence stays real
        self.clock = clock or chrono.REAL
        # explicit start/join lifecycle state (server/lifecycle.py):
        # see deployment_watcher — the handle owns the stop event
        self._loop = LoopHandle()
        self._stop = self._loop.stop_event

    def start(self) -> None:
        self._loop.start(self._run, "node-drainer")

    def stop(self) -> None:
        self._loop.stop(timeout=5.0)

    def track_node(self, node_id: str) -> None:
        """Hook for UpdateDrain; polling picks it up on the next tick."""

    def _run(self) -> None:
        """ref drainer.go:225 run"""
        while not self._stop.wait(self.poll_interval):
            try:
                for node in self.server.state.iter_nodes():
                    if node.drain_strategy is not None:
                        self._drain_node(node)
            except Exception as e:      # noqa: BLE001
                self.server.logger(f"drainer: {e!r}")

    def _drain_node(self, node) -> None:
        state = self.server.state
        strategy = node.drain_strategy
        force = (strategy.deadline_sec < 0 or
                 (strategy.force_deadline_unix and
                  self.clock.time() >= strategy.force_deadline_unix))

        remaining = []
        for alloc in state.allocs_by_node(node.id):
            if alloc.terminal_status():
                continue
            job = alloc.job
            if job is not None and job.type == JOB_TYPE_SYSTEM:
                # system allocs drain last (or never when ignored)
                if strategy.ignore_system_jobs:
                    continue
                remaining.append((alloc, True))
                continue
            remaining.append((alloc, False))

        non_system = [(a, s) for a, s in remaining if not s]
        system = [(a, s) for a, s in remaining if s]

        if not remaining:
            # empty: lift the drain, keep the node ineligible
            # (ref drainer.go handleMigratedAllocs -> NodeDrainComplete)
            self.server.raft.apply(NODE_UPDATE_DRAIN, {
                "node_id": node.id, "drain": None, "mark_eligible": False})
            return

        # system allocs stop once everything else has migrated
        batch = []
        if non_system:
            batch = self._select_batch(non_system, force)
        elif system and not strategy.ignore_system_jobs:
            batch = [a for a, _ in system]

        to_migrate = [a for a in batch
                      if not a.desired_transition.should_migrate()]
        if not to_migrate:
            return
        transitions = {a.id: DesiredTransition(migrate=True)
                       for a in to_migrate}
        evals = []
        seen_jobs = set()
        for a in to_migrate:
            key = (a.namespace, a.job_id)
            if key in seen_jobs:
                continue
            seen_jobs.add(key)
            job = a.job
            evals.append(Evaluation(
                namespace=a.namespace,
                priority=job.priority if job else 50,
                type=job.type if job else "service",
                triggered_by=TRIGGER_NODE_DRAIN, job_id=a.job_id,
                node_id=node.id, status=EVAL_STATUS_PENDING))
        self.server.raft.apply(ALLOC_UPDATE_DESIRED_TRANSITION, {
            "transitions": transitions, "evals": evals})

    def _select_batch(self, allocs, force: bool) -> list:
        """Respect each group's migrate max_parallel: only migrate more when
        enough replacements are healthy (ref drainer/watch_jobs.go)."""
        if force:
            return [a for a, _ in allocs]
        state = self.server.state
        out = []
        by_group: dict[tuple, list] = {}
        for a, _ in allocs:
            by_group.setdefault((a.namespace, a.job_id, a.task_group),
                                []).append(a)
        for (ns, job_id, tg_name), group_allocs in by_group.items():
            job = state.job_by_id(ns, job_id)
            tg = job.lookup_task_group(tg_name) if job else None
            max_parallel = tg.migrate.max_parallel if tg and tg.migrate else 1
            # in-flight migrations for this group (anywhere in the cluster)
            migrating = sum(
                1 for other in state.allocs_by_job(ns, job_id)
                if other.task_group == tg_name
                and not other.terminal_status()
                and other.desired_transition.should_migrate())
            allowed = max(0, max_parallel - migrating)
            waiting = [a for a in group_allocs
                       if not a.desired_transition.should_migrate()]
            out.extend(waiting[:allowed])
        return out
