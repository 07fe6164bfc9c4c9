"""Plan + Deployment models (ref nomad/structs/structs.go:10643 Plan,
:10887 PlanResult, :8862 Deployment).

A Plan is a scheduler's proposed state mutation: per-node placements, stops,
and preemptions. The serial plan applier verifies each node's slice against
current state (optimistic concurrency) and commits what fits.
"""
from __future__ import annotations

import dataclasses
import uuid
from dataclasses import dataclass, field
from typing import Optional

from .alloc import Allocation, ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT
from .job import Job

DEPLOYMENT_STATUS_RUNNING = "running"
DEPLOYMENT_STATUS_PAUSED = "paused"
DEPLOYMENT_STATUS_FAILED = "failed"
DEPLOYMENT_STATUS_SUCCESSFUL = "successful"
DEPLOYMENT_STATUS_CANCELLED = "cancelled"
DEPLOYMENT_STATUS_PENDING = "pending"
DEPLOYMENT_STATUS_BLOCKED = "blocked"
DEPLOYMENT_STATUS_UNBLOCKING = "unblocking"

DEPLOYMENT_TERMINAL = {DEPLOYMENT_STATUS_FAILED, DEPLOYMENT_STATUS_SUCCESSFUL,
                       DEPLOYMENT_STATUS_CANCELLED}

DESC_DEPLOYMENT_PROMOTED = "promoted canaries"
DESC_NEW_DEPLOYMENT = "created for job update"


@dataclass
class DeploymentState:
    """Per-task-group deployment progress (ref structs.go DeploymentState)."""
    auto_revert: bool = False
    auto_promote: bool = False
    promoted: bool = False
    placed_canaries: list[str] = field(default_factory=list)
    desired_canaries: int = 0
    desired_total: int = 0
    placed_allocs: int = 0
    healthy_allocs: int = 0
    unhealthy_allocs: int = 0
    progress_deadline_sec: float = 0.0
    require_progress_by_unix: float = 0.0

    def copy(self) -> "DeploymentState":
        return dataclasses.replace(self, placed_canaries=list(self.placed_canaries))


@dataclass
class Deployment:
    id: str = field(default_factory=lambda: str(uuid.uuid4()))
    namespace: str = "default"
    job_id: str = ""
    job_version: int = 0
    job_modify_index: int = 0
    job_spec_modify_index: int = 0
    job_create_index: int = 0
    is_multiregion: bool = False
    task_groups: dict[str, DeploymentState] = field(default_factory=dict)
    status: str = DEPLOYMENT_STATUS_RUNNING
    status_description: str = DESC_NEW_DEPLOYMENT
    create_index: int = 0
    modify_index: int = 0
    create_time_unix: float = 0.0
    modify_time_unix: float = 0.0

    def copy(self) -> "Deployment":
        return dataclasses.replace(
            self,
            task_groups={k: v.copy() for k, v in self.task_groups.items()})

    def active(self) -> bool:
        return self.status in (DEPLOYMENT_STATUS_RUNNING, DEPLOYMENT_STATUS_PAUSED,
                               DEPLOYMENT_STATUS_PENDING, DEPLOYMENT_STATUS_BLOCKED,
                               DEPLOYMENT_STATUS_UNBLOCKING)

    def requires_promotion(self) -> bool:
        for st in self.task_groups.values():
            if st.desired_canaries > 0 and not st.promoted:
                return True
        return False

    def has_auto_promote(self) -> bool:
        states = [st for st in self.task_groups.values() if st.desired_canaries > 0]
        return bool(states) and all(st.auto_promote for st in states)


def new_deployment(job: Job, now: float = 0.0) -> Deployment:
    """ref structs.go NewDeployment"""
    return Deployment(
        namespace=job.namespace,
        job_id=job.id,
        job_version=job.version,
        job_modify_index=job.modify_index,
        job_spec_modify_index=job.job_modify_index,
        job_create_index=job.create_index,
        status=DEPLOYMENT_STATUS_RUNNING,
        create_time_unix=now,
        modify_time_unix=now,
    )


@dataclass
class DeploymentStatusUpdate:
    deployment_id: str = ""
    status: str = ""
    status_description: str = ""


@dataclass
class DesiredUpdates:
    """Plan annotations per task group (ref structs.go DesiredUpdates)."""
    ignore: int = 0
    place: int = 0
    migrate: int = 0
    stop: int = 0
    in_place_update: int = 0
    destructive_update: int = 0
    canary: int = 0
    preemptions: int = 0


@dataclass
class PlanAnnotations:
    desired_tg_updates: dict[str, DesiredUpdates] = field(default_factory=dict)
    preempted_allocs: list[str] = field(default_factory=list)


@dataclass
class Plan:
    eval_id: str = ""
    eval_token: str = ""
    priority: int = 50
    all_at_once: bool = False
    job: Optional[Job] = None
    # node_id -> allocs to stop/evict (with updated desired status/description)
    node_update: dict[str, list[Allocation]] = field(default_factory=dict)
    # node_id -> new/updated allocs to place
    node_allocation: dict[str, list[Allocation]] = field(default_factory=dict)
    # node_id -> allocs preempted (desired_status=evict)
    node_preemptions: dict[str, list[Allocation]] = field(default_factory=dict)
    deployment: Optional[Deployment] = None
    deployment_updates: list[DeploymentStatusUpdate] = field(default_factory=list)
    annotations: Optional[PlanAnnotations] = None
    snapshot_index: int = 0
    # the submitting eval's enqueue TTL (ISSUE 8): the applier rejects a
    # past-deadline plan BEFORE the raft round — its caller already gave
    # up, committing would be wasted device+consensus work. 0 = none.
    deadline_unix: float = 0.0
    # fused plan-evaluate verdict (ISSUE 15): {version, uid, epoch,
    # rows: {view_row -> verified-ask f32[R']}} stamped by the solver's
    # fused dispatch — rows the device proved fit post-solve at that
    # usage-journal version. Worker-local advisory state (never crosses
    # raft); the applier consumes it as a monotone fast path and falls
    # back to its own dense compare whenever the stamp doesn't bind.
    solver_verdict: Optional[dict] = None

    # ---- mutators used by the schedulers (ref structs.go Plan.AppendAlloc etc) ----

    def append_alloc(self, alloc: Allocation, job: Optional[Job]) -> None:
        """Add a placement. The alloc's job is normalized to the plan job
        unless a specific (e.g. older) job version is given."""
        alloc.job = job or self.job
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_stopped_alloc(self, alloc: Allocation, desired_desc: str,
                             client_status: str = "",
                             follow_up_eval_id: str = "") -> None:
        a = alloc.copy()
        a.job = None  # the job is carried by existing state
        a.desired_status = ALLOC_DESIRED_STOP
        a.desired_description = desired_desc
        if client_status:
            a.client_status = client_status
        if follow_up_eval_id:
            a.follow_up_eval_id = follow_up_eval_id
        self.node_update.setdefault(a.node_id, []).append(a)

    def append_preempted_alloc(self, alloc: Allocation, preempting_id: str) -> None:
        a = alloc.copy()
        a.job = None
        a.desired_status = ALLOC_DESIRED_EVICT
        a.desired_description = f"Preempted by alloc ID {preempting_id}"
        a.preempted_by_allocation = preempting_id
        self.node_preemptions.setdefault(a.node_id, []).append(a)

    def pop_update(self, alloc: Allocation) -> None:
        """Remove a pending stop for this alloc (used when an updated alloc is
        placed in the same plan)."""
        updates = self.node_update.get(alloc.node_id, [])
        self.node_update[alloc.node_id] = [u for u in updates if u.id != alloc.id]
        if not self.node_update[alloc.node_id]:
            del self.node_update[alloc.node_id]

    def is_no_op(self) -> bool:
        return (not self.node_update and not self.node_allocation
                and self.deployment is None and not self.deployment_updates)


@dataclass
class PlanResult:
    """What the plan applier actually committed (ref structs.go:10887)."""
    node_update: dict[str, list[Allocation]] = field(default_factory=dict)
    node_allocation: dict[str, list[Allocation]] = field(default_factory=dict)
    node_preemptions: dict[str, list[Allocation]] = field(default_factory=dict)
    deployment: Optional[Deployment] = None
    deployment_updates: list[DeploymentStatusUpdate] = field(default_factory=list)
    rejected_nodes: list[str] = field(default_factory=list)
    refresh_index: int = 0
    alloc_index: int = 0

    def full_commit(self, plan: Plan) -> tuple[bool, int, int]:
        """(fully committed?, expected placements, actual) — ref
        structs.go PlanResult.FullCommit."""
        expected = sum(len(v) for v in plan.node_allocation.values())
        actual = sum(len(v) for v in self.node_allocation.values())
        return expected == actual, expected, actual

    def is_no_op(self) -> bool:
        return (not self.node_update and not self.node_allocation
                and not self.deployment_updates and self.deployment is None)
