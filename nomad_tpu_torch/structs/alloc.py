"""Allocation model (ref nomad/structs/structs.go:9230 Allocation,
AllocatedResources, TaskState, RescheduleTracker, DesiredTransition).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from .resources import ComparableResources, NetworkResource
from .job import Job, ReschedulePolicy

# Desired statuses (ref structs.go AllocDesiredStatus*)
ALLOC_DESIRED_RUN = "run"
ALLOC_DESIRED_STOP = "stop"
ALLOC_DESIRED_EVICT = "evict"

# Client statuses (ref structs.go AllocClientStatus*)
ALLOC_CLIENT_PENDING = "pending"
ALLOC_CLIENT_RUNNING = "running"
ALLOC_CLIENT_COMPLETE = "complete"
ALLOC_CLIENT_FAILED = "failed"
ALLOC_CLIENT_LOST = "lost"
ALLOC_CLIENT_UNKNOWN = "unknown"

# Desired descriptions used by the reconciler/scheduler
DESC_RESCHEDULED = "alloc was rescheduled because it failed"
DESC_NOT_NEEDED = "alloc not needed due to job update"
DESC_MIGRATING = "alloc is being migrated"
DESC_CANARY = "alloc is a canary"
DESC_NODE_TAINTED = "alloc was lost since its node is down"
DESC_PREEMPTED = "alloc preempted by a higher-priority allocation"

TASK_STATE_PENDING = "pending"
TASK_STATE_RUNNING = "running"
TASK_STATE_DEAD = "dead"


@dataclass(slots=True)
class AllocatedTaskResources:
    cpu_shares: int = 0
    reserved_cores: tuple[int, ...] = ()
    memory_mb: int = 0
    memory_max_mb: int = 0
    networks: list[NetworkResource] = field(default_factory=list)
    devices: list["AllocatedDeviceResource"] = field(default_factory=list)

    def comparable(self) -> ComparableResources:
        return ComparableResources(
            cpu_shares=self.cpu_shares,
            reserved_cores=tuple(self.reserved_cores),
            memory_mb=self.memory_mb,
            memory_max_mb=self.memory_max_mb,
            networks=list(self.networks),
        )


@dataclass(slots=True)
class AllocatedDeviceResource:
    vendor: str = ""
    type: str = ""
    name: str = ""
    device_ids: list[str] = field(default_factory=list)


@dataclass(slots=True)
class AllocatedSharedResources:
    disk_mb: int = 0
    networks: list[NetworkResource] = field(default_factory=list)
    ports: list[dict] = field(default_factory=list)   # AllocatedPortMapping


@dataclass(slots=True)
class AllocatedResources:
    """Per-task + shared resources actually granted (ref structs.go
    AllocatedResources)."""
    tasks: dict[str, AllocatedTaskResources] = field(default_factory=dict)
    shared: AllocatedSharedResources = field(default_factory=AllocatedSharedResources)
    # usage-index caches (state/usage_index.py): allocs stamped from one
    # task group share this object, so the XR row computes once per TG
    _xr_usage: Optional[tuple] = field(default=None, init=False,
                                       repr=False, compare=False)
    _xr_seq: Optional[bool] = field(default=None, init=False,
                                    repr=False, compare=False)

    def comparable(self) -> ComparableResources:
        c = ComparableResources(disk_mb=self.shared.disk_mb,
                                networks=list(self.shared.networks))
        for tr in self.tasks.values():
            c.add(tr.comparable())
        return c


@dataclass(slots=True)
class TaskEvent:
    type: str = ""
    time_unix: float = 0.0
    message: str = ""
    details: dict[str, str] = field(default_factory=dict)


@dataclass(slots=True)
class TaskState:
    state: str = TASK_STATE_PENDING
    failed: bool = False
    restarts: int = 0
    last_restart_unix: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    events: list[TaskEvent] = field(default_factory=list)

    def successful(self) -> bool:
        return self.state == TASK_STATE_DEAD and not self.failed


@dataclass(slots=True)
class RescheduleEvent:
    reschedule_time_unix: float = 0.0
    prev_alloc_id: str = ""
    prev_node_id: str = ""
    delay_sec: float = 0.0


@dataclass(slots=True)
class RescheduleTracker:
    events: list[RescheduleEvent] = field(default_factory=list)


@dataclass(slots=True)
class DesiredTransition:
    """Server-suggested transitions applied by drainer/scheduler (ref
    structs.go DesiredTransition)."""
    migrate: Optional[bool] = None
    reschedule: Optional[bool] = None
    force_reschedule: Optional[bool] = None

    def should_migrate(self) -> bool:
        return bool(self.migrate)

    def should_force_reschedule(self) -> bool:
        return bool(self.force_reschedule)


@dataclass(slots=True)
class AllocDeploymentStatus:
    healthy: Optional[bool] = None
    timestamp_unix: float = 0.0
    canary: bool = False
    modify_index: int = 0

    def is_healthy(self) -> bool:
        return self.healthy is True

    def is_unhealthy(self) -> bool:
        return self.healthy is False


@dataclass(slots=True)
class NetworkStatus:
    interface_name: str = ""
    address: str = ""
    dns: Optional[dict] = None


@dataclass(slots=True)
class Allocation:
    id: str = ""
    namespace: str = "default"
    eval_id: str = ""
    name: str = ""
    node_id: str = ""
    node_name: str = ""
    job_id: str = ""
    job: Optional[Job] = None          # job snapshot at placement time
    task_group: str = ""
    allocated_resources: AllocatedResources = field(default_factory=AllocatedResources)
    metrics: Optional["AllocMetric"] = None

    desired_status: str = ALLOC_DESIRED_RUN
    desired_description: str = ""
    desired_transition: DesiredTransition = field(default_factory=DesiredTransition)

    client_status: str = ALLOC_CLIENT_PENDING
    client_description: str = ""
    task_states: dict[str, TaskState] = field(default_factory=dict)
    network_status: Optional[NetworkStatus] = None

    deployment_id: str = ""
    deployment_status: Optional[AllocDeploymentStatus] = None
    reschedule_tracker: Optional[RescheduleTracker] = None
    follow_up_eval_id: str = ""
    # graceful client disconnection (ref 1.3 structs.Allocation
    # AllocStates / Expired): when the reconciler marks this alloc
    # `unknown` it stamps the disconnect time; expiry is measured
    # against the group's max_client_disconnect window
    disconnected_at: float = 0.0
    preempted_by_allocation: str = ""
    preempted_allocations: list[str] = field(default_factory=list)

    previous_allocation: str = ""
    next_allocation: str = ""

    create_index: int = 0
    modify_index: int = 0
    alloc_modify_index: int = 0
    create_time_unix: float = 0.0
    modify_time_unix: float = 0.0

    def copy(self, deep_job: bool = False) -> "Allocation":
        return dataclasses.replace(
            self,
            job=(self.job.copy() if (self.job and deep_job) else self.job),
            task_states=dict(self.task_states),
            desired_transition=dataclasses.replace(self.desired_transition),
            deployment_status=(dataclasses.replace(self.deployment_status)
                               if self.deployment_status else None),
            reschedule_tracker=(RescheduleTracker(events=list(self.reschedule_tracker.events))
                                if self.reschedule_tracker else None),
            preempted_allocations=list(self.preempted_allocations),
        )

    # ---- status predicates (ref structs.go Allocation.TerminalStatus etc) ----

    def terminal_status(self) -> bool:
        """Terminal from the server's perspective: desired stop/evict or the
        client has reached a terminal state."""
        if self.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT):
            return True
        return self.client_terminal_status()

    def server_terminal_status(self) -> bool:
        return self.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT)

    def client_terminal_status(self) -> bool:
        return self.client_status in (ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED,
                                      ALLOC_CLIENT_LOST)

    def comparable_resources(self) -> ComparableResources:
        return self.allocated_resources.comparable()

    def job_namespaced_id(self) -> tuple[str, str]:
        return (self.namespace, self.job_id)

    # ---- reschedule logic (ref structs.go Allocation.NextRescheduleTime,
    #      RescheduleEligible, reconcile_util.go updateByReschedulable) ----

    def reschedule_policy(self) -> Optional[ReschedulePolicy]:
        if self.job is None:
            return None
        tg = self.job.lookup_task_group(self.task_group)
        return tg.reschedule_policy if tg else None

    def next_reschedule_time(self, policy: Optional[ReschedulePolicy] = None
                             ) -> tuple[float, bool]:
        """Returns (when, eligible): the next time this failed alloc may be
        rescheduled under its policy's backoff."""
        policy = policy or self.reschedule_policy()
        if policy is None or not policy.should_reschedule():
            return 0.0, False
        if self.client_status != ALLOC_CLIENT_FAILED:
            return 0.0, False
        fail_time = self.last_event_time()
        delay = self.reschedule_delay(policy)
        next_time = fail_time + delay
        if not policy.unlimited:
            attempted, _ = self.reschedule_attempts_in_interval(policy)
            if attempted >= policy.attempts:
                return next_time, False
        return next_time, True

    def reschedule_delay(self, policy: ReschedulePolicy) -> float:
        """Backoff delay for the next reschedule attempt: constant,
        exponential, or fibonacci on the number of prior attempts."""
        n = len(self.reschedule_tracker.events) if self.reschedule_tracker else 0
        base = policy.delay_sec
        if policy.delay_function == "constant" or n == 0:
            delay = base
        elif policy.delay_function == "exponential":
            delay = base * (2 ** n)
        elif policy.delay_function == "fibonacci":
            a, b = base, base
            for _ in range(max(0, n - 1)):
                a, b = b, a + b
            delay = b
        else:
            delay = base
        if policy.max_delay_sec > 0:
            delay = min(delay, policy.max_delay_sec)
        return delay

    def reschedule_attempts_in_interval(self, policy: ReschedulePolicy
                                        ) -> tuple[int, float]:
        if not self.reschedule_tracker:
            return 0, 0.0
        now = self.last_event_time()
        window_start = now - policy.interval_sec
        attempts = [e for e in self.reschedule_tracker.events
                    if e.reschedule_time_unix >= window_start]
        return len(attempts), window_start

    def last_event_time(self) -> float:
        """Latest task finished_at, falling back to modify time."""
        last = 0.0
        for ts in self.task_states.values():
            if ts.finished_at > last:
                last = ts.finished_at
        return last or self.modify_time_unix

    def ran_successfully(self) -> bool:
        if not self.task_states:
            return False
        return all(ts.successful() for ts in self.task_states.values())

    def migrate_disk(self) -> bool:
        if self.job is None:
            return False
        tg = self.job.lookup_task_group(self.task_group)
        return bool(tg and tg.ephemeral_disk.migrate)


@dataclass
class AllocMetric:
    """Scheduler decision metadata attached to each placement
    (ref structs.go AllocMetric)."""
    nodes_evaluated: int = 0
    nodes_filtered: int = 0
    nodes_available: dict[str, int] = field(default_factory=dict)   # per DC
    class_filtered: dict[str, int] = field(default_factory=dict)
    constraint_filtered: dict[str, int] = field(default_factory=dict)
    nodes_exhausted: int = 0
    class_exhausted: dict[str, int] = field(default_factory=dict)
    dimension_exhausted: dict[str, int] = field(default_factory=dict)
    quota_exhausted: list[str] = field(default_factory=list)
    scores: dict[str, float] = field(default_factory=dict)
    score_meta: list[dict] = field(default_factory=list)
    allocation_time_ns: int = 0
    coalesced_failures: int = 0

    def filter_node(self, node, reason: str) -> None:
        self.nodes_filtered += 1
        if node is not None and node.node_class:
            self.class_filtered[node.node_class] = \
                self.class_filtered.get(node.node_class, 0) + 1
        if reason:
            self.constraint_filtered[reason] = \
                self.constraint_filtered.get(reason, 0) + 1

    def exhausted_node(self, node, dimension: str) -> None:
        self.nodes_exhausted += 1
        if node is not None and node.node_class:
            self.class_exhausted[node.node_class] = \
                self.class_exhausted.get(node.node_class, 0) + 1
        if dimension:
            self.dimension_exhausted[dimension] = \
                self.dimension_exhausted.get(dimension, 0) + 1

    def score_node(self, node_id: str, name: str, score: float) -> None:
        self.scores[f"{node_id}.{name}"] = score

    def copy(self) -> "AllocMetric":
        return dataclasses.replace(
            self,
            nodes_available=dict(self.nodes_available),
            class_filtered=dict(self.class_filtered),
            constraint_filtered=dict(self.constraint_filtered),
            class_exhausted=dict(self.class_exhausted),
            dimension_exhausted=dict(self.dimension_exhausted),
            quota_exhausted=list(self.quota_exhausted),
            scores=dict(self.scores),
            score_meta=list(self.score_meta),
        )


def filter_terminal_allocs(allocs: list[Allocation]
                           ) -> tuple[list[Allocation], dict[str, Allocation]]:
    """Split into (live, terminal-by-name keeping newest) — ref
    scheduler/util.go filterTerminalAllocs."""
    live: list[Allocation] = []
    terminal: dict[str, Allocation] = {}
    for a in allocs:
        if a.terminal_status():
            prev = terminal.get(a.name)
            if prev is None or prev.create_index < a.create_index:
                terminal[a.name] = a
        else:
            live.append(a)
    return live, terminal
