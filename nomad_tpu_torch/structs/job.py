"""Job specification model: Job → TaskGroup → Task plus scheduling directives
(ref nomad/structs/structs.go:4032 Job, :5997 TaskGroup, :6737 Task,
:8357 Constraint, :8477 Affinity, :8563 Spread).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from .resources import Resources, NetworkResource

# Job types (ref structs.go JobType*)
JOB_TYPE_SERVICE = "service"
JOB_TYPE_BATCH = "batch"
JOB_TYPE_SYSTEM = "system"
JOB_TYPE_SYSBATCH = "sysbatch"
JOB_TYPE_CORE = "_core"

# Job statuses
JOB_STATUS_PENDING = "pending"
JOB_STATUS_RUNNING = "running"
JOB_STATUS_DEAD = "dead"

JOB_MIN_PRIORITY = 1
JOB_DEFAULT_PRIORITY = 50
JOB_MAX_PRIORITY = 100
CORE_JOB_PRIORITY = JOB_MAX_PRIORITY * 2

DEFAULT_NAMESPACE = "default"

# Constraint operands (ref structs.go Constraint*)
OP_EQ = "="
OP_NEQ = "!="
OP_GT = ">"
OP_GTE = ">="
OP_LT = "<"
OP_LTE = "<="
OP_REGEX = "regexp"
OP_VERSION = "version"
OP_SEMVER = "semver"
OP_SET_CONTAINS = "set_contains"
OP_SET_CONTAINS_ALL = "set_contains_all"
OP_SET_CONTAINS_ANY = "set_contains_any"
OP_DISTINCT_HOSTS = "distinct_hosts"
OP_DISTINCT_PROPERTY = "distinct_property"
OP_IS_SET = "is_set"
OP_IS_NOT_SET = "is_not_set"


@dataclass
class Constraint:
    ltarget: str = ""     # attribute interpolation, e.g. "${attr.kernel.name}"
    rtarget: str = ""
    operand: str = OP_EQ

    def copy(self) -> "Constraint":
        return dataclasses.replace(self)

    def __str__(self) -> str:
        return f"{self.ltarget} {self.operand} {self.rtarget}"


@dataclass
class Affinity:
    ltarget: str = ""
    rtarget: str = ""
    operand: str = OP_EQ
    weight: int = 50      # [-100, 100]; negative = anti-affinity

    def copy(self) -> "Affinity":
        return dataclasses.replace(self)


@dataclass
class SpreadTarget:
    value: str = ""
    percent: int = 0


@dataclass
class Spread:
    attribute: str = ""
    weight: int = 50      # (0, 100]
    spread_target: list[SpreadTarget] = field(default_factory=list)

    def copy(self) -> "Spread":
        return dataclasses.replace(
            self, spread_target=[dataclasses.replace(t) for t in self.spread_target])


@dataclass
class RestartPolicy:
    """Client-side restart policy (ref structs.go RestartPolicy)."""
    attempts: int = 2
    interval_sec: float = 1800.0
    delay_sec: float = 15.0
    mode: str = "fail"    # fail | delay


@dataclass
class ReschedulePolicy:
    """Server-side reschedule policy (ref structs.go ReschedulePolicy)."""
    attempts: int = 0
    interval_sec: float = 0.0
    delay_sec: float = 30.0
    delay_function: str = "exponential"   # constant | exponential | fibonacci
    max_delay_sec: float = 3600.0
    unlimited: bool = True

    def should_reschedule(self) -> bool:
        return self.unlimited or (self.attempts > 0 and self.interval_sec > 0)


@dataclass
class UpdateStrategy:
    """Rolling-update / deployment strategy (ref structs.go UpdateStrategy)."""
    stagger_sec: float = 30.0
    max_parallel: int = 1
    health_check: str = "checks"          # checks | task_states | manual
    min_healthy_time_sec: float = 10.0
    healthy_deadline_sec: float = 300.0
    progress_deadline_sec: float = 600.0
    auto_revert: bool = False
    auto_promote: bool = False
    canary: int = 0

    def rolling(self) -> bool:
        return self.max_parallel > 0


@dataclass
class MigrateStrategy:
    """Drain migration strategy (ref structs.go MigrateStrategy)."""
    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time_sec: float = 10.0
    healthy_deadline_sec: float = 300.0


@dataclass
class EphemeralDisk:
    sticky: bool = False
    size_mb: int = 300
    migrate: bool = False


@dataclass
class VolumeRequest:
    name: str = ""
    type: str = "host"        # host | csi
    source: str = ""
    read_only: bool = False
    access_mode: str = ""
    attachment_mode: str = ""
    per_alloc: bool = False


@dataclass
class VolumeMount:
    volume: str = ""
    destination: str = ""
    read_only: bool = False


@dataclass
class PeriodicConfig:
    """Cron-style launch config (ref structs.go PeriodicConfig)."""
    enabled: bool = False
    spec: str = ""
    spec_type: str = "cron"
    prohibit_overlap: bool = False
    timezone: str = "UTC"


@dataclass
class ParameterizedJobConfig:
    payload: str = "optional"     # optional | required | forbidden
    meta_required: list[str] = field(default_factory=list)
    meta_optional: list[str] = field(default_factory=list)


@dataclass
class DispatchPayloadConfig:
    file: str = ""


@dataclass
class TaskLifecycle:
    hook: str = ""                # prestart | poststart | poststop
    sidecar: bool = False


@dataclass
class TaskArtifact:
    getter_source: str = ""
    getter_options: dict[str, str] = field(default_factory=dict)
    relative_dest: str = ""


@dataclass
class Template:
    source_path: str = ""
    dest_path: str = ""
    embedded_tmpl: str = ""
    change_mode: str = "restart"   # restart | signal | noop
    change_signal: str = ""
    perms: str = "0644"


@dataclass
class Service:
    name: str = ""
    port_label: str = ""
    tags: list[str] = field(default_factory=list)
    checks: list[dict] = field(default_factory=list)
    connect: Optional[dict] = None
    provider: str = "builtin"      # builtin registry (consul-equivalent)


@dataclass
class LogConfig:
    max_files: int = 10
    max_file_size_mb: int = 10


@dataclass
class ScalingPolicy:
    min: int = 0
    max: int = 0
    enabled: bool = True
    policy: dict = field(default_factory=dict)
    type: str = "horizontal"


@dataclass
class Vault:
    """Task vault stanza (ref structs.go Vault): the policies the derived
    token carries and how the task reacts to token changes."""
    policies: list[str] = field(default_factory=list)
    env: bool = True                 # expose VAULT_TOKEN to the task
    change_mode: str = "restart"     # restart | signal | noop
    change_signal: str = ""
    namespace: str = ""


@dataclass
class Task:
    name: str = ""
    driver: str = ""
    user: str = ""
    config: dict = field(default_factory=dict)
    env: dict[str, str] = field(default_factory=dict)
    services: list[Service] = field(default_factory=list)
    resources: Resources = field(default_factory=Resources)
    meta: dict[str, str] = field(default_factory=dict)
    constraints: list[Constraint] = field(default_factory=list)
    affinities: list[Affinity] = field(default_factory=list)
    kill_timeout_sec: float = 5.0
    log_config: LogConfig = field(default_factory=LogConfig)
    artifacts: list[TaskArtifact] = field(default_factory=list)
    templates: list[Template] = field(default_factory=list)
    dispatch_payload: Optional[DispatchPayloadConfig] = None
    lifecycle: Optional[TaskLifecycle] = None
    volume_mounts: list[VolumeMount] = field(default_factory=list)
    leader: bool = False
    shutdown_delay_sec: float = 0.0
    kill_signal: str = ""
    vault: Optional[Vault] = None

    def copy(self) -> "Task":
        return dataclasses.replace(
            self,
            config=dict(self.config),
            env=dict(self.env),
            meta=dict(self.meta),
            services=list(self.services),
            resources=self.resources.copy(),
            constraints=[c.copy() for c in self.constraints],
            affinities=[a.copy() for a in self.affinities],
            artifacts=list(self.artifacts),
            templates=list(self.templates),
            volume_mounts=list(self.volume_mounts),
        )

    def is_prestart(self) -> bool:
        return self.lifecycle is not None and self.lifecycle.hook == "prestart"

    def is_poststart(self) -> bool:
        return self.lifecycle is not None and self.lifecycle.hook == "poststart"

    def is_poststop(self) -> bool:
        return self.lifecycle is not None and self.lifecycle.hook == "poststop"


@dataclass
class TaskGroup:
    name: str = ""
    count: int = 1
    constraints: list[Constraint] = field(default_factory=list)
    affinities: list[Affinity] = field(default_factory=list)
    spreads: list[Spread] = field(default_factory=list)
    tasks: list[Task] = field(default_factory=list)
    restart_policy: RestartPolicy = field(default_factory=RestartPolicy)
    reschedule_policy: Optional[ReschedulePolicy] = None
    update: Optional[UpdateStrategy] = None
    migrate: Optional[MigrateStrategy] = None
    networks: list[NetworkResource] = field(default_factory=list)
    services: list[Service] = field(default_factory=list)
    volumes: dict[str, VolumeRequest] = field(default_factory=dict)
    ephemeral_disk: EphemeralDisk = field(default_factory=EphemeralDisk)
    scaling: Optional[ScalingPolicy] = None
    stop_after_client_disconnect_sec: Optional[float] = None
    max_client_disconnect_sec: Optional[float] = None
    shutdown_delay_sec: float = 0.0
    meta: dict[str, str] = field(default_factory=dict)

    def copy(self) -> "TaskGroup":
        return dataclasses.replace(
            self,
            constraints=[c.copy() for c in self.constraints],
            affinities=[a.copy() for a in self.affinities],
            spreads=[s.copy() for s in self.spreads],
            tasks=[t.copy() for t in self.tasks],
            restart_policy=dataclasses.replace(self.restart_policy),
            reschedule_policy=(dataclasses.replace(self.reschedule_policy)
                               if self.reschedule_policy else None),
            update=dataclasses.replace(self.update) if self.update else None,
            migrate=dataclasses.replace(self.migrate) if self.migrate else None,
            networks=[n.copy() for n in self.networks],
            services=list(self.services),
            volumes=dict(self.volumes),
            meta=dict(self.meta),
        )

    def lookup_task(self, name: str) -> Optional[Task]:
        for t in self.tasks:
            if t.name == name:
                return t
        return None


@dataclass
class Multiregion:
    strategy: dict = field(default_factory=dict)
    regions: list[dict] = field(default_factory=list)


@dataclass
class Job:
    id: str = ""
    name: str = ""
    namespace: str = DEFAULT_NAMESPACE
    region: str = "global"
    type: str = JOB_TYPE_SERVICE
    priority: int = JOB_DEFAULT_PRIORITY
    all_at_once: bool = False
    datacenters: list[str] = field(default_factory=lambda: ["dc1"])
    constraints: list[Constraint] = field(default_factory=list)
    affinities: list[Affinity] = field(default_factory=list)
    spreads: list[Spread] = field(default_factory=list)
    task_groups: list[TaskGroup] = field(default_factory=list)
    update: Optional[UpdateStrategy] = None
    multiregion: Optional[Multiregion] = None
    periodic: Optional[PeriodicConfig] = None
    parameterized: Optional[ParameterizedJobConfig] = None
    dispatched: bool = False
    payload: bytes = b""
    meta: dict[str, str] = field(default_factory=dict)
    consul_token: str = ""
    vault_token: str = ""
    vault_namespace: str = ""
    nomad_token_id: str = ""

    stop: bool = False
    parent_id: str = ""
    status: str = JOB_STATUS_PENDING
    status_description: str = ""
    stable: bool = False
    version: int = 0
    submit_time: float = 0.0
    create_index: int = 0
    modify_index: int = 0
    job_modify_index: int = 0

    def copy(self) -> "Job":
        return dataclasses.replace(
            self,
            datacenters=list(self.datacenters),
            constraints=[c.copy() for c in self.constraints],
            affinities=[a.copy() for a in self.affinities],
            spreads=[s.copy() for s in self.spreads],
            task_groups=[tg.copy() for tg in self.task_groups],
            update=dataclasses.replace(self.update) if self.update else None,
            periodic=dataclasses.replace(self.periodic) if self.periodic else None,
            parameterized=(dataclasses.replace(self.parameterized)
                           if self.parameterized else None),
            meta=dict(self.meta),
        )

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def stopped(self) -> bool:
        return self.stop

    def is_periodic(self) -> bool:
        return self.periodic is not None and self.periodic.enabled

    def is_parameterized(self) -> bool:
        return self.parameterized is not None and not self.dispatched

    def has_update_strategy(self) -> bool:
        if self.type not in (JOB_TYPE_SERVICE,):
            return False
        for tg in self.task_groups:
            if tg.update is not None and tg.update.rolling():
                return True
        return False

    def ns_id(self) -> tuple[str, str]:
        return (self.namespace, self.id)


def alloc_name(job_id: str, group: str, index: int) -> str:
    """Canonical allocation name (ref structs.go AllocName)."""
    return f"{job_id}.{group}[{index}]"


def alloc_name_index(name: str) -> int:
    """Parse the trailing [index] out of an alloc name."""
    lb = name.rfind("[")
    rb = name.rfind("]")
    if lb == -1 or rb == -1 or rb < lb:
        return -1
    try:
        return int(name[lb + 1:rb])
    except ValueError:
        return -1
