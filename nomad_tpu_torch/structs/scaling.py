"""Scaling policy state model (ref nomad/structs/structs.go ScalingPolicy
and ScalingEvent; state table ref nomad/state/schema.go scaling_policy /
scaling_event tables).

The jobspec-side `scaling` block (structs/job.py ScalingPolicy) is the ask;
these are the server-side records: a policy row per task group target kept in
the state store, and an event trail per (job, group) recording every scale
action (ref nomad/structs/structs.go JobScaleStatus).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import uuid

from .eval import new_id

SCALING_TARGET_NAMESPACE = "Namespace"
SCALING_TARGET_JOB = "Job"
SCALING_TARGET_GROUP = "Group"

SCALING_POLICY_TYPE_HORIZONTAL = "horizontal"

# cap on retained scaling events per task group
# (ref nomad/structs/structs.go JobTrackedScalingEvents)
JOB_TRACKED_SCALING_EVENTS = 20


@dataclass
class ScalingPolicyState:
    """A stored scaling policy row (ref structs.go ScalingPolicy)."""
    id: str = field(default_factory=new_id)
    type: str = SCALING_POLICY_TYPE_HORIZONTAL
    target: dict[str, str] = field(default_factory=dict)
    min: int = 0
    max: int = 0
    policy: dict = field(default_factory=dict)
    enabled: bool = True
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "ScalingPolicyState":
        return dataclasses.replace(
            self, target=dict(self.target), policy=dict(self.policy))

    def target_key(self) -> tuple[str, str, str]:
        return (self.target.get(SCALING_TARGET_NAMESPACE, ""),
                self.target.get(SCALING_TARGET_JOB, ""),
                self.target.get(SCALING_TARGET_GROUP, ""))


def policy_from_group(job, tg) -> "ScalingPolicyState | None":
    """Lower a task group's jobspec scaling block into a stored policy row
    (ref structs.go TaskGroup.GetScalingPolicies)."""
    if tg.scaling is None:
        return None
    # deterministic id: policy rows are created inside FSM apply, so a
    # random uuid would diverge across raft replicas/replays
    pid = str(uuid.uuid5(uuid.NAMESPACE_OID,
                         f"scaling/{job.namespace}/{job.id}/{tg.name}"))
    return ScalingPolicyState(
        id=pid,
        type=tg.scaling.type or SCALING_POLICY_TYPE_HORIZONTAL,
        target={
            SCALING_TARGET_NAMESPACE: job.namespace,
            SCALING_TARGET_JOB: job.id,
            SCALING_TARGET_GROUP: tg.name,
        },
        min=tg.scaling.min,
        max=tg.scaling.max,
        policy=dict(tg.scaling.policy),
        enabled=tg.scaling.enabled,
    )


@dataclass
class ScalingEvent:
    """One scale action on a task group (ref structs.go ScalingEvent)."""
    time: float = 0.0
    count: int | None = None
    previous_count: int = 0
    message: str = ""
    error: bool = False
    meta: dict = field(default_factory=dict)
    eval_id: str = ""
    create_index: int = 0

    def copy(self) -> "ScalingEvent":
        return dataclasses.replace(self, meta=dict(self.meta))
