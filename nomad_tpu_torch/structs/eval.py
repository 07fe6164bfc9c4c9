"""Evaluation model (ref nomad/structs/structs.go:10341).

An Evaluation is the unit of scheduler work: "something changed for job J,
re-assess its allocations". Evals flow through the EvalBroker to scheduler
workers and result in Plans.
"""
from __future__ import annotations

import dataclasses
import os
import uuid
from dataclasses import dataclass, field
from typing import Optional

EVAL_STATUS_BLOCKED = "blocked"
EVAL_STATUS_PENDING = "pending"
EVAL_STATUS_COMPLETE = "complete"
EVAL_STATUS_FAILED = "failed"
EVAL_STATUS_CANCELLED = "canceled"

TRIGGER_JOB_REGISTER = "job-register"
TRIGGER_JOB_DEREGISTER = "job-deregister"
TRIGGER_PERIODIC_JOB = "periodic-job"
TRIGGER_NODE_DRAIN = "node-drain"
TRIGGER_NODE_UPDATE = "node-update"
TRIGGER_ALLOC_STOP = "alloc-stop"
TRIGGER_SCHEDULED = "scheduled"
TRIGGER_ROLLING_UPDATE = "rolling-update"
TRIGGER_DEPLOYMENT_WATCHER = "deployment-watcher"
TRIGGER_FAILED_FOLLOW_UP = "failed-follow-up"
TRIGGER_MAX_PLANS = "max-plan-attempts"
TRIGGER_RETRY_FAILED_ALLOC = "alloc-failure"
TRIGGER_QUEUED_ALLOCS = "queued-allocs"
TRIGGER_PREEMPTION = "preemption"
TRIGGER_SCALING = "job-scaling"
TRIGGER_MAX_DISCONNECT = "max-disconnect-timeout"
TRIGGER_RECONNECT = "reconnect"

CORE_JOB_EVAL_GC = "eval-gc"
CORE_JOB_NODE_GC = "node-gc"
CORE_JOB_JOB_GC = "job-gc"
CORE_JOB_DEPLOYMENT_GC = "deployment-gc"
CORE_JOB_CSI_VOLUME_CLAIM_GC = "csi-volume-claim-gc"
CORE_JOB_FAILED_EVAL_REAP = "failed-eval-reap"
CORE_JOB_FORCE_GC = "force-gc"


def new_id() -> str:
    """Random UUIDv4-format id. Hand-formatted from urandom: ~7x faster
    than uuid.uuid4()+str, which matters when a 50k-alloc plan mints 50k
    ids inside the placement loop (ref helper/uuid/uuid.go Generate, which
    is likewise a raw-bytes formatter for the same reason)."""
    h = os.urandom(16).hex()
    return (f"{h[:8]}-{h[8:12]}-4{h[13:16]}-"
            f"{'89ab'[int(h[16], 16) & 3]}{h[17:20]}-{h[20:]}")


def new_ids(n: int) -> list[str]:
    """n random ids from ONE urandom read — the mass-placement path mints
    ids in batch to avoid n getrandom syscalls. The native formatter
    (native/allocstamp.c format_uuids) writes each ascii string directly
    (~50ns/id vs ~1.6us for the slicing formatter below)."""
    from .fastbatch import _load_native
    native = _load_native()
    if native:
        return native.format_uuids(os.urandom(16 * n), n)
    h = os.urandom(16 * n).hex()
    vr = "89ab"
    return [f"{s[:8]}-{s[8:12]}-4{s[13:16]}-"
            f"{vr[int(s[16], 16) & 3]}{s[17:20]}-{s[20:]}"
            for s in (h[i:i + 32] for i in range(0, 32 * n, 32))]


@dataclass
class Evaluation:
    id: str = field(default_factory=new_id)
    namespace: str = "default"
    priority: int = 50
    type: str = "service"            # scheduler type = job type
    triggered_by: str = TRIGGER_JOB_REGISTER
    job_id: str = ""
    job_modify_index: int = 0
    node_id: str = ""
    node_modify_index: int = 0
    deployment_id: str = ""
    status: str = EVAL_STATUS_PENDING
    status_description: str = ""

    wait_sec: float = 0.0            # broker initial delay
    wait_until_unix: float = 0.0     # delayed eval absolute time
    # enqueue TTL (ISSUE 8): stamped by the broker from the hot-reloadable
    # eval_deadline_s config unless the creator set one; 0 = no deadline.
    # Workers drop expired evals BEFORE the solve; the plan applier
    # rejects past-deadline plans before they cost a raft round.
    deadline_unix: float = 0.0

    next_eval: str = ""
    previous_eval: str = ""
    blocked_eval: str = ""
    related_evals: list[str] = field(default_factory=list)

    # Blocked-eval bookkeeping (ref structs.go Evaluation + blocked_evals.go)
    class_eligibility: dict[str, bool] = field(default_factory=dict)
    quota_limit_reached: str = ""
    escaped_computed_class: bool = False

    failed_tg_allocs: dict[str, object] = field(default_factory=dict)  # tg -> AllocMetric
    queued_allocations: dict[str, int] = field(default_factory=dict)   # tg -> count
    # how many failed-follow-up generations precede this eval — drives
    # the reaper's capped exponential backoff (ISSUE 3 lifecycle)
    failed_follow_ups: int = 0
    annotate_plan: bool = False
    leader_ack: str = ""             # broker token for ack/nack

    snapshot_index: int = 0
    create_index: int = 0
    modify_index: int = 0
    create_time_unix: float = 0.0
    modify_time_unix: float = 0.0

    def copy(self) -> "Evaluation":
        return dataclasses.replace(
            self,
            related_evals=list(self.related_evals),
            class_eligibility=dict(self.class_eligibility),
            failed_tg_allocs=dict(self.failed_tg_allocs),
            queued_allocations=dict(self.queued_allocations),
        )

    def terminal_status(self) -> bool:
        return self.status in (EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED,
                               EVAL_STATUS_CANCELLED)

    def should_enqueue(self) -> bool:
        return self.status == EVAL_STATUS_PENDING

    def should_block(self) -> bool:
        return self.status == EVAL_STATUS_BLOCKED

    def make_plan(self, job) -> "Plan":
        from .plan import Plan
        return Plan(
            eval_id=self.id,
            priority=(job.priority if job else self.priority),
            job=job,
            all_at_once=(job.all_at_once if job else False),
            deadline_unix=self.deadline_unix,
        )

    def create_blocked_eval(self, classes: dict[str, bool], escaped: bool,
                            quota: str, failed_tg_allocs=None) -> "Evaluation":
        """Blocked-eval follow-up when placements fail
        (ref structs.go CreateBlockedEval)."""
        return Evaluation(
            namespace=self.namespace,
            priority=self.priority,
            type=self.type,
            triggered_by=TRIGGER_QUEUED_ALLOCS,
            job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=EVAL_STATUS_BLOCKED,
            previous_eval=self.id,
            class_eligibility=dict(classes),
            escaped_computed_class=escaped,
            quota_limit_reached=quota,
            failed_tg_allocs=dict(failed_tg_allocs or {}),
        )

    def create_failed_follow_up_eval(self, wait_sec: float) -> "Evaluation":
        return Evaluation(
            namespace=self.namespace,
            priority=self.priority,
            type=self.type,
            triggered_by=TRIGGER_FAILED_FOLLOW_UP,
            job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=EVAL_STATUS_PENDING,
            wait_sec=wait_sec,
            previous_eval=self.id,
            failed_follow_ups=self.failed_follow_ups + 1,
        )
