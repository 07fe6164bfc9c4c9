"""FSM + replicated log (ref nomad/fsm.go:194 nomadFSM.Apply and
hashicorp/raft usage in nomad/server.go:1221).

The FSM applies typed log messages to the state store. The log abstraction
(`RaftLog`) assigns monotonically increasing indexes and (in the single-node
implementation) applies synchronously; a multi-node consensus backend slots
in behind the same `apply()` contract over DCN (SURVEY.md §2.7: consensus is
a control-plane-host protocol, not a TPU workload).

Snapshots (checkpoint/resume, SURVEY.md §5): pickle the state store tables +
last index; restore rebuilds indexes.
"""
from __future__ import annotations

import dataclasses
import pickle
import threading
from collections import OrderedDict
from typing import Callable, Optional

from ..state import StateStore
from ..structs import (
    Allocation, Deployment, DeploymentStatusUpdate, Evaluation, Job, Node,
    SchedulerConfiguration,
)

# message types (ref nomad/structs.go MessageType consts / fsm.go:211-307)
NODE_REGISTER = "NodeRegisterRequestType"
NODE_DEREGISTER = "NodeDeregisterRequestType"
NODE_UPDATE_STATUS = "NodeUpdateStatusRequestType"
NODE_UPDATE_DRAIN = "NodeUpdateDrainRequestType"
NODE_UPDATE_ELIGIBILITY = "NodeUpdateEligibilityRequestType"
JOB_REGISTER = "JobRegisterRequestType"
JOB_DEREGISTER = "JobDeregisterRequestType"
EVAL_UPDATE = "EvalUpdateRequestType"
EVAL_DELETE = "EvalDeleteRequestType"
ALLOC_CLIENT_UPDATE = "AllocClientUpdateRequestType"
ALLOC_UPDATE_DESIRED_TRANSITION = "AllocUpdateDesiredTransitionRequestType"
APPLY_PLAN_RESULTS = "ApplyPlanResultsRequestType"
# a coalesced commit batch: N verified plan results in ONE log entry (one
# encode, one replication round, one FSM apply) — applied strictly in list
# order so replay equals the serial one-entry-per-plan sequence
APPLY_PLAN_RESULTS_BATCH = "ApplyPlanResultsBatchRequestType"
DEPLOYMENT_STATUS_UPDATE = "DeploymentStatusUpdateRequestType"
DEPLOYMENT_PROMOTE = "DeploymentPromoteRequestType"
DEPLOYMENT_ALLOC_HEALTH = "DeploymentAllocHealthRequestType"
SCHEDULER_CONFIG = "SchedulerConfigRequestType"
PERIODIC_LAUNCH = "PeriodicLaunchRequestType"
BATCH_NODE_UPDATE_DRAIN = "BatchNodeUpdateDrainRequestType"
# one heartbeat-sweep's expired nodes flipped down in ONE log entry
# (ISSUE 10): a 10%-of-the-fleet partition costs ceil(K/rate-cap) raft
# rounds instead of K — the batch applies under one store lock hold so
# blocking readers see whole sweeps, never a half-marked storm
BATCH_NODE_UPDATE_STATUS = "BatchNodeUpdateStatusRequestType"
DEPLOYMENT_DELETE = "DeploymentDeleteRequestType"
ACL_POLICY_UPSERT = "ACLPolicyUpsertRequestType"
ACL_POLICY_DELETE = "ACLPolicyDeleteRequestType"
ACL_TOKEN_UPSERT = "ACLTokenUpsertRequestType"
ACL_TOKEN_DELETE = "ACLTokenDeleteRequestType"
ACL_TOKEN_BOOTSTRAP = "ACLTokenBootstrapRequestType"
NAMESPACE_UPSERT = "NamespaceUpsertRequestType"
NAMESPACE_DELETE = "NamespaceDeleteRequestType"
SCALING_EVENT_REGISTER = "ScalingEventRegisterRequestType"
JOB_STABILITY = "JobStabilityRequestType"
RECONCILE_SUMMARIES = "ReconcileJobSummariesRequestType"
CSI_VOLUME_REGISTER = "CSIVolumeRegisterRequestType"
CSI_VOLUME_DEREGISTER = "CSIVolumeDeregisterRequestType"
CSI_VOLUME_CLAIM = "CSIVolumeClaimRequestType"
AUTOPILOT_CONFIG = "AutopilotRequestType"
SERVICE_REGISTER = "ServiceRegistrationUpsertRequestType"
SERVICE_DEREGISTER = "ServiceRegistrationDeleteRequestType"
INTENTION_UPSERT = "ServiceIntentionUpsertRequestType"
INTENTION_DELETE = "ServiceIntentionDeleteRequestType"


@dataclasses.dataclass
class PlanApplyRequest:
    """ApplyPlanResultsRequest (ref structs.go) — what the plan applier
    commits through the log."""
    alloc_updates: list = dataclasses.field(default_factory=list)
    alloc_placements: list = dataclasses.field(default_factory=list)
    alloc_preemptions: list = dataclasses.field(default_factory=list)
    deployment: Optional[Deployment] = None
    deployment_updates: list = dataclasses.field(default_factory=list)
    eval_id: str = ""


class NomadFSM:
    """ref nomad/fsm.go:194"""

    def __init__(self, state: Optional[StateStore] = None):
        self.state = state or StateStore()
        # callbacks fired after specific message types commit (e.g. the
        # leader enqueues evals into the broker, ref fsm.go:760)
        self.on_eval_update: list[Callable[[list[Evaluation]], None]] = []
        # fired after plan results apply (ISSUE 6 warm standby): a
        # FOLLOWER feeds its passive solver state-cache twin from here,
        # so promotion finds the device tensors already current. Best-
        # effort: a callback failure must never fail the FSM apply
        self.on_plan_apply: list[Callable[[int], None]] = []
        # apply_batch deferral buffer (ISSUE 20): while a batched apply
        # window is open, eval/plan callbacks collect here and fire once
        # after the store lock drops. Only the single applier thread
        # opens windows, so a plain attribute suffices.
        self._defer: Optional[tuple[list, list]] = None

    def apply(self, index: int, msg_type: str, payload: dict) -> object:
        """ref fsm.go:194 Apply (type switch :211-307)"""
        s = self.state
        # RPC write-dedup ack (ISSUE 18): an entry stamped by
        # rpc/dedup.stamp() records (token -> index) into the replicated
        # table on EVERY server as part of the same apply — a failover
        # cannot forget the ack. `.get`, never `.pop`: this payload dict
        # is aliased by the in-memory raft log entry and WAL, and
        # stripping the stamp here would desync followers and replays.
        tok = payload.get("_dedup") if isinstance(payload, dict) else None
        if tok is not None:
            s.record_rpc_dedup(index, tok)
        if msg_type == NODE_REGISTER:
            s.upsert_node(index, payload["node"])
        elif msg_type == NODE_DEREGISTER:
            s.delete_node(index, payload["node_ids"])
        elif msg_type == NODE_UPDATE_STATUS:
            # replay determinism (ISSUE 13): applying a log entry must
            # be a pure function of the entry — a wall-clock default
            # here would re-stamp a DIFFERENT time when the entry
            # re-applies after a restart, so restored state silently
            # diverged from the state the cluster acked. Every emitter
            # stamps updated_at explicitly (PR-10 satellite).
            s.update_node_status(index, payload["node_id"], payload["status"],
                                 payload.get("updated_at", 0.0))
        elif msg_type == NODE_UPDATE_DRAIN:
            s.update_node_drain(index, payload["node_id"], payload.get("drain"),
                                payload.get("mark_eligible", False))
        elif msg_type == BATCH_NODE_UPDATE_STATUS:
            s.update_node_status_batch(index, payload["node_ids"],
                                       payload["status"],
                                       payload.get("updated_at", 0.0))
            # the batch's deduped replacement evals ride the SAME entry
            # (the JOB_REGISTER shape): status flip + evals commit
            # atomically, so neither a crash nor a leadership loss
            # between two entries can strand down nodes with no evals
            evs = payload.get("evals") or []
            if evs:
                s.upsert_evals(index, evs)
                self._notify_evals(evs)
        elif msg_type == BATCH_NODE_UPDATE_DRAIN:
            for node_id, drain in payload["updates"].items():
                s.update_node_drain(index, node_id, drain,
                                    payload.get("mark_eligible", False))
        elif msg_type == NODE_UPDATE_ELIGIBILITY:
            s.update_node_eligibility(index, payload["node_id"],
                                      payload["eligibility"],
                                      payload.get("flap_until"))
        elif msg_type == JOB_REGISTER:
            s.upsert_job(index, payload["job"])
            evs = payload.get("evals") or []
            if evs:
                s.upsert_evals(index, evs)
                self._notify_evals(evs)
        elif msg_type == JOB_DEREGISTER:
            if payload.get("purge"):
                s.delete_job(index, payload["namespace"], payload["job_id"])
            else:
                job = s.job_by_id(payload["namespace"], payload["job_id"])
                if job is not None:
                    job = job.copy()
                    job.stop = True
                    s.upsert_job(index, job)
            evs = payload.get("evals") or []
            if evs:
                s.upsert_evals(index, evs)
                self._notify_evals(evs)
        elif msg_type == EVAL_UPDATE:
            evs = payload["evals"]
            s.upsert_evals(index, evs)
            self._notify_evals(evs)
        elif msg_type == EVAL_DELETE:
            s.delete_evals(index, payload["eval_ids"],
                           payload.get("alloc_ids", []))
        elif msg_type == ALLOC_CLIENT_UPDATE:
            from ..obs import timing
            with timing.timed("nomad.fsm.alloc_client_update", "fsm.apply",
                              index=index, type="alloc_client_update",
                              allocs=len(payload["allocs"])) as sp:
                sp.annotate(jobs=s.update_allocs_from_client(
                    index, payload["allocs"]))
        elif msg_type == ALLOC_UPDATE_DESIRED_TRANSITION:
            s.update_alloc_desired_transitions(
                index, payload["transitions"], payload.get("evals", []))
            self._notify_evals(payload.get("evals", []))
        elif msg_type == APPLY_PLAN_RESULTS:
            from ..obs import trace
            with trace.span("fsm.apply", index=index, plans=1):
                s.upsert_plan_results(index, payload["result"])
            self._notify_plan_apply(index)
        elif msg_type == APPLY_PLAN_RESULTS_BATCH:
            # per-plan order within the entry IS commit order; every plan
            # of the batch shares the entry's index, and the store applies
            # them under ONE lock hold so a blocking reader that observes
            # the index always sees the WHOLE entry (serial-path parity).
            # The fsm.apply span nests under the applier's shared
            # plan.commit span (same thread); a follower's replicated
            # apply has no trace context and records nothing.
            from ..obs import trace
            with trace.span("fsm.apply", index=index,
                            plans=len(payload["results"])):
                s.upsert_plan_results_batch(index, payload["results"])
            self._notify_plan_apply(index)
        elif msg_type == DEPLOYMENT_STATUS_UPDATE:
            s.update_deployment_status(index, payload["update"],
                                       payload.get("job"),
                                       payload.get("eval"))
            if payload.get("eval"):
                self._notify_evals([payload["eval"]])
        elif msg_type == DEPLOYMENT_PROMOTE:
            s.update_deployment_promotion(index, payload["deployment_id"],
                                          payload.get("groups"))
            if payload.get("eval"):
                s.upsert_evals(index, [payload["eval"]])
                self._notify_evals([payload["eval"]])
        elif msg_type == DEPLOYMENT_ALLOC_HEALTH:
            # timestamp default 0.0, not time.time(): restart replay
            # must reproduce the originally-applied state bit-for-bit
            # (the watcher always stamps from its injectable clock)
            s.update_deployment_alloc_health(
                index, payload["deployment_id"],
                payload.get("healthy", []), payload.get("unhealthy", []),
                payload.get("timestamp", 0.0))
            if payload.get("eval"):
                s.upsert_evals(index, [payload["eval"]])
                self._notify_evals([payload["eval"]])
        elif msg_type == DEPLOYMENT_DELETE:
            s.delete_deployments(index, payload["deployment_ids"])
        elif msg_type == SCHEDULER_CONFIG:
            s.set_scheduler_config(index, payload["config"])
        elif msg_type == PERIODIC_LAUNCH:
            s.upsert_periodic_launch(index, payload["namespace"],
                                     payload["job_id"], payload["launch"])
        elif msg_type == ACL_POLICY_UPSERT:
            s.upsert_acl_policies(index, payload["policies"])
        elif msg_type == ACL_POLICY_DELETE:
            s.delete_acl_policies(index, payload["names"])
        elif msg_type in (ACL_TOKEN_UPSERT, ACL_TOKEN_BOOTSTRAP):
            s.upsert_acl_tokens(index, payload["tokens"])
        elif msg_type == ACL_TOKEN_DELETE:
            s.delete_acl_tokens(index, payload["accessor_ids"])
        elif msg_type == NAMESPACE_UPSERT:
            s.upsert_namespaces(index, payload["namespaces"])
        elif msg_type == NAMESPACE_DELETE:
            s.delete_namespaces(index, payload["names"])
        elif msg_type == SCALING_EVENT_REGISTER:
            s.upsert_scaling_event(index, payload["namespace"],
                                   payload["job_id"], payload["group"],
                                   payload["event"])
        elif msg_type == RECONCILE_SUMMARIES:
            s.reconcile_job_summaries(index)
        elif msg_type == JOB_STABILITY:
            s.update_job_stability(index, payload["namespace"],
                                   payload["job_id"], payload["version"],
                                   payload["stable"])
        elif msg_type == CSI_VOLUME_REGISTER:
            for vol in payload["volumes"]:
                s.upsert_csi_volume(index, vol)
        elif msg_type == CSI_VOLUME_DEREGISTER:
            s.delete_csi_volume(index, payload["namespace"],
                                payload["volume_id"],
                                payload.get("force", False))
        elif msg_type == CSI_VOLUME_CLAIM:
            s.csi_volume_claim(index, payload["namespace"],
                               payload["volume_id"], payload["claim"])
        elif msg_type == AUTOPILOT_CONFIG:
            s.set_autopilot_config(index, payload["config"])
        elif msg_type == SERVICE_REGISTER:
            s.upsert_service_registrations(index, payload["services"])
        elif msg_type == SERVICE_DEREGISTER:
            s.delete_service_registrations(
                index, payload.get("alloc_id", ""), payload.get("keys"))
        elif msg_type == INTENTION_UPSERT:
            s.upsert_intention(index, payload["intention"])
        elif msg_type == INTENTION_DELETE:
            s.delete_intention(index, payload["namespace"],
                               payload["source"], payload["destination"])
        else:
            raise ValueError(f"unknown message type {msg_type!r}")
        return None

    def apply_batch(self, items: list, on_error=None) -> None:
        """Apply N contiguous committed entries as ONE window (ISSUE 20
        group commit): one store write-lock hold, one snapshot-memo
        displacement cycle, one event-broker publish batch, one
        blocking-query wakeup — instead of N of each. Entry order
        inside the window IS log order, so replay equals the serial
        per-entry sequence bit for bit.

        Broker/standby callbacks (`on_eval_update`, `on_plan_apply`)
        are DEFERRED and fired once per window after the store lock
        drops: firing them under the held lock would mint new
        store->broker lock edges for the whole-program lock-order lint
        to choke on, and the serial path never ran them under the lock
        either. `on_error(index, exc)` preserves the applier's
        per-entry error isolation — one malformed entry must not drop
        its batch-mates. Caller contract: ONE applier thread opens
        windows at a time (RaftNode._run_apply is strictly serial)."""
        if not items:
            return
        deferred: tuple[list, list] = ([], [])
        self._defer = deferred
        try:
            with self.state.batch_window():
                for index, msg_type, payload in items:
                    try:
                        self.apply(index, msg_type, payload)
                    except Exception as ex:   # noqa: BLE001
                        if on_error is None:
                            raise
                        on_error(index, ex)
        finally:
            self._defer = None
        evals, plan_indexes = deferred
        if evals:
            for cb in self.on_eval_update:
                cb(evals)
        for idx in plan_indexes:
            self._notify_plan_apply(idx)

    def _notify_evals(self, evals: list[Evaluation]) -> None:
        if self._defer is not None:
            self._defer[0].extend(evals)
            return
        for cb in self.on_eval_update:
            cb(evals)

    def _notify_plan_apply(self, index: int) -> None:
        if self._defer is not None:
            self._defer[1].append(index)
            return
        for cb in self.on_plan_apply:
            try:
                cb(index)
            except Exception as e:      # noqa: BLE001 — standby feed is
                from ..metrics import record_swallowed_error   # telemetry
                record_swallowed_error("fsm.on_plan_apply", e)

    # ------------------------------------------------------ snapshot/restore

    def snapshot_bytes(self) -> bytes:
        """ref fsm.go Snapshot/Persist"""
        s = self.state
        with s._lock:
            blob = {
                "index": s._index,
                "table_index": dict(s._table_index),
                "nodes": s.nodes, "jobs": s.jobs,
                "job_versions": s.job_versions,
                "job_summaries": s.job_summaries,
                "evals": s.evals, "allocs": s.allocs,
                "deployments": s.deployments,
                "periodic_launches": s.periodic_launches,
                "scheduler_config": s.scheduler_config,
                "namespaces": s.namespaces,
                "acl_policies": s.acl_policies,
                "acl_tokens": s.acl_tokens,
                "scaling_policies": s.scaling_policies,
                "scaling_policy_by_target": s._scaling_policy_by_target,
                "scaling_events": s.scaling_events,
                "csi_volumes": s.csi_volumes,
                "csi_plugins": s.csi_plugins,
                "autopilot_config": s.autopilot_config,
                "services": s.services,
                "intentions": s.intentions,
                "rpc_dedup": s.rpc_dedup,
            }
            return pickle.dumps(blob)

    def restore_bytes(self, data: bytes) -> None:
        """ref fsm.go Restore"""
        blob = pickle.loads(data)
        s = self.state
        with s._lock:
            s._index = blob["index"]
            s._table_index = dict(blob["table_index"])
            s.nodes = dict(blob["nodes"])
            s.jobs = dict(blob["jobs"])
            s.job_versions = dict(blob["job_versions"])
            s.job_summaries = dict(blob["job_summaries"])
            s.evals = dict(blob["evals"])
            s.allocs = dict(blob["allocs"])
            s.deployments = dict(blob["deployments"])
            s.periodic_launches = dict(blob["periodic_launches"])
            s.scheduler_config = blob["scheduler_config"]
            s.namespaces = dict(blob["namespaces"])
            s.acl_policies = dict(blob.get("acl_policies", {}))
            s.acl_tokens = dict(blob.get("acl_tokens", {}))
            s.scaling_policies = dict(blob.get("scaling_policies", {}))
            s._scaling_policy_by_target = dict(
                blob.get("scaling_policy_by_target", {}))
            s.scaling_events = dict(blob.get("scaling_events", {}))
            s.csi_volumes = dict(blob.get("csi_volumes", {}))
            s.csi_plugins = dict(blob.get("csi_plugins", {}))
            s.autopilot_config = dict(
                blob.get("autopilot_config", s.autopilot_config))
            s.services = dict(blob.get("services", {}))
            s.intentions = dict(blob.get("intentions", {}))
            # .get: snapshots from before ISSUE 18 carry no dedup table
            s.rpc_dedup = OrderedDict(blob.get("rpc_dedup", {}))
            s._acl_token_by_secret = {
                t.secret_id: t.accessor_id for t in s.acl_tokens.values()}
            # rebuild secondary indexes
            s._allocs_by_node.clear()
            s._allocs_by_job.clear()
            s._allocs_by_eval.clear()
            s._evals_by_job.clear()
            for alloc in s.allocs.values():
                s._index_alloc(alloc)
            for ev in s.evals.values():
                s._index_eval(ev)
            s.usage.rebuild(s.nodes.values(), s.allocs.values())
            s._snap_memo = None     # restore bypasses _bump: drop the
            s._cond.notify_all()    # shared snapshot memo explicitly


class RaftLog:
    """Single-node replicated log: serial apply with index assignment.

    The contract multi-node consensus must keep: apply() returns only after
    the message is durably committed and visible in the FSM's state store at
    the returned index."""

    def __init__(self, fsm: NomadFSM):
        self.fsm = fsm
        self._lock = threading.Lock()
        self._index = fsm.state.latest_index()
        # single-node leadership epoch: never changes in normal operation
        # (a single-node log cannot be deposed), but the fence machinery
        # is exercised end-to-end — restore() bumps it, matching the one
        # event that invalidates prepared writes here (docs/FAILOVER.md)
        self._fence = 0

    def fence_token(self) -> Optional[int]:
        """Single-node twin of RaftNode.fence_token (ISSUE 6)."""
        with self._lock:
            return self._fence

    def quorum_fresh(self, window: Optional[float] = None) -> bool:
        """Single-node twin of RaftNode.quorum_fresh (ISSUE 18): a
        single-node log cannot be deposed, so its local state is always
        current and fast-path acks from it are always safe."""
        return True

    def apply(self, msg_type: str, payload: dict,
              timeout: float = 30.0, fence: Optional[int] = None) -> int:
        # `timeout` mirrors the multi-server RaftNode.apply budget (the
        # coalescing applier threads its per-BATCH remaining budget
        # through); the single-node log commits synchronously, so there
        # is nothing to wait on here.
        from .. import faults
        faults.fire("raft.apply")
        # idempotency stamp (ISSUE 18): if this thread is dispatching a
        # dedup-tokened RPC, the token rides THIS entry's payload so the
        # ack commits atomically with the write (rpc/dedup.py)
        from ..rpc import dedup as rpc_dedup
        payload = rpc_dedup.stamp(payload)
        # the lock spans index assignment AND application so state-store
        # mutations happen in strict log order (replay determinism)
        with self._lock:
            if fence is not None and fence != self._fence:
                from ..rpc.codec import FencedWriteError
                from ..metrics import metrics
                from ..obs import trace
                metrics.incr("nomad.raft.fence_rejected")
                trace.annotate(fence_rejected=True, fence_expected=fence,
                               fence_current=self._fence)
                raise FencedWriteError(self._fence, fence)
            self._index += 1
            index = self._index
            # attribute the assigned log index onto whatever span is in
            # flight (the applier's plan.commit span) — ISSUE 7
            from ..obs import trace
            trace.annotate(raft_index=index)
            self.fsm.apply(index, msg_type, payload)
            return index

    def barrier(self) -> int:
        """Latest committed index (leader barrier analog)."""
        with self._lock:
            return self._index

    def snapshot(self) -> bytes:
        return self.fsm.snapshot_bytes()

    def restore(self, data: bytes) -> None:
        self.fsm.restore_bytes(data)
        with self._lock:
            self._index = self.fsm.state.latest_index()
            # a restore replaces the world under any prepared write —
            # the single-node analog of losing leadership mid-batch
            self._fence += 1
