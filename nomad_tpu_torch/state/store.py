"""In-memory MVCC state store (ref nomad/state/state_store.go, schema.go).

Design: every stored object is treated as immutable once inserted — writers
insert fresh copies stamped with a monotonically increasing raft-style index,
so a snapshot is just a shallow copy of the table dicts taken under the write
lock. That gives the two correctness properties the scheduler hinges on
(SURVEY.md §7.2):

  * `snapshot()` — a point-in-time, never-changing view (memdb MVCC analog);
  * `snapshot_min_index(i)` — block until the store has applied index >= i,
    then snapshot (ref nomad/worker.go:536, plan_apply.go:184).

Blocking queries are built on one condition variable broadcast per commit
(watch-set analog of go-memdb). Secondary indexes (allocs by node/job/eval,
evals by job) are plain dicts maintained transactionally with the write lock.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, Iterable, Optional

from .usage_index import UsageIndex

from ..metrics import record_swallowed_error
from ..structs import (
    Allocation, Deployment, Evaluation, Job, Node, SchedulerConfiguration,
    ALLOC_CLIENT_LOST, ALLOC_CLIENT_FAILED, ALLOC_CLIENT_RUNNING,
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_PENDING, ALLOC_CLIENT_UNKNOWN,
    ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT,
    EVAL_STATUS_BLOCKED, JOB_STATUS_DEAD, JOB_STATUS_PENDING,
    JOB_STATUS_RUNNING, JOB_TYPE_SERVICE, JOB_TYPE_SYSTEM, JOB_TYPE_SYSBATCH,
    NODE_STATUS_DOWN,
)
from ..structs.summary import JobSummary, TaskGroupSummary

# replicated dedup-ack LRU bound (ISSUE 18): sized to out-live any
# client's retry window at chaos write rates while keeping the snapshot
# blob contribution trivial (token + int per entry)
RPC_DEDUP_CAP = 4096


class StateStore:
    def __init__(self):
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._index = 0                       # latest applied index
        self._table_index: dict[str, int] = {}

        # primary tables: key -> object
        self.nodes: dict[str, Node] = {}
        self.jobs: dict[tuple[str, str], Job] = {}            # (ns, id)
        self.job_versions: dict[tuple[str, str, int], Job] = {}
        self.job_summaries: dict[tuple[str, str], JobSummary] = {}
        self.evals: dict[str, Evaluation] = {}
        self.allocs: dict[str, Allocation] = {}
        self.deployments: dict[str, Deployment] = {}
        self.periodic_launches: dict[tuple[str, str], dict] = {}
        self.scheduler_config: SchedulerConfiguration = SchedulerConfiguration()
        self.namespaces: dict[str, dict] = {"default": {"name": "default"}}
        self.acl_policies: dict[str, object] = {}          # name -> ACLPolicy
        self.acl_tokens: dict[str, object] = {}            # accessor -> token
        self._acl_token_by_secret: dict[str, str] = {}     # secret -> accessor
        # scaling (ref nomad/state/schema.go scaling_policy/scaling_event)
        self.scaling_policies: dict[str, object] = {}      # id -> policy
        self._scaling_policy_by_target: dict[tuple, str] = {}
        self.scaling_events: dict[tuple[str, str], dict[str, list]] = {}
        # CSI (ref schema.go csi_volumes/csi_plugins)
        self.csi_volumes: dict[tuple[str, str], object] = {}  # (ns, id)
        self.csi_plugins: dict[str, object] = {}              # plugin id
        # native service catalog (the consul-integration redesign;
        # ref nomad/state service_registration table in later lines)
        self.services: dict[tuple[str, str, str], object] = {}
        # mesh authorization rules keyed (ns, source, destination)
        self.intentions: dict[tuple[str, str, str], object] = {}
        # autopilot (ref nomad/state/autopilot.go AutopilotConfig)
        self.autopilot_config: dict = {
            "CleanupDeadServers": True,
            "LastContactThresholdSec": 10.0,
            "ServerStabilizationTimeSec": 10.0,
        }
        # replicated RPC write-dedup acks (ISSUE 18): token -> commit
        # index, LRU-bounded. Written by the FSM when a raft entry
        # carries a `_dedup` stamp, so EVERY server (and a restored
        # snapshot) remembers which client requests already committed —
        # the failover half of rpc/dedup.py (the leader-local result
        # cache holds the full result blobs).
        self.rpc_dedup: "OrderedDict[str, int]" = OrderedDict()

        # secondary indexes
        self._allocs_by_node: dict[str, set[str]] = {}
        self._allocs_by_job: dict[tuple[str, str], set[str]] = {}
        self._allocs_by_eval: dict[str, set[str]] = {}
        self._evals_by_job: dict[tuple[str, str], set[str]] = {}
        # dense [N, R'] capacity/usage matrices, maintained incrementally —
        # the solver's input (see usage_index.py module docstring)
        self.usage = UsageIndex()

        # memoized point-in-time snapshot, valid until the next write
        # (ISSUE 5 satellite): every reader between two commits — the K
        # worker lanes of one coalesced micro-batch window, the plan
        # applier's per-batch SnapshotMinIndex, blocking-query fans —
        # shares ONE StateSnapshot construction instead of each paying
        # the full table copy. Safe because a StateSnapshot is read-only
        # by contract and stored objects are immutable-by-convention.
        self._snap_memo: Optional["StateSnapshot"] = None

        # event sink (wired to the event broker by the server)
        self.event_sinks: list[Callable[[str, str, int, object], None]] = []
        # batched sink twin (ISSUE 20): one call per apply-batch window
        # flush, carrying [(topic, etype, index, payload)] — the broker
        # publishes the whole window as ONE batch (one broker lock
        # round, one offer per subscriber). When empty, a window flush
        # falls back to the per-event sinks.
        self.event_batch_sinks: list[Callable[[list], None]] = []
        # apply-batch window state (ISSUE 20 group commit), guarded by
        # self._lock — the window HOLDS the lock for its whole extent
        # (that is exactly what makes the deferrals below invisible to
        # readers): depth of nested windows, buffered events, and
        # whether any commit happened inside the window.
        self._batch_depth = 0
        self._batch_events: list[tuple] = []
        self._batch_dirty = False
        # optional: the owning server/agent wires its logger in so sink
        # failures surface in the agent log (counted regardless)
        self.logger: Optional[Callable[[str], None]] = None

    # ------------------------------------------------------------------ core

    def latest_index(self) -> int:
        with self._lock:
            return self._index

    def table_index(self, table: str) -> int:
        with self._lock:
            return self._table_index.get(table, 0)

    def _bump(self, table: str, index: Optional[int] = None) -> int:
        """Advance the store to `index` (or next) for a write to `table`."""
        if index is None:
            index = self._index + 1
        self._index = max(self._index, index)
        self._table_index[table] = self._index
        # any write invalidates the shared snapshot memo — keyed on the
        # write GENERATION, not the index: a batched FSM entry applies
        # several writes at one index and each must displace the memo.
        # _bump is only ever called with self._lock held (every writer).
        # nomadlint: disable=LOCK001 — caller holds the write lock
        self._snap_memo = None
        return self._index

    def _commit(self) -> None:
        if self._batch_depth:
            # inside an apply-batch window: ONE wakeup at window exit
            # (blocking queries re-check their predicate anyway, and
            # the lock is held until the flush, so no reader can
            # observe the gap). _commit is only ever called with the
            # write lock held, like _bump above.
            # nomadlint: disable=LOCK001 — caller holds the write lock
            self._batch_dirty = True
            return
        self._cond.notify_all()

    def _emit(self, topic: str, etype: str, index: int, payload) -> None:
        if self._batch_depth:
            # inside an apply-batch window: buffer for ONE batched
            # publish at window exit (ISSUE 20)
            self._batch_events.append((topic, etype, index, payload))
            return
        for sink in self.event_sinks:
            try:
                sink(topic, etype, index, payload)
            except Exception as e:      # noqa: BLE001
                # a broken sink must not block commits, but a sink that
                # silently stops delivering is an invisible outage —
                # count it (EXC001; logger is optional, agents wire one)
                record_swallowed_error("state.emit", e, self.logger)

    @contextmanager
    def batch_window(self):
        """Hold the write lock across a batch of FSM applies and flush
        their side effects ONCE at exit (ISSUE 20 group commit): one
        condvar broadcast, one event-sink publish batch, and — because
        the lock never drops inside the window — one effective
        snapshot-memo rebuild for the whole batch instead of one per
        entry. Re-entrant (RLock + depth counter); the outermost exit
        flushes. Mutations inside the window are ordinary mutator
        calls; they re-enter the already-held lock."""
        with self._lock:
            self._batch_depth += 1
            try:
                yield self
            finally:
                self._batch_depth -= 1
                if self._batch_depth == 0:
                    self._flush_batch_locked()

    def _flush_batch_locked(self) -> None:
        events, self._batch_events = self._batch_events, []
        dirty, self._batch_dirty = self._batch_dirty, False
        if events:
            if self.event_batch_sinks:
                for sink in self.event_batch_sinks:
                    try:
                        sink(events)
                    except Exception as e:      # noqa: BLE001
                        record_swallowed_error("state.emit_batch", e,
                                               self.logger)
            else:
                for topic, etype, index, payload in events:
                    for sink in self.event_sinks:
                        try:
                            sink(topic, etype, index, payload)
                        except Exception as e:      # noqa: BLE001
                            record_swallowed_error("state.emit", e,
                                                   self.logger)
        if dirty or events:
            self._cond.notify_all()

    def snapshot(self) -> "StateSnapshot":
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> "StateSnapshot":
        snap = self._snap_memo
        if snap is None:
            snap = self._snap_memo = StateSnapshot(self)
        else:
            from ..metrics import metrics
            metrics.incr("nomad.state.snapshot_shared")
        return snap

    # -------------------------------------------------- rpc write dedup
    # (ISSUE 18) token -> commit index, written from NomadFSM.apply when
    # an entry carries a `_dedup` stamp. Deliberately NOT a _bump table:
    # a dedup record is metadata ABOUT an apply at `index`, not a write
    # of its own, and must not wake blocking queries or churn the memo.

    def record_rpc_dedup(self, index: int, token: str) -> None:
        with self._lock:
            dd = self.rpc_dedup
            dd[token] = index
            dd.move_to_end(token)
            while len(dd) > RPC_DEDUP_CAP:
                dd.popitem(last=False)

    def rpc_dedup_get(self, token: str) -> Optional[int]:
        with self._lock:
            return self.rpc_dedup.get(token)

    def rpc_dedup_len(self) -> int:
        with self._lock:
            return len(self.rpc_dedup)

    def fork(self) -> "StateStore":
        """Writable scratch copy for dry-run planning (the Job.Plan endpoint
        runs a real scheduler pass against a snapshot without touching Raft —
        ref nomad/job_endpoint.go Job.Plan). Shallow table copies are safe:
        stored objects are immutable-by-convention."""
        with self._lock:
            out = StateStore()
            out._index = self._index
            out._table_index = dict(self._table_index)
            out.nodes = dict(self.nodes)
            out.jobs = dict(self.jobs)
            out.job_versions = dict(self.job_versions)
            out.job_summaries = dict(self.job_summaries)
            out.evals = dict(self.evals)
            out.allocs = dict(self.allocs)
            out.deployments = dict(self.deployments)
            out.periodic_launches = dict(self.periodic_launches)
            out.acl_policies = dict(self.acl_policies)
            out.acl_tokens = dict(self.acl_tokens)
            out._acl_token_by_secret = dict(self._acl_token_by_secret)
            out.scheduler_config = self.scheduler_config
            out.namespaces = dict(self.namespaces)
            out.scaling_policies = dict(self.scaling_policies)
            out._scaling_policy_by_target = dict(self._scaling_policy_by_target)
            out.scaling_events = {k: {g: list(evs) for g, evs in v.items()}
                                  for k, v in self.scaling_events.items()}
            out.csi_volumes = dict(self.csi_volumes)
            out.csi_plugins = dict(self.csi_plugins)
            out.services = dict(self.services)
            out.intentions = dict(self.intentions)
            out.autopilot_config = dict(self.autopilot_config)
            out.usage = self.usage.copy()
            out._allocs_by_node = {k: set(v)
                                   for k, v in self._allocs_by_node.items()}
            out._allocs_by_job = {k: set(v)
                                  for k, v in self._allocs_by_job.items()}
            out._allocs_by_eval = {k: set(v)
                                   for k, v in self._allocs_by_eval.items()}
            out._evals_by_job = {k: set(v)
                                 for k, v in self._evals_by_job.items()}
            return out

    def snapshot_min_index(self, index: int, timeout: float = 5.0
                           ) -> "StateSnapshot":
        """Block until latest_index >= index, then snapshot
        (ref nomad/worker.go:536 snapshotMinIndex)."""
        from .. import faults
        faults.fire("state.snapshot_min_index")
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._index < index:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"timed out waiting for index {index} (at {self._index})")
                self._cond.wait(remaining)
            return self._snapshot_locked()

    def block_min_index(self, index: int, timeout: float = 60.0) -> int:
        """Blocking-query primitive: wait for any write past `index`."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._index <= index:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self._index
                self._cond.wait(remaining)
            return self._index

    # ----------------------------------------------------------------- nodes

    def upsert_node(self, index: int, node: Node) -> None:
        with self._lock:
            existing = self.nodes.get(node.id)
            node = node.copy()
            if existing:
                node.create_index = existing.create_index
                # preserve drain/eligibility set server-side unless provided
                if node.drain_strategy is None and existing.drain_strategy:
                    node.drain_strategy = existing.drain_strategy
                    node.scheduling_eligibility = existing.scheduling_eligibility
                if existing.flap_held_until:
                    # a flap hold survives re-registration (ISSUE 10):
                    # only the damper's re-admit or an operator
                    # eligibility write lifts it — a flapping agent
                    # re-registering must not wash its own hold away
                    node.flap_held_until = existing.flap_held_until
                    node.scheduling_eligibility = \
                        existing.scheduling_eligibility
            else:
                node.create_index = index
            node.modify_index = self._bump("nodes", index)
            self.nodes[node.id] = node
            self.usage.set_node(node)
            self._update_csi_plugins_from_node(index, node)
            self._emit("Node", "NodeRegistration", node.modify_index, node)
            self._commit()

    def delete_node(self, index: int, node_ids: list[str]) -> None:
        with self._lock:
            for nid in node_ids:
                self.nodes.pop(nid, None)
                self.usage.drop_node(nid)
                self._delete_node_from_csi_plugins(index, nid)
            self._bump("nodes", index)
            self._commit()

    def update_node_status(self, index: int, node_id: str, status: str,
                           updated_at: float = 0.0) -> None:
        with self._lock:
            node = self.nodes.get(node_id)
            if node is None:
                raise KeyError(f"node {node_id} not found")
            node = node.copy()
            node.status = status
            node.status_updated_at = updated_at
            node.modify_index = self._bump("nodes", index)
            self.nodes[node_id] = node
            self.usage.set_node_taint(node_id, node.ready())
            self._emit("Node", "NodeStatusUpdate", node.modify_index, node)
            self._commit()

    def update_node_status_batch(self, index: int, node_ids: list[str],
                                 status: str,
                                 updated_at: float = 0.0) -> int:
        """Batched status flip (ISSUE 10): one FSM entry marks a whole
        heartbeat-sweep's expired nodes, under ONE lock hold and one
        commit — the serial per-node sequence's exact final state (the
        storm differential in tests/test_node_storm.py pins byte
        equality). Nodes GC'd between expiry and commit are skipped.
        Returns the number of nodes actually updated."""
        n = 0
        with self._lock:
            idx = self._bump("nodes", index)
            for node_id in node_ids:
                node = self.nodes.get(node_id)
                if node is None:
                    continue
                node = node.copy()
                node.status = status
                node.status_updated_at = updated_at
                node.modify_index = idx
                self.nodes[node_id] = node
                self.usage.set_node_taint(node_id, node.ready())
                self._emit("Node", "NodeStatusUpdate", idx, node)
                n += 1
            self._commit()
        return n

    def update_node_drain(self, index: int, node_id: str, drain,
                          mark_eligible: bool = False) -> None:
        with self._lock:
            node = self.nodes.get(node_id)
            if node is None:
                raise KeyError(f"node {node_id} not found")
            node = node.copy()
            node.drain_strategy = drain
            if drain is not None:
                node.scheduling_eligibility = "ineligible"
            elif mark_eligible:
                node.scheduling_eligibility = "eligible"
            node.modify_index = self._bump("nodes", index)
            self.nodes[node_id] = node
            self.usage.set_node_taint(node_id, node.ready())
            self._emit("Node", "NodeDrain", node.modify_index, node)
            self._commit()

    def update_node_eligibility(self, index: int, node_id: str,
                                eligibility: str,
                                flap_until: Optional[float] = None) -> None:
        """`flap_until` is set by the flap damper (ISSUE 10): the hold
        deadline rides raft so a NEW leader can re-admit nodes a deposed
        damper held. Operator/plain eligibility writes clear it."""
        with self._lock:
            node = self.nodes.get(node_id)
            if node is None:
                raise KeyError(f"node {node_id} not found")
            node = node.copy()
            node.scheduling_eligibility = eligibility
            node.flap_held_until = float(flap_until or 0.0)
            node.modify_index = self._bump("nodes", index)
            self.nodes[node_id] = node
            self.usage.set_node_taint(node_id, node.ready())
            self._commit()

    def node_by_id(self, node_id: str) -> Optional[Node]:
        with self._lock:
            return self.nodes.get(node_id)

    def iter_nodes(self) -> list[Node]:
        with self._lock:
            return list(self.nodes.values())

    def node_count(self) -> int:
        """O(1) fleet size — hot-path gates (the standby twin feed runs
        per replicated plan apply) must not copy the node table."""
        with self._lock:
            return len(self.nodes)

    # ------------------------------------------------------------------ jobs

    def upsert_job(self, index: int, job: Job, keep_version: bool = False) -> None:
        """Insert/update a job, maintaining version history and summary
        (ref state_store.go UpsertJob/upsertJobImpl)."""
        with self._lock:
            key = (job.namespace, job.id)
            existing = self.jobs.get(key)
            job = job.copy()
            if existing:
                job.create_index = existing.create_index
                job.job_modify_index = index
                if not keep_version:
                    job.version = existing.version + 1
            else:
                job.create_index = index
                job.job_modify_index = index
                job.version = 0
            job.modify_index = self._bump("jobs", index)
            if job.status not in (JOB_STATUS_DEAD,):
                job.status = self._compute_job_status(job)
            self.jobs[key] = job
            self.job_versions[(job.namespace, job.id, job.version)] = job
            self._prune_job_versions(job.namespace, job.id)
            self._ensure_summary(index, job)
            self._update_scaling_policies(index, job)
            self._emit("Job", "JobRegistered", job.modify_index, job)
            self._commit()

    def _compute_job_status(self, job: Job) -> str:
        """ref state_store.go getJobStatus: running if any live alloc; pending
        while evals are outstanding or nothing has run yet; dead once a job
        that had allocations has only terminal ones left."""
        if job.stop:
            return JOB_STATUS_DEAD
        if job.is_periodic() or job.is_parameterized():
            return JOB_STATUS_RUNNING
        key = (job.namespace, job.id)
        alloc_ids = self._allocs_by_job.get(key, ())
        for aid in alloc_ids:  # any live alloc => running
            if not self.allocs[aid].terminal_status():
                return JOB_STATUS_RUNNING
        for eid in self._evals_by_job.get(key, ()):
            ev = self.evals.get(eid)
            if ev is not None and not ev.terminal_status():
                return JOB_STATUS_PENDING
        if alloc_ids:
            return JOB_STATUS_DEAD
        return JOB_STATUS_PENDING

    def _prune_job_versions(self, ns: str, job_id: str, keep: int = 6) -> None:
        versions = sorted(v for (n, j, v) in self.job_versions
                          if n == ns and j == job_id)
        for v in versions[:-keep]:
            self.job_versions.pop((ns, job_id, v), None)

    def _ensure_summary(self, index: int, job: Job) -> None:
        key = (job.namespace, job.id)
        summ = self.job_summaries.get(key)
        summ = summ.copy() if summ else JobSummary(
            job_id=job.id, namespace=job.namespace, create_index=index)
        for tg in job.task_groups:
            summ.summary.setdefault(tg.name, TaskGroupSummary())
        summ.modify_index = index
        self.job_summaries[key] = summ

    def delete_job(self, index: int, ns: str, job_id: str) -> None:
        with self._lock:
            self.jobs.pop((ns, job_id), None)
            for k in [k for k in self.job_versions if k[0] == ns and k[1] == job_id]:
                self.job_versions.pop(k)
            self.job_summaries.pop((ns, job_id), None)
            self.periodic_launches.pop((ns, job_id), None)
            self.scaling_events.pop((ns, job_id), None)
            for tkey in [k for k in self._scaling_policy_by_target
                         if k[0] == ns and k[1] == job_id]:
                pid = self._scaling_policy_by_target.pop(tkey)
                self.scaling_policies.pop(pid, None)
                self._bump("scaling_policy", index)
            self._bump("jobs", index)
            self._emit("Job", "JobDeregistered", self._index, (ns, job_id))
            self._commit()

    def job_by_id(self, ns: str, job_id: str) -> Optional[Job]:
        with self._lock:
            return self.jobs.get((ns, job_id))

    def job_by_version(self, ns: str, job_id: str, version: int) -> Optional[Job]:
        with self._lock:
            return self.job_versions.get((ns, job_id, version))

    def job_versions_by_id(self, ns: str, job_id: str) -> list[Job]:
        with self._lock:
            out = [j for (n, i, _v), j in self.job_versions.items()
                   if n == ns and i == job_id]
            return sorted(out, key=lambda j: -j.version)

    def iter_jobs(self, ns: Optional[str] = None) -> list[Job]:
        with self._lock:
            return [j for j in self.jobs.values()
                    if ns is None or j.namespace == ns]

    def job_summary(self, ns: str, job_id: str) -> Optional[JobSummary]:
        with self._lock:
            return self.job_summaries.get((ns, job_id))

    # --------------------------------------------------------------- scaling

    def _update_scaling_policies(self, index: int, job: Job) -> None:
        """Sync the scaling_policy table with a job's scaling blocks (ref
        state_store.go updateJobScalingPolicies). Must hold self._lock."""
        from ..structs.scaling import policy_from_group
        live_targets = set()
        for tg in job.task_groups:
            pol = policy_from_group(job, tg)
            if pol is None:
                continue
            tkey = pol.target_key()
            live_targets.add(tkey)
            existing_id = self._scaling_policy_by_target.get(tkey)
            if existing_id is not None:
                existing = self.scaling_policies[existing_id]
                pol.id = existing.id
                pol.create_index = existing.create_index
                if (existing.min == pol.min and existing.max == pol.max
                        and existing.policy == pol.policy
                        and existing.enabled == pol.enabled
                        and existing.type == pol.type):
                    continue  # unchanged — keep modify_index stable
                pol.modify_index = self._bump("scaling_policy", index)
            else:
                pol.create_index = index
                pol.modify_index = self._bump("scaling_policy", index)
            self.scaling_policies[pol.id] = pol
            self._scaling_policy_by_target[tkey] = pol.id
        # drop policies for groups no longer in the job
        for tkey in [k for k in self._scaling_policy_by_target
                     if k[0] == job.namespace and k[1] == job.id
                     and k not in live_targets]:
            pid = self._scaling_policy_by_target.pop(tkey)
            self.scaling_policies.pop(pid, None)
            self._bump("scaling_policy", index)

    def iter_scaling_policies(self, ns: Optional[str] = None,
                              job_id: Optional[str] = None,
                              type_: Optional[str] = None) -> list:
        with self._lock:
            out = []
            for pol in self.scaling_policies.values():
                pns, pjob, _ = pol.target_key()
                if ns is not None and pns != ns:
                    continue
                if job_id is not None and pjob != job_id:
                    continue
                if type_ is not None and pol.type != type_:
                    continue
                out.append(pol)
            return sorted(out, key=lambda p: p.target_key())

    def scaling_policy_by_id(self, policy_id: str):
        with self._lock:
            return self.scaling_policies.get(policy_id)

    def scaling_policy_by_target(self, ns: str, job_id: str, group: str):
        with self._lock:
            pid = self._scaling_policy_by_target.get((ns, job_id, group))
            return self.scaling_policies.get(pid) if pid else None

    def upsert_scaling_event(self, index: int, ns: str, job_id: str,
                             group: str, event) -> None:
        """ref state_store.go UpsertScalingEvent — bounded trail per group."""
        from ..structs.scaling import JOB_TRACKED_SCALING_EVENTS
        with self._lock:
            event = event.copy()
            event.create_index = self._bump("scaling_event", index)
            groups = self.scaling_events.setdefault((ns, job_id), {})
            trail = groups.setdefault(group, [])
            trail.insert(0, event)
            del trail[JOB_TRACKED_SCALING_EVENTS:]
            self._commit()

    def scaling_events_by_job(self, ns: str, job_id: str) -> dict[str, list]:
        with self._lock:
            return {g: list(evs) for g, evs in
                    self.scaling_events.get((ns, job_id), {}).items()}

    # ------------------------------------------------------------------ CSI

    def _update_csi_plugins_from_node(self, index: int, node) -> None:
        """Fold one node's fingerprinted CSI plugins into the aggregated
        plugin table (ref state_store.go updateNodeCSIPlugins). Holds lock."""
        from ..structs.csi import CSIPlugin
        seen = set()
        for pid, info in {**node.csi_node_plugins,
                          **node.csi_controller_plugins}.items():
            seen.add(pid)
            plug = self.csi_plugins.get(pid)
            plug = plug.copy() if plug else CSIPlugin(
                id=pid, create_index=index)
            plug.provider = info.get("provider", plug.provider)
            plug.version = info.get("provider_version", plug.version)
            if info.get("requires_controller"):
                plug.controller_required = True
            if pid in node.csi_node_plugins:
                plug.nodes[node.id] = bool(
                    node.csi_node_plugins[pid].get("healthy", False))
            if pid in node.csi_controller_plugins:
                plug.controllers[node.id] = bool(
                    node.csi_controller_plugins[pid].get("healthy", False))
            plug.modify_index = self._bump("csi_plugins", index)
            self.csi_plugins[pid] = plug
        # node no longer fingerprints a plugin -> drop its contribution
        for pid in [p for p in self.csi_plugins if p not in seen]:
            plug = self.csi_plugins[pid]
            if node.id in plug.nodes or node.id in plug.controllers:
                plug = plug.copy()
                plug.nodes.pop(node.id, None)
                plug.controllers.pop(node.id, None)
                plug.modify_index = self._bump("csi_plugins", index)
                if plug.is_empty():
                    del self.csi_plugins[pid]
                else:
                    self.csi_plugins[pid] = plug

    def _delete_node_from_csi_plugins(self, index: int, node_id: str) -> None:
        for pid in list(self.csi_plugins):
            plug = self.csi_plugins[pid]
            if node_id in plug.nodes or node_id in plug.controllers:
                plug = plug.copy()
                plug.nodes.pop(node_id, None)
                plug.controllers.pop(node_id, None)
                self._bump("csi_plugins", index)
                if plug.is_empty():
                    del self.csi_plugins[pid]
                else:
                    self.csi_plugins[pid] = plug

    def upsert_csi_volume(self, index: int, vol) -> None:
        """ref state_store.go CSIVolumeRegister"""
        with self._lock:
            key = (vol.namespace, vol.id)
            existing = self.csi_volumes.get(key)
            vol = vol.copy()
            if existing:
                vol.create_index = existing.create_index
                # claims survive re-registration
                vol.read_claims = {k: v.copy() for k, v
                                   in existing.read_claims.items()}
                vol.write_claims = {k: v.copy() for k, v
                                    in existing.write_claims.items()}
            else:
                vol.create_index = index
            vol.modify_index = self._bump("csi_volumes", index)
            self.csi_volumes[key] = vol
            self._commit()

    def delete_csi_volume(self, index: int, ns: str, vol_id: str,
                          force: bool = False) -> None:
        """ref state_store.go CSIVolumeDeregister"""
        with self._lock:
            vol = self.csi_volumes.get((ns, vol_id))
            if vol is None:
                raise ValueError(f"volume {vol_id!r} not found")
            if vol.in_use() and not force:
                raise ValueError(f"volume {vol_id!r} is in use")
            del self.csi_volumes[(ns, vol_id)]
            self._bump("csi_volumes", index)
            self._commit()

    def csi_volume_claim(self, index: int, ns: str, vol_id: str,
                         claim) -> None:
        """Take or update one claim (ref state_store.go CSIVolumeClaim)."""
        from ..structs.csi import (
            CLAIM_WRITE, CLAIM_STATE_CONTROLLER_DETACHED,
            CLAIM_STATE_NODE_DETACHED, CLAIM_STATE_READY_TO_FREE,
        )
        with self._lock:
            vol = self.csi_volumes.get((ns, vol_id))
            if vol is None:
                raise ValueError(f"volume {vol_id!r} not found")
            vol = vol.copy()
            if claim.state == CLAIM_STATE_READY_TO_FREE:
                vol.read_claims.pop(claim.alloc_id, None)
                vol.write_claims.pop(claim.alloc_id, None)
            elif claim.state in (CLAIM_STATE_NODE_DETACHED,
                                 CLAIM_STATE_CONTROLLER_DETACHED):
                # detach progress: advance the EXISTING claim's state —
                # no mode/claim_ok checks (the slot is already held)
                for claims in (vol.read_claims, vol.write_claims):
                    cur = claims.get(claim.alloc_id)
                    if cur is not None:
                        cur = cur.copy()
                        cur.state = claim.state
                        claims[claim.alloc_id] = cur
            elif claim.mode == CLAIM_WRITE:
                if not vol.claim_ok(claim.mode) and \
                        claim.alloc_id not in vol.write_claims:
                    raise ValueError(
                        f"volume {vol_id!r} has no free write claims")
                vol.read_claims.pop(claim.alloc_id, None)
                vol.write_claims[claim.alloc_id] = claim.copy()
            else:
                if not vol.claim_ok(claim.mode):
                    raise ValueError(f"volume {vol_id!r} not readable")
                vol.read_claims[claim.alloc_id] = claim.copy()
            vol.modify_index = self._bump("csi_volumes", index)
            self.csi_volumes[(ns, vol_id)] = vol
            self._commit()

    def _csi_denormalize(self, vol):
        """Attach live plugin health to a volume copy at read time
        (ref state_store.go CSIVolumeDenormalize)."""
        plug = self.csi_plugins.get(vol.plugin_id)
        vol = vol.copy()
        if plug is not None:
            vol.controllers_healthy = plug.controllers_healthy
            vol.nodes_healthy = plug.nodes_healthy
            vol.controller_required = plug.controller_required
            vol.schedulable = plug.nodes_healthy > 0 and (
                not plug.controller_required or plug.controllers_healthy > 0)
        else:
            vol.schedulable = False
        return vol

    def csi_volume_by_id(self, ns: str, vol_id: str):
        with self._lock:
            vol = self.csi_volumes.get((ns, vol_id))
            return self._csi_denormalize(vol) if vol else None

    def iter_csi_volumes(self, ns: Optional[str] = None,
                         plugin_id: Optional[str] = None) -> list:
        with self._lock:
            return [self._csi_denormalize(v)
                    for v in self.csi_volumes.values()
                    if (ns is None or v.namespace == ns)
                    and (plugin_id is None or v.plugin_id == plugin_id)]

    def csi_plugin_by_id(self, plugin_id: str):
        with self._lock:
            return self.csi_plugins.get(plugin_id)

    def iter_csi_plugins(self) -> list:
        with self._lock:
            return sorted(self.csi_plugins.values(), key=lambda p: p.id)

    # ------------------------------------------------------------- services

    def upsert_service_registrations(self, index: int,
                                     instances: list) -> None:
        with self._lock:
            idx = self._bump("services", index)
            for inst in instances:
                inst = inst.copy()
                existing = self.services.get(inst.key())
                inst.create_index = existing.create_index if existing else idx
                inst.modify_index = idx
                self.services[inst.key()] = inst
            self._commit()

    def delete_service_registrations(self, index: int,
                                     alloc_id: str = "",
                                     keys: Optional[list] = None) -> None:
        with self._lock:
            doomed = list(keys or [])
            if alloc_id:
                doomed += [k for k in self.services if k[2] == alloc_id]
            for k in doomed:
                self.services.pop(tuple(k), None)
            if doomed:
                self._bump("services", index)
            self._commit()

    # ----------------------------------------------------------- intentions

    def upsert_intention(self, index: int, intention) -> None:
        with self._lock:
            idx = self._bump("intentions", index)
            it = intention.copy()
            existing = self.intentions.get(it.key())
            it.create_index = existing.create_index if existing else idx
            it.modify_index = idx
            self.intentions[it.key()] = it
            self._commit()

    def delete_intention(self, index: int, namespace: str, source: str,
                         destination: str) -> None:
        with self._lock:
            if self.intentions.pop((namespace, source, destination),
                                   None) is not None:
                self._bump("intentions", index)
                self._commit()

    def iter_intentions(self, namespace: Optional[str] = None) -> list:
        with self._lock:
            return [i for i in self.intentions.values()
                    if namespace in (None, i.namespace)]

    def intention_allowed(self, namespace: str, source: str,
                          destination: str) -> bool:
        from ..integrations.services import intention_allowed
        with self._lock:
            return intention_allowed(self.intentions.values(), namespace,
                                     source, destination)

    def services_by_name(self, ns: str, name: str) -> list:
        with self._lock:
            return [s for s in self.services.values()
                    if s.namespace == ns and s.service_name == name]

    def iter_services(self, ns: Optional[str] = None) -> list:
        with self._lock:
            return [s for s in self.services.values()
                    if ns is None or s.namespace == ns]

    # ------------------------------------------------------------ autopilot

    def get_autopilot_config(self) -> dict:
        with self._lock:
            return dict(self.autopilot_config)

    def set_autopilot_config(self, index: int, config: dict) -> None:
        with self._lock:
            self.autopilot_config = {**self.autopilot_config, **config}
            self._bump("autopilot", index)
            self._commit()

    def update_job_stability(self, index: int, ns: str, job_id: str,
                             version: int, stable: bool) -> None:
        """ref state_store.go UpdateJobStability."""
        with self._lock:
            j = self.job_versions.get((ns, job_id, version))
            if j is None:
                return  # validated at the endpoint; FSM apply must not raise
            j = j.copy()
            j.stable = stable
            j.modify_index = self._bump("jobs", index)
            self.job_versions[(ns, job_id, version)] = j
            cur = self.jobs.get((ns, job_id))
            if cur is not None and cur.version == version:
                cur = cur.copy()
                cur.stable = stable
                cur.modify_index = j.modify_index
                self.jobs[(ns, job_id)] = cur
            self._commit()

    # ----------------------------------------------------------------- evals

    def upsert_evals(self, index: int, evals: list[Evaluation]) -> None:
        with self._lock:
            idx = self._bump("evals", index)
            for ev in evals:
                ev = ev.copy()
                existing = self.evals.get(ev.id)
                ev.create_index = existing.create_index if existing else idx
                ev.modify_index = idx
                self._index_eval(ev)
                self.evals[ev.id] = ev
                self._update_summary_queued(idx, ev)
                self._emit("Evaluation", "EvaluationUpdated", idx, ev)
            self._commit()

    def _index_eval(self, ev: Evaluation) -> None:
        key = (ev.namespace, ev.job_id)
        self._evals_by_job.setdefault(key, set()).add(ev.id)

    def _update_summary_queued(self, index: int, ev: Evaluation) -> None:
        key = (ev.namespace, ev.job_id)
        summ = self.job_summaries.get(key)
        if summ is None or not ev.queued_allocations:
            return
        summ = summ.copy()
        for tg, n in ev.queued_allocations.items():
            summ.summary.setdefault(tg, TaskGroupSummary()).queued = n
        summ.modify_index = index
        self.job_summaries[key] = summ

    def delete_evals(self, index: int, eval_ids: list[str],
                     alloc_ids: list[str] = ()) -> None:
        with self._lock:
            for eid in eval_ids:
                ev = self.evals.pop(eid, None)
                if ev:
                    s = self._evals_by_job.get((ev.namespace, ev.job_id))
                    if s:
                        s.discard(eid)
            for aid in alloc_ids:
                self._delete_alloc(aid)
            self._bump("evals", index)
            self._commit()

    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        with self._lock:
            return self.evals.get(eval_id)

    def evals_by_job(self, ns: str, job_id: str) -> list[Evaluation]:
        with self._lock:
            return [self.evals[e] for e in self._evals_by_job.get((ns, job_id), ())
                    if e in self.evals]

    def iter_evals(self) -> list[Evaluation]:
        with self._lock:
            return list(self.evals.values())

    # ---------------------------------------------------------------- allocs

    def upsert_allocs(self, index: int, allocs: list[Allocation]) -> None:
        with self._lock:
            idx = self._bump("allocs", index)
            for alloc in allocs:
                self._upsert_alloc_locked(idx, alloc)
            self._commit()

    def _upsert_alloc_locked(self, idx: int, alloc: Allocation,
                             fresh: bool = False,
                             summary_cache: Optional[dict] = None,
                             skip_summary: bool = False) -> None:
        existing = self.allocs.get(alloc.id)
        if not (fresh and existing is None):
            # defensive copy; skipped for server-generated placements that
            # are fresh objects already (plan apply fast path)
            alloc = alloc.copy()
        if existing:
            alloc.create_index = existing.create_index
            # client-only fields are not clobbered by server-side upserts
            # (ref state_store.go UpsertAllocs: preserves client status unless set)
            if alloc.client_status == ALLOC_CLIENT_PENDING and \
               existing.client_status != ALLOC_CLIENT_PENDING and \
               alloc.desired_status != existing.desired_status:
                alloc.client_status = existing.client_status
                alloc.task_states = existing.task_states
            if alloc.job is None:
                alloc.job = existing.job
        else:
            alloc.create_index = idx
        alloc.modify_index = idx
        self.allocs[alloc.id] = alloc
        self._index_alloc(alloc)
        self.usage.set_alloc(alloc)
        if not skip_summary:
            self._reconcile_summary(idx, existing, alloc, summary_cache)
        self._emit("Allocation", "AllocationUpdated", idx, alloc)

    def _index_alloc(self, alloc: Allocation) -> None:
        self._allocs_by_node.setdefault(alloc.node_id, set()).add(alloc.id)
        self._allocs_by_job.setdefault(
            (alloc.namespace, alloc.job_id), set()).add(alloc.id)
        self._allocs_by_eval.setdefault(alloc.eval_id, set()).add(alloc.id)

    def _delete_alloc(self, alloc_id: str) -> None:
        alloc = self.allocs.pop(alloc_id, None)
        if not alloc:
            return
        self.usage.drop_alloc(alloc_id)
        for idx_map, key in ((self._allocs_by_node, alloc.node_id),
                             (self._allocs_by_job, (alloc.namespace, alloc.job_id)),
                             (self._allocs_by_eval, alloc.eval_id)):
            s = idx_map.get(key)
            if s:
                s.discard(alloc_id)

    _SUMMARY_FIELDS = {
        ALLOC_CLIENT_PENDING: "starting",
        ALLOC_CLIENT_RUNNING: "running",
        ALLOC_CLIENT_COMPLETE: "complete",
        ALLOC_CLIENT_FAILED: "failed",
        ALLOC_CLIENT_LOST: "lost",
        ALLOC_CLIENT_UNKNOWN: "unknown",
    }

    def _reconcile_summary(self, index: int, old: Optional[Allocation],
                           new: Allocation,
                           cache: Optional[dict] = None) -> None:
        """Maintain per-TG client-status counts
        (ref state_store.go updateSummaryWithAlloc). `cache` holds one
        already-copied summary per job for batch writes (plan apply), so a
        50k-alloc plan pays one summary copy, not 50k."""
        key = (new.namespace, new.job_id)
        summ = cache.get(key) if cache is not None else None
        if summ is None:
            summ = self.job_summaries.get(key)
            if summ is None:
                return
            summ = summ.copy()
            if cache is not None:
                cache[key] = summ
        tg = summ.summary.setdefault(new.task_group, TaskGroupSummary())
        if old is not None:
            f = self._SUMMARY_FIELDS.get(old.client_status)
            if f:
                setattr(tg, f, max(0, getattr(tg, f) - 1))
        f = self._SUMMARY_FIELDS.get(new.client_status)
        if f:
            setattr(tg, f, getattr(tg, f) + 1)
        summ.modify_index = index
        self.job_summaries[key] = summ

    def reconcile_job_summaries(self, index: int) -> None:
        """Rebuild every job summary from the live alloc set (ref
        state_store.go ReconcileJobSummaries, driven by
        PUT /v1/system/reconcile/summaries) — the repair path for
        summaries that drifted through bugs or partial restores."""
        with self._lock:
            idx = self._bump("job_summary", index)
            rebuilt: dict[tuple, JobSummary] = {}
            for (ns, job_id), job in self.jobs.items():
                summ = JobSummary(job_id=job_id, namespace=ns,
                                  create_index=idx, modify_index=idx)
                for tg in job.task_groups:
                    summ.summary.setdefault(tg.name, TaskGroupSummary())
                rebuilt[(ns, job_id)] = summ
            for alloc in self.allocs.values():
                summ = rebuilt.get((alloc.namespace, alloc.job_id))
                if summ is None:
                    continue
                tg = summ.summary.setdefault(alloc.task_group,
                                             TaskGroupSummary())
                f = self._SUMMARY_FIELDS.get(alloc.client_status)
                if f:
                    setattr(tg, f, getattr(tg, f) + 1)
            # queued counts are eval-owned state, not derivable from
            # allocs — carry them over from the old summaries
            for key, summ in rebuilt.items():
                old = self.job_summaries.get(key)
                if old is None:
                    continue
                summ.create_index = old.create_index
                for name, tgs in summ.summary.items():
                    old_tg = old.summary.get(name)
                    if old_tg is not None:
                        tgs.queued = old_tg.queued
            self.job_summaries = rebuilt
            self._commit()

    def update_allocs_from_client(self, index: int,
                                  allocs: list[Allocation]) -> None:
        """Client status updates: merge client-owned fields onto stored allocs
        (ref state_store.go UpdateAllocsFromClient/nestedUpdateAllocFromClient)."""
        with self._lock:
            idx = self._bump("allocs", index)
            for update in allocs:
                existing = self.allocs.get(update.id)
                if existing is None:
                    continue
                alloc = existing.copy()
                alloc.client_status = update.client_status
                alloc.client_description = update.client_description
                alloc.task_states = dict(update.task_states)
                alloc.network_status = update.network_status
                if update.deployment_status is not None:
                    # deployment health accounting rides the client update
                    # (ref state_store.go nestedUpdateAllocFromClient ->
                    #  updateDeploymentWithAlloc)
                    was = (existing.deployment_status.healthy
                           if existing.deployment_status else None)
                    now_h = update.deployment_status.healthy
                    alloc.deployment_status = update.deployment_status
                    if alloc.deployment_id and was != now_h and \
                       now_h is not None:
                        d = self.deployments.get(alloc.deployment_id)
                        if d is not None and d.active():
                            d = d.copy()
                            st = d.task_groups.get(alloc.task_group)
                            if st is not None:
                                if was is None:
                                    if now_h:
                                        st.healthy_allocs += 1
                                    else:
                                        st.unhealthy_allocs += 1
                                elif now_h:
                                    st.healthy_allocs += 1
                                    st.unhealthy_allocs -= 1
                                else:
                                    st.healthy_allocs -= 1
                                    st.unhealthy_allocs += 1
                            d.modify_index = idx
                            self.deployments[d.id] = d
                alloc.modify_index = idx
                alloc.modify_time_unix = update.modify_time_unix or time.time()
                self.allocs[alloc.id] = alloc
                self.usage.set_alloc(alloc)
                self._reconcile_summary(idx, existing, alloc)
                self._emit("Allocation", "AllocationUpdated", idx, alloc)
                # job status may flip (e.g. batch job completes)
                job = self.jobs.get((alloc.namespace, alloc.job_id))
                if job is not None:
                    status = self._compute_job_status(job)
                    if status != job.status:
                        job = job.copy()
                        job.status = status
                        job.modify_index = idx
                        self.jobs[(job.namespace, job.id)] = job
            self._commit()

    def update_alloc_desired_transitions(
            self, index: int, transitions: dict[str, object],
            evals: list[Evaluation] = ()) -> None:
        """Drainer entry point (ref state_store.go
        UpdateAllocsDesiredTransitions)."""
        with self._lock:
            idx = self._bump("allocs", index)
            for alloc_id, transition in transitions.items():
                existing = self.allocs.get(alloc_id)
                if existing is None:
                    continue
                alloc = existing.copy()
                alloc.desired_transition = transition
                alloc.modify_index = idx
                self.allocs[alloc_id] = alloc
            for ev in evals:
                ev = ev.copy()
                ev.create_index = idx
                ev.modify_index = idx
                self.evals[ev.id] = ev
                self._index_eval(ev)
            self._commit()

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        with self._lock:
            return self.allocs.get(alloc_id)

    def allocs_by_node(self, node_id: str) -> list[Allocation]:
        with self._lock:
            return [self.allocs[a] for a in self._allocs_by_node.get(node_id, ())
                    if a in self.allocs]

    def allocs_by_node_terminal(self, node_id: str,
                                terminal: bool) -> list[Allocation]:
        return [a for a in self.allocs_by_node(node_id)
                if a.terminal_status() == terminal]

    def allocs_by_job(self, ns: str, job_id: str,
                      anyCreateIndex: bool = True) -> list[Allocation]:
        with self._lock:
            return [self.allocs[a]
                    for a in self._allocs_by_job.get((ns, job_id), ())
                    if a in self.allocs]

    def allocs_by_eval(self, eval_id: str) -> list[Allocation]:
        with self._lock:
            return [self.allocs[a] for a in self._allocs_by_eval.get(eval_id, ())
                    if a in self.allocs]

    def namespace_alloc_counts(self) -> dict[str, int]:
        """Per-namespace allocation counts off the job index — the
        per-tenant usage signal the convex tier's quota budget reads
        (ISSUE 19). Counts index membership (includes recently-stopped
        allocs until GC), so it is a smoothed usage signal, not an exact
        running-instance census — quotas gate NEW placements, where
        over-counting errs safe."""
        with self._lock:
            counts: dict[str, int] = {}
            for (ns, _job), ids in self._allocs_by_job.items():
                counts[ns] = counts.get(ns, 0) + len(ids)
            return counts

    def iter_allocs(self) -> list[Allocation]:
        with self._lock:
            return list(self.allocs.values())

    # ------------------------------------------------------------ plan apply

    def upsert_plan_results_batch(self, index: int, results) -> None:
        """Apply a coalesced commit batch's plan results in list order
        under ONE lock hold (the lock is reentrant): all plans of the
        entry share `index`, so a blocking reader (`snapshot_min_index`,
        `block_min_index`) that wakes on the index must see the WHOLE
        entry — releasing the lock between per-plan transactions would
        let it observe index N with later plans of N still invisible,
        and their same-index writes would never re-wake it."""
        with self._lock:
            for result in results:
                self.upsert_plan_results(index, result)

    def upsert_plan_results(self, index: int, result) -> None:
        """Atomically apply a committed plan (ref nomad/fsm.go:998
        applyPlanResults + state_store.go UpsertPlanResults).

        `result` is an ApplyPlanResultsRequest-shaped object with:
        alloc_updates (stops), alloc_placements, alloc_preemptions,
        deployment, deployment_updates, eval_id, nodes_to_preempt.
        """
        from ..metrics import metrics
        with self._lock, metrics.measure("nomad.state.upsert_plan_results"):
            idx = self._bump("allocs", index)
            summary_cache: dict = {}
            now = time.time()
            for alloc in result.alloc_updates:      # stopped/updated allocs
                self._upsert_alloc_locked(idx, alloc,
                                          summary_cache=summary_cache)
            # fresh placements (all client-status pending) aggregate into
            # one summary bump per (job, tg) instead of 50k copies/updates;
            # the store writes run inline (no per-alloc function call) with
            # the index maps and sinks hoisted out of the loop
            fresh_counts: dict[tuple, int] = {}
            allocs_map = self.allocs
            by_node = self._allocs_by_node
            by_job = self._allocs_by_job
            by_eval = self._allocs_by_eval
            usage = self.usage
            sinks = self.event_sinks
            # index-map membership is accumulated per key and bulk-merged
            # after the loop (set.update beats 50k .add calls), and the
            # usage matrix takes the whole batch at once — together the
            # largest slice of the 50k-plan commit (VERDICT r4 #5)
            fresh: list = []
            node_acc: dict[str, list] = {}
            job_acc: dict[tuple, list] = {}
            eval_acc: dict[str, list] = {}
            for alloc in result.alloc_placements:   # new placements
                if alloc.create_time_unix == 0.0:
                    alloc.create_time_unix = now
                alloc.modify_time_unix = alloc.create_time_unix
                aid = alloc.id
                if aid not in allocs_map and \
                        alloc.client_status == ALLOC_CLIENT_PENDING:
                    key = (alloc.namespace, alloc.job_id, alloc.task_group)
                    fresh_counts[key] = fresh_counts.get(key, 0) + 1
                    alloc.create_index = idx
                    alloc.modify_index = idx
                    allocs_map[aid] = alloc
                    node_acc.setdefault(alloc.node_id, []).append(aid)
                    job_acc.setdefault(
                        (alloc.namespace, alloc.job_id), []).append(aid)
                    eval_acc.setdefault(alloc.eval_id, []).append(aid)
                    fresh.append(alloc)
                    if sinks:
                        self._emit("Allocation", "AllocationUpdated", idx,
                                   alloc)
                else:
                    self._upsert_alloc_locked(idx, alloc, fresh=True,
                                              summary_cache=summary_cache)
            for acc, index_map in ((node_acc, by_node), (job_acc, by_job),
                                   (eval_acc, by_eval)):
                for k, ids in acc.items():
                    members = index_map.get(k)
                    if members is None:
                        index_map[k] = set(ids)
                    else:
                        members.update(ids)
            usage.add_fresh_batch(fresh)
            for (ns, job_id, tg_name), cnt in fresh_counts.items():
                jkey = (ns, job_id)
                summ = summary_cache.get(jkey)
                if summ is None:
                    summ = self.job_summaries.get(jkey)
                    if summ is None:
                        continue
                    summ = summ.copy()
                    summary_cache[jkey] = summ
                tg = summ.summary.setdefault(tg_name, TaskGroupSummary())
                tg.starting += cnt
                summ.modify_index = idx
                self.job_summaries[jkey] = summ
            for alloc in result.alloc_preemptions:
                self._upsert_alloc_locked(idx, alloc,
                                          summary_cache=summary_cache)
            if result.deployment is not None:
                self._upsert_deployment_locked(idx, result.deployment)
            for du in result.deployment_updates:
                self._apply_deployment_update_locked(idx, du)
            # deployment placement bookkeeping (ref state_store.go
            # updateDeploymentWithAlloc)
            for alloc in result.alloc_placements:
                if not alloc.deployment_id:
                    continue
                d = self.deployments.get(alloc.deployment_id)
                if d is None:
                    continue
                d = d.copy()
                ds = d.task_groups.get(alloc.task_group)
                if ds is not None:
                    ds.placed_allocs += 1
                    if alloc.deployment_status is not None and \
                       alloc.deployment_status.canary and \
                       alloc.id not in ds.placed_canaries:
                        ds.placed_canaries.append(alloc.id)
                d.modify_index = idx
                self.deployments[d.id] = d
            # refresh job status
            job = None
            if result.alloc_placements:
                a0 = result.alloc_placements[0]
                job = self.jobs.get((a0.namespace, a0.job_id))
            if job is not None and job.status != JOB_STATUS_RUNNING and not job.stop:
                job = job.copy()
                job.status = JOB_STATUS_RUNNING
                job.modify_index = idx
                self.jobs[(job.namespace, job.id)] = job
            self._commit()

    # ------------------------------------------------------------ deployments

    def upsert_deployment(self, index: int, deployment: Deployment) -> None:
        with self._lock:
            idx = self._bump("deployment", index)
            self._upsert_deployment_locked(idx, deployment)
            self._commit()

    def _upsert_deployment_locked(self, idx: int, deployment: Deployment) -> None:
        existing = self.deployments.get(deployment.id)
        deployment = deployment.copy()
        deployment.create_index = existing.create_index if existing else idx
        deployment.modify_index = idx
        self.deployments[deployment.id] = deployment
        self._emit("Deployment", "DeploymentStatusUpdate", idx, deployment)

    def _apply_deployment_update_locked(self, idx: int, du) -> None:
        d = self.deployments.get(du.deployment_id)
        if d is None:
            return
        d = d.copy()
        d.status = du.status
        d.status_description = du.status_description
        d.modify_index = idx
        self.deployments[d.id] = d
        # a successful deployment marks its job version stable — the anchor
        # auto-revert rolls back to (ref deploymentwatcher SetJobStable)
        if du.status == "successful":
            vkey = (d.namespace, d.job_id, d.job_version)
            job = self.job_versions.get(vkey)
            if job is not None and not job.stable:
                job = job.copy()
                job.stable = True
                self.job_versions[vkey] = job
                current = self.jobs.get((d.namespace, d.job_id))
                if current is not None and current.version == d.job_version:
                    cur = current.copy()
                    cur.stable = True
                    self.jobs[(d.namespace, d.job_id)] = cur
        self._emit("Deployment", "DeploymentStatusUpdate", idx, d)

    def update_deployment_status(self, index: int, du,
                                 job: Optional[Job] = None,
                                 eval: Optional[Evaluation] = None) -> None:
        with self._lock:
            idx = self._bump("deployment", index)
            self._apply_deployment_update_locked(idx, du)
            if job is not None:
                self.upsert_job_locked_helper(idx, job)
            if eval is not None:
                ev = eval.copy()
                ev.create_index = idx
                ev.modify_index = idx
                self.evals[ev.id] = ev
                self._index_eval(ev)
            self._commit()

    def upsert_job_locked_helper(self, idx: int, job: Job) -> None:
        key = (job.namespace, job.id)
        existing = self.jobs.get(key)
        job = job.copy()
        if existing:
            job.create_index = existing.create_index
            job.version = existing.version + 1
        job.modify_index = idx
        self.jobs[key] = job
        self.job_versions[(job.namespace, job.id, job.version)] = job

    def update_deployment_alloc_health(self, index: int, deployment_id: str,
                                       healthy: list[str], unhealthy: list[str],
                                       timestamp: float = 0.0) -> None:
        """ref state_store.go UpdateDeploymentAllocHealth"""
        from ..structs import AllocDeploymentStatus
        with self._lock:
            idx = self._bump("deployment", index)
            d = self.deployments.get(deployment_id)
            for aid, is_healthy in [(a, True) for a in healthy] + \
                                   [(a, False) for a in unhealthy]:
                alloc = self.allocs.get(aid)
                if alloc is None:
                    continue
                old = alloc
                alloc = alloc.copy()
                ds = alloc.deployment_status or AllocDeploymentStatus()
                was = ds.healthy
                ds.healthy = is_healthy
                ds.timestamp_unix = timestamp or time.time()
                ds.modify_index = idx
                alloc.deployment_status = ds
                alloc.modify_index = idx
                self.allocs[aid] = alloc
                if d is not None and alloc.deployment_id == deployment_id:
                    d = d.copy()
                    state = d.task_groups.get(alloc.task_group)
                    if state is not None:
                        if was is None:
                            if is_healthy:
                                state.healthy_allocs += 1
                            else:
                                state.unhealthy_allocs += 1
                        elif was != is_healthy:
                            if is_healthy:
                                state.healthy_allocs += 1
                                state.unhealthy_allocs -= 1
                            else:
                                state.healthy_allocs -= 1
                                state.unhealthy_allocs += 1
                    d.modify_index = idx
                    self.deployments[d.id] = d
                self._emit("Allocation", "AllocationUpdated", idx, alloc)
            self._commit()

    def update_deployment_promotion(self, index: int, deployment_id: str,
                                    groups: Optional[list[str]] = None) -> None:
        with self._lock:
            idx = self._bump("deployment", index)
            d = self.deployments.get(deployment_id)
            if d is None:
                raise KeyError(f"deployment {deployment_id} not found")
            d = d.copy()
            for name, state in d.task_groups.items():
                if groups is None or name in groups:
                    state.promoted = True
            d.modify_index = idx
            self.deployments[d.id] = d
            # canary allocs get their canary flag cleared on promote via
            # deployment watcher-created eval; state keeps alloc flags as-is
            self._commit()

    def delete_deployments(self, index: int, deployment_ids: list[str]) -> None:
        with self._lock:
            for did in deployment_ids:
                self.deployments.pop(did, None)
            self._bump("deployment", index)
            self._commit()

    def deployment_by_id(self, deployment_id: str) -> Optional[Deployment]:
        with self._lock:
            return self.deployments.get(deployment_id)

    def deployments_by_job(self, ns: str, job_id: str) -> list[Deployment]:
        with self._lock:
            return [d for d in self.deployments.values()
                    if d.namespace == ns and d.job_id == job_id]

    def latest_deployment_by_job(self, ns: str, job_id: str
                                 ) -> Optional[Deployment]:
        ds = self.deployments_by_job(ns, job_id)
        if not ds:
            return None
        return max(ds, key=lambda d: d.create_index)

    def iter_deployments(self) -> list[Deployment]:
        with self._lock:
            return list(self.deployments.values())

    # -------------------------------------------------------- periodic/config

    def upsert_periodic_launch(self, index: int, ns: str, job_id: str,
                               launch_time: float) -> None:
        with self._lock:
            idx = self._bump("periodic_launch", index)
            self.periodic_launches[(ns, job_id)] = {
                "namespace": ns, "id": job_id, "launch": launch_time,
                "modify_index": idx}
            self._commit()

    def periodic_launch_by_id(self, ns: str, job_id: str) -> Optional[dict]:
        with self._lock:
            return self.periodic_launches.get((ns, job_id))

    def set_scheduler_config(self, index: int,
                             config: SchedulerConfiguration) -> None:
        with self._lock:
            import dataclasses as _dc
            config = _dc.replace(config)
            config.modify_index = self._bump("scheduler_config", index)
            self.scheduler_config = config
            self._commit()

    def get_scheduler_config(self) -> SchedulerConfiguration:
        with self._lock:
            return self.scheduler_config

    # ------------------------------------------------------------------ ACL
    # ref nomad/state/state_store.go ACL tables (acl_policy, acl_token)

    def upsert_acl_policies(self, index: int, policies: list) -> None:
        with self._lock:
            idx = self._bump("acl_policy", index)
            for pol in policies:
                pol = pol.copy()
                existing = self.acl_policies.get(pol.name)
                pol.create_index = existing.create_index if existing else idx
                pol.modify_index = idx
                self.acl_policies[pol.name] = pol
            self._commit()

    def delete_acl_policies(self, index: int, names: list[str]) -> None:
        with self._lock:
            self._bump("acl_policy", index)
            for name in names:
                self.acl_policies.pop(name, None)
            self._commit()

    def acl_policy_by_name(self, name: str):
        with self._lock:
            return self.acl_policies.get(name)

    def iter_acl_policies(self) -> list:
        with self._lock:
            return sorted(self.acl_policies.values(), key=lambda p: p.name)

    def upsert_acl_tokens(self, index: int, tokens: list) -> None:
        with self._lock:
            idx = self._bump("acl_token", index)
            for tok in tokens:
                tok = tok.copy()
                existing = self.acl_tokens.get(tok.accessor_id)
                tok.create_index = (existing.create_index if existing
                                    else idx)
                tok.modify_index = idx
                if existing and existing.secret_id != tok.secret_id:
                    self._acl_token_by_secret.pop(existing.secret_id, None)
                self.acl_tokens[tok.accessor_id] = tok
                self._acl_token_by_secret[tok.secret_id] = tok.accessor_id
            self._commit()

    def delete_acl_tokens(self, index: int, accessor_ids: list[str]) -> None:
        with self._lock:
            self._bump("acl_token", index)
            for aid in accessor_ids:
                tok = self.acl_tokens.pop(aid, None)
                if tok is not None:
                    self._acl_token_by_secret.pop(tok.secret_id, None)
            self._commit()

    def acl_token_by_accessor(self, accessor_id: str):
        with self._lock:
            return self.acl_tokens.get(accessor_id)

    def acl_token_by_secret(self, secret_id: str):
        with self._lock:
            aid = self._acl_token_by_secret.get(secret_id)
            return self.acl_tokens.get(aid) if aid else None

    def iter_acl_tokens(self) -> list:
        with self._lock:
            return sorted(self.acl_tokens.values(),
                          key=lambda t: t.create_index)

    # ------------------------------------------------------------ namespaces

    def upsert_namespaces(self, index: int, namespaces: list[dict]) -> None:
        with self._lock:
            self._bump("namespaces", index)
            for ns in namespaces:
                self.namespaces[ns["name"]] = dict(ns)
            self._commit()

    def delete_namespaces(self, index: int, names: list[str]) -> None:
        with self._lock:
            self._bump("namespaces", index)
            for name in names:
                if name != "default":   # request validation lives in Server
                    self.namespaces.pop(name, None)
            self._commit()

    def namespace_by_name(self, name: str) -> Optional[dict]:
        with self._lock:
            return self.namespaces.get(name)

    def iter_namespaces(self) -> list[dict]:
        with self._lock:
            return sorted(self.namespaces.values(), key=lambda n: n["name"])


class StateSnapshot:
    """Point-in-time read-only view. Shallow dict copies are safe because
    stored objects are immutable-by-convention (writers always insert fresh
    copies)."""

    def __init__(self, store: StateStore):
        self.index = store._index
        self.nodes = dict(store.nodes)
        self.jobs = dict(store.jobs)
        self.job_versions = dict(store.job_versions)
        self.evals = dict(store.evals)
        self.allocs = dict(store.allocs)
        self.job_summaries = dict(store.job_summaries)
        self.deployments = dict(store.deployments)
        self.scheduler_config = store.scheduler_config
        self.csi_volumes = dict(store.csi_volumes)
        self.csi_plugins = dict(store.csi_plugins)
        self._allocs_by_node = {k: set(v) for k, v in store._allocs_by_node.items()}
        self._allocs_by_job = {k: set(v) for k, v in store._allocs_by_job.items()}
        self._evals_by_job = {k: set(v) for k, v in store._evals_by_job.items()}
        self.usage = store.usage.view()

    # read API mirrors the scheduler State interface (ref scheduler/scheduler.go:66)

    def latest_index(self) -> int:
        return self.index

    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self.nodes.get(node_id)

    def csi_volume_by_id(self, ns: str, vol_id: str):
        return self.csi_volumes.get((ns, vol_id))

    def iter_nodes(self) -> list[Node]:
        return list(self.nodes.values())

    def iter_jobs(self, ns: Optional[str] = None) -> list[Job]:
        return [j for j in self.jobs.values()
                if ns is None or j.namespace == ns]

    def iter_evals(self) -> list[Evaluation]:
        return list(self.evals.values())

    def iter_allocs(self) -> list[Allocation]:
        return list(self.allocs.values())

    def job_summary(self, ns: str, job_id: str) -> Optional[JobSummary]:
        return self.job_summaries.get((ns, job_id))

    def ready_nodes_in_dcs(self, datacenters: Iterable[str]) -> list[Node]:
        dcs = set(datacenters)
        return [n for n in self.nodes.values()
                if n.ready() and n.datacenter in dcs]

    def job_by_id(self, ns: str, job_id: str) -> Optional[Job]:
        return self.jobs.get((ns, job_id))

    def job_by_version(self, ns: str, job_id: str, version: int) -> Optional[Job]:
        return self.job_versions.get((ns, job_id, version))

    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self.evals.get(eval_id)

    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self.allocs.get(alloc_id)

    def allocs_by_node(self, node_id: str) -> list[Allocation]:
        return [self.allocs[a] for a in self._allocs_by_node.get(node_id, ())
                if a in self.allocs]

    def allocs_by_job(self, ns: str, job_id: str) -> list[Allocation]:
        return [self.allocs[a] for a in self._allocs_by_job.get((ns, job_id), ())
                if a in self.allocs]

    def evals_by_job(self, ns: str, job_id: str) -> list[Evaluation]:
        return [self.evals[e] for e in self._evals_by_job.get((ns, job_id), ())
                if e in self.evals]

    def namespace_alloc_counts(self) -> dict[str, int]:
        """Snapshot twin of StateStore.namespace_alloc_counts — the
        convex quota budget reads whichever state view the eval holds."""
        counts: dict[str, int] = {}
        for (ns, _job), ids in self._allocs_by_job.items():
            counts[ns] = counts.get(ns, 0) + len(ids)
        return counts

    def deployment_by_id(self, deployment_id: str) -> Optional[Deployment]:
        return self.deployments.get(deployment_id)

    def deployments_by_job(self, ns: str, job_id: str) -> list[Deployment]:
        return [d for d in self.deployments.values()
                if d.namespace == ns and d.job_id == job_id]

    def latest_deployment_by_job(self, ns: str, job_id: str
                                 ) -> Optional[Deployment]:
        ds = [d for d in self.deployments.values()
              if d.namespace == ns and d.job_id == job_id]
        return max(ds, key=lambda d: d.create_index) if ds else None

    def get_scheduler_config(self) -> SchedulerConfiguration:
        return self.scheduler_config
