"""Server: the control plane assembly (ref nomad/server.go:293 NewServer)
plus the RPC endpoint surface (ref nomad/job_endpoint.go, node_endpoint.go,
eval_endpoint.go, alloc_endpoint.go, deployment_endpoint.go,
operator_endpoint.go — one method family per resource).

Single-node for now: leadership is established immediately on start
(ref nomad/leader.go:224 establishLeadership) — broker/planner/periodic/
blocked-evals enabled, pending evals restored from state.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from .. import faults
from ..metrics import metrics, record_swallowed_error
from ..obs import trace
from ..rpc.codec import NotLeaderError
from ..state import StateStore
from ..structs import (
    Allocation, DrainStrategy, Evaluation, Job, Node, SchedulerConfiguration,
    ALLOC_CLIENT_FAILED, ALLOC_CLIENT_COMPLETE, ALLOC_DESIRED_STOP,
    EVAL_STATUS_CANCELLED, EVAL_STATUS_PENDING,
    JOB_TYPE_BATCH, JOB_TYPE_SERVICE, JOB_TYPE_SYSTEM,
    JOB_TYPE_SYSBATCH, NODE_SCHED_ELIGIBLE, NODE_SCHED_INELIGIBLE,
    NODE_STATUS_DOWN, NODE_STATUS_READY,
    TRIGGER_ALLOC_STOP, TRIGGER_JOB_DEREGISTER, TRIGGER_JOB_REGISTER,
    TRIGGER_NODE_DRAIN, TRIGGER_NODE_UPDATE, TRIGGER_RETRY_FAILED_ALLOC,
    CORE_JOB_EVAL_GC, CORE_JOB_JOB_GC, CORE_JOB_NODE_GC,
    CORE_JOB_DEPLOYMENT_GC, CORE_JOB_FORCE_GC, JOB_TYPE_CORE,
    new_id,
)
from .blocked_evals import BlockedEvals
from .core_sched import CoreScheduler
from .deployment_watcher import DeploymentWatcher
from .drainer import NodeDrainer
from .eval_broker import EvalBroker
from .fsm import (
    ALLOC_CLIENT_UPDATE, ALLOC_UPDATE_DESIRED_TRANSITION, EVAL_UPDATE,
    JOB_DEREGISTER, JOB_REGISTER, NODE_REGISTER, NODE_UPDATE_DRAIN,
    NODE_UPDATE_ELIGIBILITY, NODE_UPDATE_STATUS, NomadFSM, RaftLog,
    SCHEDULER_CONFIG,
)
from .heartbeat import FlapDamper, HeartbeatTimers, create_node_evals
from .periodic import PeriodicDispatch
from .plan_apply import LEADERSHIP_LOST, Planner
from .worker import Worker

def _warmup_floor() -> int:
    """The node-count floor below which establish-time device work (AOT
    warmup, tensor reseed, standby twin feed) is skipped. Reads the
    solver's authoritative backend.WARMUP_MIN_NODES when that module is
    already loaded — WITHOUT importing it (the gates run before deciding
    whether jax should be touched at all) — else the same default."""
    import sys
    backend = sys.modules.get("nomad_tpu_torch.solver.backend")
    return getattr(backend, "WARMUP_MIN_NODES", 256)


def _device_work_gate(env_var: str, node_count: int) -> bool:
    """ONE predicate for every establish/standby device-work gate
    (backend.warmup applies the same semantics to NOMAD_AOT_WARMUP):
    env "0" disables, "1" forces below the floor, default floor-gates."""
    import os
    mode = os.environ.get(env_var, "")
    if mode == "0":
        return False
    return mode == "1" or node_count >= _warmup_floor()


# workers do NOT consume "_failed": the leader reaps the dead-letter queue
# (ref nomad/leader.go:782 reapFailedEvaluations)
SCHEDULER_TYPES = [JOB_TYPE_SERVICE, JOB_TYPE_BATCH, JOB_TYPE_SYSTEM,
                   JOB_TYPE_SYSBATCH, JOB_TYPE_CORE]

# network RPC surface (ref nomad/server.go:1146 setupRpcServer):
# method name -> (Server attr, leader_only). Writes go through Raft and are
# leader-only; reads run on any server against its replicated state.
RPC_ENDPOINTS = {
    "Node.Register": ("node_register", True),
    "Node.UpdateStatus": ("node_update_status", True),
    "Node.UpdateDrain": ("node_update_drain", True),
    "Node.UpdateEligibility": ("node_update_eligibility", True),
    "Node.GetClientAllocs": ("node_get_client_allocs", False),
    "Node.UpdateAlloc": ("node_update_allocs", True),
    "Alloc.GetAlloc": ("alloc_get", False),
    "Alloc.Stop": ("alloc_stop", True),
    "Node.GetHTTPAddr": ("node_get_http_addr", False),
    "Job.Register": ("job_register", True),
    "Job.Deregister": ("job_deregister", True),
    "Job.Plan": ("job_plan", True),
    "Job.Dispatch": ("job_dispatch", True),
    "Job.Evaluate": ("job_evaluate", True),
    "Job.Scale": ("job_scale", True),
    "Job.ScaleStatus": ("job_scale_status", False),
    "Job.Revert": ("job_revert", True),
    "Job.Stable": ("job_stable", True),
    "Scaling.ListPolicies": ("scaling_policies_list", False),
    "Scaling.GetPolicy": ("scaling_policy_get", False),
    "Search.PrefixSearch": ("search_prefix", False),
    "Search.FuzzySearch": ("search_fuzzy", False),
    "CSIVolume.Register": ("csi_volume_register", True),
    "CSIVolume.Deregister": ("csi_volume_deregister", True),
    "CSIVolume.Claim": ("csi_volume_claim", True),
    "CSIVolume.List": ("csi_volume_list", False),
    "CSIVolume.Get": ("csi_volume_get", False),
    "CSIVolume.NodeDetachPending": ("csi_node_detach_pending", False),
    "CSIVolume.ControllerDetachPending":
        ("csi_controller_detach_pending", False),
    "CSIPlugin.List": ("csi_plugin_list", False),
    "CSIPlugin.Get": ("csi_plugin_get", False),
    "Service.Register": ("service_register", True),
    "Service.Deregister": ("service_deregister", True),
    "Service.List": ("service_list", False),
    "Service.Instances": ("service_instances", False),
    "Intention.Upsert": ("intention_upsert", True),
    "Intention.Delete": ("intention_delete", True),
    "Intention.List": ("intention_list", False),
    "Intention.Allowed": ("intention_allowed", False),
    "Vault.DeriveToken": ("vault_derive_token", True),
    "Node.DeriveSIToken": ("derive_si_token", True),
    "Vault.RenewToken": ("vault_renew_token", True),
    "Vault.RevokeToken": ("vault_revoke_token", True),
    # leader-only: the in-memory dev backend lives in one process; routing
    # every secret op at the leader keeps reads/renews consistent (a real
    # Vault backend is an external shared service, unaffected)
    "Vault.Read": ("secret_read", True),
    "Eval.Dequeue": ("eval_dequeue", True),
    "Eval.Ack": ("eval_ack", True),
    "Eval.Nack": ("eval_nack", True),
    "Deployment.List": ("deployment_list", False),
    "Deployment.Promote": ("deployment_promote", True),
    "Deployment.Fail": ("deployment_fail", True),
    "Deployment.Pause": ("deployment_pause", True),
    "Operator.SchedulerGetConfiguration": ("get_scheduler_configuration",
                                           False),
    "Operator.SchedulerSetConfiguration": ("set_scheduler_configuration",
                                           True),
    "Operator.SnapshotSave": ("snapshot_save", False),
    "Operator.SnapshotRestore": ("snapshot_restore", True),
    "Operator.RaftGetConfiguration": ("operator_raft_configuration", False),
    "Operator.RaftRemovePeer": ("operator_raft_remove_peer", True),
    "Operator.RaftAddPeer": ("operator_raft_add_peer", True),
    "Operator.AutopilotGetConfiguration": ("operator_autopilot_get_config",
                                           False),
    "Operator.AutopilotSetConfiguration": ("operator_autopilot_set_config",
                                           True),
    "Operator.ServerHealth": ("operator_server_health", False),
    "ACL.ListPolicies": ("acl_list_policies_wire", False),
    "ACL.ListTokens": ("acl_list_tokens_wire", False),
    "Status.Members": ("members", False),
    "Status.Regions": ("regions", False),
    # read plane (ISSUE 16): list/get served from any server's replicated
    # store; `stale=False` on a follower raises NotLeaderError so the
    # client's transparent redirect keeps default reads leader-consistent
    "Read.List": ("read_list", False),
    "Read.Get": ("read_get", False),
}


class Server:
    def __init__(self, num_workers: int = 2, logger: Optional[Callable] = None,
                 gc_interval: float = 300.0, acl_enabled: bool = False,
                 region: str = "global", authoritative_region: str = "",
                 name: str = "", secrets_file: str = ""):
        self.logger = logger or (lambda msg: None)
        self.region = region
        # cross-region ACL replication source (ref nomad/leader.go:1288);
        # empty or equal to `region` means this region is authoritative
        self.authoritative_region = authoritative_region or region
        # management token of the authoritative region used by the ACL
        # replication loop (ref config acl.replication_token)
        self.replication_token = ""
        # serf-style bootstrap_expect: >1 means wait until gossip sees
        # that many same-region servers, then all bootstrap with the
        # same config (ref nomad/serf.go maybeBootstrap)
        self.bootstrap_expect = 1
        self.name = name or f"server-{new_id()[:8]}"
        self.fsm = NomadFSM()
        self.state: StateStore = self.fsm.state
        # event-sink failures in _emit log through the agent (counted in
        # nomad.swallowed_errors either way)
        self.state.logger = self.logger
        self.raft = RaftLog(self.fsm)
        # the broker reads its overload knobs (depth cap, enqueue TTL)
        # straight from the raft-replicated scheduler config — the same
        # hot-reload path every other runtime knob rides (ISSUE 8)
        self.eval_broker = EvalBroker(
            config_fn=self.state.get_scheduler_config)
        from .event_broker import EventBroker
        # backpressure rung 1 (opt-in at construction: the server's
        # consumers watch latest STATE per key, not an exhaustive event
        # log) rides the overload pressure state: bursty fan-out
        # coalesces to latest-state delivery before anything drops
        # (self.overload is assigned below; the lambda defers)
        self.event_broker = EventBroker(
            coalesce_after=64,
            pressure_fn=lambda: self.overload.state())
        self.state.event_sinks.append(self.event_broker.sink)
        # batched twin (ISSUE 20): a whole FSM apply-batch window's
        # events land in the broker as ONE publish
        self.state.event_batch_sinks.append(self.event_broker.sink_batch)
        self.blocked_evals = BlockedEvals(self._enqueue_unblocked)
        from .acl_endpoint import ACLEndpoint
        self.acl = ACLEndpoint(self, enabled=acl_enabled)
        self.planner = Planner(self.raft, self.state)
        # overload brain (ISSUE 8): ingress admission buckets + the
        # ok->saturated->shedding pressure state driving the brownout
        # levers; ticked by the leader loop, reset on revoke
        from .overload import OverloadController
        self.overload = OverloadController(
            broker_depth_fn=self.eval_broker.depth,
            plan_depth_fn=self.planner.queue.depth,
            config_fn=self.state.get_scheduler_config)
        # a cap trip re-computes pressure immediately — a sub-second
        # burst must engage brownout before the next 1s leader tick
        self.eval_broker.on_overflow = self.overload.tick
        self.periodic = PeriodicDispatch(self)
        # RPC write-dedup (ISSUE 18): one per process, shared by the TCP
        # and virtual dispatchers (wired in rpc_listen*) — retried writes
        # whose reply was lost return the original committed result
        from ..rpc.dedup import WriteDedup
        self.write_dedup = WriteDedup(self.state)
        self.heartbeats = HeartbeatTimers(self)
        # flap damper (ISSUE 10): holds down/up-cycling nodes ineligible
        # with exponential re-admit backoff so reconnect churn cannot
        # oscillate the solver's eligibility mask; shares the heartbeat
        # clock so ManualClock tests drive both from one timeline
        # no explicit clock: the damper tracks heartbeats.clock
        # dynamically, so swapping in a ManualClock moves both
        self.flap_damper = FlapDamper(self)
        self.core_scheduler = CoreScheduler(self)
        self.deployment_watcher = DeploymentWatcher(self)
        self.drainer = NodeDrainer(self)
        from .volume_watcher import VolumeWatcher
        self.volume_watcher = VolumeWatcher(self)
        if secrets_file:
            from ..integrations.secrets import FileSecretsProvider
            self.secrets = FileSecretsProvider(secrets_file)
        else:
            from ..integrations.secrets import InMemorySecretsProvider
            self.secrets = InMemorySecretsProvider()
        self.scheduler_types = SCHEDULER_TYPES
        self.workers = [Worker(self, i) for i in range(num_workers)]
        self.gc_interval = gc_interval
        self._leader_stop = threading.Event()
        self._leader_thread: Optional[threading.Thread] = None
        self.is_leader = False
        self._shutdown_ev = threading.Event()
        # recovery-barrier per-step timings of the most recent successful
        # _establish_leadership (ISSUE 6; the bench failover probe reads
        # these for failover_detail), and the raft term that
        # establishment ran for — a re-election at a NEWER term must
        # re-run the barrier even when the old reign's revoke callback
        # lost the thread race (is_leader still True)
        self._establish_timings: dict[str, float] = {}
        self._established_term = -1
        # serializes _establish_leadership: the election callback and the
        # deferred establish-retry thread must never run the barrier (and
        # double-start every leader subsystem) concurrently
        self._establish_lock = threading.Lock()
        # network RPC (optional; wired by rpc_listen). leader_rpc_addr is
        # maintained by the consensus layer for follower->leader forwarding.
        self.rpc_server = None
        self.leader_rpc_addr = ""
        # multi-server consensus (optional; wired by enable_raft). When set,
        # leadership is election-driven instead of immediate-on-start.
        self.raft_node = None
        # gossip membership + federation (optional; wired by gossip_listen):
        # same-region members drive Raft peer management, cross-region
        # members populate the federation routing table (ref serf.go)
        self.gossip = None
        # region -> {server name -> rpc_addr} of ALIVE foreign servers
        self.region_servers: dict[str, dict[str, str]] = {}

        # the FSM tells the leader about new evals (ref fsm.go:760)
        self.fsm.on_eval_update.append(self._on_eval_update)
        # followers advance the passive solver tensor twin as replicated
        # plan results land (ISSUE 6 warm standby)
        self.fsm.on_plan_apply.append(self._feed_standby_twin)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        import os

        self._shutdown_ev.clear()
        from ..runtime import enable_compile_cache, tune_gc
        tune_gc()          # allocation-heavy plans vs default GC cadence
        if os.environ.get("NOMAD_COMPILE_CACHE"):
            # persistent XLA compile cache BEFORE the first jit: a warm
            # restart then replays serialized executables instead of
            # recompiling the solver grid as placement blackout
            enable_compile_cache()
        if self.raft_node is None:
            self._establish_leadership()
        else:
            self.raft_node.start()
            # warm standby (ISSUE 6): a follower pre-warms the AOT
            # compile grid in the background so a later promotion pays
            # ~0 compile instead of a cold-XLA placement blackout
            threading.Thread(target=self._standby_warmup_loop, daemon=True,
                             name="standby-warmup").start()
        for w in self.workers:
            w.start()

    def enable_raft(self, node_id: str, peers: dict[str, str],
                    data_dir: str = None, **raft_kw) -> None:
        """Switch from the single-node log to elected multi-server consensus
        (ref nomad/server.go:1221 setupRaft + leader.go:56 monitorLeadership).
        Must be called after rpc_listen() and before start()."""
        if self.rpc_server is None:
            raise RuntimeError("enable_raft requires rpc_listen() first")
        from .raft import RaftNode
        peers = dict(peers)
        peers.setdefault(node_id, self.rpc_server.addr)
        self.raft_node = RaftNode(self.fsm, node_id, self.rpc_server, peers,
                                  data_dir=data_dir, logger=self.logger,
                                  **raft_kw)
        self.raft = self.raft_node
        self.planner.raft = self.raft_node
        self.raft_node.on_leadership_change = self._on_leadership_change
        self.rpc_server.leadership_fn = self._raft_leadership

    # RPC methods the admission buckets never touch: raft consensus
    # traffic (rate-limiting replication/votes under load would turn an
    # overload into an outage) and the node heartbeat path (starving
    # heartbeats mass-invalidates the fleet exactly when it is busiest).
    _ADMISSION_EXEMPT_PREFIXES = ("Raft.",)
    _ADMISSION_EXEMPT = {"Node.UpdateStatus", "Status.Members",
                         "Status.Regions"}
    # long-hold methods billed against the blocking-query bucket
    _ADMISSION_BLOCKING = {"Node.GetClientAllocs", "Eval.Dequeue"}

    def _rpc_admission(self, method: str, leader_only: bool) -> None:
        """RpcDispatcher admission hook (ISSUE 8): classify the method
        (write / read / blocking) and probe the matching token bucket;
        raises overload.RateLimitExceeded for the dispatcher to envelope
        as a RateLimitError with the retry hint."""
        if method in self._ADMISSION_EXEMPT or \
                method.startswith(self._ADMISSION_EXEMPT_PREFIXES):
            return
        from .overload import CLASS_BLOCKING, CLASS_READ, CLASS_WRITE
        if method in self._ADMISSION_BLOCKING:
            cls = CLASS_BLOCKING
        elif leader_only:
            cls = CLASS_WRITE
        else:
            cls = CLASS_READ
        self.overload.admit(cls)

    def _raft_leadership(self) -> tuple[bool, str]:
        is_leader, leader_addr = self.raft_node.leadership()
        self.leader_rpc_addr = leader_addr
        return is_leader, leader_addr

    def _on_leadership_change(self, is_leader: bool) -> None:
        """ref nomad/leader.go:56 monitorLeadership"""
        if is_leader:
            self.logger("server: leadership acquired")
            self._establish_leadership()
        else:
            self.logger("server: leadership lost")
            self._revoke_leadership()

    def rpc_listen(self, bind: str = "127.0.0.1", port: int = 0,
                   key: bytes = None, tls=None) -> str:
        """Start serving the network RPC surface (ref nomad/rpc.go
        listen/handleConn). Returns the bound "host:port" address."""
        from ..rpc.server import DEFAULT_KEY, RpcServer
        self.rpc_server = RpcServer(bind=bind, port=port,
                                    key=key or DEFAULT_KEY,
                                    logger=self.logger, tls=tls)
        self.rpc_server.register_endpoints(self, RPC_ENDPOINTS)
        self.rpc_server.leadership_fn = \
            lambda: (self.is_leader, self.leader_rpc_addr)
        self.rpc_server.admission_fn = self._rpc_admission
        self.rpc_server.dedup = self.write_dedup
        self.rpc_server.start()
        return self.rpc_server.addr

    def rpc_listen_virtual(self, network, name: str,
                           key: bytes = None) -> str:
        """Attach this server to an in-memory `rpc.virtual.VirtualNetwork`
        instead of a TCP listener — the deterministic multi-server test
        transport (ISSUE 6). Interface-identical to rpc_listen():
        enable_raft()/forwarding ride on top unchanged, and the network's
        partition/drop/delay/crash controls apply to every hop."""
        from ..rpc.server import DEFAULT_KEY
        self.rpc_server = network.server(name, key=key or DEFAULT_KEY,
                                         logger=self.logger)
        self.rpc_server.register_endpoints(self, RPC_ENDPOINTS)
        self.rpc_server.leadership_fn = \
            lambda: (self.is_leader, self.leader_rpc_addr)
        self.rpc_server.admission_fn = self._rpc_admission
        self.rpc_server.dedup = self.write_dedup
        self.rpc_server.start()
        return self.rpc_server.addr

    @property
    def rpc_addr(self) -> str:
        return self.rpc_server.addr if self.rpc_server is not None else ""

    # ------------------------------------------------- gossip / federation

    def gossip_listen(self, bind: str = "127.0.0.1", port: int = 0,
                      key: bytes = None) -> str:
        """Join the gossip fabric (ref nomad/server.go:1388 setupSerf).
        Requires rpc_listen() first — the rpc addr rides in our tags so
        discovered servers are immediately routable."""
        if self.rpc_server is None:
            raise RuntimeError("gossip_listen requires rpc_listen() first")
        from ..rpc.server import DEFAULT_KEY
        from .gossip import Gossip
        tags = {"role": "nomad-server", "region": self.region,
                "rpc_addr": self.rpc_server.addr, "id": self.name}
        if getattr(self, "http_advertise", ""):
            # lets followers proxy HTTP writes to the leader's HTTP
            # surface (ref serf tags port/addr feeding rpc forwarding)
            tags["http_addr"] = self.http_advertise
        self.gossip = Gossip(
            name=self.name, bind=bind, port=port,
            key=key or DEFAULT_KEY, logger=self.logger,
            tags=tags,
            on_join=self._on_gossip_join,
            on_leave=self._on_gossip_leave,
            on_fail=self._on_gossip_fail)
        self.gossip.start()
        self.rpc_server.region = self.region
        self.rpc_server.region_servers_fn = self._region_servers_snapshot
        return self.gossip.addr

    def gossip_join(self, seeds: list[str]) -> int:
        """ref serf.Join via -join/retry_join"""
        return self.gossip.join(seeds)

    def _region_servers_snapshot(self) -> dict[str, dict[str, str]]:
        return {r: dict(servers) for r, servers in
                self.region_servers.items()}

    def members(self) -> list[dict]:
        """ref nomad/serf.go Members for `server members` / agent API"""
        return self.gossip.members_snapshot() if self.gossip else []

    def leader_http_addr(self) -> str:
        """The current raft leader's advertised HTTP address (via its
        gossip tags), or "" when unknown — the follower HTTP forwarding
        target (ref nomad/rpc.go forward; our proxy rides HTTP)."""
        if self.raft_node is None or self.gossip is None:
            return ""
        _, leader_rpc = self.raft_node.leadership()
        leader_id = self.raft_node.leader_id
        for m in self.members():
            t = m.get("tags", {})
            if t.get("role") != "nomad-server":
                continue
            if t.get("id") == leader_id or \
                    (leader_rpc and t.get("rpc_addr") == leader_rpc):
                return t.get("http_addr", "")
        return ""

    def regions(self) -> list[str]:
        out = {self.region} | set(self.region_servers)
        return sorted(out)

    def _maybe_bootstrap(self) -> None:
        """ref nomad/serf.go maybeBootstrap: once bootstrap_expect
        same-region servers are visible, every one of them bootstraps
        raft with the identical (sorted) initial configuration."""
        if self.raft_node is None or self.bootstrap_expect <= 1 or \
                self.raft_node.bootstrap:
            return
        if self.gossip is None:
            return
        servers = {}
        for m in self.gossip.alive_members():
            t = m.tags
            if t.get("role") == "nomad-server" and \
                    t.get("region", "") == self.region and \
                    t.get("id") and t.get("rpc_addr"):
                servers[t["id"]] = t["rpc_addr"]
        if len(servers) >= self.bootstrap_expect:
            peers = dict(sorted(servers.items()))
            if self.raft_node.bootstrap_with(peers):
                self.logger(
                    f"server: bootstrap_expect={self.bootstrap_expect} "
                    f"reached; bootstrapping with {sorted(peers)}")

    def _on_gossip_join(self, member) -> None:
        """ref nomad/serf.go:98 nodeJoin (+ maybeBootstrap)"""
        tags = member.tags
        if tags.get("role") != "nomad-server":
            return
        self._maybe_bootstrap()
        region = tags.get("region", "")
        if region != self.region:
            self.region_servers.setdefault(region, {})[member.name] = \
                tags.get("rpc_addr", "")
            self.logger(f"server: federated server {member.name} "
                        f"joined region {region}")
            return
        # same region: NEW servers are adopted as NON-VOTERS (leader-
        # driven serf-join -> raft-autopilot AddNonvoter) and promoted by
        # the autopilot tick after stabilizing. A member flapping
        # SUSPECT->ALIVE re-fires this join and must KEEP its voter
        # status — demoting an established voter would silently shrink
        # the commit quorum.
        if self.raft_node is not None and self.is_leader and \
                tags.get("id") and tags.get("rpc_addr"):
            pid = tags["id"]
            voter = (pid in self.raft_node.peers and
                     pid not in self.raft_node.nonvoters)
            try:
                self.raft_node.add_peer(pid, tags["rpc_addr"], voter=voter)
                self.logger(f"server: added raft peer {pid}"
                            f"{'' if voter else ' (non-voter)'}")
            except Exception as e:      # noqa: BLE001
                self.logger(f"server: add_peer {pid} failed: {e}")

    def _on_gossip_fail(self, member) -> None:
        """ref nomad/serf.go:163 nodeFailed + autopilot dead-server
        cleanup: the leader drops failed same-region servers from Raft."""
        tags = member.tags
        if tags.get("role") != "nomad-server":
            return
        region = tags.get("region", "")
        if region != self.region:
            self.region_servers.get(region, {}).pop(member.name, None)
            return
        if self.raft_node is not None and self.is_leader and tags.get("id"):
            try:
                self.raft_node.remove_peer(tags["id"])
                self.logger(f"server: removed failed peer {tags['id']}")
            except Exception as e:      # noqa: BLE001
                self.logger(f"server: remove_peer failed: {e}")

    def _on_gossip_leave(self, member) -> None:
        self._on_gossip_fail(member)

    def _reconcile_gossip_peers(self) -> None:
        """Leader tick: converge raft membership onto the gossip view of
        same-region servers (ref nomad/leader.go reconcileMember). Event
        callbacks handle the common case instantly; this heals joins that
        raced leadership establishment and any missed UDP event."""
        if self.gossip is None or self.raft_node is None or \
                not self.is_leader:
            return
        alive = {}
        for m in self.gossip.alive_members():
            tags = m.tags
            if tags.get("role") == "nomad-server" and \
                    tags.get("region", "") == self.region and \
                    tags.get("id") and tags.get("rpc_addr"):
                alive[tags["id"]] = tags["rpc_addr"]
        peers = dict(self.raft_node.peers)
        for pid, addr in alive.items():
            if peers.get(pid) != addr:
                # keep the existing voter/non-voter status: reconcile must
                # not promote ahead of the autopilot stabilization window
                voter = pid in peers and pid not in self.raft_node.nonvoters
                self.raft_node.add_peer(pid, addr, voter=voter)
                self.logger(f"server: reconciled raft peer {pid}")

    # --------------------------------------------------- ACL replication

    def _require_replication_token(self, secret: str) -> None:
        """Token listings carry SecretIDs: with ACLs on, only a management
        token may read them (ref acl_endpoint.go: replication endpoints
        require the replication/management token)."""
        if not self.acl.enabled:
            return
        acl = self.acl.resolve_token(secret)
        if not acl.is_management():
            from .acl_endpoint import PermissionDeniedError
            raise PermissionDeniedError(
                "ACL replication requires a management token")

    def acl_list_policies_wire(self, secret: str = "") -> list[dict]:
        """Replication source endpoint (ref acl_endpoint.go ListPolicies
        with the replication token)."""
        from ..api_codec import to_api
        self._require_replication_token(secret)
        return [to_api(p) for p in self.state.iter_acl_policies()]

    def acl_list_tokens_wire(self, global_only: bool = True,
                             secret: str = "") -> list[dict]:
        from ..api_codec import to_api
        self._require_replication_token(secret)
        return [to_api(t) for t in self.state.iter_acl_tokens()
                if t.global_ or not global_only]

    def _acl_replication_loop(self, interval: float = 1.0) -> None:
        """Mirror policies + global tokens from the authoritative region.
        Pull-based full-set diff per cycle — the reference diffs by
        modify_index; at control-plane ACL cardinality the full set is a
        single small RPC either way."""
        from ..api_codec import from_api
        from ..structs.acl_structs import ACLPolicy, ACLToken
        from .fsm import (
            ACL_POLICY_DELETE, ACL_POLICY_UPSERT, ACL_TOKEN_DELETE,
            ACL_TOKEN_UPSERT,
        )
        while not self._leader_stop.wait(interval):
            servers = self.region_servers.get(self.authoritative_region, {})
            addrs = [a for a in servers.values() if a]
            if not addrs:
                continue
            try:
                from ..rpc.client import RpcClient
                with RpcClient(addrs, key=self.rpc_server.key,
                               tls=self.rpc_server.tls) as cli:
                    pol_wire = cli.call("ACL.ListPolicies",
                                        secret=self.replication_token)
                    tok_wire = cli.call("ACL.ListTokens", True,
                                        secret=self.replication_token)
            except Exception as e:      # noqa: BLE001
                self.logger(f"server: acl replication fetch failed: {e}")
                continue
            try:
                want_pols = {p.name: p for p in
                             (from_api(ACLPolicy, w) for w in pol_wire)}
                want_toks = {t.accessor_id: t for t in
                             (from_api(ACLToken, w) for w in tok_wire)}
                have_pols = {p.name: p for p in
                             self.state.iter_acl_policies()}
                have_toks = {t.accessor_id: t for t in
                             self.state.iter_acl_tokens() if t.global_}
                up_p = [p for n, p in want_pols.items()
                        if n not in have_pols or
                        have_pols[n].rules != p.rules or
                        have_pols[n].description != p.description]
                del_p = [n for n in have_pols if n not in want_pols]
                up_t = [t for a, t in want_toks.items()
                        if a not in have_toks or
                        have_toks[a].secret_id != t.secret_id or
                        have_toks[a].policies != t.policies or
                        have_toks[a].type != t.type]
                del_t = [a for a in have_toks if a not in want_toks]
                if up_p:
                    self.raft.apply(ACL_POLICY_UPSERT, {"policies": up_p})
                if del_p:
                    self.raft.apply(ACL_POLICY_DELETE, {"names": del_p})
                if up_t:
                    self.raft.apply(ACL_TOKEN_UPSERT, {"tokens": up_t})
                if del_t:
                    self.raft.apply(ACL_TOKEN_DELETE,
                                    {"accessor_ids": del_t})
            except Exception as e:      # noqa: BLE001
                self.logger(f"server: acl replication apply failed: {e}")

    def shutdown(self) -> None:
        self._shutdown_ev.set()
        if self.gossip is not None:
            # broadcast LEFT and close the UDP socket — a shut-down
            # server must not keep acking probes and looking alive
            try:
                self.gossip.leave()
            except Exception:           # noqa: BLE001
                self.gossip.shutdown()
        if self.raft_node is not None:
            self.raft_node.shutdown()
        if self.rpc_server is not None:
            self.rpc_server.shutdown()
        self._leader_stop.set()
        for w in self.workers:
            w.stop()
        self.deployment_watcher.stop()
        self.drainer.stop()
        self.planner.stop()
        self.eval_broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.periodic.set_enabled(False)
        self.heartbeats.stop()
        for w in self.workers:
            w.join(1.0)

    def _revoke_leadership(self) -> None:
        """ref nomad/leader.go revokeLeadership: disable every leader-only
        subsystem; scheduling resumes wherever the new leader is. Pendings
        failed here carry the distinct leadership-lost disposition
        (counted in `nomad.plan.leadership_lost`, ISSUE 6 satellite)."""
        with self._establish_lock:
            was_leader = self.is_leader
            root = trace.begin_root("leader.revoke", was_leader=was_leader)
            try:
                with trace.use(root):
                    self._revoke_leadership_locked()
            except BaseException as e:
                root.end("error", error=repr(e)[:200])
                raise
            root.end("ok" if was_leader and not self.is_leader else "stale")

    def _revoke_leadership_locked(self) -> None:
        if not self.is_leader:
            return
        if self._still_leader() and self.raft_node is not None and \
                self.raft_node.current_term == self._established_term:
            # stale revoke: the deposal this callback reports has already
            # been superseded by a re-election whose establishment RAN
            # (the term matches what the barrier last established;
            # callback threads are unordered). Tearing down now would
            # leave a live leader with every subsystem disabled.
            self.logger("server: ignoring stale leadership revoke")
            return
        self._teardown_leadership_locked(LEADERSHIP_LOST)

    def _teardown_leadership_locked(self, reason: str) -> None:
        self.is_leader = False
        self._leader_stop.set()
        # join before a re-election can clear the stop event, else the old
        # loop never observes it and two leader loops run after re-elect
        if self._leader_thread is not None:
            self._leader_thread.join(timeout=5.0)
            self._leader_thread = None
        self._disable_leader_subsystems(reason=reason)

    def _disable_leader_subsystems(self, reason: str) -> None:
        """Shared by revoke and by a recovery-barrier unwind: every
        leader-only subsystem back to the follower state."""
        self.eval_broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.planner.stop(reason=reason)
        self.periodic.set_enabled(False)
        self.heartbeats.stop()
        self.deployment_watcher.stop()
        self.drainer.stop()
        self.volume_watcher.stop()
        # release the brownout levers: a demoted server must not keep a
        # stale pressure state pinned on the process-wide batcher/tracer
        self.overload.reset()
        # a follower must never re-admit flap-held nodes; the new
        # leader adopts the holds from replicated state at establish
        self.flap_damper.reset()

    def _still_leader(self) -> bool:
        """Is the CONSENSUS layer still calling us leader (independent of
        whether establishment finished)? A shutdown aborts establishment
        the same way a lost election does."""
        if self._shutdown_ev.is_set():
            return False
        return self.raft_node is None or self.raft_node.is_leader()

    # ----------------------------------------- post-election recovery barrier

    # ordered recovery-barrier steps (ISSUE 6; docs/FAILOVER.md). Each is
    # fault-injectable at `leader.establish.<name>` and metered as
    # `nomad.leader.establish.<name>`:
    #   barrier        raft Barrier: FSM reflects every prior-term commit
    #   plan_queue     fail stale plan pendings; start the serial applier
    #   state_cache    reseed/advance the device-resident tensor twins
    #                  (warm when the standby feed tracked this store)
    #   heartbeats     re-arm EVERY node TTL with the failover grace
    #                  window, then start the reaper
    #   watchers       periodic dispatch, deployment/drain/volume watchers
    #   broker_restore re-enqueue pending evals + re-track periodic jobs
    #                  from replicated state (runs after is_leader flips:
    #                  concurrent commits dedup through the broker)

    def _establish_leadership(self) -> None:
        """ref nomad/leader.go:224, hardened into an ordered, metered,
        fault-injectable recovery barrier (ISSUE 6). Establish and
        revoke serialize on one lock, so the election callback, the
        deferred retry thread, and a racing revoke can never interleave
        subsystem starts/stops; a second establish is an idempotent
        no-op (`is_leader` already set), and a stale revoke is detected
        inside (`_still_leader`)."""
        with self._establish_lock:
            # the recovery barrier is a ROOT trace (ISSUE 7): every
            # `leader.establish.<step>` below nests under it, and a
            # failover promotion shows up in /v1/traces next to the
            # evals it unblocked
            root = trace.begin_root(
                "leader.establish",
                term=self.raft_node.current_term
                if self.raft_node is not None else 0)
            try:
                with trace.use(root):
                    # establishment is exclusive by design; the lock
                    # serializes it — nomadlint: disable=LOCK003
                    self._establish_leadership_locked()
            except BaseException as e:
                root.end("error", error=repr(e)[:200])
                raise
            root.end("ok" if self.is_leader else "unwound",
                     is_leader=self.is_leader)

    def _establish_leadership_locked(self) -> None:
        term = self.raft_node.current_term \
            if self.raft_node is not None else 0
        if self.is_leader:
            if term == self._established_term:
                return          # idempotent re-entry, same reign
            # re-elected at a NEWER term while the old reign's subsystems
            # are still up (the deposal's revoke callback lost the thread
            # race to this election callback): tear down first so the new
            # term runs the FULL barrier — skipping it would skip the FSM
            # catch-up of an interim leader's commits and the heartbeat
            # re-arm, the two failure shapes the barrier exists for
            self.logger(f"server: re-elected at term {term} before the "
                        f"term-{self._established_term} revoke ran; "
                        f"re-running the recovery barrier")
            self._teardown_leadership_locked(LEADERSHIP_LOST)
        t_enter = time.perf_counter()
        timings: dict[str, float] = {}
        # Barrier FIRST (ref leader.go:236 raft.Barrier): everything below
        # reads the FSM, which must reflect every entry committed under
        # previous terms — otherwise a just-elected leader can re-enqueue
        # an already-planned eval and double-place it. A slow apply (big
        # replay) RETRIES rather than returning: bailing out would leave a
        # live raft leader with every leader subsystem permanently
        # disabled. Only losing leadership ends the wait.
        t0 = time.perf_counter()
        wait_barrier = getattr(self.raft, "wait_barrier", None)
        while wait_barrier is not None:
            if not self._still_leader():
                self.logger("server: leadership lost during barrier")
                return
            try:
                faults.fire("leader.establish.barrier")
                wait_barrier(timeout=30.0)
                break
            except TimeoutError as e:
                self.logger(f"server: leadership barrier slow, "
                            f"retrying: {e!r}")
            except NotLeaderError as e:     # lost lead mid-wait: done
                self.logger(f"server: leadership barrier failed: {e!r}")
                return
            except Exception as e:      # noqa: BLE001 — transient (incl.
                # injected barrier faults): retry while still leader —
                # returning here would leave a live raft leader with
                # every leader subsystem permanently disabled
                self.logger(f"server: leadership barrier error, "
                            f"retrying: {e!r}")
                # barrier retry backoff; nothing else contends this
                # lock while establishing — nomadlint: disable=LOCK003
                time.sleep(0.05)  # nomadlint: disable=RPC001 — in-process raft barrier retry on the real-time establish path, not a client RPC
        timings["barrier"] = time.perf_counter() - t0
        metrics.add_sample("nomad.leader.establish.barrier",
                           timings["barrier"])
        trace.record_span("leader.establish.barrier", None, t0)

        # step retries back off under the establish lock on purpose
        # (revoke waits for a clean stop) — nomadlint: disable=LOCK003
        ok = (self._establish_step("plan_queue", self._step_plan_queue,
                                   timings)
              and self._establish_step("state_cache", self._step_state_cache,
                                       timings)
              and self._establish_step("heartbeats", self._step_heartbeats,
                                       timings)
              and self._establish_step("watchers", self._step_watchers,
                                       timings))
        if ok:
            # the flip happens BEFORE broker_restore: evals committed while
            # the restore iterates reach the broker via _on_eval_update,
            # evals committed before it are found in state, and the overlap
            # dedups on eval id / job key inside the broker
            self.is_leader = True
            ok = self._establish_step("broker_restore",
                                      self._step_broker_restore, timings)
        if not ok:
            # leadership lost mid-barrier or a step exhausted its retries:
            # unwind to the follower state — a half-established leader
            # must not run — and, if consensus still names us leader,
            # retry the WHOLE barrier shortly (steps are idempotent)
            self.is_leader = False
            self._disable_leader_subsystems(reason=LEADERSHIP_LOST)
            if self._still_leader():
                metrics.incr("nomad.leader.establish_retry")
                threading.Thread(target=self._reestablish_later,
                                 daemon=True,
                                 name="establish-retry").start()
            return
        if not self._still_leader() or not self.is_leader:
            # a revoke raced the tail of the barrier (is_leader may
            # already be False): leave everything in the follower state
            # instead of starting a leader loop for a non-leader
            self.is_leader = False
            self._disable_leader_subsystems(reason=LEADERSHIP_LOST)
            return
        total = time.perf_counter() - t_enter
        timings["total"] = total
        self._establish_timings = timings
        # record the reign as of COMPLETION: if the term moved mid-barrier
        # (we lost and re-won), the queued establish callback for the new
        # term sees the mismatch and re-runs the barrier
        self._established_term = self.raft_node.current_term \
            if self.raft_node is not None else 0
        metrics.add_sample("nomad.leader.establish_s", total)
        metrics.set_gauge("nomad.leader.failover_s", total)
        self._leader_stop.clear()
        self._leader_thread = threading.Thread(
            target=self._leader_loop, daemon=True, name="leader-loop")
        self._leader_thread.start()
        # pre-compile the solver's (kernel, tier, bucket) grid for this
        # cluster size in the background (ISSUE 4): a freshly-promoted
        # leader should not pay cold XLA compiles as placement blackout
        # on its first real eval. Below backend.WARMUP_MIN_NODES this is
        # a no-op (unit-test servers must not compile the world). A
        # warm-standby follower already compiled the grid — warmup then
        # costs one cache probe.
        threading.Thread(target=self._solver_warmup, daemon=True,
                         name="solver-warmup").start()
        # non-authoritative region leaders mirror ACL state from the
        # authoritative region (ref nomad/leader.go:1288
        # replicateACLPolicies / :1368 replicateACLTokens)
        if self.region != self.authoritative_region:
            threading.Thread(target=self._acl_replication_loop, daemon=True,
                             name="acl-replication").start()

    def _establish_step(self, name: str, fn: Callable,
                        timings: dict) -> bool:
        """One barrier step: fault site, bounded retries, per-step timing.
        False aborts establishment (leadership gone or retries spent)."""
        for attempt in range(5):
            if not self._still_leader():
                self.logger(f"server: leadership lost during establish "
                            f"step {name}")
                return False
            t0 = time.perf_counter()
            try:
                with trace.span(f"leader.establish.{name}",
                                attempt=attempt):
                    faults.fire(f"leader.establish.{name}")
                    fn()
            except Exception as e:      # noqa: BLE001 — retried, bounded
                self.logger(f"server: establish step {name} failed "
                            f"(attempt {attempt + 1}/5): {e!r}")
                time.sleep(0.05 * (attempt + 1))
                continue
            timings[name] = time.perf_counter() - t0
            # `name` ranges over the five literal barrier step names
            # nomadlint: disable=OBS001 — bounded step-name set
            metrics.add_sample(f"nomad.leader.establish.{name}",
                               timings[name])
            return True
        metrics.incr("nomad.leader.establish_step_failed")
        self.logger(f"server: establish step {name} exhausted retries")
        return False

    def _step_plan_queue(self) -> None:
        """Stale pendings from a previous reign (or from a drain that
        raced the revoke) fail with the leadership-lost disposition
        before the serial applier restarts."""
        n = self.planner.queue.drain_stale(LEADERSHIP_LOST)
        if n:
            metrics.incr("nomad.plan.leadership_lost", n)
            self.logger(f"server: drained {n} stale plan pendings")
        self.planner.start()

    def _step_state_cache(self) -> None:
        """Promote/reseed the solver's device-resident cluster tensors
        for THIS store (new uid/epoch on a cold takeover; a journal-tail
        replay when the standby twin kept pace). Floor-gated like the AOT
        warmup — seeding builds DEVICE twins, and a unit-test server with
        three nodes must not pay jax backend attach at establish
        (NOMAD_AOT_WARMUP=1 forces, =0 disables, same as backend.warmup).
        Lazy import: a stripped solver-less build skips."""
        if not _device_work_gate("NOMAD_AOT_WARMUP",
                                 self.state.node_count()):
            return
        try:
            from ..solver import state_cache
        except ImportError:
            return
        out = state_cache.reseed(self.state)
        if not out.get("skipped"):
            self.logger(
                f"server: state cache "
                f"{'advanced (warm)' if out['warm'] else 'reseeded'}"
                f" for {out['rows']} nodes at establish")

    def _step_heartbeats(self) -> None:
        self.heartbeats.stop()      # idempotent under step retries
        self.heartbeats.initialize_heartbeat_timers()
        # inherit flap holds a deposed leader committed (flap_held_until
        # rides raft on the eligibility entry) so held nodes still
        # re-admit on schedule after a failover
        self.flap_damper.reset()
        self.flap_damper.adopt(self.state)
        self.heartbeats.start()

    def _step_watchers(self) -> None:
        self.eval_broker.set_enabled(True)
        self.blocked_evals.set_enabled(True)
        self.periodic.set_enabled(True)
        # stop-then-start: a RETRY of this step after a partial failure
        # (e.g. thread creation failing midway) must not leak a second
        # watcher thread — start() is not idempotent, stop() is
        for watcher in (self.deployment_watcher, self.drainer,
                        self.volume_watcher):
            watcher.stop()
            watcher.start()

    def _step_broker_restore(self) -> None:
        # re-enqueue non-terminal evals, re-track periodic jobs
        for ev in self.state.iter_evals():
            if ev.status == EVAL_STATUS_PENDING:
                self.eval_broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)
        for job in self.state.iter_jobs():
            if job.is_periodic() and not job.stopped():
                self.periodic.add(job)

    def _reestablish_later(self) -> None:
        time.sleep(1.0)
        if self._still_leader() and not self.is_leader:
            self._establish_leadership()

    # ------------------------------------------------------- warm standby

    def _standby_warmup_loop(self) -> None:
        """Follower-side AOT warmup (ISSUE 6 warm standby): once the
        replicated cluster crosses the warmup floor, compile the solver
        grid NOW — so failover-to-first-solve is a cache probe, not a
        cold XLA compile. NOMAD_STANDBY_WARMUP=0 disables."""
        import os
        if os.environ.get("NOMAD_STANDBY_WARMUP", "") == "0":
            return
        while not self._shutdown_ev.wait(2.0):
            if self.is_leader:
                return          # the leader establish path owns warmup
            try:
                n = self.state.node_count()
                if n < _warmup_floor():
                    continue
                from ..solver import backend
                out = backend.warmup(
                    n, cfg=self.state.get_scheduler_config())
                if not out.get("skipped"):
                    self.logger(
                        f"server: standby warmup compiled "
                        f"{out['artifacts']} artifacts for bucket "
                        f"{out.get('bucket')} in {out['seconds']}s")
                # operator-visible: this follower is a WARM standby
                metrics.set_gauge("nomad.standby.warmed", 1)
                return
            except Exception as e:  # noqa: BLE001 — warmup is best-effort
                record_swallowed_error("server.standby_warmup", e,
                                       self.logger)
                return

    def _feed_standby_twin(self, index: int) -> None:
        """fsm.on_plan_apply hook: a FOLLOWER advances the passive tensor
        twin as replicated plan results land; the leader's own applier
        feeds the cache via plan_apply.note_commit instead (leader-only
        mutation stays inside the fence-checked applier, LEAD001).
        NOMAD_STANDBY_TWIN: "0" disables, "1" forces even below the
        warmup floor (the failover tests), default floor-gated so small
        in-process clusters never touch the device from an FSM apply."""
        if self.raft_node is None or self.is_leader:
            return
        if not _device_work_gate("NOMAD_STANDBY_TWIN",
                                 self.state.node_count()):
            return
        try:
            from ..solver import state_cache
        except ImportError:
            return
        state_cache.standby_feed(self.state)

    def _solver_warmup(self) -> None:
        """Leader-election AOT warmup (backend.warmup). Lazy import: a
        stripped build without the solver stays bootable; any failure is
        logged, never fatal — evals just pay the compiles lazily."""
        try:
            from ..solver import backend
            out = backend.warmup(len(self.state.iter_nodes()),
                                 cfg=self.state.get_scheduler_config())
            if not out.get("skipped"):
                self.logger(
                    f"server: solver warmup compiled {out['artifacts']} "
                    f"artifacts for bucket {out.get('bucket')} in "
                    f"{out['seconds']}s")
        except Exception as e:      # noqa: BLE001 — warmup is best-effort
            from ..metrics import record_swallowed_error
            record_swallowed_error("server.solver_warmup", e, self.logger)

    def _leader_loop(self) -> None:
        """Broker nack-timeout reaping + periodic core GC evals
        (ref leader.go schedulePeriodic / reapFailedEvaluations)."""
        last_gc = time.time()
        while not self._leader_stop.wait(1.0):
            self.eval_broker.check_nack_timeouts()
            try:
                # pressure recompute + brownout apply/release (ISSUE 8)
                self.overload.tick()
            except Exception as e:      # noqa: BLE001
                self.logger(f"overload tick: {e!r}")
            try:
                # a raft apply failing mid-reap (leadership transition,
                # injected raft.apply fault) must not kill the loop: the
                # dequeued eval's nack timeout redelivers it to the
                # failed queue and the next tick retries
                self._reap_failed_evaluations()
            except Exception as e:      # noqa: BLE001
                self.logger(f"failed-eval reap: {e!r}")
            try:
                self._autopilot_cleanup_dead_servers()
            except Exception as e:      # noqa: BLE001
                self.logger(f"autopilot: {e!r}")
            try:
                self._reap_stale_services()
            except Exception as e:      # noqa: BLE001
                self.logger(f"service reap: {e!r}")
            try:
                self._reconcile_gossip_peers()
            except Exception as e:      # noqa: BLE001
                self.logger(f"gossip reconcile: {e!r}")
            try:
                self._autopilot_promote_stable_servers()
            except Exception as e:      # noqa: BLE001
                self.logger(f"autopilot promote: {e!r}")
            try:
                # re-admit flap-held nodes whose hold expired (ISSUE 10)
                self._flap_readmit_tick()
            except Exception as e:      # noqa: BLE001
                self.logger(f"flap readmit: {e!r}")
            try:
                # terminate node-update evals the broker coalesced away
                # (the broker cannot raft-apply from the FSM callback)
                self._cancel_coalesced_evals()
            except Exception as e:      # noqa: BLE001
                self.logger(f"coalesced-eval cancel: {e!r}")
            if time.time() - last_gc >= self.gc_interval:
                last_gc = time.time()
                for kind in (CORE_JOB_EVAL_GC, CORE_JOB_JOB_GC,
                             CORE_JOB_NODE_GC, CORE_JOB_DEPLOYMENT_GC):
                    self.eval_broker.enqueue(Evaluation(
                        type=JOB_TYPE_CORE, job_id=kind,
                        priority=200, status="pending"))

    def _reap_failed_evaluations(self) -> None:
        """Dead-letter consumer (ref leader.go:782): the core scheduler
        owns the terminate + backed-off failed-follow-up lifecycle."""
        self.core_scheduler.reap_failed_evals()

    def _flap_readmit_tick(self) -> None:
        """Re-admit nodes whose flap hold expired (ISSUE 10): restore
        eligibility (which clears `flap_held_until` in the store) and
        wake blocked evals for the node's class. A node whose hold was
        already lifted by an operator eligibility write (flap_held_until
        cleared) just drops out of the damper's set."""
        for node_id in self.flap_damper.due():
            node = self.state.node_by_id(node_id)
            if node is None or not getattr(node, "flap_held_until", 0.0):
                self.flap_damper.release(node_id)
                continue
            index = self.raft.apply(NODE_UPDATE_ELIGIBILITY, {
                "node_id": node_id,
                "eligibility": NODE_SCHED_ELIGIBLE})
            self.flap_damper.release(node_id)
            metrics.incr("nomad.heartbeat.flap_readmitted")
            self.blocked_evals.unblock(node.computed_class, index)
            # the hold path suppressed the READY transition's system-job
            # evals ("nothing may schedule onto it yet") — emit them at
            # re-admission or the node comes back without its node-local
            # system allocs until some unrelated eval happens by
            evals = [e for e in create_node_evals(self.state, node_id)
                     if e.type == JOB_TYPE_SYSTEM]
            if evals:
                self.raft.apply(EVAL_UPDATE, {"evals": evals})

    def _cancel_coalesced_evals(self) -> None:
        """Storm-coalesced node-update evals (ISSUE 10) were superseded
        in the broker by an earlier queued eval for the same job; their
        state records would sit `pending` forever without this — cancel
        them so eval GC can reap."""
        superseded = self.eval_broker.take_coalesced()
        if not superseded:
            return
        canceled = []
        for eval_id in superseded:
            cur = self.state.eval_by_id(eval_id)
            if cur is None or cur.terminal_status():
                continue
            cur = cur.copy()
            cur.status = EVAL_STATUS_CANCELLED
            cur.status_description = ("superseded by a queued node-update "
                                      "eval (storm coalescing)")
            canceled.append(cur)
        if canceled:
            try:
                self.raft.apply(EVAL_UPDATE, {"evals": canceled})
            except Exception:
                # a transient apply failure must not lose the drained
                # ids — re-stash so the next tick retries the cancel
                self.eval_broker.restash_coalesced(superseded)
                raise
            metrics.incr("nomad.broker.node_update_canceled",
                         len(canceled))

    def eval_drain_failed(self) -> dict:
        """Operator drain of the broker dead-letter queue (agent HTTP
        /v1/operator/broker/drain-failed): each drained eval terminates
        as failed WITHOUT a follow-up — the operator is declaring it
        unrecoverable (bad jobspec, decommissioned node class) and
        taking it out of the retry loop."""
        from ..structs import EVAL_STATUS_CANCELLED, EVAL_STATUS_FAILED
        # one atomic broker removal covers dead letters AND their
        # waiting follow-ups (the leader reaper converts one into the
        # other every tick, so a two-step listing would race it); if the
        # terminating raft commit then fails, everything is restored to
        # the queue — nothing is lost, the operator simply retries
        drained, follows = self.eval_broker.drain_failed()
        updates = []
        for ev in drained:
            failed = ev.copy()
            failed.status = EVAL_STATUS_FAILED
            failed.status_description = \
                "dead-lettered evaluation drained by operator"
            updates.append(failed)
        for ev in follows:
            cancelled = ev.copy()
            cancelled.status = EVAL_STATUS_CANCELLED
            cancelled.status_description = \
                "failed-follow-up cancelled by operator drain"
            updates.append(cancelled)
        if updates:
            try:
                self.raft.apply(EVAL_UPDATE, {"evals": updates})
            except BaseException:
                self.eval_broker.restore_failed(drained + follows)
                raise
        return {"drained": [ev.id for ev in drained],
                "cancelled_follow_ups": [ev.id for ev in follows],
                "count": len(drained) + len(follows)}

    def _on_eval_update(self, evals: list[Evaluation]) -> None:
        if not self.is_leader:
            return
        for ev in evals:
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)

    def _enqueue_unblocked(self, ev: Evaluation) -> None:
        self.raft.apply(EVAL_UPDATE, {"evals": [ev]})

    # ------------------------------------------------------- Job endpoints

    def job_register(self, job: Job) -> dict:
        """ref nomad/job_endpoint.go:80 Job.Register (admission hooks:
        connect sidecar expansion + the jobspec layer's
        validate/canonicalize)."""
        from ..integrations.connect import connect_admission
        connect_admission(job)
        err = self._validate_job(job)
        if err:
            raise ValueError(err)
        evals = []
        if job.is_periodic():
            pass  # periodic parents don't get evals; dispatcher launches
        elif job.is_parameterized():
            pass
        else:
            evals.append(Evaluation(
                namespace=job.namespace, priority=job.priority, type=job.type,
                triggered_by=TRIGGER_JOB_REGISTER, job_id=job.id,
                status=EVAL_STATUS_PENDING))
        index = self.raft.apply(JOB_REGISTER, {"job": job, "evals": evals})
        # unconditional: PeriodicDispatch.add untracks jobs that are no
        # longer periodic/are stopped, so updates can't leave stale children
        stored = self.state.job_by_id(job.namespace, job.id)
        self.periodic.add(stored)
        self.blocked_evals.untrack(job.namespace, job.id)
        return {"eval_id": evals[0].id if evals else "", "index": index,
                "job_modify_index": index}

    def _validate_job(self, job: Job) -> str:
        if not job.id:
            return "missing job ID"
        if not job.task_groups:
            return "job requires at least one task group"
        seen = set()
        for tg in job.task_groups:
            if tg.name in seen:
                return f"duplicate task group {tg.name!r}"
            seen.add(tg.name)
            if not tg.tasks and job.type != JOB_TYPE_SYSTEM:
                pass
            for task in tg.tasks:
                if not task.driver:
                    return f"task {task.name!r} missing driver"
        if job.type not in (JOB_TYPE_SERVICE, JOB_TYPE_BATCH, JOB_TYPE_SYSTEM,
                            JOB_TYPE_SYSBATCH):
            return f"invalid job type {job.type!r}"
        cfg = self.state.get_scheduler_config()
        if cfg.reject_job_registration:
            return "job registration is disabled"
        return ""

    def namespace_upsert(self, namespaces: list[dict]) -> int:
        from .fsm import NAMESPACE_UPSERT
        return self.raft.apply(NAMESPACE_UPSERT, {"namespaces": namespaces})

    def namespace_delete(self, names: list[str]) -> int:
        from .fsm import NAMESPACE_DELETE
        # validate BEFORE the log apply: a raising FSM apply would burn a
        # log index and diverge across replicas
        for name in names:
            if name == "default":
                raise ValueError("default namespace cannot be deleted")
            if any(j.namespace == name for j in self.state.iter_jobs(name)):
                raise ValueError(f"namespace {name!r} has registered jobs")
        return self.raft.apply(NAMESPACE_DELETE, {"names": names})

    def job_plan(self, job: Job, diff: bool = True) -> dict:
        """Dry-run scheduler pass over a forked state (ref
        nomad/job_endpoint.go Job.Plan): insert the candidate job into a
        scratch store, run the real scheduler with a capturing planner, and
        return the annotated plan + job diff — Raft is never touched."""
        from ..scheduler import new_scheduler
        from ..scheduler.testing import Harness
        from ..structs.diff import job_diff
        from ..api_codec import to_api
        err = self._validate_job(job)
        if err:
            raise ValueError(err)
        old = self.state.job_by_id(job.namespace, job.id)
        scratch = self.state.fork()
        cand = job.copy()
        cand.version = (old.version + 1) if old else 0
        scratch.upsert_job(scratch.latest_index() + 1, cand)
        h = Harness(scratch)
        h.next_index = scratch.latest_index() + 1
        ev = Evaluation(
            namespace=job.namespace, priority=job.priority, type=job.type,
            job_id=job.id, triggered_by=TRIGGER_JOB_REGISTER,
            status=EVAL_STATUS_PENDING, annotate_plan=True)
        h.process(lambda snap, planner: new_scheduler(ev.type, snap, planner),
                  ev)
        plan = h.plans[-1] if h.plans else None
        final_ev = h.evals[-1] if h.evals else ev
        # contextual=True per ref job_endpoint.go Plan → Diff(job, true):
        # unchanged fields ride along as Type None for `plan -verbose`
        the_diff = job_diff(old, cand, contextual=True) if diff else None
        if the_diff is not None and plan is not None and \
                plan.annotations is not None:
            # scheduling-consequence annotations (ref scheduler/annotate.go
            # Annotate): what each change FORCES + per-group update counts
            from ..scheduler.annotate import annotate_job_diff
            annotate_job_diff(the_diff, plan.annotations)
        return {
            "Annotations": to_api(plan.annotations) if plan else None,
            "FailedTGAllocs": to_api(final_ev.failed_tg_allocs) or None,
            "JobModifyIndex": old.modify_index if old else 0,
            "CreatedEvals": [to_api(e) for e in h.created_evals],
            "Diff": the_diff,
            "Index": self.state.latest_index(),
        }

    def job_deregister(self, namespace: str, job_id: str,
                       purge: bool = False) -> dict:
        job = self.state.job_by_id(namespace, job_id)
        ev = Evaluation(
            namespace=namespace,
            priority=job.priority if job else 50,
            type=job.type if job else JOB_TYPE_SERVICE,
            triggered_by=TRIGGER_JOB_DEREGISTER, job_id=job_id,
            status=EVAL_STATUS_PENDING)
        index = self.raft.apply(JOB_DEREGISTER, {
            "namespace": namespace, "job_id": job_id, "purge": purge,
            "evals": [ev]})
        self.periodic.remove(namespace, job_id)
        self.blocked_evals.untrack(namespace, job_id)
        return {"eval_id": ev.id, "index": index}

    def job_evaluate(self, namespace: str, job_id: str,
                     force_reschedule: bool = False) -> dict:
        """Force a new evaluation of an existing job (ref
        nomad/job_endpoint.go Evaluate): no spec change, just re-run the
        scheduler — used to kick a job after node capacity changes or to
        force failed-alloc reschedules."""
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            raise ValueError(f"job {job_id!r} not found")
        if job.is_periodic():
            raise ValueError("can't evaluate periodic job")
        if job.is_parameterized():
            raise ValueError("can't evaluate parameterized job")
        ev = Evaluation(
            namespace=namespace, priority=job.priority, type=job.type,
            triggered_by=TRIGGER_JOB_REGISTER, job_id=job_id,
            status=EVAL_STATUS_PENDING)
        if force_reschedule:
            ev.triggered_by = TRIGGER_RETRY_FAILED_ALLOC
        # the FSM's on_eval_update hook enqueues it on the leader
        index = self.raft.apply(EVAL_UPDATE, {"evals": [ev]})
        return {"eval_id": ev.id, "eval_create_index": index,
                "job_modify_index": job.modify_index, "index": index}

    def job_dispatch(self, namespace: str, job_id: str,
                     payload: bytes = b"", meta: Optional[dict] = None) -> dict:
        """Parameterized job dispatch (ref nomad/job_endpoint.go Dispatch)."""
        parent = self.state.job_by_id(namespace, job_id)
        if parent is None or not parent.is_parameterized():
            raise ValueError(f"job {job_id!r} is not parameterized")
        cfg = parent.parameterized
        if cfg.payload == "forbidden" and payload:
            raise ValueError("payload forbidden")
        if cfg.payload == "required" and not payload:
            raise ValueError("payload required")
        meta = meta or {}
        for key in cfg.meta_required:
            if key not in meta:
                raise ValueError(f"missing required dispatch meta {key!r}")
        for key in meta:
            if key not in cfg.meta_required and key not in cfg.meta_optional:
                raise ValueError(f"unexpected dispatch meta {key!r}")
        child = parent.copy()
        child.id = f"{parent.id}/dispatch-{int(time.time())}-{new_id()[:8]}"
        child.parent_id = parent.id
        child.dispatched = True
        child.payload = payload
        child.meta = {**parent.meta, **meta}
        ev = Evaluation(
            namespace=namespace, priority=child.priority, type=child.type,
            triggered_by=TRIGGER_JOB_REGISTER, job_id=child.id,
            status=EVAL_STATUS_PENDING)
        index = self.raft.apply(JOB_REGISTER, {"job": child, "evals": [ev]})
        return {"dispatched_job_id": child.id, "eval_id": ev.id,
                "index": index}

    def job_scale(self, namespace: str, job_id: str, group: str,
                  count: Optional[int] = None, message: str = "",
                  error: bool = False, meta: Optional[dict] = None,
                  policy_override: bool = False) -> dict:
        """Scale a task group's count and record a scaling event (ref
        nomad/job_endpoint.go Job.Scale). With count=None only the event is
        recorded (autoscaler heartbeat/error reporting)."""
        from .fsm import SCALING_EVENT_REGISTER
        from ..structs.scaling import ScalingEvent
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            raise ValueError(f"job {job_id!r} not found")
        if job.stop and count is not None:
            raise ValueError("cannot scale a stopped job")
        tg = job.lookup_task_group(group)
        if tg is None:
            raise ValueError(f"task group {group!r} not found in {job_id!r}")
        prev_count = tg.count
        eval_id = ""
        index = 0
        if count is not None:
            if count < 0:
                raise ValueError("scaling count must be >= 0")
            if error:
                raise ValueError("cannot scale and report an error at once")
            pol = self.state.scaling_policy_by_target(namespace, job_id, group)
            if pol is not None and not policy_override:
                if count < pol.min:
                    raise ValueError(
                        f"group count was less than scaling policy minimum: "
                        f"{count} < {pol.min}")
                if pol.max and count > pol.max:
                    raise ValueError(
                        f"group count was greater than scaling policy "
                        f"maximum: {count} > {pol.max}")
            job = job.copy()
            job.lookup_task_group(group).count = count
            result = self.job_register(job)
            eval_id, index = result["eval_id"], result["index"]
        event = ScalingEvent(
            time=time.time(), count=count, previous_count=prev_count,
            message=message, error=error, meta=dict(meta or {}),
            eval_id=eval_id)
        ev_index = self.raft.apply(SCALING_EVENT_REGISTER, {
            "namespace": namespace, "job_id": job_id, "group": group,
            "event": event})
        return {"eval_id": eval_id, "index": index or ev_index,
                "eval_create_index": index}

    def job_scale_status(self, namespace: str, job_id: str) -> dict:
        """ref nomad/job_endpoint.go Job.ScaleStatus / structs.JobScaleStatus."""
        job = self.state.job_by_id(namespace, job_id)
        if job is None:
            raise ValueError(f"job {job_id!r} not found")
        events = self.state.scaling_events_by_job(namespace, job_id)
        groups = {}
        allocs = self.state.allocs_by_job(namespace, job_id)
        for tg in job.task_groups:
            placed = running = healthy = unhealthy = 0
            for a in allocs:
                if a.task_group != tg.name or a.terminal_status():
                    continue
                placed += 1
                if a.client_status == "running":
                    running += 1
                ds = a.deployment_status
                if ds is not None and ds.healthy is True:
                    healthy += 1
                elif ds is not None and ds.healthy is False:
                    unhealthy += 1
            groups[tg.name] = {
                "Desired": tg.count, "Placed": placed, "Running": running,
                "Healthy": healthy, "Unhealthy": unhealthy,
                "Events": events.get(tg.name, []),
            }
        return {
            "JobID": job.id, "Namespace": job.namespace,
            "JobStopped": job.stop, "JobCreateIndex": job.create_index,
            "JobModifyIndex": job.modify_index, "TaskGroups": groups,
        }

    def job_revert(self, namespace: str, job_id: str, version: int,
                   enforce_prior_version: Optional[int] = None) -> dict:
        """Re-register an older job version (ref nomad/job_endpoint.go
        Job.Revert)."""
        cur = self.state.job_by_id(namespace, job_id)
        if cur is None:
            raise ValueError(f"job {job_id!r} not found")
        if enforce_prior_version is not None \
                and cur.version != enforce_prior_version:
            raise ValueError(
                f"current version {cur.version} does not match enforced "
                f"prior version {enforce_prior_version}")
        if version == cur.version:
            raise ValueError(f"job already at version {version}")
        target = self.state.job_by_version(namespace, job_id, version)
        if target is None:
            raise ValueError(f"job {job_id!r} at version {version} not found")
        revert = target.copy()
        revert.stop = False
        return self.job_register(revert)

    def job_stable(self, namespace: str, job_id: str, version: int,
                   stable: bool) -> dict:
        """Mark a job version (un)stable (ref nomad/job_endpoint.go
        Job.Stable; used by deployment auto-revert)."""
        from .fsm import JOB_STABILITY
        if self.state.job_by_version(namespace, job_id, version) is None:
            raise ValueError(f"job {job_id!r} version {version} not found")
        index = self.raft.apply(JOB_STABILITY, {
            "namespace": namespace, "job_id": job_id, "version": version,
            "stable": stable})
        return {"index": index}

    def scaling_policies_list(self, namespace: Optional[str] = None,
                              job_id: Optional[str] = None,
                              type_: Optional[str] = None) -> list:
        return self.state.iter_scaling_policies(namespace, job_id, type_)

    def scaling_policy_get(self, policy_id: str):
        return self.state.scaling_policy_by_id(policy_id)

    # ----------------------------------------------- Service catalog + Vault

    def service_register(self, instances: list) -> dict:
        """ref the consul service_client Register path, state-store backed."""
        from .fsm import SERVICE_REGISTER
        index = self.raft.apply(SERVICE_REGISTER, {"services": instances})
        return {"index": index}

    def service_deregister(self, alloc_id: str = "",
                           keys: Optional[list] = None) -> dict:
        from .fsm import SERVICE_DEREGISTER
        index = self.raft.apply(SERVICE_DEREGISTER,
                                {"alloc_id": alloc_id, "keys": keys})
        return {"index": index}

    def service_list(self, namespace: Optional[str] = None) -> list:
        return self.state.iter_services(namespace)

    def service_instances(self, namespace: str, name: str) -> list:
        return self.state.services_by_name(namespace, name)

    # mesh authorization (Consul intentions analog): rules are raft-
    # replicated; the connect proxies consult IntentionAllowed per
    # connection
    def intention_upsert(self, intention) -> dict:
        from .fsm import INTENTION_UPSERT
        from ..integrations.services import INTENTION_ALLOW, INTENTION_DENY
        if intention.action not in (INTENTION_ALLOW, INTENTION_DENY):
            raise ValueError(f"invalid action {intention.action!r}")
        if not intention.source or not intention.destination:
            raise ValueError("intention requires source and destination")
        if not intention.namespace or intention.namespace == "*":
            # namespaces match exactly in intention_allowed (no
            # wildcarding) — a "*" namespace rule would be inert
            raise ValueError("intention requires a concrete namespace")
        index = self.raft.apply(INTENTION_UPSERT, {"intention": intention})
        return {"index": index}

    def intention_delete(self, namespace: str, source: str,
                         destination: str) -> dict:
        from .fsm import INTENTION_DELETE
        index = self.raft.apply(INTENTION_DELETE, {
            "namespace": namespace, "source": source,
            "destination": destination})
        return {"index": index}

    def intention_list(self, namespace: Optional[str] = None) -> list:
        return self.state.iter_intentions(namespace)

    def intention_allowed(self, namespace: str, source: str,
                          destination: str) -> bool:
        return self.state.intention_allowed(namespace, source, destination)

    def _reap_stale_services(self) -> None:
        """Registrations of terminal/vanished allocs are removed by the
        leader (the consul-integration's deregister-on-stop safety net)."""
        doomed = []
        for inst in self.state.iter_services():
            alloc = self.state.alloc_by_id(inst.alloc_id)
            if alloc is None or alloc.terminal_status():
                doomed.append(list(inst.key()))
        if doomed:
            self.service_deregister(keys=doomed)

    def vault_derive_token(self, alloc_id: str, task: str) -> dict:
        """ref nomad/node_endpoint.go DeriveVaultToken: validates the alloc
        asks for vault before issuing."""
        alloc = self.state.alloc_by_id(alloc_id)
        if alloc is None:
            raise ValueError(f"allocation {alloc_id!r} not found")
        tg = alloc.job.lookup_task_group(alloc.task_group) \
            if alloc.job else None
        t = tg.lookup_task(task) if tg else None
        if t is None or t.vault is None:
            raise ValueError(f"task {task!r} does not use vault")
        tok = self.secrets.derive_token(alloc_id, task,
                                        list(t.vault.policies))
        return {"token": tok.token, "ttl_sec": tok.ttl_sec}

    def derive_si_token(self, alloc_id: str, task: str) -> dict:
        """Service-identity token for a connect sidecar task (ref
        nomad/node_endpoint.go:DeriveSIToken + the client sids_hook:
        Consul SI tokens scoped to the service the sidecar fronts).
        Validates the named task IS the injected proxy of one of the
        alloc's connect services before minting."""
        from ..integrations.connect import PROXY_PREFIX
        alloc = self.state.alloc_by_id(alloc_id)
        if alloc is None:
            raise ValueError(f"allocation {alloc_id!r} not found")
        tg = alloc.job.lookup_task_group(alloc.task_group) \
            if alloc.job else None
        svc_name = task[len(PROXY_PREFIX):] \
            if task.startswith(PROXY_PREFIX) else ""
        svc = next((s for s in (tg.services if tg else [])
                    if s.name == svc_name and s.connect), None)
        if svc is None:
            raise ValueError(
                f"task {task!r} is not a connect sidecar of this alloc")
        tok = self.secrets.derive_token(
            alloc_id, task,
            ["si", f"service:{alloc.namespace}/{svc.name}"])
        return {"token": tok.token, "ttl_sec": tok.ttl_sec,
                "service": svc.name}

    def vault_renew_token(self, token: str) -> dict:
        tok = self.secrets.renew_token(token)
        return {"ttl_sec": tok.ttl_sec, "expires_at": tok.expires_at}

    def vault_revoke_token(self, token: str) -> dict:
        self.secrets.revoke_token(token)
        return {}

    def secret_read(self, path: str) -> Optional[dict]:
        return self.secrets.read(path)

    # --------------------------------------------------------- CSI endpoints

    def csi_volume_register(self, volumes: list) -> dict:
        """ref nomad/csi_endpoint.go CSIVolume.Register"""
        for vol in volumes:
            if not vol.id:
                raise ValueError("volume requires an ID")
            if not vol.plugin_id:
                raise ValueError(f"volume {vol.id!r} requires a plugin ID")
        from .fsm import CSI_VOLUME_REGISTER
        index = self.raft.apply(CSI_VOLUME_REGISTER, {"volumes": volumes})
        return {"index": index}

    def csi_volume_deregister(self, namespace: str, volume_id: str,
                              force: bool = False) -> dict:
        from .fsm import CSI_VOLUME_DEREGISTER
        # fail fast with a readable error before paying the raft round-trip
        vol = self.state.csi_volume_by_id(namespace, volume_id)
        if vol is None:
            raise ValueError(f"volume {volume_id!r} not found")
        if vol.in_use() and not force:
            raise ValueError(f"volume {volume_id!r} is in use")
        index = self.raft.apply(CSI_VOLUME_DEREGISTER, {
            "namespace": namespace, "volume_id": volume_id, "force": force})
        return {"index": index}

    def csi_volume_claim(self, namespace: str, volume_id: str, claim) -> dict:
        """Claim (or release, via claim.state) a volume for an alloc
        (ref csi_endpoint.go CSIVolume.Claim)."""
        from .fsm import CSI_VOLUME_CLAIM
        from ..structs.csi import (
            CLAIM_STATE_CONTROLLER_DETACHED, CLAIM_STATE_NODE_DETACHED,
            CLAIM_STATE_READY_TO_FREE,
        )
        vol = self.state.csi_volume_by_id(namespace, volume_id)
        if vol is None:
            raise ValueError(f"volume {volume_id!r} not found")
        if claim.state not in (CLAIM_STATE_READY_TO_FREE,
                               CLAIM_STATE_NODE_DETACHED,
                               CLAIM_STATE_CONTROLLER_DETACHED):
            if not vol.schedulable:
                raise ValueError(f"volume {volume_id!r} is not schedulable")
            # enforce claim limits BEFORE the raft round-trip: the clustered
            # applier swallows FSM errors, so an in-FSM rejection would be
            # reported as success to the caller
            from ..structs.csi import CLAIM_WRITE
            if claim.mode == CLAIM_WRITE \
                    and claim.alloc_id not in vol.write_claims \
                    and not vol.claim_ok(claim.mode):
                raise ValueError(
                    f"volume {volume_id!r} has no free write claims")
            if claim.mode != CLAIM_WRITE and not vol.claim_ok(claim.mode):
                raise ValueError(f"volume {volume_id!r} not readable")
        index = self.raft.apply(CSI_VOLUME_CLAIM, {
            "namespace": namespace, "volume_id": volume_id, "claim": claim})
        return {"index": index,
                "volume": self.state.csi_volume_by_id(namespace, volume_id)}

    def csi_volume_list(self, namespace: Optional[str] = None,
                        plugin_id: Optional[str] = None) -> list:
        return self.state.iter_csi_volumes(namespace, plugin_id)

    def _claim_alloc_gone(self, claim) -> bool:
        alloc = self.state.alloc_by_id(claim.alloc_id)
        return alloc is None or alloc.terminal_status()

    def csi_node_detach_pending(self, node_id: str) -> list[dict]:
        """Claims on `node_id` awaiting NODE unpublish: alloc terminal or
        gone, claim still in the taken state. The node's csimanager polls
        this and confirms each detach with a node-detached claim update
        (the pull-model half of volumewatcher/volume_watcher.go)."""
        from ..structs.csi import CLAIM_STATE_TAKEN
        out = []
        for vol in self.state.iter_csi_volumes():
            for claim in list(vol.read_claims.values()) + \
                    list(vol.write_claims.values()):
                if claim.node_id != node_id or \
                        claim.state != CLAIM_STATE_TAKEN:
                    continue
                if not self._claim_alloc_gone(claim):
                    continue
                out.append({"namespace": vol.namespace,
                            "volume_id": vol.id,
                            "alloc_id": claim.alloc_id,
                            "plugin_id": vol.plugin_id})
        return out

    def csi_controller_detach_pending(self, plugin_ids: list[str],
                                      node_id: str = "") -> list[dict]:
        """Claims awaiting CONTROLLER unpublish for plugins this caller
        hosts a controller for: node detach done, plugin requires a
        controller round before the claim can free. The round is LEASED
        to one controller node (lowest healthy id) so concurrent
        controller hosts don't issue duplicate backend unpublishes — the
        reference serializes this through the server-side volumewatcher."""
        from ..structs.csi import CLAIM_STATE_NODE_DETACHED
        wanted = set(plugin_ids)
        out = []
        for vol in self.state.iter_csi_volumes():
            if vol.plugin_id not in wanted:
                continue
            plug = self.state.csi_plugin_by_id(vol.plugin_id)
            if plug is None or not plug.controller_required:
                continue
            if node_id:
                from ..structs import NODE_STATUS_DOWN
                healthy = sorted(nid for nid, ok in plug.controllers.items()
                                 if ok)
                if not healthy:
                    # no controller reports healthy (ADVICE r4): lease on
                    # a registered id whose NODE is still alive rather
                    # than dropping the gate — an open gate hands the
                    # same claim to every polling host and the backend
                    # sees duplicate ControllerUnpublishVolume rounds.
                    # Dead-node registrations are excluded (leasing on a
                    # SIGKILL'd host would stall detach forever); if NO
                    # registered controller is provably alive, grant the
                    # caller (it is polling, therefore alive) — progress
                    # over dedup in the double-failure corner.
                    def _alive(nid: str) -> bool:
                        n = self.state.node_by_id(nid)
                        return (n is not None
                                and n.status != NODE_STATUS_DOWN)
                    healthy = sorted(nid for nid in plug.controllers
                                     if _alive(nid))
                if healthy and node_id != healthy[0]:
                    continue        # another node holds the lease
            for claim in list(vol.read_claims.values()) + \
                    list(vol.write_claims.values()):
                if claim.state != CLAIM_STATE_NODE_DETACHED:
                    continue
                if not self._claim_alloc_gone(claim):
                    continue
                out.append({"namespace": vol.namespace,
                            "volume_id": vol.id,
                            "alloc_id": claim.alloc_id,
                            "node_id": claim.node_id,
                            "plugin_id": vol.plugin_id})
        return out

    def csi_volume_get(self, namespace: str, volume_id: str):
        return self.state.csi_volume_by_id(namespace, volume_id)

    def csi_plugin_list(self) -> list:
        return self.state.iter_csi_plugins()

    def csi_plugin_get(self, plugin_id: str):
        return self.state.csi_plugin_by_id(plugin_id)

    # ------------------------------------------------------ Search endpoints

    def search_prefix(self, prefix: str, context: str = "all",
                      namespace: str = "default", acl=None) -> dict:
        from .search import prefix_search
        return prefix_search(self.state, prefix, context, namespace, acl)

    def search_fuzzy(self, text: str, context: str = "all",
                     namespace: str = "default", acl=None) -> dict:
        from .search import fuzzy_search
        return fuzzy_search(self.state, text, context, namespace, acl)

    # ------------------------------------------------------ Node endpoints

    def node_register(self, node: Node) -> dict:
        """ref nomad/node_endpoint.go:81 Register"""
        if not node.id:
            raise ValueError("missing node ID")
        node = node.copy()
        if not node.computed_class:
            node.compute_class()
        if not node.status:
            node.status = NODE_STATUS_READY
        prior = self.state.node_by_id(node.id)
        index = self.raft.apply(NODE_REGISTER, {"node": node})
        ttl = self.heartbeats.reset_heartbeat_timer(node.id)
        if node.status == NODE_STATUS_READY:
            hold = None
            if prior is not None and prior.status != NODE_STATUS_READY:
                # a down node coming back via re-register is the same
                # down->up edge the status endpoint sees (ISSUE 10)
                hold = self.flap_damper.record_up(node.id)
            if hold is not None:
                self.raft.apply(NODE_UPDATE_ELIGIBILITY, {
                    "node_id": node.id,
                    "eligibility": NODE_SCHED_INELIGIBLE,
                    "flap_until": hold})
            else:
                stored = self.state.node_by_id(node.id)
                if not getattr(stored, "flap_held_until", 0.0):
                    self.blocked_evals.unblock(node.computed_class, index)
        return {"heartbeat_ttl": ttl, "index": index}

    def node_update_status(self, node_id: str, status: str) -> dict:
        """ref node_endpoint.go:421 UpdateStatus"""
        node = self.state.node_by_id(node_id)
        if node is None:
            raise KeyError(f"node {node_id} not found")
        if node.status == status and not self.raft.quorum_fresh():
            # the unchanged-status fast path (below) acks without a raft
            # round — safe only when the local state it consulted is
            # provably current. A leader healing from a partition can
            # still believe it leads while its state is behind the real
            # leader's: acking "already in that state" from it LOSES an
            # acked write (ISSUE 18, docs/PARTITIONS.md). Refuse instead;
            # the client's retry ladder re-lands the same dedup token on
            # a server that can vouch for its read.
            metrics.incr("nomad.rpc.stale_ack_refused")
            raise NotLeaderError("")
        evals: list[Evaluation] = []
        if node.status != status:
            was_up = node.status == NODE_STATUS_READY
            index = self.raft.apply(NODE_UPDATE_STATUS, {
                "node_id": node_id, "status": status,
                "updated_at": time.time()})
            if status == NODE_STATUS_DOWN:
                if was_up:
                    self.flap_damper.record_down(node_id)
                evals = create_node_evals(self.state, node_id)
            elif status == NODE_STATUS_READY:
                hold = self.flap_damper.record_up(node_id)
                if hold is not None:
                    # flap damping (ISSUE 10): the node cycled down/up
                    # past the threshold — hold it ineligible (the
                    # deadline rides raft) instead of letting reconnect
                    # churn oscillate the eligibility mask. No unblock,
                    # no system evals: nothing may schedule onto it yet.
                    self.raft.apply(NODE_UPDATE_ELIGIBILITY, {
                        "node_id": node_id,
                        "eligibility": NODE_SCHED_INELIGIBLE,
                        "flap_until": hold})
                else:
                    node = self.state.node_by_id(node_id)
                    # a node still inside an active flap hold cycling
                    # down/up below the (reset) threshold must not
                    # unblock evals or get system evals — it is
                    # ineligible until the readmit tick lifts the hold
                    # (same guard node_register applies)
                    if not getattr(node, "flap_held_until", 0.0):
                        self.blocked_evals.unblock(node.computed_class,
                                                   index)
                        evals = [e for e in
                                 create_node_evals(self.state, node_id)
                                 if e.type == JOB_TYPE_SYSTEM]
            if evals:
                self.raft.apply(EVAL_UPDATE, {"evals": evals})
        ttl = self.heartbeats.reset_heartbeat_timer(node_id)
        return {"heartbeat_ttl": ttl,
                "eval_ids": [e.id for e in evals]}

    def node_heartbeat(self, node_id: str) -> dict:
        ttl = self.heartbeats.reset_heartbeat_timer(node_id)
        return {"heartbeat_ttl": ttl}

    def node_update_drain(self, node_id: str,
                          drain: Optional[DrainStrategy],
                          mark_eligible: bool = False) -> dict:
        """ref node_endpoint.go:557 UpdateDrain"""
        node = self.state.node_by_id(node_id)
        if node is None:
            raise KeyError(f"node {node_id} not found")
        if drain is not None and drain.deadline_sec > 0:
            drain.force_deadline_unix = time.time() + drain.deadline_sec
        index = self.raft.apply(NODE_UPDATE_DRAIN, {
            "node_id": node_id, "drain": drain,
            "mark_eligible": mark_eligible})
        evals = []
        if drain is not None:
            evals = create_node_evals(self.state, node_id)
            for ev in evals:
                ev.triggered_by = TRIGGER_NODE_DRAIN
            if evals:
                self.raft.apply(EVAL_UPDATE, {"evals": evals})
            self.drainer.track_node(node_id)
        return {"index": index, "eval_ids": [e.id for e in evals]}

    def node_update_eligibility(self, node_id: str, eligibility: str) -> dict:
        index = self.raft.apply(NODE_UPDATE_ELIGIBILITY, {
            "node_id": node_id, "eligibility": eligibility})
        # an operator eligibility write supersedes any flap hold (the
        # store cleared flap_held_until with this entry)
        self.flap_damper.release(node_id)
        if eligibility == "eligible":
            node = self.state.node_by_id(node_id)
            if node:
                self.blocked_evals.unblock(node.computed_class, index)
        return {"index": index}

    def node_get_client_allocs(self, node_id: str, min_index: int = 0,
                               timeout: float = 30.0) -> dict:
        """Blocking query the client long-polls (ref node_endpoint.go
        GetClientAllocs / client watchAllocations). The hold shrinks
        under pressure (brownout, ISSUE 8) — parked long-polls return
        capacity, clients just re-poll sooner."""
        deadline = time.time() + min(timeout, self.overload.blocking_cap_s())
        # park on the broker, not the store condvar: only Allocation
        # events wake this long-poll, instead of every write in the
        # cluster waking every parked client (ISSUE 16). `seen` tracks
        # the last observed topic index so unrelated alloc churn cannot
        # busy-spin the re-check loop; the deadline re-check keeps the
        # no-event GC paths correct (bounded-delay, never wrong).
        seen = min_index
        while True:
            allocs = self.state.allocs_by_node(node_id)
            index = self.state.latest_index()
            relevant = {a.id: a.modify_index for a in allocs
                        if not (a.desired_status == ALLOC_DESIRED_STOP and
                                a.client_terminal_status())}
            if any(mi > min_index for mi in relevant.values()) or \
               time.time() >= deadline:
                return {"allocs": relevant, "index": index}
            seen = max(seen, self.event_broker.wait_for_index(
                ("Allocation",), seen,
                timeout=max(0.05, deadline - time.time())))

    # ---------------------------------------------------------- read plane
    # ISSUE 16: list/get served from ANY server's replicated store off the
    # leader's hot lock, via the snapshot memo (`state/store.py _snap_memo`
    # — repeated reads between writes share one snapshot). Staleness is
    # provable: every response carries QueryMeta {LastIndex, KnownLeader,
    # Stale, Server} (ref nomad/structs QueryMeta + AllowStale).

    def _read_snapshot(self, stale: bool, max_stale_index: int,
                       timeout: float):
        """Resolve the snapshot a read is served from.

        Consistent (default) reads on a follower redirect to the leader
        via NotLeaderError (the rpc client retries transparently). Stale
        reads serve locally; `max_stale_index` bounds the staleness —
        the follower blocks until its store has applied that index, and
        redirects to the leader if it cannot catch up in time."""
        if self.raft_node is not None:
            # leader_rpc_addr is otherwise only refreshed when the
            # dispatcher gates a leader-only endpoint; read endpoints are
            # leader_only=False, so pull the current leader from raft here
            # or KnownLeader/redirects would ride a stale cache
            self._raft_leadership()
        if not stale and self.raft_node is not None and not self.is_leader:
            raise NotLeaderError(self.leader_rpc_addr)
        if max_stale_index:
            cap = min(timeout, self.overload.blocking_cap_s())
            try:
                return self.state.snapshot_min_index(max_stale_index,
                                                     timeout=cap)
            except TimeoutError:
                # this replica is too far behind the bound: the leader
                # (which defines the index) can always serve it
                if not self.is_leader and self.leader_rpc_addr:
                    raise NotLeaderError(self.leader_rpc_addr)
                raise
        return self.state.snapshot()

    def _read_meta(self, index: int, stale: bool) -> dict:
        # KnownLeader=False during elections is the client's signal that
        # LastIndex may lag an unreachable majority (ref QueryMeta)
        known = self.is_leader or bool(self.leader_rpc_addr)
        metrics.incr("nomad.read.leader_served" if self.is_leader
                     else "nomad.read.follower_served")
        return {"LastIndex": index, "KnownLeader": known,
                "Stale": bool(stale and not self.is_leader),
                "Server": self.name}

    def read_list(self, table: str, namespace: Optional[str] = None,
                  stale: bool = False, max_stale_index: int = 0,
                  fields: Optional[list] = None, columnar: bool = False,
                  timeout: float = 5.0) -> dict:
        """List stubs for the fleet-dashboard hot paths. Rows are sorted
        by (CreateIndex, ID) so leader and follower payloads at the same
        index are bit-identical (the staleness differential contract)."""
        from ..api_codec import (alloc_stub, job_stub, node_stub,
                                 project_fields, to_api, to_columnar)
        snap = self._read_snapshot(stale, max_stale_index, timeout)
        by_create = lambda o: (o.create_index, o.id)  # noqa: E731
        if table == "nodes":
            rows = [node_stub(n) for n in sorted(snap.iter_nodes(),
                                                 key=by_create)]
        elif table == "allocs":
            allocs = [a for a in snap.iter_allocs()
                      if namespace is None or a.namespace == namespace]
            rows = [alloc_stub(a) for a in sorted(allocs, key=by_create)]
        elif table == "evals":
            evals = [e for e in snap.iter_evals()
                     if namespace is None or e.namespace == namespace]
            rows = [to_api(e) for e in sorted(evals, key=by_create)]
        elif table == "jobs":
            rows = [job_stub(j, snap.job_summary(j.namespace, j.id))
                    for j in sorted(snap.iter_jobs(namespace),
                                    key=by_create)]
        else:
            raise ValueError(f"unknown read table: {table!r}")
        rows = project_fields(rows, fields)
        out = {"QueryMeta": self._read_meta(snap.index, stale)}
        if columnar:
            out["Columnar"] = to_columnar(rows)
        else:
            out["Items"] = rows
        return out

    def read_get(self, table: str, key: str,
                 namespace: str = "default", stale: bool = False,
                 max_stale_index: int = 0, timeout: float = 5.0) -> dict:
        """Single-object read off any server (same staleness contract as
        read_list)."""
        from ..api_codec import to_api
        snap = self._read_snapshot(stale, max_stale_index, timeout)
        if table == "node":
            obj = snap.node_by_id(key)
        elif table == "alloc":
            obj = snap.alloc_by_id(key)
        elif table == "eval":
            obj = snap.eval_by_id(key)
        elif table == "job":
            obj = snap.job_by_id(namespace, key)
        elif table == "deployment":
            obj = snap.deployment_by_id(key)
        else:
            raise ValueError(f"unknown read table: {table!r}")
        return {"Item": to_api(obj) if obj is not None else None,
                "QueryMeta": self._read_meta(snap.index, stale)}

    def node_update_allocs(self, allocs: list[Allocation]) -> dict:
        """Client pushes alloc status (ref node_endpoint.go UpdateAlloc):
        terminal transitions trigger new evals."""
        index = self.raft.apply(ALLOC_CLIENT_UPDATE, {"allocs": allocs})
        evals = []
        seen = set()
        for alloc in allocs:
            stored = self.state.alloc_by_id(alloc.id)
            if stored is None or stored.job is None:
                continue
            key = (stored.namespace, stored.job_id)
            if key in seen:
                continue
            if alloc.client_status in (ALLOC_CLIENT_FAILED,):
                seen.add(key)
                evals.append(Evaluation(
                    namespace=stored.namespace,
                    priority=stored.job.priority,
                    type=stored.job.type,
                    triggered_by=TRIGGER_RETRY_FAILED_ALLOC,
                    job_id=stored.job_id, status=EVAL_STATUS_PENDING))
            elif alloc.client_status == ALLOC_CLIENT_COMPLETE and \
                    stored.job.type in (JOB_TYPE_BATCH, JOB_TYPE_SYSBATCH):
                seen.add(key)
                evals.append(Evaluation(
                    namespace=stored.namespace,
                    priority=stored.job.priority,
                    type=stored.job.type,
                    triggered_by=TRIGGER_ALLOC_STOP,
                    job_id=stored.job_id, status=EVAL_STATUS_PENDING))
        if evals:
            self.raft.apply(EVAL_UPDATE, {"evals": evals})
        return {"index": index, "eval_ids": [e.id for e in evals]}

    # ----------------------------------------------------- Alloc endpoints

    def node_get_http_addr(self, node_id: str) -> str:
        """HTTP address of a node's agent (used by remote ephemeral-disk
        migration, ref client/allocwatcher remotePrevAlloc)."""
        node = self.state.node_by_id(node_id)
        return node.http_addr if node else ""

    def alloc_get(self, alloc_id: str):
        """ref nomad/alloc_endpoint.go GetAlloc"""
        return self.state.alloc_by_id(alloc_id)

    def alloc_stop(self, alloc_id: str) -> dict:
        """User-initiated alloc stop (ref alloc_endpoint.go Stop): mark the
        transition and create an eval."""
        alloc = self.state.alloc_by_id(alloc_id)
        if alloc is None:
            raise KeyError(f"alloc {alloc_id} not found")
        from ..structs import DesiredTransition
        ev = Evaluation(
            namespace=alloc.namespace,
            priority=alloc.job.priority if alloc.job else 50,
            type=alloc.job.type if alloc.job else JOB_TYPE_SERVICE,
            triggered_by=TRIGGER_ALLOC_STOP, job_id=alloc.job_id,
            status=EVAL_STATUS_PENDING)
        self.raft.apply(ALLOC_UPDATE_DESIRED_TRANSITION, {
            "transitions": {alloc_id: DesiredTransition(migrate=True)},
            "evals": [ev]})
        return {"eval_id": ev.id}

    # ------------------------------------------------------ Eval endpoints

    def eval_dequeue(self, schedulers: list[str],
                     timeout: float = 1.0) -> tuple[Optional[Evaluation], str]:
        """ref nomad/eval_endpoint.go:83 Dequeue"""
        return self.eval_broker.dequeue(schedulers, timeout)

    def eval_ack(self, eval_id: str, token: str) -> None:
        self.eval_broker.ack(eval_id, token)

    def eval_nack(self, eval_id: str, token: str) -> None:
        self.eval_broker.nack(eval_id, token)

    # ------------------------------------------------ Deployment endpoints

    def deployment_list(self, namespace: Optional[str] = None) -> list:
        return [d for d in self.state.iter_deployments()
                if namespace in (None, "*") or d.namespace == namespace]

    def deployment_promote(self, deployment_id: str,
                           groups: Optional[list] = None) -> dict:
        return self.deployment_watcher.promote(deployment_id, groups)

    def deployment_fail(self, deployment_id: str) -> dict:
        return self.deployment_watcher.fail_deployment(deployment_id)

    def deployment_pause(self, deployment_id: str, paused: bool) -> dict:
        return self.deployment_watcher.pause(deployment_id, paused)

    # -------------------------------------------------- Operator endpoints

    # ----------------------------------------------------- Operator: raft

    def operator_raft_configuration(self) -> dict:
        """ref nomad/operator_endpoint.go RaftGetConfiguration"""
        from .raft import RaftNode
        if isinstance(self.raft, RaftNode):
            is_leader, _ = self.raft.leadership()
            # snapshot membership under the raft lock: config-entry
            # application resizes these dicts concurrently, and this
            # endpoint is polled exactly during membership transitions
            with self.raft._lock:
                peers = dict(self.raft.peers)
                nonvoters = set(self.raft.nonvoters)
            servers = [{
                "ID": pid, "Node": pid, "Address": addr,
                "Leader": (pid == self.raft.node_id and is_leader)
                or pid == self.raft.leader_id,
                # real voter status: freshly (re)joined servers ride as
                # non-voters until autopilot promotes them, and operators
                # (and the e2e rejoin test) must see that
                "Voter": pid not in nonvoters,
                "RaftProtocol": "3",
            } for pid, addr in sorted(peers.items())]
            return {"Servers": servers, "Index": self.raft.barrier()}
        return {"Servers": [{
            "ID": "server-1", "Node": "server-1",
            "Address": self.rpc_addr if self.rpc_server else "local",
            "Leader": self.is_leader, "Voter": True, "RaftProtocol": "3",
        }], "Index": self.raft.barrier()}

    def operator_raft_remove_peer(self, peer_id: str = "",
                                  address: str = "") -> dict:
        """ref operator_endpoint.go RaftRemovePeerByAddress/ID"""
        from .raft import RaftNode
        if not isinstance(self.raft, RaftNode):
            raise ValueError("raft membership requires a multi-node cluster")
        if not peer_id and address:
            matches = [pid for pid, a in self.raft.peers.items()
                       if a == address]
            if not matches:
                raise ValueError(f"no raft peer at address {address!r}")
            peer_id = matches[0]
        index = self.raft.remove_peer(peer_id)
        return {"index": index}

    def operator_raft_add_peer(self, peer_id: str, address: str) -> dict:
        """Join a new server into the raft configuration (agent join path)."""
        from .raft import RaftNode
        if not isinstance(self.raft, RaftNode):
            raise ValueError("raft membership requires a multi-node cluster")
        index = self.raft.add_peer(peer_id, address)
        return {"index": index}

    def operator_autopilot_get_config(self) -> dict:
        return self.state.get_autopilot_config()

    def operator_autopilot_set_config(self, config: dict) -> dict:
        from .fsm import AUTOPILOT_CONFIG
        index = self.raft.apply(AUTOPILOT_CONFIG, {"config": config})
        return {"Updated": True, "index": index}

    def operator_server_health(self) -> dict:
        """ref operator autopilot health endpoint"""
        from .raft import RaftNode
        if isinstance(self.raft, RaftNode):
            servers = self.raft.server_health()
        else:
            servers = [{"ID": "server-1", "Address": "local",
                        "Leader": self.is_leader, "Voter": True,
                        "Healthy": True, "LastContactSec": 0.0,
                        "MatchIndex": self.raft.barrier()}]
        # Healthy=None means "unknown from this server" (follower view);
        # only definite failures make the cluster unhealthy
        healthy = all(s["Healthy"] is not False for s in servers)
        return {"Healthy": healthy,
                "FailureTolerance": max(0, (sum(
                    1 for s in servers if s["Healthy"]) - 1) // 2),
                "Servers": servers}

    def _autopilot_promote_stable_servers(self) -> None:
        """raft-autopilot stable-server promotion (ref nomad/autopilot.go
        promoteStableServers): a non-voter that has replicated healthily
        for ServerStabilizationTime becomes a voter."""
        from .raft import RaftNode
        if not isinstance(self.raft, RaftNode) or not self.is_leader:
            return
        # tick evidence: tests that drive this method directly (the
        # de-flaked gossip promote test) still assert the HOUSEKEEPING
        # LOOP invokes it, via this counter — dropping the loop call
        # would silently stop real clusters from promoting nonvoters
        from ..metrics import metrics
        metrics.incr("nomad.autopilot.promote_tick")
        cfg = self.state.get_autopilot_config()
        stabilization = float(cfg.get("ServerStabilizationTimeSec", 10.0))
        for s_h in self.raft.server_health():
            if s_h["Voter"] or not s_h["Healthy"]:
                continue
            if s_h.get("KnownForSec", 0.0) >= stabilization:
                # bounded: a promote racing the server's death must not
                # stall the 1s leader housekeeping loop for 30s
                self.raft.promote_peer(s_h["ID"], timeout=5.0)
                self.logger(
                    f"server: promoted stable server {s_h['ID']} to voter")

    def _autopilot_cleanup_dead_servers(self) -> None:
        """Leader-side dead-server reaping (ref nomad/autopilot.go
        pruneDeadServers), driven by the stored autopilot config."""
        from .raft import RaftNode
        if not isinstance(self.raft, RaftNode) or not self.is_leader:
            return
        cfg = self.state.get_autopilot_config()
        if not cfg.get("CleanupDeadServers", True):
            return
        threshold = float(cfg.get("LastContactThresholdSec", 10.0))
        stabilization = float(cfg.get("ServerStabilizationTimeSec", 10.0))
        health = self.raft.server_health()
        # never remove below a majority of the current config (autopilot's
        # quorum guard)
        removable = len(health) - max(2, len(health) // 2 + 1)
        for s in health:
            if removable <= 0:
                break
            if s["Healthy"] or s["ID"] == self.raft.node_id:
                continue
            if s.get("KnownForSec", 0.0) < stabilization:
                # just joined: give it time to come up before reaping
                continue
            age = s["LastContactSec"]
            if age is None or age < threshold:
                # None = no contact data (shouldn't happen on a leader past
                # election baseline) — never treat unknown as dead
                continue
            try:
                # bounded wait: a quorum-less cluster must not stall the
                # leader housekeeping loop for the full apply timeout
                self.raft.remove_peer(s["ID"], timeout=5.0)
                self.logger(f"autopilot: removed dead server {s['ID']}")
                removable -= 1
            except Exception as e:  # noqa: BLE001
                self.logger(f"autopilot: remove failed: {e!r}")
                break

    def get_scheduler_configuration(self) -> SchedulerConfiguration:
        return self.state.get_scheduler_config()

    def set_scheduler_configuration(self, config: SchedulerConfiguration
                                    ) -> dict:
        err = config.validate()
        if err:
            raise ValueError(err)
        index = self.raft.apply(SCHEDULER_CONFIG, {"config": config})
        return {"index": index}

    # ----------------------------------------------------------- utilities

    def status_summary(self) -> dict:
        """GET /v1/status: liveness + the overload/pressure block
        (docs/OVERLOAD.md). Served locally by any server — a follower
        reports its own (idle) pressure, which is itself informative."""
        return {
            "Leader": self.is_leader,
            "Name": self.name,
            "Pressure": self.overload.snapshot(),
            "Broker": dict(self.eval_broker.stats),
        }

    def operator_debug_bundle(self) -> dict:
        """GET /v1/operator/debug (ISSUE 11): one self-contained snapshot
        of everything an operator needs to explain THIS server's behavior
        after the fact — metrics, recent traces, pressure/broker/state-
        cache/breaker internals, the latest placement-explain records and
        the device-runtime telemetry — the server-side block `nomad-tpu
        operator debug` folds into its timestamped archive
        (docs/OBSERVABILITY.md lists the format). Read-only and local:
        every block samples in-process state, no raft round."""
        faults.fire("operator.debug")
        from ..api_codec import to_api
        from ..obs import devruntime
        from ..obs import trace as obs_trace
        from ..solver import backend as solver_backend
        from ..solver import explain as solver_explain
        from ..solver import sharding as solver_sharding
        from ..solver import state_cache
        # spec wall clock: capture timestamps are observability data
        # nomadlint: disable=DET001 — capture timestamp, not a decision
        captured = time.time()
        breaker = solver_backend.breaker()
        tiers = ("sharded", "pallas", "batch", "xla", "host")
        raft_block: dict = {"Enabled": self.raft_node is not None}
        if self.raft_node is not None:
            raft_block.update({
                "Term": self.raft_node.current_term,
                "CommitIndex": self.raft_node.commit_index,
                "LastApplied": self.raft_node.last_applied,
                "State": self.raft_node.state,
                "Health": self.raft_node.server_health(),
            })
            # durable-storage state (ISSUE 13, docs/DURABILITY.md):
            # generation, fsync discipline + counters, and how the last
            # boot recovered (tail truncation / quarantine / migration)
            dur = self.raft_node._durable
            raft_block["Durability"] = {
                "Stats": dur.stats() if dur is not None else None,
                "Restore": {
                    "Quarantined": self.raft_node.log_quarantined,
                    "TailTruncatedFrames":
                        self.raft_node.log_tail_truncated,
                    "Migrated": self.raft_node.log_migrated,
                },
            }
        return {
            "Meta": {
                "Name": self.name,
                "Leader": self.is_leader,
                "CapturedUnix": round(captured, 3),
                "EstablishTimings": dict(self._establish_timings),
            },
            "Status": self.status_summary(),
            "Metrics": metrics.snapshot(),
            "DeviceRuntime": devruntime.snapshot(),
            "Traces": {"Stats": obs_trace.stats(),
                       "Recent": obs_trace.traces(50)},
            "Explains": solver_explain.recent(64),
            "StateCache": state_cache.cache().stats(),
            # elastic-mesh state (ISSUE 14, docs/SHARDED_SOLVE.md):
            # generation, quarantined devices, surviving shard count —
            # plus the mesh counters an operator reads after a loss
            "Mesh": {
                **solver_sharding.describe(),
                "Rebuilds": int(metrics.counter("nomad.mesh.rebuilds")),
                "Replays": int(metrics.counter("nomad.mesh.replays")),
                "Evacuations": int(metrics.counter(
                    "nomad.solver.state_cache.evacuations")),
            },
            "Breakers": {t: breaker.state(t) for t in tiers},
            "BlockedEvals": dict(self.blocked_evals.stats),
            "SchedulerConfig": to_api(self.state.get_scheduler_config()),
            "Raft": raft_block,
            # partition-event forensics (ISSUE 18, docs/PARTITIONS.md):
            # per-peer outbound breaker state, dedup cache occupancy, and
            # the rpc retry/shed counters — one capture answers "which
            # link was down, what got retried, what got shed"
            "Rpc": {
                "Breakers": (self.rpc_server.rpc_breaker.snapshot()
                             if self.rpc_server is not None else {}),
                "Dedup": self.write_dedup.stats(),
                "Counters": {
                    k: int(metrics.counter(f"nomad.rpc.{k}"))
                    for k in ("retries", "failovers", "deadline_exceeded",
                              "dedup_hits", "breaker_open",
                              "breaker_closed")},
            },
        }

    def run_gc(self) -> None:
        """Force a full GC pass (the `nomad system gc` analog)."""
        self.core_scheduler.process(Evaluation(
            type=JOB_TYPE_CORE, job_id=CORE_JOB_FORCE_GC))

    def reconcile_summaries(self) -> dict:
        """Rebuild job summaries from allocs, replicated through Raft
        (ref nomad/system_endpoint.go ReconcileJobSummaries)."""
        from .fsm import RECONCILE_SUMMARIES
        index = self.raft.apply(RECONCILE_SUMMARIES, {})
        return {"index": index}

    def snapshot_save(self) -> bytes:
        return self.raft.snapshot()

    def snapshot_restore(self, data: bytes) -> None:
        self.raft.restore(data)
