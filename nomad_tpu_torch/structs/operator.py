"""Operator-mutable scheduler configuration (ref nomad/structs/operator.go:131-180).

This is the extension point where the TPU solver registers as a scheduler
algorithm alongside classic binpack/spread: SURVEY.md north star.
"""
from __future__ import annotations

from dataclasses import dataclass, field

SCHED_ALG_BINPACK = "binpack"
SCHED_ALG_SPREAD = "spread"
SCHED_ALG_TPU = "tpu-batch"   # the new one: batched JAX/XLA solve
SCHED_ALG_CONVEX = "convex"   # ISSUE 19: global projected-gradient solve

VALID_SCHEDULER_ALGORITHMS = (SCHED_ALG_BINPACK, SCHED_ALG_SPREAD,
                              SCHED_ALG_TPU, SCHED_ALG_CONVEX)


@dataclass
class PreemptionConfig:
    """Per-scheduler preemption toggles (ref operator.go PreemptionConfig)."""
    system_scheduler_enabled: bool = True
    sysbatch_scheduler_enabled: bool = False
    batch_scheduler_enabled: bool = False
    service_scheduler_enabled: bool = False


@dataclass
class SchedulerConfiguration:
    """Raft-replicated, runtime-mutable scheduler config
    (ref operator.go:144, set via /v1/operator/scheduler/configuration).

    The tpu-batch knobs ride the same hot-reload path as
    `scheduler_algorithm`: a SCHEDULER_CONFIG log entry replaces the
    stored config, and every eval reads the latest copy through its
    EvalContext — no restart, no cache to bust.

      preemption_config       per-scheduler-kind preemption switches
                              (system/sysbatch/batch/service) the
                              planner consults before evicting victims.
      memory_oversubscription_enabled
                              allow tasks to exceed their memory reserve
                              up to the node max (ref behavior); off =
                              reserve is the hard cap at placement time.
      reject_job_registration drain valve: refuse new job registrations
                              (writes) while the cluster sheds load —
                              reads and in-flight work are untouched.
      pause_eval_broker       stop the broker handing evals to workers
                              (dequeue returns empty); enqueued work
                              parks until unpaused. Operator brownout
                              lever, not a data-path state.
      plan_pipeline_enabled   pipelined plan lifecycle: chunk the solve,
                              dispatch chunk N+1 on the accelerator while
                              the host materializes/evaluates/commits
                              chunk N. False forces the serial path.
      plan_pipeline_chunks    how many chunks a pipelined eval splits
                              into; 1 means stay serial (a one-chunk
                              pipeline commits nothing early).
      plan_pipeline_min_count below this many placements an eval stays
                              serial (chunking overhead beats the overlap).
      eval_batch_enabled      eval-stream micro-batching: small depth
                              solves on a TPU coalesce into one padded
                              batched dispatch instead of the host tier.
      eval_batch_window_ms    how long the first pending solve waits for
                              siblings before dispatching the batch.
      plan_commit_batch_max   how many verified pending plans the serial
                              applier may drain into ONE raft entry / FSM
                              batch apply (cross-eval commit coalescing);
                              1 means the pre-coalescing serial path.
      plan_commit_timeout_s   the raft-apply budget for a WHOLE commit
                              batch (not per message) — on exhaustion
                              every plan of the batch fails with a
                              `nomad.plan.commit_timeout` count instead
                              of serially starving the queue.
      plan_commit_window_ms   how long the applier lingers for more
                              arrivals after a partial drain — engages
                              ONLY while more evals than drained plans
                              are in flight (the micro-batcher's signal),
                              so a lone plan never waits.
      telemetry_trace_enabled span-based eval tracing (nomad_tpu/obs/):
                              False makes every instrumentation site a
                              cheap no-op. NOMAD_TRACE=0/1 env overrides
                              either way (docs/OBSERVABILITY.md).
      telemetry_trace_sample  head-based sampling rate in [0,1] for
                              HEALTHY traces; traces ending non-ok
                              (faulted, failed, leadership lost) are
                              always retained regardless.
      telemetry_trace_capacity  how many completed traces the bounded
                              in-memory store keeps for /v1/traces.
      ingress_write_rate      token-bucket admission rate (requests/s)
                              for write endpoints at the HTTP/RPC front
                              doors; over-rate callers get 429 +
                              Retry-After before any state is touched.
                              0 disables the class (docs/OVERLOAD.md).
      ingress_read_rate       same, for non-blocking reads.
      ingress_blocking_rate   same, for blocking queries (?index=&wait=).
      ingress_burst_s         bucket capacity in seconds of rate: a
                              bucket holds rate*burst_s tokens, so short
                              bursts up to that size are admitted even
                              at the sustained limit.
      broker_depth_cap        eval-broker backlog ceiling (ready +
                              job-pending + delayed). On overflow the
                              LOWEST-priority pending eval is shed into
                              the failed-eval backoff lifecycle (never
                              core/system evals); 0 = unbounded (the
                              pre-overload-layer behavior).
      eval_deadline_s         enqueue TTL stamped on evals entering the
                              broker: workers drop expired evals before
                              the solve, the plan applier rejects past-
                              deadline plans before the raft round
                              (goodput over throughput). 0 = no TTL.
      pressure_saturated_frac fraction of broker_depth_cap at which the
                              pressure state leaves `ok` (brownout:
                              wider micro-batch window, trace sampling
                              downshift, shorter blocking queries).
      heartbeat_invalidate_rate_cap
                              max expired nodes one heartbeat sweep may
                              flip down (one BATCH_NODE_UPDATE_STATUS
                              raft entry per sweep); overflow carries
                              over to the next sweep, so a mass
                              partition drains paced instead of as one
                              raft megaflood. 0 = uncapped
                              (docs/NODE_FAILURE.md).
      flap_damping_threshold  down->up cycles inside the window before a
                              node is held ineligible (flap damping);
                              0 disables damping entirely.
      flap_damping_window_s   sliding window the cycle count lives in.
      flap_damping_backoff_s  first hold duration; doubles per
                              subsequent flap episode.
      flap_damping_backoff_max_s   hold ceiling for chronic flappers.
      placement_explain_enabled   placement explainability (ISSUE 11):
                              the tensor solve keeps its per-stage
                              elimination reductions as a fixed-shape
                              device byproduct and materializes real
                              AllocMetric attribution for failed
                              placements. NOMAD_EXPLAIN=0/1 env
                              overrides either way; placements are
                              bit-identical on or off
                              (docs/OBSERVABILITY.md).
      placement_explain_recent  how many recent explain records the
                              bounded process ring retains for the
                              operator debug bundle.
      solver_fused_enabled    whole-eval device residency (ISSUE 15):
                              dispatch gather+solve+plan-verdict
                              (+explain) as ONE compiled program per
                              solve against the resident state-cache
                              twins — one device round trip per eval.
                              Placements are bit-identical on or off;
                              NOMAD_SOLVER_FUSED=0/1 overrides
                              (docs/BACKEND_TIERS.md).
      raft_fsync              fsync discipline for raft persistence
                              (ISSUE 13, docs/DURABILITY.md): `always`
                              fsyncs every append/meta/commit (the
                              no-acked-entry-lost contract), `interval`
                              paces append fsyncs at
                              raft_fsync_interval_ms while still
                              syncing commit points (manifest/meta/
                              snapshot), `never` trusts the page cache
                              (throughput over durability — a power
                              loss may forget acked entries; a plain
                              process crash still loses nothing).
                              Hot-reloadable; NOMAD_RAFT_FSYNC
                              (`mode` or `mode:interval_ms`) overrides
                              for bench legs.
      raft_fsync_interval_ms  append-fsync pacing for raft_fsync =
                              interval.
      raft_group_commit_max_entries
                              leader write-path group commit (ISSUE 20,
                              docs/DURABILITY.md): max proposals one
                              committer drain stages into a SINGLE WAL
                              append + fsync window. Self-clocking (no
                              timer): an idle leader still commits a
                              lone entry immediately. 1 = serial
                              one-entry-per-sync (the differential-test
                              oracle). Hot-reloadable;
                              NOMAD_RAFT_GROUP_COMMIT overrides for
                              bench legs and the crash fuzzer.
      raft_replicate_batch_max
                              max log entries one AppendEntries RPC
                              ships per follower round; the follower
                              persists the whole batch with ONE fsync
                              before acking (persist-before-ack at
                              batch granularity). Hot-reloadable;
                              NOMAD_RAFT_REPL_BATCH overrides.
      solver_convex_enabled   global convex placement tier (ISSUE 19):
                              with scheduler_algorithm = "convex", solve
                              the whole eval as ONE on-device projected-
                              gradient program (binpack/spread/affinity
                              objective + per-tenant quota budget +
                              namespace-stacking fairness), demoting to
                              the greedy ladder via the tier breaker on
                              any failure. False pins the greedy ladder
                              even under the convex algorithm;
                              NOMAD_SOLVER_CONVEX=0/1 env overrides
                              (docs/BACKEND_TIERS.md).
      solver_convex_max_iters projected-gradient iteration ceiling (the
                              `lax.while_loop` bound; convergence
                              usually stops the loop far earlier).
      solver_convex_tolerance relative objective-decrease threshold that
                              declares convergence.
      solver_convex_fairness_weight
                              weight of the namespace-stacking fairness
                              term in the objective; 0 solves pure
                              fragmentation.
      solver_convex_namespace_quota
                              per-tenant (namespace) running-instance
                              budget the convex solve hard-caps each
                              eval's placement count against; 0 = no
                              quota.
    """
    scheduler_algorithm: str = SCHED_ALG_BINPACK
    preemption_config: PreemptionConfig = field(default_factory=PreemptionConfig)
    memory_oversubscription_enabled: bool = False
    reject_job_registration: bool = False
    pause_eval_broker: bool = False
    plan_pipeline_enabled: bool = True
    plan_pipeline_chunks: int = 4
    plan_pipeline_min_count: int = 8192
    eval_batch_enabled: bool = True
    eval_batch_window_ms: float = 8.0
    plan_commit_batch_max: int = 32
    plan_commit_timeout_s: float = 30.0
    plan_commit_window_ms: float = 5.0
    telemetry_trace_enabled: bool = True
    telemetry_trace_sample: float = 1.0
    telemetry_trace_capacity: int = 2048
    ingress_write_rate: float = 0.0
    ingress_read_rate: float = 0.0
    ingress_blocking_rate: float = 0.0
    ingress_burst_s: float = 2.0
    broker_depth_cap: int = 8192
    eval_deadline_s: float = 0.0
    pressure_saturated_frac: float = 0.5
    heartbeat_invalidate_rate_cap: int = 4096
    flap_damping_threshold: int = 3
    flap_damping_window_s: float = 300.0
    flap_damping_backoff_s: float = 30.0
    flap_damping_backoff_max_s: float = 900.0
    placement_explain_enabled: bool = True
    placement_explain_recent: int = 256
    # whole-eval residency (ISSUE 15): fuse gather+solve+plan-verdict
    # (+explain) into ONE compiled dispatch against the state cache's
    # resident twins. Placements are bit-identical on or off;
    # NOMAD_SOLVER_FUSED=0/1 env force-overrides (bench parity legs).
    solver_fused_enabled: bool = True
    # global convex placement tier (ISSUE 19): cluster-wide allocation
    # as one on-device projected-gradient solve when the operator picks
    # scheduler_algorithm = "convex". All four knobs are runtime scalars
    # of the compiled program — hot-reloading them never recompiles.
    # NOMAD_SOLVER_CONVEX=0/1 env force-overrides (bench parity legs).
    solver_convex_enabled: bool = True
    solver_convex_max_iters: int = 200
    solver_convex_tolerance: float = 1e-4
    solver_convex_fairness_weight: float = 0.05
    solver_convex_namespace_quota: int = 0
    raft_fsync: str = "always"
    raft_fsync_interval_ms: float = 50.0
    raft_group_commit_max_entries: int = 64
    raft_replicate_batch_max: int = 1024
    create_index: int = 0
    modify_index: int = 0

    def effective_scheduler_algorithm(self) -> str:
        """ref operator.go:164 EffectiveSchedulerAlgorithm"""
        return self.scheduler_algorithm or SCHED_ALG_BINPACK

    def validate(self) -> str:
        if self.scheduler_algorithm not in VALID_SCHEDULER_ALGORITHMS:
            return (f"invalid scheduler algorithm {self.scheduler_algorithm!r}; "
                    f"must be one of {VALID_SCHEDULER_ALGORITHMS}")
        if self.plan_pipeline_chunks < 1:
            return "plan_pipeline_chunks must be >= 1"
        if self.plan_pipeline_min_count < 0:
            return "plan_pipeline_min_count must be >= 0"
        if self.eval_batch_window_ms < 0:
            return "eval_batch_window_ms must be >= 0"
        if self.plan_commit_batch_max < 1:
            return "plan_commit_batch_max must be >= 1"
        if self.plan_commit_timeout_s <= 0:
            return "plan_commit_timeout_s must be > 0"
        if self.plan_commit_window_ms < 0:
            return "plan_commit_window_ms must be >= 0"
        if not 0.0 <= self.telemetry_trace_sample <= 1.0:
            return "telemetry_trace_sample must be in [0, 1]"
        if self.telemetry_trace_capacity < 1:
            return "telemetry_trace_capacity must be >= 1"
        for knob in ("ingress_write_rate", "ingress_read_rate",
                     "ingress_blocking_rate"):
            if getattr(self, knob) < 0:
                return f"{knob} must be >= 0 (0 disables)"
        if self.ingress_burst_s <= 0:
            return "ingress_burst_s must be > 0"
        if self.broker_depth_cap < 0:
            return "broker_depth_cap must be >= 0 (0 = unbounded)"
        if self.eval_deadline_s < 0:
            return "eval_deadline_s must be >= 0 (0 = no deadline)"
        if not 0.0 < self.pressure_saturated_frac <= 1.0:
            return "pressure_saturated_frac must be in (0, 1]"
        if self.heartbeat_invalidate_rate_cap < 0:
            return "heartbeat_invalidate_rate_cap must be >= 0 (0 = uncapped)"
        if self.flap_damping_threshold < 0:
            return "flap_damping_threshold must be >= 0 (0 disables)"
        if self.flap_damping_window_s <= 0:
            return "flap_damping_window_s must be > 0"
        if self.flap_damping_backoff_s <= 0:
            return "flap_damping_backoff_s must be > 0"
        if self.flap_damping_backoff_max_s < self.flap_damping_backoff_s:
            return ("flap_damping_backoff_max_s must be >= "
                    "flap_damping_backoff_s")
        if self.placement_explain_recent < 1:
            return "placement_explain_recent must be >= 1"
        if self.solver_convex_max_iters < 1:
            return "solver_convex_max_iters must be >= 1"
        if self.solver_convex_tolerance <= 0:
            return "solver_convex_tolerance must be > 0"
        if self.solver_convex_fairness_weight < 0:
            return "solver_convex_fairness_weight must be >= 0"
        if self.solver_convex_namespace_quota < 0:
            return "solver_convex_namespace_quota must be >= 0 (0 = no quota)"
        if self.raft_fsync not in ("always", "interval", "never"):
            return ("raft_fsync must be one of 'always', 'interval', "
                    "'never'")
        if self.raft_fsync_interval_ms <= 0:
            return "raft_fsync_interval_ms must be > 0"
        if self.raft_group_commit_max_entries < 1:
            return "raft_group_commit_max_entries must be >= 1 (1 = serial)"
        if self.raft_replicate_batch_max < 1:
            return "raft_replicate_batch_max must be >= 1"
        return ""
