#!/usr/bin/env python3
"""Chip smoke test of nomad_tpu_torch: the quickest proof that the port
starts on the card and that its main path goes through its kernels.

    python3 chip_smoke.py          # from the repo root, one CUDA card

Phases (any failed check raises; the script then exits non-zero and
prints no result):

  1. device   torch/CUDA versions, whether nvcc and triton exist, the card
              (`nvidia-smi --query-gpu=name,power.limit`).
  2. build    the CUDA kernels from nomad_tpu_torch/solver/csrc (and the
              empty launch-floor kernel and the pow10 check), one nvcc per
              source, started together; ptxas registers and shared memory.
  3. pow10    the kernels' 10**x (csrc/pow10.cuh) against the float64 pow
              rounded to float32 on every float32 in [-46, 1] and below -46,
              enumerated on the card: 0 mismatches, 0 below -46.
     kernels  each kernel against its plain PyTorch version on the card, on
              seeded inputs at the main path's shapes: 10,000 live nodes in
              the 16,384 bucket, the depth curve dense at K=128, on the
              sampled grid (DEPTH_GRID <= 128), with max_per_node=1, with
              a block of infeasible rows, under the spread algorithm (dense
              and grid), and dense at K=512 with a small ask (capacities
              past 512); the score/capacity pass at 16,384, its score entry
              under the greedy tail and its greedy entry against the plain
              fill at counts 1 and 5,000 and at max_per_node 1. Capacities
              exactly equal, densities and scores to atol 1e-4, k_star
              exactly equal except on rows whose top two plain densities lie
              within 1e-5 (counted); placements exactly equal (0 moved
              nodes). Device times per launch from the profiler over 30
              launches, per-call times by CUDA events (medians of 200
              calls for the kernels, 30 for the plain versions); the
              kernels of one fill_greedy_binpack_fused call; an empty
              kernel's device time (`floor_ms`).
     chunked  the chunked-step kernel (csrc/chunked_step.cu) against its
              plain step at the same bucket (10,000 live rows; two spread
              stanzas, one targeted and one even, a distinct_property
              stanza, affinity, collisions): can_place equal, scores bit
              for bit (the score csrc/chunked_score.cuh gives both scan
              kernels). Then the whole-scan kernel (csrc/chunked_scan.cu)
              against the plain scan, placements, usage, spread counts
              and quotas bit-equal, one launch a solve and no step
              launch: on those inputs under binpack and the spread
              algorithm, and on every fixture of nomad_tpu_torch/
              testing.py (SCAN_CASES: chunk 1, nothing feasible, done
              mid-scan, max_per_node 1, a split ask, buckets 8, 1,024 and
              65,536). Step kernel: device time per launch (profiler, 30
              launches). Scan kernel: device time per solve (profiler, 10
              solves), wall per call, the plain scan's, the steps it ran,
              one cluster barrier (an empty loop of 10,000, queued
              events) and the dependency floor (steps x barrier), the
              bound (`chunked_scan` lines).
  4. main     the port's placement path at the north-star size: an FSM with
              10,000 bench-fleet nodes under scheduler_algorithm=tpu-batch
              and the Planner's applier thread running, three evals
              through new_scheduler("batch") -> process -> the applier's
              queue -> FSM commit: a 50,000-task batch job (pipelined, as
              the default knobs say: 4 chunks of the dense depth curve,
              each chunk's plan committed while later chunks solve), a
              2,000-task job (the grid, serial) and a count-1 job (the
              greedy pass, serial), at the defaults: the 50k eval on the
              classic route, the 2k and count-1 evals on the whole-eval
              fused route. Every instance committed, no usage row over
              capacity; the 50k eval counted 1 pipelined eval, 4 chunks,
              4 depth-curve launches, no fused dispatch and one dispatch
              on the twins' rows; the 2k eval one launch of K1's gather
              entry, the count-1 eval one of K2's, each one verdict
              launch, one fused dispatch and one device round trip; the
              state cache's twins on cuda:0, fed by every commit (equal
              to the committed usage), served hits; the plain tier
              untouched. The launch counts are zeroed just before and
              read just after.
     service  the slice at full width: a fresh FSM of 10,000 bench-fleet
              nodes in datacenters dc1..dc3 (i % 3) and racks r0..r99
              (i % 100), service preemption on, the applier thread
              running: (a) `web`, 5,000 instances with the spread blocks
              of Nomad's documentation examples (datacenters 50/30/20
              under weight 70, racks even under weight 30), (b)
              `rack-capped`, 150 instances under distinct_property
              ${meta.rack} = 2, (c) a priority-20 batch job filling every
              node at 2,000 MHz / 4,096 MB, then a priority-80 service
              job of 1,000 such instances. Every instance committed, no
              row over capacity, (a) near its targets and its racks even
              (tolerances at WEB_DC_TOL), (b) at most 2 per rack, (c)
              exactly 1,000 filler allocs preempted; no host fallback on
              (a) and (b), one scan-kernel launch per scan solve and no
              step-kernel launch; the plain tier untouched. Each scan
              solve replayed on its own inputs (bit-equal to the plain
              scan; steps, device time, wall) and the preemption
              masks on the card and the CPU (equal; [C, V], wall, device
              time). Launch counts zeroed before (a), read after (c).
  5. compare  the same 50k eval on fresh clusters, serial
              (plan_pipeline_enabled=False: at the defaults the serial
              eval takes the fused route) and pipelined, each with
              explain on and off (placement_explain_enabled), in turns
              (COMPARE_ORDER, two runs a cell), each with the applier
              thread running and after a full garbage collection: the
              walls and their medians per cell, the layer breakdowns and
              the pipeline's host/overlap seconds; launch counts zeroed
              before and read after each run.
  6. profile  the pipelined 50k eval under torch.profiler: the card's busy
              time against the eval's wall.
  7. small    a 200-node cluster's evals on the card and on the CPU (the
              plain tier): the depth and greedy jobs, two pipelined
              (plan_pipeline_min_count 1, 3 chunks), the web, rack-capped
              and a deep job on the scan, a filler and a job placed by
              preemption, then a job asked beyond the full cluster's
              capacity and a distinct_hosts job past one per node, each
              from the same seeded id stream: identical alloc -> node
              maps, preempted alloc ids, explain records (tier aside),
              placed allocs' metrics (score metadata, scores) and failed
              placements' metrics, field for field.
  8. ladder   the dispatch chain on the card, faulted on purpose: card
              work never moves to the CPU, so a device error raises out
              of the eval. The 2,000-task eval with `solver.dispatch.cuda`
              faulted once raises and commits nothing; the pipelined 50k
              eval with a CUDA out-of-memory error raised at chunk 2's
              host copy raises PipelineChunkError after committing chunks
              0 and 1; each counts one dispatch error and runs no solve
              on the CPU. Then the breaker with a threshold of 2: two
              faulted solves (each raised, none skipped) open it, a
              healthy solve launches the kernel and closes it, an
              injected device loss opens it at once; and a kernel build
              error and a bug, each raised BREAKER_THRESHOLD + 1 times
              over, never counted and never open it (`ladder` lines).

  9. lanes    (after `kernels`) the depth-curve kernel over the lanes of a
              full micro-batch window: 8 lanes at the 16,384 bucket (own
              usage, ask, count and max_per_node each) bit-equal to 8
              one-lane launches and, placements, to each lane's solo
              fill_depth_fused; plain version within K1's tolerances;
              device ms per window against 8 solo launches, the bound.
              Then the fused window (the batch tier with the fused route
              on, forced: BATCH_MAX_COUNT is 0): 8 lanes of one resident
              twin pair, each its own shuffled idx, one launch of K1's
              gather entry and one of the verdict, each lane bit-equal to
              its solo fused eval; its device ms.
     fused    (after `lanes`) the whole-eval fused route's kernel entries
              at the main path's shapes (16,384 rows, 10,000 live in
              shuffled idx over the twins): K1's gather entry dense at
              K=128 on the 50k eval's fleet, on the grid and under the
              spread algorithm; K2's greedy gather entry placing 1, 2,000
              and 5,000; the fit verdict (csrc/fit_verdict.cu) on the 2k
              fused eval's placements and on over-full ones, over 1, 3
              and 8 lanes and on a ragged edge, its device ms beside its
              gather floor (launch_floor.cu's gather entry: the same
              grid, one dependent gather a row). Each
              bit-equal to its plain version (the gather entries to their
              kernel's plain entry on gather_rows' rows, and to the torch
              versions within K1's and K2's tolerances; the verdict to
              kernels.fit_verdict_ref), one launch each; device ms,
              per-call ms, plain ms, bound, launch floor; each fused
              eval's kernels and one call with its host copy (`fused K1
              gather`, `fused K2 gather`, `fused fit verdict`, `fused
              ... eval` lines).
 10. server   the port's Server(num_workers=4) on the card: 10,000 nodes
              through node_register, the 50k job through job_register, a
              worker and the pipelined applier (every instance committed,
              no row over capacity, register -> last commit wall, layer
              timers); a fresh Server over snapshot_restore, whose
              establishment reseeds the state cache (10,000 rows) and
              warms every kernel, after which a 2k eval builds and loads
              nothing; the debug bundle (the card in DeviceRuntime, one
              shard, breakers closed, the state cache's rows).
     fused pairs  (after `server`) the fused route against the classic one
              in turns, FUSED_PAIRS pairs (on first in even pairs): each
              leg a fresh one-worker server over the 10,000-node
              snapshot with solver_fused_enabled on or off, running the
              2k eval, the count-1 eval and the stream (16 jobs of 1,000
              back to back), every eval id pinned; per eval its wall,
              nomad.plan.evaluate, verdict_fastpath, dispatch.fused.cuda
              and the most round trips an eval counted. Placements equal
              in both legs of every pair; on, one fused dispatch and one
              round trip an eval and the verdict's fast path on the 2k
              eval; off, none; a sign test per eval kind (`fused pair`,
              `fused pairs` lines).
 11. stream   16 jobs of 1,000 tasks registered back to back on a fresh
              10,000-node server with 4 workers, micro-batching on and off
              in turns (on, off, off, on) (stream_sweep.py runs the
              sweep's other counts, 500, 2,000 and 4,000, with more
              pairs): evals/s, submit_plan p50/p99, the batcher's counters and
              window sizes, the window launches; every instance
              placed, no row over capacity. Here with the fused route
              off, so the windows are the classic lanes entry
              (stream_sweep.py runs the defaults: fused windows). Per
              count, the runs in pairs
              and a one-sided sign test on them: a count qualifies for
              backend.BATCH_MAX_COUNT only where the coalesced run beat
              solo in enough pairs (p <= 0.05); two pairs a count, as
              here, can never qualify one (stream_sweep.py runs more).
 12. rejections  8 jobs of 1,000 tasks (cpu 400, mem 700) at once on a
              2,000-node server with 8 workers, under tpu-batch and under
              binpack: node and alloc rejection rates from each plan's
              PlanResult (the planner instance wrapped); each job placed
              whole or failed on plan conflicts with a blocked eval
              holding the rest; no row over capacity.
 13. server fault  solver.dispatch.cuda faulted once under a 2k eval: the
              worker nacks, the broker redelivers, the second delivery
              commits everything; 1 dispatch error, 1 eval failure, 0 CPU
              solves. Faults cleared and the breaker reset after.
 14. convex   (a) the convex-solve kernel (csrc/convex_solve.cu) against
              its plain version at bench.py `_convex_run`'s cluster
              (10,000 nodes, 16,384 rows, count 3,000, fairness 0.05),
              binpack and spread, at tolerance 1e-4 and 1e-9, a 128-row
              case that runs all 200 iterations, and every other
              testing.CONVEX_CASES fixture (the 65,536- and 131,072-row
              buckets, budget 0): the solve bit for bit, the whole
              eval's placements, fit, convex_won and iterations equal,
              one launch each of the kernel and K2, 0 rows over
              capacity; on the timed cases device ms, per-call ms, plain
              ms, bound and dependency floor, and the one-halving
              design's reduction count (`convex <case>` lines). (b)
              scheduler_algorithm "convex" set through the operator API
              on a 10,000-node server: a 5,000-task job under convex and
              tpu-batch in turns, register -> commit walls; a convex eval
              counts 1 convex dispatch, 1 round trip, 1 launch of the
              kernel, 0 CPU solves (`convex server` lines). (c)
              solver.dispatch.convex faulted once: nacked, redelivered,
              committed in one plan (`convex fault`).
 15. raft     three port Servers in this process on one in-memory
              VirtualNetwork, each with a durable WAL (server/durable.py)
              in a temp dir at raft_fsync = always, group commit on, the
              DISK timing of tests/test_raft.py (RAFT_TIMING) and 4
              workers each (a follower's workers wait on its disabled
              broker). (a) The 10,000-node fleet through
              the leader's node_register from 16 threads (entries per
              leader append, i.e. per fsync, and per AppendEntries); the
              50k job through job_register on the leader and the same job
              on an in-memory-log Server over the server phase's fleet
              snapshot, in turns (RAFT_ORDER): register -> last commit on
              the leader, -> both followers applied the leader's index,
              layers, raft samples, fsyncs, one replication hop's codec
              cost; then a count-1 job (K2's greedy entry). Every
              instance on every store, 0 rows over capacity, no election
              mid-eval, 0 CPU solves, 0 dispatch errors, 0 swallowed
              state-cache errors; K1 launched 4 times a raft 50k eval.
              (b) The leader crashed (net.crash): crash -> new leader
              established (its barrier reseeds the state cache at 10,000
              rows on the card), -> warmup done, a 2,000-task job (one
              pinned eval id) register -> commit; the twins equal a fresh
              reseed's; the crashed server rebuilt over its data_dir
              recovers from its WAL and catches up (its store's allocs and
              usage equal the leader's); a fresh Server over the new
              leader's snapshot places the 2k job exactly as the new
              leader did (`raft ...` lines).
 16. agent    the port as Nomad's agent, every agent its own OS process
              (`python -m nomad_tpu_torch.cli agent -config <file>`,
              data dirs under build/, no NOMAD_SOLVER_DEVICE: each solves
              on cuda:0). (a) A -dev agent: scheduler set to tpu-batch
              and an HCL raw_exec job (3 x /bin/sleep) run through the
              port's CLI; job, alloc (its placement metrics) and node
              status; the 3 task processes under its data dir; /ui 200;
              from /v1/metrics `nomad.solver.dispatch.cuda` >= 1, 0 on
              the CPU's tier, 0 dispatch errors; /v1/agent/self's device
              row names the card; its cold build (compile-cache misses,
              start -> first commit); job stop ends the tasks. (b) Three
              server agents (TCP RPC, gossip retry_join, bootstrap_expect
              3, Raft on the agent's defaults: 0.4-0.8 s election
              timeout, raft_fsync always, WALs under the data dirs), two
              client agents in datacenter `real`, and the node simulator
              (`python -m nomad_tpu_torch.testing simulate`): 10,000
              bench-fleet nodes registered over the servers' RPC and
              heartbeated every half TTL. Over HTTP: the 50k job
              (register -> last commit on the leader within
              AGENT_BIG_BOUND_S, -> both followers applied), a count-1
              job and a count-2 raw_exec job that must run one sleep on
              each client agent; each process's CPU seconds during the
              eval (/proc/<pid>/stat); the leader's and a follower's
              snapshots decoded with the port's codec: every job's
              allocs, no alloc id or name twice, 0 usage rows over
              capacity. (c) kill -9 of the leader, once every follower
              is a warm standby: crash -> a survivor
              established, its state cache promoted warm or reseeded, its
              warmup, a 2,000-task job register -> commit with no
              compile-cache miss on the promoted leader, the new
              leader's snapshot held as in (b); the killed agent
              restarted over its data dir catches up (its alloc count the
              leader's) and loads its kernels (compile-cache hits, no
              miss). Every leader change with its term (`agent elections`);
              every node ready at the end and none marked down for a
              missed TTL (`nomad.heartbeat.invalidate`, every server). Every child process is
              stopped and every task process reaped in a `finally`
              (`agent ...` lines).
 17. analysis (after `main`) the port's static analyzer gate over the
              tree this script ships (`python -m nomad_tpu_torch.analysis
              nomad_tpu_torch`, in a process of its own while the evals
              run): no active finding, no parse error. Then three evals on
              fresh 10,000-node clusters under torch's sync debug mode
              ("warn"): the 50k-task eval serial (the fused route), one
              fused 2,000-task eval, and the 50k eval pipelined (the main
              path's default). Every synchronizing call the card reports,
              from any thread (a warnings hook, not catch_warnings), is
              counted by the innermost nomad_tpu_torch/ file and line; a
              sync in SYNC001's scope (solver/placer.py,
              solver/microbatch.py) must fall on a line carrying a
              `nomadlint: disable=SYNC001` seam marker. The mode is reset
              to "default" in a `finally` (`analysis ...` lines).
 18. mesh     (last) the device mesh (solver/sharding.py) on 4
              virtual shards of the card (`device.use_devices(["cuda:0"]
              * 4)`; restored in a `finally`). (1) Each shard's K1, K2,
              their gather entries and fit_verdict against their plain
              versions on the shard's block, then every sharded solve on
              the 50k eval's inputs (greedy 5,000, depth 50,000, fused
              depth 2,000, fused greedy 1, preemption over 4,096
              candidates) bit-equal to the solo solve, with one launch of
              its kernel a shard (counts zeroed just before each solve,
              read just after) and both walls. (2) Pod scale: 100,000
              pinned-id nodes, one 200,000-task eval (eval id pod-eval)
              solo and sharded on identical clusters, placements equal node
              for node, the sharded leg's syncs under the debug mode (none
              unmarked), then one 1,000,000-task eval committed whole on
              the mesh. (3) Elasticity: SHARD_MIN_NODES 8,192, 16 x 1,000
              tasks with pinned eval ids on a server over the 10,000-node
              fleet; undisturbed, then shards d2 and d1 lost at staggered
              dispatch seams (one worker: placements equal the undisturbed
              run's; then 4 workers): one generation bump a loss,
              quarantine [1, 2], 2 shards, replays, evacuation seconds, 0
              evals lost; then every shard lost: the next eval raises and
              commits nothing. (4) With several cards, (1) over the real
              cards; else one line saying the mesh ran on virtual shards
              (`mesh ...` lines; no multi-card figure).

Servers run with their heartbeat TTL set past the run (no clients here)
and stop in a `finally`. The native stamping extension (native/) is
built with runtime.ensure_native() before the first eval.

Explain runs at its default (on) everywhere: the `explain` lines give
each main-path eval's record (the 50k eval's placed_total 50,000 and
n_feasible 10,000) and `nomad.solver.explain.seconds`; the placer
reduces every solve on the host (`reduce_numpy`), so no eval runs a
reduce on the card. The explain phase (after `chunked`) holds the torch
reduce on the card (kernels.explain_reduce) to the numpy reduce bit for
bit at the 16,384 bucket and on a float32 rounding boundary, gives its
device ms per reduce, and times the two ways to finish a serial solve:
that reduce enqueued on the card riding the placement vector's copy,
against the copy alone followed by the numpy reduce (the placer's). The compare phase runs the 50k eval
serial and pipelined, each with explain on and off, in turns. Every
healthy phase fails on any dispatch error, breaker opening or explain
error (nomad.solver.explain.errors).

Then a `kernels` JSON line and, last, the device line.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_LIVE = 10_000
N_BUCKET = 16_384
SEED = 20261016
ATOL = 1e-4
NEAR_TIE = 1e-5
REPS = 30
# per-call times (CUDA events around one wrapper call) are host time for
# the most part and spread widely from call to call: take a longer median
CALL_REPS = 200
BIG_COUNT, MID_COUNT = 50_000, 2_000
# per-eval layer timers (seconds, metrics.timer_sum deltas)
LAYERS = ("nomad.scheduler.reconcile", "nomad.solver.tensorize",
          "nomad.solver.device", "nomad.solver.solve",
          "nomad.solver.materialize", "nomad.solver.preempt",
          "nomad.solver.explain.seconds", "nomad.plan.evaluate",
          "nomad.plan.apply")
# the pipelined lifecycle's host seconds, and those of them spent while
# chunk solves or the applier were still busy
PIPE_TIMERS = ("nomad.plan.pipeline.host", "nomad.plan.pipeline.overlap")
# per-eval counter deltas, by short name
COUNTERS = {"evals": "nomad.plan.pipeline.evals",
            "chunks": "nomad.plan.pipeline.chunks",
            "twin_dispatches": "nomad.solver.state_cache.twin_dispatches",
            "torch_depth": "nomad.solver.kernel.depth.torch",
            "torch_greedy": "nomad.solver.kernel.greedy.torch",
            "torch_chunked": "nomad.solver.kernel.chunked.torch",
            "scan_solves": "nomad.solver.kernel.chunked.cuda",
            "host_fallback": "nomad.solver.placements_host_fallback",
            # the dispatch chain: classified device errors, breaker
            # openings, solves served by the CPU's plain tier
            "dispatch_errors": "nomad.solver.dispatch_errors",
            "breaker_opened": "nomad.solver.tier_breaker_opened",
            "torch_serves": "nomad.solver.dispatch.torch",
            "torch_fused_serves": "nomad.solver.dispatch.fused.torch",
            # the whole-eval fused route's dispatches on the card
            "fused": "nomad.solver.dispatch.fused.cuda",
            # explain: records, reduces run on the card, swallowed errors
            "explain_records": "nomad.solver.explain.records",
            "explain_errors": "nomad.solver.explain.errors"}
# counters every healthy phase must leave at 0
HEALTHY_ZERO = ("dispatch_errors", "breaker_opened", "explain_errors")
# and every eval on the card: no solve served by the CPU's plain tier
CARD_ZERO = HEALTHY_ZERO + ("torch_serves", "torch_fused_serves")
# the kernels the main path runs: the 50k eval the classic depth curve,
# the 2k and count-1 evals the fused route's entries; the service path
# runs chunked_scan
MAIN_KERNELS = ("depth_curve", "depth_curve_gather", "score_capacity_gather",
                "fit_verdict")
# the card the port solves on (the solve device's default)
DEVICE = "cuda:0"
BIG_CHUNKS = 4          # SchedulerConfiguration.plan_pipeline_chunks default
# the compare phase: (mode, explain) in turns, two runs a cell
COMPARE_ORDER = ((("serial", True), ("pipelined", True),
                  ("pipelined", False), ("serial", False)) +
                 (("serial", False), ("pipelined", False),
                  ("pipelined", True), ("serial", True)))
SMALL_PIPELINE = {"plan_pipeline_min_count": 1, "plan_pipeline_chunks": 3}

# the service path: racks per cluster, the web job's datacenter targets
# (percent), the distinct_property cap per rack, and the evals' sizes
N_RACKS = 100
WEB_TARGETS = {"dc1": 50, "dc2": 30, "dc3": 20}
RACK_CAP = 2
WEB_COUNT, RACK_CAPPED_COUNT, PREEMPT_COUNT = 5_000, 150, 1_000
FILL_ASK = (2_000, 4_096)               # MHz, MB of the filler and preemptor
# the service tier's priority: the preemptor's, and web's and
# rack-capped's, so only the priority-20 filler is below it (a victim
# must have a lower priority than the job that preempts it)
SERVICE_PRIORITY = 80
# The spread blocks are soft: the reference's own chunked scan (the JAX
# package's place_chunked, which the port matches bit for bit) lands this
# web job on an empty 2,500-node fleet about 2% of the job off its
# datacenter targets, its racks 45..59
# (tests/test_torch_chunked.py::test_web_spread_at_proxy_scale_matches_
# reference). The card is held per datacenter to that test's own bound,
# 2.5% of the job, and to a rack spread (max - min) of half the mean.
WEB_DC_TOL = 0.025
WEB_RACK_SPREAD = 0.5

# H100 SXM published peaks (HBM3 bandwidth, dense f32 CUDA-core rate)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per evaluated dense depth / per node, read off the kernels'
# source; a pow counts as ONE operation, so the bound is a lower bound
DEPTH_OPS_DENSE, DEPTH_OPS_NODE = 31, 30
SCORE_OPS_NODE = 35
# chunked_step.cu: per node (capacity, fit score, anti, affinity, mean)
# and per spread stanza (boost and sum)
STEP_OPS_NODE, STEP_OPS_STANZA = 38, 8
# chunked_scan.cu: per live node per step beside the spread and distinct
# terms (the pre-score load, the mean: adds, compare, divide, the key)
SCAN_OPS_STEP = 6
SOLVE_REPS = 5
# cluster barriers per launch when timing one barrier
BARRIER_STEPS = 10_000
# the ladder phase's breaker cycle: rows a solve
BREAKER_ROWS = 1_024
# the server slice: every wait on a server's evals ends by this deadline
SERVER_TIMEOUT_S = 180.0
# the stream: jobs registered back to back on a 10,000-node server with
# 4 workers, at STREAM_COUNT and at the other counts of the batch tier's
# sweep, STREAM_PAIRS pairs of runs (batching on and off) a count; a count
# qualifies for backend.BATCH_MAX_COUNT where coalescing beat solo in
# enough pairs for a one-sided sign test at STREAM_P
STREAM_JOBS, STREAM_WORKERS, STREAM_COUNT = 16, 4, 1_000
STREAM_COUNTS = (1_000, 500, 2_000, 4_000)
STREAM_PAIRS, STREAM_P = 2, 0.05
# plan rejections under concurrent workers (bench.py
# _concurrent_rejection_rate's shape, each job cut from 2,000 tasks to
# 1,000: the binpack run is host scheduling under one interpreter lock,
# 237-286 s at 2,000, and the script keeps to its running time)
REJECT_NODES, REJECT_JOBS, REJECT_COUNT, REJECT_WORKERS = 2_000, 8, 1_000, 8
# the host binpack scheduler takes seconds an eval at this size, its 8
# workers share one interpreter lock, and evals that lose a plan conflict
# plan again
REJECT_TIMEOUT_S = 720.0


def _cpu_solves(metrics) -> float:
    """Solves served by the CPU's plain tier, classic or fused."""
    return metrics.counter("nomad.solver.dispatch.torch") + \
        metrics.counter("nomad.solver.dispatch.fused.torch")


class CheckFailed(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------ phase 1

def device_phase(torch) -> str:
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"nvcc {nvcc or 'missing'}; triton "
        f"{'present' if importlib.util.find_spec('triton') else 'missing'}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch sees {torch.cuda.device_count()} device(s): "
        f"{torch.cuda.get_device_name(0)}")
    return card


# ------------------------------------------------------------ phase 3

# float32 bit patterns, inclusive: every float32 in [-46, 1] (both signs
# of zero), then every float32 below -46 down to -inf
POW10_RANGES = (("[0, 1]", 0x00000000, 0x3F800000),
                ("[-46, -0]", 0x80000000, 0xC2380000),
                ("below -46", 0xC2380001, 0xFF800000))


def pow10_phase(torch, dev) -> dict:
    """pow10.cuh's 10**x, which both kernels call, against the float64 pow
    rounded to float32 on every float32 input of POW10_RANGES, enumerated
    by bit pattern on the card: 0 mismatches, and 0 everywhere below -46
    in both."""
    from nomad_tpu_torch.solver import cuda_kernels
    cuda_kernels.pow10_check(0, 0, dev)                 # load, warm up
    out = {"inputs": 0, "mismatches": 0, "undecided": 0}
    t0 = time.perf_counter()
    for name, first, last in POW10_RANGES:
        mism, undecided, nonzero = cuda_kernels.pow10_check(first, last, dev)
        count = last - first + 1
        log(f"pow10 {name}: {count} float32 inputs, {mism} mismatches, "
            f"{undecided} left to the float64 pow, {nonzero} nonzero")
        check(mism == 0, f"pow10 {name}: {mism} mismatches")
        if name == "below -46":
            check(nonzero == 0, f"pow10 below -46: {nonzero} nonzero")
        out["inputs"] += count
        out["mismatches"] += mism
        out["undecided"] += undecided
    out["seconds"] = time.perf_counter() - t0
    log(f"pow10: {out['inputs']} inputs checked in {out['seconds']:.3f} s")
    return out


def _inputs(np, torch, dev):
    """Seeded node matrices at the main path's bucket: bench-fleet
    capacities, partial usage, ~5% infeasible live rows, padding rows
    zero and infeasible (as the placer pads)."""
    from nomad_tpu_torch.solver.tensorize import DYN_PORT_SPAN
    rng = np.random.default_rng(SEED)
    cap = np.zeros((N_BUCKET, 5), np.float32)
    cap[:N_LIVE, 0] = rng.choice([4_000, 8_000, 16_000, 32_000], N_LIVE)
    cap[:N_LIVE, 1] = rng.choice([8_192, 16_384, 32_768, 65_536], N_LIVE)
    cap[:N_LIVE, 2] = 500_000
    cap[:N_LIVE, 3] = DYN_PORT_SPAN
    cap[:N_LIVE, 4] = 1_000
    used = np.zeros_like(cap)
    used[:N_LIVE, 0] = np.floor(cap[:N_LIVE, 0] * rng.random(N_LIVE) * 0.6)
    used[:N_LIVE, 1] = np.floor(cap[:N_LIVE, 1] * rng.random(N_LIVE) * 0.6)
    used[:N_LIVE, 2] = rng.integers(0, 100_000, N_LIVE)
    feas = np.zeros(N_BUCKET, bool)
    feas[:N_LIVE] = rng.random(N_LIVE) > 0.05
    coll = np.zeros(N_BUCKET, np.int32)
    coll[:N_LIVE] = (rng.random(N_LIVE) < 0.1).astype(np.int32)
    aff = np.zeros(N_BUCKET, np.float32)
    jitter = rng.random(N_BUCKET, dtype=np.float32)
    ask = np.array([250, 512, 300, 0, 0], np.float32)

    def t(a):
        return torch.from_numpy(a).to(dev)
    return dict(cap=t(cap), used=t(used), ask=t(ask), feasible=t(feas),
                coll=t(coll), aff=t(aff), jitter=t(jitter))


def _median_ms(torch, fn, reps=REPS) -> float:
    """Median wall time of one call on the card's clock (CUDA events):
    the kernel plus whatever host work keeps the card waiting between
    the events (wrapper checks, allocation, launch)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(torch, fn, kernel: str, reps=REPS, per_call=1,
               scale_missing=False) -> tuple:
    """(kernel ms, all device ms, how) per call from a torch.profiler
    trace of `reps` calls: the named kernel's own device time, the device
    time of every kernel the call launches, and how the kernel's was
    taken. A call launches the named kernel `per_call` times; a trace
    that recorded another number of its launches is logged and taken
    again. After three such traces a kernel launched once a call is
    timed by the mean of the launches its last trace did record, if that
    is at least half of them: how is then "profiler (n of reps
    launches)", else "profiler". With `scale_missing`, a kernel launched
    many times a call (a sharded solve's queued launches) is timed the
    same way: the mean launch the last trace recorded times `per_call`.
    Else its time and how are None (the caller times with CUDA events).
    (None, None, None) when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    mine = n_mine = 0
    for _ in range(3):                  # a trace may miss the kernel
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as e:       # no CUPTI: CUDA events instead
            log(f"profiler unavailable ({e}); timing with CUDA events")
            return None, None, None
        mine = total = 0.0
        n_mine = 0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            total += us
            if kernel in e.name:
                mine += us
                n_mine += 1
        if not kernel:
            if total > 0:
                return None, total / reps / 1e3, None
            continue
        if n_mine == reps * per_call:
            return mine / reps / 1e3, total / reps / 1e3, "profiler"
        log(f"profiler trace recorded {n_mine} launches of {kernel}, "
            f"{reps * per_call} expected; tracing again")
    if (per_call == 1 or scale_missing) and 2 * n_mine >= reps * per_call:
        log(f"{kernel}: the mean of the {n_mine} launches the last trace "
            f"recorded")
        return (mine / n_mine * per_call / 1e3, None,
                f"profiler ({n_mine} of {reps * per_call} launches)")
    return None, (total / reps / 1e3 if total > 0 else None), None


def _placements_agree(torch, got, want, producer_differs: bool, what: str):
    """-> nodes the near ties moved (0 when the placements are equal).
    Unequal placements are allowed only where the producers disagree
    within tolerance (a near tie reorders nodes)."""
    torch.cuda.synchronize()
    check(int(got.sum()) == int(want.sum()),
          f"{what}: placed {int(got.sum())} vs plain {int(want.sum())}")
    moved = int((got != want).sum())
    check(moved == 0 or producer_differs,
          f"{what}: {moved} nodes placed differently from the plain "
          f"version although the producers agree bit for bit")
    return moved


def _kernel_times(torch, dev, inp, small_ask) -> tuple:
    """The kernels' times, taken first, in a process not yet churned by
    the plain versions' large temporaries: K1 on the 50k eval's inputs
    and on the partly used fleet, K2's greedy and score entries, the
    launch floor and the kernels of one fill_greedy_binpack_fused call;
    then the plain versions' times and the bounds. -> (k1, k2, fill)."""
    import gc
    from nomad_tpu_torch.solver import cuda_kernels, kernels
    gc.collect()
    base = (inp["cap"], inp["used"], inp["ask"])
    grid128 = tuple(g for g in kernels.DEPTH_GRID if g <= 128)
    big = 2 ** 30
    # the 50k eval's inputs: the same fleet empty (no usage, no
    # collisions), dense K=128
    empty = (inp["cap"], torch.zeros_like(inp["used"]), inp["ask"],
             inp["feasible"], torch.zeros_like(inp["coll"]), BIG_COUNT,
             inp["aff"])
    part = base + (inp["feasible"], inp["coll"], BIG_COUNT, inp["aff"])
    k512 = (inp["cap"], inp["used"], small_ask) + part[3:]
    greedy = base + (inp["feasible"], False, True, big)

    k1 = _times(torch, "depth_curve_kernel",
                lambda: cuda_kernels.depth_curve(*empty, k_max=128))
    k2 = _times(torch, "score_capacity_kernel",
                lambda: cuda_kernels._launch_score_capacity(*greedy))
    floor = _times(torch, "launch_floor_kernel",
                   lambda: cuda_kernels.launch_floor(dev))
    for key, args, kw in (
            ("grid_ms", part, dict(k_max=128, depth_grid=grid128)),
            ("spread_ms", part, dict(k_max=128, spread_algorithm=True)),
            ("k512_ms", k512, dict(k_max=512))):
        k1[key] = _times(torch, "depth_curve_kernel",
                         lambda a=args, kw=kw: cuda_kernels.depth_curve(
                             *a, **kw))["ms"]
    k2["score_ms"] = _times(torch, "score_capacity_kernel",
                            lambda: cuda_kernels.score_capacity_fused(
                                *base, inp["feasible"]))["ms"]
    fill = _kernel_list(
        torch, lambda: cuda_kernels.fill_greedy_binpack_fused(
            *base, 1, inp["feasible"]))
    fill["call_ms"] = _median_ms(
        torch, lambda: cuda_kernels.fill_greedy_binpack_fused(
            *base, 1, inp["feasible"]), CALL_REPS)
    for r in (k1, k2):
        r["floor_ms"] = floor["ms"]

    k1.update(_plain_times(
        torch, lambda: kernels.depth_curve_ref(*empty, k_max=128)))
    k2.update(_plain_times(torch, lambda: kernels._greedy_key(
        *kernels.score_capacity_ref(*base, inp["feasible"]), big)))
    _, _, c_p = kernels.depth_curve_ref(*empty, k_max=128)
    depths = int(torch.clamp(c_p, max=128).sum())     # depths evaluated
    k1_bytes = N_BUCKET * (2 * 5 * 4 + 1 + 4 + 4 + 3 * 4) + 5 * 4
    k1_ops = depths * DEPTH_OPS_DENSE + N_BUCKET * DEPTH_OPS_NODE
    k1.update(_bound(k1_bytes, k1_ops))
    k1["depths_evaluated"] = depths
    k2_bytes = N_BUCKET * (2 * 5 * 4 + 1 + 4 + 4) + 5 * 4
    k2.update(_bound(k2_bytes, N_BUCKET * SCORE_OPS_NODE))

    log(f"K1 50k-eval inputs: kernel {k1['ms']} ms device "
        f"({k1['call_ms']} ms per wrapper call), plain {k1['plain_ms']} ms "
        f"({k1['plain_device_ms']} ms device), bound {k1['bound_ms']} ms "
        f"({k1['bound_by']}: {k1_bytes} B, {k1_ops} ops, {depths} depths)")
    log(f"K1 on the partly used fleet: grid_k128 {k1['grid_ms']} ms, "
        f"spread_dense_k128 {k1['spread_ms']} ms, dense_k512 "
        f"{k1['k512_ms']} ms device")
    log(f"K2 greedy entry: kernel {k2['ms']} ms device ({k2['call_ms']} ms "
        f"per wrapper call), score entry {k2['score_ms']} ms, plain "
        f"{k2['plain_ms']} ms ({k2['plain_device_ms']} ms device), bound "
        f"{k2['bound_ms']} ms ({k2['bound_by']})")
    log(f"launch floor: empty kernel {floor['ms']} ms device "
        f"({floor['call_ms']} ms per call, timed by {floor['timing']})")
    log("one fill_greedy_binpack_fused call (count 1, 16,384 nodes): "
        + json.dumps(fill))
    return k1, k2, fill


def kernels_phase(np, torch, dev) -> dict:
    from nomad_tpu_torch.solver import cuda_kernels, kernels
    inp = _inputs(np, torch, dev)
    base = (inp["cap"], inp["used"], inp["ask"])
    grid128 = tuple(g for g in kernels.DEPTH_GRID if g <= 128)
    infeasible_block = inp["feasible"].clone()
    infeasible_block[2_000:4_000] = False
    # a small ask: capacities pass 128, so the curve crosses every
    # 128-depth chunk of the kernel up to 512
    small_ask = torch.tensor([50, 64, 300, 0, 0], dtype=torch.float32,
                             device=dev)
    feas, big = inp["feasible"], 2 ** 30
    cases = [
        # name, ask, feasible, max_per_node, k_max, grid, spread, count,
        # jitter_samples
        ("dense_k128", inp["ask"], feas, big, 128, None, False, BIG_COUNT,
         0.0),
        ("grid_k128", inp["ask"], feas, big, 128, grid128, False, MID_COUNT,
         0.4),
        ("max_per_node_1", inp["ask"], feas, 1, 128, None, False, 8_000, 0.0),
        ("infeasible_block", inp["ask"], infeasible_block, big, 128, None,
         False, BIG_COUNT, 0.0),
        ("spread_dense_k128", inp["ask"], feas, big, 128, None, True,
         BIG_COUNT, 0.0),
        ("grid_spread", inp["ask"], feas, big, 128, grid128, True, MID_COUNT,
         0.4),
        ("dense_k512", small_ask, feas, big, 512, None, False, 500_000, 0.0),
    ]
    k1, k2, fill = _kernel_times(torch, dev, inp, small_ask)
    k1.update({"max_abs_err": 0.0, "near_tie_rows": 0, "moved_nodes": 0,
               "cases": []})
    for name, ask, feas, mpn, k_max, grid, spread, count, js in cases:
        args = (inp["cap"], inp["used"], ask, feas, inp["coll"], BIG_COUNT,
                inp["aff"])
        kw = dict(max_per_node=mpn, k_max=k_max, spread_algorithm=spread,
                  depth_grid=grid)
        d_k, k_k, c_k = cuda_kernels.depth_curve(*args, **kw)
        d_p, k_p, c_p = kernels.depth_curve_ref(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(c_k, c_p), f"K1 {name}: k_cap differs")
        if name == "dense_k512":
            check(int(c_p.max()) > 512,
                  f"K1 {name}: capacities stop at {int(c_p.max())}")
        fin = torch.isfinite(d_p)
        check(torch.equal(torch.isfinite(d_k), fin),
              f"K1 {name}: rows with no fitting depth differ")
        err = float((d_k[fin] - d_p[fin]).abs().max()) if fin.any() else 0.0
        check(err <= ATOL, f"K1 {name}: d_star max abs err {err}")
        bad = torch.nonzero((k_k != k_p) & fin).flatten()
        ties = 0
        if len(bad):
            dens, _, _ = kernels.depth_density(*args, **kw)
            top2 = torch.topk(dens[bad], 2, dim=1).values
            gap = (top2[:, 0] - top2[:, 1]).abs()
            check(bool((gap <= NEAR_TIE).all()),
                  f"K1 {name}: k_star differs on {len(bad)} rows, not all "
                  f"near ties (largest top-two gap {float(gap.max())})")
            ties = len(bad)
        tail = (count, inp["jitter"], 1.5, js)
        p_k = kernels._depth_order_take_one(d_k, k_k, c_k, *tail)
        p_p = kernels.fill_depth(inp["cap"], inp["used"], ask, count, feas,
                                 inp["coll"], BIG_COUNT, inp["aff"],
                                 max_per_node=mpn, k_max=k_max,
                                 spread_algorithm=spread,
                                 order_jitter=inp["jitter"],
                                 jitter_scale=1.5, jitter_samples=js,
                                 depth_grid=grid)
        differs = bool(ties) or not torch.equal(d_k[fin], d_p[fin])
        moved = _placements_agree(torch, p_k, p_p, differs, f"K1 {name}")
        check(moved == 0, f"K1 {name}: near ties moved {moved} nodes")
        if mpn == 1:
            check(int(p_k.max()) <= 1, "K1 max_per_node_1: depth > 1")
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        k1["near_tie_rows"] += ties
        k1["moved_nodes"] += moved
        k1["cases"].append(name)
        log(f"K1 {name}: k_cap equal (max {int(c_p.max())}), d_star max abs "
            f"err {err:.3g}, k_star near-tie rows {ties}, placed "
            f"{int(p_k.sum())}, nodes moved by near ties {moved}")

    # K2 at the bucket: capacity exact, score to atol, greedy tail; the
    # greedy entry (the main path's) against the plain fill
    k2.update({"near_tie_rows": 0, "moved_nodes": 0})
    c_k, s_k = cuda_kernels.score_capacity_fused(*base, inp["feasible"])
    c_p, s_p = kernels.score_capacity_ref(*base, inp["feasible"])
    torch.cuda.synchronize()
    check(torch.equal(c_k, c_p), "K2: capacity differs")
    err = float((s_k - s_p).abs().max())
    check(err <= ATOL, f"K2: score max abs err {err}")
    k2["max_abs_err"] = err
    for count, mpn in ((1, big), (5_000, big), (5_000, 1)):
        what = f"K2 count={count} max_per_node={mpn}"
        p_k = kernels._greedy_take(c_k, s_k, count, mpn)
        p_p = kernels.fill_greedy_binpack(*base, count, inp["feasible"],
                                          max_per_node=mpn)
        differs = not torch.equal(s_k, s_p)
        moved = _placements_agree(torch, p_k, p_p, differs, what)
        check(moved == 0, f"{what}: near ties moved {moved} nodes")
        g_k = cuda_kernels.fill_greedy_binpack_fused(
            *base, count, inp["feasible"], max_per_node=mpn)
        moved_g = _placements_agree(torch, g_k, p_p, differs,
                                    f"{what}, greedy entry")
        check(moved_g == 0, f"{what}, greedy entry: moved {moved_g} nodes")
        k2["moved_nodes"] += moved + moved_g
        log(f"{what}: capacity equal, score max abs err {err:.3g}, placed "
            f"{int(p_k.sum())}; score entry + tail and greedy entry place "
            f"like the plain fill (nodes moved {moved}, {moved_g})")
    return {"depth_curve": k1, "score_capacity": k2, "greedy_fill": fill}


def _kernel_list(torch, fn) -> dict:
    """The device kernels one call of `fn` runs (profiler, after a
    warm-up): name -> [launches, device ms], and their total. None for
    both when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:           # no CUPTI
        log(f"profiler unavailable ({e}); no kernel list")
        return {"kernels": None, "device_ms": None}
    kernels: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = kernels.setdefault(e.name[:80], [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.elapsed_us() / 1e3
    if not kernels:
        return {"kernels": None, "device_ms": None}
    return {"kernels": kernels,
            "device_ms": sum(v[1] for v in kernels.values())}


def _queued_ms(torch, fn, reps=REPS) -> float:
    """Device time per call of `fn` with the launches queued back to back
    behind a spin kernel, so the host's pace does not enter (CUDA
    events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _times(torch, kernel: str, run) -> dict:
    """The kernel's device time per launch (the profiler's; queued CUDA
    events where the profiler does not see the kernel), how it was taken
    (`timing`: `_device_ms`'s how, or "queued events") and the wrapper's
    per-call time."""
    ms, _, how = _device_ms(torch, run, kernel)
    out = {"call_ms": _median_ms(torch, run, CALL_REPS), "timing": how}
    if not ms:
        ms, out["timing"] = _queued_ms(torch, run), "queued events"
    out["ms"] = ms
    return out


def _plain_times(torch, plain) -> dict:
    """The plain version's per-call time and device time."""
    return {"plain_ms": _median_ms(torch, plain),
            "plain_device_ms": _device_ms(torch, plain, "")[1]}


def _bound(nbytes: int, ops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _scan_inputs(np, torch, dev):
    """The chunked scan's inputs at the main path's bucket: the seeded
    fleet of _inputs with affinity on a fifth of the nodes, two spread
    stanzas (datacenters dc1..dc3 targeted 50/30/20 under weight 0.7,
    racks r0..r99 even), one distinct_property stanza over the racks with
    quotas of 30..69 (about WEB_COUNT in all), collisions.
    -> (place_chunked's positional args for WEB_COUNT instances,
    d_active)."""
    inp = _inputs(np, torch, dev)
    rng = np.random.default_rng(SEED + 1)
    live = np.arange(N_BUCKET) < N_LIVE
    aff = np.where(live & (rng.random(N_BUCKET) < 0.2),
                   rng.uniform(-1, 1, N_BUCKET), 0.0).astype(np.float32)
    sp_ids = np.where(live, np.stack([np.arange(N_BUCKET) % 3,
                                      np.arange(N_BUCKET) % N_RACKS]), -1)
    sp_counts = np.full((2, 128), -1, np.int32)
    sp_counts[0, :3] = 0
    sp_counts[1, :N_RACKS] = rng.integers(0, 3, N_RACKS)
    sp_desired = np.full((2, 128), -1.0, np.float32)
    sp_desired[0, :3] = [pc / 100 * WEB_COUNT for pc in WEB_TARGETS.values()]
    dp_ids = np.where(live, np.arange(N_BUCKET) % N_RACKS, -1)[None]
    dp_rem = np.zeros((1, 128), np.int32)
    dp_rem[0, :N_RACKS] = rng.integers(30, 70, N_RACKS)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)
    args = (inp["cap"], inp["used"], inp["ask"], WEB_COUNT, inp["feasible"],
            inp["coll"], WEB_COUNT, t(sp_ids, np.int32),
            t(sp_counts, np.int32), t(sp_desired, np.float32),
            t([1, 0], np.int32), t([0.7, 0.3], np.float32),
            t(aff, np.float32), t(dp_ids, np.int32), t(dp_rem, np.int32))
    return args, t(dp_rem[:, 0] >= 0, np.bool_)


def _step_args(args, placed, d_active):
    """chunked_step's positional args from place_chunked's and a
    placement vector."""
    return (args[:3] + (args[4], args[5], placed, 2 ** 30, args[6])
            + args[7:15] + (d_active,))


def _step_bound(args) -> dict:
    """The least time for one step on this run's inputs: a feasible row
    reads cap, used, feasible, collisions, placements, affinity, spread
    and distinct ids and writes its score; an infeasible row (padding
    included) can only score -inf, so it reads its feasible byte and
    writes the score; the [S, P] and [D, P] tables are read once. Float32
    operations on the feasible rows (two 10**x counted as one each)."""
    n = args[0].shape[0]
    n_feas = int(args[4].sum())
    n_s, n_p = args[8].shape
    n_d, n_dp = args[14].shape
    nbytes = (n_feas * (2 * 5 * 4 + 1 + 4 + 4 + 4 + 4 * n_s + 4 * n_d + 4)
              + (n - n_feas) * (1 + 4)
              + n_s * n_p * 8 + n_d * n_dp * 4 + 5 * 4 + n_s * 8 + n_d)
    ops = n_feas * (STEP_OPS_NODE + STEP_OPS_STANZA * n_s + 2 * n_d)
    out = _bound(nbytes, ops)
    out.update(bytes=nbytes, ops=ops)
    return out


def _scan_bound(args, steps: int, selected: int, placed_init=False) -> dict:
    """The least time for one whole-scan solve on this run's inputs.
    Bytes: every row reads its usage and feasible byte (and placed_init
    where given) and writes its usage and placements; a feasible row also
    reads cap, collisions, affinity, spread and distinct ids; the [S, P]
    and [D, P] tables are read and written once, the targets read once.
    Operations: each feasible row's full score once, then each step the
    part that reads the running tables (spread terms, distinct check, the
    mean) for every feasible row, and the full score again for each
    selected row; `steps` is what the kernel ran."""
    n = args[0].shape[0]
    n_feas = int(args[4].sum())
    n_s, n_p = args[8].shape
    n_d, n_dp = args[14].shape
    nbytes = (n * (5 * 4 * 2 + 1 + 4 + (4 if placed_init else 0))
              + n_feas * (5 * 4 + 4 + 4 + 4 * n_s + 4 * n_d)
              + 2 * (n_s * n_p * 4 + n_d * n_dp * 4) + n_s * n_p * 4
              + 5 * 4 + n_s * 8)
    full = STEP_OPS_NODE + STEP_OPS_STANZA * n_s + 2 * n_d
    ops = (n_feas + selected) * full + steps * n_feas * (
        SCAN_OPS_STEP + STEP_OPS_STANZA * n_s + 2 * n_d)
    out = _bound(nbytes, ops)
    out.update(bytes=nbytes, ops=ops)
    return out


def _on_card(np, torch, dev, args) -> tuple:
    return tuple(torch.from_numpy(np.asarray(a)).to(dev)
                 if isinstance(a, np.ndarray) else int(a) for a in args)


def _bit_equal(got, want) -> bool:
    return all(g.dtype == w.dtype and g.shape == w.shape and
               g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes()
               for g, w in zip(got, want))


def chunked_phase(np, torch, dev, floor_ms) -> dict:
    """The chunked scan's two kernels on the card. The step kernel
    against its plain step at the main path's bucket: can_place equal,
    scores bit for bit (the score the scan kernel shares). The scan
    kernel against the plain scan, all four returns bit-equal, one launch
    per solve and no step launch: on the web inputs under binpack and the
    spread algorithm, and on every fixture of nomad_tpu_torch/testing.py
    (chunk 1, nothing feasible, done mid-scan, max_per_node 1, a split
    ask, buckets 8, 1,024 and 65,536, the CPU tests' cases). Times: the
    step kernel's device time per launch, per-call and plain times; the
    scan kernel's device time and wall per solve, the plain scan's wall,
    the steps it ran, one cluster barrier and the dependency floor
    (steps x barrier), the bound."""
    from nomad_tpu_torch.solver import cuda_kernels, kernels
    from nomad_tpu_torch.testing import SCAN_CASES, chunked_case, split_solves
    args, d_active = _scan_inputs(np, torch, dev)
    rng = np.random.default_rng(SEED + 2)
    placed = torch.from_numpy(
        rng.integers(0, 3, N_BUCKET).astype(np.int32)).to(dev)
    step_out = {"max_abs_err": 0.0}
    for spread in (False, True):
        step = _step_args(args, placed, d_active)
        s_k = cuda_kernels.chunked_step(*step, spread_algorithm=spread)
        s_p = kernels.chunked_step_ref(*step, spread_algorithm=spread)
        torch.cuda.synchronize()
        fin = torch.isfinite(s_p)
        check(torch.equal(torch.isfinite(s_k), fin),
              f"chunked_step spread={spread}: can_place differs on "
              f"{int((torch.isfinite(s_k) != fin).sum())} nodes")
        err = float((s_k[fin] - s_p[fin]).abs().max())
        check(s_k.cpu().numpy().tobytes() == s_p.cpu().numpy().tobytes(),
              f"chunked_step spread={spread}: scores not bit-equal "
              f"(max abs err {err})")
        step_out["max_abs_err"] = max(step_out["max_abs_err"], err)
        log(f"chunked_step spread_algorithm={spread}: can_place equal on "
            f"{int(fin.sum())} of {N_BUCKET} nodes, scores bit-equal")
    step = _step_args(args, placed, d_active)
    step_out.update(_times(torch, "chunked_step_kernel",
                           lambda: cuda_kernels.chunked_step(*step)))
    step_out.update(_plain_times(
        torch, lambda: kernels.chunked_step_ref(*step)))
    step_out["floor_ms"] = floor_ms
    step_out.update(_step_bound(args))
    log(f"chunked_step: kernel {step_out['ms']} ms device per launch "
        f"({step_out['call_ms']} ms per wrapper call), plain step "
        f"{step_out['plain_ms']} ms ({step_out['plain_device_ms']} ms "
        f"device), bound {step_out['bound_ms']} ms "
        f"({step_out['bound_by']}: {step_out['bytes']} B, "
        f"{step_out['ops']} ops), floor {floor_ms} ms")

    out = {"max_abs_err": 0.0, "cases": {}}
    for spread in (False, True):
        before = dict(cuda_kernels.LAUNCHES)
        got = cuda_kernels.chunked_scan(*args, spread_algorithm=spread)
        torch.cuda.synchronize()
        n_scan = cuda_kernels.LAUNCHES["chunked_scan"] - before["chunked_scan"]
        n_step = cuda_kernels.LAUNCHES["chunked_step"] - before["chunked_step"]
        check(n_scan == 1 and n_step == 0,
              f"chunked_scan spread={spread}: {n_scan} scan and {n_step} "
              f"step launches for one solve")
        want = kernels.place_chunked(*args, spread_algorithm=spread)
        err = float((got[1] - want[1]).abs().max())
        for name, g, w in zip(("placed", "used", "spread_counts",
                               "distinct_remaining"), got, want):
            check(_bit_equal([g], [w]), f"chunked_scan spread={spread}: "
                  f"{name} differs from the plain scan's (usage max abs "
                  f"err {err})")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        key = "web_spread" if spread else "web"
        out["cases"][key] = {"placed": int(got[0].sum()),
                             "steps": int(got[4])}
        log(f"chunked_scan web spread_algorithm={spread} ({WEB_COUNT} "
            f"asked, placed {int(got[0].sum())}, {int(got[4])} steps): "
            f"one launch, bit-equal to the plain scan (placements, usage, "
            f"counts, quotas)")
    for name in SCAN_CASES:
        a, kw = chunked_case(name)
        a = _on_card(np, torch, dev, a)
        solves = []

        def scan(*x, **k):
            solves.append(1)
            return cuda_kernels.place_chunked(*x, **k)
        before = dict(cuda_kernels.LAUNCHES)
        got = split_solves(scan, a, kw)
        torch.cuda.synchronize()
        n_scan = cuda_kernels.LAUNCHES["chunked_scan"] - before["chunked_scan"]
        n_step = cuda_kernels.LAUNCHES["chunked_step"] - before["chunked_step"]
        want = split_solves(kernels.place_chunked, a, kw)
        check(_bit_equal(got, want),
              f"chunked_scan case {name}: differs from the plain scan")
        check(n_scan == len(solves) and n_step == 0,
              f"chunked_scan case {name}: {n_scan} scan launches for "
              f"{len(solves)} solves, {n_step} step launches")
        out["cases"][name] = {"n": int(a[0].shape[0]), "solves": len(solves),
                              "placed": int(got[0].sum()),
                              "count": int(a[3])}
    check(out["cases"]["split"]["solves"] > 1, "the split case ran 1 solve")
    log(f"chunked_scan: {len(SCAN_CASES)} fixtures bit-equal to the plain "
        f"scan, one launch per solve: " + json.dumps(out["cases"]))

    run = (lambda: cuda_kernels.place_chunked(*args))
    got = cuda_kernels.chunked_scan(*args)
    steps, selected = int(got[4]), int(got[0].sum())
    ms, all_ms, how = _device_ms(torch, run, "chunked_scan_kernel", reps=10)
    out.update(ms=ms, solve_device_ms=all_ms, steps=steps, timing=how,
               call_ms=_median_ms(torch, run, CALL_REPS),
               plain_ms=_median_ms(torch, lambda: kernels.place_chunked(
                   *args), SOLVE_REPS),
               floor_ms=floor_ms)
    if not ms:
        out["ms"] = _queued_ms(torch, run, 10)
        out["timing"] = "queued events"
    solve = _kernel_list(torch, run)
    out["solve_kernels"] = solve["kernels"]
    out["barrier_ms"] = _queued_ms(
        torch, lambda: cuda_kernels.cluster_barrier(BARRIER_STEPS, dev),
        5) / BARRIER_STEPS
    out["dependency_floor_ms"] = steps * out["barrier_ms"]
    out.update(_scan_bound(args, steps, selected))
    log(f"chunked_scan: {out['ms']} ms device per solve ({steps} steps, "
        f"{out['ms'] * 1e3 / steps} us a step), {out['call_ms']} ms per "
        f"call, plain scan {out['plain_ms']} ms per call; one cluster "
        f"barrier {out['barrier_ms'] * 1e3} us, dependency floor "
        f"{out['dependency_floor_ms']} ms; bound {out['bound_ms']} ms "
        f"({out['bound_by']}: {out['bytes']} B, {out['ops']} ops); launch "
        f"floor {floor_ms} ms")
    log("one place_chunked solve's device kernels: "
        + json.dumps(out["solve_kernels"]))
    return {"chunked_step": step_out, "chunked_scan": out}


class _ServiceRecorder:
    """For the service path's measurements: records the arguments of each
    scan solve (cuda_kernels.place_chunked, as backend.select hands it
    out) with the scan-kernel launches it made, and the inputs and wall of each
    preemption mask pass (SolverPlacer._preempt_masks). Restores both on
    exit. Behaviour is unchanged."""

    def __init__(self):
        self.scans, self.preempts = [], []

    def __enter__(self):
        from nomad_tpu_torch.solver import backend, cuda_kernels, placer
        self._scan = cuda_kernels.place_chunked
        self._masks = placer.SolverPlacer.__dict__["_preempt_masks"]
        scan, masks = self._scan, self._masks.__func__

        def place_chunked(*a, **kw):
            before = cuda_kernels.LAUNCHES["chunked_scan"]
            out = scan(*a, **kw)
            self.scans.append((a, kw, cuda_kernels.LAUNCHES["chunked_scan"]
                               - before))
            return out

        def preempt_masks(*a):
            t0 = time.perf_counter()
            out = masks(*a)
            self.preempts.append((a, time.perf_counter() - t0))
            return out
        cuda_kernels.place_chunked = place_chunked
        placer.SolverPlacer._preempt_masks = staticmethod(preempt_masks)
        backend.reset()             # selections made from here see them
        return self

    def __exit__(self, *exc):
        from nomad_tpu_torch.solver import backend, cuda_kernels, placer
        cuda_kernels.place_chunked = self._scan
        placer.SolverPlacer._preempt_masks = self._masks
        backend.reset()


def service_phase(np, torch) -> dict:
    """The slice at full width: 10,000 bench-fleet nodes in three
    datacenters and 100 racks, service preemption on, the applier thread
    running; through new_scheduler: (a) the web job's spread blocks and
    (b) the rack-capped job (the chunked scan, one launch of the scan
    kernel a solve), both
    at the service tier's priority 80, then (c) a priority-20 batch job
    filling every node and a priority-80 service job that fits only by
    preemption, with the filler's allocations the only ones below it. The launch counts are
    zeroed just before (a) and read just after (c)."""
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.solver import cuda_kernels, kernels
    from nomad_tpu_torch.testing import fill_count
    t0 = time.perf_counter()
    fsm, planner = _cluster(
        N_LIVE, seed=44, racks=N_RACKS,
        preemption_config=structs.PreemptionConfig(
            service_scheduler_enabled=True))
    log(f"service: seeded {N_LIVE} nodes in {time.perf_counter() - t0:.3f} s")
    s = fsm.state
    dc = {n.id: n.datacenter for n in s.iter_nodes()}
    rack = {n.id: n.meta["rack"] for n in s.iter_nodes()}
    out = {"evals": {}}
    with _applier(planner), _ServiceRecorder() as rec:
        cuda_kernels.reset_launches()           # the service path's window
        web = _drive(torch, fsm, planner, _mk_service_job(
            mock, structs, "web", WEB_COUNT, 250, 512, "web",
            priority=SERVICE_PRIORITY))
        capped = _drive(torch, fsm, planner, _mk_service_job(
            mock, structs, "rack-capped", RACK_CAPPED_COUNT, 250, 512,
            "rack-capped", priority=SERVICE_PRIORITY))
        fill = fill_count(s.usage.view(), *FILL_ASK)
        filler = _drive(torch, fsm, planner, _mk_batch_job(
            mock, "filler", fill, *FILL_ASK, priority=20))
        evicted0 = {a.id for a in s.iter_allocs()
                    if a.desired_status == "evict"}
        pre = _drive(torch, fsm, planner, _mk_service_job(
            mock, structs, "preemptor", PREEMPT_COUNT, *FILL_ASK,
            priority=SERVICE_PRIORITY))
        launches = dict(cuda_kernels.LAUNCHES)  # read just after
    check(launches["chunked_scan"] == len(rec.scans) >= 2,
          f"service path: {launches['chunked_scan']} scan-kernel launches "
          f"for {len(rec.scans)} scan solves")
    check(launches["chunked_step"] == 0,
          f"service path: {launches['chunked_step']} step-kernel launches")
    for name, r in (("web", web), ("rack-capped", capped),
                    ("filler", filler), ("preemptor", pre)):
        c = r["counters"]
        check(c["torch_depth"] == c["torch_greedy"] ==
              c["torch_chunked"] == 0,
              f"service {name}: the plain torch tier served a solve")
        out["evals"][name] = r
    for name, r in (("web", web), ("rack-capped", capped)):
        check(r["counters"]["host_fallback"] == 0,
              f"service {name}: {r['counters']['host_fallback']} "
              f"placements fell back to the host stack")
        check(r["launches"]["chunked_scan"] > 0 and
              r["counters"]["scan_solves"] >= 1,
              f"service {name}: the scan did not run on the scan kernel")
    # (a) the spread blocks
    by_dc = {d: 0 for d in WEB_TARGETS}
    by_rack: dict = {}
    for a in s.allocs_by_job("default", "web"):
        by_dc[dc[a.node_id]] += 1
        by_rack[rack[a.node_id]] = by_rack.get(rack[a.node_id], 0) + 1
    targets = {d: pc / 100 * WEB_COUNT for d, pc in WEB_TARGETS.items()}
    miss = {d: by_dc[d] - targets[d] for d in by_dc}
    check(all(abs(m) <= WEB_DC_TOL * WEB_COUNT for m in miss.values()),
          f"web: datacenters {by_dc} against targets {targets}")
    spread = max(by_rack.values()) - min(by_rack.values())
    check(len(by_rack) == N_RACKS and
          spread <= WEB_RACK_SPREAD * WEB_COUNT / N_RACKS,
          f"web: {len(by_rack)} racks, {min(by_rack.values())}.."
          f"{max(by_rack.values())} per rack")
    out["web"] = {"by_dc": by_dc, "targets": targets, "miss": miss,
                  "rack_min": min(by_rack.values()),
                  "rack_max": max(by_rack.values())}
    # (b) the rack cap
    per_rack: dict = {}
    for a in s.allocs_by_job("default", "rack-capped"):
        per_rack[rack[a.node_id]] = per_rack.get(rack[a.node_id], 0) + 1
    check(max(per_rack.values()) <= RACK_CAP,
          f"rack-capped: {max(per_rack.values())} on one rack")
    # (c) preemption
    preempted = [a for a in s.iter_allocs()
                 if a.desired_status == "evict" and a.id not in evicted0]
    victims_of = {a.job_id for a in preempted}
    check(len(preempted) == PREEMPT_COUNT and victims_of == {"filler"},
          f"preemptor: preempted {len(preempted)} allocs of {victims_of}")
    check(len(rec.preempts) == 1, f"{len(rec.preempts)} preemption passes")
    out.update(launches=launches, fill_count=fill,
               preempted=len(preempted))
    log(f"service: web {by_dc} against targets {targets} (miss {miss}), "
        f"racks {out['web']['rack_min']}..{out['web']['rack_max']}; "
        f"rack-capped at most {max(per_rack.values())} per rack; filler "
        f"{fill} allocs; preemptor displaced {len(preempted)} filler "
        f"allocs; launches {json.dumps(launches)}")
    for name, r in out["evals"].items():
        log(f"service {name}: {r['committed']}/{r['count']} committed in "
            f"{r['wall_s']} s; layers {json.dumps(r['layers_s'])}; "
            f"counters {json.dumps(r['counters'])}; launches "
            f"{json.dumps(r['launches'])}")
    # the recorded scan solves replayed: device time, and the plain scan
    # on the same inputs
    out["scans"] = []
    for (a, kw, n_launch), name in zip(rec.scans, ("web", "rack-capped")):
        got = cuda_kernels.chunked_scan(*a, **kw)
        want = kernels.place_chunked(*a, **kw)
        check(_bit_equal(got[:4], want), f"service {name}: the kernel's "
              f"scan differs from the plain scan on its own inputs")
        def solve():
            return cuda_kernels.place_chunked(*a, **kw)
        r = {"eval": name, "launches": n_launch, "steps": int(got[4]),
             "device_ms": _device_ms(torch, solve, "", reps=5)[1],
             "wall_ms": _median_ms(torch, solve, 3),
             "plain_wall_ms": _median_ms(
                 torch, lambda: kernels.place_chunked(*a, **kw), 3)}
        if not r["device_ms"]:
            r["device_ms"] = _queued_ms(torch, solve, 5)
        out["scans"].append(r)
        log(f"service {name} scan solve: {n_launch} scan launch(es), "
            f"{r['steps']} steps, {r['device_ms']} ms device, "
            f"{r['wall_ms']} ms wall, plain scan {r['plain_wall_ms']} ms "
            f"(replayed on its inputs; bit-equal to the plain scan)")
    (v_res, v_prio, ask, free, job_prio), wall = rec.preempts[0]
    on_card = [torch.from_numpy(np.asarray(x)).to(DEVICE)
               for x in (v_res, v_prio, ask, free)]
    masks_card = kernels.preempt_top_k(*on_card, job_prio).cpu()
    masks_cpu = kernels.preempt_top_k(
        *[torch.from_numpy(np.asarray(x)) for x in (v_res, v_prio, ask,
                                                     free)], job_prio)
    check(torch.equal(masks_card, masks_cpu),
          "preemption masks differ between the card and the CPU")
    pk = _kernel_list(torch, lambda: kernels.preempt_top_k(*on_card,
                                                           job_prio))
    out["preempt"] = {"C": int(v_res.shape[0]), "V": int(v_res.shape[1]),
                      "mask_wall_s": wall, "device_ms": pk["device_ms"],
                      "pass_s": pre["layers_s"]["solver.preempt"]}
    log(f"preemption pass: [C, V] = [{v_res.shape[0]}, {v_res.shape[1]}], "
        f"whole pass {out['preempt']['pass_s']} s wall, mask solve "
        f"{wall} s wall (to host), {pk['device_ms']} ms device; masks "
        f"equal on the card and the CPU")
    return out


# ------------------------------------------------------------ phase 4

def _mk_node(mock, i, rng, pin="", racks=0):
    """bench.py's heterogeneous fleet node (`testing.bench_node`, which
    the agent phase's node simulator registers too)."""
    from nomad_tpu_torch.testing import bench_node
    return bench_node(mock, i, rng, pin, racks)


def _mk_batch_job(mock, job_id, count, cpu=250, mem=512, disk=300,
                  priority=50):
    job = mock.batch_job()
    job.id = job.name = job_id
    job.priority = priority
    job.datacenters = ["dc1", "dc2", "dc3"]
    tg = job.task_groups[0]
    tg.count = count
    tg.ephemeral_disk.size_mb = disk
    task = tg.tasks[0]
    task.resources.cpu = cpu
    task.resources.memory_mb = mem
    task.resources.networks = []
    tg.networks = []
    return job


def _mk_service_job(mock, structs, job_id, count, cpu, mem, shape="",
                    priority=50):
    """A service job of the service layout: `shape` "web" adds the spread
    blocks of the Nomad documentation's examples (datacenters targeted
    50/30/20 under weight 70, racks even under weight 30), "rack-capped"
    a distinct_property ${meta.rack} constraint at 2 per rack."""
    job = mock.job()
    job.id = job.name = job_id
    job.priority = priority
    job.datacenters = ["dc1", "dc2", "dc3"]
    tg = job.task_groups[0]
    tg.count = count
    tg.ephemeral_disk.size_mb = 300
    tg.networks = []
    task = tg.tasks[0]
    task.resources.cpu = cpu
    task.resources.memory_mb = mem
    task.resources.networks = []
    if shape == "web":
        job.spreads = [
            structs.Spread(attribute="${node.datacenter}", weight=70,
                           spread_target=[
                               structs.SpreadTarget(value=dc, percent=pc)
                               for dc, pc in WEB_TARGETS.items()]),
            structs.Spread(attribute="${meta.rack}", weight=30)]
    elif shape == "rack-capped":
        tg.constraints = [structs.Constraint(
            ltarget="${meta.rack}", rtarget=str(RACK_CAP),
            operand=structs.OP_DISTINCT_PROPERTY)]
    return job


class _Shim:
    """The planner interface a server worker provides, over the real
    serial applier (bench.py's _WorkerShim): while the Planner's applier
    thread runs, plans go through its queue — a pipelined eval's chunk
    plans without waiting (submit_plan_async) — else they apply inline."""

    def __init__(self, planner, state):
        self.planner = planner
        self.state = state

    def _queue_alive(self) -> bool:
        t = getattr(self.planner, "_thread", None)
        return t is not None and t.is_alive()

    def submit_plan(self, plan):
        if self._queue_alive():
            return self.planner.submit_plan(plan, timeout=120.0)
        return self.planner.apply_plan(plan)

    def submit_plan_async(self, plan):
        if self._queue_alive():
            return self.planner.submit_plan_async(plan)
        from nomad_tpu_torch.server.plan_apply import _PendingPlan
        pending = _PendingPlan(plan)
        try:
            pending.respond(self.planner.apply_plan(plan), None)
        except Exception as e:          # noqa: BLE001 — report to caller
            pending.respond(None, str(e))
        return pending

    def update_eval(self, ev):
        self.state.upsert_evals(self.state.latest_index() + 1, [ev])

    def create_eval(self, ev):
        self.state.upsert_evals(self.state.latest_index() + 1, [ev])

    def refresh_snapshot(self, old):
        return self.state.snapshot()


def _cluster(n_nodes, seed, pin="", racks=0, **config):
    import numpy as np
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import NomadFSM, Planner
    from nomad_tpu_torch.server.fsm import RaftLog
    from nomad_tpu_torch.structs import SchedulerConfiguration
    rng = np.random.default_rng(seed)
    fsm = NomadFSM()
    s = fsm.state
    s.set_scheduler_config(
        1, SchedulerConfiguration(scheduler_algorithm="tpu-batch", **config))
    for i in range(n_nodes):
        s.upsert_node(i + 2, _mk_node(mock, i, rng, pin, racks))
    return fsm, Planner(RaftLog(fsm), s)


@contextlib.contextmanager
def _applier(planner):
    """The Planner's applier thread, running for the block's length."""
    planner.start()
    try:
        yield
    finally:
        planner.stop()


def _run_eval(fsm, planner, job, eval_id):
    from nomad_tpu_torch.scheduler import new_scheduler
    from nomad_tpu_torch.structs import Evaluation
    s = fsm.state
    s.upsert_job(s.latest_index() + 1, job)
    ev = Evaluation(id=eval_id, namespace="default", job_id=job.id,
                    type=job.type, priority=job.priority)
    s.upsert_evals(s.latest_index() + 1, [ev])
    sched = new_scheduler(job.type, s.snapshot(), _Shim(planner, s))
    sched.process(ev)
    return s.eval_by_id(ev.id)


def _drive(torch, fsm, planner, job, eval_id=None, healthy=True) -> dict:
    """One eval of `job` through the port's scheduler and applier, checked
    (every instance committed, the eval complete, no usage row over
    capacity; when `healthy`, no dispatch error, breaker opening or
    explain error) and measured: wall, layer
    seconds, the pipeline's host seconds, and counter and kernel-launch
    deltas."""
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import cuda_kernels
    s = fsm.state
    job_id, count = job.id, job.task_groups[0].count
    launches0 = dict(cuda_kernels.LAUNCHES)
    counters0 = {k: metrics.counter(v) for k, v in COUNTERS.items()}
    timers0 = {k: metrics.timer_sum(k) for k in LAYERS + PIPE_TIMERS}
    t0 = time.perf_counter()
    ev = _run_eval(fsm, planner, job, eval_id or f"chip-smoke-{job_id}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    placed = len(s.allocs_by_job("default", job_id))
    check(placed == count, f"{job_id}: committed {placed}/{count}")
    check(ev is not None and ev.status == "complete",
          f"{job_id}: eval status {getattr(ev, 'status', None)}")
    view = s.usage.view()
    over = int((view.used > view.cap + 1e-3).any(axis=1).sum())
    check(over == 0, f"{job_id}: {over} usage rows over capacity")
    timers = {k.split(".", 1)[1]: metrics.timer_sum(k) - v
              for k, v in timers0.items()}
    counters = {k: metrics.counter(COUNTERS[k]) - v
                for k, v in counters0.items()}
    if healthy:
        bad = {k: counters[k] for k in CARD_ZERO if counters[k]}
        check(not bad, f"{job_id}: a healthy eval counted {bad}")
    return {"count": count, "committed": placed, "wall_s": wall,
            "layers_s": {k.split(".", 1)[1]: timers[k.split(".", 1)[1]]
                         for k in LAYERS},
            "pipeline_s": {k.split(".", 1)[1]: timers[k.split(".", 1)[1]]
                           for k in PIPE_TIMERS},
            "counters": counters,
            "launches": {k: cuda_kernels.LAUNCHES[k] - v
                         for k, v in launches0.items()}}


def _explain_record(eval_id: str) -> dict:
    """The newest explain record of `eval_id` (the ring's as_dict)."""
    from nomad_tpu_torch.solver import explain
    recs = [r for r in explain.recent(256) if r["eval_id"] == eval_id]
    check(len(recs) >= 1, f"no explain record for eval {eval_id}")
    return recs[0]


def main_path_phase(torch) -> dict:
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import cuda_kernels, state_cache
    t0 = time.perf_counter()
    fsm, planner = _cluster(N_LIVE, seed=42)
    log(f"main: seeded {N_LIVE} nodes in "
        f"{time.perf_counter() - t0:.3f} s")
    s = fsm.state
    state_cache.reset()                       # hits counted from here
    # at the defaults the 50k eval pipelines on the classic route (its
    # chunks ride the twins' rows, gathered once), and the 2k and count-1
    # evals take the whole-eval fused route: one launch of a gather entry
    # and one of the fit verdict, no twin gather
    evals = [("big", BIG_COUNT, "depth_curve"),
             ("mid", MID_COUNT, "depth_curve_gather"),
             ("one", 1, "score_capacity_gather")]
    # the host's waits for the card's answer: one sample a host sync
    syncs = "nomad.solver.device"
    out = {"evals": {}}
    cuda_kernels.reset_launches()                 # the main path's window
    with _applier(planner):
        for job_id, count, kname in evals:
            s0 = metrics.sample_count(syncs)
            r = _drive(torch, fsm, planner,
                       _mk_batch_job(mock, job_id, count))
            c = r["counters"]
            pipelined = job_id == "big"
            check(c["evals"] == int(pipelined) and
                  c["chunks"] == (BIG_CHUNKS if pipelined else 0),
                  f"{job_id}: pipeline counters {c}")
            rose = r["launches"][kname]
            check(rose == (BIG_CHUNKS if pipelined else 1),
                  f"{job_id}: {kname} launched {rose} times")
            check(c["twin_dispatches"] == int(pipelined) and
                  c["fused"] == int(not pipelined) and
                  r["launches"]["fit_verdict"] == int(not pipelined),
                  f"{job_id}: {c['twin_dispatches']} dispatches rode the "
                  f"state cache's twins, {c['fused']} fused dispatches, "
                  f"{r['launches']['fit_verdict']} verdict launches")
            r["host_syncs"] = metrics.sample_count(syncs) - s0
            check(r["host_syncs"] == (BIG_CHUNKS if pipelined else 1),
                  f"{job_id}: {r['host_syncs']} host syncs")
            check(c["torch_depth"] == c["torch_greedy"] == 0,
                  f"{job_id}: the plain torch tier served a solve on the "
                  f"card")
            stats = state_cache.cache().stats()
            check(stats["twins_device"] == DEVICE,
                  f"{job_id}: twins on {stats['twins_device']}")
            r["cache"] = stats
            # explain at its default (on): one record, every instance
            # placed and every live node feasible
            rec = _explain_record(f"chip-smoke-{job_id}")
            check(c["explain_records"] == 1 and
                  rec["placed_total"] == count and
                  rec["n_feasible"] == N_LIVE and not rec["rejected"],
                  f"{job_id}: explain record {json.dumps(rec)[:400]}")
            r["explain"] = {k: rec[k] for k in (
                "tier", "kernel", "n_feasible", "nodes_exhausted",
                "nodes_fit", "placed_nodes", "placed_total")}
            r["explain"]["score_meta_rows"] = len(rec["score_meta"])
            out["evals"][job_id] = r
            log(f"explain {job_id}: record {json.dumps(r['explain'])}; "
                f"nomad.solver.explain.seconds "
                f"{r['layers_s']['solver.explain.seconds']} s, "
                f"nomad.solver.explain.errors {c['explain_errors']}")
            log(f"main {job_id}: {r['committed']}/{count} committed in "
                f"{r['wall_s']} s ({kname} launches +{rose}, pipelined "
                f"{pipelined}, fused dispatches {c['fused']}, host syncs "
                f"{r['host_syncs']}, overcommitted rows 0); layers "
                f"{json.dumps(r['layers_s'])}; pipeline "
                f"{json.dumps(r['pipeline_s'])}; cache {json.dumps(stats)}")
    out["launches"] = dict(cuda_kernels.LAUNCHES)  # read just after
    for name in MAIN_KERNELS:
        check(out["launches"][name] >= 1,
              f"kernel {name} was not launched on the main path")
    cache = state_cache.cache()
    stats = cache.stats()
    check(stats["hits"] >= 1, f"no state cache hit in 3 evals: {stats}")
    # every commit fed the cache on the applier thread: the twins hold
    # exactly the committed usage
    view = s.usage.view()
    check(stats["version"] == view.version,
          f"cache at version {stats['version']}, store at {view.version}")
    cap_dev, used_dev = cache.twins()
    n = view.cap.shape[0]
    check(used_dev[:n].cpu().numpy().tobytes() == view.used.tobytes() and
          cap_dev[:n].cpu().numpy().tobytes() == view.cap.tobytes(),
          "the twins differ from the committed usage")
    out["cache"] = stats
    log(f"main: state cache {json.dumps(stats)}; twins equal the "
        f"committed usage")
    return out


SYNC_SCOPE = ("solver/placer.py", "solver/microbatch.py")   # SYNC001's
ANALYSIS_TIMEOUT_S = 300.0


class _SyncRecorder:
    """Counts the host syncs of the card while it is installed, from
    every thread: each synchronizing CUDA call torch's sync debug mode
    reports (a replaced warnings.showwarning, the module-level hook every
    thread's warnings reach, under an "always" filter for the sync
    warning), and each explicit wait the mode does not report
    (torch.cuda.synchronize, Stream.synchronize, Event.synchronize,
    wrapped). close() restores all of it. A sync is keyed by its
    innermost nomad_tpu_torch/ frame ("path:line"; with none, the
    innermost frame's file, line, function and thread), and by the
    innermost frame in SYNC001's scope that led to it, if any."""

    MESSAGE = r".*synchroniz.*"

    def __init__(self, torch):
        import collections
        import threading
        import warnings
        self._torch = torch
        self._warnings = warnings
        self._lock = threading.Lock()
        self.sites = collections.Counter()
        self.callers = collections.Counter()
        self._pkg = str(ROOT / "nomad_tpu_torch") + os.sep
        self._show = warnings.showwarning
        self._filters = list(warnings.filters)
        warnings.filterwarnings("always", message=self.MESSAGE)
        warnings.showwarning = self._hook
        self._waits = [(torch.cuda, "synchronize"),
                       (torch.cuda.Stream, "synchronize"),
                       (torch.cuda.Event, "synchronize")]
        self._saved = [getattr(o, n) for o, n in self._waits]
        for (owner, name), fn in zip(self._waits, self._saved):
            setattr(owner, name, self._counted(fn))

    def _counted(self, fn):
        def wait(*a, **k):
            self._record(sys._getframe(1))
            return fn(*a, **k)
        return wait

    def _hook(self, message, category, filename, lineno, file=None,
              line=None):
        if "synchroniz" not in str(message):
            return self._show(message, category, filename, lineno, file,
                              line)
        self._record(sys._getframe(1))

    def _record(self, f) -> None:
        import threading
        site, caller, first = None, None, None
        while f is not None:
            path = f.f_code.co_filename
            if path.startswith(self._pkg):
                rel = path[len(self._pkg):].replace(os.sep, "/")
                here = f"{rel}:{f.f_lineno}"
                site = site or here
                if caller is None and rel in SYNC_SCOPE:
                    caller = here
            elif first is None and "warnings" not in os.path.basename(path):
                tail = os.sep.join(path.split(os.sep)[-2:])
                first = f"{tail}:{f.f_lineno} ({f.f_code.co_name}, " \
                    f"thread {threading.current_thread().name})"
            f = f.f_back
        site = site or first or "?"
        with self._lock:
            self.sites[site] += 1
            if caller is not None and caller != site:
                self.callers[caller] += 1

    def take(self) -> tuple:
        """(sites, callers) counted since the last take, then reset."""
        with self._lock:
            out = (dict(self.sites), dict(self.callers))
            self.sites.clear()
            self.callers.clear()
        return out

    def close(self) -> None:
        for (owner, name), fn in zip(self._waits, self._saved):
            setattr(owner, name, fn)
        self._warnings.showwarning = self._show
        self._warnings.filters[:] = self._filters
        self._warnings._filters_mutated()


def _unmarked_syncs(sites: dict) -> dict:
    """The sites among `sites` in SYNC001's scope ("path:line") whose line
    carries no SYNC001 seam marker (the analyzer's own reading of the
    marker, as its rule applies it)."""
    from nomad_tpu_torch.analysis.core import SourceModule
    mods, bad = {}, {}
    for site, n in sites.items():
        rel, _, line = site.rpartition(":")
        if rel not in SYNC_SCOPE:
            continue
        if rel not in mods:
            path = ROOT / "nomad_tpu_torch" / rel
            mods[rel] = SourceModule(str(path), path.read_text())
        if not mods[rel].suppressed("SYNC001", int(line)):
            bad[site] = n
    return bad


def analysis_phase(torch) -> dict:
    """The port's analyzer gate over this checkout, and the card's own
    account of every host sync of the 50k eval (serial and pipelined)
    and of a fused 2k eval, held against SYNC001's seam markers."""
    from nomad_tpu_torch import mock
    t_phase = time.perf_counter()
    gate = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch.analysis", "--json",
         "nomad_tpu_torch"], cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    out = {"evals": {}}
    try:
        runs = (("serial", False, (("big", BIG_COUNT), ("mid", MID_COUNT))),
                ("pipelined", True, (("big", BIG_COUNT),)))
        for mode, pipelined, jobs in runs:
            fsm, planner = _cluster(N_LIVE, seed=42,
                                    plan_pipeline_enabled=pipelined)
            with _applier(planner):
                for job_id, count in jobs:
                    job = _mk_batch_job(mock, f"sync-{mode}-{job_id}",
                                        count)
                    torch.cuda.synchronize()
                    # the recorder spans the eval alone: switching the mode
                    # can itself sync once in a process
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        rec = _SyncRecorder(torch)
                        t0 = time.perf_counter()
                        try:
                            r = _run_eval(fsm, planner, job,
                                          f"sync-{mode}-{job_id}")
                        finally:
                            rec.close()
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                    sites, callers = rec.take()
                    placed = len(fsm.state.allocs_by_job("default",
                                                         job.id))
                    check(placed == count and r.status == "complete",
                          f"sync audit {mode} {job_id}: {placed}/{count} "
                          f"committed, eval {r.status}")
                    name = f"{mode} {job_id}"
                    inside = {k: v for k, v in sites.items()
                              if k.rpartition(":")[0] in SYNC_SCOPE}
                    outside = {k: v for k, v in sites.items()
                               if k not in inside}
                    out["evals"][name] = {
                        "count": count, "syncs": sum(sites.values()),
                        "wall_s": time.perf_counter() - t0,
                        "in_scope": inside, "outside_scope": outside,
                        "reached_from_scope": callers,
                        "unmarked": _unmarked_syncs({**sites, **callers})}
                    e = out["evals"][name]
                    log(f"analysis syncs {name} ({count} tasks, "
                        f"{e['wall_s']} s under the audit): "
                        f"{e['syncs']} syncs; in SYNC001's scope "
                        f"{json.dumps(inside)}; outside it "
                        f"{json.dumps(outside)}, reached from the scope "
                        f"at {json.dumps(callers)}")
    finally:
        try:
            stdout, stderr = gate.communicate(timeout=ANALYSIS_TIMEOUT_S)
        finally:
            if gate.poll() is None:
                gate.kill()
                gate.wait()
    findings = json.loads(stdout or "[]")
    out["gate"] = {"rc": gate.returncode, "findings": len(findings),
                   "parse_errors": stderr.strip().splitlines()}
    log(f"analysis gate: python -m nomad_tpu_torch.analysis "
        f"nomad_tpu_torch exited {gate.returncode}, {len(findings)} "
        f"active findings, parse errors {out['gate']['parse_errors']}")
    for f in findings[:20]:
        log(f"  {f['path']}:{f['line']}: {f['rule']} {f['message'][:160]}")
    check(gate.returncode == 0 and not findings and not stderr.strip(),
          "the analyzer gate failed over the shipped tree")
    unmarked = {k: v for e in out["evals"].values()
                for k, v in e["unmarked"].items()}
    check(not unmarked, f"syncs in (or reached from) SYNC001's scope on "
          f"lines without a seam marker: {unmarked}")
    check(all(e["syncs"] >= 1 for e in out["evals"].values()),
          "an eval recorded no sync: the audit saw nothing")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"analysis phase: {out['seconds']:.1f} s; every sync in "
        f"SYNC001's scope on a marked seam")
    return out


def compare_phase(torch) -> dict:
    """The 50k eval serial and pipelined, explain on and off, on fresh
    clusters in turns (COMPARE_ORDER)."""
    import gc
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.solver import cuda_kernels
    runs = []
    for i, (mode, ex) in enumerate(COMPARE_ORDER):
        pipelined = mode == "pipelined"
        fsm, planner = _cluster(N_LIVE, seed=42,
                                plan_pipeline_enabled=pipelined,
                                placement_explain_enabled=ex)
        gc.collect()                    # no earlier run's garbage in this one
        cuda_kernels.reset_launches()             # this run's window
        with _applier(planner):
            r = _drive(torch, fsm, planner,
                       _mk_batch_job(mock, f"cmp-{i}-{mode}", BIG_COUNT))
        launches = dict(cuda_kernels.LAUNCHES)     # read just after
        # serial, the eval takes the whole-eval fused route (the default):
        # one launch of K1's gather entry; pipelined, a classic launch a
        # chunk
        want = {"depth_curve": BIG_CHUNKS if pipelined else 0,
                "depth_curve_gather": 0 if pipelined else 1}
        got = {k: launches[k] for k in want}
        check(got == want, f"compare {mode}: launches {got}, expected "
              f"{want}")
        c = r["counters"]
        check(c["evals"] == int(pipelined),
              f"compare {mode}: pipeline counters {c}")
        check(c["explain_records"] == int(ex),
              f"compare {mode} explain {ex}: {c['explain_records']} "
              f"records")
        r.update(mode=mode, explain=ex, launches=launches)
        runs.append(r)
        log(f"compare {mode} explain {'on' if ex else 'off'}: 50k eval "
            f"wall {r['wall_s']} s; layers {json.dumps(r['layers_s'])}; "
            f"pipeline {json.dumps(r['pipeline_s'])}; launches "
            f"{json.dumps(launches)}")
    cells = {f"{m} explain {'on' if e else 'off'}": [
        r["wall_s"] for r in runs if r["mode"] == m and r["explain"] == e]
        for m in ("serial", "pipelined") for e in (True, False)}
    medians = {k: statistics.median(w) for k, w in cells.items()}
    explain_s = {k: statistics.median(
        [r["layers_s"]["solver.explain.seconds"] for r in runs
         if f"{r['mode']} explain {'on' if r['explain'] else 'off'}" == k])
        for k in cells}
    walls = {m: [r["wall_s"] for r in runs if r["mode"] == m]
             for m in ("serial", "pipelined")}
    log(f"compare: 50k eval walls {json.dumps(cells)} s (order "
        f"{[f'{m}/{int(e)}' for m, e in COMPARE_ORDER]}); medians "
        f"{json.dumps(medians)}; explain seconds (median) "
        f"{json.dumps(explain_s)}")
    return {"walls_s": walls, "cells_s": cells, "median_wall_s": medians,
            "explain_s": explain_s, "runs": runs}


def profile_phase(torch) -> dict:
    """The pipelined 50k eval once more on a fresh cluster under
    torch.profiler (device activity only), the applier thread running:
    the card's busy time against the eval's wall time. Separate from the
    main path so its timing is unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    from nomad_tpu_torch import mock
    fsm, planner = _cluster(N_LIVE, seed=43)
    job = _mk_batch_job(mock, "big-profiled", BIG_COUNT)
    torch.cuda.synchronize()
    with _applier(planner), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _run_eval(fsm, planner, job, "chip-smoke-big-profiled")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_s": wall, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / (wall * 1e3),
           "top_device_ms": {k[:60]: v for k, v in top}}
    log(f"profiled pipelined 50k eval: wall {wall} s, device busy {busy} "
        f"ms, idle share {out['idle_share']}; top "
        f"{json.dumps(out['top_device_ms'])}")
    return out


def explain_phase(np, torch, dev) -> dict:
    """The explain reduce (kernels.explain_reduce, torch ops on the card)
    at the main path's bucket: the 16,384-row node matrices of the
    kernels phase, the placements of a 2,000-instance depth solve on
    them, four node classes, distinct_hosts on. Bit-equal to the numpy
    reduce on those inputs and on rows placed on a float32 rounding
    boundary; device ms per reduce (profiler), its device kernels, wall
    per call, and its bound (each input read once, against HBM)."""
    from nomad_tpu_torch.solver import cuda_kernels, explain, kernels
    from nomad_tpu_torch.testing import explain_boundary_case
    inp = _inputs(np, torch, dev)
    placed = cuda_kernels.fill_depth_fused(
        inp["cap"], inp["used"], inp["ask"], MID_COUNT, inp["feasible"],
        inp["coll"], MID_COUNT, inp["aff"], k_max=128)
    rng = np.random.default_rng(SEED + 6)
    cls = np.full(N_BUCKET, -1, np.int32)
    cls[:N_LIVE] = rng.integers(0, 4, N_LIVE)
    cls_t = torch.from_numpy(cls).to(dev)
    args = (inp["cap"], inp["used"], inp["ask"], inp["feasible"],
            inp["coll"], placed, cls_t)

    def run():
        return kernels.explain_reduce(*args, True, n_classes=4)
    got = explain.unpack(run().cpu().numpy(), 5, 4)
    host = [a.cpu().numpy() for a in args]
    want = explain.reduce_numpy(*host, np.bool_(True), n_classes=4)
    check(all(np.asarray(a).tobytes() == np.asarray(b).tobytes()
              for a, b in zip(got, want)),
          f"explain reduce on the card {got} differs from numpy {want}")
    b_args = explain_boundary_case()
    b_t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in b_args[:7]]
    b_got = explain.unpack(kernels.explain_reduce(
        *b_t, False, n_classes=2).cpu().numpy(), 5, 2)
    b_want = explain.reduce_numpy(*b_args, n_classes=2)
    check(all(np.asarray(a).tobytes() == np.asarray(b).tobytes()
              for a, b in zip(b_got, b_want)),
          "explain reduce on the card differs from numpy on the rounding "
          "boundary")
    _, device_ms, _ = _device_ms(torch, run, "")
    klist = _kernel_list(torch, run)
    wall_ms = _median_ms(torch, run, CALL_REPS)
    finish = _finish_times(np, torch, inp, placed, cls)
    n = N_BUCKET
    nbytes = (2 * n * 5 * 4 + 5 * 4 + n + 3 * n * 4 +
              (6 + 5 + 2 * 4) * 4)
    # per row: the post-solve usage (5 multiplies, 5 adds), the
    # next-instance compare (5 adds, 5 compares)
    out = {"device_ms": device_ms, "wall_ms": wall_ms,
           "device_kernels": (sum(v[0] for v in klist["kernels"].values())
                              if klist["kernels"] else None),
           "bytes": nbytes, "ops": n * 20, **_bound(nbytes, n * 20),
           "counts": got[0].tolist(), "finish": finish}
    log(f"explain finish of a serial solve at {N_BUCKET} rows (host wall, "
        f"the placement vector already computed): reduce on the card "
        f"riding the copy {finish['card_ms']} ms, copy then numpy reduce "
        f"{finish['numpy_ms']} ms, the copy alone {finish['copy_ms']} ms")
    log(f"explain reduce at {N_BUCKET} rows: {out['device_ms']} ms device "
        f"per reduce ({out['device_kernels']} device kernels), "
        f"{wall_ms} ms wall per call, bound {out['bound_ms']} ms "
        f"({out['bound_by']}: {nbytes} B); counts {out['counts']}; "
        f"bit-equal to the numpy reduce, also on the rounding boundary")
    return out


def _finish_times(np, torch, inp, placed, cls) -> dict:
    """Two ways to end a serial solve with explain on, on the same inputs,
    by median host wall (perf_counter, the card idle before each call),
    in turns: `card` uploads the solve's ask, feasible, collision and
    class columns, enqueues kernels.explain_reduce behind the solve on
    the state cache's twins and brings its buffer back with the
    placement vector in one copy; `numpy` (the placer's route) copies
    the placement vector alone, then runs explain.dispatch_reduce
    (reduce_numpy over the host arrays' live rows). `copy` is the copy
    alone. Both reduces must give the same counts."""
    import types
    from nomad_tpu_torch.solver import backend, explain, kernels
    gt = types.SimpleNamespace(
        cap=inp["cap"].cpu().numpy(), used=inp["used"].cpu().numpy(),
        ask=inp["ask"].cpu().numpy(), feasible=inp["feasible"].cpu().numpy(),
        job_collisions=inp["coll"].cpu().numpy(), distinct_hosts=True,
        cap_dev=inp["cap"], used_dev=inp["used"], nodes=range(N_LIVE))
    n = placed.shape[0]

    def card():
        dev = placed.device
        t = [backend._tensor(a, dev, dtype) for a, dtype in (
            (gt.ask, torch.float32), (gt.feasible, torch.bool),
            (gt.job_collisions, torch.int32), (cls, torch.int32))]
        ex = kernels.explain_reduce(gt.cap_dev, gt.used_dev, *t[:3], placed,
                                    t[3], True, n_classes=4)
        both = torch.cat((placed.to(torch.int32), ex)).cpu().numpy()
        return explain.unpack(both[n:], 5, 4)

    def host():
        return explain.dispatch_reduce(gt, placed.cpu().numpy(), cls, 4)

    def copy():
        return placed.cpu().numpy()

    a, b = card(), host()
    check(all(np.asarray(x).tobytes() == np.asarray(y).tobytes()
              for x, y in zip(a, b)),
          f"explain finish: the card's reduce {a} differs from the numpy "
          f"reduce {b}")
    out = {}
    for name, fn in (("card", card), ("numpy", host), ("copy", copy),
                     ("numpy", host), ("card", card)):
        for _ in range(3):
            fn()
        times = []
        for _ in range(CALL_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out.setdefault(f"{name}_ms_runs", []).append(
            statistics.median(times))
    for name in ("card", "numpy", "copy"):
        out[f"{name}_ms"] = min(out[f"{name}_ms_runs"])
    return out


def ladder_phase(np, torch) -> dict:
    """The dispatch chain on the card, faulted on purpose. Card work never
    moves to the CPU: (a) the 2,000-task eval (serial) with
    `solver.dispatch.cuda` faulted once raises out of the scheduler and
    commits nothing; (b) the pipelined 50k eval with a CUDA out-of-memory
    error raised when chunk 2's result reaches the host raises
    PipelineChunkError once chunks 0 and 1 are committed. Each counts one
    dispatch error, and no solve is served by the CPU's plain tier.
    (c) the breaker with a threshold of 2: two faulted solves, each
    raised (none skipped), open it; a healthy solve launches the kernel
    and closes it; a device loss (`device.lost.d0`) opens it at once and
    the next healthy solve closes it. (d) a kernel build error and a bug,
    each raised BREAKER_THRESHOLD + 1 times over, are never counted and
    never open the breaker."""
    import random
    from nomad_tpu_torch import faults, mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import backend, cuda_kernels, placer
    from nomad_tpu_torch.testing import seeded_urandom
    out = {}

    def run_faulted(job_id, count, pipelined, seed, exc_type):
        """One seeded eval on a fresh cluster, expected to raise
        `exc_type` -> (allocs committed, counter and launch deltas)."""
        fsm, planner = _cluster(N_LIVE, seed=45, pin="ladder-node-",
                                plan_pipeline_enabled=pipelined)
        backend.reset()
        launches0 = dict(cuda_kernels.LAUNCHES)
        counters0 = {k: metrics.counter(v) for k, v in COUNTERS.items()}
        raised = None
        with _applier(planner), seeded_urandom(seed):
            random.seed(seed)
            try:
                _run_eval(fsm, planner, _mk_batch_job(mock, job_id, count),
                          f"ladder-{job_id}")
            except exc_type as e:
                raised = e
        torch.cuda.synchronize()
        check(raised is not None,
              f"ladder: the faulted {job_id} eval did not raise "
              f"{exc_type.__name__}")
        return (len(fsm.state.allocs_by_job("default", job_id)),
                {k: metrics.counter(v) - counters0[k]
                 for k, v in COUNTERS.items()},
                {k: cuda_kernels.LAUNCHES[k] - v
                 for k, v in launches0.items()}, raised)

    # (a) the serial 2k eval, one fault at the cuda rung
    faults.install({"solver.dispatch.cuda": {"mode": "raise", "times": 1}})
    try:
        committed, c, launched, _ = run_faulted(
            "l-mid", MID_COUNT, False, 11, faults.FaultError)
        fired = faults.fired("solver.dispatch.cuda")
    finally:
        faults.clear()
    # the 2k eval takes the fused route: its dispatch fires the tier's
    # site, and raises before any launch
    check(fired == 1 and committed == 0 and c["dispatch_errors"] == 1 and
          c["torch_serves"] == c["torch_fused_serves"] == 0 and
          launched["depth_curve"] == launched["depth_curve_gather"] == 0,
          f"ladder: 2k eval faulted {fired}x committed {committed}, "
          f"counters {c}, launches {launched}")
    out["serial"] = {"faults": fired, "committed": committed,
                     "dispatch_errors": c["dispatch_errors"],
                     "torch_serves": c["torch_serves"]}
    log(f"ladder serial 2k eval: {fired} fault at solver.dispatch.cuda "
        f"raised out of the eval; {committed} allocs committed, "
        f"{c['dispatch_errors']} dispatch error, {c['torch_serves']} "
        f"solves on the CPU, {launched['depth_curve']} depth launches")

    # (b) the pipelined 50k eval, chunk 2's result lost at the host copy
    real = placer._Chunk.numpy
    seen = []

    def numpy(self):
        seen.append(1)
        if len(seen) == 3:
            raise torch.OutOfMemoryError("CUDA out of memory (injected "
                                         "at chunk 2's materialize)")
        return real(self)
    placer._Chunk.numpy = numpy
    try:
        committed, c, launched, e = run_faulted(
            "l-big", BIG_COUNT, True, 12, placer.PipelineChunkError)
    finally:
        placer._Chunk.numpy = real
    per_chunk = BIG_COUNT // BIG_CHUNKS
    check("chunk 2 of 4" in str(e) and committed == 2 * per_chunk and
          c["dispatch_errors"] == 1 and c["torch_serves"] == 0 and
          c["torch_fused_serves"] == 0 and c["fused"] == 0 and
          launched["depth_curve"] == BIG_CHUNKS,
          f"ladder: the faulted 50k eval ({e}) committed {committed}, "
          f"counters {c}, launches {launched}")
    out["pipelined"] = {"committed": committed,
                        "dispatch_errors": c["dispatch_errors"],
                        "torch_serves": c["torch_serves"]}
    log(f"ladder pipelined 50k eval: chunk 2 of {BIG_CHUNKS} lost at its "
        f"host copy (torch.OutOfMemoryError) raised PipelineChunkError; "
        f"{committed}/{BIG_COUNT} committed (chunks 0 and 1), "
        f"{c['dispatch_errors']} dispatch error, {c['torch_serves']} "
        f"solves on the CPU")

    # (c) the breaker on the card, threshold 2
    inp = _inputs(np, torch, torch.device(DEVICE))
    host = {k: v[:BREAKER_ROWS].cpu().numpy() for k, v in inp.items()
            if k != "ask"}
    args = (host["cap"], host["used"], inp["ask"].cpu().numpy(),
            np.int32(200), host["feasible"], host["coll"], np.int32(200),
            host["aff"], np.int32(2 ** 30), None, np.float32(0.5),
            np.float32(0.0))
    knob = backend.BREAKER_THRESHOLD
    backend.BREAKER_THRESHOLD = 2
    names = ("dispatch_errors.cuda", "tier_breaker_opened.cuda",
             "tier_breaker_closed.cuda", "device_loss.cuda",
             "dispatch.cuda", "dispatch.torch")
    c0 = {k: metrics.counter(f"nomad.solver.{k}") for k in names}
    states, raised = [], 0
    try:
        backend.reset()
        _, fn = backend.select("depth", BREAKER_ROWS, k_max=16)
        want = fn(*args)
        launches = cuda_kernels.LAUNCHES["depth_curve"]
        faults.install({"solver.dispatch.cuda": {"mode": "raise"}})
        for _ in range(2):
            try:
                fn(*args)
            except faults.FaultError:
                raised += 1
            states.append(backend.breaker().state("cuda"))
        fired = faults.fired("solver.dispatch.cuda")
        faults.clear()
        check(torch.equal(fn(*args), want), "ladder: the healing solve")
        states.append(backend.breaker().state("cuda"))
        healed = cuda_kernels.LAUNCHES["depth_curve"] - launches
        faults.install({"device.lost.d0": {"mode": "raise", "times": 1}})
        try:
            fn(*args)
        except faults.DeviceLostError:
            raised += 1
        states.append(backend.breaker().state("cuda"))
        faults.clear()
        check(torch.equal(fn(*args), want),
              "ladder: the solve after a device loss")
        states.append(backend.breaker().state("cuda"))
    finally:
        faults.clear()
        backend.BREAKER_THRESHOLD = knob
        backend.reset()
    d = {k: metrics.counter(f"nomad.solver.{k}") - v for k, v in c0.items()}
    check(fired == 2 and raised == 3 and healed == 1 and
          states == ["closed", "open", "closed", "open", "closed"] and
          d["dispatch_errors.cuda"] == 3 and
          d["tier_breaker_opened.cuda"] == 2 and
          d["tier_breaker_closed.cuda"] == 2 and
          d["device_loss.cuda"] == 1 and d["dispatch.torch"] == 0,
          f"ladder breaker: fired {fired}, raised {raised}, states "
          f"{states}, counters {d}, healing launches {healed}")
    out["breaker"] = {"states": states, "counters": d}
    log(f"ladder breaker: 2 faulted solves raised and opened it, the "
        f"healthy solve launched the kernel ({healed} launch) and closed "
        f"it, a device loss raised and opened it at once, the next solve "
        f"closed it; states {states}; counters {json.dumps(d)}")

    # (d) errors that are not device errors: never counted, never open it
    real_depth = cuda_kernels.fill_depth_fused
    kinds = {}
    for exc in (cuda_kernels.KernelBuildError("CUDA kernel build failed "
                                              "(injected)"),
                ValueError("a bug in the solve (injected)")):
        def broken(*a, _exc=exc, **kw):
            raise _exc
        cuda_kernels.fill_depth_fused = broken
        e0 = metrics.counter("nomad.solver.dispatch_errors")
        t0 = metrics.counter("nomad.solver.dispatch.torch")
        n, shut = 0, []
        try:
            backend.reset()
            _, fn = backend.select("depth", BREAKER_ROWS, k_max=16)
            for _ in range(backend.BREAKER_THRESHOLD + 1):
                try:
                    fn(*args)
                except type(exc):
                    n += 1
                shut.append(backend.breaker().state("cuda"))
        finally:
            cuda_kernels.fill_depth_fused = real_depth
            backend.reset()
        counted = metrics.counter("nomad.solver.dispatch_errors") - e0
        on_cpu = metrics.counter("nomad.solver.dispatch.torch") - t0
        check(n == backend.BREAKER_THRESHOLD + 1 and counted == 0 and
              on_cpu == 0 and set(shut) == {"closed"},
              f"ladder: {type(exc).__name__} raised {n}x, counted "
              f"{counted}, CPU serves {on_cpu}, breaker {shut}")
        kinds[type(exc).__name__] = n
    out["never_counted"] = kinds
    log(f"ladder: {json.dumps(kinds)} raised out of every solve, none "
        f"counted as a dispatch error, breaker closed throughout, no "
        f"solve on the CPU")
    return out


# the small phase's evals: (job id, count, kind); the filler's count
# (None) is what fills every node
SMALL_JOBS = (("s-dense", 200, "batch"), ("s-grid", 60, "batch"),
              ("s-one", 1, "batch"), ("s-pipe", 600, "batch"),
              ("s-web", 300, "web"), ("s-capped", 90, "rack-capped"),
              ("s-deep", 2_000, "deep"), ("s-fill", None, "filler"),
              ("s-preempt", 30, "preemptor"), ("s-over", 60, "over"),
              ("s-dh", 250, "distinct-hosts"))
SMALL_PIPED = ("s-pipe", "s-fill")
# the small phase's evals that leave instances unplaced: asked beyond
# the full cluster's capacity, and distinct_hosts past one per node
SMALL_FAILING = ("s-over", "s-dh")
SMALL_RACKS = 50


def _small_job(mock, structs, job_id, count, kind):
    if kind == "batch":
        return _mk_batch_job(mock, job_id, count)
    if kind == "deep":                  # k_max > 512: the scan
        return _mk_batch_job(mock, job_id, count, cpu=5, mem=8)
    if kind == "filler":
        return _mk_batch_job(mock, job_id, count, *FILL_ASK, priority=20)
    if kind == "preemptor":
        return _mk_service_job(mock, structs, job_id, count, *FILL_ASK,
                               priority=80)
    if kind == "over":          # the filler's priority: nothing to preempt
        return _mk_batch_job(mock, job_id, count, *FILL_ASK, priority=20)
    if kind == "distinct-hosts":
        job = _mk_batch_job(mock, job_id, count, cpu=5, mem=8,
                            priority=20)
        job.task_groups[0].constraints = [
            structs.Constraint(operand=structs.OP_DISTINCT_HOSTS)]
        return job
    return _mk_service_job(mock, structs, job_id, count, 250, 512, kind)


def _small_metric(m) -> dict:
    """An AllocMetric's fields, less the wall-clock allocation time."""
    import dataclasses
    d = dataclasses.asdict(m)
    d.pop("allocation_time_ns")
    return d


def small_phase(torch) -> None:
    """A 200-node cluster in three datacenters and 50 racks, its evals on
    the card and on the CPU's plain tier: the batch jobs of the depth and
    greedy solves, one pipelined from one placement in 3 chunks, the web
    and rack-capped service jobs and a deep job (the scan), a priority-20
    filler and a priority-80 job placed by preemption, then a job asked
    beyond the full cluster's capacity and a distinct_hosts job past one
    per node. Each eval runs from the same seeded id stream on both: the
    committed alloc -> node maps, the preempted alloc ids, the explain
    records (tier aside), the placed allocs' metrics (score metadata and
    scores) and the failed placements' metrics must be identical, and
    the card run must count no dispatch error."""
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import backend, explain
    from nomad_tpu_torch.solver.device import use_device
    from nomad_tpu_torch.testing import fill_count, seeded_urandom
    runs = []
    try:
        for dev in (DEVICE, "cpu"):
            use_device(dev)
            backend.reset()
            explain.reset()
            fsm, planner = _cluster(
                200, seed=7, pin="small-node-", racks=SMALL_RACKS,
                preemption_config=structs.PreemptionConfig(
                    batch_scheduler_enabled=True,
                    service_scheduler_enabled=True), **SMALL_PIPELINE)
            s = fsm.state
            preempted: dict = {}
            records: dict = {}
            failed: dict = {}
            metrics_of: dict = {}
            zero0 = {k: metrics.counter(COUNTERS[k]) for k in HEALTHY_ZERO}
            for seed, (job_id, count, kind) in enumerate(SMALL_JOBS):
                if count is None:
                    count = fill_count(s.usage.view(), *FILL_ASK)
                evals0 = metrics.counter("nomad.plan.pipeline.evals")
                chunks0 = metrics.counter("nomad.plan.pipeline.chunks")
                evicted = {a.id for a in s.iter_allocs()
                           if a.desired_status == "evict"}
                ev_id = f"chip-smoke-{job_id}"
                with seeded_urandom(seed):
                    ev = _run_eval(
                        fsm, planner,
                        _small_job(mock, structs, job_id, count, kind),
                        ev_id)
                piped = (metrics.counter("nomad.plan.pipeline.evals") -
                         evals0,
                         metrics.counter("nomad.plan.pipeline.chunks") -
                         chunks0)
                want = (1, 3) if job_id in SMALL_PIPED else (0, 0)
                check(piped == want, f"small {dev} {job_id}: pipelined "
                      f"(evals, chunks) {piped}, expected {want}")
                allocs = s.allocs_by_job("default", job_id)
                placed = len(allocs)
                check(placed == count if job_id not in SMALL_FAILING
                      else placed < count and ev.failed_tg_allocs,
                      f"small {dev} {job_id}: committed {placed}/{count}")
                preempted[job_id] = sorted(
                    a.id for a in s.iter_allocs()
                    if a.desired_status == "evict" and a.id not in evicted)
                records[job_id] = [
                    {k: v for k, v in r.items() if k != "tier"}
                    for r in explain.recent(256) if r["eval_id"] == ev_id]
                check(len(records[job_id]) == 1,
                      f"small {dev} {job_id}: {len(records[job_id])} "
                      f"explain records")
                failed[job_id] = {tg: _small_metric(m) for tg, m in
                                  (ev.failed_tg_allocs or {}).items()}
                metrics_of[job_id] = {a.name: _small_metric(a.metrics)
                                      for a in allocs}
            zero = {k: metrics.counter(COUNTERS[k]) - v
                    for k, v in zero0.items()}
            check(not any(zero.values()),
                  f"small {dev}: a healthy run counted {zero}")
            runs.append(({a.name: a.node_id for a in s.iter_allocs()},
                         preempted, records, failed, metrics_of))
    finally:
        use_device(DEVICE)
        backend.reset()
    (card_map, card_pre, card_rec, card_failed, card_metrics), \
        (cpu_map, cpu_pre, cpu_rec, cpu_failed, cpu_metrics) = runs
    diff = sum(card_map[k] != cpu_map.get(k) for k in card_map)
    check(len(card_map) == len(cpu_map) and diff == 0,
          f"small: {diff} allocs placed differently on the card than on "
          f"the CPU")
    check(card_pre == cpu_pre and len(card_pre["s-preempt"]) == 30,
          "small: the preempted allocs differ between the card and the CPU")
    for job_id in card_rec:
        check(card_rec[job_id] == cpu_rec[job_id],
              f"small {job_id}: explain records differ: card "
              f"{json.dumps(card_rec[job_id])[:600]} cpu "
              f"{json.dumps(cpu_rec[job_id])[:600]}")
        check(card_failed[job_id] == cpu_failed[job_id],
              f"small {job_id}: failed placement metrics differ: card "
              f"{card_failed[job_id]} cpu {cpu_failed[job_id]}")
        check(card_metrics[job_id] == cpu_metrics[job_id],
              f"small {job_id}: placed allocs' metrics differ")
    for job_id in SMALL_FAILING:
        m = next(iter(card_failed[job_id].values()))
        log(f"small {job_id}: failed placement metric (card = CPU) "
            f"{json.dumps({k: m[k] for k in ('nodes_evaluated', 'nodes_filtered', 'constraint_filtered', 'nodes_exhausted', 'dimension_exhausted', 'class_exhausted')})}")
    log(f"small: {len(card_map)} allocs over {len(SMALL_JOBS)} evals (s-pipe "
        f"and s-fill pipelined in 3 chunks; s-web, s-capped and "
        f"s-deep on the scan; s-preempt placed by preemption, displacing "
        f"{len(card_pre['s-preempt'])}; s-over and s-dh partly placed), "
        f"card and CPU maps, preempted ids, explain records, placed and "
        f"failed metrics identical; no dispatch error")


# ------------------------------------------------------------------ main

# ----------------------------------------------------- the server slice


def lanes_phase(np, torch, dev) -> dict:
    """The depth-curve kernel over the lanes of a full micro-batch window
    (LANES lanes at the bucket, dense K = 128), each lane with its own
    usage, ask, count and max_per_node. Its outputs bit-equal to one
    one-lane launch a lane and to the plain lane version within the K1
    tolerances; the window's placements bit-equal to each lane's solo
    fill_depth_fused. Device ms per window against 8 solo launches, the
    plain version's ms, the bound of the window's lanes."""
    from nomad_tpu_torch.solver import cuda_kernels, kernels
    from nomad_tpu_torch.solver.buckets import BATCH_LANES
    inp = _inputs(np, torch, dev)
    scale = torch.tensor([1.0, 0.5, 0.0, 1.2, 0.8, 0.3, 0.9, 0.1],
                         device=dev)
    used = torch.stack([torch.floor(inp["used"] * s) for s in scale])
    cap = inp["cap"].expand(BATCH_LANES, -1, -1).contiguous()
    ask = torch.tensor([[250, 512, 300, 0, 0], [500, 256, 300, 0, 0],
                        [100, 2_048, 300, 0, 0], [1_000, 1_024, 0, 0, 0],
                        [250, 512, 300, 0, 0], [2_000, 4_096, 300, 0, 0],
                        [400, 700, 0, 0, 0], [50, 128, 100, 0, 0]],
                       dtype=torch.float32, device=dev)
    feas = inp["feasible"].expand(BATCH_LANES, -1).contiguous()
    coll = inp["coll"].expand(BATCH_LANES, -1).contiguous()
    aff = inp["aff"].expand(BATCH_LANES, -1).contiguous()
    jitter = inp["jitter"].expand(BATCH_LANES, -1).contiguous()
    counts = [STREAM_COUNT, 500, 2_000, 4_000, 1, 300, 2_000, 700]
    desired = [max(c, 1) for c in counts]
    mpn = [2 ** 30, 2 ** 30, 1, 2 ** 30, 2 ** 30, 3, 2 ** 30, 2]
    curve = (cap, used, ask, feas, coll, desired, aff, mpn)
    kw = dict(k_max=128)
    before = dict(cuda_kernels.LAUNCHES)
    d_l, k_l, c_l = cuda_kernels.depth_curve_lanes(*curve, **kw)
    torch.cuda.synchronize()
    check(cuda_kernels.LAUNCHES["depth_curve_lanes"] ==
          before["depth_curve_lanes"] + 1 and
          cuda_kernels.LAUNCHES["depth_curve"] == before["depth_curve"],
          "lanes: the window took more than one launch")

    def solo_curve(lane):
        return cuda_kernels.depth_curve(
            cap[lane], used[lane], ask[lane], feas[lane], coll[lane],
            desired[lane], aff[lane], max_per_node=mpn[lane], **kw)
    for lane in range(BATCH_LANES):
        d_s, k_s, c_s = solo_curve(lane)
        check(torch.equal(d_l[lane].view(torch.int32), d_s.view(torch.int32))
              and torch.equal(k_l[lane], k_s) and torch.equal(c_l[lane], c_s),
              f"lanes: lane {lane} differs from its solo launch")
    d_p, k_p, c_p = kernels.depth_curve_lanes_ref(*curve, **kw)
    check(torch.equal(c_l, c_p), "lanes: k_cap differs from plain")
    fin = torch.isfinite(d_p)
    check(torch.equal(torch.isfinite(d_l), fin),
          "lanes: rows with no fitting depth differ from plain")
    err = float((d_l[fin] - d_p[fin]).abs().max())
    check(err <= ATOL, f"lanes: d_star max abs err {err}")
    ties = int(((k_l != k_p) & fin).sum())
    tail = dict(order_jitter=jitter, jitter_scales=[1.5] * BATCH_LANES,
                jitter_samples=[0.0] * BATCH_LANES, **kw)
    placed = cuda_kernels.fill_depth_lanes(
        cap, used, ask, counts, feas, coll, desired, aff, mpn, **tail)
    plain = kernels.fill_depth_lanes(
        cap, used, ask, counts, feas, coll, desired, aff, mpn, **tail)
    moved = 0
    for lane in range(BATCH_LANES):
        solo = cuda_kernels.fill_depth_fused(
            cap[lane], used[lane], ask[lane], counts[lane], feas[lane],
            coll[lane], desired[lane], aff[lane], max_per_node=mpn[lane],
            order_jitter=jitter[lane], jitter_scale=1.5, jitter_samples=0.0,
            **kw)
        check(torch.equal(placed[lane], solo),
              f"lanes: lane {lane}'s placements differ from its solo solve")
        moved += _placements_agree(torch, placed[lane], plain[lane],
                                   bool(ties), f"lanes: lane {lane}")
    check(moved == 0, f"lanes: near ties moved {moved} nodes")

    out = _times(torch, "depth_curve_kernel",
                 lambda: cuda_kernels.depth_curve_lanes(*curve, **kw))

    def eight_solo():
        for lane in range(BATCH_LANES):
            solo_curve(lane)
    solo_ms, _, _ = _device_ms(torch, eight_solo, "depth_curve_kernel",
                            per_call=BATCH_LANES)
    # the 8 launches' device time together, per call of eight_solo
    out["solo_8_ms"] = solo_ms or _queued_ms(torch, eight_solo)
    out.update(_plain_times(
        torch, lambda: kernels.depth_curve_lanes_ref(*curve, **kw)))
    depths = int(torch.clamp(c_p, max=128).sum())
    nbytes = BATCH_LANES * (N_BUCKET * (2 * 5 * 4 + 1 + 4 + 4 + 3 * 4)
                            + 5 * 4 + 2 * 4)
    ops = depths * DEPTH_OPS_DENSE + BATCH_LANES * N_BUCKET * DEPTH_OPS_NODE
    out.update(_bound(nbytes, ops))
    out.update(max_abs_err=err, near_tie_rows=ties, moved_nodes=moved,
               depths_evaluated=depths)

    # the fused window (the batch tier with the whole-eval route on; forced
    # here, BATCH_MAX_COUNT being 0): one resident twin pair, each lane its
    # own shuffled idx, ask, count and max_per_node; one launch of K1's
    # gather entry and one of the verdict for the window, each lane equal
    # to its solo fused eval
    f_inp = _fused_inputs(np, torch, dev)
    rng = np.random.default_rng(SEED + 3)
    idx = np.zeros((BATCH_LANES, N_BUCKET), np.int32)
    idx[0, :N_LIVE] = f_inp["idx"][:N_LIVE].cpu().numpy()
    for lane in range(1, BATCH_LANES):
        idx[lane, :N_LIVE] = rng.permutation(N_LIVE)
    idx = torch.from_numpy(idx).to(dev)
    valid = f_inp["valid"].expand(BATCH_LANES, -1).contiguous()
    feas_f = f_inp["feasible"].expand(BATCH_LANES, -1).contiguous()
    twins = (f_inp["cap"], f_inp["used"])
    window = (*twins, idx, valid, ask, counts, feas_f, coll, desired, aff,
              mpn)
    before = dict(cuda_kernels.LAUNCHES)
    placed_w, fit_w = cuda_kernels.fused_eval_depth_lanes(*window, **tail)
    torch.cuda.synchronize()
    check(cuda_kernels.LAUNCHES["depth_curve_gather"] ==
          before["depth_curve_gather"] + 1 and
          cuda_kernels.LAUNCHES["fit_verdict"] == before["fit_verdict"] + 1,
          "lanes: the fused window took more than one launch of each")
    for lane in range(BATCH_LANES):
        solo = cuda_kernels.fused_eval_depth(
            *twins, idx[lane], valid[lane], ask[lane], counts[lane],
            feas_f[lane], coll[lane], desired[lane], aff[lane], mpn[lane],
            jitter[lane], 1.5, 0.0, None, False, k_max=128)
        check(torch.equal(placed_w[lane], solo[0]) and
              torch.equal(fit_w[lane], solo[1]),
              f"lanes: fused lane {lane} differs from its solo fused eval")
    out["fused_window_ms"] = _kernel_list(
        torch, lambda: cuda_kernels.fused_eval_depth_lanes(
            *window, **tail))["device_ms"]
    log(f"lanes: the fused window ({BATCH_LANES} lanes of one twin pair, "
        f"shuffled idx) bit-equal to each lane's solo fused eval, one "
        f"launch of the gather entry and one of the verdict; "
        f"{out['fused_window_ms']} ms device for every kernel it runs")
    log(f"lanes: the window ({BATCH_LANES} lanes x {N_BUCKET} rows, dense "
        f"K=128) bit-equal to {BATCH_LANES} one-lane launches; placements "
        f"bit-equal to each lane's solo fill_depth_fused; plain d_star max "
        f"abs err {err:.3g}, near-tie rows {ties}")
    log(f"lanes: kernel {out['ms']} ms device per window ({out['call_ms']} "
        f"ms per wrapper call), {BATCH_LANES} solo launches "
        f"{out['solo_8_ms']} ms device together, plain {out['plain_ms']} "
        f"ms, bound {out['bound_ms']} ms "
        f"({out['bound_by']}: {nbytes} B, {ops} ops, {depths} depths)")
    return out


# ----------------------------------------------------- the fused route

# float32 operations of the fit verdict a row: per dimension a fused
# multiply-add (2), the add of FIT_EPS and the compare
FIT_OPS_ROW = 5 * 4
# the fused pairs: runs of the 2k, count-1 and stream evals with the
# whole-eval route on and off in turns; one worker, so both legs of a pair
# plan and commit every eval in one order from one snapshot and their
# placements can be compared
FUSED_PAIRS = 10
FUSED_WORKERS = 1
FUSED_EVAL_IDS = {"mid": "0000f05e-0000-0000-0000-000000000002",
                  "one": "0000f05e-0000-0000-0000-000000000001"}


def _fused_inputs(np, torch, dev):
    """The fused route's inputs at the main path's bucket: the seeded
    fleet of _inputs as the state cache's twins, and one eval's idx over
    them, its N_LIVE live rows shuffled (rows past N_LIVE invalid)."""
    inp = _inputs(np, torch, dev)
    rng = np.random.default_rng(SEED + 2)
    idx = np.zeros(N_BUCKET, np.int32)
    idx[:N_LIVE] = rng.permutation(N_LIVE)
    valid = np.arange(N_BUCKET) < N_LIVE
    inp["idx"] = torch.from_numpy(idx).to(dev)
    inp["valid"] = torch.from_numpy(valid).to(dev)
    inp["feasible"] = inp["feasible"] & inp["valid"]
    return inp


def _fused_gather_bytes(extra_per_row: int) -> int:
    """Bytes a gather entry moves at the bucket: idx and valid for every
    row, the two twin rows of each live row, `extra_per_row` more."""
    return N_BUCKET * (4 + 1 + extra_per_row) + N_LIVE * 2 * 5 * 4 + 5 * 4


def fused_kernel_phase(np, torch, dev, floor_ms: float) -> dict:
    """The fused route's three kernel entries at the main path's shapes
    (16,384 rows, 10,000 live in shuffled idx): (a) K1's gather entry,
    dense K = 128 on the 50k eval's inputs, on the grid and under the
    spread algorithm; (b) K2's greedy gather entry, placing 1, 2,000 and
    5,000; (c) the fit verdict on the 2k fused eval's placements and on
    over-full ones. Each entry bit-equal to its plain version: the gather
    entries to the plain entries of their kernels on gather_rows' rows
    (the same arithmetic on the same rows), and to the plain torch
    versions within K1's and K2's tolerances; the verdict to
    kernels.fit_verdict_ref bit for bit. Device ms, per-call ms, the
    bound and the launch floor for each."""
    from nomad_tpu_torch.solver import cuda_kernels, kernels
    inp = _fused_inputs(np, torch, dev)
    grid128 = tuple(g for g in kernels.DEPTH_GRID if g <= 128)
    twins = (inp["cap"], inp["used"])
    sel = (inp["idx"], inp["valid"])
    cap, used = kernels.gather_rows(*twins, *sel)
    empty_used = torch.zeros_like(inp["used"])
    cap_e, used_e = kernels.gather_rows(inp["cap"], empty_used, *sel)
    out = {}

    # (a) K1's gather entry
    a = {"max_abs_err": 0.0, "cases": []}

    def one(t):                 # one lane of a [N] column
        return t[None].contiguous()
    for name, u_res, u_rows, kw in (
            ("dense_k128", empty_used, used_e, dict(k_max=128)),
            ("grid_k128", inp["used"], used,
             dict(k_max=128, depth_grid=grid128)),
            ("spread_dense_k128", inp["used"], used,
             dict(k_max=128, spread_algorithm=True))):
        c_rows = cap_e if u_res is empty_used else cap
        cols = (one(inp["ask"]), one(inp["feasible"]), one(inp["coll"]),
                (BIG_COUNT,), one(inp["aff"]), (2 ** 30,))
        before = cuda_kernels.LAUNCHES["depth_curve_gather"]
        got = cuda_kernels.depth_curve_gather(
            inp["cap"], u_res, one(inp["idx"]), one(inp["valid"]), *cols,
            **kw)
        torch.cuda.synchronize()
        check(cuda_kernels.LAUNCHES["depth_curve_gather"] == before + 1,
              f"fused K1 gather {name}: not one launch")
        plain_entry = cuda_kernels.depth_curve(
            c_rows, u_rows, inp["ask"], inp["feasible"], inp["coll"],
            BIG_COUNT, inp["aff"], **kw)
        for g, w, what in zip(got, plain_entry, ("d_star", "k_star",
                                                 "k_cap")):
            g = g[0].view(torch.int32) if g.dtype == torch.float32 else g[0]
            w = w.view(torch.int32) if w.dtype == torch.float32 else w
            check(torch.equal(g, w), f"fused K1 gather {name}: {what} "
                  f"differs from the plain entry on the gathered rows")
        d_p, k_p, c_p = kernels.depth_curve_ref(
            c_rows, u_rows, inp["ask"], inp["feasible"], inp["coll"],
            BIG_COUNT, inp["aff"], **kw)
        check(torch.equal(got[2][0], c_p), f"fused K1 gather {name}: k_cap")
        fin = torch.isfinite(d_p)
        err = float((got[0][0][fin] - d_p[fin]).abs().max())
        check(err <= ATOL, f"fused K1 gather {name}: d_star err {err}")
        a["max_abs_err"] = max(a["max_abs_err"], err)
        a["cases"].append(name)
        log(f"fused K1 gather {name}: bit-equal to the plain entry on the "
            f"gathered rows; plain torch d_star max abs err {err:.3g}, "
            f"k_cap equal")

    def k1_run(u_res=empty_used, **kw):
        return lambda: cuda_kernels.depth_curve_gather(
            inp["cap"], u_res, one(inp["idx"]), one(inp["valid"]),
            one(inp["ask"]), one(inp["feasible"]), one(inp["coll"]),
            (BIG_COUNT,), one(inp["aff"]), (2 ** 30,), **kw)
    a.update(_times(torch, "depth_curve_kernel", k1_run(k_max=128)))
    a["grid_ms"] = _times(torch, "depth_curve_kernel", k1_run(
        inp["used"], k_max=128, depth_grid=grid128))["ms"]
    a["spread_ms"] = _times(torch, "depth_curve_kernel", k1_run(
        inp["used"], k_max=128, spread_algorithm=True))["ms"]
    a.update(_plain_times(torch, lambda: kernels.depth_curve_ref(
        *kernels.gather_rows(inp["cap"], empty_used, *sel), inp["ask"],
        inp["feasible"], inp["coll"], BIG_COUNT, inp["aff"], k_max=128)))
    _, _, c_p = kernels.depth_curve_ref(cap_e, used_e, inp["ask"],
                                        inp["feasible"], inp["coll"],
                                        BIG_COUNT, inp["aff"], k_max=128)
    depths = int(torch.clamp(c_p, max=128).sum())
    nbytes = _fused_gather_bytes(1 + 4 + 4 + 3 * 4)
    a.update(_bound(nbytes, depths * DEPTH_OPS_DENSE
                    + N_BUCKET * DEPTH_OPS_NODE))
    a.update(floor_ms=floor_ms, depths_evaluated=depths)
    out["depth_curve_gather"] = a
    log(f"fused K1 gather entry (dense K=128, the 50k eval's fleet): "
        f"kernel {a['ms']} ms device ({a['call_ms']} ms per wrapper call), "
        f"grid {a['grid_ms']} ms, spread {a['spread_ms']} ms; plain "
        f"(gather_rows + depth_curve_ref) {a['plain_ms']} ms; bound "
        f"{a['bound_ms']} ms ({a['bound_by']}: {nbytes} B, {depths} "
        f"depths); launch floor {floor_ms} ms")

    # (b) K2's greedy gather entry
    b = {"moved_nodes": 0}
    c_g, key_g = cuda_kernels.score_capacity_gather(
        *twins, *sel, inp["ask"], inp["feasible"])
    c_e, key_e = cuda_kernels._launch_score_capacity(
        cap, used, inp["ask"], inp["feasible"], False, True, 2 ** 30)
    torch.cuda.synchronize()
    check(torch.equal(c_g, c_e) and torch.equal(key_g.view(torch.int32),
                                                key_e.view(torch.int32)),
          "fused K2 gather: differs from the greedy entry on the gathered "
          "rows")
    c_p, key_p = kernels._greedy_key(*kernels.score_capacity_ref(
        cap, used, inp["ask"], inp["feasible"]), 2 ** 30)
    check(torch.equal(c_g, c_p), "fused K2 gather: capacity differs")
    b["max_abs_err"] = float((key_g - key_p).abs().max())
    check(b["max_abs_err"] <= ATOL, f"fused K2 gather: key err "
          f"{b['max_abs_err']}")
    for count in (1, MID_COUNT, 5_000):
        got, fit = cuda_kernels.fused_eval_greedy(
            *twins, *sel, inp["ask"], count, inp["feasible"], 2 ** 30, None,
            False, inp["coll"])
        want = kernels.fill_greedy_binpack(cap, used, inp["ask"], count,
                                           inp["feasible"])
        moved = _placements_agree(torch, got, want, b["max_abs_err"] > 0,
                                  f"fused greedy count={count}")
        check(moved == 0, f"fused greedy count={count}: moved {moved}")
        check(torch.equal(fit, kernels.fused_fit_verdict(
            cap, used, inp["ask"], got)), f"fused greedy count={count}: fit")
        b["moved_nodes"] += moved
        log(f"fused greedy eval count={count}: placed {int(got.sum())} like "
            f"the plain fill on the gathered rows (nodes moved {moved}); "
            f"verdict bit-equal to the plain one")
    b.update(_times(torch, "score_capacity_kernel",
                    lambda: cuda_kernels.score_capacity_gather(
                        *twins, *sel, inp["ask"], inp["feasible"])))
    b.update(_plain_times(torch, lambda: kernels._greedy_key(
        *kernels.score_capacity_ref(*kernels.gather_rows(*twins, *sel),
                                    inp["ask"], inp["feasible"]), 2 ** 30)))
    nbytes = _fused_gather_bytes(1 + 2 * 4)
    b.update(_bound(nbytes, N_BUCKET * SCORE_OPS_NODE))
    b["floor_ms"] = floor_ms
    out["score_capacity_gather"] = b
    log(f"fused K2 gather entry: kernel {b['ms']} ms device ({b['call_ms']} "
        f"ms per wrapper call), plain {b['plain_ms']} ms, bound "
        f"{b['bound_ms']} ms ({b['bound_by']}: {nbytes} B), key max abs err "
        f"{b['max_abs_err']:.3g}")

    # (c) the fit verdict, on the 2k fused eval's placements
    placed, fit = cuda_kernels.fused_eval_depth(
        *twins, *sel, inp["ask"], MID_COUNT, inp["feasible"], inp["coll"],
        MID_COUNT, inp["aff"], 2 ** 30, inp["jitter"], 1.5, 0.4, None,
        False, k_max=128, depth_grid=grid128)
    want = kernels.fill_depth(cap, used, inp["ask"], MID_COUNT,
                              inp["feasible"], inp["coll"], MID_COUNT,
                              inp["aff"], k_max=128,
                              order_jitter=inp["jitter"], jitter_scale=1.5,
                              jitter_samples=0.4, depth_grid=grid128)
    moved = _placements_agree(torch, placed, want, True, "fused 2k eval")
    over = placed + (torch.arange(N_BUCKET, device=dev) % 5 == 0).to(
        torch.int32) * 40
    c = {"max_abs_err": 0.0}
    for what, p in (("the 2k eval's placements", placed.clone()),
                    ("over-full placements", over)):
        before = cuda_kernels.LAUNCHES["fit_verdict"]
        p_k, f_k = cuda_kernels.fit_verdict(*twins, *sel, inp["ask"], p)
        torch.cuda.synchronize()
        check(cuda_kernels.LAUNCHES["fit_verdict"] == before + 1,
              "fused fit verdict: not one launch")
        f_p = kernels.fit_verdict_ref(*twins, *sel, inp["ask"], p)
        check(torch.equal(f_k, f_p) and torch.equal(p_k, p),
              f"fused fit verdict on {what}: differs from plain")
        host = cuda_kernels.fused_to_host(p_k, f_k)
        check(np.array_equal(host[0], p.cpu().numpy()) and
              np.array_equal(host[1], f_p.cpu().numpy()),
              "fused fit verdict: the one host copy differs")
        log(f"fused fit verdict on {what}: bit-equal to the plain verdict "
            f"({int(f_p.sum())} of {N_BUCKET} rows fit); one host copy")
    check(bool(fit[placed > 0].all()), "fused 2k eval: a placed row unfit")
    # over a window's lanes and on a ragged edge
    lanes = {}
    for n_lanes in (1, 3, 8):
        cols = [torch.stack([torch.roll(t, 37 * lane)
                             for lane in range(n_lanes)]).contiguous()
                for t in (inp["idx"], inp["valid"], over)]
        ask_l = torch.stack([inp["ask"]] * n_lanes).contiguous()
        for n in (N_BUCKET, N_BUCKET - 3):
            args = (cols[0][:, :n].contiguous(), cols[1][:, :n].contiguous(),
                    ask_l, cols[2][:, :n].contiguous())
            p_k, f_k = cuda_kernels.fit_verdict(*twins, *args)
            torch.cuda.synchronize()
            check(torch.equal(f_k, kernels.fit_verdict_ref(*twins, *args))
                  and torch.equal(p_k, args[3]),
                  f"fused fit verdict: {n_lanes} lanes of {n} rows differ "
                  f"from plain")
        lanes[n_lanes] = cols, ask_l
    log(f"fused fit verdict over 1, 3 and 8 lanes, {N_BUCKET} and "
        f"{N_BUCKET - 3} rows (a ragged edge): bit-equal to the plain "
        f"verdict")
    gathered = cuda_kernels.gather_floor(inp["idx"], inp["cap"])
    torch.cuda.synchronize()
    check(torch.equal(gathered, inp["cap"][inp["idx"].long(), 0]),
          "gather floor: the kernel gathered other rows")
    c.update(_times(torch, "fit_verdict_kernel",
                    lambda: cuda_kernels.fit_verdict(*twins, *sel,
                                                     inp["ask"], placed)))
    c["lanes_ms"] = {
        n_lanes: _times(torch, "fit_verdict_kernel",
                        lambda: cuda_kernels.fit_verdict(
                            *twins, cols[0], cols[1], ask_l, cols[2]))["ms"]
        for n_lanes, (cols, ask_l) in lanes.items()}
    c["gather_floor_ms"] = _times(torch, "gather_floor",
                                  lambda: cuda_kernels.gather_floor(
                                      inp["idx"], inp["cap"]))["ms"]
    c.update(_plain_times(torch, lambda: kernels.fit_verdict_ref(
        *twins, *sel, inp["ask"], placed)))
    nbytes = _fused_gather_bytes(4 + 4 + 1)
    c.update(_bound(nbytes, N_BUCKET * FIT_OPS_ROW))
    c["floor_ms"] = floor_ms
    out["fit_verdict"] = c
    log(f"fused fit verdict: kernel {c['ms']} ms device ({c['call_ms']} ms "
        f"per wrapper call), over 1/3/8 lanes {json.dumps(c['lanes_ms'])} "
        f"ms, plain {c['plain_ms']} ms, bound {c['bound_ms']} ms "
        f"({c['bound_by']}: {nbytes} B); launch floor {floor_ms} ms, gather "
        f"floor (the same grid, one dependent gather a row) "
        f"{c['gather_floor_ms']} ms")

    # the whole fused evals, one call each: every kernel they run and the
    # call with its one host copy
    for name, run in (
            ("2k", lambda: cuda_kernels.fused_to_host(
                *cuda_kernels.fused_eval_depth(
                    *twins, *sel, inp["ask"], MID_COUNT, inp["feasible"],
                    inp["coll"], MID_COUNT, inp["aff"], 2 ** 30,
                    inp["jitter"], 1.5, 0.4, None, False, k_max=128,
                    depth_grid=grid128))),
            ("count-1", lambda: cuda_kernels.fused_to_host(
                *cuda_kernels.fused_eval_greedy(
                    *twins, *sel, inp["ask"], 1, inp["feasible"], 2 ** 30,
                    None, False, inp["coll"])))):
        ev = _kernel_list(torch, run)
        ev["call_ms"] = _median_ms(torch, run, CALL_REPS)
        out[f"eval_{name}"] = ev
        log(f"fused {name} eval, one call with its host copy: "
            f"{ev['call_ms']} ms; kernels {json.dumps(ev)}")
    out["moved_nodes_2k"] = moved
    return out


def _register_pinned(srv, job, eval_id: str) -> None:
    """job_register's raft entry with the eval's id pinned, so two runs
    of one eval shuffle and place alike (the stack's rng is seeded by the
    eval id)."""
    from nomad_tpu_torch.server.fsm import JOB_REGISTER
    from nomad_tpu_torch.structs import Evaluation
    srv.raft.apply(JOB_REGISTER, {"job": job, "evals": [Evaluation(
        id=eval_id, namespace="default", priority=job.priority,
        type=job.type, job_id=job.id, triggered_by="job-register",
        status="pending")]})


FUSED_METRICS = {"fused": "nomad.solver.dispatch.fused.cuda",
                 "classic": "nomad.solver.dispatch.cuda",
                 "fastpath": "nomad.plan.verdict_fastpath",
                 "dispatch_errors": "nomad.solver.dispatch_errors",
                 "cpu": "nomad.solver.dispatch.torch",
                 "cpu_fused": "nomad.solver.dispatch.fused.torch"}


def _fused_evals(torch, srv, jobs: list) -> dict:
    """Register `jobs` [(job, eval id)] back to back and wait for their
    evals: wall, nomad.plan.evaluate seconds, counter deltas, the most
    device round trips one eval counted, launch deltas."""
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import cuda_kernels
    rt = "nomad.solver.device_round_trips"
    c0 = {k: metrics.counter(v) for k, v in FUSED_METRICS.items()}
    e0 = metrics.timer_sum("nomad.plan.evaluate")
    rt0 = metrics.sample_count(rt)
    l0 = dict(cuda_kernels.LAUNCHES)
    t0 = time.perf_counter()
    for job, eval_id in jobs:
        _register_pinned(srv, job, eval_id)
    t1 = _wait_evals(srv, [e for _, e in jobs])
    torch.cuda.synchronize()
    d = {k: metrics.counter(v) - c0[k] for k, v in FUSED_METRICS.items()}
    check(d["dispatch_errors"] == 0 and d["cpu"] == d["cpu_fused"] == 0,
          f"fused run counted {d}")
    return {"wall_s": t1 - t0, "evaluate_s":
            metrics.timer_sum("nomad.plan.evaluate") - e0, "counts": d,
            "round_trips_max": metrics.percentile(rt, 1.0, skip=rt0)
            if metrics.sample_count(rt) > rt0 else None,
            "launches": {k: cuda_kernels.LAUNCHES[k] - v
                         for k, v in l0.items() if cuda_kernels.LAUNCHES[k]
                         - v}}


def _fused_run(np, torch, snapshot, fused: bool, pair: int) -> dict:
    """One leg: a fresh one-worker server over the fleet's snapshot with
    the fused route on or off; the 2k eval, the count-1 eval, then the
    stream (STREAM_JOBS jobs of STREAM_COUNT tasks back to back), every
    eval id pinned. -> each eval's measurements and the alloc -> node
    maps."""
    from nomad_tpu_torch import mock
    srv = _server(FUSED_WORKERS, snapshot=snapshot,
                  solver_fused_enabled=fused)
    out: dict = {"fused": fused, "pair": pair}
    try:
        mid = _mk_batch_job(mock, f"fu-mid-{pair}", MID_COUNT)
        out["mid"] = _fused_evals(torch, srv, [(mid, FUSED_EVAL_IDS["mid"])])
        one = _mk_batch_job(mock, f"fu-one-{pair}", 1)
        out["one"] = _fused_evals(torch, srv, [(one, FUSED_EVAL_IDS["one"])])
        stream = [(_mk_batch_job(mock, f"fu-stream-{pair}-{j}",
                                 STREAM_COUNT),
                   f"0000f05e-0000-0000-0001-{j:012d}")
                  for j in range(STREAM_JOBS)]
        out["stream"] = _fused_evals(torch, srv, stream)
        jobs = {mid.id: MID_COUNT, one.id: 1}
        jobs.update({j.id: STREAM_COUNT for j, _ in stream})
        _check_committed(srv, jobs)
        out["maps"] = {job_id: {a.name: a.node_id for a in
                                srv.state.allocs_by_job("default", job_id)}
                       for job_id in jobs}
    finally:
        _shutdown(srv)
    return out


def fused_pairs_phase(np, torch, snapshot, card: str) -> dict:
    """The fused route against the classic one through the server, in
    turns: FUSED_PAIRS pairs (on first in even pairs), each leg a fresh
    one-worker server over the 10,000-node snapshot running the 2k eval,
    the count-1 eval and the 1,000-task stream. Every eval committed, no
    row over capacity, no dispatch error or CPU solve; placements equal in
    both legs of every pair; with the route on the 2k and count-1 evals
    each take one fused dispatch on the card and one round trip, and the
    applier takes the verdict's fast path; off, none."""
    from nomad_tpu_torch.solver import cuda_kernels
    runs = []
    for pair in range(FUSED_PAIRS):
        order = (True, False) if pair % 2 == 0 else (False, True)
        legs = {}
        for fused in order:
            r = _fused_run(np, torch, snapshot, fused, pair)
            legs[fused] = r
            runs.append(r)
            for what in ("mid", "one", "stream"):
                e = r[what]
                log(f"fused pair {pair} {what} fused "
                    f"{'on' if fused else 'off'}: wall {e['wall_s']:.6f} s, "
                    f"nomad.plan.evaluate {e['evaluate_s']:.6f} s, "
                    f"verdict_fastpath {e['counts']['fastpath']}, "
                    f"dispatch.fused.cuda {e['counts']['fused']}, "
                    f"dispatch.cuda {e['counts']['classic']}, round trips "
                    f"(max an eval) {e['round_trips_max']}, launches "
                    f"{json.dumps(e['launches'])} ({card})")
        check(legs[True]["maps"] == legs[False]["maps"],
              f"fused pair {pair}: placements differ with the route on "
              f"and off")
        on, off = legs[True], legs[False]
        for what, n_evals in (("mid", 1), ("one", 1),
                              ("stream", STREAM_JOBS)):
            check(on[what]["counts"]["fused"] == n_evals and
                  off[what]["counts"]["fused"] == 0,
                  f"fused pair {pair} {what}: fused dispatches on "
                  f"{on[what]['counts']['fused']}, off "
                  f"{off[what]['counts']['fused']}")
            check(on[what]["round_trips_max"] == 1,
                  f"fused pair {pair} {what}: "
                  f"{on[what]['round_trips_max']} round trips an eval")
        check(on["mid"]["counts"]["fastpath"] > 0 and
              off["mid"]["counts"]["fastpath"] == 0,
              f"fused pair {pair}: verdict fast path on "
              f"{on['mid']['counts']['fastpath']}, off "
              f"{off['mid']['counts']['fastpath']}")
    summary = {}
    for what in ("mid", "one", "stream"):
        cell = {}
        for fused in (True, False):
            rs = [r[what] for r in runs if r["fused"] is fused]
            cell["on" if fused else "off"] = {
                "wall_s": [r["wall_s"] for r in rs],
                "median_wall_s": statistics.median(r["wall_s"] for r in rs),
                "evaluate_s": [r["evaluate_s"] for r in rs],
                "median_evaluate_s": statistics.median(
                    r["evaluate_s"] for r in rs),
                "fastpath": [r["counts"]["fastpath"] for r in rs],
                "round_trips_max": [r["round_trips_max"] for r in rs]}
        wall = {(r["pair"], r["fused"]): r[what]["wall_s"] for r in runs}
        diffs = [wall[(p, True)] - wall[(p, False)]
                 for p in range(FUSED_PAIRS)]
        wins = sum(x < 0 for x in diffs)
        cell.update(pair_diff_s=diffs, wins=wins,
                    median_pair_diff_s=statistics.median(diffs),
                    sign_test_p=_sign_test_p(wins, FUSED_PAIRS),
                    loses_p=_sign_test_p(FUSED_PAIRS - wins, FUSED_PAIRS))
        summary[what] = cell
        log(f"fused pairs {what}: median wall on "
            f"{cell['on']['median_wall_s']:.6f} s, off "
            f"{cell['off']['median_wall_s']:.6f} s; median pair diff (on - "
            f"off) {cell['median_pair_diff_s']:+.6f} s, on faster in "
            f"{wins}/{FUSED_PAIRS} (sign test p {cell['sign_test_p']:.4f}, "
            f"slower p {cell['loses_p']:.4f}); median evaluate on "
            f"{cell['on']['median_evaluate_s']:.6f} s, off "
            f"{cell['off']['median_evaluate_s']:.6f} s")
    # the classic K2 entry's launches on its path: the count-1 eval with
    # the route off (each leg's own window)
    offs = [r for r in runs if not r["fused"]]
    launches = {"score_capacity": offs[0]["one"]["launches"].get(
        "score_capacity", 0)}
    check(launches["score_capacity"] == 1,
          f"fused off: the count-1 eval launched K2 "
          f"{launches['score_capacity']} times")
    for r in runs:
        r.pop("maps")
    return {"runs": runs, "summary": summary, "launches": launches}


def _server(workers: int, snapshot: bytes = None, logs: list = None,
            **config):
    """The port's in-process Server on the card, its leadership
    established (start): restored from `snapshot` first, so establishment
    sees the cluster, and then under scheduler_algorithm tpu-batch and
    `config`. No client heartbeats reach it here: the registered nodes'
    heartbeat TTL is set past the run."""
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.structs import SchedulerConfiguration
    from nomad_tpu_torch.solver import backend
    logs = [] if logs is None else logs
    srv = Server(num_workers=workers, gc_interval=9999, logger=logs.append)
    srv.heartbeats.min_ttl = 3600.0
    if snapshot is not None:
        srv.snapshot_restore(snapshot)
    srv.start()
    config.setdefault("scheduler_algorithm", "tpu-batch")
    srv.set_scheduler_configuration(SchedulerConfiguration(**config))
    if srv.state.node_count() >= backend.WARMUP_MIN_NODES:
        # establishment's warmup runs on a thread: let it finish before
        # anything is timed
        deadline = time.monotonic() + SERVER_TIMEOUT_S
        while not any("solver warmup" in m for m in list(logs)):
            check(time.monotonic() < deadline,
                  f"no warmup at establish: {logs[:5]}")
            time.sleep(0.01)
    return srv


def _register_fleet(srv, np, n_nodes: int, seed: int) -> float:
    from nomad_tpu_torch import mock
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for i in range(n_nodes):
        srv.node_register(_mk_node(mock, i, rng))
    return time.perf_counter() - t0


def _wait_evals(srv, eval_ids, timeout: float = SERVER_TIMEOUT_S,
                done=("complete",)) -> float:
    """Wait until every eval of `eval_ids` has a status in `done` (fail on
    any other terminal status, or at the deadline); -> perf_counter at
    completion."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        evs = [srv.state.eval_by_id(i) for i in eval_ids]
        if all(e is not None and e.status in done for e in evs):
            return time.perf_counter()
        bad = [(e.job_id, e.status, e.status_description) for e in evs
               if e is not None and e.status not in done
               and e.status in ("complete", "failed", "cancelled")]
        check(not bad, f"evals ended {bad}")
        time.sleep(0.001)
    check(False, f"evals not complete after {timeout} s: "
          f"{[getattr(srv.state.eval_by_id(i), 'status', None) for i in eval_ids]}")


def _check_committed(srv, jobs: dict) -> None:
    """Every job's instances committed (desired run), no usage row over
    capacity."""
    for job_id, count in jobs.items():
        live = sum(1 for a in srv.state.allocs_by_job("default", job_id)
                   if a.desired_status == "run")
        check(live == count, f"{job_id}: committed {live}/{count}")
    view = srv.state.usage.view()
    over = int((view.used > view.cap + 1e-3).any(axis=1).sum())
    check(over == 0, f"{over} usage rows over capacity")


def _shutdown(srv) -> None:
    """Stop the server; a worker finishes the eval it is in first."""
    srv.shutdown()
    for w in srv.workers:
        w.join(SERVER_TIMEOUT_S)
        check(not w._thread or not w._thread.is_alive(),
              f"worker {w.id} still running after shutdown")


def server_phase(np, torch, card: str) -> dict:
    """The port as a server on the card: the 50k eval through
    Server.job_register and a worker, then a restart from a snapshot
    (establishment reseeds the state cache and warms every kernel), a 2k
    eval that builds and loads nothing, and the debug bundle."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import cuda_kernels, state_cache
    out: dict = {}
    srv = _server(4)
    try:
        out["register_s"] = _register_fleet(srv, np, N_LIVE, 42)
        nodes_only = srv.snapshot_save()
        timers0 = {k: metrics.timer_sum(k) for k in LAYERS + PIPE_TIMERS}
        counters0 = {k: metrics.counter(v) for k, v in COUNTERS.items()}
        cuda_kernels.reset_launches()            # this path's window
        t0 = time.perf_counter()
        eval_id = srv.job_register(
            _mk_batch_job(mock, "srv-big", BIG_COUNT))["eval_id"]
        t1 = _wait_evals(srv, [eval_id])
        launches = dict(cuda_kernels.LAUNCHES)   # read just after
        torch.cuda.synchronize()
        _check_committed(srv, {"srv-big": BIG_COUNT})
        counters = {k: metrics.counter(v) - counters0[k]
                    for k, v in COUNTERS.items()}
        bad = {k: counters[k] for k in CARD_ZERO if counters[k]}
        check(not bad, f"server 50k eval counted {bad}")
        check(launches["depth_curve"] == BIG_CHUNKS,
              f"server 50k eval: depth_curve launched "
              f"{launches['depth_curve']} times")
        out.update(wall_s=t1 - t0, launches=launches,
                   layers_s={k.split(".", 1)[1]: metrics.timer_sum(k) - v
                             for k, v in timers0.items()},
                   counters=counters)
        log(f"server: {N_LIVE} nodes registered through node_register in "
            f"{out['register_s']:.3f} s; the 50k job through job_register "
            f"and a worker: {BIG_COUNT} committed, 0 rows over capacity, "
            f"register -> last commit {out['wall_s']} s ({card}); layers "
            f"{json.dumps(out['layers_s'])}; launches {json.dumps(launches)}")
        snap = srv.snapshot_save()
    finally:
        _shutdown(srv)

    # a restart: a fresh server over the snapshot; the kernels' libraries
    # are dropped from the process first, so the warmup has to load them
    logs: list = []
    cuda_kernels._fns.clear()
    warm0 = metrics.counter("nomad.solver.warmup.artifacts")
    errs0 = metrics.counter("nomad.solver.warmup.errors")
    srv = _server(4, snapshot=snap, logs=logs)
    try:
        deadline = time.monotonic() + SERVER_TIMEOUT_S
        while metrics.counter("nomad.solver.warmup.artifacts") == warm0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        seeded = [m for m in logs if "state cache" in m]
        stats = state_cache.cache().stats()
        check(seeded and str(N_LIVE) in seeded[0],
              f"establish did not reseed the state cache: {logs[:5]}")
        check(metrics.counter("nomad.solver.warmup.errors") == errs0,
              f"warmup errors: {logs}")
        warm = [m for m in logs if "solver warmup" in m]
        check(warm, f"no warmup at establish: {logs[:5]}")
        out["warmup_s"] = metrics.snapshot()["gauges"].get(
            "nomad.solver.warmup.seconds")
        out["warmup_artifacts"] = metrics.counter(
            "nomad.solver.warmup.artifacts") - warm0
        loads0, misses0 = len(cuda_kernels._fns), metrics.counter(
            "nomad.compile_cache.misses")
        t0 = time.perf_counter()
        eval_id = srv.job_register(
            _mk_batch_job(mock, "srv-mid", MID_COUNT))["eval_id"]
        out["restart_2k_wall_s"] = _wait_evals(srv, [eval_id]) - t0
        _check_committed(srv, {"srv-big": BIG_COUNT, "srv-mid": MID_COUNT})
        check(len(cuda_kernels._fns) == loads0 and metrics.counter(
            "nomad.compile_cache.misses") == misses0,
            "the 2k eval after the warmup built or loaded a kernel")
        bundle = srv.operator_debug_bundle()
        rt = bundle["DeviceRuntime"]
        check(rt["devices"] and rt["devices"][0]["kind"] ==
              torch.cuda.get_device_name(0),
              f"debug bundle devices {rt['devices']}")
        check(bundle["Mesh"]["Shards"] == 1, f"mesh {bundle['Mesh']}")
        check(all(v == "closed" for v in bundle["Breakers"].values()),
              f"breakers {bundle['Breakers']}")
        check(bundle["StateCache"]["rows"] >= N_LIVE,
              f"state cache {bundle['StateCache']}")
        out.update(reseed=seeded[0], cache=stats, device_runtime=rt,
                   mesh=bundle["Mesh"], breakers=bundle["Breakers"])
        log(f"server restart: {seeded[0]!r}; {warm[0]!r} (warmup "
            f"{out['warmup_s']} s, {out['warmup_artifacts']} artifacts); "
            f"the 2k eval then built and loaded no kernel "
            f"({out['restart_2k_wall_s']} s register -> commit)")
        log(f"server debug bundle: DeviceRuntime {json.dumps(rt)}; Mesh "
            f"{json.dumps(bundle['Mesh'])}; Breakers "
            f"{json.dumps(bundle['Breakers'])}; StateCache rows "
            f"{bundle['StateCache']['rows']}")
    finally:
        _shutdown(srv)
    out["nodes_snapshot"] = nodes_only
    return out


def _stream_run(np, torch, snapshot, count: int, batch: bool,
                fused: bool = True) -> dict:
    """STREAM_JOBS jobs of `count` tasks registered back to back on a
    fresh 10,000-node server with STREAM_WORKERS workers, the whole-eval
    fused route on or off (its coalesced windows are then the fused
    lanes or the classic lanes entry)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import cuda_kernels
    mb = ("dispatches", "solo", "early_fire")
    srv = _server(STREAM_WORKERS, snapshot=snapshot,
                  eval_batch_enabled=batch, solver_fused_enabled=fused)
    try:
        jobs = [_mk_batch_job(mock, f"stream-{count}-{batch:d}-{j}", count)
                for j in range(STREAM_JOBS)]
        skip = metrics.sample_count("nomad.worker.submit_plan")
        size0 = metrics.sample_count("nomad.solver.microbatch.size")
        wait0 = metrics.sample_count("nomad.solver.microbatch.leader_wait")
        c0 = {k: metrics.counter(f"nomad.solver.microbatch.{k}") for k in mb}
        errs0 = metrics.counter("nomad.solver.dispatch_errors")
        cpu0 = _cpu_solves(metrics)
        cuda_kernels.reset_launches()            # this path's window
        t0 = time.perf_counter()
        ids = [srv.job_register(j)["eval_id"] for j in jobs]
        t1 = _wait_evals(srv, ids)
        launches = dict(cuda_kernels.LAUNCHES)   # read just after
        _check_committed(srv, {j.id: count for j in jobs})
        check(metrics.counter("nomad.solver.dispatch_errors") == errs0 and
              _cpu_solves(metrics) == cpu0,
              "the stream counted a dispatch error or a CPU solve")
        sizes = metrics.samples["nomad.solver.microbatch.size"].raw_window(
            size0) if size0 < metrics.sample_count(
            "nomad.solver.microbatch.size") else []
        waits = metrics.samples[
            "nomad.solver.microbatch.leader_wait"].raw_window(wait0) \
            if wait0 < metrics.sample_count(
                "nomad.solver.microbatch.leader_wait") else []
        r = {"count": count, "batch": batch, "wall_s": t1 - t0,
             "evals_per_s": STREAM_JOBS / (t1 - t0),
             "submit_plan_p50_s": metrics.percentile(
                 "nomad.worker.submit_plan", 0.5, skip),
             "submit_plan_p99_s": metrics.percentile(
                 "nomad.worker.submit_plan", 0.99, skip),
             "microbatch": {k: metrics.counter(
                 f"nomad.solver.microbatch.{k}") - c0[k] for k in mb},
             "window_sizes": sizes,
             "leader_wait_s": statistics.median(waits) if waits else None,
             "launches": launches}
    finally:
        _shutdown(srv)
    return r


def _sign_test_p(wins: int, pairs: int) -> float:
    """One-sided sign test: the chance of `wins` or more wins in `pairs`
    fair coin flips."""
    return sum(math.comb(pairs, k) for k in range(wins, pairs + 1)) / \
        2 ** pairs


def stream_phase(np, torch, snapshot, card: str,
                 pairs: int = STREAM_PAIRS,
                 counts: tuple = STREAM_COUNTS, fused: bool = True) -> dict:
    """The eval stream on a 10,000-node server: 16 jobs registered back
    to back, `pairs` pairs of runs with micro-batching on and off (on
    first in even pairs, off first in odd ones), at each of `counts`
    (the batch tier's sweep by default); every instance placed, no
    node over capacity. During the sweep the batch tier's count ceiling
    is raised to the count under test, so each `on` run can coalesce. A
    count qualifies where the coalesced run was faster in enough pairs
    for a one-sided sign test at STREAM_P; the pick is the largest count
    that qualifies, else 0."""
    from nomad_tpu_torch.solver import backend
    runs = []
    ceiling = backend.BATCH_MAX_COUNT
    try:
        for count in counts:
            backend.BATCH_MAX_COUNT = count
            for pair in range(pairs):
                order = (True, False) if pair % 2 == 0 else (False, True)
                for batch in order:
                    r = _stream_run(np, torch, snapshot, count, batch,
                                    fused)
                    r["pair"] = pair
                    runs.append(r)
                    log(f"stream count {count} pair {pair} batch "
                        f"{'on' if batch else 'off'}: {STREAM_JOBS} evals "
                        f"in {r['wall_s']:.4f} s, {r['evals_per_s']:.3f} "
                        f"evals/s; submit_plan p50 "
                        f"{r['submit_plan_p50_s']:.5f} s p99 "
                        f"{r['submit_plan_p99_s']:.5f} s; microbatch "
                        f"{json.dumps(r['microbatch'])} sizes "
                        f"{r['window_sizes']} leader wait "
                        f"{r['leader_wait_s']}; launches "
                        f"{json.dumps(r['launches'])} ({card})")
    finally:
        backend.BATCH_MAX_COUNT = ceiling
    main = [r for r in runs if r["count"] == STREAM_COUNT and r["batch"]]
    # the windows' lanes entry: the classic one, or the fused route's
    # gather entry (which fused solo solves launch too: count windows)
    if fused:
        lanes = sum(r["microbatch"]["dispatches"] for r in main)
    else:
        lanes = sum(r["launches"]["depth_curve_lanes"] for r in main)
    check(lanes >= 1, f"the stream at {STREAM_COUNT} launched the lane "
          f"entry {lanes} times")
    summary = {}
    for count in counts:
        cell = {}
        for batch in (True, False):
            rs = [r for r in runs if r["count"] == count
                  and r["batch"] == batch]
            cell["on" if batch else "off"] = {
                "evals_per_s": [r["evals_per_s"] for r in rs],
                "median_eval_wall_s": statistics.median(
                    r["wall_s"] for r in rs) / STREAM_JOBS,
                "submit_plan_p50_s": [r["submit_plan_p50_s"] for r in rs],
                "submit_plan_p99_s": [r["submit_plan_p99_s"] for r in rs]}
        wall = {(r["pair"], r["batch"]): r["wall_s"] for r in runs
                if r["count"] == count}
        diffs = [(wall[(p, True)] - wall[(p, False)]) / STREAM_JOBS
                 for p in range(pairs)]
        wins = sum(d < 0 for d in diffs)
        cell.update(pair_diff_s=diffs, wins=wins,
                    median_pair_diff_s=statistics.median(diffs),
                    sign_test_p=_sign_test_p(wins, pairs))
        cell["qualifies"] = cell["sign_test_p"] <= STREAM_P
        summary[count] = cell
    qualified = [c for c in counts if summary[c]["qualifies"]]
    pick = max(qualified) if qualified else 0
    log(f"stream: per-eval wall on - off, median over {pairs} pairs; "
        f"coalesced faster in: "
        + "; ".join(f"{c}: {summary[c]['median_pair_diff_s']:+.5f} s, "
                    f"{summary[c]['wins']}/{pairs} "
                    f"(p {summary[c]['sign_test_p']:.4f})"
                    for c in counts)
        + f"; counts that qualify at p <= {STREAM_P}: {qualified}, pick "
          f"{pick} (in the code: {backend.BATCH_MAX_COUNT})")
    return {"runs": runs, "summary": summary, "batch_max_count_pick": pick,
            "launches": {"depth_curve_lanes": lanes}}


def _rejection_run(np, torch, snapshot, algorithm: str) -> dict:
    """8 jobs of 1,000 tasks (cpu 400, mem 700; bench.py
    `_concurrent_rejection_rate`) registered at once on a 2,000-node
    server with 8 workers. Each plan and its PlanResult is recorded by
    wrapping the server's planner instance.

    A batch eval whose plans are rejected on both of its attempts
    (scheduler MAX_BATCH_SCHEDULE_ATTEMPTS, 2, as in the reference and
    Nomad) ends `failed` with its remainder parked in a blocked eval,
    which nothing in the run releases (the reference has no periodic
    unblock of such evals). So each job is held to: every instance
    committed, or the eval failed on plan conflicts with a blocked eval
    holding the rest; never more than its count, each name once; no
    eval taken back by the broker's nack timeout from the worker still
    scheduling it; and no node over capacity. The instances left
    unplaced are counted and reported."""
    from nomad_tpu_torch import mock
    srv = _server(REJECT_WORKERS, snapshot=snapshot,
                  scheduler_algorithm=algorithm)
    records = []
    submit = srv.planner.submit_plan

    def recorded(plan, *a, **kw):
        result = submit(plan, *a, **kw)
        records.append((plan, result))
        return result
    srv.planner.submit_plan = recorded
    timed_out = []
    sweep = srv.eval_broker.check_nack_timeouts

    def swept():
        out = sweep()
        timed_out.extend(out)
        return out
    srv.eval_broker.check_nack_timeouts = swept
    try:
        jobs = [_mk_batch_job(mock, f"rej-{algorithm}-{j}", REJECT_COUNT,
                              cpu=400, mem=700) for j in range(REJECT_JOBS)]
        t0 = time.perf_counter()
        ids = [srv.job_register(j)["eval_id"] for j in jobs]
        t1 = _wait_evals(srv, ids, REJECT_TIMEOUT_S,
                         done=("complete", "failed"))
        placed, failed = {}, 0
        for job, eval_id in zip(jobs, ids):
            names = [a.name for a in srv.state.allocs_by_job("default",
                                                             job.id)
                     if a.desired_status == "run"]
            placed[job.id] = len(names)
            check(len(set(names)) == len(names) <= REJECT_COUNT,
                  f"{job.id}: {len(names)} allocations for a count of "
                  f"{REJECT_COUNT}, {len(set(names))} names")
            if placed[job.id] == REJECT_COUNT:
                continue
            ev = srv.state.eval_by_id(eval_id)
            held = [e for e in srv.state.iter_evals()
                    if e.job_id == job.id and e.status == "blocked"]
            check(ev.status == "failed" and
                  ev.status_description == "maximum attempts reached" and
                  held, f"{job.id}: {placed[job.id]}/{REJECT_COUNT} placed, "
                  f"eval {ev.status} ({ev.status_description}), "
                  f"{len(held)} blocked evals")
            failed += 1
        view = srv.state.usage.view()
        over = int((view.used > view.cap + 1e-3).any(axis=1).sum())
        check(over == 0, f"{over} usage rows over capacity")
        check(not timed_out, f"evals taken back by the nack timeout "
              f"mid-schedule: {timed_out}")
    finally:
        _shutdown(srv)
    rn = tn = ra = ta = 0
    for plan, result in records:
        if result is None:
            continue
        tn += len(plan.node_allocation)
        rn += len(result.rejected_nodes)
        ta += sum(len(v) for v in plan.node_allocation.values())
        ra += sum(len(plan.node_allocation[n]) for n in result.rejected_nodes
                  if n in plan.node_allocation)
    return {"algorithm": algorithm, "plans": len(records),
            "node_rejection_rate": rn / tn if tn else 0.0,
            "alloc_rejection_rate": ra / ta if ta else 0.0,
            "rejected_nodes": rn, "plan_nodes": tn, "wall_s": t1 - t0,
            "failed_evals": failed, "nack_timeouts": len(timed_out),
            "unplaced": REJECT_JOBS * REJECT_COUNT - sum(placed.values())}


def rejection_phase(np, torch, card: str) -> dict:
    srv = _server(0)
    try:
        _register_fleet(srv, np, REJECT_NODES, 7)
        snap = srv.snapshot_save()
    finally:
        _shutdown(srv)
    out = {}
    for algorithm in ("tpu-batch", "binpack"):
        r = out[algorithm] = _rejection_run(np, torch, snap, algorithm)
        log(f"rejections {algorithm}: {REJECT_JOBS} x {REJECT_COUNT} tasks "
            f"on {REJECT_NODES} nodes, {REJECT_WORKERS} workers: "
            f"{r['failed_evals']} evals failed on plan conflicts, "
            f"{r['unplaced']} instances left to their blocked evals, "
            f"{r['nack_timeouts']} nack timeouts; "
            f"{r['plans']} plans, node rejection rate "
            f"{r['node_rejection_rate']:.5f} ({r['rejected_nodes']}/"
            f"{r['plan_nodes']}), alloc rejection rate "
            f"{r['alloc_rejection_rate']:.5f}, wall {r['wall_s']:.3f} s "
            f"({card})")
    return out


def server_fault_phase(np, torch, snapshot) -> dict:
    """A fault fires once at `solver.dispatch.cuda` under a 2,000-task
    eval on a 10,000-node server: the worker nacks it, the broker
    redelivers it, and the second delivery commits everything; one
    dispatch error, one eval failure, no solve on the CPU."""
    from nomad_tpu_torch import faults, mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import backend
    names = {"dispatch_errors": "nomad.solver.dispatch_errors.cuda",
             "fused_errors": "nomad.solver.dispatch_errors.fused",
             "eval_failures": "nomad.worker.eval_failures",
             "cpu_solves": "nomad.solver.dispatch.torch",
             "cpu_fused_solves": "nomad.solver.dispatch.fused.torch"}
    srv = _server(4, snapshot=snapshot)
    try:
        srv.eval_broker.initial_nack_delay = 0.05
        c0 = {k: metrics.counter(v) for k, v in names.items()}
        faults.install({"solver.dispatch.cuda": {"mode": "raise",
                                                 "times": 1}})
        t0 = time.perf_counter()
        eval_id = srv.job_register(
            _mk_batch_job(mock, "faulted", MID_COUNT))["eval_id"]
        t1 = _wait_evals(srv, [eval_id])
        _check_committed(srv, {"faulted": MID_COUNT})
        d = {k: metrics.counter(v) - c0[k] for k, v in names.items()}
        # the 2k eval takes the fused route, whose dispatch fires the
        # tier's fault site too
        check(d["dispatch_errors"] == 1 and d["fused_errors"] == 1 and
              d["eval_failures"] == 1 and d["cpu_solves"] == 0 and
              d["cpu_fused_solves"] == 0, f"server fault counted {d}")
    finally:
        faults.clear()
        backend.reset()
        _shutdown(srv)
    log(f"server fault: solver.dispatch.cuda raised once under the 2k eval;"
        f" the worker nacked it, the broker redelivered it, the second "
        f"delivery committed {MID_COUNT} in {t1 - t0:.3f} s after "
        f"register; counts {json.dumps(d)}")
    return {"counts": d, "wall_s": t1 - t0}


# the convex phase: the server's convex job (below the pipeline's 8,192,
# so the serial route takes it, as the reference's does), the runs in
# turns against tpu-batch, and the faulted job
CONVEX_COUNT = 5_000
CONVEX_ORDER = ("convex", "tpu-batch", "tpu-batch", "convex")
CONVEX_TIMED = ("bench_binpack", "bench_spread", "bench_binpack_deep",
                "bench_spread_deep")
# float32 operations a row of the convex solve needs (the reference's
# loop; an add, multiply, divide, floor, min or max is one, a fused
# multiply-add two, a 10**x one): its inputs once (capacity 20, score 10,
# cost 2, the sum of u and the start 4, the start's objective 7: 43),
# then each iteration the gradient step 7, the bracket 4, 50 halvings of
# 4 and the projection 3, the objective 7: 221. The kernel sums the
# midpoints it does not take as well (7 a round of 3 halvings); the
# bound counts the loop's work, whatever the kernel computes
# speculatively, so it reads the same before and after.
CONVEX_OPS_ROW = 43
CONVEX_OPS_ROW_ITER = 221


def _convex_bound(b: int, iters: int) -> dict:
    """The least time for one convex solve of `b` rows and `iters`
    iterations: cap, used, ask, feasible, collisions and affinity read
    once; the iterate, u and cost written once; the operations above."""
    nbytes = b * (2 * 5 * 4 + 1 + 4 + 4) + 5 * 4 + b * 3 * 4 + 16
    ops = b * (CONVEX_OPS_ROW + iters * CONVEX_OPS_ROW_ITER)
    out = _bound(nbytes, ops)
    out.update(bytes=nbytes, ops=ops)
    return out


def _convex_args(np, torch, dev, name) -> tuple:
    """testing.CONVEX_CASES[name] on the card: (convex_solve's args,
    convex_eval's args, spread, the host cap, used and ask)."""
    from nomad_tpu_torch.testing import convex_fixture
    cap, used, feas, coll, ask, count, kw = convex_fixture(name)
    b = cap.shape[0]
    aff = kw["affinity_boost"]
    aff = np.zeros(b, np.float32) if aff is None else aff

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    knobs = (kw["max_iters"], kw["tolerance"], kw["fairness_weight"],
             kw["quota_budget"])
    solve = (t(cap), t(used), t(ask), t(feas), t(coll), t(aff), count,
             kw["max_per_node"], *knobs)
    evals = (t(cap), t(used), t(np.arange(b, dtype=np.int32)),
             t(np.ones(b, bool)), t(ask), count, t(feas),
             kw["max_per_node"], t(aff), t(coll), None, False, *knobs)
    return solve, evals, kw["spread_algorithm"], (cap, used, ask)


def _convex_reductions(iters: int, prior: bool = False) -> int:
    """Cluster reductions of a convex solve of `iters` iterations: csrc/
    convex_solve.cu's (sum u, the start's objective with the first
    bracket, then an iteration's 17 rounds of 3 halvings, the last of 2,
    and one objective-and-bracket reduction), or, with `prior`, the
    one-halving design it replaced (sum u, the start's objective, then
    an iteration's bracket, 50 halvings and objective)."""
    from nomad_tpu_torch.solver import convex
    if prior:
        return 2 + iters * (convex.PROJECT_ITERS + 2)
    return 2 + iters * (-(-convex.PROJECT_ITERS // 3) + 1)


def _convex_solves_equal(torch, got, want) -> bool:
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            return False
    return True


def convex_kernel_phase(np, torch, dev, floor_ms) -> dict:
    """(a) The convex-solve kernel against its plain version on the card
    on every testing.CONVEX_CASES fixture: bench.py `_convex_run`'s
    cluster (10,000 nodes, 16,384 rows, count 3,000, fairness 0.05),
    binpack and spread, at tolerance 1e-4 and at 1e-9 (the loop runs
    until the objective stops moving), a 128-row spread case that runs
    all 200 iterations, the 65,536-row bucket (rows in shared memory) and
    the 131,072-row one (global scratch), the fuzzed edge cases (budget 0
    by count and by capacity among them): iterate, u, cost, budget,
    iterations and gap bit-equal; the whole eval (kernel, K2's greedy
    entry, torch tail) placing as the plain eval, with one launch of each
    kernel and 0 rows over capacity in the host AllocsFit re-walk. On the
    timed cases: device ms (profiler; queued events beside it), per-call
    ms, the plain version's ms, the bound and the dependency floor
    (cluster reductions x one cluster barrier of the solve's shape, from
    an empty loop of BARRIER_STEPS), beside the one-halving design's
    reduction count."""
    from nomad_tpu_torch.solver import convex, cuda_kernels
    from nomad_tpu_torch.testing import CONVEX_CASES
    out: dict = {}
    barrier_ms = _queued_ms(torch, lambda: cuda_kernels.cluster_barrier(
        BARRIER_STEPS, dev, threads=1024), 5) / BARRIER_STEPS
    for name in CONVEX_TIMED + ("small_spread_deep",):
        check(name in CONVEX_CASES, f"no convex fixture {name}")
    for name in CONVEX_CASES:
        solve, evals, spread, (cap, used, ask) = _convex_args(
            np, torch, dev, name)

        def run():
            return cuda_kernels.convex_solve(*solve, spread_algorithm=spread)
        got, want = run(), convex.convex_solve_ref(
            *solve, spread_algorithm=spread)
        torch.cuda.synchronize()
        err = float((got[0] - want[0]).abs().max())
        check(_convex_solves_equal(torch, got, want),
              f"convex {name}: the kernel's solve differs from plain")
        k0 = dict(cuda_kernels.LAUNCHES)
        card = convex.to_host(cuda_kernels.convex_eval_fused(
            *evals, spread_algorithm=spread))
        per_eval = {k: cuda_kernels.LAUNCHES[k] - k0[k]
                    for k in ("convex_solve", "score_capacity")}
        plain = convex.to_host(convex.convex_eval(
            *evals, spread_algorithm=spread))
        check(np.array_equal(card[0], plain[0]) and
              np.array_equal(card[1], plain[1]) and card[2] == plain[2]
              and card[4] == plain[4] and abs(card[3] - plain[3]) <= 1e-6,
              f"convex {name}: card eval {card[2:]} against plain "
              f"{plain[2:]}")
        check(per_eval == {"convex_solve": 1, "score_capacity": 1},
              f"convex {name}: launches per eval {per_eval}")
        post = used + card[0][:, None].astype(np.float32) * ask[None, :]
        over = int((post > cap + 1e-3).any(axis=1).sum())
        check(over == 0, f"convex {name}: {over} rows over capacity")
        iters = card[2]
        r = {"rows": int(cap.shape[0]), "iterations": iters,
             "gap": float(card[3]), "won": card[4],
             "placed": int(card[0].sum()), "budget": int(want[3]),
             "launches_per_eval": per_eval, "violations": over,
             "max_abs_err": err}
        if name not in CONVEX_TIMED + ("small_spread_deep",):
            log(f"convex {name} ({r['rows']} rows): kernel = plain bit for "
                f"bit; {iters} iterations, budget {r['budget']}, placed "
                f"{r['placed']}, won {r['won']}, 0 rows over capacity, "
                f"launches per eval {json.dumps(per_eval)}")
            out[name] = r
            continue
        r.update(reductions=_convex_reductions(iters),
                 reductions_prior=_convex_reductions(iters, prior=True),
                 floor_ms=floor_ms, barrier_ms=barrier_ms)
        r["dependency_floor_ms"] = r["reductions"] * barrier_ms
        r.update(_convex_bound(cap.shape[0], iters))
        if name in CONVEX_TIMED:
            r.update(_times(torch, "convex_solve", run))
            r["queued_ms"] = _queued_ms(torch, run)
        else:
            r["ms"] = r["queued_ms"] = _queued_ms(torch, run, 3)
            r["timing"] = "queued events"
        if name == "bench_binpack":
            r["plain_ms"] = _median_ms(torch, lambda: convex.convex_solve_ref(
                *solve, spread_algorithm=spread), 3)
            ev = _kernel_list(torch, lambda: convex.to_host(
                cuda_kernels.convex_eval_fused(
                    *evals, spread_algorithm=spread)))
            r["eval_kernels"], r["eval_device_ms"] = (ev["kernels"],
                                                      ev["device_ms"])
            r["eval_call_ms"] = _median_ms(torch, lambda: convex.to_host(
                cuda_kernels.convex_eval_fused(
                    *evals, spread_algorithm=spread)), 30)
        log(f"convex {name}: kernel = plain bit for bit; {iters} "
            f"iterations, gap {r['gap']}, won {r['won']}, placed "
            f"{r['placed']}, 0 rows over capacity, launches per eval "
            f"{json.dumps(per_eval)}; {r['ms']} ms device per solve "
            f"(queued {r['queued_ms']}; {r.get('timing')}), "
            f"{r.get('call_ms')} ms per call, "
            f"plain {r.get('plain_ms')} ms; bound {r['bound_ms']} ms "
            f"({r['bound_by']}: {r['bytes']} B, {r['ops']} ops); "
            f"dependency floor {r['dependency_floor_ms']} ms "
            f"({r['reductions']} cluster reductions x "
            f"{barrier_ms * 1e3} us barrier; the one-halving design "
            f"{r['reductions_prior']})")
        out[name] = r
    b = out["bench_binpack"]
    log(f"convex eval on the card (bench_binpack): {b['eval_device_ms']} ms "
        f"device, {b['eval_call_ms']} ms per call with its one host copy; "
        f"kernels {json.dumps(b['eval_kernels'])}")
    return out


def convex_server_phase(np, torch, snapshot) -> dict:
    """(b) scheduler_algorithm "convex" set through the operator API on a
    10,000-node server (4 workers, explain on), a 5,000-task batch job
    under it and under tpu-batch in turns (CONVEX_ORDER): every instance
    committed, 0 rows over capacity; a convex eval counts 1 convex
    dispatch, 1 device round trip, 1 convex-solve launch and 1 K2 launch,
    0 solves on the CPU, 0 dispatch errors; the warmup's convex block
    runs first, as establishment under a convex config would. (c)
    solver.dispatch.convex faulted once under a 2,000-task convex eval:
    the worker nacks it, the broker redelivers it, the second delivery
    commits everything in one plan (nothing of the faulted solve
    committed); 1 convex dispatch error, 1 eval failure, 0 CPU solves."""
    from nomad_tpu_torch import faults, mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import backend, cuda_kernels
    from nomad_tpu_torch.structs import SchedulerConfiguration
    names = {"convex": "nomad.solver.dispatch.convex",
             "dispatch_errors": "nomad.solver.dispatch_errors",
             "cpu_solves": "nomad.solver.dispatch.torch",
             "cpu_fused_solves": "nomad.solver.dispatch.fused.torch",
             "eval_failures": "nomad.worker.eval_failures",
             "convex_errors": "nomad.solver.dispatch_errors.convex"}
    rt_name = "nomad.solver.device_round_trips"
    out: dict = {"runs": []}
    jobs: dict = {}
    srv = _server(4, snapshot=snapshot, scheduler_algorithm="convex")
    try:
        # what establishment runs under a "convex" config (this server
        # was established under the snapshot's tpu-batch one): the warmup
        # with its convex block, so no timed eval loads a kernel
        a0 = metrics.counter("nomad.solver.warmup.artifacts")
        warm = backend.warmup(srv.state.node_count(),
                              cfg=SchedulerConfiguration(
                                  scheduler_algorithm="convex"))
        # 9 classic, 7 fused, 2 convex artifacts
        check(metrics.counter("nomad.solver.warmup.artifacts") - a0 == 18,
              f"convex warmup: {warm}")
        out["warmup"] = warm
        for i, alg in enumerate(CONVEX_ORDER):
            srv.set_scheduler_configuration(
                SchedulerConfiguration(scheduler_algorithm=alg))
            c0 = {k: metrics.counter(v) for k, v in names.items()}
            rt0 = metrics.sample_count(rt_name)
            cuda_kernels.reset_launches()        # this eval's window
            t0 = time.perf_counter()
            job_id = f"cvx-{i}"
            eval_id = srv.job_register(
                _mk_batch_job(mock, job_id, CONVEX_COUNT))["eval_id"]
            t1 = _wait_evals(srv, [eval_id])
            launches = dict(cuda_kernels.LAUNCHES)   # read just after
            jobs[job_id] = CONVEX_COUNT
            _check_committed(srv, jobs)
            d = {k: metrics.counter(v) - c0[k] for k, v in names.items()}
            rts = (metrics.percentile(rt_name, 0.0, skip=rt0),
                   metrics.percentile(rt_name, 1.0, skip=rt0))
            rec = _explain_record(eval_id)
            check(rec["placed_total"] == CONVEX_COUNT,
                  f"{job_id}: explain placed_total {rec['placed_total']}")
            check(d["cpu_solves"] == d["cpu_fused_solves"] == 0 and
                  d["dispatch_errors"] == 0,
                  f"{job_id} ({alg}) counted {d}")
            want = 1 if alg == "convex" else 0
            check(d["convex"] == want and launches["convex_solve"] == want,
                  f"{job_id} ({alg}): {d['convex']} convex dispatches, "
                  f"{launches['convex_solve']} convex_solve launches")
            if alg == "convex":
                check(metrics.sample_count(rt_name) - rt0 == 1 and
                      rts == (1, 1), f"{job_id}: round trips {rts}")
                check(launches["score_capacity"] == 1,
                      f"{job_id}: K2 launched {launches['score_capacity']}")
            run = {"algorithm": alg, "wall_s": t1 - t0, "counts": d,
                   "round_trips": rts[1], "launches": launches,
                   "iterations": metrics.snapshot()["gauges"].get(
                       "nomad.solver.convex.iterations")}
            out["runs"].append(run)
            log(f"convex server: {job_id} under {alg}: {CONVEX_COUNT} "
                f"committed, 0 rows over capacity, register -> commit "
                f"{run['wall_s']} s, {rts[1]} round trips, launches "
                f"{json.dumps(launches)}, counts {json.dumps(d)}")
        for alg in ("convex", "tpu-batch"):
            out[f"{alg}_wall_s"] = [r["wall_s"] for r in out["runs"]
                                    if r["algorithm"] == alg]
        out["launches"] = {k: sum(r["launches"][k] for r in out["runs"]
                                  if r["algorithm"] == "convex")
                           for k in ("convex_solve", "score_capacity")}

        # (c) a faulted convex dispatch: nacked, redelivered, committed
        srv.set_scheduler_configuration(
            SchedulerConfiguration(scheduler_algorithm="convex"))
        srv.eval_broker.initial_nack_delay = 0.05
        c0 = {k: metrics.counter(v) for k, v in names.items()}
        faults.install({"solver.dispatch.convex": {"mode": "raise",
                                                   "times": 1}})
        t0 = time.perf_counter()
        eval_id = srv.job_register(
            _mk_batch_job(mock, "cvx-faulted", MID_COUNT))["eval_id"]
        t1 = _wait_evals(srv, [eval_id])
        jobs["cvx-faulted"] = MID_COUNT
        _check_committed(srv, jobs)
        d = {k: metrics.counter(v) - c0[k] for k, v in names.items()}
        plans = {a.create_index for a in
                 srv.state.allocs_by_job("default", "cvx-faulted")}
        check(d["convex_errors"] == 1 and d["eval_failures"] == 1 and
              d["cpu_solves"] == 0 and d["convex"] == 1 and
              len(plans) == 1, f"convex fault counted {d}, {len(plans)} "
              f"commits")
        out["fault"] = {"counts": d, "wall_s": t1 - t0}
        log(f"convex fault: solver.dispatch.convex raised once under a "
            f"{MID_COUNT}-task convex eval; the worker nacked it, the "
            f"broker redelivered it, the second delivery committed "
            f"{MID_COUNT} in one plan, {t1 - t0:.3f} s after register; "
            f"counts {json.dumps(d)}")
    finally:
        faults.clear()
        backend.reset()
        _shutdown(srv)
    return out


# ----------------------------------------------------- the raft slice

# three Raft servers in this process on one in-memory network, a durable
# WAL each at raft_fsync = always (the default) with group commit on
RAFT_SERVERS, RAFT_WORKERS, RAFT_SEED = 3, 4, 9
# bench.py's election timeout for in-process clusters under load
# (bench.py:1208), the heartbeat of tests/test_raft.py's DISK profile: a
# server's log compaction (an FSM snapshot written and fsync'd under its
# raft lock, every 8,192 entries) at 10,000 nodes, or a 50k eval holding
# the interpreter, must not outlast it. With DISK's 1.2-2.4 s a follower
# campaigned during the fleet's registration on the H100's host.
RAFT_TIMING = dict(election_timeout=(6.0, 12.0), heartbeat_interval=0.15)
# the fleet's registrations: concurrent writers (bench.py
# _write_storm_run's shape), so group commit batches their fsyncs
RAFT_WRITERS = 16
# the 50k job through consensus against the in-memory log, in turns; the
# second job of each side lands on the fleet the first one filled
RAFT_ORDER = (("raft", "raft-a"), ("memory", "raft-a"),
              ("memory", "raft-b"), ("raft", "raft-b"))
# the 2k job after the failover, under one eval id on the new leader and
# on a fresh server built from its snapshot
RAFT_EVAL_ID = "0000feed-beef-0000-0000-00000000c0de"
RAFT_SAMPLES = ("nomad.raft.apply_wait", "nomad.raft.batch_entries",
                "nomad.raft.replicate_batch_entries")
RAFT_SWALLOWED = ("nomad.swallowed_errors.state_cache.standby_feed",
                  "nomad.swallowed_errors.state_cache.note_commit")
RAFT_CACHE = ("reseeds", "promote_warm", "twin_seeds", "hits", "misses",
              "commit_feeds")


def _raft_server(net, name: str, logs: dict):
    """A port Server on the virtual network; its log lines, stamped with
    perf_counter, in logs[name]."""
    from nomad_tpu_torch.server import Server
    lines = logs.setdefault(name, [])
    srv = Server(num_workers=RAFT_WORKERS, gc_interval=9999,
                 logger=lambda m: lines.append((time.perf_counter(), m)))
    srv.heartbeats.min_ttl = 3600.0
    srv.rpc_listen_virtual(net, name)
    return srv


def _raft_start(srv, name: str, peers: dict, root: str) -> None:
    """enable_raft over `root`/<name> and start."""
    srv.enable_raft(name, peers, data_dir=os.path.join(root, name),
                    seed=RAFT_SEED * 1000 + int(name[1:]), **RAFT_TIMING)
    srv.start()


def _raft_leader(servers, timeout: float = SERVER_TIMEOUT_S):
    """The one leader every live server names, its recovery barrier done
    for its current term."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        led = [s for s in servers if s.raft_node.is_leader()]
        if len(led) == 1:
            s = led[0]
            if s.is_leader and s._established_term == \
                    s.raft_node.current_term and all(
                        o.raft_node.leadership()[1] == s.rpc_addr
                        for o in servers):
                return s
        time.sleep(0.001)
    check(False, f"no established raft leader among "
          f"{[s.raft_node.node_id for s in servers]}")


def _raft_applied(servers, index: int,
                  timeout: float = SERVER_TIMEOUT_S) -> float:
    """perf_counter once every server has applied `index`."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(s.raft_node.last_applied >= index for s in servers):
            return time.perf_counter()
        time.sleep(0.0005)
    check(False, f"servers short of index {index}: "
          f"{[s.raft_node.last_applied for s in servers]}")


def _store_sums(srv) -> dict:
    """What two replicas must agree on: live allocations and usage."""
    import numpy as np
    view = srv.state.usage.view()
    return {"allocs": sum(1 for a in srv.state.iter_allocs()
                          if a.desired_status == "run"),
            "nodes": srv.state.node_count(),
            "used": np.asarray(view.used, np.float64).sum(axis=0).tolist(),
            "over": int((view.used > view.cap + 1e-3).any(axis=1).sum())}


def _sample_stats(name: str, skip: int) -> dict:
    from nomad_tpu_torch.metrics import metrics
    s = metrics.samples.get(name)
    vals = sorted(s.raw_window(skip)) if s is not None else []
    if not vals:
        return {"n": 0}
    return {"n": len(vals), "sum": sum(vals), "p50": vals[len(vals) // 2],
            "max": vals[-1]}


def _raft_window():
    """Counters, layer timers, raft samples and swallowed errors now."""
    from nomad_tpu_torch.metrics import metrics
    return ({k: metrics.counter(v) for k, v in COUNTERS.items()},
            {k: metrics.timer_sum(k) for k in LAYERS + PIPE_TIMERS},
            {k: metrics.sample_count(k) for k in RAFT_SAMPLES},
            {k: metrics.counter(k) for k in RAFT_SWALLOWED})


def _raft_deltas(window, on_card: bool, what: str) -> dict:
    from nomad_tpu_torch.metrics import metrics
    counters0, timers0, samples0, swallowed0 = window
    counters = {k: metrics.counter(v) - counters0[k]
                for k, v in COUNTERS.items()}
    bad = {k: counters[k] for k in (CARD_ZERO if on_card else HEALTHY_ZERO)
           if counters[k]}
    check(not bad, f"{what}: counted {bad}")
    swallowed = {k: metrics.counter(k) - v for k, v in swallowed0.items()}
    check(not any(swallowed.values()), f"{what}: swallowed {swallowed}")
    return {"counters": counters, "swallowed": swallowed,
            "layers_s": {k.split(".", 1)[1]: metrics.timer_sum(k) - v
                         for k, v in timers0.items()},
            "raft": {k: _sample_stats(k, v) for k, v in samples0.items()}}


def _raft_eval(leader, followers, job_id: str, count: int,
               on_card: bool) -> dict:
    """One job through job_register on the raft leader: register -> the
    eval complete on the leader (its last commit), and -> both followers
    applied the leader's index then; every instance on every store, no
    row over capacity, no election, no error counted or swallowed."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.solver import cuda_kernels
    term = leader.raft_node.current_term
    fsync0 = {s.raft_node.node_id: dict(s.raft_node._durable.stats())
              for s in [leader] + followers}
    window = _raft_window()
    cuda_kernels.reset_launches()                # this eval's window
    t0 = time.perf_counter()
    eval_id = leader.job_register(
        _mk_batch_job(mock, job_id, count))["eval_id"]
    t1 = _wait_evals(leader, [eval_id])
    index = leader.raft_node.commit_index
    t2 = _raft_applied(followers, index)
    launches = dict(cuda_kernels.LAUNCHES)       # read just after
    out = _raft_deltas(window, on_card, f"raft {job_id}")
    out["launches"] = launches
    check(leader.raft_node.current_term == term and
          leader.raft_node.is_leader(),
          f"raft {job_id}: an election during the eval (term {term} -> "
          f"{leader.raft_node.current_term})")
    for s in [leader] + followers:
        _check_committed(s, {job_id: count})
    sums = [_store_sums(s) for s in [leader] + followers]
    check(all(x == sums[0] for x in sums),
          f"raft {job_id}: replicas differ {sums}")
    out["fsyncs"] = {
        s.raft_node.node_id: {
            k: s.raft_node._durable.stats()[k] - fsync0[s.raft_node.node_id][k]
            for k in ("fsyncs", "appends")}
        for s in [leader] + followers}
    out.update(leader_commit_s=t1 - t0, followers_applied_s=t2 - t0,
               index=index, term=term, window=[t0, t2])
    return out


def _memory_eval(srv, job_id: str, count: int, on_card: bool) -> dict:
    """The same job through the in-memory-log server's job_register."""
    from nomad_tpu_torch import mock
    window = _raft_window()
    t0 = time.perf_counter()
    eval_id = srv.job_register(_mk_batch_job(mock, job_id, count))["eval_id"]
    t1 = _wait_evals(srv, [eval_id])
    out = _raft_deltas(window, on_card, f"memory {job_id}")
    _check_committed(srv, {job_id: count})
    out.update(leader_commit_s=t1 - t0)
    return out


def _codec_hop_s(leader) -> dict:
    """One replication hop's codec cost (rpc/virtual.py encodes and
    decodes every request): the largest plan-results entry of the
    leader's log through codec.encode + codec.decode."""
    from nomad_tpu_torch.rpc import codec

    def allocs(e) -> int:
        # one plan's results, or a coalesced batch of them
        reqs = e.payload.get("results") or [e.payload["result"]]
        return sum(len(r.alloc_placements or []) for r in reqs)
    with leader.raft_node._lock:
        plans = [e for e in leader.raft_node.log
                 if e.type.startswith("ApplyPlanResults")]
    if not plans:
        return {}
    big = max(plans, key=allocs)
    t0 = time.perf_counter()
    blob = codec.encode(big.payload)
    t1 = time.perf_counter()
    codec.decode(blob)
    t2 = time.perf_counter()
    return {"allocs": allocs(big), "type": big.type, "bytes": len(blob),
            "encode_s": t1 - t0, "decode_s": t2 - t1}


def _join_new_threads(before: set, timeout: float = 60.0) -> None:
    """Wait for the threads the phase's servers started to end (a
    warmup thread still in a torch call when the interpreter exits
    aborts the process), all but the two loops a shut-down server
    leaves parked on an event."""
    import threading
    deadline = time.monotonic() + timeout
    left = []
    for t in threading.enumerate():
        if t in before or t is threading.current_thread():
            continue
        if t.name in ("volume-watcher", "periodic-dispatch"):
            continue
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            left.append(t.name)
    if left:
        log(f"threads still running after the phase: {left}")


def _log_times(logs: dict, needle: str) -> list:
    return sorted((t, name, m) for name, lines in logs.items()
                  for t, m in list(lines) if needle in m)


def raft_phase(np, torch, card: str, nodes_snapshot: bytes,
               n_nodes: int = N_LIVE, big: int = BIG_COUNT,
               mid: int = MID_COUNT, on_card: bool = True) -> dict:
    """The port as a replicated, durable three-server cluster (phase 15):
    the fleet and the 50k job committed through Raft group commit, the
    same job on the in-memory log in turns, the count-1 job, a leader
    crash and the new leader's first 2k eval against a fresh server
    built from its snapshot, and the crashed server's restart from its
    WAL. A failed check prints the servers' last log lines."""
    import re
    import tempfile
    import threading

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.rpc.virtual import VirtualNetwork
    from nomad_tpu_torch.server.fsm import JOB_REGISTER
    from nomad_tpu_torch.solver import cuda_kernels, state_cache
    from nomad_tpu_torch.structs import Evaluation, SchedulerConfiguration
    out: dict = {"timing": RAFT_TIMING, "writers": RAFT_WRITERS}
    threads_before = set(threading.enumerate())
    root = tempfile.mkdtemp(prefix="nomad-raft-")
    net = VirtualNetwork(seed=RAFT_SEED)
    logs: dict = {}
    names = [f"r{i}" for i in range(RAFT_SERVERS)]
    servers = {n: _raft_server(net, n, logs) for n in names}
    peers = {n: s.rpc_addr for n, s in servers.items()}
    mem = fresh = None
    try:
        t0 = time.perf_counter()
        for n in names:
            _raft_start(servers[n], n, peers, root)
        leader = _raft_leader(list(servers.values()))
        out["first_election_s"] = time.perf_counter() - t0
        leader.set_scheduler_configuration(SchedulerConfiguration(
            scheduler_algorithm="tpu-batch"))
        followers = [s for s in servers.values() if s is not leader]
        # the fleet: RAFT_WRITERS threads through node_register at
        # raft_fsync = always
        rng = np.random.default_rng(42)
        fleet = [_mk_node(mock, i, rng) for i in range(n_nodes)]
        errors: list = []

        def writer(k):
            try:
                for node in fleet[k::RAFT_WRITERS]:
                    leader.node_register(node)
            except Exception as e:  # noqa: BLE001 — checked below
                errors.append(repr(e))
        fsync0 = {n: dict(s.raft_node._durable.stats())
                  for n, s in servers.items()}
        batch0 = metrics.sample_count("nomad.raft.batch_entries")
        repl0 = metrics.sample_count("nomad.raft.replicate_batch_entries")
        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(RAFT_WRITERS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t1 = time.perf_counter()
        check(not errors, f"raft fleet registration: {errors[:3]}")
        t2 = _raft_applied(followers, leader.raft_node.commit_index)
        check(all(s.state.node_count() == n_nodes
                  for s in servers.values()),
              f"raft fleet: {[s.state.node_count() for s in servers.values()]}")
        out["fleet"] = {
            "register_s": t1 - t0, "followers_applied_s": t2 - t0,
            "fsync": leader.raft_node._durable.stats()["fsync_mode"],
            "batch_entries": _sample_stats("nomad.raft.batch_entries",
                                           batch0),
            "replicate_batch_entries": _sample_stats(
                "nomad.raft.replicate_batch_entries", repl0),
            "fsyncs": {n: s.raft_node._durable.stats()["fsyncs"] -
                       fsync0[n]["fsyncs"] for n, s in servers.items()}}
        check(out["fleet"]["fsync"] == "always",
              f"raft_fsync {out['fleet']['fsync']}")
        log(f"raft fleet: {n_nodes} nodes through node_register from "
            f"{RAFT_WRITERS} threads at raft_fsync=always in "
            f"{out['fleet']['register_s']} s (followers applied at "
            f"{out['fleet']['followers_applied_s']} s); entries per "
            f"leader append (one fsync) "
            f"{json.dumps(out['fleet']['batch_entries'])}; per "
            f"AppendEntries {json.dumps(out['fleet']['replicate_batch_entries'])}; "
            f"fsyncs {json.dumps(out['fleet']['fsyncs'])}")

        # the 50k job through consensus and on the in-memory log, in turns
        runs = []
        for side, job_id in RAFT_ORDER:
            if side == "raft":
                # what establishment over a populated store does; the
                # in-memory server's restore did it at its own start
                state_cache.reseed(leader.state)
                r = _raft_eval(leader, followers, job_id, big, on_card)
                if "codec_hop" not in out:
                    out["codec_hop"] = _codec_hop_s(leader)
            else:
                if mem is None:
                    mem = _server(RAFT_WORKERS, snapshot=nodes_snapshot)
                r = _memory_eval(mem, job_id, big, on_card)
                if job_id == RAFT_ORDER[-2][1]:     # its last run
                    _shutdown(mem)
                    mem = None
            r.update(side=side, job=job_id)
            runs.append(r)
            log(f"raft compare {side} {job_id}: {big} committed, register "
                f"-> leader commit {r['leader_commit_s']} s"
                + (f", -> both followers applied "
                   f"{r['followers_applied_s']} s; entries per leader "
                   f"append {json.dumps(r['raft']['nomad.raft.batch_entries'])}"
                   f", per AppendEntries "
                   f"{json.dumps(r['raft']['nomad.raft.replicate_batch_entries'])}"
                   f", apply_wait {json.dumps(r['raft']['nomad.raft.apply_wait'])}"
                   f", fsyncs {json.dumps(r['fsyncs'])}"
                   if side == "raft" else "")
                + f"; layers {json.dumps(r['layers_s'])} ({card})")
        # the count-1 job: K2's greedy entry under consensus
        r = _raft_eval(leader, followers, "raft-one", 1, on_card)
        r.update(side="raft", job="raft-one")
        runs.append(r)
        # the raft path's launches: each raft eval's own window, summed
        launches = {k: sum(r["launches"][k] for r in runs
                           if r["side"] == "raft")
                    for k in cuda_kernels.LAUNCHES}
        out["runs"], out["launches"] = runs, launches
        if on_card:
            for r in runs:
                if r["side"] == "raft":
                    want = BIG_CHUNKS if r["job"] != "raft-one" else 0
                    check(r["launches"]["depth_curve"] == want,
                          f"raft {r['job']}: depth_curve launched "
                          f"{r['launches']['depth_curve']} times")
            # the count-1 eval takes the fused route: K2's gather entry
            check(runs[-1]["launches"]["score_capacity_gather"] == 1,
                  f"raft-one: score_capacity_gather launched "
                  f"{runs[-1]['launches']['score_capacity_gather']} times")
        walls = {side: sorted(r["leader_commit_s"] for r in runs[:4]
                              if r["side"] == side)
                 for side in ("raft", "memory")}
        overlap = walls["raft"][0] <= walls["memory"][-1] and \
            walls["memory"][0] <= walls["raft"][-1]
        out["compare"] = {"walls_s": walls,
                          "verdict": "unresolved" if overlap else
                          ("raft slower" if walls["raft"][0] >
                           walls["memory"][-1] else "raft faster")}
        # followers' standby warmups (backend.warmup on their own
        # threads): did any run inside a raft eval's window?
        spans = []
        for t, name, m in _log_times(logs, "standby warmup"):
            secs = re.search(r"in ([0-9.]+)s", m)
            spans.append((name, t - float(secs.group(1)) if secs else t, t))
        out["standby_warmups"] = [
            {"server": n, "start": a, "end": b,
             "overlaps_a_raft_eval": any(
                 a < r["window"][1] and r["window"][0] < b
                 for r in runs if r["side"] == "raft")}
            for n, a, b in spans]
        log(f"raft compare: 50k register -> last commit, raft "
            f"{walls['raft']} s, in-memory log {walls['memory']} s: "
            f"{out['compare']['verdict']}; one replication hop's codec "
            f"{json.dumps(out['codec_hop'])}; launches {json.dumps(launches)}; "
            f"count-1 {r['leader_commit_s']} s; follower warmups "
            f"{json.dumps(out['standby_warmups'])}")

        # (b) the leader crashes
        old = leader
        old_name = old.raft_node.node_id
        term = old.raft_node.current_term
        cache = state_cache.cache()
        c0 = {k: metrics.counter(f"nomad.solver.state_cache.{k}")
              for k in RAFT_CACHE}
        stats0 = cache.stats()
        window = _raft_window()
        t_crash = time.perf_counter()
        net.crash(old_name)
        rest = [s for s in servers.values() if s is not old]
        leader = _raft_leader(rest)
        t_est = time.perf_counter()
        new_name = leader.raft_node.node_id
        lines = logs[new_name]
        deadline = time.monotonic() + SERVER_TIMEOUT_S
        while not any("solver warmup" in m for t, m in list(lines)
                      if t >= t_crash):
            check(time.monotonic() < deadline,
                  f"no warmup after the failover: {lines[-5:]}")
            time.sleep(0.001)
        t_warm = next(t for t, m in list(lines)
                      if t >= t_crash and "solver warmup" in m)
        reseeded = [m for t, m in list(lines)
                    if t >= t_crash and "state cache" in m]
        check(reseeded and str(n_nodes) in reseeded[0],
              f"the new leader did not reseed the state cache: {lines[-8:]}")
        stats1 = cache.stats()
        check(stats1["uid"] == leader.state.usage.uid and
              stats1["rows"] == n_nodes,
              f"state cache after the failover {stats1}")
        # the reseeded twins against a fresh reseed of the same store
        cap_w, used_w = (t.clone() for t in cache.twins())
        cache.reset()
        state_cache.reseed(leader.state)
        cap_f, used_f = cache.twins()
        check(torch.equal(cap_w, cap_f) and torch.equal(used_w, used_f),
              "the new leader's twins differ from a fresh reseed's")
        if on_card:
            check(stats1["twins_device"] == DEVICE,
                  f"twins on {stats1['twins_device']}")
        snap = leader.snapshot_save()
        job = _mk_batch_job(mock, "raft-after", mid)

        def pinned():
            return Evaluation(id=RAFT_EVAL_ID, namespace="default",
                              priority=job.priority, type=job.type,
                              job_id=job.id, triggered_by="job-register",
                              status="pending")
        t_reg = time.perf_counter()
        leader.raft.apply(JOB_REGISTER, {"job": job.copy(),
                                         "evals": [pinned()]})
        t_commit = _wait_evals(leader, [RAFT_EVAL_ID])
        follower = next(s for s in rest if s is not leader)
        _raft_applied([follower], leader.raft_node.commit_index)
        fo = _raft_deltas(window, on_card, "raft failover")
        check(leader.raft_node.current_term > term,
              f"failover: term {leader.raft_node.current_term}")
        _check_committed(leader, {"raft-after": mid})
        got = {a.name: a.node_id
               for a in leader.state.allocs_by_job("default", "raft-after")}
        c1 = {k: metrics.counter(f"nomad.solver.state_cache.{k}") - v
              for k, v in c0.items()}
        out["failover"] = {
            "crashed": old_name, "new_leader": new_name,
            "term": [term, leader.raft_node.current_term],
            "crash_to_established_s": t_est - t_crash,
            "established_to_warm_s": t_warm - t_est,
            "register_to_commit_s": t_commit - t_reg,
            # what a user waits: the phase's own twin check and snapshot
            # between the warmup and the register left out
            "crash_to_first_commit_s":
                (t_warm - t_crash) + (t_commit - t_reg),
            "crash_to_first_commit_wall_s": t_commit - t_crash,
            "establish_timings_s": dict(
                getattr(leader, "_establish_timings", {}) or {}),
            "reseed": reseeded[0], "cache_before": stats0,
            "cache_after": stats1, "cache_counters": c1,
            "counters": fo["counters"]}

        # the crashed server restarts from its WAL and catches up, well
        # inside autopilot's dead-server threshold (LastContactThresholdSec,
        # 10 s from the new leader's election), which would reap it from
        # the configuration
        out["failover"]["crash_to_restart_s"] = time.perf_counter() - t_crash
        _shutdown(old)
        net.restart(old_name)
        t0 = time.perf_counter()
        back = _raft_server(net, old_name, logs)
        servers[old_name] = back
        _raft_start(back, old_name, peers, root)
        index = leader.raft_node.commit_index
        t1 = _raft_applied([back], index)
        check(not back.raft_node.is_leader(), "the restarted server leads")
        want_sums = _store_sums(leader)
        got_sums = _store_sums(back)
        check(got_sums == want_sums and want_sums["over"] == 0,
              f"restart: {got_sums} against the leader's {want_sums}")
        out["restart"] = {"caught_up_s": t1 - t0, "index": index,
                          "store": got_sums,
                          "durable": back.raft_node._durable.stats()}
        log(f"raft restart: {old_name} rebuilt over its data_dir, "
            f"recovered and caught up to index {index} in "
            f"{out['restart']['caught_up_s']} s; store {json.dumps(got_sums)} "
            f"equals the leader's")
        # a fresh server over the new leader's snapshot places the same
        fresh = _server(1, snapshot=snap)
        fresh.raft.apply(JOB_REGISTER, {"job": job.copy(),
                                        "evals": [pinned()]})
        _wait_evals(fresh, [RAFT_EVAL_ID])
        want = {a.name: a.node_id
                for a in fresh.state.allocs_by_job("default", "raft-after")}
        _shutdown(fresh)
        fresh = None
        moved = sum(1 for k in want if got.get(k) != want[k])
        check(len(got) == len(want) == mid and moved == 0,
              f"failover: {moved} of {mid} placements differ from a fresh "
              f"reseeded server's")
        out["failover"]["placements_equal_fresh"] = True
        log(f"raft failover: {old_name} crashed at term {term}; {new_name} "
            f"established in {out['failover']['crash_to_established_s']} "
            f"s (barrier steps {json.dumps(out['failover']['establish_timings_s'])}), "
            f"warm {out['failover']['established_to_warm_s']} s later; "
            f"the 2k job register -> commit "
            f"{out['failover']['register_to_commit_s']} s, crash -> "
            f"first commit {out['failover']['crash_to_first_commit_s']} "
            f"s (wall {out['failover']['crash_to_first_commit_wall_s']} s with "
            f"this phase's twin check and snapshot); {mid} placements equal a fresh server's over the snapshot; "
            f"{reseeded[0]!r}; twins equal a fresh reseed's; state cache "
            f"{json.dumps(stats1)}, counters {json.dumps(c1)}")

    except CheckFailed:
        for name, lines in sorted(logs.items()):
            for t, m in list(lines)[-25:]:
                log(f"  raft log {name} {t}: {m}")
        raise
    finally:
        for s in (mem, fresh):
            if s is not None:
                _shutdown(s)
        for s in servers.values():
            s.shutdown()
        _join_new_threads(threads_before)
        shutil.rmtree(root, ignore_errors=True)
    out["campaigns"] = [(name, m) for _, name, m in
                        _log_times(logs, "campaigning")]
    return out


# ------------------------------------------------------------ phase 16
#
# The port as Nomad's agent, each agent its own OS process (`python -m
# nomad_tpu_torch.cli agent -config <file>`), driven over HTTP and the
# CLI, the fleet from the node simulator (`python -m
# nomad_tpu_torch.testing simulate`). No agent is told which device to
# use: each solves on cuda:0, the solve device's default.

AGENT_KEY = "chip-smoke-agent-cluster-key"
AGENT_SERVERS, AGENT_CLIENTS = 3, 2
AGENT_REAL_DC = "real"          # the client agents' datacenter
AGENT_WAIT_S = 240.0            # the bound of every wait of the phase
AGENT_BIG_BOUND_S = 120.0       # the 50k job: register -> last commit
# how often the phase polls an agent's HTTP API while it waits: each poll
# is a request thread in an agent whose interpreter the eval and its
# heartbeat service share
AGENT_POLL_S = 0.05
# the cluster's scheduler configuration, set through the operator API.
# Each raft entry of the 50k eval is bounded at 50,000 / 16 = 3,125
# allocs (~1 MB): at the default 4 chunks, coalesced into entries of
# 12,500-25,000 allocs (3.8-7.6 MB), encoding, shipping, decoding and
# persisting one entry outlasts the agents' 0.4-0.8 s election timeout
# (their replication loop sends heartbeats behind it), and the cluster
# changed leader every few seconds without committing the job (PERF.md,
# ROADMAP Queue 3 item 14)
AGENT_SCHEDULER = {"SchedulerAlgorithm": "tpu-batch",
                   "PlanPipelineChunks": 16, "PlanCommitBatchMax": 1}
AGENT_SLEEP_JOB = """job "agent-sleep" {
  datacenters = ["dc1"]
  type = "service"
  group "g" {
    count = 3
    task "t" {
      driver = "raw_exec"
      config {
        command = "/bin/sleep"
        args    = ["600"]
      }
      resources {
        cpu    = 50
        memory = 32
      }
    }
  }
}
"""


def _cli(env: dict, addr: str, *args, timeout: float = 120.0) -> str:
    """Run the port's CLI against `addr`; fail unless it exits 0."""
    r = subprocess.run([sys.executable, "-m", "nomad_tpu_torch.cli", *args],
                       env=dict(env, NOMAD_ADDR=addr), capture_output=True,
                       text=True, timeout=timeout, cwd=str(ROOT))
    check(r.returncode == 0, f"cli {' '.join(args)}: rc {r.returncode}: "
          f"{r.stderr[-2000:]}")
    return r.stdout


def _counters(agent) -> dict:
    return agent.get("/v1/metrics")["telemetry"]["counters"]


def _agent_solves(counters: dict, on_card: bool, what: str,
                  since: dict = None) -> dict:
    """The agent's solves (counted from `since`, the counters at an
    earlier read) ran on its device and none failed: on the card
    `nomad.solver.dispatch.cuda` and `.fused.cuda` >= 1 together and 0 on
    the CPU's plain tier (classic or fused)."""
    from nomad_tpu_torch.solver.cuda_kernels import KERNELS
    since = since or {}

    def c(name):
        return int(counters.get(name, 0) - since.get(name, 0))
    out = {"dispatch_cuda": c("nomad.solver.dispatch.cuda")
           + c("nomad.solver.dispatch.fused.cuda"),
           "dispatch_torch": c("nomad.solver.dispatch.torch")
           + c("nomad.solver.dispatch.fused.torch"),
           "dispatch_fused": c("nomad.solver.dispatch.fused"),
           "dispatch_errors": c("nomad.solver.dispatch_errors"),
           "compile_cache_hits": c("nomad.compile_cache.hits"),
           "compile_cache_misses": c("nomad.compile_cache.misses"),
           "launches": {k: c(f"nomad.solver.kernel_launches.{k}")
                        for k in KERNELS}}
    check(out["dispatch_errors"] == 0, f"{what}: {out}")
    if on_card:
        check(out["dispatch_cuda"] >= 1 and out["dispatch_torch"] == 0,
              f"{what}: solves not on the card: {out}")
    else:
        check(out["dispatch_torch"] >= 1, f"{what}: {out}")
    return out


def _wait(fn, what: str, timeout: float = AGENT_WAIT_S,
          interval: float = AGENT_POLL_S):
    from nomad_tpu_torch.testing import wait_until
    got = wait_until(fn, timeout, interval)
    check(got is not None, f"{what}: not within {timeout} s")
    return got


def _agent_dev(base: str, env: dict, kind: str, on_card: bool) -> dict:
    """(a) One -dev agent (server and client in one process): a raw_exec
    job through the CLI, its tasks real processes."""
    from nomad_tpu_torch.testing import AgentProcess, free_ports, task_pids
    t0 = time.monotonic()
    dev = AgentProcess("dev", {"ports": {"http": free_ports(1)[0]}}, base,
                       env, args=("-dev",)).start()
    try:
        check(dev.wait_http(AGENT_WAIT_S), f"dev agent: {dev.tail()}")
        t_http = time.monotonic() - t0
        addr = dev.url("")
        _cli(env, addr, "operator", "scheduler", "set-config",
             "-scheduler-algorithm", "tpu-batch")
        cfg = json.loads(_cli(env, addr, "operator", "scheduler",
                              "get-config"))
        check(cfg["SchedulerConfig"]["SchedulerAlgorithm"] == "tpu-batch",
              f"scheduler config {cfg}")
        spec = os.path.join(base, "agent-sleep.nomad")
        with open(spec, "w") as f:
            f.write(AGENT_SLEEP_JOB)
        t_run = time.monotonic()
        out = _cli(env, addr, "job", "run", spec)
        check("Evaluation status: complete" in out, f"job run: {out}")
        allocs = dev.get("/v1/job/agent-sleep/allocations")
        check(len(allocs) == 3, f"dev: {len(allocs)} allocs")
        t_commit = time.monotonic()
        _wait(lambda: sum(a["ClientStatus"] == "running" for a in
                          dev.get("/v1/job/agent-sleep/allocations")) == 3,
              "dev: 3 allocs running")
        pids = _wait(lambda: (lambda p: p if len(p) == 3 else None)(
            task_pids(dev.dir, "sleep 600")), "dev: 3 sleep processes")
        status = _cli(env, addr, "job", "status", "agent-sleep")
        check(status.count("running") >= 3, f"job status: {status}")
        alloc = dev.get(f"/v1/allocation/{allocs[0]['ID']}")
        astatus = _cli(env, addr, "alloc", "status", allocs[0]["ID"])
        check("Status        = running" in astatus, f"alloc: {astatus}")
        metric = alloc.get("Metrics") or {}
        check(metric.get("NodesEvaluated", 0) >= 1 and
              metric.get("ScoreMeta"),
              f"alloc placement metrics: {metric}")
        nodes = _cli(env, addr, "node", "status")
        check(" ready " in nodes, f"node status: {nodes}")
        ui = dev.raw("/ui")
        check(b"<html" in ui[:4096].lower(), "GET /ui: no html")
        solves = _agent_solves(_counters(dev), on_card, "agent dev")
        devices = dev.get("/v1/agent/self")["stats"]["device_runtime"][
            "devices"]
        if on_card:
            check(devices and devices[0]["kind"] == kind,
                  f"agent self devices {devices}, card {kind}")
        _cli(env, addr, "job", "stop", "agent-sleep")
        _wait(lambda: not task_pids(dev.dir, "sleep 600"),
              "dev: task processes gone after job stop")
    finally:
        dev.stop()
    check(dev.proc.returncode == 0,
          f"dev agent exited {dev.proc.returncode}: {dev.tail()}")
    res = {"http_up_s": t_http, "job_run_to_commit_s": t_commit - t_run,
           "start_to_first_commit_s": t_commit - t0,
           "task_pids": len(pids), "alloc_metric": {
               k: metric.get(k) for k in ("NodesEvaluated",
                                          "NodesExhausted",
                                          "NodesFiltered")},
           "devices": [d["kind"] for d in devices], **solves}
    log(f"agent dev: up {t_http:.3f} s, job run -> committed "
        f"{res['job_run_to_commit_s']:.3f} s, start -> first commit "
        f"{res['start_to_first_commit_s']:.3f} s, cold build: "
        f"{solves['compile_cache_misses']} compile-cache misses, "
        f"{solves['compile_cache_hits']} hits; dispatch.cuda "
        f"{solves['dispatch_cuda']}, torch {solves['dispatch_torch']}, "
        f"errors 0; 3 sleep processes, alloc metrics {res['alloc_metric']}, "
        f"device {res['devices']}; /ui 200; job stop ended the tasks")
    return res


class _LeaderWatch:
    """Polls every live server agent's /v1/status/leader and records each
    change of leader (seconds since `t0`, its name); `terms` reads the
    term of each from the servers' logs."""

    def __init__(self, servers, t0: float):
        import threading
        self.servers, self.t0 = servers, t0
        self.changes: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="leader-watch")
        self._thread.start()

    def leader(self):
        led = [s for s in self.servers if s.alive() and s.is_leader()]
        return led[0] if len(led) == 1 else None

    def _run(self):
        last = None
        while not self._stop.wait(0.1):
            s = self.leader()
            if s is not None and s is not last:
                last = s
                self.changes.append({"t": time.monotonic() - self.t0,
                                     "leader": s.name})

    def stop(self):
        self._stop.set()
        self._thread.join(10.0)

    def between(self, a: float, b: float) -> list:
        return [c for c in self.changes if a <= c["t"] <= b]

    def terms(self) -> dict:
        """Each server's terms won and campaigns, from its agent log; each
        recorded change gets the term its leader won next."""
        won, campaigns = {}, {}
        for s in self.servers:
            lines = s.tail(1 << 22).splitlines()
            won[s.name] = [int(ln.rsplit("term ", 1)[1].rstrip(")"))
                           for ln in lines if "became leader (term" in ln]
            campaigns[s.name] = sum("campaigning (term" in ln
                                    for ln in lines)
        seen = {k: list(v) for k, v in won.items()}
        for c in self.changes:
            c["term"] = seen[c["leader"]].pop(0) if seen[c["leader"]] \
                else None
        return {"won": won, "campaigns": campaigns}


def _sim_stats(path: str) -> list:
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("{"):
                out.append(json.loads(line))
    return out


def _sim_rate(stats: list, a: float, b: float) -> float:
    """Heartbeats a second over the simulator's reports that bracket
    monotonic times a and b (the clock is system-wide)."""
    rows = [s for s in stats if s["event"] == "stats"]
    lo = [s for s in rows if s["mono"] <= a][-1:] or rows[:1]
    hi = [s for s in rows if s["mono"] >= b][:1] or rows[-1:]
    if not lo or hi[0]["mono"] <= lo[0]["mono"]:
        return 0.0
    return (hi[0]["heartbeats"] - lo[0]["heartbeats"]) / \
        (hi[0]["mono"] - lo[0]["mono"])


def _snapshot_check(raw: bytes, jobs: dict, what: str) -> dict:
    """Decode a server's snapshot with the port's codec and hold it: each
    job of `jobs` with exactly its count of live allocs, no alloc id or
    name twice, no usage row over capacity."""
    from nomad_tpu_torch.rpc import codec
    from nomad_tpu_torch.server.fsm import NomadFSM
    blob = codec.decode(raw)
    allocs = blob["allocs"]
    check(all(k == a.id for k, a in allocs.items()),
          f"{what}: alloc keyed by another id")
    out = {"bytes": len(raw), "allocs": len(allocs), "index": blob["index"]}
    for job_id, count in jobs.items():
        live = [a for a in allocs.values()
                if a.job_id == job_id and a.desired_status == "run"]
        check(len(live) == count, f"{what}: {job_id} {len(live)}/{count}")
        check(len({a.id for a in live}) == count and
              len({a.name for a in live}) == count,
              f"{what}: {job_id} holds an alloc id or name twice")
    fsm = NomadFSM()
    fsm.restore_bytes(raw)
    view = fsm.state.usage.view()
    over = int((view.used > view.cap + 1e-3).any(axis=1).sum())
    check(over == 0, f"{what}: {over} usage rows over capacity")
    out["over"] = over
    return out


def _write(watch, path: str, body, timeout: float = AGENT_WAIT_S):
    """PUT `body` through the current leader, retried across elections
    (as Nomad's clients retry on no leader). -> (leader, response,
    monotonic time of the accepted request)."""
    deadline = time.monotonic() + timeout
    last = None
    while True:
        s = watch.leader()
        if s is not None:
            try:
                t = time.monotonic()
                return s, s.put(path, body), t
            except Exception as e:      # noqa: BLE001 — retried until the deadline
                last = e
        check(time.monotonic() < deadline,
              f"PUT {path}: no leader took it: {last!r}")
        time.sleep(0.2)


def _submit(watch, job: dict):
    """Register `job` -> (leader, eval id, monotonic time of the accepted
    register)."""
    s, resp, t = _write(watch, "/v1/jobs", {"Job": job})
    return s, resp["eval_id"], t


def _placed(agent, job_id: str) -> int:
    """The job's instances placed, from its summary on `agent`."""
    summary = agent.get(f"/v1/job/{job_id}/summary")["Summary"]
    return sum(g["Starting"] + g["Running"] + g["Complete"]
               for g in summary.values())


def _place_whole(watch, leader, job_id: str, count: int, eval_id: str,
                 t_reg: float, bound: float) -> tuple:
    """Wait until all `count` instances of the registered job are placed,
    within `bound` seconds of its register (`t_reg`). An eval that ends
    short (a leader change fenced its plans and it failed after its
    attempts, its remainder left to a blocked eval) is followed, as an
    operator would follow it, by `job eval` (PUT
    /v1/job/<id>/evaluate) on the current leader. `leader` is the server
    that took the register, polled while it lives. -> (leader,
    monotonic time all were placed, the evals: id, status,
    description)."""
    deadline = t_reg + bound
    evals = []
    while True:
        def terminal():
            s = leader if leader.alive() else watch.leader()
            if s is None:
                return None
            ev = s.get(f"/v1/evaluation/{eval_id}", 10.0)
            return (s, ev) if ev["Status"] in ("complete", "failed",
                                               "canceled") else None
        leader, ev = _wait(terminal, f"eval {eval_id} of {job_id} ended",
                           max(1.0, deadline - time.monotonic()))
        t_end = time.monotonic()
        evals.append({"id": eval_id, "status": ev["Status"],
                      "description": ev.get("StatusDescription", "")})
        placed = _placed(leader, job_id)
        if placed == count:
            return leader, t_end, evals
        check(time.monotonic() < deadline,
              f"{job_id}: {placed}/{count} placed {bound} s after its "
              f"register; evals {evals}")
        leader, resp, _ = _write(watch, f"/v1/job/{job_id}/evaluate", {})
        eval_id = resp["EvalID"]


def _invalidated(servers) -> int:
    """Nodes the live servers have marked down for a missed TTL (each
    counts on the leader it was then)."""
    return sum(int(_counters(s).get("nomad.heartbeat.invalidate", 0))
               for s in servers if s.alive())


def _standby_warmed(agent) -> bool:
    """The server agent has run its standby warmup (its kernels built
    or loaded while it followed)."""
    return bool(agent.get("/v1/metrics")["telemetry"]["gauges"].get(
        "nomad.standby.warmed"))


def _api_job(job) -> dict:
    from nomad_tpu_torch.api_codec import to_api
    return to_api(job)


def _alloc_total(agent) -> int:
    return agent.get("/v1/metrics")["allocs"]


def _agent_cluster(base: str, env: dict, on_card: bool, n_nodes: int,
                   big: int, mid: int) -> dict:
    """(b) three server agents, two client agents and the node
    simulator, each its own process; the 50k job over HTTP; then (c) a
    kill -9 of the leader and its restart over its data dir."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.testing import (
        client_agent, cpu_seconds, free_ports, server_agent, task_pids)
    ports = free_ports(3 * AGENT_SERVERS + AGENT_CLIENTS)
    sp = [{"http": ports[i], "rpc": ports[AGENT_SERVERS + i],
           "serf": ports[2 * AGENT_SERVERS + i]}
          for i in range(AGENT_SERVERS)]
    rpcs = [f"127.0.0.1:{p['rpc']}" for p in sp]
    t0 = time.monotonic()
    servers = [server_agent(
        f"server{i}", base, sp[i], AGENT_SERVERS,
        [f"127.0.0.1:{sp[j]['serf']}" for j in range(AGENT_SERVERS)
         if j != i], AGENT_KEY, env) for i in range(AGENT_SERVERS)]
    clients = [client_agent(f"client{i}", base,
                            ports[3 * AGENT_SERVERS + i], rpcs, AGENT_KEY,
                            AGENT_REAL_DC, env)
               for i in range(AGENT_CLIENTS)]
    procs = list(servers) + list(clients)
    sim = None
    sim_log = os.path.join(base, "simulator.log")
    watch = None
    res: dict = {}
    try:
        for s in servers:
            s.start()
        for s in servers:
            check(s.wait_http(AGENT_WAIT_S), f"{s.name}: {s.tail()}")
        watch = _LeaderWatch(servers, t0)
        leader = _wait(watch.leader, "a leader among the server agents")
        res["leader_s"] = time.monotonic() - t0
        _write(watch, "/v1/operator/scheduler/configuration",
               AGENT_SCHEDULER)
        for c in clients:
            c.start()
        t_fleet = time.monotonic()
        with open(sim_log, "w") as f:
            sim = subprocess.Popen(
                [sys.executable, "-m", "nomad_tpu_torch.testing",
                 "simulate", "-servers", ",".join(rpcs), "-nodes",
                 str(n_nodes), "-key", AGENT_KEY],
                cwd=str(ROOT), env=env, stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True)
        want_nodes = n_nodes + AGENT_CLIENTS
        _wait(lambda: (lambda s: s is not None and s.get("/v1/metrics")[
            "nodes"] == want_nodes)(watch.leader()),
              f"{want_nodes} nodes registered", interval=1.0)
        t_fleet_end = time.monotonic()
        reg = _wait(lambda: [s for s in _sim_stats(sim_log)
                             if s["event"] == "registered"],
                    "the simulator's registered report", interval=0.2)
        res["fleet"] = {
            "nodes": want_nodes, "seconds": t_fleet_end - t_fleet,
            "simulator_register_s": reg[0]["register_s"],
            "invalidated": _invalidated(servers),
            "elections": watch.between(t_fleet - t0, t_fleet_end - t0)}
        log(f"agent fleet: {want_nodes} nodes ({n_nodes} simulated, "
            f"{AGENT_CLIENTS} client agents) registered through the "
            f"servers' RPC in {res['fleet']['seconds']:.3f} s (simulator "
            f"{res['fleet']['simulator_register_s']}), nodes marked down "
            f"{res['fleet']['invalidated']}, elections "
            f"{res['fleet']['elections']}")

        # the 50k job, then the count-1 job, over HTTP
        leader = _wait(watch.leader, "a leader")
        counters0 = _counters(leader)
        cpu0 = {s.name: cpu_seconds(s.pid) for s in servers}
        big_job = _mk_batch_job(mock, "agent-big", big)
        leader, big_eval, t_reg = _submit(watch, _api_job(big_job))
        leader, t_commit, big_evals = _place_whole(
            watch, leader, "agent-big", big, big_eval, t_reg,
            AGENT_BIG_BOUND_S)
        cpu1 = {s.name: cpu_seconds(s.pid) for s in servers}
        followers = [s for s in servers if s is not leader]
        applied = {}
        for f in followers:
            _wait(lambda: _placed(f, "agent-big") == big,
                  f"{f.name} applied the {big} allocs")
            applied[f.name] = time.monotonic() - t_reg
        t_done = time.monotonic()
        sims = _sim_stats(sim_log)
        apply_wait = leader.get("/v1/metrics")["telemetry"]["samples"].get(
            "nomad.raft.apply_wait")
        res["big"] = {
            "count": big, "leader": leader.name, "evals": big_evals,
            "scheduler": AGENT_SCHEDULER,
            "register_to_leader_commit_s": t_commit - t_reg,
            "register_to_followers_applied_s": applied,
            "cpu_s_during_eval": {k: cpu1[k] - cpu0[k] for k in cpu0},
            "heartbeats_per_s": _sim_rate(sims, t_reg, t_done),
            "invalidated_since_fleet": _invalidated(servers)
            - res["fleet"]["invalidated"],
            "elections": watch.between(t_reg - t0, t_done - t0),
            "raft_apply_wait": apply_wait}
        one_job = _mk_batch_job(mock, "agent-one", 1)
        leader, one_eval, t_one = _submit(watch, _api_job(one_job))
        leader, _, _ = _place_whole(watch, leader, "agent-one", 1, one_eval,
                                    t_one, AGENT_WAIT_S)
        # the leader's solves of the 50k and count-1 evals
        res["solves"] = _agent_solves(_counters(leader), on_card,
                                      "agent cluster", counters0)
        res["launches"] = res["solves"]["launches"]
        log(f"agent cluster: {big:,} tasks, register -> last commit on "
            f"{leader.name} {res['big']['register_to_leader_commit_s']:.3f}"
            f" s (PR 9's in-process raft figure 4.08-5.57 s, another "
            f"setup) over evals {big_evals}, -> followers applied "
            f"{applied}; CPU s during the "
            f"eval {res['big']['cpu_s_during_eval']}; heartbeats "
            f"{res['big']['heartbeats_per_s']:.1f}/s, nodes marked down "
            f"{res['big']['invalidated_since_fleet']}; elections "
            f"{res['big']['elections']}; launches with the count-1 job "
            f"{res['launches']}")

        # the count-2 raw_exec job on the two client agents
        sleep = {"ID": "agent-real", "Name": "agent-real",
                 "Type": "service", "Datacenters": [AGENT_REAL_DC],
                 "TaskGroups": [{"Name": "g", "Count": AGENT_CLIENTS,
                                 "Tasks": [{
                                     "Name": "t", "Driver": "raw_exec",
                                     "Config": {"command": "/bin/sleep",
                                                "args": ["601"]},
                                     "Resources": {"CPU": 50,
                                                   "MemoryMB": 32}}]}]}
        leader, real_eval, t_real = _submit(watch, sleep)
        _place_whole(watch, leader, "agent-real", AGENT_CLIENTS, real_eval,
                     t_real, AGENT_WAIT_S)
        _wait(lambda: sum(a["ClientStatus"] == "running" for a in
                          watch.leader().get(
                              "/v1/job/agent-real/allocations"))
              == AGENT_CLIENTS, "agent-real running")
        on = {c.name: task_pids(c.dir, "sleep 601") for c in clients}
        check(all(len(p) == 1 for p in on.values()),
              f"agent-real's tasks by client: {on}")

        # (c) kill -9 the leader, once it has its kernels (it placed the
        # jobs above, or warmed) and every follower is a warm standby, the
        # one that led before the fleet registered too (ROADMAP Queue 3
        # item 15: its promotion built the kernels inside its first eval,
        # and nvcc then starved the fleet's heartbeats)
        def _killable():
            s = watch.leader()
            if s is None or not on_card:
                return s
            built = sum(_counters(s).get(f"nomad.compile_cache.{k}", 0)
                        for k in ("hits", "misses"))
            warm = all(_standby_warmed(f) for f in servers if f is not s)
            return s if built and warm else None
        t_ready = time.monotonic()
        old = _wait(_killable, "a leader that has its kernels, and warm "
                    "standbys", interval=0.5)
        standby_wait_s = time.monotonic() - t_ready
        old_term = old.get("/v1/operator/debug")["Raft"]["Term"]
        warmups0 = {s.name: s.tail(1 << 22).count("solver warmup")
                    for s in servers}
        # nodes a leader has marked down for a missed TTL, so far
        invalidated0 = {s.name: _counters(s).get(
            "nomad.heartbeat.invalidate", 0) for s in servers}
        t_kill = time.monotonic()
        old.kill9()
        # /v1/status/leader answers the server's is_leader, which its
        # recovery barrier sets once every establish step but the
        # broker's restore has run
        new = _wait(lambda: (lambda s: s if s is not None and s is not old
                             else None)(watch.leader()),
                    "a new leader after the kill", interval=0.01)
        t_new = time.monotonic()
        bundle = _wait(lambda: (lambda b: b if b["Raft"]["Term"] != old_term
                                and "total" in b["Meta"]["EstablishTimings"]
                                else None)(new.get("/v1/operator/debug")),
                       "the new leader's establish timings", interval=0.1)
        cache = {k: int(bundle["Metrics"]["counters"].get(
            f"nomad.solver.state_cache.{k}", 0)) for k in RAFT_CACHE}
        timings = bundle["Meta"]["EstablishTimings"]
        # the killed agent restarted over its data dir at once: the new
        # leader's autopilot drops a peer it has not reached for 10 s of
        # its reign (LastContactThresholdSec), and a dropped server that
        # comes back campaigns at ever higher terms, which unseat the
        # leader (the reference's Raft has no pre-vote): in run D the
        # restart came 13 s after the election and the cluster changed
        # leader for minutes
        t_re = time.monotonic()
        old.start()
        mid_job = _mk_batch_job(mock, "agent-mid", mid)
        # the promoted leader's kernel builds during its first eval (its
        # standby warmup built and loaded the solve kernels, the fused
        # route's included), and its fused dispatches
        promoted, pc0 = new, _counters(new)
        new, mid_eval, t_mid = _submit(watch, _api_job(mid_job))
        new, t_mid_commit, mid_evals = _place_whole(
            watch, new, "agent-mid", mid, mid_eval, t_mid, AGENT_WAIT_S)
        pc = _counters(promoted)
        first_eval = {k: int(pc.get(name, 0) - pc0.get(name, 0))
                      for k, name in (
                          ("compile_cache_misses",
                           "nomad.compile_cache.misses"),
                          ("compile_cache_hits", "nomad.compile_cache.hits"),
                          ("dispatch_fused_cuda",
                           "nomad.solver.dispatch.fused.cuda"))}
        # the new leader's establishment warmup (a thread; from 256 nodes)
        # logs when done
        if n_nodes >= 256:
            _wait(lambda: new.tail(1 << 22).count("solver warmup") >
                  warmups0[new.name], f"{new.name}'s warmup after the kill",
                  interval=0.1)
        warm = [line.strip() for line in new.tail(20000).splitlines()
                if "solver warmup" in line]
        if on_card:
            check(first_eval["compile_cache_misses"] == 0,
                  f"{promoted.name}, a warm standby, ran nvcc in its first "
                  f"eval as leader: {first_eval}")
        res["failover"] = {
            "killed": old.name, "new_leader": new.name,
            "standby_wait_s": standby_wait_s,
            "crash_to_established_s": t_new - t_kill,
            "establish_timings": timings,
            "state_cache": cache,
            "promoted_warm": cache["promote_warm"] >= 1,
            "warmup_log": warm[-1:],
            "mid_register_to_commit_s": t_mid_commit - t_mid,
            "mid_evals": mid_evals,
            "crash_to_mid_commit_s": t_mid_commit - t_kill,
            "first_eval": first_eval,
            "elections": watch.between(t_kill - t0,
                                       time.monotonic() - t0)}
        log(f"agent failover: every follower a warm standby "
            f"{standby_wait_s:.3f} s before the kill; kill -9 {old.name}; "
            f"crash -> {new.name} "
            f"established {t_new - t_kill:.3f} s (its establish steps "
            f"{timings}); state cache "
            f"{res['failover']['state_cache']} (promoted warm: "
            f"{res['failover']['promoted_warm']}); warmup {warm[-1:]}; "
            f"{mid:,}-task job register -> commit "
            f"{res['failover']['mid_register_to_commit_s']:.3f} s, all "
            f"placed; on {promoted.name} during it "
            f"{json.dumps(first_eval)}")

        # the restarted agent catches up
        check(old.wait_http(AGENT_WAIT_S), f"{old.name}: {old.tail()}")
        target = _alloc_total(_wait(watch.leader, "a leader"))
        _wait(lambda: _alloc_total(old) == target,
              f"{old.name} caught up to {target} allocs", interval=0.05)
        t_caught = time.monotonic()
        if on_card:
            # a follower loads its kernels in its standby warmup, once its
            # store crosses the warmup floor
            _wait(lambda: _standby_warmed(old),
                  f"{old.name}'s standby warmup", interval=0.1)
        rc = _counters(old)
        hits = int(rc.get("nomad.compile_cache.hits", 0))
        misses = int(rc.get("nomad.compile_cache.misses", 0))
        if on_card:
            check(misses == 0, f"{old.name} ran nvcc on restart: {misses}")
        res["restart"] = {"caught_up_s": t_caught - t_re, "allocs": target,
                          "compile_cache_hits": hits,
                          "compile_cache_misses": misses}
        log(f"agent restart: {old.name} over its data dir caught up to "
            f"{target:,} allocs in {t_caught - t_re:.3f} s; compile cache "
            f"{hits} hits, {misses} misses")

        # the leader's and a follower's snapshots, at the end: saving one
        # pickles the whole store under its lock (26 MB here), long enough
        # at the agents' election timeout to hand leadership on
        jobs = {"agent-big": big, "agent-one": 1,
                "agent-real": AGENT_CLIENTS, "agent-mid": mid}
        snaps = {}
        leader = _wait(watch.leader, "a leader")
        for s in (leader, old if old is not leader else
                  next(f for f in servers if f is not leader)):
            raw = s.raw("/v1/operator/snapshot", 300.0)
            snaps[s.name] = _snapshot_check(raw, jobs, s.name)
        res["snapshots"] = snaps
        log(f"agent snapshots: {snaps}; agent-real ran one sleep on "
            f"each client agent {on}")
        res["terms"] = watch.terms()
        res["elections"] = list(watch.changes)
        sims = _sim_stats(sim_log)
        res["simulator"] = sims[-1] if sims else None
        nodes = new.get("/v1/nodes")
        down = [n["Name"] for n in nodes if n["Status"] != "ready"]
        # the killed server's count before its kill, every server's since
        # (the restarted one counts from its restart)
        res["nodes_invalidated"] = int(invalidated0[old.name] + sum(
            _counters(s).get("nomad.heartbeat.invalidate", 0)
            for s in servers))
        check(not down and not res["nodes_invalidated"],
              f"the simulator did not keep the fleet ready: {len(down)} "
              f"nodes not ready ({down[:5]}), "
              f"{res['nodes_invalidated']} marked down for a missed TTL; "
              f"simulator {res['simulator']}")
        log(f"agent elections: {res['elections']} (terms won "
            f"{res['terms']}); simulator {res['simulator']}; every node "
            f"ready, none marked down for a missed TTL")
    except BaseException:
        # what a failed phase needs to be read: who led when, and each
        # server's elections
        if watch is not None:
            log(f"agent cluster failed; elections {watch.terms()}, "
                f"leaders seen {watch.changes}")
        raise
    finally:
        if watch is not None:
            watch.stop()
        if sim is not None and sim.poll() is None:
            sim.terminate()
            try:
                sim.wait(60)
            except subprocess.TimeoutExpired:
                sim.kill()
                sim.wait(30)
        for p in procs:
            p.stop()
    return res


def agent_phase(torch, card: str, n_nodes: int = 10_000,
                big: int = 50_000, mid: int = 2_000,
                on_card: bool = True) -> dict:
    """The port as Nomad's agent (phase 16): (a) a -dev agent, (b) three
    server agents, two client agents and the node simulator's fleet,
    each its own process, (c) a kill -9 failover and a restart. Every
    child process is stopped, and every task process reaped, before the
    phase returns or raises."""
    import tempfile
    from nomad_tpu_torch.testing import child_env, reap_tasks
    (ROOT / "build").mkdir(exist_ok=True)
    base = tempfile.mkdtemp(prefix="agent-phase-", dir=str(ROOT / "build"))
    env = child_env()
    env.pop("NOMAD_SOLVER_DEVICE", None)
    if not on_card:
        env["NOMAD_SOLVER_DEVICE"] = "cpu"
    kind = torch.cuda.get_device_name(0) if on_card else card
    try:
        dev = _agent_dev(base, env, kind, on_card)
        cluster = _agent_cluster(base, env, on_card, n_nodes, big, mid)
    finally:
        # raw_exec tasks are session leaders: the client agents' tasks
        # outlive them by design, so the phase ends them by pid
        reaped = reap_tasks(base)
        shutil.rmtree(base, ignore_errors=True)
    log(f"agent phase: every agent stopped, {len(reaped)} task processes "
        f"reaped")
    return {"dev": dev, **cluster}


# --------------------------------------------------------------- the mesh

MESH_SHARDS = 4         # virtual shards of the one card
POD_NODES, POD_DIFF_TASKS, POD_TASKS = 100_000, 200_000, 1_000_000
POD_RACKS = 100         # the pod cluster's racks (the web job spreads on)
POD_CONVEX_COUNT = 6_000    # below plan_pipeline_min_count: one solve
MESH_LANES, MESH_EVAL_GROUPS = 8, 2
PREEMPT_CANDIDATES, PREEMPT_VICTIMS = 4_096, 8
CHAOS_FLOOR = 8_192     # SHARD_MIN_NODES for the elasticity leg (bench.py's)
CHAOS_KILLS = (2, 1)    # shards lost, in this order, at staggered dispatches
# the fire of each shard's site that raises: d2 at its 5th (on one worker
# the third eval's solve, replayed on the survivors), d1 at its 9th (a
# twin advance, replayed on the evacuated twins)
CHAOS_AFTER = (5, 9)
MESH_COUNTERS = {"sharded": "nomad.solver.dispatch.sharded",
                 "fused_sharded": "nomad.solver.dispatch.fused.sharded",
                 "solo": "nomad.solver.dispatch.cuda",
                 "fused_solo": "nomad.solver.dispatch.fused.cuda",
                 "cpu": "nomad.solver.dispatch.torch",
                 "dispatch_errors": "nomad.solver.dispatch_errors",
                 "replays": "nomad.mesh.replays",
                 "rebuilds": "nomad.mesh.rebuilds",
                 "evacuations": "nomad.solver.state_cache.evacuations"}


def _mesh_world(devs) -> None:
    """Install the shard list `devs` (None: the visible cards) and drop
    every mesh-keyed state: the quarantine, the generation, chains, the
    state cache, faults."""
    from nomad_tpu_torch import faults
    from nomad_tpu_torch.solver import (backend, device, microbatch,
                                        sharding, state_cache)
    device.use_devices(devs)
    faults.clear()
    sharding.reset()
    backend.reset()
    state_cache.reset()
    microbatch.reset()


def _mesh_counts() -> dict:
    from nomad_tpu_torch.metrics import metrics
    return {k: metrics.counter(v) for k, v in MESH_COUNTERS.items()}


def _delta(before: dict) -> dict:
    now = _mesh_counts()
    return {k: now[k] - before[k] for k in now}


def _k1_vs_plain(torch, kernels, got, want, dens_fn, what) -> tuple:
    """K1's (d_star, k_star, k_cap) against the plain version's on the
    same block: k_cap exact, the no-fit rows alike, d_star to ATOL, k_star
    exact but on near ties. -> (max abs err, near-tie rows)."""
    d_k, k_k, c_k = got
    d_p, k_p, c_p = want
    check(torch.equal(c_k, c_p), f"{what}: k_cap differs")
    fin = torch.isfinite(d_p)
    check(torch.equal(torch.isfinite(d_k), fin),
          f"{what}: rows with no fitting depth differ")
    err = float((d_k[fin] - d_p[fin]).abs().max()) if fin.any() else 0.0
    check(err <= ATOL, f"{what}: d_star max abs err {err}")
    bad = torch.nonzero((k_k != k_p) & fin).flatten()
    if len(bad):
        top2 = torch.topk(dens_fn()[bad], 2, dim=1).values
        gap = (top2[:, 0] - top2[:, 1]).abs()
        check(bool((gap <= NEAR_TIE).all()),
              f"{what}: k_star differs on {len(bad)} rows, not near ties")
    return err, int(len(bad))


def _shard_kernels_vs_plain(np, torch, m, inp, on_card: bool) -> dict:
    """Each shard's launch of K1, K2, their gather entries and the
    verdict against its plain version on that shard's block (the twins'
    block, and the eval rows the shard owns)."""
    from nomad_tpu_torch.solver import cuda_kernels, kernels, sharding
    out = {"max_abs_err": 0.0, "near_tie_rows": 0}
    caps = sharding.node_blocks(inp["cap"], m)
    useds = sharding.node_blocks(inp["used"], m)
    feas = sharding.node_blocks(inp["feasible"], m)
    colls = sharding.node_blocks(inp["coll"], m)
    affs = sharding.node_blocks(inp["aff"], m)
    rows = int(caps[0].shape[0])
    idx, valid = inp["idx"], inp["valid"]
    for s, d in enumerate(m.devices):
        what = f"mesh shard d{d.id}"
        block = (caps[s], useds[s], inp["ask"], feas[s], colls[s], BIG_COUNT,
                 affs[s])
        kw = dict(k_max=128)
        err, ties = _k1_vs_plain(
            torch, kernels, cuda_kernels.depth_curve(*block, **kw),
            kernels.depth_curve_ref(*block, **kw),
            lambda: kernels.depth_density(*block, **kw)[0], f"{what} K1")
        c_k, key_k = cuda_kernels.score_capacity_greedy(
            caps[s], useds[s], inp["ask"], feas[s])
        c_p, key_p = kernels._greedy_key(*kernels.score_capacity_ref(
            caps[s], useds[s], inp["ask"], feas[s]), 2 ** 30)
        check(torch.equal(c_k, c_p), f"{what} K2: capacity differs")
        err2 = float((key_k - key_p).abs().max())
        check(err2 <= ATOL, f"{what} K2: key max abs err {err2}")
        own = (idx // rows) == s
        idx_s = torch.where(own, idx - s * rows, 0).to(torch.int32)
        valid_s = valid & own
        g = (caps[s], useds[s], idx_s[None], valid_s[None], inp["ask"][None],
             inp["feasible"][None], inp["coll"][None], (BIG_COUNT,),
             inp["aff"][None], (2 ** 30,))
        gk = cuda_kernels.depth_curve_gather(*g, k_max=128)
        cap_g, used_g = kernels.gather_lanes(caps[s], useds[s], g[2], g[3])
        gp = kernels.depth_curve_lanes_ref(cap_g, used_g, *g[4:], k_max=128)
        err3, ties3 = _k1_vs_plain(
            torch, kernels, tuple(x[0] for x in gk), tuple(x[0] for x in gp),
            lambda: kernels.depth_density(
                cap_g[0], used_g[0], inp["ask"], inp["feasible"],
                inp["coll"], BIG_COUNT, inp["aff"], k_max=128)[0],
            f"{what} K1 gather")
        ck, kk = cuda_kernels.score_capacity_gather(
            caps[s], useds[s], idx_s, valid_s, inp["ask"], inp["feasible"])
        cp, kp = kernels._greedy_key(*kernels.score_capacity_ref(
            cap_g[0], used_g[0], inp["ask"], inp["feasible"]), 2 ** 30)
        check(torch.equal(ck, cp), f"{what} K2 gather: capacity differs")
        err4 = float((kk - kp).abs().max())
        check(err4 <= ATOL, f"{what} K2 gather: key max abs err {err4}")
        placed = torch.where(valid_s, 1 + (torch.arange(
            idx.shape[0], device=idx.device) % 3), 0).to(torch.int32)
        _, fit_k = cuda_kernels.fit_verdict(caps[s], useds[s], idx_s,
                                            valid_s, inp["ask"], placed)
        fit_p = kernels.fit_verdict_ref(caps[s], useds[s], idx_s, valid_s,
                                        inp["ask"], placed)
        check(torch.equal(fit_k, fit_p), f"{what} fit_verdict differs")
        out["max_abs_err"] = max(out["max_abs_err"], err, err2, err3, err4)
        out["near_tie_rows"] += ties + ties3
        log(f"{what}: K1, K2, K1 gather, K2 gather and fit_verdict against "
            f"their plain versions on the shard's block ({rows} twin rows, "
            f"{int(valid_s.sum())} eval rows owned): max abs err "
            f"{max(err, err2, err3, err4):.3g}, near-tie rows {ties + ties3}"
            f", verdict equal")
    return out


def _mesh_solves(np, torch, m, inp, on_card: bool, what: str) -> dict:
    """Every sharded solve on the 50k eval's inputs against the solo solve
    on the same inputs, bit for bit; each sharded solve's launches (S a
    kernel) and its wall (CUDA-event medians, as _median_ms)."""
    from nomad_tpu_torch.solver import cuda_kernels, kernels, sharding
    cap, used, ask = inp["cap"], inp["used"], inp["ask"]
    feas, coll, aff, jit = (inp["feasible"], inp["coll"], inp["aff"],
                            inp["jitter"])
    idx, valid = inp["idx"], inp["valid"]
    twins = (sharding.put_node_sharded(cap, m),
             sharding.put_node_sharded(used, m))
    rng = np.random.default_rng(SEED + 7)
    c, v = PREEMPT_CANDIDATES, PREEMPT_VICTIMS
    vr = rng.uniform(10, 3_000, size=(c, v, 5)).astype(np.float32)
    vp = rng.integers(10, 60, size=(c, v)).astype(np.int32)
    fr = rng.uniform(0, 2_000, size=(c, 5)).astype(np.float32)
    p_ask = np.array([2_000, 4_096, 300, 0, 0], np.float32)
    depth = (cap, used, ask, BIG_COUNT, feas, coll, BIG_COUNT, aff, 2 ** 30,
             jit, 1.0, 0.0)
    cls = torch.zeros_like(coll)
    fused_d = (idx, valid, ask, MID_COUNT, feas, coll, MID_COUNT, aff,
               2 ** 30, jit, 1.5, 0.0, cls, False)
    fused_g = (idx, valid, ask, 1, feas, 2 ** 30, cls, False, coll)
    cases = {
        "greedy": (
            lambda: sharding.sharded_fill_greedy(m)(cap, used, ask, 5_000,
                                                    feas, 2 ** 30),
            lambda: cuda_kernels.fill_greedy_binpack_fused(
                cap, used, ask, 5_000, feas),
            {"score_capacity": m.size}),
        "depth": (
            lambda: sharding.sharded_fill_depth(m, 128)(*depth),
            lambda: cuda_kernels.fill_depth_fused(
                *depth[:8], max_per_node=2 ** 30, order_jitter=jit,
                jitter_scale=1.0, jitter_samples=0.0, k_max=128),
            {"depth_curve": m.size}),
        "fused depth": (
            lambda: sharding.sharded_fused(m, "depth", k_max=128)(
                *twins, *fused_d),
            lambda: cuda_kernels.fused_eval_depth(cap, used, *fused_d,
                                                  k_max=128),
            {"depth_curve_gather": m.size, "fit_verdict": m.size}),
        "fused greedy": (
            lambda: sharding.sharded_fused(m, "greedy")(*twins, *fused_g),
            lambda: cuda_kernels.fused_eval_greedy(cap, used, *fused_g),
            {"score_capacity_gather": m.size, "fit_verdict": m.size}),
        "preempt": (
            lambda: sharding.sharded_preempt_top_k(m)(vr, vp, p_ask, fr, 70),
            lambda: kernels.preempt_top_k(
                *(torch.from_numpy(a).to(m.lead) for a in (vr, vp, p_ask,
                                                           fr)), 70),
            {}),
    }
    out = {}
    for name, (sharded, solo, want_launches) in cases.items():
        if on_card:
            torch.cuda.synchronize()
        cuda_kernels.reset_launches()
        got = sharded()
        if on_card:
            torch.cuda.synchronize()
        launches = {k: n for k, n in cuda_kernels.LAUNCHES.items() if n}
        ref = solo()
        got_t = got if isinstance(got, tuple) else (got,)
        ref_t = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got_t, ref_t):
            check(g.dtype == r.dtype and g.cpu().numpy().tobytes() ==
                  r.cpu().numpy().tobytes(),
                  f"{what} {name}: the sharded solve differs from the solo "
                  f"solve")
        if on_card:
            check(launches == want_launches,
                  f"{what} {name}: launches {launches}, expected "
                  f"{want_launches}")
        r = {"launches": launches,
             "placed": int(got_t[0].sum()) if name != "preempt"
             else int(got_t[0].sum()),
             "sharded_ms": _median_ms(torch, sharded) if on_card else None,
             "solo_ms": _median_ms(torch, solo) if on_card else None}
        out[name] = r
        log(f"{what} {name}: sharded over {m.size} shards equals the solo "
            f"solve bit for bit; launches {json.dumps(launches)} (one a "
            f"shard); wall {r['sharded_ms']} ms sharded vs {r['solo_ms']} "
            f"ms solo (one call, CUDA events; virtual shards share one "
            f"card)" if on_card else
            f"{what} {name}: sharded equals solo bit for bit")
    return out


def _shard_scan_blocks(torch, m, args):
    """The scan's positional args (place_chunked's) as cuda_kernels.
    chunked_shard's per-shard lists on `m`, placed_init zeros."""
    from nomad_tpu_torch.solver import sharding
    n = m.size

    def blk(x, axis=0):
        return list(sharding.node_blocks(x, m, axis=axis))
    placed = torch.zeros(int(args[0].shape[0]), dtype=torch.int32,
                         device=args[0].device)
    return (blk(args[0]), blk(args[1]), [args[2]] * n, args[3], blk(args[4]),
            blk(args[5]), args[6], blk(args[7], 1), [args[8]] * n,
            [args[9]] * n, [args[10]] * n, [args[11]] * n, blk(args[12]),
            blk(args[13], 1), [args[14]] * n, blk(placed))


def _timed_once(torch, fn) -> tuple:
    """(fn's result, its wall in ms, the card synchronized on both sides):
    the plain versions' time, too slow to repeat."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _mesh_scan(np, torch, m, dev, floor_ms, on_card) -> dict:
    """The sharded scan on the web inputs (_scan_inputs: 16,384 rows,
    WEB_COUNT instances, 250 steps): the kernel (csrc/chunked_shard.cu,
    one launch a step for every shard of the card, a cluster of 8 CTAs a
    shard) against its plain version on the same blocks, each shard's
    rows and tables bit for bit; the sharded program against the solo
    scan kernel, all four outputs bit for bit; the launches (max_steps + 1
    a device) and how many exited early on each shard; device ms per
    solve and µs per step, wall per call, the plain version's one call,
    the solo scan's, the bound and the floors."""
    from nomad_tpu_torch.solver import cuda_kernels, kernels, sharding
    args, _ = _scan_inputs(np, torch, dev)
    blocks = _shard_scan_blocks(torch, m, args)
    cuda_kernels.reset_launches()
    got = cuda_kernels.chunked_shard(*blocks)
    if on_card:
        torch.cuda.synchronize()
    launches = cuda_kernels.LAUNCHES["chunked_shard"]
    want, plain_ms = _timed_once(
        torch, lambda: kernels.chunked_shard_ref(*blocks)) if on_card \
        else (kernels.chunked_shard_ref(*blocks), None)
    for s in range(m.size):
        check(_bit_equal([got[0][s], got[1][s], got[2][s], got[3][s]],
                         [want[0][s], want[1][s], want[2][s], want[3][s]]),
              f"mesh chunked_shard: shard {s} differs from the plain "
              f"version")
    state = got[4].cpu()
    steps, early = int(state[0, 2]), int(state[0, 5])
    check(steps == want[4] and bool((state[:, 2] == steps).all())
          and bool((state[:, 5] == early).all()),
          f"mesh chunked_shard: steps {state[:, 2].tolist()}, early exits "
          f"{state[:, 5].tolist()}, plain {want[4]} steps")
    fn = sharding.sharded_place_chunked(m)
    sh = fn(*args, None, 2 ** 30)
    solo = cuda_kernels.place_chunked(*args)
    check(_bit_equal([sh[0].cpu(), sh[1].cpu(), sh[2], sh[3]],
                     [solo[0], solo[1], solo[2], solo[3]]),
          "mesh sharded scan: differs from the solo scan kernel")
    check(not on_card or (launches == 257 and early == 256 - steps),
          f"mesh chunked_shard: {launches} launches, {early} early exits "
          f"a shard for {steps} steps on {m.size} shards")
    out = {"launches_per_solve": launches, "early_exits": early,
           "steps": steps, "shards": m.size, "max_abs_err": 0.0,
           "plain_ms": plain_ms, "floor_ms": floor_ms,
           "placed": int(solo[0].sum())}
    if on_card:
        run = (lambda: cuda_kernels.chunked_shard(*blocks))
        ms, all_ms, how = _device_ms(torch, run, "chunked_shard_kernel",
                                     reps=5, per_call=launches,
                                     scale_missing=True)
        if not ms:
            ms, how = _queued_ms(torch, run, 5), "queued events"
        out.update(ms=ms, solve_device_ms=all_ms, timing=how,
                   step_us=ms * 1e3 / (steps + 1),
                   call_ms=_median_ms(torch, lambda: fn(*args, None,
                                                        2 ** 30), 10),
                   solo_ms=_median_ms(torch,
                                      lambda: cuda_kernels.place_chunked(
                                          *args), 10),
                   dependency_floor_ms=steps * floor_ms,
                   launch_floor_ms=launches * floor_ms)
        out.update(_scan_bound(args, steps, out["placed"]))
    log(f"mesh chunked_shard ({m.size} virtual shards, {N_BUCKET} rows, "
        f"{WEB_COUNT} asked, {steps} steps): each shard's rows and tables "
        f"bit-equal to the plain version; the sharded scan bit-equal to "
        f"the solo scan kernel on all four outputs; {launches} launches "
        f"(one a step for all {m.size} shards, {early} exited early on "
        f"each shard); "
        + (f"{out['ms']} ms device per solve ({out['timing']}), "
           f"{out['step_us']:.3f} us a step (over the {steps + 1} "
           f"working launches), "
           f"{out['call_ms']} ms per call, solo scan {out['solo_ms']} ms, "
           f"plain {plain_ms} ms (one call); bound {out['bound_ms']} ms "
           f"({out['bound_by']}), floor {launches} x {floor_ms} ms = "
           f"{out['launch_floor_ms']} ms (dependency {steps} x "
           f"{floor_ms} ms = {out['dependency_floor_ms']} ms)"
           if on_card else "on the CPU"))
    return out


def _mesh_convex(np, torch, m, dev, floor_ms, on_card) -> dict:
    """The sharded convex solve on testing.convex_fixture("bench_binpack")
    (10,000 nodes, 16,384 rows): the kernel (csrc/convex_shard.cu, one
    launch a round for every shard of the card, a cluster of 8 x 1,024
    threads a shard) against its plain version, bit for bit (the
    iterate, u and cost of every shard, budget, iterations, gap); the
    sharded eval over node-sharded twins placing as the solo convex eval;
    the rounds and the waits; device ms per solve, wall per call, the
    plain version's one call, the bound and the floor."""
    from nomad_tpu_torch.solver import convex, cuda_kernels, sharding
    solve, evals, spread, (cap, used, ask) = _convex_args(
        np, torch, dev, "bench_binpack")

    def blk(x):
        return list(sharding.node_blocks(x, m))
    sargs = (blk(solve[0]), blk(solve[1]), [solve[2]] * m.size,
             blk(solve[3]), blk(solve[4]), blk(solve[5])) + solve[6:]
    cuda_kernels.reset_launches()
    got = cuda_kernels.convex_solve_sharded(*sargs, spread_algorithm=spread)
    if on_card:
        torch.cuda.synchronize()
    launches = cuda_kernels.LAUNCHES["convex_shard"]
    waits = cuda_kernels.WAITS["convex_shard"]
    want, plain_ms = _timed_once(torch, lambda: convex.convex_solve_sharded_ref(
        *sargs, spread_algorithm=spread)) if on_card else (
        convex.convex_solve_sharded_ref(*sargs, spread_algorithm=spread),
        None)
    for s in range(m.size):
        check(_convex_solves_equal(torch, [got[i][s] for i in range(3)],
                                   [want[i][s] for i in range(3)]),
              f"mesh convex_shard: shard {s} differs from the plain version")
    check(_convex_solves_equal(torch, got[3:], want[3:]),
          f"mesh convex_shard: scalars {[float(x) for x in got[3:]]} vs "
          f"{[float(x) for x in want[3:]]}")
    iters = int(got[4])
    rounds = 3 + 18 * iters
    twins = tuple(sharding.put_node_sharded(t, m) for t in evals[:2])
    prog = sharding.sharded_convex(m, spread_algorithm=spread)
    placed, fit, _, _, won = prog(*twins, *evals[2:])
    solo = convex.to_host(cuda_kernels.convex_eval_fused(
        *evals, spread_algorithm=spread))
    check(np.array_equal(placed.cpu().numpy(), solo[0]) and
          np.array_equal(fit.cpu().numpy(), solo[1]) and bool(won) == solo[4],
          "mesh sharded convex: placements differ from the solo eval")
    check(not on_card or (launches == cuda_kernels.CONVEX_FIRST_BLOCK
                          and waits == 1),
          f"mesh convex_shard: {launches} launches, {waits} waits")
    out = {"launches_per_solve": launches, "waits": waits,
           "iterations": iters, "rounds": rounds, "shards": m.size,
           "max_abs_err": 0.0, "plain_ms": plain_ms, "floor_ms": floor_ms,
           "placed": int(solo[0].sum())}
    if on_card:
        run = (lambda: cuda_kernels.convex_solve_sharded(
            *sargs, spread_algorithm=spread))
        ms, all_ms, how = _device_ms(torch, run, "convex_shard_kernel",
                                     reps=10, per_call=launches,
                                     scale_missing=True)
        if not ms:
            ms, how = _queued_ms(torch, run, 10), "queued events"
        out.update(ms=ms, solve_device_ms=all_ms, timing=how,
                   round_us=ms * 1e3 / rounds,
                   call_ms=_median_ms(torch, run, 30),
                   solo_ms=_median_ms(torch, lambda: cuda_kernels.convex_solve(
                       *solve, spread_algorithm=spread), 30),
                   dependency_floor_ms=rounds * floor_ms)
        out.update(_convex_bound(cap.shape[0], iters))
    log(f"mesh convex_shard ({m.size} virtual shards, {cap.shape[0]} rows, "
        f"{iters} iterations): each shard's iterate, u and cost and the "
        f"scalars bit-equal to the plain version; the sharded eval places "
        f"as the solo eval ({out['placed']} placed); {launches} launches "
        f"(one a round for all {m.size} shards; {rounds} rounds do the "
        f"work, the rest of the block exits early), {waits} wait(s); "
        + (f"{out['ms']} ms device per solve ({out['timing']}), "
           f"{out['round_us']:.3f} us a round, "
           f"{out['call_ms']} ms per call, solo solve {out['solo_ms']} ms, "
           f"plain {plain_ms} ms (one call); bound {out['bound_ms']} ms "
           f"({out['bound_by']}), floor {rounds} x {floor_ms} ms = "
           f"{out['dependency_floor_ms']} ms" if on_card else "on the CPU"))
    return out


def _mesh_windows(np, torch, m, dev, on_card) -> dict:
    """An 8-lane classic window and an 8-lane fused depth window over
    node-sharded twins, and the eval-batched greedy over 2 groups x 2
    shards, on the 50k eval's fleet: each lane (eval) equal to its solo
    solve, with one K1 (or gather-entry) launch and one verdict launch a
    shard a window, and one K2 launch an (eval, shard)."""
    from nomad_tpu_torch.solver import (backend, cuda_kernels, kernels,
                                        sharding)
    from nomad_tpu_torch.solver.tensorize import stack_lanes
    inp = _fused_inputs(np, torch, dev)
    rng = np.random.default_rng(SEED + 9)
    counts = [int(c) for c in rng.integers(50, 2_000, MESH_LANES)]
    lanes = [(inp["cap"], inp["used"], inp["ask"], np.int32(c),
              inp["feasible"], inp["coll"], np.int32(c), inp["aff"],
              np.int32(2 ** 30), inp["jitter"], np.float32(1.0),
              np.float32(0.0)) for c in counts]
    per = MESH_LANES // m.size
    parts = [stack_lanes(lanes[s * per:(s + 1) * per],
                         backend._ARG_DTYPES["depth"], dev=d.device)
             for s, d in enumerate(m.devices)]
    lanes_fn = backend._lanes_fn(on_card, 128, False, None)
    cuda_kernels.reset_launches()
    got = sharding.split_lanes(m, lanes_fn, parts)
    classic = {k: n for k, n in cuda_kernels.LAUNCHES.items() if n}
    for lane, g in zip(lanes, got):
        want = cuda_kernels.fill_depth_fused(
            *lane[:8], max_per_node=2 ** 30, order_jitter=lane[9],
            jitter_scale=1.0, jitter_samples=0.0, k_max=128)
        check(_bit_equal([g], [want]), "mesh classic window: a lane "
              "differs from its solo solve")
    check(not on_card or classic == {"depth_curve_lanes": m.size},
          f"mesh classic window: launches {classic}")
    twins = (sharding.put_node_sharded(inp["cap"], m),
             sharding.put_node_sharded(inp["used"], m))
    f_lanes = []
    for i, c in enumerate(counts):
        perm = np.random.default_rng(SEED + 20 + i).permutation(N_LIVE)
        idx = np.zeros(N_BUCKET, np.int32)
        idx[:N_LIVE] = perm
        f_lanes.append((torch.from_numpy(idx).to(dev), inp["valid"],
                        inp["ask"], np.int32(c), inp["feasible"],
                        inp["coll"], np.int32(c), inp["aff"],
                        np.int32(2 ** 30), inp["jitter"], np.float32(1.5),
                        np.float32(0.0)))
    cols = stack_lanes(f_lanes, backend.FUSED_LANE_DTYPES)
    cuda_kernels.reset_launches()
    placed, fit = sharding.sharded_fused_lanes(128)(*twins, *cols)
    fused = {k: n for k, n in cuda_kernels.LAUNCHES.items() if n}
    for i, lane in enumerate(f_lanes):
        w_p, w_f = cuda_kernels.fused_eval_depth(
            inp["cap"], inp["used"], *lane[:3], int(lane[3]), lane[4],
            lane[5], int(lane[6]), lane[7], 2 ** 30, lane[9], 1.5, 0.0,
            None, False, k_max=128)
        check(_bit_equal([placed[i], fit[i]], [w_p, w_f]),
              f"mesh fused window: lane {i} differs from its solo eval")
    check(not on_card or fused == {"depth_curve_gather": m.size,
                                   "fit_verdict": m.size},
          f"mesh fused window: launches {fused}")
    n_evals = 2 * MESH_EVAL_GROUPS
    ecap = torch.stack([inp["cap"]] * n_evals)
    eused = torch.stack([inp["used"] * (1.0 - 0.1 * e)
                         for e in range(n_evals)]).floor()
    eask = torch.stack([inp["ask"] * (1 + e) for e in range(n_evals)])
    ecounts = np.array([1, 700, 2_500, 9_000][:n_evals], np.int32)
    efeas = torch.stack([inp["feasible"]] * n_evals)
    cuda_kernels.reset_launches()
    eb = sharding.sharded_eval_batch_fill_greedy(m, MESH_EVAL_GROUPS)(
        ecap, eused, eask, ecounts, efeas)
    batched = {k: n for k, n in cuda_kernels.LAUNCHES.items() if n}
    for e in range(n_evals):
        want = cuda_kernels.fill_greedy_binpack_fused(
            ecap[e], eused[e], eask[e], int(ecounts[e]), efeas[e])
        check(_bit_equal([eb[e]], [want]),
              f"mesh eval-batched greedy: eval {e} differs from its solo "
              f"greedy")
    check(not on_card or batched == {"score_capacity": n_evals * m.size
                                     // MESH_EVAL_GROUPS},
          f"mesh eval-batched greedy: launches {batched}")
    log(f"mesh windows ({m.size} virtual shards): an {MESH_LANES}-lane "
        f"classic window split {per} lanes a shard, every lane equal to "
        f"its solo solve, launches {json.dumps(classic)}; an "
        f"{MESH_LANES}-lane fused depth window over node-sharded twins, "
        f"every lane (placed, verdict) equal to its solo fused eval, "
        f"launches {json.dumps(fused)}; the eval-batched greedy, {n_evals} "
        f"evals over {MESH_EVAL_GROUPS} groups of "
        f"{m.size // MESH_EVAL_GROUPS} shards, each equal to its solo "
        f"greedy, launches {json.dumps(batched)}")
    return {"classic": classic, "fused": fused, "eval_batched": batched,
            "lanes": MESH_LANES}


def _by_node(s, job_id) -> dict:
    placed: dict = {}
    for a in s.allocs_by_job("default", job_id):
        placed[a.node_id] = placed.get(a.node_id, 0) + 1
    return placed


def _pod_slice_evals(torch, fsm, planner, on_card: bool) -> dict:
    """On a pod leg's cluster, after its diff eval: the web-shaped spread
    service job (WEB_COUNT instances, datacenters targeted 50/30/20, racks
    even: the scan path) and a POD_CONVEX_COUNT-task batch job under the
    convex algorithm. -> each eval's placement map, wall, layer times and
    launches."""
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.structs import SchedulerConfiguration
    s = fsm.state
    out = {}
    web = _drive(torch, fsm, planner, _mk_service_job(
        mock, structs, "pod-web", WEB_COUNT, 250, 512, "web",
        priority=SERVICE_PRIORITY), "pod-web-eval", healthy=on_card)
    s.set_scheduler_config(s.latest_index() + 1, SchedulerConfiguration(
        scheduler_algorithm="convex"))
    try:
        cvx = _drive(torch, fsm, planner, _mk_batch_job(
            mock, "pod-convex", POD_CONVEX_COUNT), "pod-convex-eval",
            healthy=on_card)
    finally:
        s.set_scheduler_config(s.latest_index() + 1, SchedulerConfiguration(
            scheduler_algorithm="tpu-batch"))
    for name, r, job_id in (("web", web, "pod-web"),
                            ("convex", cvx, "pod-convex")):
        out[name] = {"wall_s": r["wall_s"], "layers_s": r["layers_s"],
                     "launches": {k: n for k, n in r["launches"].items()
                                  if n},
                     "placed": _by_node(s, job_id)}
    return out


def _pod_leg(torch, card_mesh, sharded: bool, count: int, on_card: bool,
             n_nodes: int, audit: bool = False) -> dict:
    """One pod-scale leg: a fresh cluster of `n_nodes` pinned-id nodes in
    three datacenters and POD_RACKS racks, one `count`-task eval (eval id
    "pod-eval"), then the web spread job and the convex job on the same
    cluster (_pod_slice_evals), on the 4-shard mesh or solo. -> the
    placement maps, walls, counters (and the syncs)."""
    from nomad_tpu_torch import mock
    _mesh_world(card_mesh if sharded else card_mesh[:1])
    t0 = time.perf_counter()
    fsm, planner = _cluster(n_nodes, seed=31, pin="pod-", racks=POD_RACKS)
    seed_s = time.perf_counter() - t0
    job = _mk_batch_job(mock, "pod-diff", count)
    before = _mesh_counts()
    rec = None
    with _applier(planner):
        if audit and on_card:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            rec = _SyncRecorder(torch)
        try:
            r = _drive(torch, fsm, planner, job, "pod-eval",
                       healthy=on_card)
        finally:
            if rec is not None:
                rec.close()
                torch.cuda.set_sync_debug_mode("default")
        d = _delta(before)
        slice_evals = _pod_slice_evals(torch, fsm, planner, on_card)
    out = {"seed_s": seed_s, "wall_s": r["wall_s"], "counts": d,
           "layers_s": r["layers_s"], "launches": {
               k: n for k, n in r["launches"].items() if n},
           "placed": _by_node(fsm.state, job.id), "fsm": (fsm, planner),
           "slice": slice_evals}
    if rec is not None:
        sites, callers = rec.take()
        out["syncs"] = {"total": sum(sites.values()), "sites": sites,
                        "reached_from_scope": callers,
                        "unmarked": _unmarked_syncs({**sites, **callers})}
    return out


def _pod_phase(np, torch, card_mesh, on_card: bool, n_nodes: int,
               diff_tasks: int, tasks: int) -> dict:
    """The reference's pod-scale lineage cut to one card: the sharded and
    the solo leg of one `diff_tasks` eval on identical clusters place node
    for node alike; then one `tasks` eval commits whole on the mesh."""
    from nomad_tpu_torch import mock
    solo = _pod_leg(torch, card_mesh, False, diff_tasks, on_card, n_nodes)
    del solo["fsm"]
    shard = _pod_leg(torch, card_mesh, True, diff_tasks, on_card, n_nodes,
                     audit=True)
    check(shard["placed"] == solo["placed"],
          f"pod: the sharded and the solo leg place differently "
          f"({sum(shard['placed'].values())} vs "
          f"{sum(solo['placed'].values())} instances)")
    kernels = {"web": ("chunked_shard", "chunked_scan"),
               "convex": ("convex_shard", "convex_solve")}
    for name, (mesh_k, solo_k) in kernels.items():
        a, b = shard["slice"][name], solo["slice"][name]
        check(a["placed"] == b["placed"],
              f"pod {name}: the sharded and the solo leg place differently")
        check(not on_card or (a["launches"].get(mesh_k, 0) > 0 and
                              mesh_k not in b["launches"] and
                              a["launches"].get(solo_k, 0) == 0 and
                              b["launches"].get(solo_k, 0) > 0),
              f"pod {name}: launches sharded {a['launches']}, solo "
              f"{b['launches']}")
        log(f"mesh pod {name}: {sum(a['placed'].values())} instances on "
            f"{len(a['placed'])} nodes, sharded and solo node for node "
            f"alike; sharded wall {a['wall_s']:.3f} s (launches "
            f"{json.dumps(a['launches'])}, layers "
            f"{json.dumps({k: round(v, 4) for k, v in a['layers_s'].items()})}"
            f"), solo {b['wall_s']:.3f} s (launches "
            f"{json.dumps(b['launches'])}, layers "
            f"{json.dumps({k: round(v, 4) for k, v in b['layers_s'].items()})})")
    check(shard["counts"]["sharded"] >= 1 and shard["counts"]["solo"] == 0
          and solo["counts"]["sharded"] == 0,
          f"pod: tiers {shard['counts']} / {solo['counts']}")
    check(not on_card or shard["counts"]["cpu"] == solo["counts"]["cpu"]
          == 0, "pod: a solve ran on the CPU")
    if on_card:
        check(not shard["syncs"]["unmarked"],
              f"pod: syncs on unmarked lines {shard['syncs']['unmarked']}")
    log(f"mesh pod: {n_nodes} nodes, one {diff_tasks}-task eval (id "
        f"pod-eval): sharded leg {shard['wall_s']:.3f} s "
        f"(nomad.solver.dispatch.sharded {shard['counts']['sharded']}, "
        f"launches {json.dumps(shard['launches'])}), solo leg "
        f"{solo['wall_s']:.3f} s (launches {json.dumps(solo['launches'])}); "
        f"placements equal node for node on {len(shard['placed'])} nodes; "
        f"cluster builds {shard['seed_s']:.1f} s / {solo['seed_s']:.1f} s "
        f"(walls on {MESH_SHARDS} virtual shards of one card, not a "
        f"multi-card figure)")
    if "syncs" in shard:
        s = shard["syncs"]
        log(f"mesh pod syncs (sharded {diff_tasks}-task eval): {s['total']} "
            f"syncs at {json.dumps(s['sites'])}, reached from SYNC001's "
            f"scope at {json.dumps(s['reached_from_scope'])}; unmarked "
            f"{s['unmarked']}")
    fsm, planner = shard.pop("fsm")
    job = _mk_batch_job(mock, "pod-batch", tasks)
    before = _mesh_counts()
    with _applier(planner):
        r = _drive(torch, fsm, planner, job, "pod-eval-1m",
                   healthy=on_card)
    big = {"wall_s": r["wall_s"], "committed": r["committed"],
           "counts": _delta(before), "layers_s": r["layers_s"],
           "launches": {k: n for k, n in r["launches"].items() if n}}
    check(big["committed"] == tasks and big["counts"]["sharded"] >= 1,
          f"pod: the {tasks}-task eval committed {big['committed']} "
          f"(sharded dispatches {big['counts']['sharded']})")
    log(f"mesh pod headline: one {tasks}-task eval on {n_nodes} nodes "
        f"through scheduler -> applier -> FSM commit on the {MESH_SHARDS}-"
        f"shard mesh: {big['committed']} committed in {big['wall_s']:.3f} s "
        f"(nomad.solver.dispatch.sharded {big['counts']['sharded']}, "
        f"launches {json.dumps(big['launches'])}, layers "
        f"{json.dumps({k: round(v, 4) for k, v in big['layers_s'].items()})})")
    del fsm, planner, r
    import gc
    t_gc = time.perf_counter()
    gc.collect()        # the clusters' allocations, freed here at once
    log(f"mesh pod: the pod clusters collected in "
        f"{time.perf_counter() - t_gc:.2f} s")
    for leg in (shard, solo):
        leg["placed_nodes"] = len(leg.pop("placed"))
        for r in leg["slice"].values():
            r["placed_nodes"] = len(r.pop("placed"))
    return {"diff": {"sharded": shard, "solo": solo}, "headline": big}


def _chaos_run(np, torch, snapshot, card_mesh, workers: int, kill: bool,
               n_jobs: int, count: int, floor: int,
               batching: bool = False) -> dict:
    """One elasticity leg: a fresh server over the fleet's snapshot on the
    4-shard mesh (SHARD_MIN_NODES at CHAOS_FLOOR), `n_jobs` jobs of
    `count` tasks with pinned eval ids registered at once; with `kill`,
    CHAOS_KILLS lost at staggered dispatches. With `batching`, the fused
    route off, backend.BATCH_MAX_COUNT at `count` and a 200 ms window:
    concurrent evals coalesce into classic windows, split over the shards
    where their lanes divide (the splits counted)."""
    from nomad_tpu_torch import faults, mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import backend, buckets, sharding
    _mesh_world(card_mesh)
    prev_floor, prev_batch = backend.SHARD_MIN_NODES, backend.BATCH_MAX_COUNT
    backend.SHARD_MIN_NODES = floor
    split = sharding.split_lanes
    splits: list = []
    if batching:
        backend.BATCH_MAX_COUNT = count

        def counted(m, lanes_fn, parts):
            splits.append(m.size)
            return split(m, lanes_fn, parts)
        sharding.split_lanes = counted
    # a window waits for every eval in flight (it fires early once they
    # are in): its lanes then divide over the shards more often
    srv = _server(workers, snapshot=snapshot,
                  **({"solver_fused_enabled": False,
                      "eval_batch_window_ms": 200.0} if batching else {}))
    w0 = metrics.counter("nomad.solver.microbatch.dispatches")
    try:
        jobs = [_mk_batch_job(mock, f"chaos-{j}", count)
                for j in range(n_jobs)]
        ev_skip = metrics.sample_count("nomad.mesh.evacuation")
        before = _mesh_counts()
        if kill:
            faults.install({f"device.lost.d{d}": {"mode": "after", "n": n,
                                                  "times": 1}
                            for d, n in zip(CHAOS_KILLS, CHAOS_AFTER)})
        t0 = time.perf_counter()
        for j, job in enumerate(jobs):
            _register_pinned(srv, job, f"chaos-eval-{j}")
        t1 = _wait_evals(srv, [f"chaos-eval-{j}" for j in range(n_jobs)])
        fired = {d: faults.fired(f"device.lost.d{d}") for d in CHAOS_KILLS}
        faults.clear()
        _check_committed(srv, {j.id: count for j in jobs})
        placed = {}
        for job in jobs:
            m = {}
            for a in srv.state.allocs_by_job("default", job.id):
                m[a.node_id] = m.get(a.node_id, 0) + 1
            placed[job.id] = m
        n_ev = metrics.sample_count("nomad.mesh.evacuation") - ev_skip
        evac = metrics.samples["nomad.mesh.evacuation"].raw_window(ev_skip) \
            if n_ev > 0 else []
        snap = sharding.snapshot()
        r = {"workers": workers, "on_card": snap.mesh.lead.type == "cuda",
             "killed": sorted(d for d, n in fired.items()
                                                  if n) if kill else [],
             "fired": fired, "wall_s": t1 - t0, "counts": _delta(before),
             "generation": sharding.generation(),
             "quarantined": sorted(sharding.quarantined()),
             "shards_left": snap.shards,
             "bucket_10k": buckets.node_bucket(srv.state.node_count()),
             "evacuation_s": [round(x, 4) for x in evac],
             "evals_lost": sum(1 for j in range(n_jobs)
                               if srv.state.eval_by_id(
                                   f"chaos-eval-{j}").status != "complete"),
             "placed": placed,
             "windows": metrics.counter(
                 "nomad.solver.microbatch.dispatches") - w0,
             "split_windows": len(splits), "split_shards": sorted(
                 set(splits))}
    finally:
        _shutdown(srv)
        backend.SHARD_MIN_NODES = prev_floor
        backend.BATCH_MAX_COUNT = prev_batch
        sharding.split_lanes = split
    return r


def _chaos_phase(np, torch, snapshot, card_mesh, n_jobs: int,
                 count: int, floor: int) -> dict:
    """The reference's device-chaos shape cut to 4 shards: the same
    pinned stream undisturbed and with d2 then d1 lost (one worker, so
    both runs place in one order), then the stream on STREAM_WORKERS
    concurrent workers with the same kills."""
    calm = _chaos_run(np, torch, snapshot, card_mesh, 1, False, n_jobs, count,
                      floor)
    hit = _chaos_run(np, torch, snapshot, card_mesh, 1, True, n_jobs, count,
                     floor)
    busy = _chaos_run(np, torch, snapshot, card_mesh, STREAM_WORKERS, True,
                      n_jobs, count, floor)
    # micro-batching on: windows split their lanes over the shards
    batched = _chaos_run(np, torch, snapshot, card_mesh, STREAM_WORKERS,
                         True, n_jobs, count, floor, batching=True)
    check(batched["windows"] >= 1 and batched["split_windows"] >= 1,
          f"chaos batched: {batched['windows']} windows, "
          f"{batched['split_windows']} split over the shards")
    for r in (hit, busy, batched):
        check(r["evals_lost"] == 0, f"chaos: {r['evals_lost']} evals lost")
        check(r["quarantined"] == sorted(CHAOS_KILLS) and
              r["generation"] == len(CHAOS_KILLS) and
              r["counts"]["rebuilds"] == len(CHAOS_KILLS),
              f"chaos: generation {r['generation']}, quarantine "
              f"{r['quarantined']}, rebuilds {r['counts']['rebuilds']}")
        check(r["shards_left"] == MESH_SHARDS - len(CHAOS_KILLS) and
              r["bucket_10k"] % r["shards_left"] == 0,
              f"chaos: {r['shards_left']} shards, bucket {r['bucket_10k']}")
        check(r["counts"]["replays"] >= 1 and r["counts"]["evacuations"] >= 1,
              f"chaos: replays {r['counts']['replays']}, evacuations "
              f"{r['counts']['evacuations']}")
        check(r["counts"]["cpu"] == 0 or not r["on_card"],
              "chaos: a solve ran on the CPU")
    check(calm["counts"]["rebuilds"] == 0 and calm["generation"] == 0,
          "chaos: the undisturbed run rebuilt")
    check(hit["placed"] == calm["placed"],
          "chaos: placements differ from the undisturbed run")
    for name, r in (("undisturbed", calm), ("lost d2 then d1", hit),
                    (f"{STREAM_WORKERS} workers, lost d2 then d1", busy),
                    (f"{STREAM_WORKERS} workers batching, lost d2 then d1",
                     batched)):
        log(f"mesh chaos {name}: {n_jobs} x {count}-task evals, "
            f"{r['workers']} worker(s), {r['wall_s']:.3f} s; generation "
            f"{r['generation']}, quarantine {r['quarantined']}, "
            f"{r['shards_left']} shards left, bucket of the fleet "
            f"{r['bucket_10k']}; replays {r['counts']['replays']}, "
            f"evacuations {r['counts']['evacuations']} "
            f"({r['evacuation_s']} s), evals lost {r['evals_lost']}, "
            f"dispatches {json.dumps({k: r['counts'][k] for k in ('sharded', 'fused_sharded', 'solo', 'fused_solo', 'cpu')})}"
            f"; windows {r['windows']}, split over the shards "
            f"{r['split_windows']} (shard counts {r['split_shards']})")
    log("mesh chaos: the one-worker stream that lost d2 and d1 placed "
        "exactly as the undisturbed one, job for job, node for node")
    for r in (calm, hit, busy, batched):
        r["placed"] = {k: len(v) for k, v in r["placed"].items()}
    return {"undisturbed": calm, "lost": hit, "concurrent": busy,
            "batched": batched}


def _all_lost_phase(torch, card_mesh) -> dict:
    """Lose the last shards: the next eval raises and commits nothing,
    and no solve runs on the CPU."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.solver import backend, sharding
    _mesh_world(card_mesh)
    fsm, planner = _cluster(64, seed=5)
    sharding.rebuild("test", lost_device_ids=CHAOS_KILLS)
    before = _mesh_counts()
    sharding.rebuild("test", lost_device_ids=[
        i for i in range(MESH_SHARDS) if i not in CHAOS_KILLS])
    check(sharding.lost(), "mesh: shards left after losing every one")
    job = _mk_batch_job(mock, "lost-all", 16)
    raised = None
    try:
        _run_eval(fsm, planner, job, "lost-all-eval")
    except sharding.MeshLostError as e:
        raised = str(e)
    try:
        backend.select("depth", N_BUCKET)
    except sharding.MeshLostError as e:
        raised = raised or str(e)
    committed = len(fsm.state.allocs_by_job("default", job.id))
    d = _delta(before)
    check(raised is not None and committed == 0 and d["cpu"] == 0 and
          d["sharded"] == d["solo"] == 0,
          f"mesh all lost: raised {raised!r}, committed {committed}, "
          f"counts {d}")
    log(f"mesh all lost: quarantine {sorted(sharding.quarantined())}; the "
        f"next eval raised ({raised[:90]}...), committed {committed}, CPU "
        f"solves {d['cpu']}")
    return {"raised": raised, "committed": committed}


def mesh_phase(np, torch, card: str, nodes_snapshot: bytes,
               pod_nodes: int = POD_NODES, diff_tasks: int = POD_DIFF_TASKS,
               tasks: int = POD_TASKS, chaos_jobs: int = STREAM_JOBS,
               chaos_count: int = STREAM_COUNT, chaos_floor: int = CHAOS_FLOOR,
               on_card: bool = True, floor_ms: float = 0.0) -> dict:
    """The device mesh (solver/sharding.py) on the card: 4 virtual shards
    of cuda:0 (`device.use_devices`), every per-shard kernel launch and
    every merge on the H100. (1) Each shard's kernels against their plain
    versions, and every sharded solve against the solo solve on the 50k
    eval's inputs, bit for bit, S launches a kernel a solve; the sharded
    scan and convex kernels against their plain versions and the solo
    solves, split windows and the eval-batched greedy against their solo
    solves. (2) Pod scale, the scan's and convex's legs on the same
    clusters. (3) Elasticity, a batching leg among them. (4) The real
    cards, if several."""
    from nomad_tpu_torch.solver import device, sharding
    t_phase = time.perf_counter()
    dev = torch.device(card)
    card_mesh = [card] * MESH_SHARDS
    out = {}
    try:
        _mesh_world(card_mesh)
        m = sharding.mesh()
        check(m is not None and m.size == MESH_SHARDS,
              f"mesh: {m} over {card_mesh}")
        inp = _fused_inputs(np, torch, dev)
        out["shards"] = _shard_kernels_vs_plain(np, torch, m, inp, on_card)
        out["solves"] = _mesh_solves(np, torch, m, inp, on_card,
                                     f"mesh {MESH_SHARDS} virtual shards")
        t = time.perf_counter()
        out["chunked_shard"] = _mesh_scan(np, torch, m, dev, floor_ms,
                                          on_card)
        out["convex_shard"] = _mesh_convex(np, torch, m, dev, floor_ms,
                                           on_card)
        out["windows"] = _mesh_windows(np, torch, m, dev, on_card)
        out["slice_kernels_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["pod"] = _pod_phase(np, torch, card_mesh, on_card, pod_nodes,
                                diff_tasks, tasks)
        out["pod"]["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        out["chaos"] = _chaos_phase(np, torch, nodes_snapshot, card_mesh,
                                    chaos_jobs, chaos_count, chaos_floor)
        out["chaos"]["seconds"] = time.perf_counter() - t
        out["all_lost"] = _all_lost_phase(torch, card_mesh)
        n = torch.cuda.device_count() if on_card else 1
        if n > 1:
            cards = [f"cuda:{i}" for i in range(n)]
            _mesh_world(cards)
            out["cards"] = _mesh_solves(np, torch, sharding.mesh(), inp,
                                        on_card, f"mesh {n} cards")
        else:
            log("mesh: one card visible — the mesh ran on virtual shards of "
                "one card; its walls are no multi-card figure")
    finally:
        _mesh_world(None)
        device.use_devices(None)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"mesh phase: {out['seconds']:.1f} s")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import numpy as np
        from nomad_tpu_torch.solver import cuda_kernels
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    card = device_phase(torch)
    secs = cuda_kernels.build()
    log(f"build: {secs:.2f} s")
    for name, text in cuda_kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    # the native stamping extension (native/, gitignored) is built from
    # the checkout before the first eval stamps an allocation
    from nomad_tpu_torch import runtime
    from nomad_tpu_torch.structs import fastbatch
    native = runtime.ensure_native()
    native_loaded = bool(fastbatch._load_native())
    log(f"native stamping extension: built {native}, loaded "
        f"{native_loaded}")
    pow10 = pow10_phase(torch, dev)
    res = kernels_phase(np, torch, dev)
    res["depth_curve_lanes"] = lanes_phase(np, torch, dev)
    res["depth_curve_lanes"]["floor_ms"] = res["depth_curve"]["floor_ms"]
    fused_k = fused_kernel_phase(np, torch, dev,
                                 res["depth_curve"]["floor_ms"])
    res.update({k: fused_k[k] for k in ("depth_curve_gather",
                                        "score_capacity_gather",
                                        "fit_verdict")})
    res.update(chunked_phase(np, torch, dev, res["depth_curve"]["floor_ms"]))
    ex = explain_phase(np, torch, dev)
    main = main_path_phase(torch)
    analysis = analysis_phase(torch)
    service = service_phase(np, torch)
    compare = compare_phase(torch)
    prof = profile_phase(torch)
    small_phase(torch)
    ladder = ladder_phase(np, torch)
    server = server_phase(np, torch, card)
    nodes = server.pop("nodes_snapshot")        # the 10,000-node fleet
    t_fused = time.perf_counter()
    fused = fused_pairs_phase(np, torch, nodes, card)
    log(f"fused pairs phase: {time.perf_counter() - t_fused:.1f} s")
    # the stream at STREAM_COUNT only, with the fused route off: its
    # coalesced windows are the classic lanes entry (depth_curve_lanes);
    # stream_sweep.py runs every count at the defaults
    stream = stream_phase(np, torch, nodes, card, counts=(STREAM_COUNT,),
                          fused=False)
    rejections = rejection_phase(np, torch, card)
    fault = server_fault_phase(np, torch, nodes)
    t_cvx = time.perf_counter()
    cvx = convex_kernel_phase(np, torch, dev,
                              res["depth_curve"]["floor_ms"])
    cvx_server = convex_server_phase(np, torch, nodes)
    log(f"convex phase: {time.perf_counter() - t_cvx:.1f} s")
    t_raft = time.perf_counter()
    raft = raft_phase(np, torch, card, nodes)
    log(f"raft phase: {time.perf_counter() - t_raft:.1f} s")
    t_agent = time.perf_counter()
    agent = agent_phase(torch, card)
    log(f"agent phase: {time.perf_counter() - t_agent:.1f} s")
    # last: its 100,000-node clusters and 1.2M allocations are freed at
    # its end, and no later phase shares the process with their garbage
    mesh = mesh_phase(np, torch, DEVICE, nodes,
                      floor_ms=res["depth_curve"]["floor_ms"])

    meta = {
        "depth_curve": ("nomad_tpu_torch/solver/csrc/depth_curve.cu",
                        "nomad_tpu/solver/pallas_kernels.py:174"),
        # K1 over a window's lanes: the micro-batch window, which the
        # reference runs as jit(vmap(fill_depth)) of the same kernel
        "depth_curve_lanes": ("nomad_tpu_torch/solver/csrc/depth_curve.cu",
                              "nomad_tpu/solver/pallas_kernels.py:174"),
        "score_capacity": ("nomad_tpu_torch/solver/csrc/score_capacity.cu",
                           "nomad_tpu/solver/pallas_kernels.py:31"),
        # no Pallas kernel: the step of place_chunked's lax.scan
        "chunked_step": ("nomad_tpu_torch/solver/csrc/chunked_step.cu",
                         "nomad_tpu/solver/kernels.py:414"),
        # no Pallas kernel: place_chunked's lax.scan, one XLA program
        "chunked_scan": ("nomad_tpu_torch/solver/csrc/chunked_scan.cu",
                         "nomad_tpu/solver/kernels.py:345"),
        # no Pallas kernel: convex_eval's lax.while_loop, one XLA program
        "convex_solve": ("nomad_tpu_torch/solver/csrc/convex_solve.cu",
                         "nomad_tpu/solver/convex.py:129"),
        # the whole-eval fused route: K1's and K2's gather entries (the
        # reference's fused programs inline gather_rows before the Pallas
        # kernels' work) and the verdict (no Pallas kernel: part of the
        # fused XLA program)
        "depth_curve_gather": ("nomad_tpu_torch/solver/csrc/depth_curve.cu",
                               "nomad_tpu/solver/pallas_kernels.py:174"),
        "score_capacity_gather": (
            "nomad_tpu_torch/solver/csrc/score_capacity.cu",
            "nomad_tpu/solver/pallas_kernels.py:31"),
        "fit_verdict": ("nomad_tpu_torch/solver/csrc/fit_verdict.cu",
                        "nomad_tpu/solver/kernels.py:439"),
        # no Pallas kernel: place_chunked's lax.scan under the node-axis
        # sharding of sharded_place_chunked (one XLA program)
        "chunked_shard": ("nomad_tpu_torch/solver/csrc/chunked_shard.cu",
                          "nomad_tpu/solver/sharding.py:442"),
        # no Pallas kernel: convex_eval's lax.while_loop under the
        # node-axis sharding of sharded_convex (one XLA program)
        "convex_shard": ("nomad_tpu_torch/solver/csrc/convex_shard.cu",
                         "nomad_tpu/solver/sharding.py:546"),
    }
    # each kernel's launches on the path that runs it: the scan's two on
    # the service path (the step kernel no longer runs there)
    launches = dict(main["launches"])
    for name in ("chunked_step", "chunked_scan"):
        launches[name] = service["launches"][name]
    # the windows' on the stream at STREAM_COUNT with batching on
    launches["depth_curve_lanes"] = stream["launches"]["depth_curve_lanes"]
    # the convex solve's on the server's convex evals; its row's numbers
    # from the main path's shape, bench_binpack
    launches["convex_solve"] = cvx_server["launches"]["convex_solve"]
    # the classic K2 entry's on the count-1 eval with the fused route off
    # (the main path's count-1 eval takes the fused route)
    launches["score_capacity"] = fused["launches"]["score_capacity"]
    res["convex_solve"] = cvx["bench_binpack"]
    # the mesh's two kernels: their launches on the mesh phase's pod
    # legs (the spread job's sharded scan, the convex job's sharded solve)
    pod = mesh["pod"]["diff"]["sharded"]["slice"]
    launches["chunked_shard"] = pod["web"]["launches"].get("chunked_shard",
                                                           0)
    launches["convex_shard"] = pod["convex"]["launches"].get("convex_shard",
                                                             0)
    res["chunked_shard"] = mesh["chunked_shard"]
    res["convex_shard"] = mesh["convex_shard"]
    rows = []
    for name, (src, rep) in meta.items():
        r = res[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": rep, "launches": launches[name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None,
               "floor_ms": r["floor_ms"], "call_ms": r["call_ms"],
               # the cluster leader agent's launches on the agent path
               # (the 50k and count-1 jobs over HTTP), read from its
               # /v1/metrics
               "agent_launches": agent["launches"][name]}
        for k in ("near_tie_rows", "moved_nodes", "grid_ms", "spread_ms",
                  "k512_ms", "depths_evaluated", "score_ms", "steps",
                  "solve_device_ms", "barrier_ms", "dependency_floor_ms",
                  "solo_8_ms", "iterations", "eval_device_ms",
                  "eval_call_ms", "plain_device_ms", "fused_window_ms",
                  "reductions", "reductions_prior", "gather_floor_ms",
                  "lanes_ms", "timing", "launch_floor_ms", "step_us",
                  "round_us", "launches_per_solve", "early_exits",
                  "waits", "rounds", "solo_ms", "shards"):
            if k in r:
                row[k] = r[k]
        rows.append(row)
    log(json.dumps({"e2e": main["evals"], "cache": main["cache"],
                    "service": {k: v for k, v in service.items()
                                if k != "launches"},
                    "compare_50k": compare, "profiled_50k": prof,
                    "explain_reduce": ex, "ladder": ladder,
                    "server": server, "stream": stream,
                    "rejections": rejections, "server_fault": fault,
                    "convex": {k: {f: v for f, v in r.items()
                                   if f != "eval_kernels"}
                               for k, r in cvx.items()},
                    "convex_server": cvx_server, "raft": raft,
                    "fused": {"kernels": fused_k, "pairs": fused},
                    "agent": agent, "analysis": analysis, "mesh": mesh,
                    "native_stamping": native_loaded,
                    "greedy_fill": res["greedy_fill"], "pow10": pow10,
                    "card": card,
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
