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
              greedy pass, serial). Every instance committed, no usage
              row over capacity; the 50k eval counted 1 pipelined eval, 4
              chunks and 4 depth-curve launches; the state cache's twins
              on cuda:0, fed by every commit (equal to the committed
              usage), served hits and rode every dispatch; the plain tier
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
              (plan_pipeline_enabled=False) and pipelined, each with
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
 10. server   the port's Server(num_workers=4) on the card: 10,000 nodes
              through node_register, the 50k job through job_register, a
              worker and the pipelined applier (every instance committed,
              no row over capacity, register -> last commit wall, layer
              timers); a fresh Server over snapshot_restore, whose
              establishment reseeds the state cache (10,000 rows) and
              warms every kernel, after which a 2k eval builds and loads
              nothing; the debug bundle (the card in DeviceRuntime, one
              shard, breakers closed, the state cache's rows).
 11. stream   16 jobs of 1,000 tasks registered back to back on a fresh
              10,000-node server with 4 workers, micro-batching on and off
              in turns (on, off, off, on), then at 500, 2,000 and 4,000:
              evals/s, submit_plan p50/p99, the batcher's counters and
              window sizes, the window launches; every instance
              placed, no row over capacity. Per count, the runs in pairs
              and a one-sided sign test on them: a count qualifies for
              backend.BATCH_MAX_COUNT only where the coalesced run beat
              solo in enough pairs (p <= 0.05); two pairs a count, as
              here, can never qualify one (stream_sweep.py runs more).
 12. rejections  8 jobs of 2,000 tasks (cpu 400, mem 700) at once on a
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
              binpack and spread, at tolerance 1e-4 and 1e-9, and a
              128-row case that runs all 200 iterations: the solve bit
              for bit, the whole eval's placements, fit, convex_won and
              iterations equal, one launch each of the kernel and K2,
              0 rows over capacity; device ms, per-call ms, plain ms,
              bound and dependency floor (`convex <case>` lines). (b)
              scheduler_algorithm "convex" set through the operator API
              on a 10,000-node server: a 5,000-task job under convex and
              tpu-batch in turns, register -> commit walls; a convex eval
              counts 1 convex dispatch, 1 round trip, 1 launch of the
              kernel, 0 CPU solves (`convex server` lines). (c)
              solver.dispatch.convex faulted once: nacked, redelivered,
              committed in one plan (`convex fault`).

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
            # explain: records, reduces run on the card, swallowed errors
            "explain_records": "nomad.solver.explain.records",
            "explain_errors": "nomad.solver.explain.errors"}
# counters every healthy phase must leave at 0
HEALTHY_ZERO = ("dispatch_errors", "breaker_opened", "explain_errors")
# and every eval on the card: no solve served by the CPU's plain tier
CARD_ZERO = HEALTHY_ZERO + ("torch_serves",)
# the kernels the 50k main path runs; the service path runs chunked_scan
MAIN_KERNELS = ("depth_curve", "score_capacity")
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
# _concurrent_rejection_rate's shape)
REJECT_NODES, REJECT_JOBS, REJECT_COUNT, REJECT_WORKERS = 2_000, 8, 2_000, 8
# the host binpack scheduler takes seconds an eval at this size, its 8
# workers share one interpreter lock, and evals that lose a plan conflict
# plan again
REJECT_TIMEOUT_S = 720.0


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


def _device_ms(torch, fn, kernel: str, reps=REPS, per_call=1) -> tuple:
    """(kernel ms, all device ms) per call from a torch.profiler trace of
    `reps` calls: the named kernel's own device time, and the device time
    of every kernel the call launches. A call launches the named kernel
    `per_call` times; a trace that recorded another number of its
    launches is logged and taken again, and after three such traces the
    kernel's time is None (the caller times with CUDA events). (None,
    None) when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(3):                  # a trace may miss the kernel
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as e:       # no CUPTI: CUDA events instead
            log(f"profiler unavailable ({e}); timing with CUDA events")
            return None, None
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
                return None, total / reps / 1e3
            continue
        if n_mine == reps * per_call:
            return mine / reps / 1e3, total / reps / 1e3
        log(f"profiler trace recorded {n_mine} launches of {kernel}, "
            f"{reps * per_call} expected; tracing again")
    return None, (total / reps / 1e3 if total > 0 else None)


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
    events where the profiler does not see the kernel) and the wrapper's
    per-call time."""
    ms, _ = _device_ms(torch, run, kernel)
    out = {"call_ms": _median_ms(torch, run, CALL_REPS),
           "timing": "profiler"}
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
    ms, all_ms = _device_ms(torch, run, "chunked_scan_kernel", reps=10)
    out.update(ms=ms, solve_device_ms=all_ms, steps=steps,
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
    """bench.py's heterogeneous fleet node. With `racks`, the service
    layout: datacenter dc1..dc3 by i % 3 and meta.rack r0.. by i % racks."""
    n = mock.node()
    if pin:
        n.id = f"{pin}{i:06d}"
    n.name = f"bench-{i}"
    n.node_class = f"c{int(rng.integers(0, 4))}"
    n.datacenter = "dc1" if i % 2 == 0 else "dc2"
    if racks:
        n.datacenter = f"dc{i % 3 + 1}"
        n.meta["rack"] = f"r{i % racks}"
    n.node_resources.cpu.cpu_shares = int(
        rng.choice([4_000, 8_000, 16_000, 32_000]))
    n.node_resources.memory.memory_mb = int(
        rng.choice([8_192, 16_384, 32_768, 65_536]))
    n.node_resources.disk.disk_mb = 500_000
    return n


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
    from nomad_tpu_torch.solver import cuda_kernels, state_cache
    t0 = time.perf_counter()
    fsm, planner = _cluster(N_LIVE, seed=42)
    log(f"main: seeded {N_LIVE} nodes in "
        f"{time.perf_counter() - t0:.3f} s")
    s = fsm.state
    state_cache.reset()                       # hits counted from here
    evals = [("big", BIG_COUNT, "depth_curve"),
             ("mid", MID_COUNT, "depth_curve"),
             ("one", 1, "score_capacity")]
    out = {"evals": {}}
    cuda_kernels.reset_launches()                 # the main path's window
    with _applier(planner):
        for job_id, count, kname in evals:
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
            check(c["twin_dispatches"] == 1,
                  f"{job_id}: {c['twin_dispatches']} dispatches rode the "
                  f"state cache's twins, expected 1")
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
                f"{pipelined}, overcommitted rows 0); layers "
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
        want = BIG_CHUNKS if pipelined else 1
        check(launches["depth_curve"] == want,
              f"compare {mode}: depth_curve launched "
              f"{launches['depth_curve']} times, expected {want}")
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
    _, device_ms = _device_ms(torch, run, "")
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
    check(fired == 1 and committed == 0 and c["dispatch_errors"] == 1 and
          c["torch_serves"] == 0 and launched["depth_curve"] == 0,
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
    solo_ms, _ = _device_ms(torch, eight_solo, "depth_curve_kernel",
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


def _stream_run(np, torch, snapshot, count: int, batch: bool) -> dict:
    """STREAM_JOBS jobs of `count` tasks registered back to back on a
    fresh 10,000-node server with STREAM_WORKERS workers."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import cuda_kernels
    mb = ("dispatches", "solo", "early_fire")
    srv = _server(STREAM_WORKERS, snapshot=snapshot,
                  eval_batch_enabled=batch)
    try:
        jobs = [_mk_batch_job(mock, f"stream-{count}-{batch:d}-{j}", count)
                for j in range(STREAM_JOBS)]
        skip = metrics.sample_count("nomad.worker.submit_plan")
        size0 = metrics.sample_count("nomad.solver.microbatch.size")
        wait0 = metrics.sample_count("nomad.solver.microbatch.leader_wait")
        c0 = {k: metrics.counter(f"nomad.solver.microbatch.{k}") for k in mb}
        errs0 = metrics.counter("nomad.solver.dispatch_errors")
        cpu0 = metrics.counter("nomad.solver.dispatch.torch")
        cuda_kernels.reset_launches()            # this path's window
        t0 = time.perf_counter()
        ids = [srv.job_register(j)["eval_id"] for j in jobs]
        t1 = _wait_evals(srv, ids)
        launches = dict(cuda_kernels.LAUNCHES)   # read just after
        _check_committed(srv, {j.id: count for j in jobs})
        check(metrics.counter("nomad.solver.dispatch_errors") == errs0 and
              metrics.counter("nomad.solver.dispatch.torch") == cpu0,
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
                 pairs: int = STREAM_PAIRS) -> dict:
    """The eval stream on a 10,000-node server: 16 jobs registered back
    to back, `pairs` pairs of runs with micro-batching on and off (on
    first in even pairs, off first in odd ones), at STREAM_COUNT and at
    the other counts of the batch tier's sweep; every instance placed, no
    node over capacity. During the sweep the batch tier's count ceiling
    is raised to the count under test, so each `on` run can coalesce. A
    count qualifies where the coalesced run was faster in enough pairs
    for a one-sided sign test at STREAM_P; the pick is the largest count
    that qualifies, else 0."""
    from nomad_tpu_torch.solver import backend
    runs = []
    ceiling = backend.BATCH_MAX_COUNT
    try:
        for count in STREAM_COUNTS:
            backend.BATCH_MAX_COUNT = count
            for pair in range(pairs):
                order = (True, False) if pair % 2 == 0 else (False, True)
                for batch in order:
                    r = _stream_run(np, torch, snapshot, count, batch)
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
    lanes = sum(r["launches"]["depth_curve_lanes"] for r in main)
    check(lanes >= 1, f"the stream at {STREAM_COUNT} launched the lane "
          f"entry {lanes} times")
    summary = {}
    for count in STREAM_COUNTS:
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
    qualified = [c for c in STREAM_COUNTS if summary[c]["qualifies"]]
    pick = max(qualified) if qualified else 0
    log(f"stream: per-eval wall on - off, median over {pairs} pairs; "
        f"coalesced faster in: "
        + "; ".join(f"{c}: {summary[c]['median_pair_diff_s']:+.5f} s, "
                    f"{summary[c]['wins']}/{pairs} "
                    f"(p {summary[c]['sign_test_p']:.4f})"
                    for c in STREAM_COUNTS)
        + f"; counts that qualify at p <= {STREAM_P}: {qualified}, pick "
          f"{pick} (in the code: {backend.BATCH_MAX_COUNT})")
    return {"runs": runs, "summary": summary, "batch_max_count_pick": pick,
            "launches": {"depth_curve_lanes": lanes}}


def _rejection_run(np, torch, snapshot, algorithm: str) -> dict:
    """8 jobs of 2,000 tasks (cpu 400, mem 700; bench.py
    `_concurrent_rejection_rate`) registered at once on a 2,000-node
    server with 8 workers. Each plan and its PlanResult is recorded by
    wrapping the server's planner instance.

    A batch eval whose plans are rejected on both of its attempts
    (scheduler MAX_BATCH_SCHEDULE_ATTEMPTS, 2, as in the reference and
    Nomad) ends `failed` with its remainder parked in a blocked eval,
    which nothing in the run releases (the reference has no periodic
    unblock of such evals). So each job is held to: every instance
    committed, or the eval failed on plan conflicts with a blocked eval
    holding the rest; and no node over capacity. The instances left
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
    try:
        jobs = [_mk_batch_job(mock, f"rej-{algorithm}-{j}", REJECT_COUNT,
                              cpu=400, mem=700) for j in range(REJECT_JOBS)]
        t0 = time.perf_counter()
        ids = [srv.job_register(j)["eval_id"] for j in jobs]
        t1 = _wait_evals(srv, ids, REJECT_TIMEOUT_S,
                         done=("complete", "failed"))
        placed, failed = {}, 0
        for job, eval_id in zip(jobs, ids):
            placed[job.id] = sum(
                1 for a in srv.state.allocs_by_job("default", job.id)
                if a.desired_status == "run")
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
            "failed_evals": failed,
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
            f"{r['unplaced']} instances left to their blocked evals; "
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
             "eval_failures": "nomad.worker.eval_failures",
             "cpu_solves": "nomad.solver.dispatch.torch"}
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
        check(d["dispatch_errors"] == 1 and d["eval_failures"] == 1 and
              d["cpu_solves"] == 0, f"server fault counted {d}")
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
# float32 operations a row of the convex solve needs (csrc/
# convex_solve.cu; an add, multiply, divide, floor, min or max is one, a
# fused multiply-add two, a 10**x one): its inputs once (capacity 20,
# score 10, cost 2, the sum of u and the start 4, the start's objective 7:
# 43), then each iteration the gradient step 7, the bracket 4, 50
# halvings of 4 and the projection 3, the objective 7: 221
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
    aff = np.zeros(b, np.float32)

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


def convex_kernel_phase(np, torch, dev, floor_ms) -> dict:
    """(a) The convex-solve kernel against its plain version on the card
    at bench.py `_convex_run`'s cluster (10,000 nodes, 16,384 rows, count
    3,000, fairness 0.05), binpack and spread, at tolerance 1e-4 and at
    1e-9 (the loop runs until the objective stops moving), and a
    128-row spread case that runs all 200 iterations: iterate, u, cost,
    budget, iterations and gap bit-equal; the whole eval (kernel, K2's
    greedy entry, torch tail) placing as the plain eval, with one launch
    of each kernel and 0 rows over capacity in the host AllocsFit
    re-walk. Device ms (profiler; queued events beside it), per-call ms,
    the plain version's ms, the bound and the dependency floor (cluster
    reductions x one cluster barrier of the solve's shape, from an empty
    loop of BARRIER_STEPS)."""
    from nomad_tpu_torch.solver import convex, cuda_kernels
    from nomad_tpu_torch.testing import CONVEX_CASES
    out: dict = {}
    barrier_ms = _queued_ms(torch, lambda: cuda_kernels.cluster_barrier(
        BARRIER_STEPS, dev, threads=1024), 5) / BARRIER_STEPS
    for name in CONVEX_TIMED + ("small_spread_deep",):
        check(name in CONVEX_CASES, f"no convex fixture {name}")
        solve, evals, spread, (cap, used, ask) = _convex_args(
            np, torch, dev, name)

        def run():
            return cuda_kernels.convex_solve(*solve, spread_algorithm=spread)
        got, want = run(), convex.convex_solve_ref(
            *solve, spread_algorithm=spread)
        torch.cuda.synchronize()
        err = float((got[0] - want[0]).abs().max())
        for g, w in zip(got, want):
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            check(torch.equal(g, w),
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
        r = {"iterations": iters, "gap": float(card[3]), "won": card[4],
             "placed": int(card[0].sum()), "launches_per_eval": per_eval,
             "violations": over, "max_abs_err": err,
             "reductions": 2 + iters * (convex.PROJECT_ITERS + 2),
             "floor_ms": floor_ms, "barrier_ms": barrier_ms}
        r["dependency_floor_ms"] = r["reductions"] * barrier_ms
        r.update(_convex_bound(cap.shape[0], iters))
        if name in CONVEX_TIMED:
            r.update(_times(torch, "convex_solve", run))
            r["queued_ms"] = _queued_ms(torch, run)
        else:
            r["ms"] = r["queued_ms"] = _queued_ms(torch, run, 3)
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
            f"(queued {r['queued_ms']}), {r.get('call_ms')} ms per call, "
            f"plain {r.get('plain_ms')} ms; bound {r['bound_ms']} ms "
            f"({r['bound_by']}: {r['bytes']} B, {r['ops']} ops); "
            f"dependency floor {r['dependency_floor_ms']} ms "
            f"({r['reductions']} cluster reductions x "
            f"{barrier_ms * 1e3} us barrier)")
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
        check(metrics.counter("nomad.solver.warmup.artifacts") - a0 == 11,
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
            check(d["cpu_solves"] == 0 and d["dispatch_errors"] == 0,
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
    res.update(chunked_phase(np, torch, dev, res["depth_curve"]["floor_ms"]))
    ex = explain_phase(np, torch, dev)
    main = main_path_phase(torch)
    service = service_phase(np, torch)
    compare = compare_phase(torch)
    prof = profile_phase(torch)
    small_phase(torch)
    ladder = ladder_phase(np, torch)
    server = server_phase(np, torch, card)
    nodes = server.pop("nodes_snapshot")        # the 10,000-node fleet
    stream = stream_phase(np, torch, nodes, card)
    rejections = rejection_phase(np, torch, card)
    fault = server_fault_phase(np, torch, nodes)
    t_cvx = time.perf_counter()
    cvx = convex_kernel_phase(np, torch, dev,
                              res["depth_curve"]["floor_ms"])
    cvx_server = convex_server_phase(np, torch, nodes)
    log(f"convex phase: {time.perf_counter() - t_cvx:.1f} s")

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
    res["convex_solve"] = cvx["bench_binpack"]
    rows = []
    for name, (src, rep) in meta.items():
        r = res[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": rep, "launches": launches[name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None,
               "floor_ms": r["floor_ms"], "call_ms": r["call_ms"]}
        for k in ("near_tie_rows", "moved_nodes", "grid_ms", "spread_ms",
                  "k512_ms", "depths_evaluated", "score_ms", "steps",
                  "solve_device_ms", "barrier_ms", "dependency_floor_ms",
                  "solo_8_ms", "iterations", "eval_device_ms",
                  "eval_call_ms"):
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
                    "convex_server": cvx_server,
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
