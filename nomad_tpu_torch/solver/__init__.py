"""Batched placement solver on the card — the north star (BASELINE.json):
the scheduler's scoring loop as dense tensor programs over node×resource
matrices, registered as SchedulerAlgorithm="tpu-batch" next to
binpack/spread. Counterpart of nomad_tpu/solver, one card: the depth and
greedy solves and the chunked scan with their hand kernels
(cuda_kernels.py), batched preemption, the backend selector with its
dispatch chain and health breaker, explain, tensorize, the card-resident
state cache (state_cache.py) and the placer's serial route and pipelined
plan lifecycle.

Eval micro-batching (microbatch.py) coalesces concurrent evals' small
depth solves into one lane-batched launch; the copied server's hooks
(eval broker, overload controller, plan applier) reach it lazily and
find it. `sharding.py` is the single-card part of the reference's
(snapshot, generation, describe). `backend.warmup` builds every kernel
at leadership establishment.

The convex tier (convex.py; scheduler_algorithm "convex") solves a
depth or greedy eval as one projected-gradient program over the state
cache's resident twins, one launch of csrc/convex_solve.cu on a card.

Not ported yet: the fused route, the sharded solves (`make_mesh`,
`sharded_fill_greedy`) and the reference's host floor and pipeline
degrade path (card work never moves to the CPU). The copied
plan applier's `state_cache` hooks find this package's cache: the
evaluate pass gathers from it and every commit feeds it.
"""
from .device import solve_device, use_device  # noqa: F401
from .kernels import (  # noqa: F401
    DEPTH_GRID, FIT_EPS, NUM_XR, XR_CPU, XR_DISK, XR_MBITS, XR_MEM,
    XR_PORTS, depth_curve_ref, fill_depth, fill_greedy_binpack,
    instance_capacity, place_chunked, plan_fit_verdict, preempt_top_k,
    preemption_distance, score_capacity_ref, score_fit,
)
from .tensorize import (  # noqa: F401
    GroupTensors, alloc_usage_row, build_group_tensors, group_ask_row,
    node_capacity_row,
)
from .placer import SolverPlacer  # noqa: F401
