"""Batched placement solver on the card — the north star (BASELINE.json):
the scheduler's scoring loop as dense tensor programs over node×resource
matrices, registered as SchedulerAlgorithm="tpu-batch" next to
binpack/spread. Counterpart of nomad_tpu/solver, main-path subset: the
depth and greedy solves with their hand kernels (cuda_kernels.py), the
backend selector, tensorize and the serial placer.

Not ported yet: the device state cache, eval micro-batching, explain, the
chunked scan, preemption, the convex tier and sharding. The copied
scheduler and plan applier reach three of those lazily inside `try`
(server/plan_apply.py's `microbatch` and `state_cache` hooks); finding no
such module here, they take their documented solver-less branch: the
applier reports no in-flight evals and gathers its rows from the usage
view.
"""
from .device import solve_device, use_device  # noqa: F401
from .kernels import (  # noqa: F401
    DEPTH_GRID, FIT_EPS, NUM_XR, XR_CPU, XR_DISK, XR_MBITS, XR_MEM,
    XR_PORTS, depth_curve_ref, fill_depth, fill_greedy_binpack,
    instance_capacity, plan_fit_verdict, score_capacity_ref, score_fit,
)
from .tensorize import (  # noqa: F401
    GroupTensors, alloc_usage_row, build_group_tensors, group_ask_row,
    node_capacity_row,
)
from .placer import SolverPlacer  # noqa: F401
