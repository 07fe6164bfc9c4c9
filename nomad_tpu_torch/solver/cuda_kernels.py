"""Hand-written CUDA kernels for the placement hot loop — the counterpart
of nomad_tpu/solver/pallas_kernels.py.

  depth_curve     csrc/depth_curve.cu, replaces `_depth_curve_kernel`
                  (the depth solver's per-node curve producer); one
                  launch takes L lanes, so a solo solve is one lane
  depth_curve_lanes  the same launch over a window's lanes: the
                  eval-stream micro-batch window (the reference's
                  jit(vmap(fill_depth)), microbatch.py `_batched_fn`);
                  `fill_depth_lanes` is it plus the torch tail over
                  [L, N], the tail a solo solve runs with L = 1
  score_capacity  csrc/score_capacity.cu, replaces
                  `_score_capacity_kernel` (the greedy inner pass; its
                  greedy entry also folds in the greedy tail's key step)
  chunked_scan    csrc/chunked_scan.cu, the whole chunked scan in one
                  launch: a persistent cluster of 8 CTAs that keeps the
                  running state on chip (no Pallas counterpart: the
                  reference runs the scan as one XLA program);
                  `place_chunked` launches it once per solve
  convex_solve    csrc/convex_solve.cu, the convex tier's projected-
                  gradient solve in one launch: a persistent cluster of 8
                  CTAs that keeps the iterate on chip (no Pallas
                  counterpart: the reference runs it as one XLA program,
                  convex.py `convex_eval`); `convex_eval_fused` is the
                  whole eval with it and the score/capacity kernel's
                  greedy entry as the baseline
  depth_curve_gather  the depth-curve kernel's gather entry (csrc/
                  depth_curve.cu): each lane's rows read through idx from
                  the state cache's resident twins, never copied out —
                  the whole-eval fused route's producer (ref kernels.
                  fused_eval_depth, whose XLA program inlines
                  gather_rows); solo solves and micro-batch windows
                  share it
  score_capacity_gather  the score/capacity kernel's greedy entry
                  through idx the same way (ref kernels.
                  fused_eval_greedy)
  fit_verdict     csrc/fit_verdict.cu, the fused route's plan-fit
                  verdict through idx (no Pallas counterpart: part of the
                  reference's fused XLA program); it writes the placement
                  vector beside the verdict, so the eval's results reach
                  the host in one copy (fused_to_host)
  chunked_shard   csrc/chunked_shard.cu, the scan with its node axis
                  sharded (the reference's sharded_place_chunked): one
                  launch a device a step, a cluster of 8 CTAs for each of
                  its shards, max_steps + 1 a device queued by one
                  launcher call, each shard ranking every shard's offers
                  itself
  convex_shard    csrc/convex_shard.cu, the convex solve with its node
                  axis sharded (the reference's sharded_convex): one
                  launch a device a reduction round, a cluster of 8 x
                  1,024 threads for each of its shards, queued in blocks
                  of rounds with one wait a block (convex_solve_sharded)
  chunked_step    csrc/chunked_step.cu, one scan step's score pass: the
                  score the scan kernel shares (csrc/chunked_score.cuh),
                  held bit for bit against the plain step; no placer path
                  launches it
  launch_floor    csrc/launch_floor.cu, an empty kernel: the card's
                  launch floor, and the fit verdict's grid doing only
                  its dependent gather, for measurement only
  pow10_check     csrc/pow10_check.cu, the exhaustive check of
                  csrc/pow10.cuh, for chip_smoke.py

The placement kernels take 10**x from csrc/pow10.cuh: exactly the plain
version's float64 pow rounded to float32, by a cheap estimate that falls
back to the float64 pow where it cannot decide the rounding.

Build: each source is compiled by `nvcc` for sm_90a into its own shared
library with a plain C interface, loaded with ctypes. The libraries go
under build/kernels/ at the repo root, named by a hash of their source
and of every csrc/*.cuh header, so an unchanged tree does not rebuild;
all sources compile in parallel at first use. No fast math (the kernels
take floor of quotients and pow) and no FMA contraction, so the kernels
round like their plain versions. A source that does not build (or no
nvcc) raises KernelBuildError, which the backend passes through
untouched; a launch that reports a CUDA error raises KernelLaunchError,
a device error that feeds the backend's breaker before it raises.

Wrappers: `fill_depth_fused`, `fill_greedy_binpack_fused`,
`place_chunked`, `convex_eval_fused`, `fused_eval_depth` and
`fused_eval_greedy` keep the reference signatures; `fill_depth_lanes`
and `fused_eval_depth_lanes` take their plain versions'. A wrapper given CPU
tensors runs the plain version (kernels.py, convex.py), though the
placer itself routes CPU solves to the torch tier (backend.select);
given CUDA tensors it checks device, dtype, shape and
contiguity, allocates its outputs (and the scan's scratch), launches on
the current stream and raises if the launch reports an error. `LAUNCHES`
counts the launches of each placement kernel; nothing else adds to it
(the metrics registry's `nomad.solver.kernel_launches.<name>` mirrors it).
Loading a library counts `nomad.compile_cache.hits` when it was found
built (runtime.enable_compile_cache points BUILD_DIR at a durable
directory); each library nvcc builds counts `nomad.compile_cache.misses`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..metrics import metrics
from . import convex, kernels
from .buckets import BATCH_LANES
from .device import device_program
from .kernels import NUM_XR, _greedy_fill

REPO_ROOT = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
SOURCES = {"depth_curve": "depth_curve.cu",
           "score_capacity": "score_capacity.cu",
           "chunked_step": "chunked_step.cu",
           "chunked_scan": "chunked_scan.cu",
           "convex_solve": "convex_solve.cu",
           "chunked_shard": "chunked_shard.cu",
           "convex_shard": "convex_shard.cu",
           "fit_verdict": "fit_verdict.cu",
           "launch_floor": "launch_floor.cu",
           "pow10_check": "pow10_check.cu"}
# the placement kernels' launch counts (depth_curve counts solo solves,
# depth_curve_lanes the windows: one entry of depth_curve.cu; the fused
# route's gather entries count apart from the entries they share a
# kernel with)
KERNELS = ("depth_curve", "depth_curve_lanes", "score_capacity",
           "chunked_step", "chunked_scan", "convex_solve",
           "depth_curve_gather", "score_capacity_gather", "fit_verdict",
           "chunked_shard", "convex_shard")
# the kernels the placer's solves launch on one card: the first one a
# process finds unbuilt has all of them built at once (one nvcc a
# source), so a cold server pays the slowest build once, not each build
# as its solve first needs it, and its data dir then holds them all for
# a restart. The mesh's two kernels build at their first use (a mesh
# server's warmup drives both): a server on one card never launches
# them, and their nvcc would compete with its start
SOLVE_KERNELS = ("depth_curve", "score_capacity", "chunked_scan",
                 "convex_solve", "fit_verdict")
MAX_GRID = 32           # csrc/depth_curve.cu DepthGrid capacity
MAX_LANES = BATCH_LANES  # csrc/depth_curve.cu LaneScalars capacity

LAUNCHES = {name: 0 for name in KERNELS}
# host waits a sharded convex solve made (one a block of rounds)
WAITS = {"convex_shard": 0}
BUILD_LOG: dict = {}    # name -> nvcc output (registers, spills)
_fns: dict = {}         # (name, symbol) -> the library's function
_build_lock = threading.Lock()
_launch_lock = threading.Lock()     # LAUNCHES: workers launch concurrently

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "depth_curve_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P,
                           _I, _I, _P, _P],
    "depth_curve_gather_launch": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _P, _P, _I, _P, _I, _I, _P, _P],
    "score_capacity_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "score_capacity_gather_launch": [_P, _P, _I, _P, _P, _P, _P, _I, _I,
                                     _I, _P, _P],
    "fit_verdict_launch": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    "chunked_step_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P, _P,
                            _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P,
                            _P],
    "chunked_scan_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P, _P,
                            _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                            _I, _P, _P, _P, _P],
    "chunked_scan_scratch_bytes": [_I, _I, _I, _I, _I],
    "chunked_scan_barrier_launch": [_I, _I, _P],
    "convex_solve_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                            _F, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P],
    "convex_solve_scratch_bytes": [_I],
    "chunked_shard_launch": [_P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P],
    "chunked_shard_scratch_bytes": [_I, _I, _I, _I, _I],
    "chunked_shard_cand_bytes": [_I, _I, _I],
    "convex_shard_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F,
                            _F, _F, _I, _I, _P],
    "convex_shard_scratch_bytes": [_I],
    "convex_shard_done_offset": [],
    "launch_floor_launch": [_P],
    "launch_floor_gather_launch": [_P, _P, _I, _I, _P, _P],
    "pow10_check_launch": [ctypes.c_uint, ctypes.c_uint, _P, _P],
}


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        for name in WAITS:
            WAITS[name] = 0


class KernelBuildError(RuntimeError):
    """A kernel's library could not be built (nvcc missing or failing).
    Not a device error: the solve raises it and the breaker never sees
    it (backend.device_error_types leaves it out)."""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError("nvcc not found: the CUDA kernels are built "
                               "with the CUDA toolkit's nvcc")
    return path


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of the flags, the source and
    every header in csrc/ (a changed header must not reuse a stale
    library)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> float:
    """Compile every kernel whose library is missing, one nvcc process
    per source, all started together. Returns the seconds spent."""
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        # the memoized loader's build step (_fn): nvcc runs only for a
        # library missing from BUILD_DIR, whose name hashes its source,
        # headers and flags — nomadlint: disable=JIT002
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    metrics.incr("nomad.compile_cache.misses", len(todo) - len(failed))
    if failed:
        raise KernelBuildError("CUDA kernel build failed:\n" +
                               "\n".join(failed))
    return time.perf_counter() - t0


def _fn(name: str, symbol: str = "launch"):
    """The function `<name>_<symbol>` of kernel `name`'s library (its
    launch function by default), built and loaded at first use."""
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    with _build_lock:
        fn = _fns.get((name, symbol))
        if fn is None:
            path = _lib_path(name)
            if path.exists():
                metrics.incr("nomad.compile_cache.hits")
            else:
                build(SOLVE_KERNELS if name in SOLVE_KERNELS else [name])
            fn = getattr(ctypes.CDLL(str(path)), f"{name}_{symbol}")
            fn.argtypes = _ARGTYPES[f"{name}_{symbol}"]
            fn.restype = (ctypes.c_longlong
                          if symbol.endswith(("_bytes", "_offset"))
                          else ctypes.c_int)
            _fns[(name, symbol)] = fn
    return fn


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    """Raise, naming the fault, unless `t` is a contiguous tensor of
    `dtype` and `shape` on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")


def _fits(t, dtype, shape, device) -> bool:
    return (isinstance(t, torch.Tensor) and t.dtype is dtype
            and t.shape == shape and t.device == device and t.is_contiguous())


def _check_rows(cap, used, ask, feasible, *columns) -> int:
    """Raise on what a kernel does not take: cap and used f32[N, 5], ask
    f32[5], feasible bool[N] and each (tensor, name, dtype) of `columns`
    of length N, all contiguous on one CUDA device. -> N."""
    dev = cap.device
    if dev.type != "cuda":
        raise ValueError(f"cap: on {dev}, expected a CUDA device")
    n = cap.shape[0]
    rows, col = (n, NUM_XR), (n,)
    for t, what, dtype, shape in ((cap, "cap", torch.float32, rows),
                                  (used, "used", torch.float32, rows),
                                  (ask, "ask", torch.float32, (NUM_XR,)),
                                  (feasible, "feasible", torch.bool, col)):
        if not _fits(t, dtype, shape, dev):
            _check(t, what, dtype, shape, dev)
    for t, what, dtype in columns:
        if not _fits(t, dtype, col, dev):
            _check(t, what, dtype, col, dev)
    return n


class KernelLaunchError(RuntimeError):
    """A placement kernel's launch reported a CUDA error; `code` is its
    cudaError_t (backend.classify_device_error reads it)."""

    def __init__(self, msg: str, code: int = 0):
        super().__init__(msg)
        self.code = code


def _launched(name: str, err: int, n: int = 1) -> None:
    """Count `n` launches of kernel `name` (a sharded solve's launcher
    queues many in one call), or raise the launch's error."""
    if err != 0:
        raise KernelLaunchError(
            f"{name} kernel launch failed: cudaError_t {err}", err)
    with _launch_lock:
        LAUNCHES[name] += n
    # a kernel's name: one of the fixed SOURCES (its LAUNCHES key), not a
    # cluster entity — nomadlint: disable=OBS001
    metrics.incr(f"nomad.solver.kernel_launches.{name}", n)


def _stream(dev) -> int:
    """The raw handle of `dev`'s current stream (what
    torch.cuda.current_stream(dev).cuda_stream gives, without building a
    Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


@functools.lru_cache(maxsize=64)
def _grid_array(grid: tuple) -> tuple:
    """(ctypes float[MAX_GRID], its address) for a depth grid, built once
    per grid; the launch copies it into the kernel's by-value argument."""
    arr = (ctypes.c_float * MAX_GRID)(*[float(g) for g in grid])
    return arr, ctypes.addressof(arr)


def _depth_statics(k_max, depth_grid) -> tuple:
    """(grid, its address) for a depth-curve launch, after checking what
    the kernel takes: at most MAX_GRID sampled depths, or 1..4096 dense."""
    grid = () if depth_grid is None else tuple(depth_grid)
    if len(grid) > MAX_GRID:
        raise ValueError(f"depth_grid has {len(grid)} depths, the kernel "
                         f"takes at most {MAX_GRID}")
    if not grid and not 1 <= int(k_max) <= 4096:
        raise ValueError(f"k_max {k_max} out of range")
    return grid, _grid_array(grid)[1]


def _launch_depth_curve(name, lead, cap, used, ask, feasible,
                        job_collisions, desired_counts, affinity_boost,
                        max_per_node, k_max, spread_algorithm,
                        depth_grid, gather=None) -> tuple:
    """One launch of the depth-curve kernel on CUDA tensors, counted under
    `name`: `lead` is () for one lane of [N] inputs (cap/used [N, 5], ask
    [5], the rest [N]) and (L,) for L stacked lanes ([L, N, 5], [L, 5],
    [L, N]); desired_counts and max_per_node are one host scalar a lane.
    With `gather` = (idx, valid) (lead + [N] each) the gather entry runs:
    cap/used are the resident twins [R, 5], one pair for every lane, and
    lane l's row b is twin row idx[l, b] (zero where valid is False).
    -> (d_star, k_star, k_cap) of shape lead + [N] (f32, i32, i32), the
    rows of one int32 lead + [3, N] buffer; d_star is -inf where no depth
    fits."""
    dev = cap.device
    if dev.type != "cuda":
        raise ValueError(f"cap: on {dev}, expected a CUDA device")
    if gather is None:
        if cap.dim() != len(lead) + 2:
            raise ValueError(f"cap: shape {tuple(cap.shape)}, expected "
                             f"{list(lead)} + [nodes, {NUM_XR}]")
        n = cap.shape[len(lead)]
        rows = lead + (n, NUM_XR)
        mats = ((cap, "cap", torch.float32, rows),
                (used, "used", torch.float32, rows))
    else:
        idx, valid = gather
        if idx.dim() != len(lead) + 1:
            raise ValueError(f"idx: shape {tuple(idx.shape)}, expected "
                             f"{list(lead)} + [rows]")
        n, n_res = idx.shape[-1], cap.shape[0]
        twin = (n_res, NUM_XR)
        mats = ((cap, "cap_res", torch.float32, twin),
                (used, "used_res", torch.float32, twin),
                (idx, "idx", torch.int32, lead + (n,)),
                (valid, "valid", torch.bool, lead + (n,)))
    n_lanes = lead[0] if lead else 1
    if not 0 < n_lanes <= MAX_LANES:
        raise ValueError(f"{n_lanes} lanes: the kernel takes 1.."
                         f"{MAX_LANES}")
    if len(desired_counts) != n_lanes or len(max_per_node) != n_lanes:
        raise ValueError("desired_counts and max_per_node need one value "
                         "a lane")
    col = lead + (n,)
    for t, what, dtype, shape in mats + (
            (ask, "ask", torch.float32, lead + (NUM_XR,)),
            (feasible, "feasible", torch.bool, col),
            (job_collisions, "job_collisions", torch.int32, col),
            (affinity_boost, "affinity_boost", torch.float32, col)):
        if not _fits(t, dtype, shape, dev):
            _check(t, what, dtype, shape, dev)
    grid, g_ptr = _depth_statics(k_max, depth_grid)
    desired = (ctypes.c_float * n_lanes)(
        *[float(max(int(d), 1)) for d in desired_counts])
    mpn = (ctypes.c_float * n_lanes)(
        *[float(min(int(m), kernels.MAX_PER_NODE_CAP))
          for m in max_per_node])
    out = torch.empty(lead + (3, n), dtype=torch.int32, device=dev)
    tail = (ask.data_ptr(), feasible.data_ptr(), job_collisions.data_ptr(),
            affinity_boost.data_ptr(), n, n_lanes, ctypes.addressof(desired),
            ctypes.addressof(mpn), int(k_max), g_ptr, len(grid),
            int(bool(spread_algorithm)), out.data_ptr(), _stream(dev))
    if gather is None:
        err = _fn("depth_curve")(cap.data_ptr(), used.data_ptr(), *tail)
    else:
        err = _fn("depth_curve", "gather_launch")(
            cap.data_ptr(), used.data_ptr(), n_res, idx.data_ptr(),
            valid.data_ptr(), *tail)
    _launched(name, err)
    d_star, k_star, k_cap = out.unbind(len(lead))
    return d_star.view(torch.float32), k_star, k_cap


def depth_curve(cap, used, ask, feasible, job_collisions, desired_count,
                affinity_boost, max_per_node=kernels.MAX_PER_NODE_CAP,
                k_max: int = 128, spread_algorithm: bool = False,
                depth_grid=None) -> tuple:
    """(d_star f32[N], k_star i32[N], k_cap i32[N]) — one launch of the
    depth-curve kernel over one lane on CUDA tensors,
    kernels.depth_curve_ref on CPU tensors. d_star is -inf where no depth
    fits."""
    if cap.device.type == "cpu":
        return kernels.depth_curve_ref(
            cap, used, ask, feasible, job_collisions, desired_count,
            affinity_boost, max_per_node=max_per_node, k_max=k_max,
            spread_algorithm=spread_algorithm, depth_grid=depth_grid)
    return _launch_depth_curve(
        "depth_curve", (), cap, used, ask, feasible, job_collisions,
        (desired_count,), affinity_boost, (max_per_node,), k_max,
        spread_algorithm, depth_grid)


def fill_depth_fused(cap, used, ask, count, feasible, job_collisions,
                     desired_count, affinity_boost,
                     max_per_node=kernels.MAX_PER_NODE_CAP,
                     order_jitter=None, jitter_scale=0.5,
                     jitter_samples=0.0, k_max: int = 128,
                     spread_algorithm: bool = False, depth_grid=None):
    """kernels.fill_depth with the depth-curve kernel as its producer:
    same signature and semantics, the E-S order/take tail shared."""
    d_star, k_star, k_cap = depth_curve(
        cap, used, ask, feasible, job_collisions, desired_count,
        affinity_boost, max_per_node=max_per_node, k_max=k_max,
        spread_algorithm=spread_algorithm, depth_grid=depth_grid)
    return kernels._depth_order_take_one(d_star, k_star, k_cap, count,
                                         order_jitter, jitter_scale,
                                         jitter_samples)


def depth_curve_lanes(cap, used, ask, feasible, job_collisions,
                      desired_counts, affinity_boost, max_per_node,
                      k_max: int = 128, spread_algorithm: bool = False,
                      depth_grid=None) -> tuple:
    """(d_star f32[L, N], k_star i32[L, N], k_cap i32[L, N]) — one launch
    of the depth-curve kernel over a window's stacked CUDA tensors
    (cap/used [L, N, 5], ask [L, 5], feasible/job_collisions/
    affinity_boost [L, N]; desired_counts and max_per_node L host
    scalars), kernels.depth_curve_lanes_ref on CPU tensors. Lane l equals
    depth_curve on lane l's slices, bit for bit."""
    if cap.device.type == "cpu":
        return kernels.depth_curve_lanes_ref(
            cap, used, ask, feasible, job_collisions, desired_counts,
            affinity_boost, max_per_node, k_max=k_max,
            spread_algorithm=spread_algorithm, depth_grid=depth_grid)
    return _launch_depth_curve(
        "depth_curve_lanes", tuple(cap.shape[:1]), cap, used, ask, feasible,
        job_collisions, desired_counts, affinity_boost, max_per_node, k_max,
        spread_algorithm, depth_grid)


def fill_depth_lanes(cap, used, ask, counts, feasible, job_collisions,
                     desired_counts, affinity_boost, max_per_node,
                     order_jitter=None, jitter_scales=None,
                     jitter_samples=None, k_max: int = 128,
                     spread_algorithm: bool = False, depth_grid=None):
    """kernels.fill_depth_lanes with the depth-curve kernel as its
    producer: one launch for the whole window, then the torch tail over
    [L, N]. Lane l equals fill_depth_fused on lane l alone, bit for
    bit."""
    d_star, k_star, k_cap = depth_curve_lanes(
        cap, used, ask, feasible, job_collisions, desired_counts,
        affinity_boost, max_per_node, k_max=k_max,
        spread_algorithm=spread_algorithm, depth_grid=depth_grid)
    return kernels._depth_order_take(d_star, k_star, k_cap, counts,
                                     order_jitter, jitter_scales,
                                     jitter_samples)


def _launch_score_capacity(cap, used, ask, feasible, spread: bool,
                           greedy: bool, max_per_node) -> tuple:
    """One launch of the score/capacity kernel on CUDA tensors, the two
    rows of one int32 [2, N] output buffer: (capacity i32[N], score
    f32[N]), or with `greedy` (capacity clamped to max_per_node, sort key
    f32[N]) as kernels._greedy_key gives them."""
    n = _check_rows(cap, used, ask, feasible)
    dev = cap.device
    mpn = min(int(max_per_node), kernels.MAX_PER_NODE_CAP)
    out = torch.empty((2, n), dtype=torch.int32, device=dev)
    err = _fn("score_capacity")(
        cap.data_ptr(), used.data_ptr(), ask.data_ptr(), feasible.data_ptr(),
        n, int(bool(spread)), int(bool(greedy)), mpn, out.data_ptr(),
        _stream(dev))
    _launched("score_capacity", err)
    capacity, second = out.unbind(0)
    return capacity, second.view(torch.float32)


def score_capacity_fused(cap, used, ask, feasible, spread: bool = False):
    """(capacity i32[N], score f32[N]) — the score/capacity kernel on
    CUDA tensors, kernels.score_capacity_ref on CPU tensors."""
    if cap.device.type == "cpu":
        return kernels.score_capacity_ref(cap, used, ask, feasible,
                                          spread=spread)
    return _launch_score_capacity(cap, used, ask, feasible, spread, False,
                                  kernels.MAX_PER_NODE_CAP)


def score_capacity_greedy(cap, used, ask, feasible,
                          max_per_node=kernels.MAX_PER_NODE_CAP) -> tuple:
    """(capacity clamped to max_per_node i32[N], greedy sort key f32[N])
    — one launch of the score/capacity kernel's greedy entry on CUDA
    tensors; kernels._greedy_key of score_capacity_ref on CPU tensors.
    Row-local: a sharded solve runs it on each shard's block."""
    if cap.device.type == "cpu":
        return kernels._greedy_key(
            *kernels.score_capacity_ref(cap, used, ask, feasible),
            max_per_node)
    return _launch_score_capacity(cap, used, ask, feasible, False, True,
                                  max_per_node)


def fill_greedy_binpack_fused(cap, used, ask, count, feasible,
                              max_per_node=kernels.MAX_PER_NODE_CAP):
    """kernels.fill_greedy_binpack with the score/capacity kernel's
    greedy entry as its producer: the kernel writes the clamped capacity
    and the sort key, the shared stable sort + cumsum tail takes."""
    if cap.device.type == "cpu":
        return kernels.fill_greedy_binpack(cap, used, ask, count, feasible,
                                           max_per_node=max_per_node)
    return _greedy_fill(*score_capacity_greedy(cap, used, ask, feasible,
                                               max_per_node), count)


# ------------------------------------------------- the whole-eval route

def _check_twins(cap_res, used_res, idx, valid, lead) -> tuple:
    """Raise unless cap_res/used_res are f32 [R, 5] twins on one CUDA
    device and idx/valid int32/bool of shape lead + [B] there. -> (the
    device, R, B)."""
    dev = cap_res.device
    if dev.type != "cuda":
        raise ValueError(f"cap_res: on {dev}, expected a CUDA device")
    if idx.dim() != len(lead) + 1:
        raise ValueError(f"idx: shape {tuple(idx.shape)}, expected "
                         f"{list(lead)} + [rows]")
    n_res, n = cap_res.shape[0], idx.shape[-1]
    for t, what, dtype, shape in (
            (cap_res, "cap_res", torch.float32, (n_res, NUM_XR)),
            (used_res, "used_res", torch.float32, (n_res, NUM_XR)),
            (idx, "idx", torch.int32, lead + (n,)),
            (valid, "valid", torch.bool, lead + (n,))):
        if not _fits(t, dtype, shape, dev):
            _check(t, what, dtype, shape, dev)
    return dev, n_res, n


def depth_curve_gather(cap_res, used_res, idx, valid, ask, feasible,
                       job_collisions, desired_counts, affinity_boost,
                       max_per_node, k_max: int = 128,
                       spread_algorithm: bool = False,
                       depth_grid=None) -> tuple:
    """(d_star f32[L, B], k_star i32[L, B], k_cap i32[L, B]) — one launch
    of the depth-curve kernel's gather entry: lane l over rows idx[l] of
    the resident twins (cap_res/used_res [R, 5]; idx, valid, feasible,
    job_collisions and affinity_boost [L, B]; ask [L, 5];
    desired_counts and max_per_node L host scalars). A solo solve is one
    lane. On CPU tensors: kernels.depth_curve_lanes_ref on the gathered
    rows (kernels.gather_lanes)."""
    if cap_res.device.type == "cpu":
        cap, used = kernels.gather_lanes(cap_res, used_res, idx, valid)
        return kernels.depth_curve_lanes_ref(
            cap, used, ask, feasible, job_collisions, desired_counts,
            affinity_boost, max_per_node, k_max=k_max,
            spread_algorithm=spread_algorithm, depth_grid=depth_grid)
    return _launch_depth_curve(
        "depth_curve_gather", tuple(idx.shape[:1]), cap_res, used_res, ask,
        feasible, job_collisions, desired_counts, affinity_boost,
        max_per_node, k_max, spread_algorithm, depth_grid,
        gather=(idx, valid))


def score_capacity_gather(cap_res, used_res, idx, valid, ask, feasible,
                          max_per_node=kernels.MAX_PER_NODE_CAP) -> tuple:
    """(capacity clamped to max_per_node i32[B], greedy sort key f32[B])
    — one launch of the score/capacity kernel's greedy entry over rows idx
    of the resident twins (idx, valid, feasible [B]; ask [5]). On CPU
    tensors: kernels._greedy_key of score_capacity_ref on the gathered
    rows."""
    if cap_res.device.type == "cpu":
        cap, used = kernels.gather_rows(cap_res, used_res, idx, valid)
        return kernels._greedy_key(
            *kernels.score_capacity_ref(cap, used, ask, feasible),
            max_per_node)
    dev, n_res, n = _check_twins(cap_res, used_res, idx, valid, ())
    for t, what, dtype, shape in ((ask, "ask", torch.float32, (NUM_XR,)),
                                  (feasible, "feasible", torch.bool, (n,))):
        if not _fits(t, dtype, shape, dev):
            _check(t, what, dtype, shape, dev)
    out = torch.empty((2, n), dtype=torch.int32, device=dev)
    err = _fn("score_capacity", "gather_launch")(
        cap_res.data_ptr(), used_res.data_ptr(), n_res, idx.data_ptr(),
        valid.data_ptr(), ask.data_ptr(), feasible.data_ptr(), n, 0,
        min(int(max_per_node), kernels.MAX_PER_NODE_CAP), out.data_ptr(),
        _stream(dev))
    _launched("score_capacity_gather", err)
    capacity, key = out.unbind(0)
    return capacity, key.view(torch.float32)


def fit_verdict(cap_res, used_res, idx, valid, ask, placed) -> tuple:
    """(placed i32, fit bool), both of placed's shape — one launch of the
    fit-verdict kernel over rows idx of the resident twins: idx, valid
    and placed [B] with ask [5], or [L, B] with ask [L, 5]. On a card
    both results are views of one buffer the kernel writes (placed
    copied beside the verdict), so fused_to_host brings them back in one
    copy. On CPU tensors: (placed, kernels.fit_verdict_ref)."""
    if cap_res.device.type == "cpu":
        return placed, kernels.fit_verdict_ref(cap_res, used_res, idx, valid,
                                               ask, placed)
    lead = tuple(idx.shape[:-1])
    dev, n_res, n = _check_twins(cap_res, used_res, idx, valid, lead)
    n_lanes = lead[0] if lead else 1
    if not 0 < n_lanes <= MAX_LANES:
        raise ValueError(f"{n_lanes} lanes: the kernel takes 1.."
                         f"{MAX_LANES}")
    for t, what, dtype, shape in (
            (ask, "ask", torch.float32, lead + (NUM_XR,)),
            (placed, "placed", torch.int32, lead + (n,))):
        if not _fits(t, dtype, shape, dev):
            _check(t, what, dtype, shape, dev)
    rows = n_lanes * n
    buf = torch.empty((5 * rows,), dtype=torch.uint8, device=dev)
    placed_out = buf[:4 * rows].view(torch.int32).view(lead + (n,))
    fit = buf[4 * rows:].view(torch.bool).view(lead + (n,))
    err = _fn("fit_verdict")(
        cap_res.data_ptr(), used_res.data_ptr(), n_res, idx.data_ptr(),
        valid.data_ptr(), ask.data_ptr(), placed.data_ptr(), n, n_lanes,
        placed_out.data_ptr(), fit.data_ptr(), _stream(dev))
    _launched("fit_verdict", err)
    return placed_out, fit


def fused_to_host(placed, fit) -> tuple:
    """fit_verdict's (placed, fit) as numpy through ONE device-to-host
    copy of the buffer they are views of. CPU tensors pass through."""
    if placed.device.type == "cpu":
        # CPU tensors: no copy — nomadlint: disable=SYNC001
        return placed.numpy(), fit.numpy()
    storage, rows = placed.untyped_storage(), placed.numel()
    if storage.nbytes() != 5 * rows or \
            placed.data_ptr() != storage.data_ptr() or \
            fit.data_ptr() != storage.data_ptr() + 4 * rows:
        raise ValueError("placed and fit are not views of fit_verdict's "
                         "buffer")
    buf = torch.empty(0, dtype=torch.uint8,
                      device=placed.device).set_(storage)
    # the fused route's ONE copy to the host: the seam the placer's fused
    # solve and the fused window reach — nomadlint: disable=SYNC001
    host = buf.cpu()
    return (host[:4 * rows].view(torch.int32).view(placed.shape).numpy(),
            host[4 * rows:].view(torch.bool).view(fit.shape).numpy())


@device_program
def fused_eval_depth(cap_res, used_res, idx, valid, ask, count, feasible,
                     job_collisions, desired_count, affinity_boost,
                     max_per_node, order_jitter, jitter_scale,
                     jitter_samples, class_ids, distinct_hosts,
                     k_max: int = 128, spread_algorithm: bool = False,
                     depth_grid=None, n_classes: int = 0) -> tuple:
    """kernels.fused_eval_depth on the card: the depth-curve kernel's
    gather entry (one lane), the shared torch order/take tail, the
    fit-verdict kernel; nothing read back. -> (placed i32[B], fit
    bool[B]), views of one buffer (fused_to_host). CPU tensors run the
    plain version. The card's program reduces no explain classes (the
    placer explains on the host), so `n_classes` must be 0 there."""
    if cap_res.device.type == "cpu":
        return kernels.fused_eval_depth(
            cap_res, used_res, idx, valid, ask, count, feasible,
            job_collisions, desired_count, affinity_boost, max_per_node,
            order_jitter, jitter_scale, jitter_samples, class_ids,
            distinct_hosts, k_max=k_max, spread_algorithm=spread_algorithm,
            depth_grid=depth_grid, n_classes=n_classes)
    if n_classes:
        raise ValueError("the card's fused program reduces no explain "
                         "classes: the placer explains on the host")
    del class_ids, distinct_hosts
    return _fused_depth(cap_res, used_res, idx[None], valid[None], ask[None],
                        (count,), feasible[None], job_collisions[None],
                        (desired_count,), affinity_boost[None],
                        (max_per_node,),
                        None if order_jitter is None else order_jitter[None],
                        (jitter_scale,), (jitter_samples,), k_max,
                        spread_algorithm, depth_grid, solo=True)


@device_program
def fused_eval_depth_lanes(cap_res, used_res, idx, valid, ask, counts,
                           feasible, job_collisions, desired_counts,
                           affinity_boost, max_per_node, order_jitter=None,
                           jitter_scales=None, jitter_samples=None,
                           k_max: int = 128, spread_algorithm: bool = False,
                           depth_grid=None) -> tuple:
    """kernels.fused_eval_depth_lanes on the card: one launch of the
    gather entry over the window's lanes (one twin pair), the torch tail
    over [L, B] and one verdict launch. -> (placed i32[L, B], fit
    bool[L, B]), views of one buffer; lane l equals fused_eval_depth on
    lane l alone, bit for bit. CPU tensors run the plain version."""
    if cap_res.device.type == "cpu":
        return kernels.fused_eval_depth_lanes(
            cap_res, used_res, idx, valid, ask, counts, feasible,
            job_collisions, desired_counts, affinity_boost, max_per_node,
            order_jitter=order_jitter, jitter_scales=jitter_scales,
            jitter_samples=jitter_samples, k_max=k_max,
            spread_algorithm=spread_algorithm, depth_grid=depth_grid)
    return _fused_depth(cap_res, used_res, idx, valid, ask, counts, feasible,
                        job_collisions, desired_counts, affinity_boost,
                        max_per_node, order_jitter, jitter_scales,
                        jitter_samples, k_max, spread_algorithm, depth_grid)


@device_program
def _fused_depth(cap_res, used_res, idx, valid, ask, counts, feasible,
                 job_collisions, desired_counts, affinity_boost, max_per_node,
                 order_jitter, jitter_scales, jitter_samples, k_max,
                 spread_algorithm, depth_grid, solo: bool = False) -> tuple:
    """The card's fused depth eval over [L, B] lanes; `solo` drops the
    lane axis of one lane's results."""
    d_star, k_star, k_cap = depth_curve_gather(
        cap_res, used_res, idx, valid, ask, feasible, job_collisions,
        desired_counts, affinity_boost, max_per_node, k_max=k_max,
        spread_algorithm=spread_algorithm, depth_grid=depth_grid)
    placed = kernels._depth_order_take(d_star, k_star, k_cap, counts,
                                       order_jitter, jitter_scales,
                                       jitter_samples)
    if solo:
        return fit_verdict(cap_res, used_res, idx[0], valid[0], ask[0],
                           placed[0])
    return fit_verdict(cap_res, used_res, idx, valid, ask, placed)


@device_program
def fused_eval_greedy(cap_res, used_res, idx, valid, ask, count, feasible,
                      max_per_node, class_ids, distinct_hosts,
                      job_collisions, n_classes: int = 0) -> tuple:
    """kernels.fused_eval_greedy on the card: the score/capacity
    kernel's gather entry, the shared stable sort + cumsum tail, the
    fit-verdict kernel. -> (placed i32[B], fit bool[B]), views of one
    buffer. CPU tensors run the plain version; `n_classes` must be 0 on
    the card."""
    if cap_res.device.type == "cpu":
        return kernels.fused_eval_greedy(
            cap_res, used_res, idx, valid, ask, count, feasible,
            max_per_node, class_ids, distinct_hosts, job_collisions,
            n_classes=n_classes)
    if n_classes:
        raise ValueError("the card's fused program reduces no explain "
                         "classes: the placer explains on the host")
    capacity, key = score_capacity_gather(cap_res, used_res, idx, valid,
                                          ask, feasible, max_per_node)
    placed = _greedy_fill(capacity, key, count)
    return fit_verdict(cap_res, used_res, idx, valid, ask, placed)


MAX_STANZAS = 16        # csrc/chunked_score.cuh shared-memory capacity


def chunked_step(cap, used, ask, feasible, job_collisions, placed,
                 max_per_node, desired_count, spread_ids, spread_counts,
                 spread_desired, spread_mode, spread_weights, affinity_boost,
                 distinct_ids, distinct_remaining, d_active,
                 spread_algorithm: bool = False) -> torch.Tensor:
    """One scan step's score f32[N] (-inf where the node cannot take an
    instance now) — one launch of the chunked-step kernel on CUDA
    tensors, kernels.chunked_step_ref on CPU tensors."""
    if cap.device.type == "cpu":
        return kernels.chunked_step_ref(
            cap, used, ask, feasible, job_collisions, placed, max_per_node,
            desired_count, spread_ids, spread_counts, spread_desired,
            spread_mode, spread_weights, affinity_boost, distinct_ids,
            distinct_remaining, d_active, spread_algorithm=spread_algorithm)
    n = _check_rows(cap, used, ask, feasible,
                    (job_collisions, "job_collisions", torch.int32),
                    (placed, "placed", torch.int32),
                    (affinity_boost, "affinity_boost", torch.float32))
    dev = cap.device
    n_s, n_p = spread_counts.shape
    n_d, n_dp = distinct_remaining.shape
    if not 0 < n_s <= MAX_STANZAS or not n_d > 0:
        raise ValueError(f"{n_s} spread and {n_d} distinct stanzas: the "
                         f"kernel takes 1..{MAX_STANZAS} and at least 1")
    for t, what, dtype, shape in (
            (spread_ids, "spread_ids", torch.int32, (n_s, n)),
            (spread_counts, "spread_counts", torch.int32, (n_s, n_p)),
            (spread_desired, "spread_desired", torch.float32, (n_s, n_p)),
            (spread_mode, "spread_mode", torch.int32, (n_s,)),
            (spread_weights, "spread_weights", torch.float32, (n_s,)),
            (distinct_ids, "distinct_ids", torch.int32, (n_d, n)),
            (distinct_remaining, "distinct_remaining", torch.int32,
             (n_d, n_dp)),
            (d_active, "d_active", torch.bool, (n_d,))):
        if not _fits(t, dtype, shape, dev):
            _check(t, what, dtype, shape, dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    err = _fn("chunked_step")(
        cap.data_ptr(), used.data_ptr(), ask.data_ptr(), feasible.data_ptr(),
        job_collisions.data_ptr(), placed.data_ptr(), n,
        min(int(max_per_node), kernels.MAX_PER_NODE_CAP),
        float(max(int(desired_count), 1)), int(bool(spread_algorithm)),
        spread_ids.data_ptr(), spread_counts.data_ptr(),
        spread_desired.data_ptr(), spread_mode.data_ptr(),
        spread_weights.data_ptr(), n_s, n_p, affinity_boost.data_ptr(),
        distinct_ids.data_ptr(), distinct_remaining.data_ptr(),
        d_active.data_ptr(), n_d, n_dp, out.data_ptr(), _stream(dev))
    _launched("chunked_step", err)
    return out


MAX_CHUNK = 256         # csrc/chunked_scan.cu: k = min(N, 256) a step


def chunked_scan(cap, used, ask, count, feasible, job_collisions,
                 desired_count, spread_ids, spread_counts, spread_desired,
                 spread_mode, spread_weights, affinity_boost, distinct_ids,
                 distinct_remaining, max_per_node=kernels.MAX_PER_NODE_CAP,
                 max_steps: int = 256, spread_algorithm: bool = False,
                 placed_init=None) -> tuple:
    """One launch of the scan kernel on CUDA tensors: place_chunked's four
    returns (placed_total, final_used, spread_counts, distinct_remaining,
    in new buffers; the inputs are not modified) and the steps the kernel
    ran, i32[1] on the card (read it only to measure: it syncs)."""
    n = _check_rows(cap, used, ask, feasible,
                    (job_collisions, "job_collisions", torch.int32),
                    (affinity_boost, "affinity_boost", torch.float32))
    dev = cap.device
    n_s, n_p = spread_counts.shape
    n_d, n_dp = distinct_remaining.shape
    if not 0 < n_s <= MAX_STANZAS or not 0 < n_d <= MAX_STANZAS:
        raise ValueError(f"{n_s} spread and {n_d} distinct stanzas: the "
                         f"kernel takes 1..{MAX_STANZAS} of each")
    for t, what, dtype, shape in (
            (spread_ids, "spread_ids", torch.int32, (n_s, n)),
            (spread_counts, "spread_counts", torch.int32, (n_s, n_p)),
            (spread_desired, "spread_desired", torch.float32, (n_s, n_p)),
            (spread_mode, "spread_mode", torch.int32, (n_s,)),
            (spread_weights, "spread_weights", torch.float32, (n_s,)),
            (distinct_ids, "distinct_ids", torch.int32, (n_d, n)),
            (distinct_remaining, "distinct_remaining", torch.int32,
             (n_d, n_dp))):
        if not _fits(t, dtype, shape, dev):
            _check(t, what, dtype, shape, dev)
    count, max_steps = int(count), int(max_steps)
    if max_steps < 1:
        raise ValueError(f"max_steps {max_steps}: the scan takes >= 1")
    # place_chunked's chunk: ceil(count / max_steps), within [1, k]
    chunk = min(max((count + max_steps - 1) // max_steps, 1), min(n, 256))
    if placed_init is None:
        placed = torch.zeros((n,), dtype=torch.int32, device=dev)
    else:
        if not _fits(placed_init, torch.int32, (n,), dev):
            _check(placed_init, "placed_init", torch.int32, (n,), dev)
        placed = placed_init.clone()
    used_out = used.clone()
    sp_out = torch.empty_like(spread_counts)
    dr_out = torch.empty_like(distinct_remaining)
    nbytes = int(_fn("chunked_scan", "scratch_bytes")(n, n_s, n_p, n_d,
                                                        n_dp))
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    err = _fn("chunked_scan")(
        cap.data_ptr(), used_out.data_ptr(), ask.data_ptr(),
        feasible.data_ptr(), job_collisions.data_ptr(), placed.data_ptr(),
        n, min(int(max_per_node), kernels.MAX_PER_NODE_CAP),
        float(max(int(desired_count), 1)), int(bool(spread_algorithm)),
        spread_ids.data_ptr(), spread_counts.data_ptr(),
        spread_desired.data_ptr(), spread_mode.data_ptr(),
        spread_weights.data_ptr(), n_s, n_p, affinity_boost.data_ptr(),
        distinct_ids.data_ptr(), distinct_remaining.data_ptr(), n_d, n_dp,
        count, chunk, max_steps, sp_out.data_ptr(), dr_out.data_ptr(),
        scratch.data_ptr(), _stream(dev))
    _launched("chunked_scan", err)
    # the step count: the first word of the scratch's last 16 bytes
    steps = scratch[nbytes - 16:nbytes - 12].view(torch.int32)
    return placed, used_out, sp_out, dr_out, steps


def place_chunked(cap, used, ask, count, feasible, job_collisions,
                  desired_count, spread_ids, spread_counts, spread_desired,
                  spread_mode, spread_weights, affinity_boost, distinct_ids,
                  distinct_remaining, max_per_node=kernels.MAX_PER_NODE_CAP,
                  max_steps: int = 256, spread_algorithm: bool = False,
                  placed_init=None) -> tuple:
    """kernels.place_chunked as one launch of the scan kernel on CUDA
    tensors (chunked_scan): same signature and returns. CPU tensors run
    the plain version."""
    if cap.device.type == "cpu":
        return kernels.place_chunked(
            cap, used, ask, count, feasible, job_collisions, desired_count,
            spread_ids, spread_counts, spread_desired, spread_mode,
            spread_weights, affinity_boost, distinct_ids,
            distinct_remaining, max_per_node=max_per_node,
            max_steps=max_steps, spread_algorithm=spread_algorithm,
            placed_init=placed_init)
    return chunked_scan(
        cap, used, ask, count, feasible, job_collisions, desired_count,
        spread_ids, spread_counts, spread_desired, spread_mode,
        spread_weights, affinity_boost, distinct_ids, distinct_remaining,
        max_per_node=max_per_node, max_steps=max_steps,
        spread_algorithm=spread_algorithm, placed_init=placed_init)[:4]


def convex_solve(cap, used, ask, feasible, job_collisions, affinity_boost,
                 count, max_per_node, max_iters, tolerance, fairness_weight,
                 quota_budget, spread_algorithm: bool = False) -> tuple:
    """The convex solve (convex.convex_solve_ref's signature and returns:
    x, u_int, cost, budget_int, iterations, gap) — one launch of the
    convex-solve kernel on CUDA tensors, its outputs left on the card;
    the plain version on CPU tensors."""
    if cap.device.type == "cpu":
        return convex.convex_solve_ref(
            cap, used, ask, feasible, job_collisions, affinity_boost, count,
            max_per_node, max_iters, tolerance, fairness_weight,
            quota_budget, spread_algorithm=spread_algorithm)
    n = _check_rows(cap, used, ask, feasible,
                    (job_collisions, "job_collisions", torch.int32),
                    (affinity_boost, "affinity_boost", torch.float32))
    dev = cap.device
    x = torch.empty((n,), dtype=torch.float32, device=dev)
    cost = torch.empty((n,), dtype=torch.float32, device=dev)
    u_int = torch.empty((n,), dtype=torch.int32, device=dev)
    scalars = torch.empty((4,), dtype=torch.int32, device=dev)
    nbytes = int(_fn("convex_solve", "scratch_bytes")(n))
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    err = _fn("convex_solve")(
        cap.data_ptr(), used.data_ptr(), ask.data_ptr(), feasible.data_ptr(),
        job_collisions.data_ptr(), affinity_boost.data_ptr(), n,
        min(int(max_per_node), kernels.MAX_PER_NODE_CAP), int(count),
        int(max_iters), int(bool(spread_algorithm)), float(tolerance),
        float(fairness_weight), float(quota_budget),
        convex.curvature(spread_algorithm),
        convex.step_offset(spread_algorithm), kernels._INV_MAX_SCORE,
        scratch.data_ptr(), x.data_ptr(), u_int.data_ptr(), cost.data_ptr(),
        scalars.data_ptr(), _stream(dev))
    _launched("convex_solve", err)
    return (x, u_int, cost, scalars[0], scalars[1],
            scalars[2:3].view(torch.float32).reshape(()))


@device_program
def convex_eval_fused(cap_res, used_res, idx, valid, ask, count, feasible,
                      max_per_node, affinity_boost, job_collisions,
                      class_ids, distinct_hosts, max_iters, tolerance,
                      fairness_weight, quota_budget,
                      spread_algorithm: bool = False,
                      n_classes: int = 0) -> tuple:
    """convex.convex_eval with the convex-solve kernel as its solve and
    the score/capacity kernel's greedy entry as its baseline: one launch
    of each, the gather, rounding and selection as torch ops behind them
    on the same stream, nothing read back. CPU tensors run the plain
    eval."""
    return convex.convex_eval(
        cap_res, used_res, idx, valid, ask, count, feasible, max_per_node,
        affinity_boost, job_collisions, class_ids, distinct_hosts,
        max_iters, tolerance, fairness_weight, quota_budget,
        spread_algorithm=spread_algorithm, n_classes=n_classes,
        solve=convex_solve, greedy=fill_greedy_binpack_fused)


# ------------------------------------------------- the sharded solves

SHARD_PTRS = {"chunked_shard": 19, "convex_shard": 13}   # csrc enums' NPTR
MAX_SHARDS = 16         # csrc/chunked_shard.cu, csrc/convex_shard.cu


def _shard_layout(name: str, caps) -> tuple:
    """(ctypes pointer table [S][NPTR], the shards' device ordinals) for a
    sharded launcher, after checking the shard count."""
    n_shards = len(caps)
    if not 1 <= n_shards <= MAX_SHARDS:
        raise ValueError(f"{n_shards} shards: the kernel takes 1.."
                         f"{MAX_SHARDS}")
    devs = [c.device for c in caps]
    ptrs = (ctypes.c_ulonglong * (n_shards * SHARD_PTRS[name]))()
    ordinals = (ctypes.c_int * n_shards)(*[d.index or 0 for d in devs])
    return ptrs, ordinals


def _set_ptrs(ptrs, name: str, shard: int, values) -> None:
    base = shard * SHARD_PTRS[name]
    for i, v in enumerate(values):
        ptrs[base + i] = v if isinstance(v, int) else v.data_ptr()


def chunked_shard(caps, useds, asks, count, feasibles, collisions,
                  desired_count, spread_ids, spread_counts, spread_desired,
                  spread_modes, spread_weights, affinities, distinct_ids,
                  distinct_remaining, placed,
                  max_per_node=kernels.MAX_PER_NODE_CAP, max_steps: int = 256,
                  spread_algorithm: bool = False) -> tuple:
    """The sharded scan: kernels.chunked_shard_ref's per-shard lists in
    and out, one launcher call queueing max_steps + 1 launches of the
    sharded step kernel a device (csrc/chunked_shard.cu: each launch a
    cluster of 8 CTAs for every shard the device holds) on CUDA tensors,
    no host wait; the plain version on CPU tensors. -> (placed blocks,
    used blocks, spread_counts per shard, distinct_remaining per shard,
    state int32 [S, 8] on the first shard's device: column 2 the steps
    run, column 5 the launches that found the shard done and exited
    early; read it only to measure)."""
    if caps[0].device.type == "cpu":
        out = kernels.chunked_shard_ref(
            caps, useds, asks, count, feasibles, collisions, desired_count,
            spread_ids, spread_counts, spread_desired, spread_modes,
            spread_weights, affinities, distinct_ids, distinct_remaining,
            placed, max_per_node=max_per_node, max_steps=max_steps,
            spread_algorithm=spread_algorithm)
        state = torch.zeros((len(caps), 8), dtype=torch.int32)
        state[:, 2] = out[4]
        return out[:4] + (state,)
    ptrs, ordinals = _shard_layout("chunked_shard", caps)
    n_shards = len(caps)
    n = int(caps[0].shape[0])
    n_s, n_p = spread_counts[0].shape
    n_d, n_dp = distinct_remaining[0].shape
    if not 0 < n_s <= MAX_STANZAS or not 0 < n_d <= MAX_STANZAS:
        raise ValueError(f"{n_s} spread and {n_d} distinct stanzas: the "
                         f"kernel takes 1..{MAX_STANZAS} of each")
    count, max_steps = int(count), int(max_steps)
    if max_steps < 1:
        raise ValueError(f"max_steps {max_steps}: the scan takes >= 1")
    chunk = min(max((count + max_steps - 1) // max_steps, 1),
                min(n * n_shards, MAX_CHUNK))
    nbytes = int(_fn("chunked_shard", "scratch_bytes")(n, n_s, n_p, n_d,
                                                         n_dp))
    cbytes = int(_fn("chunked_shard", "cand_bytes")(n_shards, chunk,
                                                      n_s + n_d))
    cands = {}          # one candidate buffer a device, its shards' slots
    placed_out, used_out, sp_out, dp_out, scratch = [], [], [], [], []
    for s in range(n_shards):
        dev = caps[s].device
        _check_rows(caps[s], useds[s], asks[s], feasibles[s],
                    (collisions[s], "job_collisions", torch.int32),
                    (affinities[s], "affinity_boost", torch.float32),
                    (placed[s], "placed", torch.int32))
        for t, what, dtype, shape in (
                (spread_ids[s], "spread_ids", torch.int32, (n_s, n)),
                (spread_counts[s], "spread_counts", torch.int32, (n_s, n_p)),
                (spread_desired[s], "spread_desired", torch.float32,
                 (n_s, n_p)),
                (spread_modes[s], "spread_mode", torch.int32, (n_s,)),
                (spread_weights[s], "spread_weights", torch.float32, (n_s,)),
                (distinct_ids[s], "distinct_ids", torch.int32, (n_d, n)),
                (distinct_remaining[s], "distinct_remaining", torch.int32,
                 (n_d, n_dp))):
            if not _fits(t, dtype, shape, dev):
                _check(t, what, dtype, shape, dev)
        placed_out.append(placed[s].clone())
        used_out.append(useds[s].clone())
        sp_out.append(torch.empty_like(spread_counts[s]))
        dp_out.append(torch.empty_like(distinct_remaining[s]))
        scratch.append(torch.empty((nbytes,), dtype=torch.uint8, device=dev))
        cand = cands.get(dev)
        if cand is None:
            cand = cands[dev] = torch.empty((cbytes,), dtype=torch.uint8,
                                            device=dev)
        _set_ptrs(ptrs, "chunked_shard", s, (
            caps[s], used_out[s], asks[s], feasibles[s], collisions[s],
            placed_out[s], spread_ids[s], spread_counts[s],
            spread_desired[s], spread_modes[s], spread_weights[s],
            affinities[s], distinct_ids[s], distinct_remaining[s], sp_out[s],
            dp_out[s], scratch[s], cand, _stream(dev)))
    launches = ctypes.c_int(0)
    err = _fn("chunked_shard")(
        ptrs, ordinals, n_shards, n,
        min(int(max_per_node), kernels.MAX_PER_NODE_CAP),
        float(max(int(desired_count), 1)), int(bool(spread_algorithm)), n_s,
        n_p, n_d, n_dp, count, chunk, max_steps, ctypes.byref(launches))
    _launched("chunked_shard", err, launches.value)
    lead = caps[0].device
    state = torch.stack([sc[:32].view(torch.int32).to(lead, non_blocking=True)
                         for sc in scratch])
    return placed_out, used_out, sp_out, dp_out, state


# the sharded convex solve's rounds are queued in blocks, each ending in
# one wait on the done flag: the first block covers a solve of two
# iterations (3 + 18 x 2 rounds, a launch a device each: the bench
# fixture's), each later block twice the one before
CONVEX_FIRST_BLOCK = 3 + 18 * 2


def convex_solve_sharded(caps, useds, asks, feasibles, collisions,
                         affinities, count, max_per_node, max_iters,
                         tolerance, fairness_weight, quota_budget,
                         spread_algorithm: bool = False) -> tuple:
    """The sharded convex solve (convex.convex_solve_sharded_ref's
    per-shard lists and returns): on CUDA tensors, rounds of the sharded
    solve kernel (csrc/convex_shard.cu: a round one launch a device, a
    cluster of 8 x 1,024 threads for every shard it holds) queued in
    blocks of CONVEX_FIRST_BLOCK rounds, then twice as many, and so on,
    each block ending in ONE wait on the lead shard's done flag (a solve of
    i iterations takes 3 + 18 i rounds: one wait up to 2 iterations, 2 up
    to 5, 3 up to 12, ...); the plain version on CPU tensors. `WAITS`
    counts the waits.
    -> (x blocks, u_int blocks, cost blocks, budget_int, iterations, gap),
    the scalars on the first shard's device."""
    if caps[0].device.type == "cpu":
        return convex.convex_solve_sharded_ref(
            caps, useds, asks, feasibles, collisions, affinities, count,
            max_per_node, max_iters, tolerance, fairness_weight,
            quota_budget, spread_algorithm=spread_algorithm)
    ptrs, ordinals = _shard_layout("convex_shard", caps)
    n_shards = len(caps)
    n = int(caps[0].shape[0])
    nbytes = int(_fn("convex_shard", "scratch_bytes")(n))
    done_at = int(_fn("convex_shard", "done_offset")())
    slots = {}          # one slot buffer a device, its shards' partials
    xs, us, costs, scalars, scratch = [], [], [], [], []
    for s in range(n_shards):
        dev = caps[s].device
        _check_rows(caps[s], useds[s], asks[s], feasibles[s],
                    (collisions[s], "job_collisions", torch.int32),
                    (affinities[s], "affinity_boost", torch.float32))
        xs.append(torch.empty((n,), dtype=torch.float32, device=dev))
        costs.append(torch.empty((n,), dtype=torch.float32, device=dev))
        us.append(torch.empty((n,), dtype=torch.int32, device=dev))
        scalars.append(torch.empty((4,), dtype=torch.int32, device=dev))
        scratch.append(torch.empty((nbytes,), dtype=torch.uint8,
                                   device=dev))
        if dev not in slots:
            slots[dev] = torch.empty((2 * n_shards * 8,),
                                     dtype=torch.float32, device=dev)
        _set_ptrs(ptrs, "convex_shard", s, (
            caps[s], useds[s], asks[s], feasibles[s], collisions[s],
            affinities[s], scratch[s], slots[dev], xs[s], us[s], costs[s],
            scalars[s], _stream(dev)))
    lead = caps[0].device
    done_h = torch.empty((1,), dtype=torch.int32, pin_memory=True)
    rounds, block = 0, CONVEX_FIRST_BLOCK
    last = 3 + 18 * max(int(max_iters), 0)
    while True:
        launches = ctypes.c_int(0)
        err = _fn("convex_shard")(
            ptrs, ordinals, n_shards, n,
            min(int(max_per_node), kernels.MAX_PER_NODE_CAP), int(count),
            int(max_iters), int(bool(spread_algorithm)), float(tolerance),
            float(fairness_weight), float(quota_budget),
            convex.curvature(spread_algorithm),
            convex.step_offset(spread_algorithm), kernels._INV_MAX_SCORE,
            rounds, block, ctypes.byref(launches))
        _launched("convex_shard", err, launches.value)
        rounds += block
        done_h.copy_(scratch[0][done_at:done_at + 4].view(torch.int32),
                     non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(lead))
        # one wait a block of rounds: the sharded convex solve's loop
        # test, counted in WAITS — nomadlint: disable=SYNC001
        ev.synchronize()
        with _launch_lock:
            WAITS["convex_shard"] += 1
        # pinned host memory, read after the wait — nomadlint: disable=SYNC001
        if int(done_h[0]):
            break
        if rounds >= last:
            raise RuntimeError(f"the sharded convex solve ran {rounds} "
                               f"rounds without finishing")
        block *= 2
    return (xs, us, costs, scalars[0][0], scalars[0][1],
            scalars[0][2:3].view(torch.float32).reshape(()))


@device_program
def convex_eval_sharded_fused(caps, useds, asks, count, feasibles,
                              max_per_node, affinities, collisions,
                              max_iters, tolerance, fairness_weight,
                              quota_budget,
                              spread_algorithm: bool = False) -> tuple:
    """convex.convex_eval_sharded with the sharded convex kernel as its
    solve and the score/capacity kernel's greedy entry (one launch a
    shard) as its baseline's keys; CPU tensors run the plain eval."""
    return convex.convex_eval_sharded(
        caps, useds, asks, count, feasibles, max_per_node, affinities,
        collisions, max_iters, tolerance, fairness_weight, quota_budget,
        spread_algorithm=spread_algorithm, solve=convex_solve_sharded,
        greedy_key=score_capacity_greedy)


def cluster_barrier(steps: int, dev, threads: int = 512) -> None:
    """One launch of `steps` cluster barriers on 8 CTAs of `threads`
    threads (the scan kernel's 512, the convex solve's 1,024) on `dev`'s
    current stream: a persistent solve's dependency floor, for
    measurement only; not counted in LAUNCHES."""
    err = _fn("chunked_scan", "barrier_launch")(int(steps), int(threads),
                                                _stream(dev))
    if err != 0:
        raise RuntimeError(f"cluster_barrier kernel launch failed: "
                           f"cudaError_t {err}")


def launch_floor(dev) -> None:
    """One launch of the empty kernel on `dev`'s current stream: the
    launch floor chip_smoke.py measures. Not a placement kernel, and not
    counted in LAUNCHES."""
    err = _fn("launch_floor")(_stream(dev))
    if err != 0:
        raise RuntimeError(f"launch_floor kernel launch failed: "
                           f"cudaError_t {err}")


def gather_floor(idx, src) -> torch.Tensor:
    """One launch of the fit verdict's grid doing only its dependent chain
    (idx [L, n] or [n] int32, then src[idx, 0] of a float32 [n_res, 5]
    twin, then a store) on src's current stream: the verdict's gather
    floor, for measurement only; not counted in LAUNCHES. -> the gathered
    floats, idx's shape."""
    out = torch.empty(idx.shape, dtype=torch.float32, device=src.device)
    n_lanes = idx.shape[0] if idx.dim() == 2 else 1
    err = _fn("launch_floor", "gather_launch")(
        idx.data_ptr(), src.data_ptr(), idx.shape[-1], n_lanes,
        out.data_ptr(), _stream(src.device))
    if err != 0:
        raise RuntimeError(f"gather_floor kernel launch failed: "
                           f"cudaError_t {err}")
    return out


def pow10_check(first: int, last: int, dev) -> tuple:
    """Runs csrc/pow10_check.cu over every float32 whose bit pattern lies
    in [first, last] on `dev`: (mismatches, inputs left to the float64
    pow, inputs with a nonzero result)."""
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    err = _fn("pow10_check")(int(first), int(last), counts.data_ptr(),
                             _stream(dev))
    if err != 0:
        raise RuntimeError(f"pow10_check kernel launch failed: "
                           f"cudaError_t {err}")
    # a measurement's read, off the solve path — nomadlint: disable=SYNC001
    return tuple(int(c) for c in counts.tolist())
