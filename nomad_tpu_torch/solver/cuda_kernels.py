"""Hand-written CUDA kernels for the placement hot loop — the counterpart
of nomad_tpu/solver/pallas_kernels.py.

  depth_curve     csrc/depth_curve.cu, replaces `_depth_curve_kernel`
                  (the depth solver's per-node curve producer)
  score_capacity  csrc/score_capacity.cu, replaces
                  `_score_capacity_kernel` (the greedy inner pass)

Build: each source is compiled by `nvcc` for sm_90a into its own shared
library with a plain C interface, loaded with ctypes. The libraries go
under build/kernels/ at the repo root, named by a hash of their source,
so an unchanged tree does not rebuild; all sources compile in parallel at
first use. No fast math (the kernels take floor of quotients and pow) and
no FMA contraction, so the kernels round like their plain versions.

Wrappers: `fill_depth_fused` and `fill_greedy_binpack_fused` keep the
reference signatures. A wrapper given CPU tensors runs the plain version
(kernels.py); given CUDA tensors it checks device, dtype, shape and
contiguity, allocates its outputs, launches on the current stream and
raises if the launch reports an error. `LAUNCHES` counts the launches of
each kernel; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from . import kernels
from .kernels import NUM_XR, _depth_order_take, _greedy_take

REPO_ROOT = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
SOURCES = {"depth_curve": "depth_curve.cu",
           "score_capacity": "score_capacity.cu"}
MAX_GRID = 32           # csrc/depth_curve.cu DepthGrid capacity
_NEG_BIG = -1e9

LAUNCHES = {name: 0 for name in SOURCES}
BUILD_LOG: dict = {}    # name -> nvcc output (registers, spills)
_libs: dict = {}
_build_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "depth_curve_launch": [_P, _P, _P, _P, _P, _P, _I, _F, _F, _I, _P, _I,
                           _I, _P, _P, _P, _P],
    "score_capacity_launch": [_P, _P, _P, _P, _I, _I, _P, _P, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit's nvcc")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{h[:16]}.so"


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
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _lib(name: str):
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _build_lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = _ARGTYPES[f"{name}_launch"]
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
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


def _check_rows(cap, used, ask, feasible) -> int:
    if cap.device.type != "cuda":
        raise ValueError(f"cap: on {cap.device}, expected a CUDA device")
    n = cap.shape[0]
    dev = cap.device
    _check(cap, "cap", torch.float32, (n, NUM_XR), dev)
    _check(used, "used", torch.float32, (n, NUM_XR), dev)
    _check(ask, "ask", torch.float32, (NUM_XR,), dev)
    _check(feasible, "feasible", torch.bool, (n,), dev)
    return n


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def launch_depth_curve(cap, used, ask, feasible, job_collisions,
                       desired_count, affinity_boost,
                       max_per_node=kernels.MAX_PER_NODE_CAP,
                       k_max: int = 128, spread_algorithm: bool = False,
                       depth_grid=None) -> tuple:
    """One launch of the depth-curve kernel on CUDA tensors: the raw
    (d_star f32[N] (-1e9 where no depth fits), k_star i32[N],
    k_cap i32[N])."""
    n = _check_rows(cap, used, ask, feasible)
    dev = cap.device
    _check(job_collisions, "job_collisions", torch.int32, (n,), dev)
    _check(affinity_boost, "affinity_boost", torch.float32, (n,), dev)
    grid = tuple(depth_grid) if depth_grid is not None else ()
    if len(grid) > MAX_GRID:
        raise ValueError(f"depth_grid has {len(grid)} depths, the kernel "
                         f"takes at most {MAX_GRID}")
    if not grid and not 1 <= int(k_max) <= 4096:
        raise ValueError(f"k_max {k_max} out of range")
    desired = float(max(int(desired_count), 1))
    mpn = float(min(int(max_per_node), kernels.MAX_PER_NODE_CAP))
    g_arr = (ctypes.c_float * MAX_GRID)(*[float(g) for g in grid])
    d_star = torch.empty((n,), dtype=torch.float32, device=dev)
    k_star = torch.empty((n,), dtype=torch.int32, device=dev)
    k_cap = torch.empty((n,), dtype=torch.int32, device=dev)
    fn = _lib("depth_curve").depth_curve_launch
    err = fn(cap.data_ptr(), used.data_ptr(), ask.data_ptr(),
             feasible.data_ptr(), job_collisions.data_ptr(),
             affinity_boost.data_ptr(), n, desired, mpn, int(k_max),
             ctypes.cast(g_arr, ctypes.c_void_p), len(grid),
             int(bool(spread_algorithm)), d_star.data_ptr(),
             k_star.data_ptr(), k_cap.data_ptr(), _stream(dev))
    _launched("depth_curve", err)
    return d_star, k_star, k_cap


def depth_curve(cap, used, ask, feasible, job_collisions, desired_count,
                affinity_boost, max_per_node=kernels.MAX_PER_NODE_CAP,
                k_max: int = 128, spread_algorithm: bool = False,
                depth_grid=None) -> tuple:
    """(d_star f32[N], k_star i32[N], k_cap i32[N]) — the depth-curve
    kernel on CUDA tensors, kernels.depth_curve_ref on CPU tensors.
    d_star is -inf where no depth fits."""
    if cap.device.type == "cpu":
        return kernels.depth_curve_ref(
            cap, used, ask, feasible, job_collisions, desired_count,
            affinity_boost, max_per_node=max_per_node, k_max=k_max,
            spread_algorithm=spread_algorithm, depth_grid=depth_grid)
    d_star, k_star, k_cap = launch_depth_curve(
        cap, used, ask, feasible, job_collisions, desired_count,
        affinity_boost, max_per_node=max_per_node, k_max=k_max,
        spread_algorithm=spread_algorithm, depth_grid=depth_grid)
    d_star = torch.where(d_star <= _NEG_BIG / 2.0, -torch.inf, d_star)
    return d_star, k_star, k_cap


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
    return _depth_order_take(d_star, k_star, k_cap, count, order_jitter,
                             jitter_scale, jitter_samples)


def score_capacity_fused(cap, used, ask, feasible, spread: bool = False):
    """(capacity i32[N], score f32[N]) — the score/capacity kernel on
    CUDA tensors, kernels.score_capacity_ref on CPU tensors."""
    if cap.device.type == "cpu":
        return kernels.score_capacity_ref(cap, used, ask, feasible,
                                          spread=spread)
    n = _check_rows(cap, used, ask, feasible)
    dev = cap.device
    capacity = torch.empty((n,), dtype=torch.int32, device=dev)
    score = torch.empty((n,), dtype=torch.float32, device=dev)
    fn = _lib("score_capacity").score_capacity_launch
    err = fn(cap.data_ptr(), used.data_ptr(), ask.data_ptr(),
             feasible.data_ptr(), n, int(bool(spread)),
             capacity.data_ptr(), score.data_ptr(), _stream(dev))
    _launched("score_capacity", err)
    return capacity, score


def fill_greedy_binpack_fused(cap, used, ask, count, feasible,
                              max_per_node=kernels.MAX_PER_NODE_CAP):
    """kernels.fill_greedy_binpack with the score/capacity kernel as its
    producer: same stable sort + cumsum fill tail."""
    capacity, score = score_capacity_fused(cap, used, ask, feasible)
    return _greedy_take(capacity, score, count, max_per_node)
