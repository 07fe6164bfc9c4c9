"""One backend selector for the placer's solver kernels.

Every solve the placer issues routes through `select(kernel, n_padded,
...)`, which returns `(tier, fn)`:

  cuda   the hand-written CUDA kernels (cuda_kernels.py) with their torch
         tails on the card — whenever the solve device is a card.
  torch  the plain PyTorch versions (kernels.py) — only when the caller
         asked for the CPU (device.use_device("cpu")).

The returned callable has ONE normalized positional signature per kernel,
so the placer's call sites are backend-oblivious. It takes the placer's
numpy arrays and host scalars, moves the arrays to the solve device and
returns the placement vector there:

  greedy : fn(cap, used, ask, count, feasible, max_per_node) -> placed
  depth  : fn(cap, used, ask, count, feasible, job_collisions, desired,
              aff, max_per_node, order_jitter, jitter_scale,
              jitter_samples) -> placed
  chunked: fn(cap, used, ask, count, feasible, job_collisions, desired,
              sp_ids, sp_counts, sp_desired, sp_mode, sp_weights, aff,
              dp_ids, dp_remaining, placed_init, max_per_node)
              -> (placed, used, sp_counts, dp_remaining)

Array arguments that already lie on the solve device pass through
untouched (the state cache's twins, a pipelined chunk's fed-forward
usage); `on_device` moves a whole argument tuple there once. Arrays
reach a card through pinned memory without blocking, so no dispatch
waits for the work queued before it: a dispatch never blocks, and
`async_dispatch` only marks the pipeline's call sites.

Not ported yet: the degradation ladder and its per-tier breaker, the
host/batch small-count routing and the sharded tier. Until then no solve
gives way from a kernel to its plain version: a failing launch raises.
`breaker_release_all` is the no-op the placer's eval exit calls.
"""
from __future__ import annotations

import functools
import threading
from contextlib import contextmanager

import numpy as np
import torch

from .. import faults
from ..metrics import metrics
from . import device as _device, roundtrip

_cache: dict = {}
_dispatch_ctx = threading.local()
_DEVICE_ERRORS: tuple = ()

# dtype of each array position of the normalized signatures (below)
_ARG_DTYPES = {
    "greedy": {0: torch.float32, 1: torch.float32, 2: torch.float32,
               4: torch.bool},
    "depth": {0: torch.float32, 1: torch.float32, 2: torch.float32,
              4: torch.bool, 5: torch.int32, 7: torch.float32,
              9: torch.float32},
    "chunked": {0: torch.float32, 1: torch.float32, 2: torch.float32,
                4: torch.bool, 5: torch.int32, 7: torch.int32,
                8: torch.int32, 9: torch.float32, 10: torch.int32,
                11: torch.float32, 12: torch.float32, 13: torch.int32,
                14: torch.int32, 15: torch.int32},
}


def reset() -> None:
    """Drop cached selections (tests switch the solve device)."""
    _cache.clear()


def breaker_release_all() -> None:
    """No breaker exists yet; kept so the placer's eval exit is the
    reference's."""


def tier() -> str:
    """The tier solves run on now: "cuda" on a card, "torch" on the CPU.
    Raises like device.solve_device() when the card is missing."""
    return "cuda" if _device.solve_device().type == "cuda" else "torch"


def device_error_types() -> tuple:
    """Exception types that mean "the card or a kernel launch failed", as
    opposed to a bug in the solve itself: the pipeline's materialize site
    catches them to re-raise with the chunk named. CUDA runtime errors
    are torch.AcceleratorError where torch has it, RuntimeError before."""
    global _DEVICE_ERRORS
    if not _DEVICE_ERRORS:
        from .cuda_kernels import KernelLaunchError
        _DEVICE_ERRORS = (
            faults.FaultError, KernelLaunchError, torch.cuda.CudaError,
            torch.OutOfMemoryError,
            getattr(torch, "AcceleratorError", RuntimeError))
    return _DEVICE_ERRORS


@contextmanager
def async_dispatch():
    """Marks the pipeline's chunk dispatches, where the reference's
    chain must not block. A dispatch here never blocks anyway: launches
    and pinned copies queue on the device's stream, and a failure
    surfaces at the call or at the caller's materialize site."""
    yield


def last_dispatch_tier() -> str:
    """The tier that served the calling thread's most recent dispatch
    ("" before the first). With no ladder it is the selected tier."""
    return getattr(_dispatch_ctx, "last_tier", "")


def _tensor(x, dev, dtype):
    """numpy array (or tensor) -> contiguous tensor on `dev`. A numpy
    array goes to a card through pinned memory without blocking."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).contiguous()
    x = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    if dev.type == "cuda":
        return x.pin_memory().to(dev, non_blocking=True)
    return x


def on_device(kernel: str, args: tuple) -> tuple:
    """`kernel`'s normalized positional args with every array on the
    solve device, so repeated dispatches of the same inputs (pipelined
    chunks) copy nothing."""
    dev = _device.solve_device()
    types = _ARG_DTYPES[kernel]
    return tuple(_tensor(a, dev, types[i])
                 if i in types and a is not None else a
                 for i, a in enumerate(args))


def _note_dispatch(dev) -> None:
    _dispatch_ctx.last_tier = "cuda" if dev.type == "cuda" else "torch"
    if dev.type == "cuda":
        roundtrip.note("solve")


def _greedy(fn, dev, cap, used, ask, count, feasible, max_per_node):
    _note_dispatch(dev)
    return fn(_tensor(cap, dev, torch.float32),
              _tensor(used, dev, torch.float32),
              _tensor(ask, dev, torch.float32), int(count),
              _tensor(feasible, dev, torch.bool), int(max_per_node))


def _depth(fn, dev, k_max, spread_algorithm, depth_grid, cap, used, ask,
           count, feasible, coll, desired, aff, max_per_node, order_jitter,
           jitter_scale, jitter_samples):
    _note_dispatch(dev)
    if aff is None:
        aff = torch.zeros(cap.shape[0], dtype=torch.float32, device=dev)
    jit = None if order_jitter is None else \
        _tensor(order_jitter, dev, torch.float32)
    return fn(_tensor(cap, dev, torch.float32),
              _tensor(used, dev, torch.float32),
              _tensor(ask, dev, torch.float32), int(count),
              _tensor(feasible, dev, torch.bool),
              _tensor(coll, dev, torch.int32), int(desired),
              _tensor(aff, dev, torch.float32),
              max_per_node=int(max_per_node), order_jitter=jit,
              jitter_scale=float(np.float32(jitter_scale)),
              jitter_samples=float(np.float32(jitter_samples)),
              k_max=k_max, spread_algorithm=spread_algorithm,
              depth_grid=depth_grid)


def _chunked(fn, dev, max_steps, spread_algorithm, cap, used, ask, count,
             feasible, coll, desired, sp_ids, sp_counts, sp_desired,
             sp_mode, sp_weights, aff, dp_ids, dp_remaining, placed_init,
             max_per_node):
    _note_dispatch(dev)
    args = on_device("chunked", (
        cap, used, ask, count, feasible, coll, desired, sp_ids, sp_counts,
        sp_desired, sp_mode, sp_weights, aff, dp_ids, dp_remaining,
        placed_init))
    return fn(*args[:3], int(count), args[4], args[5], int(desired),
              *args[7:15], max_per_node=int(max_per_node),
              max_steps=max_steps, spread_algorithm=spread_algorithm,
              placed_init=args[15])


def select(kernel: str, n_padded: int, *, k_max: int = 128,
           spread_algorithm: bool = False, depth_grid=None,
           max_steps: int = 256):
    """-> (tier, fn) for `kernel` in {greedy, depth, chunked}. The tier
    follows the solve device (device.solve_device(), which raises when it
    is a card and none is present). `n_padded` (the bucketed node axis)
    keeps the reference's signature; no routing reads it yet."""
    dev = _device.solve_device()
    tier = "cuda" if dev.type == "cuda" else "torch"
    key = (kernel, tier, str(dev), k_max, spread_algorithm, depth_grid,
           max_steps)
    cached = _cache.get(key)
    if cached is not None:
        return cached
    from . import cuda_kernels, kernels
    if kernel == "greedy":
        impl = (cuda_kernels.fill_greedy_binpack_fused if tier == "cuda"
                else kernels.fill_greedy_binpack)
        fn = functools.partial(_greedy, impl, dev)
    elif kernel == "depth":
        impl = (cuda_kernels.fill_depth_fused if tier == "cuda"
                else kernels.fill_depth)
        fn = functools.partial(_depth, impl, dev, k_max, spread_algorithm,
                               depth_grid)
    elif kernel == "chunked":
        impl = (cuda_kernels.place_chunked if tier == "cuda"
                else kernels.place_chunked)
        fn = functools.partial(_chunked, impl, dev, max_steps,
                               spread_algorithm)
    else:
        raise ValueError(f"unknown kernel {kernel!r} (greedy, depth, "
                         f"chunked)")
    out = _cache[key] = (tier, fn)
    return out


def record(kernel: str, backend: str) -> None:
    """Emit the per-solve routing metrics
    (`nomad.solver.kernel.<kernel>.<tier>`)."""
    metrics.incr(f"nomad.solver.backend.{backend}")
    metrics.incr(f"nomad.solver.kernel.{kernel}.{backend}")
    # attribute the selected tier/kernel onto the in-flight solve span
    from ..obs import trace
    trace.annotate(tier=backend, kernel=kernel)
