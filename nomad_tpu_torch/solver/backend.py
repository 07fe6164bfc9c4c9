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

Not ported yet: the degradation ladder and its per-tier breaker, the
host/batch small-count routing and the sharded tier. Until then no solve
gives way from a kernel to its plain version: a failing launch raises.
`breaker_release_all` is the no-op the placer's eval exit calls.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..metrics import metrics
from . import device as _device, roundtrip

_cache: dict = {}


def reset() -> None:
    """Drop cached selections (tests switch the solve device)."""
    _cache.clear()


def breaker_release_all() -> None:
    """No breaker exists yet; kept so the placer's eval exit is the
    reference's."""


def _tensor(x, dev, dtype):
    """numpy array (or tensor) -> contiguous tensor on `dev`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=dev, dtype=dtype).contiguous()


def _note_dispatch(dev) -> None:
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
    n = cap.shape[0]
    if aff is None:
        aff = np.zeros(n, np.float32)
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


def select(kernel: str, n_padded: int, *, k_max: int = 128,
           spread_algorithm: bool = False, depth_grid=None):
    """-> (tier, fn) for `kernel` in {greedy, depth}. The tier follows the
    solve device (device.solve_device(), which raises when it is a card
    and none is present). `n_padded` (the bucketed node axis) keeps the
    reference's signature; no routing reads it yet."""
    dev = _device.solve_device()
    tier = "cuda" if dev.type == "cuda" else "torch"
    key = (kernel, tier, str(dev), k_max, spread_algorithm, depth_grid)
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
    else:
        raise ValueError(f"unknown kernel {kernel!r} (greedy, depth)")
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
