"""One backend selector for the placer's solver kernels.

Every solve the placer issues routes through `select(kernel, n_padded,
...)`, which returns `(tier, fn)`:

  cuda   the hand-written CUDA kernels (cuda_kernels.py) with their torch
         tails on the card — whenever the solve device is a card.
  torch  the plain PyTorch versions (kernels.py) on the CPU — only when
         the caller asked for the CPU (device.use_device("cpu")).
  batch  eval-stream micro-batching (microbatch.py): a depth solve of at
         most BATCH_MAX_COUNT instances, while micro-batching is enabled
         and more than one eval is in flight, waits a short window for
         siblings and solves with them as one lane-batched launch
         (cuda_kernels.fill_depth_lanes; kernels.fill_depth_lanes on the
         CPU). A window of one runs the solo chain above.
  sharded  the node axis split over the device mesh (sharding.py): a
         greedy, depth or chunked solve whose bucket is at least
         SHARD_MIN_NODES and divides by the mesh's shard count runs K2 or
         K1 on each shard's row block and its tail once on the mesh's
         first device (sharding.sharded_fill_greedy / sharded_fill_depth),
         or the scan's step kernel a shard a step
         (sharding.sharded_place_chunked); the fused route's program and
         the convex solve likewise over the state cache's sharded twins
         (sharding.sharded_fused, sharding.sharded_convex).
         `NOMAD_SOLVER_BACKEND=sharded` forces it on any dividing bucket,
         any other value keeps every solve solo. A window (the batch
         tier) splits its lanes over the mesh where they divide.

The returned callable has ONE normalized positional signature per kernel,
so the placer's call sites are backend-oblivious. It takes the placer's
numpy arrays (or tensors already on the solve device: the state cache's
twins, a pipelined chunk's fed-forward usage) and host scalars:

  greedy : fn(cap, used, ask, count, feasible, max_per_node) -> placed
  depth  : fn(cap, used, ask, count, feasible, job_collisions, desired,
              aff, max_per_node, order_jitter, jitter_scale,
              jitter_samples) -> placed
  chunked: fn(cap, used, ask, count, feasible, job_collisions, desired,
              sp_ids, sp_counts, sp_desired, sp_mode, sp_weights, aff,
              dp_ids, dp_remaining, placed_init, max_per_node)
              -> (placed, used, sp_counts, dp_remaining)
  preempt: fn(victim_res, victim_prio, ask, free, job_prio) -> bool[C, V]

Dispatch chain (the reference's `LADDER`, no lower rung): every
selection is a per-call chain of ONE rung, `cuda` on a card, `torch`
when the caller asked for the CPU, `sharded` on the mesh. Card work never moves to the
CPU: the reference's host floor is not ported, and the plain versions
never run on a card. A classified device error (`device_error_types`: an
injected fault, a kernel launch error, a CUDA runtime error, out of
memory) is counted (`nomad.solver.dispatch_errors.<tier>`), logged on
the solve span (`trace.annotate_list("dispatch_errors", tier)`) and fed
to the tier's health breaker, then raised out of the solve. The breaker
(BREAKER_* knobs) only observes: it opens after repeated device errors
inside a window, or at once on device loss (`classify_device_error`, which
also drops the state cache's twins), and closes on the next success; it
never skips the card. Anything else — a bug, a kernel that does not build
(KernelBuildError), no card at all — raises and feeds nothing. Fault
sites `solver.dispatch.<tier>` (and `device.lost.d<N>` on the cuda rung)
ride the same catch, so the error path is provable without a sick card.

The convex tier (`select_convex`, under scheduler_algorithm "convex")
has a chain of one rung too: the whole eval (cuda_kernels.
convex_eval_fused on a card, convex.convex_eval on the CPU; on the mesh
sharding.sharded_convex) and its one host copy; a device error also
counts `nomad.solver.dispatch_errors.convex`. The reference's demotion
from convex to the classic ladder is not ported, by the rule above; a
lost shard replays the convex eval itself on the survivors.

The batch tier has no chain of its own: the micro-batcher classifies a
window's device error (`nomad.solver.dispatch_errors.batch`), feeds the
"batch" breaker and raises it to every lane; a solo solve takes the
solo chain.

The fused tier (`select_fused`, on by default: SchedulerConfiguration.
solver_fused_enabled, NOMAD_SOLVER_FUSED) runs a depth or greedy eval
whole — gather from the state cache's resident twins, solve, plan-fit
verdict — behind one host copy (cuda_kernels.fused_eval_depth/_greedy on
a card, kernels.fused_eval_* on the CPU). Its chain has one rung too; a
device error also counts `nomad.solver.dispatch_errors.fused` and is
raised out of the eval, where the reference re-solves through the
classic ladder.

Elastic mesh: a device LOSS on the sharded rung (an attributable
`device.lost.d<N>` or CUDA error) quarantines the shard and rebuilds the
mesh at a new generation (sharding.rebuild: chains dropped, twins
evacuated), then the chain re-selects at the new generation and replays
the identical host inputs (`host_args`, or the call's own arrays) on the
survivors, at most sharding.MAX_REPLAYS times (`nomad.mesh.replays`):
on the survivor mesh, or solo on its first device where the old bucket
no longer divides. Never on the CPU: when every shard is lost, `tier()`
raises (sharding.MeshLostError). Chains are keyed on the generation.

`warmup` (from the server's leadership establishment) drives one
synthetic solve of every kernel the card path uses through `select`,
`select_fused` and `select_convex`, so a leader's first eval builds and
loads nothing.

Outside `async_dispatch()` a chain call ends at the solve's one host
sync: the result is copied to the host there (or by the caller's
`finish`), so an asynchronous device error surfaces inside the chain and
is classified too, and breaker success is recorded only for a result
that reached the host. Inside `async_dispatch()` (the pipelined placer)
the chain returns device tensors without waiting; the caller's
materialize site records success or the failure.
"""
from __future__ import annotations

import functools
import os
import threading
import time
from contextlib import contextmanager

import numpy as np
import torch

from .. import faults
from ..metrics import metrics
from ..obs import timing
from . import device as _device, roundtrip

# Health-breaker knobs: N device errors inside the window open the tier
# (it closes on the next success). Read at call time, so tests and
# operators can monkeypatch them.
BREAKER_THRESHOLD = int(os.environ.get("NOMAD_BREAKER_THRESHOLD", "3"))
BREAKER_WINDOW_S = float(os.environ.get("NOMAD_BREAKER_WINDOW_S", "30"))

# The batch tier's count ceiling, the port's own number (the reference's
# HOST_MAX_COUNT, 2048, was set for a remote TPU's round trip and does
# not carry over): the largest count at which coalescing beat solo on the
# H100 in two sweeps of stream_sweep.py (10 pairs of runs a count at 500,
# 1,000, 2,000 and 4,000; a count qualifies at a one-sided sign test of
# p <= 0.05). No count qualified in both (PERF.md §6), so 0: the tier
# never engages unless this is raised. Read at call time (tests patch
# it; chip_smoke.py's stream phase raises it for its on runs).
BATCH_MAX_COUNT = 0

# The sharded tier's bucket floor: the reference's value
# (nomad_tpu/solver/backend.py:97), NOT measured on cards — no box with
# several cards exists here to set it. Read at call time (tests and
# chip_smoke.py lower it).
SHARD_MIN_NODES = 32768

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
    "preempt": {0: torch.float32, 1: torch.int32, 2: torch.float32,
                3: torch.float32},
    # convex.convex_eval's: twins, idx, valid, ask, feasible, affinity,
    # collisions
    "convex": {0: torch.float32, 1: torch.float32, 2: torch.int32,
               3: torch.bool, 4: torch.float32, 6: torch.bool,
               8: torch.float32, 9: torch.int32},
    # kernels.fused_eval_depth's and fused_eval_greedy's: twins, idx,
    # valid, ask, feasible, then the depth columns or the greedy's class
    # ids and collisions
    "fused_depth": {0: torch.float32, 1: torch.float32, 2: torch.int32,
                    3: torch.bool, 4: torch.float32, 6: torch.bool,
                    7: torch.int32, 9: torch.float32, 11: torch.float32,
                    14: torch.int32},
    "fused_greedy": {0: torch.float32, 1: torch.float32, 2: torch.int32,
                     3: torch.bool, 4: torch.float32, 6: torch.bool,
                     8: torch.int32, 10: torch.int32},
}
# a fused depth window's stacked lane columns: fused_depth's positions 2..13
# (idx through jitter_samples; the class ids and distinct_hosts stay out)
FUSED_LANE_DTYPES = {i - 2: t for i, t in _ARG_DTYPES["fused_depth"].items()
                     if 2 <= i < 14}


def reset() -> None:
    """Drop cached selections and the breakers' state (tests switch the
    solve device)."""
    _cache.clear()
    _breaker.reset()


def tier() -> str:
    """The kind of device solves run on now: "cuda" on a card, "torch" on
    the CPU. Raises like device.solve_device() when the card is missing,
    and sharding.MeshLostError when every shard of the device set is
    quarantined."""
    from . import sharding
    if sharding.lost():
        raise sharding.MeshLostError(
            "every shard of the solver's device set is lost (quarantined "
            f"{sorted(sharding.quarantined())}): nothing solves until the "
            "mesh is reset")
    return "cuda" if _device.solve_device().type == "cuda" else "torch"


def _snap(mesh_snap=None):
    """The caller's MeshSnapshot, or a fresh one when it predates the
    current generation (never build a chain against a dead mesh)."""
    from . import sharding
    if mesh_snap is not None and mesh_snap.generation == \
            sharding.generation():
        return mesh_snap
    return sharding.snapshot()


def gather_tier(n_padded: int) -> str:
    """The tier a solve at bucket `n_padded` would take, as the state
    cache's gather routes by it: "sharded" where the mesh takes the
    bucket, else tier()."""
    solo = tier()
    return "sharded" if sharded_on(n_padded, _snap()) else solo


def sharded_on(n_padded: int, snap) -> bool:
    """Does a solve at bucket `n_padded` take the sharded tier under
    `snap`? More than one shard, a bucket that divides over them, and the
    bucket at least SHARD_MIN_NODES (NOMAD_SOLVER_BACKEND=sharded skips
    the floor; any other value keeps the solve solo)."""
    if snap.mesh is None or n_padded <= 0 or n_padded % snap.shards:
        return False
    forced = os.environ.get("NOMAD_SOLVER_BACKEND", "")
    if forced:
        return forced == "sharded"
    return n_padded >= SHARD_MIN_NODES


# ------------------------------------------------------ device errors

def device_error_types() -> tuple:
    """Exception types that mean "the card or a kernel launch failed"
    (classified and fed to the breaker), as opposed to a bug in the solve itself or a kernel that
    does not build (cuda_kernels.KernelBuildError). CUDA runtime errors
    are torch.AcceleratorError where torch has it."""
    global _DEVICE_ERRORS
    if not _DEVICE_ERRORS:
        from .cuda_kernels import KernelLaunchError
        errs = [faults.FaultError, KernelLaunchError, torch.cuda.CudaError,
                torch.OutOfMemoryError]
        if hasattr(torch, "AcceleratorError"):
            errs.append(torch.AcceleratorError)
        _DEVICE_ERRORS = tuple(errs)
    return _DEVICE_ERRORS


# CUDA's sticky errors: after one of these the context is unusable and
# every later call on it fails too. By message (torch's CUDA errors) and
# by cudaError_t code (a kernel launch's returned code).
_DEVICE_LOSS_MARKERS = (
    "illegal memory access", "illegal address", "illegal instruction",
    "misaligned address", "unspecified launch failure",
    "device-side assert", "uncorrectable ecc", "busy or unavailable",
    "devices unavailable", "launch timed out", "device lost",
    "device_lost", "handle is invalid",
)
_DEVICE_LOSS_CODES = frozenset((46, 214, 700, 702, 710, 714, 715, 716,
                                717, 718, 719))


def classify_device_error(exc: BaseException) -> str:
    """-> 'device_loss' | 'transient' for an exception already known to
    be one of device_error_types(). Device loss means the card's context
    is gone (a sticky CUDA error, an injected loss): retrying can only
    fail again, so the breaker opens at once. Everything else (out of
    memory, an injected FaultError, a non-sticky launch error) is
    transient and rides the breaker's window."""
    if isinstance(exc, faults.device_lost_error_type()):
        return "device_loss"
    if getattr(exc, "code", None) in _DEVICE_LOSS_CODES:
        return "device_loss"
    msg = str(exc).lower()
    if any(m in msg for m in _DEVICE_LOSS_MARKERS):
        return "device_loss"
    return "transient"


def _lost_device_ids(exc: BaseException) -> tuple:
    did = getattr(exc, "device_id", None)
    return (int(did),) if isinstance(did, int) and did >= 0 else ()


def note_dispatch_failure(tier: str, exc: BaseException,
                          generation: int = None) -> bool:
    """One dispatch seam's device error: count it, note it on the solve
    span, classify it and feed the breaker. Device loss opens the tier at
    once. With one device there is no mesh: the state cache's twins are
    dropped (no later gather indexes buffers of a dead context) and
    nothing replays. With a device set of several shards the lost shard
    (the error's `device_id`) is quarantined and the mesh rebuilt
    (sharding.rebuild, which evacuates the twins). Returns True when the
    caller should REPLAY its identical inputs at the new generation: the
    generation moved past the one the dispatch rode (`generation`; at
    most one replay a bump, callers cap cascades at
    sharding.MAX_REPLAYS)."""
    from ..obs import trace
    from . import sharding
    metrics.incr("nomad.solver.dispatch_errors")
    metrics.incr(f"nomad.solver.dispatch_errors.{tier}")
    trace.annotate_list("dispatch_errors", tier)
    kind = classify_device_error(exc)
    if kind != "device_loss":
        _breaker.record_failure(tier)
        return False
    metrics.incr("nomad.solver.device_loss")
    metrics.incr(f"nomad.solver.device_loss.{tier}")
    if len(sharding.all_shards()) <= 1:
        _breaker.record_failure(tier, device_loss=True)
        from . import state_cache
        state_cache.cache().drop_twins()
        return False
    lost = _lost_device_ids(exc)
    metrics.incr("nomad.mesh.device_loss")
    metrics.incr(f"nomad.mesh.device_loss.{tier}")
    stale = generation is not None \
        and sharding.generation() > generation \
        and not (set(lost) - sharding.quarantined())
    if not stale:
        # open NOW: concurrent dispatches must not storm the dead shard
        # before the rebuild lands (the rebuild resets the tier)
        _breaker.record_failure(tier, device_loss=True)
    new_gen = sharding.rebuild("device_loss", lost,
                               observed_generation=generation)
    return generation is None or new_gen > generation


def on_mesh_rebuild(gen: int, quarantined_new: bool = True) -> None:
    """sharding.rebuild()'s hook: drop every chain built against the old
    mesh (the cache keys on the generation too; this frees them). When
    the rebuild quarantined a new shard, the device tiers' breakers start
    clean: their failures blame a shard the new generation no longer
    holds. An unattributable loss rebuilds the same set, and the breaker
    stays open."""
    del gen
    _cache.clear()
    if quarantined_new:
        for t in ("sharded", "batch", "cuda"):
            _breaker.reset_tier(t)


class TierBreaker:
    """Per-tier health breaker: closed -> open (>= BREAKER_THRESHOLD
    device errors within BREAKER_WINDOW_S, or one device loss) -> closed
    on the next success. With no lower rung to serve a solve it only
    observes: an open tier is still dispatched to, and its state is read
    by operators (`state`) and the `tier_breaker_*` metrics.

    Knobs are read from module globals at call time so tests and
    operators can monkeypatch them without rebuilding chains. Uses
    time.monotonic — latency bookkeeping, not a scheduling decision."""

    def __init__(self):
        self._lock = threading.Lock()
        # tier -> {"failures": [t, ...], "open": bool}
        self._tiers: dict[str, dict] = {}

    def _rec(self, tier: str) -> dict:
        rec = self._tiers.get(tier)
        if rec is None:
            rec = self._tiers[tier] = {"failures": [], "open": False}
        return rec

    def reset(self) -> None:
        with self._lock:
            self._tiers.clear()

    def reset_tier(self, tier: str) -> None:
        """Forget one tier's failures (a mesh rebuild quarantined the
        shard they blamed)."""
        with self._lock:
            if self._tiers.pop(tier, None) is not None:
                metrics.set_gauge(
                    f"nomad.solver.tier_breaker_state.{tier}", 0)

    def state(self, tier: str) -> str:
        with self._lock:
            rec = self._tiers.get(tier)
            return "open" if rec is not None and rec["open"] else "closed"

    def record_success(self, tier: str) -> None:
        with self._lock:
            rec = self._rec(tier)
            was_open = rec["open"]
            rec["failures"] = []
            rec["open"] = False
            if was_open:
                metrics.incr("nomad.solver.tier_breaker_closed")
                metrics.incr(f"nomad.solver.tier_breaker_closed.{tier}")
            metrics.set_gauge(f"nomad.solver.tier_breaker_state.{tier}", 0)

    def record_failure(self, tier: str, device_loss: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            rec = self._rec(tier)
            if rec["open"]:
                return
            fails = [t for t in rec["failures"] if now - t < BREAKER_WINDOW_S]
            fails.append(now)
            rec["failures"] = fails
            # a lost card is not a transient: the tier opens at once
            if device_loss or len(fails) >= BREAKER_THRESHOLD:
                rec["open"] = True
                rec["failures"] = []
                metrics.incr("nomad.solver.tier_breaker_opened")
                metrics.incr(f"nomad.solver.tier_breaker_opened.{tier}")
                if device_loss:
                    metrics.incr(
                        "nomad.solver.tier_breaker_opened.device_loss")
                metrics.set_gauge(
                    f"nomad.solver.tier_breaker_state.{tier}", 1)


_breaker = TierBreaker()


def breaker() -> TierBreaker:
    return _breaker


def breaker_record(tier: str, ok: bool) -> None:
    """External dispatch sites (the pipelined placer's materialize) feed
    the same breaker the chain uses."""
    if ok:
        _breaker.record_success(tier)
    else:
        _breaker.record_failure(tier)


@contextmanager
def async_dispatch():
    """Inside this context the chain returns device tensors WITHOUT
    copying them to the host (the pipelined placer overlaps chunk solves
    with host work); asynchronous device failures then surface at the
    caller's materialize site, which owns the breaker feedback: the
    chain defers record_success, since a result that has not reached the
    host proves nothing about the card."""
    prev = getattr(_dispatch_ctx, "on", False)
    _dispatch_ctx.on = True
    try:
        yield
    finally:
        _dispatch_ctx.on = prev


def host_sync():
    """Time a solve's wait for the card's answer at one host sync: a
    `nomad.solver.device` sample (its count is the host syncs of the
    eval) and a `solver.device_wait` span. On the CPU tier it times the
    same seam, where there is nothing to wait for."""
    return timing.timed("nomad.solver.device", "solver.device_wait")


def to_host(out):
    """A chain result (a tensor, a sharding.NodeSharded, or a tuple of
    them) on the host: the solve's sync. Numpy arrays pass through."""
    from . import sharding
    if isinstance(out, torch.Tensor):
        return out.cpu()
    if isinstance(out, sharding.NodeSharded):
        return torch.from_numpy(sharding.to_host(out))
    if isinstance(out, tuple):
        return tuple(to_host(o) for o in out)
    return out


def _chain(kernel: str, tier: str, fn, dev):
    """The per-call dispatch of `fn` on `tier`. A classified device error
    (at the launch, or at the host copy that ends a non-async call) is
    noted (note_dispatch_failure) and raised; any other error raises
    untouched and feeds nothing. On the cuda rung the card's
    `device.lost.d<N>` fault site fires (sharding.solo_loss_site)."""

    def run(*args, finish=None, host_args=None):
        """`finish(out)`: the caller's end of a non-async call, the host
        copy of what it needs (a scan refill reads one scalar); the plain
        host copy of every output by default. `host_args` (the sharded
        rung's replay inputs) is not read on a solo rung."""
        del host_args
        async_mode = getattr(_dispatch_ctx, "on", False)
        from ..obs import trace
        from . import sharding
        try:
            with trace.span(f"solver.dispatch.{tier}"):
                faults.fire(f"solver.dispatch.{tier}")
                if tier == "cuda":
                    faults.fire(sharding.solo_loss_site(dev))
                out = fn(*args)
                if not async_mode:
                    with host_sync():
                        out = finish(out) if finish is not None \
                            else to_host(out)
        except device_error_types() as e:
            note_dispatch_failure(tier, e)
            raise
        if not async_mode:
            # async callers report from their materialize site
            _breaker.record_success(tier)
        if tier == "cuda":
            roundtrip.note("preempt" if kernel == "preempt" else "solve")
        metrics.incr(f"nomad.solver.dispatch.{tier}")
        return out
    return run


def _tensor(x, dev, dtype):
    """numpy array (or tensor) -> contiguous tensor on `dev`. A numpy
    array goes to a card through pinned memory without blocking. A
    sharding.NodeSharded (a sharded solve's carried state, replayed solo
    on the survivors' first device after a rebuild) meets there whole."""
    from . import sharding
    if isinstance(x, sharding.NodeSharded):
        x = x.lead()
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).contiguous()
    x = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    if dev.type == "cuda":
        return x.pin_memory().to(dev, non_blocking=True)
    return x


def on_device(kernel: str, args: tuple, dev=None) -> tuple:
    """`kernel`'s normalized positional args with every array on `dev`
    (the solve device by default), so repeated dispatches of the same
    inputs (pipelined chunks) copy nothing."""
    dev = _device.solve_device() if dev is None else dev
    types = _ARG_DTYPES[kernel]
    return tuple(_tensor(a, dev, types[i])
                 if i in types and a is not None else a
                 for i, a in enumerate(args))


def _greedy(fn, dev, cap, used, ask, count, feasible, max_per_node):
    return fn(_tensor(cap, dev, torch.float32),
              _tensor(used, dev, torch.float32),
              _tensor(ask, dev, torch.float32), int(count),
              _tensor(feasible, dev, torch.bool), int(max_per_node))


def _depth(fn, dev, k_max, spread_algorithm, depth_grid, cap, used, ask,
           count, feasible, coll, desired, aff, max_per_node, order_jitter,
           jitter_scale, jitter_samples):
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
    args = on_device("chunked", (
        cap, used, ask, count, feasible, coll, desired, sp_ids, sp_counts,
        sp_desired, sp_mode, sp_weights, aff, dp_ids, dp_remaining,
        placed_init), dev)
    return fn(*args[:3], int(count), args[4], args[5], int(desired),
              *args[7:15], max_per_node=int(max_per_node),
              max_steps=max_steps, spread_algorithm=spread_algorithm,
              placed_init=args[15])


def _preempt(fn, dev, victim_res, victim_prio, ask, free, job_prio):
    t = on_device("preempt", (victim_res, victim_prio, ask, free), dev)
    return fn(*t, int(job_prio))


def _build(kernel: str, tier: str, dev, k_max: int, max_steps: int,
           spread_algorithm: bool, depth_grid=None):
    """One tier's callable: "cuda" binds the hand kernels on the card,
    "torch" the plain versions on the CPU."""
    from . import cuda_kernels, kernels
    card = tier == "cuda"
    if kernel == "greedy":
        impl = (cuda_kernels.fill_greedy_binpack_fused if card
                else kernels.fill_greedy_binpack)
        return functools.partial(_greedy, impl, dev)
    if kernel == "depth":
        impl = cuda_kernels.fill_depth_fused if card else kernels.fill_depth
        return functools.partial(_depth, impl, dev, k_max, spread_algorithm,
                                 depth_grid)
    if kernel == "chunked":
        impl = cuda_kernels.place_chunked if card else kernels.place_chunked
        return functools.partial(_chunked, impl, dev, max_steps,
                                 spread_algorithm)
    if kernel == "preempt":
        # one torch program on either device (no hand kernel)
        return functools.partial(_preempt, kernels.preempt_top_k, dev)
    raise ValueError(f"unknown kernel {kernel!r} (greedy, depth, chunked, "
                     f"preempt)")


def _batch_eligible(kernel: str, count) -> bool:
    """The batch tier's rule (ref backend._tier, `:595-624`): a depth
    solve of 1..BATCH_MAX_COUNT instances while micro-batching is enabled
    and more than one eval is in flight. Re-decided on every select: the
    in-flight count moves."""
    if kernel != "depth" or count is None or \
            not 0 < int(count) <= BATCH_MAX_COUNT:
        return False
    from . import microbatch
    return microbatch.enabled() and microbatch.concurrency() > 1


def _lanes_fn(card: bool, k_max: int, spread_algorithm: bool, depth_grid):
    """The batch tier's window solve over the stacked normalized depth
    columns (tensorize.stack_lanes) -> placed i32[L, N] on the solve
    device: one launch of the depth-curve kernel over the lanes on a
    card, the plain lane solve on the CPU."""
    from . import cuda_kernels, kernels
    impl = cuda_kernels.fill_depth_lanes if card else kernels.fill_depth_lanes

    def run(cap, used, ask, counts, feasible, coll, desired, aff, mpn,
            order_jitter, jitter_scales, jitter_samples):
        if aff is None:
            aff = torch.zeros(cap.shape[:2], dtype=torch.float32,
                              device=cap.device)
        return impl(cap, used, ask, counts, feasible, coll, desired, aff,
                    mpn, order_jitter=order_jitter,
                    jitter_scales=jitter_scales,
                    jitter_samples=jitter_samples, k_max=k_max,
                    spread_algorithm=spread_algorithm,
                    depth_grid=depth_grid)
    return run


def select(kernel: str, n_padded: int = 0, *, count=None, k_max: int = 128,
           spread_algorithm: bool = False, depth_grid=None,
           max_steps: int = 256, mesh_snap=None):
    """-> (tier, chain) for `kernel` in {greedy, depth, chunked, preempt}.
    The tier follows the solve device (device.solve_device(), which
    raises when it is a card and none is present): "cuda" on a card,
    "torch" on the CPU — or "batch" for a depth solve of `count` (the
    instances asked) that may coalesce with concurrent evals
    (_batch_eligible), or "sharded" for a greedy, depth or chunked solve
    at a bucket `n_padded` the mesh takes (sharded_on, under `mesh_snap`, the
    placer's snapshot: its bucket and this choice describe one device
    set). Every card solve runs on the card: no small-count host pick
    (the reference's thresholds were set on a TPU) and no host floor."""
    dev = _device.solve_device()
    tier_name = tier()
    batch = _batch_eligible(kernel, count)
    if kernel in ("greedy", "depth", "chunked") and not batch:
        snap = _snap(mesh_snap)
        if sharded_on(n_padded, snap):
            return select_sharded(kernel, snap, k_max=k_max,
                                  spread_algorithm=spread_algorithm,
                                  depth_grid=depth_grid, max_steps=max_steps)
    key = (kernel, tier_name, str(dev), k_max, spread_algorithm, depth_grid,
           max_steps)
    solo = _cache.get(key)
    if solo is None:
        fn = _build(kernel, tier_name, dev, k_max, max_steps,
                    spread_algorithm, depth_grid)
        solo = _cache[key] = (tier_name, _chain(kernel, tier_name, fn, dev))
    if not batch:
        return solo
    bkey = ("batch",) + key
    batched = _cache.get(bkey)
    if batched is None:
        from . import microbatch
        lanes = _lanes_fn(tier_name == "cuda", k_max, spread_algorithm,
                          depth_grid)
        skey = (kernel, k_max, spread_algorithm, depth_grid)
        solo_fn = solo[1]

        def run_batched(*args, host_args=None):
            del host_args       # a window replays its own stacked inputs
            return microbatch.solve(skey, lanes, solo_fn, args)
        batched = _cache[bkey] = ("batch", run_batched)
    return batched


# ----------------------------------------------------------------- sharded

def select_sharded(kernel: str, snap, *, k_max: int = 128,
                   spread_algorithm: bool = False, depth_grid=None,
                   max_steps: int = 256):
    """-> ("sharded", chain) for `kernel` in {greedy, depth, chunked,
    preempt} on `snap`'s mesh, cached per generation."""
    key = ("sharded", kernel, snap.generation, k_max, spread_algorithm,
           depth_grid, max_steps)
    cached = _cache.get(key)
    if cached is None:
        cached = _cache[key] = ("sharded", _sharded_chain(
            kernel, snap, k_max, spread_algorithm, depth_grid, max_steps))
    return cached


def select_preempt(shard: bool, mesh_snap=None):
    """-> (tier, chain) for the batched preemption scan: its candidate
    axis sharded when `shard` (the placer's PREEMPT_SHARD_MIN) and the
    mesh has more than one shard, unless NOMAD_SOLVER_BACKEND forces a
    solo tier; else the solo chain."""
    tier()
    snap = _snap(mesh_snap)
    forced = os.environ.get("NOMAD_SOLVER_BACKEND", "")
    if shard and snap.mesh is not None and forced in ("", "sharded"):
        return select_sharded("preempt", snap)
    return select("preempt")


def _replay(kernel: str, args: tuple, finish, k_max: int,
            spread_algorithm: bool, depth_grid, err: BaseException,
            max_steps: int = 256):
    """Re-run a sharded dispatch that lost a shard: a fresh selection at
    the new generation (the survivor mesh, or solo on its first device
    where the old bucket no longer divides) on the identical inputs,
    counted in `nomad.mesh.replays`. A cascade replays once a bump, at
    most sharding.MAX_REPLAYS deep; past that the loss raises."""
    from ..obs import trace
    from . import sharding
    depth = getattr(_dispatch_ctx, "replay_depth", 0)
    if depth >= sharding.MAX_REPLAYS:
        raise err
    metrics.incr("nomad.mesh.replays")
    trace.annotate_list("dispatch_errors", "sharded:replay")
    _dispatch_ctx.replay_depth = depth + 1
    try:
        if kernel == "preempt":
            _, fn = select_preempt(True)
        else:
            _, fn = select(kernel, int(args[0].shape[0]), k_max=k_max,
                           spread_algorithm=spread_algorithm,
                           depth_grid=depth_grid, max_steps=max_steps)
        return fn(*args, finish=finish)
    finally:
        _dispatch_ctx.replay_depth = depth


def _sharded_chain(kernel: str, snap, k_max: int, spread_algorithm: bool,
                   depth_grid, max_steps: int = 256):
    """The sharded rung for `kernel` on `snap`'s mesh: the sharded solve
    (sharding.sharded_fill_greedy / _fill_depth / _place_chunked /
    _preempt_top_k) under
    the span solver.dispatch.sharded and the fault sites
    `solver.dispatch.sharded` and `device.lost.d<N>` for each shard. A
    device loss rebuilds the mesh and replays (_replay) from `host_args`
    (the caller's uncommitted host arrays, when it passed twins) or the
    call's own arguments; any other device error is noted and raised."""
    from . import sharding
    m, gen = snap.mesh, snap.generation
    if kernel == "greedy":
        fn = sharding.sharded_fill_greedy(m)
    elif kernel == "depth":
        fn = sharding.sharded_fill_depth(m, k_max, spread_algorithm,
                                         depth_grid)
    elif kernel == "chunked":
        fn = sharding.sharded_place_chunked(m, max_steps, spread_algorithm)
    elif kernel == "preempt":
        fn = sharding.sharded_preempt_top_k(m)
    else:
        raise ValueError(f"no sharded {kernel!r} (greedy, depth, chunked, "
                         f"preempt)")

    def run(*args, finish=None, host_args=None):
        async_mode = getattr(_dispatch_ctx, "on", False)
        from ..obs import trace
        try:
            with trace.span("solver.dispatch.sharded", shards=m.size,
                            generation=gen):
                faults.fire("solver.dispatch.sharded")
                sharding.fire_device_loss_sites(m)
                out = fn(*args)
                if not async_mode:
                    with host_sync():
                        out = finish(out) if finish is not None \
                            else to_host(out)
        except device_error_types() as e:
            if note_dispatch_failure("sharded", e, generation=gen):
                return _replay(kernel,
                               host_args if host_args is not None else args,
                               finish, k_max, spread_algorithm, depth_grid,
                               e, max_steps)
            raise
        if not async_mode:
            _breaker.record_success("sharded")
        roundtrip.note("preempt" if kernel == "preempt" else "solve")
        metrics.incr("nomad.solver.dispatch.sharded")
        return out
    return run


# ------------------------------------------------------------------ convex

def convex_enabled(cfg=None, algorithm=None) -> bool:
    """The convex tier's gate (ref backend.convex_enabled): on when the
    eval's effective scheduler algorithm is "convex" and the hot-
    reloadable SchedulerConfiguration.solver_convex_enabled kill switch
    is on; NOMAD_SOLVER_CONVEX=0/1 overrides both."""
    env = os.environ.get("NOMAD_SOLVER_CONVEX", "")
    if env == "0":
        return False
    if env == "1":
        return True
    if algorithm is not None and algorithm != "convex":
        return False
    return bool(getattr(cfg, "solver_convex_enabled", True))


def select_convex(kernel: str, n_padded: int = 0, *,
                  spread_algorithm: bool = False, twins_device=None,
                  sharded_twins: bool = False, mesh_snap=None):
    """-> (tier, run) for the convex solve of a `kernel` ("depth" or
    "greedy") eval, or None when the convex route declines: the resident
    twins live on another device than the solves, or are of the other
    kind than the tier (ref select_convex's twin/tier mismatch). The
    reference also declines its host tier and remaps its pallas and batch
    tiers to the XLA program; the port has one tier a solve device, so on
    a card every depth and greedy eval takes the convex route.

    On the mesh (sharded_on at `n_padded` under `mesh_snap`) the tier is
    "sharded": sharding.sharded_convex over the state cache's sharded
    twins (`sharded_twins` says the eval holds them; solo twins there
    decline, as sharded twins decline a solo tier).

    `run(*convex_args, host_args=None)` takes convex.convex_eval's
    positional args (the twins, idx, valid, ask, count, ...) and returns
    its outputs on the host through ONE copy (convex.to_host); on the
    sharded tier `host_args` (the same args with the eval's host rows as
    the twins) replays the eval after a lost shard."""
    dev = _device.solve_device()
    tier_name = tier()
    snap = _snap(mesh_snap)
    if sharded_on(n_padded, snap):
        if twins_device is not None and not sharded_twins:
            return None
        key = ("convex", kernel, "sharded", snap.generation,
               spread_algorithm)
        cached = _cache.get(key)
        if cached is None:
            cached = _cache[key] = ("sharded", _convex_sharded_chain(
                kernel, snap, spread_algorithm))
        return cached
    if sharded_twins:
        return None
    if twins_device is not None and torch.device(twins_device) != dev:
        return None
    key = ("convex", kernel, tier_name, str(dev), spread_algorithm)
    cached = _cache.get(key)
    if cached is None:
        cached = _cache[key] = (tier_name, _convex_chain(
            kernel, tier_name, dev, spread_algorithm))
    return cached


def _convex_sharded_chain(kernel: str, snap, spread_algorithm: bool):
    """The convex dispatch on the mesh: sharding.sharded_convex over the
    sharded twins and its one host copy, under the span
    solver.dispatch.convex and the sites `solver.dispatch.convex`,
    `solver.dispatch.sharded` and `device.lost.d<N>` for each shard. A
    device loss rebuilds the mesh and replays the eval at the new
    generation from `host_args` (counted in `nomad.mesh.replays`, at most
    sharding.MAX_REPLAYS deep): on the survivors, or solo on their first
    device; without `host_args`, or past the cap, the loss raises. Any
    other device error is counted (`dispatch_errors.convex` besides the
    tier's) and raised."""
    from . import convex, sharding
    m, gen = snap.mesh, snap.generation
    fn = sharding.sharded_convex(m, spread_algorithm=spread_algorithm)

    def run(*args, host_args=None):
        from ..obs import trace
        try:
            with trace.span("solver.dispatch.convex", tier="sharded",
                            convex=True, kernel=kernel, shards=m.size,
                            generation=gen):
                faults.fire("solver.dispatch.convex")
                faults.fire("solver.dispatch.sharded")
                sharding.fire_device_loss_sites(m)
                placed, fit, iters, gap, won = fn(*args)
                with host_sync():
                    host = convex.to_host((sharding.at_lead(placed),
                                           sharding.at_lead(fit), iters,
                                           gap, won))
        except device_error_types() as e:
            metrics.incr("nomad.solver.dispatch_errors.convex")
            depth = getattr(_dispatch_ctx, "replay_depth", 0)
            if note_dispatch_failure("sharded", e, generation=gen) and \
                    host_args is not None and \
                    depth < sharding.MAX_REPLAYS:
                metrics.incr("nomad.mesh.replays")
                trace.annotate_list("dispatch_errors", "sharded:replay")
                bucket = int(host_args[0].shape[0])
                sel = select_convex(kernel, bucket,
                                    spread_algorithm=spread_algorithm)
                _dispatch_ctx.replay_depth = depth + 1
                try:
                    return sel[1](*host_args, host_args=host_args)
                finally:
                    _dispatch_ctx.replay_depth = depth
            raise
        _breaker.record_success("sharded")
        metrics.incr("nomad.solver.dispatch.convex")
        metrics.incr("nomad.solver.dispatch.convex.sharded")
        roundtrip.note("convex")
        return host
    return run


def _fire_convex_sites(tier: str, dev) -> None:
    """The convex dispatch's fault sites: `solver.dispatch.convex`, the
    tier's own `solver.dispatch.<tier>` and, on a card, its
    `device.lost.d<N>`."""
    from . import sharding
    faults.fire("solver.dispatch.convex")
    faults.fire(f"solver.dispatch.{tier}")
    if tier == "cuda":
        faults.fire(sharding.solo_loss_site(dev))


def _convex_chain(kernel: str, tier: str, dev, spread_algorithm: bool):
    """The convex dispatch: the eval (cuda_kernels.convex_eval_fused on a
    card, convex.convex_eval on the CPU) and its one host copy. A
    classified device error is counted (`nomad.solver.dispatch_errors
    .convex` besides the tier's), fed to the tier's breaker and raised
    out of the eval; anything else raises untouched. The reference's
    demotion to the classic ladder is not ported: a failing kernel is
    reported, never papered over."""
    from . import convex, cuda_kernels
    impl = (cuda_kernels.convex_eval_fused if tier == "cuda"
            else convex.convex_eval)

    def run(*args, host_args=None):
        del host_args           # one rung, no replay
        from ..obs import trace
        try:
            with trace.span("solver.dispatch.convex", tier=tier,
                            convex=True, kernel=kernel):
                _fire_convex_sites(tier, dev)
                out = impl(*on_device("convex", args, dev),
                           spread_algorithm=spread_algorithm)
                with host_sync():
                    host = convex.to_host(out)
        except device_error_types() as e:
            metrics.incr("nomad.solver.dispatch_errors.convex")
            note_dispatch_failure(tier, e)
            raise
        _breaker.record_success(tier)
        metrics.incr("nomad.solver.dispatch.convex")
        metrics.incr(f"nomad.solver.dispatch.convex.{tier}")
        if tier == "cuda":
            roundtrip.note("convex")
        return host
    return run


# ------------------------------------------------------------------- fused

def fused_enabled(cfg=None) -> bool:
    """The whole-eval fused route's gate (ref backend.fused_enabled):
    SchedulerConfiguration.solver_fused_enabled, hot-reloadable, on by
    default; NOMAD_SOLVER_FUSED=0/1 overrides."""
    env = os.environ.get("NOMAD_SOLVER_FUSED", "")
    if env == "0":
        return False
    if env == "1":
        return True
    return bool(getattr(cfg, "solver_fused_enabled", True))


def select_fused(kernel: str, n_padded: int = 0, *, count=None,
                 k_max: int = 128, spread_algorithm: bool = False,
                 depth_grid=None, twins_device=None,
                 sharded_twins: bool = False, mesh_snap=None):
    """-> (tier, run) for the whole-eval fused program of a `kernel`
    ("depth" or "greedy") eval, or None where the route declines: another
    kernel, or resident twins on another device than the solves (ref
    select_fused's twin/tier mismatch). The reference also declines its
    host tier and its pallas tier, where its Pallas kernel owns the shape
    and fusing would trade it for an XLA program; the port's fused
    program runs the same hand kernels, so it fuses on the `cuda` tier and
    on `torch` (a CPU request), as the reference fuses on its xla tier. A
    depth eval that may coalesce (_batch_eligible) takes the "batch" tier:
    its window is one launch of the fused lanes (microbatch.solve_fused).

    `run(*fused_args)` takes kernels.fused_eval_depth's (or _greedy's)
    positional args — the twins, idx, valid, ask, count, ... — and returns
    (placed i32[B], fit bool[B]) on the host through ONE copy
    (cuda_kernels.fused_to_host): the eval's one sync. The placer
    explains on the host, so the program reduces no explain classes.

    On the mesh (sharded_on at `n_padded` under `mesh_snap`) the tier is
    "sharded": sharding.sharded_fused over the state cache's sharded
    twins; a depth eval that may coalesce takes the "batch" tier there
    too, its window each shard's gather entry over the lanes' rows it
    owns (sharding.sharded_fused_lanes). Sharded twins feed the sharded
    tiers alone and solo twins the solo tiers (`sharded_twins` says which
    the eval holds); a mismatch declines, and the classic route serves
    the eval."""
    if kernel not in ("depth", "greedy"):
        return None
    dev = _device.solve_device()
    tier_name = tier()
    snap = _snap(mesh_snap)
    sharded = sharded_on(n_padded, snap)
    if sharded != bool(sharded_twins):
        return None
    if sharded:
        key = ("fused", kernel, "sharded", snap.generation, k_max,
               spread_algorithm, depth_grid)
        solo = _cache.get(key)
        if solo is None:
            solo = _cache[key] = ("sharded", _fused_sharded_chain(
                kernel, snap, k_max, spread_algorithm, depth_grid))
    else:
        if twins_device is not None and torch.device(twins_device) != dev:
            return None
        key = ("fused", kernel, tier_name, str(dev), k_max,
               spread_algorithm, depth_grid)
        solo = _cache.get(key)
        if solo is None:
            solo = _cache[key] = (tier_name, _fused_chain(
                kernel, tier_name, dev, k_max, spread_algorithm, depth_grid))
    if not _batch_eligible(kernel, count):
        return solo
    bkey = ("batch",) + key
    batched = _cache.get(bkey)
    if batched is None:
        from . import microbatch, sharding
        # a window over sharded twins: each shard's gather entry over the
        # lanes' rows it owns (sharding.sharded_fused_lanes)
        lanes = sharding.sharded_fused_lanes(
            k_max, spread_algorithm, depth_grid) if sharded else \
            _fused_lanes_fn(tier_name == "cuda", k_max, spread_algorithm,
                            depth_grid)
        skey = ("fused", kernel, k_max, spread_algorithm, depth_grid)
        solo_fn = solo[1]

        def run_batched(*args, host_args=None):
            del host_args       # a window replays its own stacked inputs
            # a window's faults and errors are the micro-batcher's; a
            # window of one runs the solo chain, with its own sites
            with _fused_span("batch", kernel):
                return microbatch.solve_fused(skey, lanes, solo_fn, args)
        batched = _cache[bkey] = ("batch", run_batched)
    return batched


@contextmanager
def _fused_span(tier: str, kernel: str):
    """The fused dispatch's span (ref _fused_chain): solver.dispatch.fused,
    or solver.dispatch.batch around a window's whole wait."""
    from ..obs import trace
    name = "solver.dispatch.batch" if tier == "batch" \
        else "solver.dispatch.fused"
    with trace.span(name, tier=tier, fused=True, kernel=kernel):
        yield


def note_fused(tier: str) -> None:
    """Bill one fused eval's dispatch: `nomad.solver.dispatch.fused[.tier]`
    and, on a card, its one round trip."""
    metrics.incr("nomad.solver.dispatch.fused")
    metrics.incr(f"nomad.solver.dispatch.fused.{tier}")
    if tier != "torch":
        roundtrip.note("fused")


def _fused_call(kernel: str, impl, dev, k_max: int, spread_algorithm: bool,
                depth_grid, args: tuple):
    """One fused eval's launches: `args` on `dev`, host scalars as the
    wrappers take them."""
    t = on_device(f"fused_{kernel}", args, dev)
    if kernel == "greedy":
        return impl(*t[:5], int(t[5]), t[6], int(t[7]), t[8], bool(t[9]),
                    t[10])
    (cap_res, used_res, idx, valid, ask, count, feasible, coll, desired, aff,
     mpn, jitter, jscale, jsamples, cls, dh) = t
    if aff is None:
        aff = torch.zeros(idx.shape, dtype=torch.float32, device=dev)
    return impl(cap_res, used_res, idx, valid, ask, int(count), feasible,
                coll, int(desired), aff, int(mpn), jitter,
                float(np.float32(jscale)), float(np.float32(jsamples)), cls,
                bool(dh), k_max=k_max, spread_algorithm=spread_algorithm,
                depth_grid=depth_grid)


def _fused_chain(kernel: str, tier: str, dev, k_max: int,
                 spread_algorithm: bool, depth_grid):
    """The fused dispatch (ref _fused_chain): the eval (cuda_kernels.
    fused_eval_depth/_greedy on a card, the plain kernels.fused_eval_* on
    the CPU) and its one host copy, under the span solver.dispatch.fused
    and the fault sites `solver.dispatch.fused`, `solver.dispatch.<tier>`
    and, on a card, `device.lost.d<N>`. A classified device error is
    counted (`nomad.solver.dispatch_errors.fused` besides the tier's), fed
    to the tier's breaker and raised out of the eval; anything else raises
    untouched. The reference's re-solve through the classic ladder is not
    ported: card work never moves to the CPU, and a failing kernel is
    reported, never papered over."""
    from . import cuda_kernels, kernels, sharding
    mod = cuda_kernels if tier == "cuda" else kernels
    impl = mod.fused_eval_depth if kernel == "depth" \
        else mod.fused_eval_greedy

    def run(*args, host_args=None):
        del host_args           # one rung, no replay
        try:
            with _fused_span(tier, kernel):
                faults.fire("solver.dispatch.fused")
                faults.fire(f"solver.dispatch.{tier}")
                if tier == "cuda":
                    faults.fire(sharding.solo_loss_site(dev))
                res = _fused_call(kernel, impl, dev, k_max,
                                  spread_algorithm, depth_grid, args)
                with host_sync():
                    out = cuda_kernels.fused_to_host(*res)
        except device_error_types() as e:
            metrics.incr("nomad.solver.dispatch_errors.fused")
            note_dispatch_failure(tier, e)
            raise
        _breaker.record_success(tier)
        note_fused(tier)
        return out
    return run


def _fused_sharded_chain(kernel: str, snap, k_max: int,
                         spread_algorithm: bool, depth_grid):
    """The fused dispatch on the mesh: sharding.sharded_fused over the
    sharded twins and its one host copy, under the span
    solver.dispatch.fused and the sites `solver.dispatch.fused`,
    `solver.dispatch.sharded` and `device.lost.d<N>` for each shard. A
    device loss rebuilds the mesh and replays the eval through the
    classic chain at the new generation from `host_args` (the eval's
    uncommitted host rows: the twins it held may be of the dead mesh),
    which returns no verdict (None), as the reference's classic replay
    does; without `host_args` the loss raises."""
    from . import cuda_kernels, sharding
    m, gen = snap.mesh, snap.generation
    fn = sharding.sharded_fused(m, kernel=kernel, k_max=k_max,
                                spread_algorithm=spread_algorithm,
                                depth_grid=depth_grid)

    def run(*args, host_args=None):
        try:
            with _fused_span("sharded", kernel):
                faults.fire("solver.dispatch.fused")
                faults.fire("solver.dispatch.sharded")
                sharding.fire_device_loss_sites(m)
                res = fn(*args)
                with host_sync():
                    out = cuda_kernels.fused_to_host(*res)
        except device_error_types() as e:
            metrics.incr("nomad.solver.dispatch_errors.fused")
            if note_dispatch_failure("sharded", e, generation=gen) and \
                    host_args is not None:
                metrics.incr("nomad.mesh.replays")
                _, classic = select(kernel, int(host_args[0].shape[0]),
                                    k_max=k_max,
                                    spread_algorithm=spread_algorithm,
                                    depth_grid=depth_grid)
                return classic(*host_args).numpy(), None
            raise
        _breaker.record_success("sharded")
        note_fused("sharded")
        return out
    return run


def _fused_lanes_fn(card: bool, k_max: int, spread_algorithm: bool,
                    depth_grid):
    """The batch tier's fused window over one twin pair and the stacked
    lane columns (FUSED_LANE_DTYPES) -> (placed i32[L, B], fit
    bool[L, B]) on the solve device: one launch of the depth-curve
    kernel's gather entry over the lanes, the tail and one verdict launch
    on a card; the plain lane eval on the CPU."""
    from . import cuda_kernels, kernels
    impl = cuda_kernels.fused_eval_depth_lanes if card \
        else kernels.fused_eval_depth_lanes

    def run(cap_res, used_res, idx, valid, ask, counts, feasible, coll,
            desired, aff, mpn, jitter, jitter_scales, jitter_samples):
        if aff is None:
            aff = torch.zeros(idx.shape, dtype=torch.float32,
                              device=idx.device)
        return impl(cap_res, used_res, idx, valid, ask, counts, feasible,
                    coll, desired, aff, mpn, order_jitter=jitter,
                    jitter_scales=jitter_scales,
                    jitter_samples=jitter_samples, k_max=k_max,
                    spread_algorithm=spread_algorithm, depth_grid=depth_grid)
    return run


def record(kernel: str, backend: str) -> None:
    """Emit the per-solve routing metrics
    (`nomad.solver.kernel.<kernel>.<tier>`)."""
    metrics.incr(f"nomad.solver.backend.{backend}")
    metrics.incr(f"nomad.solver.kernel.{kernel}.{backend}")
    # attribute the selected tier/kernel onto the in-flight solve span
    from ..obs import trace
    trace.annotate(tier=backend, kernel=kernel)


# ------------------------------------------------------------------ warmup

# clusters below this don't warm by default: a unit-test server with a
# handful of mock nodes would pay the kernel builds on every promotion.
# NOMAD_AOT_WARMUP=1 forces, =0 disables.
WARMUP_MIN_NODES = 256


def warmup(n_nodes: int, k_maxes: tuple = (8, 64, 128),
           budget_s: float = 300.0, cfg=None) -> dict:
    """Build and load every kernel the card path uses before the first
    real eval (ref backend.warmup; on a mesh, its sharded chains): called
    from Server._establish_leadership on promotion (a background thread), so a
    leader's first eval builds and loads no kernel. One tiny synthetic
    solve per (kernel, regime) at the cluster's bucket, driven through
    the real `select()` chains — the depth curve dense and on the sampled
    grid for each k_max, the greedy pass and the chunked scan — then one
    two-lane window of the batch tier's lane solve, one fused eval per
    depth regime and the fused greedy eval through `select_fused` when
    fusion is on (ref warmup's fused block), and one convex eval per
    spread setting when the config routes to convex.
    Most-valuable-first under `budget_s`. Raises nothing: a failure is
    counted (`nomad.solver.warmup.errors`) and the eval pays the build
    lazily (NOMAD_DEBUG=1 re-raises). With NOMAD_COMPILE_CACHE set the
    built libraries persist, so a warm restart only loads them."""
    from .buckets import node_bucket
    from .kernels import DEPTH_GRID, NUM_XR
    from .tensorize import stack_lanes

    mode = os.environ.get("NOMAD_AOT_WARMUP", "")
    if mode == "0" or (n_nodes < WARMUP_MIN_NODES and mode != "1"):
        return {"skipped": True, "artifacts": 0, "seconds": 0.0}
    bucket = node_bucket(n_nodes)
    cap = np.zeros((bucket, NUM_XR), np.float32)
    cap[:] = (4_000.0, 8_192.0, 500_000.0, 12_001.0, 10_000.0)
    used = np.zeros_like(cap)
    ask = np.zeros(NUM_XR, np.float32)
    ask[:3] = (250.0, 512.0, 300.0)
    feasible = np.ones(bucket, bool)
    jitter = np.zeros(bucket, np.float32)
    coll = np.zeros(bucket, np.int32)
    depth_args = (cap, used, ask, np.int32(1), feasible, coll, np.int32(1),
                  np.zeros(bucket, np.float32), np.int32(2 ** 30), jitter,
                  np.float32(1.0), np.float32(0.0))
    t0 = time.monotonic()
    artifacts = 0
    plan: list[tuple] = []
    for k_max in k_maxes:
        grid = tuple(g for g in DEPTH_GRID if g <= k_max) or (1,)
        plan.append(("depth", {"k_max": k_max, "depth_grid": None}))
        plan.append(("depth", {"k_max": k_max, "depth_grid": grid}))
    plan.append(("greedy", {}))
    plan.append(("chunked", {"max_steps": 256}))
    plan.append(("lanes", {}))
    for kernel, kw in plan:
        if time.monotonic() - t0 > budget_s:
            metrics.incr("nomad.solver.warmup.budget_exhausted")
            break
        try:
            if kernel == "lanes":
                lanes = _lanes_fn(tier() == "cuda", k_maxes[-1], False, None)
                to_host(lanes(*stack_lanes([depth_args] * 2,
                                           _ARG_DTYPES["depth"])))
                artifacts += 1
                continue
            # no count: a synthetic solve never joins a live window
            _, fn = select(kernel, bucket, **kw)
            if kernel == "depth":
                fn(*depth_args)
            elif kernel == "greedy":
                fn(cap, used, ask, np.int32(1), feasible, np.int32(2 ** 30))
            else:
                s_ids = np.full((1, bucket), -1, np.int32)
                pad2 = np.full((1, 2), -1, np.int32)
                fn(cap, used, ask, np.int32(1), feasible, coll,
                   np.int32(1), s_ids, pad2,
                   np.full((1, 2), -1.0, np.float32),
                   np.full(1, -1, np.int32), np.zeros(1, np.float32),
                   np.zeros(bucket, np.float32), s_ids, pad2,
                   np.zeros(bucket, np.int32), np.int32(2 ** 30))
            artifacts += 1
        except Exception as e:  # noqa: BLE001 — warmup must never wedge
            metrics.incr("nomad.solver.warmup.errors")
            if os.environ.get("NOMAD_DEBUG"):
                raise
            del e
    idx = np.arange(bucket, dtype=np.int32)
    valid = np.ones(bucket, bool)
    cls = np.zeros(bucket, np.int32)
    # the fused route (ref warmup's fused block): one synthetic fused eval
    # per depth regime and the greedy one through the real select_fused
    # chains, over the synthetic matrices as the twins
    if fused_enabled(cfg) and time.monotonic() - t0 <= budget_s:
        from . import sharding
        snap = sharding.snapshot()
        shard = sharded_on(bucket, snap)
        twins = (cap, used)
        if shard:
            # the sharded route's twins, as the state cache seeds them
            twins = tuple(sharding.put_node_sharded(t, snap.mesh,
                                                    torch.float32)
                          for t in (cap, used))
        head = twins + (idx, valid, ask, np.int32(1), feasible)
        for kernel, kw in plan:
            if kernel not in ("depth", "greedy"):
                continue
            if time.monotonic() - t0 > budget_s:
                metrics.incr("nomad.solver.warmup.budget_exhausted")
                break
            try:
                sel = select_fused(kernel, bucket, sharded_twins=shard,
                                   **kw)
                if sel is None:
                    continue
                _, fn = sel
                if kernel == "depth":
                    fn(*head, *depth_args[5:], None, np.bool_(False))
                else:
                    fn(*head, np.int32(2 ** 30), None, np.bool_(False), coll)
                artifacts += 1
            except Exception as e:  # noqa: BLE001 — warmup never wedges
                metrics.incr("nomad.solver.warmup.errors")
                if os.environ.get("NOMAD_DEBUG"):
                    raise
                del e
    # the convex solve (ref warmup's convex block): one synthetic eval per
    # spread setting through the real select_convex chain, whenever the
    # config could route evals to the "convex" algorithm
    if convex_enabled(cfg, getattr(cfg, "scheduler_algorithm", "convex")) \
            and time.monotonic() - t0 <= budget_s:
        from . import sharding
        snap = sharding.snapshot()
        shard = sharded_on(bucket, snap)
        twins = (cap, used)
        if shard:
            # the sharded solve's twins, as the state cache seeds them
            twins = tuple(sharding.put_node_sharded(t, snap.mesh,
                                                    torch.float32)
                          for t in (cap, used))
        for spread in (False, True):
            if time.monotonic() - t0 > budget_s:
                metrics.incr("nomad.solver.warmup.budget_exhausted")
                break
            try:
                sel = select_convex("greedy", bucket,
                                    spread_algorithm=spread,
                                    sharded_twins=shard, mesh_snap=snap)
                if sel is None:
                    continue
                sel[1](*twins, idx, valid, ask, np.int32(1), feasible,
                       np.int32(2 ** 30), np.zeros(bucket, np.float32),
                       coll, cls, np.bool_(False), np.int32(200),
                       np.float32(1e-4), np.float32(0.05),
                       np.float32(2 ** 30))
                artifacts += 1
            except Exception as e:  # noqa: BLE001 — warmup never wedges
                metrics.incr("nomad.solver.warmup.errors")
                if os.environ.get("NOMAD_DEBUG"):
                    raise
                del e
    seconds = time.monotonic() - t0
    metrics.incr("nomad.solver.warmup.artifacts", artifacts)
    metrics.set_gauge("nomad.solver.warmup.seconds", round(seconds, 3))
    return {"skipped": False, "artifacts": artifacts,
            "seconds": round(seconds, 3), "bucket": bucket}
