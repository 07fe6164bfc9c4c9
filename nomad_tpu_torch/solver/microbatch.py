"""Eval-stream micro-batching: coalesce the small depth solves of
concurrent evals into one lane-batched launch on the card. Counterpart of
nomad_tpu/solver/microbatch.py.

With several scheduler workers in flight, the FIRST pending solve of a
window waits a short time (SchedulerConfiguration.eval_batch_window_ms,
hot-reloadable) for siblings; the window is solved as ONE launch of the
depth-curve kernel over its lanes plus the torch tail over [L, N] (cuda_kernels.fill_depth_lanes; the plain
kernels.fill_depth_lanes on the CPU), and each worker gets its own row
back. Each lane's placements equal that lane's solo solve bit for bit.

Shape discipline:
  * requests group by (array shapes, k_max, spread_algorithm, depth_grid)
    — mixed-shape requests form separate windows;
  * a window holds at most LANES lanes; a larger one splits.

Coalescing only engages when more than one eval is in flight; a lone
eval never sleeps on the window. Two in-flight signals feed that
decision: `eval_started`/`eval_finished` from the placer (evals inside
compute_placements) and `broker_in_flight` from the server's eval broker
(evals dequeued but not acked, visible before a sibling reaches its own
solve).

Port differences from the reference, each by the port's rule that card
work never moves to the CPU:
  * a window of one lane (no sibling arrived) runs the normal solo card
    solve (the backend's solo chain), not a host solve, and counts as
    `nomad.solver.microbatch.solo`, as the reference counts it;
  * a device error in a window is classified (backend.note_dispatch_
    failure, tier "batch"), fed to the breaker and raised to EVERY lane
    of the window: there is no per-lane host fan-out and no mesh replay
    (one card).
  * a window is not padded to LANES rows: the reference pads with
    count-0 clones of lane 0 because its XLA program has one fixed
    shape, while a launch takes any lane count, so padding lanes would
    only add work.
  * `solve_fused` and its helpers wait for the fused route (ROADMAP
    Queue 1 item 4).

Metric and span names are the reference's:
`nomad.solver.microbatch.{solo,dispatches,size,early_fire}`,
`solver.microbatch.dispatch` (one span a window, linked to every lane's
eval) and `solver.microbatch.wait` (each lane's wait, in its own trace).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from ..metrics import metrics
from ..obs import trace
from .buckets import BATCH_LANES as LANES   # the largest window
FOLLOWER_TIMEOUT = 120.0    # follower safety valve if a leader dies


class _Request:
    __slots__ = ("args", "event", "out", "err", "ctx", "t0",
                 "dispatch_ctx")

    def __init__(self, args: tuple):
        self.args = args
        self.event = threading.Event()
        self.out: Optional[torch.Tensor] = None
        self.err: Optional[BaseException] = None
        # trace context of the submitting eval (captured on ITS thread)
        # and the shared dispatch span this lane rode: the fan-in links
        self.ctx = trace.current()
        self.t0 = time.perf_counter()
        self.dispatch_ctx = None


class MicroBatcher:
    def __init__(self):
        self._lock = threading.Lock()
        self._queues: dict[tuple, list[_Request]] = {}
        self._window_s = 0.008
        # the overload controller's brownout multiplier: under pressure
        # the window widens so each launch serves more lanes. The placer
        # re-applies the config base every eval; the controller owns this.
        self._pressure_boost = 1.0
        self._enabled = True
        self._active_evals = 0
        self._broker_hint = 0

    # ------------------------------------------------------- configuration

    def configure(self, enabled: bool, window_s: float) -> None:
        """Called by the placer from the CURRENT SchedulerConfiguration on
        every eval: the knobs hot-reload through the replicated config."""
        self._enabled = bool(enabled)
        self._window_s = max(0.0, float(window_s))

    def enabled(self) -> bool:
        return self._enabled

    def set_pressure_boost(self, factor: float) -> None:
        """Overload-controller lever (server/overload.py): >1 widens the
        effective window under pressure; 1.0 restores the config base."""
        with self._lock:
            self._pressure_boost = max(1.0, float(factor))

    def window_s(self) -> float:
        return self._window_s * self._pressure_boost

    # ------------------------------------------------- eval in-flight hints

    def eval_started(self) -> None:
        with self._lock:
            self._active_evals += 1

    def eval_finished(self) -> None:
        with self._lock:
            self._active_evals = max(0, self._active_evals - 1)

    def broker_in_flight(self, n: int) -> None:
        """The eval broker's outstanding (dequeued, unacked) eval count,
        pushed on every dequeue/ack/nack. An int store is atomic under the
        GIL; no lock on the broker's hot path."""
        self._broker_hint = max(0, int(n))

    def concurrency(self) -> int:
        """Best-known count of evals that might still issue a solve."""
        return max(self._active_evals, self._broker_hint)

    # -------------------------------------------------------------- solving

    def solve(self, static_key: tuple, lanes_fn: Callable, solo_fn: Callable,
              args: tuple) -> torch.Tensor:
        """One normalized depth solve -> placed i32[N] on the host. Blocks
        until the result is ready; the calling worker thread may be
        elected window leader and run the whole coalesced launch.
        `lanes_fn(*columns)` solves a window's stacked columns (placed
        [L, N] on the solve device); `solo_fn(*args)` is the backend's
        solo chain for this solve."""
        # None marks an absent optional arg (no affinities, no jitter): it
        # must not collide with a scalar's () shape
        key = static_key + tuple(
            None if a is None else tuple(getattr(a, "shape", ()))
            for a in args)
        solo = False
        with self._lock:
            if self.concurrency() <= 1:
                solo = True
            else:
                q = self._queues.setdefault(key, [])
                req = _Request(args)
                q.append(req)
                leader = len(q) == 1
        if solo:
            metrics.incr("nomad.solver.microbatch.solo")
            return solo_fn(*args)

        if leader:
            # collect siblings for one window, then drain and launch. The
            # wait ends EARLY once every known in-flight eval's lane has
            # arrived (or the lane count is full): sleeping out the window
            # then would be pure added latency
            t_wait = time.perf_counter()
            deadline = time.monotonic() + self.window_s()
            while True:
                # sleep BEFORE the first check: even a window of 0 must
                # yield the GIL once, or released siblings never enqueue
                time.sleep(min(0.001, max(0.0,
                                          deadline - time.monotonic())))
                with self._lock:
                    arrived = len(self._queues.get(key, ()))
                    expected = max(self._active_evals, self._broker_hint)
                if time.monotonic() >= deadline:
                    break
                if arrived >= LANES or arrived >= expected:
                    metrics.incr("nomad.solver.microbatch.early_fire")
                    break
            metrics.add_sample("nomad.solver.microbatch.leader_wait",
                               time.perf_counter() - t_wait)
            with self._lock:
                batch = self._queues.pop(key, [])
            try:
                self._run_batch(static_key, lanes_fn, solo_fn, batch)
            except BaseException as e:   # noqa: BLE001 — fan the error out
                for r in batch:
                    if r.err is None and r.out is None:
                        r.err = e
                        r.event.set()
                raise
        else:
            req.event.wait(self.window_s() + FOLLOWER_TIMEOUT)
        # per-lane wait span in the EVAL's own trace, linked to the shared
        # dispatch span it rode: enqueue -> result
        trace.record_span(
            "solver.microbatch.wait", req.ctx, req.t0,
            links=(req.dispatch_ctx,) if req.dispatch_ctx else (),
            status="error" if req.err is not None else "ok",
            solo=req.dispatch_ctx is None, leader=leader)
        if req.err is not None:
            raise req.err
        if req.out is None:
            raise RuntimeError("microbatch leader never delivered a result")
        if req.dispatch_ctx is not None:
            # this eval touched the card through the shared window
            from . import roundtrip
            roundtrip.note("solve")
        return req.out

    def _run_batch(self, static_key: tuple, lanes_fn, solo_fn,
                   batch: list[_Request]) -> None:
        if not batch:
            return
        if len(batch) == 1:
            # the window closed with no siblings: the solo card solve
            metrics.incr("nomad.solver.microbatch.solo")
            batch[0].out = solo_fn(*batch[0].args)
            batch[0].event.set()
            return
        metrics.incr("nomad.solver.microbatch.dispatches")
        metrics.add_sample("nomad.solver.microbatch.size", len(batch))
        for start in range(0, len(batch), LANES):
            self._dispatch(static_key, lanes_fn, batch[start:start + LANES])

    def _dispatch(self, static_key: tuple, lanes_fn,
                  lanes: list[_Request]) -> None:
        """One coalesced window: stack its lanes' columns on the solve
        device, launch once, bring the [L, N] result to the host at the
        window's one sync, and hand each lane its row.
        A device error is classified, fed to the breaker and raised; the
        caller raises it to every lane."""
        from . import backend, sharding
        from .. import faults
        from .tensorize import stack_lanes
        cols = stack_lanes([r.args for r in lanes],
                           backend._ARG_DTYPES["depth"])
        sp = trace.start_span(
            "solver.microbatch.dispatch",
            links=[r.ctx for r in lanes if r.ctx is not None],
            tier="batch", bucket=len(lanes), lanes=len(lanes))
        sctx = sp.ctx()
        for req in lanes:
            req.dispatch_ctx = sctx
        try:
            faults.fire("solver.microbatch.dispatch")
            sharding.fire_device_loss_sites()
            out = lanes_fn(*cols).cpu()     # the window's one sync
        except backend.device_error_types() as e:
            backend.note_dispatch_failure("batch", e)
            sp.end("error", error=repr(e)[:200])
            raise
        except BaseException as e:      # noqa: BLE001 — bugs raise as is
            sp.end("error", error=repr(e)[:200])
            raise
        backend.breaker_record("batch", ok=True)
        metrics.incr("nomad.solver.dispatch.batch")
        sp.end("ok")
        for row, req in enumerate(lanes):
            req.out = out[row]
            req.event.set()

    def reset(self) -> None:
        """Tests: drop queues and in-flight hints."""
        with self._lock:
            self._queues.clear()
            self._active_evals = 0
            self._broker_hint = 0
            self._pressure_boost = 1.0


_batcher = MicroBatcher()

# module-level forwarding API (the backend, the placer, the broker and the
# overload controller import these; one process-wide batcher, one card)
configure = _batcher.configure
enabled = _batcher.enabled
set_pressure_boost = _batcher.set_pressure_boost
window_s = _batcher.window_s
eval_started = _batcher.eval_started
eval_finished = _batcher.eval_finished
broker_in_flight = _batcher.broker_in_flight
concurrency = _batcher.concurrency
solve = _batcher.solve
reset = _batcher.reset
