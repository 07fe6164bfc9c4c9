"""Eval-stream micro-batching: coalesce the small depth solves of
concurrent evals into one lane-batched launch on the card. Counterpart of
nomad_tpu/solver/microbatch.py.

With several scheduler workers in flight, the FIRST pending solve of a
window waits a short time (SchedulerConfiguration.eval_batch_window_ms,
hot-reloadable) for siblings; the window is solved as ONE launch of the
depth-curve kernel over its lanes plus the torch tail over [L, N] (cuda_kernels.fill_depth_lanes; the plain
kernels.fill_depth_lanes on the CPU), and each worker gets its own row
back. Each lane's placements equal that lane's solo solve bit for bit.

Fused windows (`solve_fused`): concurrent fused depth evals whose
inputs reference the SAME resident twin pair (the state cache's twins
at one journal version) coalesce into one launch of the depth-curve
kernel's gather entry over an idx [L, B], then the tail and one verdict
launch over the lanes (cuda_kernels.fused_eval_depth_lanes); the twins
are shared, never stacked. Each lane gets its own (placed, fit) back,
equal to its solo fused solve bit for bit.

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
    of the window: there is no per-lane host fan-out. A device LOSS that
    rebuilds the mesh replays the identical window at the new generation
    (at most sharding.MAX_REPLAYS times, `nomad.mesh.replays`), as the
    reference replays it.
  * on a mesh, a classic window whose lane count divides over the
    shards splits its lanes over them (`sharding.lane_sharding`, the
    reference's lane axis over the mesh): shard s gets the stacked
    columns of lanes [s L/S, (s + 1) L/S) and solves them with ONE launch
    of the depth-curve kernel and the tail, and the rows meet on the
    mesh's first device (`sharding.split_lanes`). Any other lane count
    runs solo on the first device, as the reference's `lane_sharding`
    returns None. A fused window over node-sharded twins runs each
    shard's gather entry over the lanes' rows it owns
    (`sharding.sharded_fused_lanes`). Such windows fire every shard's
    `device.lost.d<N>` site, a solo one only the first shard's.
  * a window is not padded to LANES rows: the reference pads with
    count-0 clones of lane 0 because its XLA program has one fixed
    shape, while a launch takes any lane count, so padding lanes would
    only add work.
  * the fused window (`solve_fused`, ref `solve_fused`/`_fused_fn`)
    likewise: a window of one runs the solo fused card solve, and a
    window's device error is raised to every lane.

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


def _shapes(args) -> tuple:
    """The queue key's part for a lane's args: each array's shape, None
    for an absent optional arg (not a scalar's ())."""
    return tuple(None if a is None else tuple(getattr(a, "shape", ()))
                 for a in args)


class _Request:
    __slots__ = ("args", "event", "out", "err", "ctx", "t0",
                 "dispatch_ctx", "coalesced")

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
        self.coalesced = False      # rode a window's launch (not solo)


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
        # nomadlint: disable=LOCK001 — deliberate GIL-atomic store (above)
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
        key = static_key + _shapes(args)
        return self._submit(key, args, solo_fn, lambda batch: self._run_batch(
            static_key, lanes_fn, solo_fn, batch), fused=False)

    def solve_fused(self, static_key: tuple, lanes_fn: Callable,
                    solo_fn: Callable, args: tuple) -> tuple:
        """One fused depth eval (kernels.fused_eval_depth's positional
        args, the twins first) -> (placed i32[B], fit bool[B]) on the
        host. Evals whose args reference the same twin pair coalesce: the
        window leader stacks the lanes' columns (args[2:14]) and runs
        `lanes_fn(cap_res, used_res, *columns)` once; a window of one
        runs `solo_fn(*args)`, the backend's solo fused chain. Twin
        identity keys the queue, so lanes gathered at different journal
        versions form separate windows and each lane's bits are its own
        snapshot's."""
        key = (static_key, id(args[0]), id(args[1])) + _shapes(args[2:14])
        return self._submit(key, args, solo_fn, lambda batch: self._run_batch(
            static_key, lanes_fn, solo_fn, batch, fused=True), fused=True)

    def _submit(self, key: tuple, args: tuple, solo_fn: Callable,
                run: Callable, fused: bool):
        """Queue one lane under `key` and wait for its result: with one
        eval in flight `solo_fn(*args)` at once; else the first lane of a
        window leads it (`_lead`, then `run(batch)`) and the others
        wait."""
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
            self._lead(key, run)
        else:
            # the lane's wait for the card's answer: the window's sync
            from . import backend
            with backend.host_sync():
                req.event.wait(self.window_s() + FOLLOWER_TIMEOUT)
        # per-lane wait span in the EVAL's own trace, linked to the shared
        # dispatch span it rode: enqueue -> result
        trace.record_span(
            "solver.microbatch.wait", req.ctx, req.t0,
            links=(req.dispatch_ctx,) if req.dispatch_ctx else (),
            status="error" if req.err is not None else "ok",
            solo=req.dispatch_ctx is None, leader=leader, fused=fused)
        if req.err is not None:
            raise req.err
        if req.out is None:
            raise RuntimeError("microbatch leader never delivered a result")
        if fused and req.coalesced:
            # this eval's fused solve rode the shared window
            from . import backend
            backend.note_fused("batch")
        elif req.dispatch_ctx is not None:
            # this eval touched the card through the shared window
            from . import roundtrip
            roundtrip.note("solve")
        return req.out

    def _lead(self, key: tuple, run: Callable) -> None:
        """The window leader: collect siblings under `key` for one window,
        then drain the queue and `run(batch)`; an error reaches every
        lane. The wait ends EARLY once every known in-flight eval's lane
        has arrived (or the lane count is full): sleeping out the window
        then would be pure added latency."""
        t_wait = time.perf_counter()
        deadline = time.monotonic() + self.window_s()
        while True:
            # sleep BEFORE the first check: even a window of 0 must yield
            # the GIL once, or released siblings never enqueue
            time.sleep(min(0.001, max(0.0, deadline - time.monotonic())))
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
            run(batch)
        except BaseException as e:   # noqa: BLE001 — fan the error out
            for r in batch:
                if r.err is None and r.out is None:
                    r.err = e
                    r.event.set()
            raise

    def _run_batch(self, static_key: tuple, lanes_fn, solo_fn,
                   batch: list[_Request], fused: bool = False) -> None:
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
            self._dispatch(static_key, lanes_fn, batch[start:start + LANES],
                           fused)

    def _dispatch(self, static_key: tuple, lanes_fn,
                  lanes: list[_Request], fused: bool = False) -> None:
        """One coalesced window: stack its lanes' columns on the solve
        device, launch once, bring the [L, N] result to the host at the
        window's one sync, and hand each lane its row (a fused window:
        its (placed, fit) rows, the twins passed once ahead of the
        columns). A device error is classified, fed to the breaker and
        raised; the caller raises it to every lane."""
        from . import backend, cuda_kernels, sharding
        from .. import faults
        from .tensorize import stack_lanes
        if fused:
            cols = stack_lanes([r.args[2:14] for r in lanes],
                               backend.FUSED_LANE_DTYPES)
            twins = lanes[0].args[:2]
            over_shards = sharding.is_node_sharded(twins[0])
        sp = trace.start_span(
            "solver.microbatch.dispatch",
            links=[r.ctx for r in lanes if r.ctx is not None],
            tier="batch", bucket=len(lanes), lanes=len(lanes), fused=fused)
        sctx = sp.ctx()
        for req in lanes:
            req.dispatch_ctx = sctx
        replays = 0
        while True:
            gen = sharding.generation()
            # a classic window's lanes split over the mesh of this attempt
            # (a replay's: the survivors) where they divide over it
            split = None if fused else sharding.lane_sharding(len(lanes))
            try:
                faults.fire("solver.microbatch.dispatch")
                if split is not None or (fused and over_shards):
                    sharding.fire_device_loss_sites(split)
                else:
                    sharding.fire_device_loss_sites(lead_only=True)
                # the window's one sync, the leader's wait for the card
                if fused:
                    res = lanes_fn(*twins, *cols)
                    with backend.host_sync():
                        # nomadlint: disable=SYNC001 — fused window sync
                        out = tuple(zip(*cuda_kernels.fused_to_host(*res)))
                elif split is None:
                    cols = stack_lanes([r.args for r in lanes],
                                       backend._ARG_DTYPES["depth"])
                    res = lanes_fn(*cols)
                    with backend.host_sync():
                        # nomadlint: disable=SYNC001 — the window's one sync
                        out = res.cpu()
                else:
                    k = len(lanes) // split.size
                    parts = [stack_lanes(
                        [r.args for r in lanes[s * k:(s + 1) * k]],
                        backend._ARG_DTYPES["depth"], dev=d.device)
                        for s, d in enumerate(split.devices)]
                    res = sharding.split_lanes(split, lanes_fn, parts)
                    with backend.host_sync():
                        # nomadlint: disable=SYNC001 — the window's one sync
                        out = res.cpu()
                break
            except backend.device_error_types() as e:
                # a device LOSS that rebuilt the mesh replays the identical
                # window at the new generation; anything else raises to
                # every lane
                if backend.note_dispatch_failure("batch", e, generation=gen) \
                        and replays < sharding.MAX_REPLAYS:
                    replays += 1
                    metrics.incr("nomad.mesh.replays")
                    continue
                sp.end("error", error=repr(e)[:200])
                raise
            except BaseException as e:  # noqa: BLE001 — bugs raise as is
                sp.end("error", error=repr(e)[:200])
                raise
        backend.breaker_record("batch", ok=True)
        if not fused:       # a fused lane bills dispatch.fused.batch
            metrics.incr("nomad.solver.dispatch.batch")
        sp.end("ok")
        for row, req in enumerate(lanes):
            req.out = out[row]
            req.coalesced = True
            req.event.set()

    def on_mesh_rebuild(self, gen: int) -> None:
        """sharding.rebuild()'s hook, in the reference's order. The port's
        batcher holds no mesh-keyed state (a window reads the mesh and
        stacks its columns afresh at each attempt), so nothing is
        dropped; a window in flight during the rebuild replays in
        `_dispatch` on the survivors."""
        del gen

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
solve_fused = _batcher.solve_fused
on_mesh_rebuild = _batcher.on_mesh_rebuild
reset = _batcher.reset
