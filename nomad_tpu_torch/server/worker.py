"""Scheduler workers (ref nomad/worker.go:385 Worker.run): dequeue an eval,
wait for state to catch up to it, run the scheduler, submit plans, ack/nack.

The worker is the scheduler's Planner implementation (ref
scheduler/scheduler.go:113): SubmitPlan routes through the serial plan
applier; eval updates commit through the log.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from .. import faults
from ..metrics import metrics, record_swallowed_error
from ..obs import timing, trace
from ..scheduler import new_scheduler
from ..structs import Evaluation, Plan, PlanResult, EVAL_STATUS_FAILED
from .eval_broker import EvalBroker
from .fsm import EVAL_UPDATE, RaftLog
from .plan_apply import Planner

DEQUEUE_TIMEOUT = 0.5


class EvalNotHeld(RuntimeError):
    """The worker's eval is no longer outstanding under its token: the
    broker took it back (a flush at a leadership change, a nack timeout)
    and may have handed it to another worker, so this worker's plans and
    eval writes are refused."""


class Worker:
    def __init__(self, server, worker_id: int = 0):
        self.server = server
        self.id = worker_id
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._snapshot = None
        self._eval_token = ""
        self._eval: Optional[Evaluation] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=f"worker-{self.id}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float = 5.0) -> None:
        if self._thread:
            self._thread.join(timeout)

    # ---------------------------------------------------------------- loop

    def run(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            ev, token = self.server.eval_broker.dequeue(
                self.server.scheduler_types, timeout=DEQUEUE_TIMEOUT)
            if ev is None:
                # a disabled broker (every follower's) answers at once:
                # wait on its condition, which enabling it (leadership)
                # notifies, instead of spinning on the interpreter lock
                # that the server's Raft threads need
                broker = self.server.eval_broker
                with broker._lock:
                    if not broker._enabled and not self._stop.is_set():
                        broker._cond.wait(DEQUEUE_TIMEOUT)
                continue
            # ref worker.go:461 `nomad.worker.dequeue_eval`
            metrics.add_sample("nomad.worker.dequeue_eval",
                               time.perf_counter() - t0)
            self._eval, self._eval_token = ev, token
            # hot-reload the tracing knobs from the raft-replicated
            # scheduler config (same path as eval_batch_*), then adopt
            # the trace the broker began at enqueue — the cross-thread
            # handoff (ISSUE 7). begin_eval covers broker-less paths
            # (restore corners, direct test drives): idempotent.
            cfg = self.server.state.get_scheduler_config()
            trace.configure(
                enabled=getattr(cfg, "telemetry_trace_enabled", True),
                sample_rate=getattr(cfg, "telemetry_trace_sample", 1.0),
                capacity=getattr(cfg, "telemetry_trace_capacity", None))
            broker_owner = id(self.server.eval_broker)
            ctx = trace.eval_ctx(ev.id) or trace.begin_eval(
                ev.id, "eval", owner=broker_owner, job=ev.job_id,
                type=ev.type, trigger=ev.triggered_by)
            # deadline propagation (ISSUE 8): an eval whose enqueue TTL
            # lapsed in the queue is dropped BEFORE the solve — its
            # caller already gave up, so device time spent on it is pure
            # anti-goodput. The drop is acked (the eval is done, not
            # redelivered) and traced with the `expired` disposition.
            if ev.deadline_unix and time.time() >= ev.deadline_unix:
                try:
                    faults.fire("worker.expire")
                    metrics.incr("nomad.worker.eval_expired")
                    trace.end_eval(
                        ev.id, "expired", owner=broker_owner,
                        deadline_unix=ev.deadline_unix,
                        late_s=round(time.time() - ev.deadline_unix, 3))
                    self.server.eval_broker.ack(ev.id, token)
                except Exception as e:   # noqa: BLE001 — injected/ack race
                    # an injected expiry-path fault (or an ack race with
                    # a nack-timeout sweep) must not kill the worker loop
                    record_swallowed_error("worker.expire", e)
                continue
            # the broker keeps the eval while its scheduler runs: in
            # process a worker stops only with its server, so the nack
            # timer would only ever race a live one (a host binpack of
            # thousands of instances outlasts it under a busy interpreter)
            broker = self.server.eval_broker
            with broker._lock:
                rec = broker._unack.get(ev.id)
                if rec is not None and rec["token"] == token:
                    rec["deadline"] = float("inf")
            try:
                with trace.use(ctx), \
                        trace.span("worker.invoke", worker=self.id,
                                   type=ev.type):
                    self._invoke_scheduler(ev)
            except Exception as e:      # noqa: BLE001
                # the nack path survives the exception, but it must not
                # be invisible: a sick device/tier shows up here first
                # (ISSUE 3 — counted per scheduler type for triage)
                metrics.incr("nomad.worker.eval_failures")
                metrics.incr(f"nomad.worker.eval_failures.{ev.type}")
                record_swallowed_error("worker.run", e)
                self.server.logger(f"worker-{self.id}: eval {ev.id[:8]} "
                                   f"failed: {e!r}")
                trace.end_eval(ev.id, "error", owner=broker_owner,
                               error=repr(e)[:200])
                try:
                    self.server.eval_broker.nack(ev.id, token)
                except ValueError:
                    pass
                continue
            trace.end_eval(ev.id, "ok", owner=broker_owner)
            try:
                self.server.eval_broker.ack(ev.id, token)
            except ValueError:
                pass

    def _invoke_scheduler(self, ev: Evaluation) -> None:
        """ref worker.go:552 invokeScheduler"""
        faults.fire("worker.invoke")
        if ev.type == "_core":
            self.server.core_scheduler.process(ev)
            return
        wait_index = max(ev.modify_index, ev.snapshot_index)
        with timing.timed("nomad.worker.wait_for_index",
                          "worker.wait_for_index", index=wait_index):
            self._snapshot = self.server.state.snapshot_min_index(
                wait_index, timeout=5.0)
        sched = new_scheduler(ev.type, self._snapshot, self)
        # ref worker.go:553 `nomad.worker.invoke_scheduler_<type>`; the
        # thread's CPU seconds over the same block under a name outside
        # that prefix, which counts the evals processed
        with timing.timed(f"nomad.worker.invoke_scheduler_{ev.type}",
                          "scheduler.process",
                          cpu="nomad.worker.invoke_cpu", type=ev.type):
            sched.process(ev)

    # ------------------------------------------------- Planner interface

    def _hold(self) -> None:
        """Refuse a write for an eval this worker no longer holds (ref
        plan_endpoint.go Submit and eval_endpoint.go Update/Create check
        the eval's token): an eval the broker took back is placed by
        another worker, and both plans would commit."""
        if self._eval is None or not self._eval_token:
            return
        if self.server.eval_broker.outstanding(self._eval.id) != \
                self._eval_token:
            raise EvalNotHeld(f"eval {self._eval.id[:8]} is no longer "
                              f"held by worker-{self.id}")

    def submit_plan(self, plan: Plan) -> Optional[PlanResult]:
        """ref worker.go:585 SubmitPlan"""
        plan.eval_token = self._eval_token
        plan.snapshot_index = max(plan.snapshot_index,
                                  self._snapshot.latest_index()
                                  if self._snapshot else 0)
        self._hold()
        with timing.timed("nomad.worker.submit_plan", "plan.submit"):
            # wait for the applier's answer (ref: no deadline): a plan
            # given up on while still queued commits later, under a retry
            # that places the same instances again
            result = self.server.planner.submit_plan(plan, timeout=None)
        if result is None:
            return None
        # state refresh hint after rejections (ref worker.go shouldResubmit)
        if result.refresh_index:
            try:
                self._snapshot = self.server.state.snapshot_min_index(
                    result.refresh_index, timeout=5.0)
            except TimeoutError as e:
                # survivable (the stale snapshot just means another
                # rejection/retry round) but never silent (ISSUE 3)
                record_swallowed_error("worker.refresh_snapshot", e,
                                       self.server.logger)
        return result

    def submit_plan_async(self, plan: Plan):
        """Pipelined plan lifecycle: enqueue an intermediate chunk plan on
        the serial applier WITHOUT waiting for the result — the scheduler
        overlaps the next chunk's solve/materialize with this commit (ref
        plan_apply.go:71, where evaluation overlaps the previous raft
        commit). Returns the queue's pending handle; the placer resolves
        every pending before the eval's final plan is submitted, so commit
        order and the refresh-after-rejection contract are preserved."""
        plan.eval_token = self._eval_token
        plan.snapshot_index = max(plan.snapshot_index,
                                  self._snapshot.latest_index()
                                  if self._snapshot else 0)
        self._hold()
        return self.server.planner.submit_plan_async(plan)

    def update_eval(self, ev: Evaluation) -> None:
        """ref worker.go:640 UpdateEval"""
        self._hold()
        ev = ev.copy()
        ev.modify_time_unix = time.time()
        self.server.raft.apply(EVAL_UPDATE, {"evals": [ev]})

    def create_eval(self, ev: Evaluation) -> None:
        """ref worker.go:665 CreateEval"""
        self._hold()
        ev = ev.copy()
        ev.create_time_unix = ev.modify_time_unix = time.time()
        self.server.raft.apply(EVAL_UPDATE, {"evals": [ev]})

    def reblock_eval(self, ev: Evaluation) -> None:
        self.server.blocked_evals.block(ev)

    def refresh_snapshot(self, old):
        self._snapshot = self.server.state.snapshot()
        return self._snapshot
