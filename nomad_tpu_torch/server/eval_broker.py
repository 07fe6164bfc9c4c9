"""Eval broker: leader-only priority queue of evaluations with ack/nack
semantics (ref nomad/eval_broker.go:47).

Per-scheduler-type priority heaps; at most one eval per job outstanding —
later evals for the same job wait in a pending map (dedup, ref
eval_broker.go:182 Enqueue); nacked evals requeue with escalating delay;
wait_until evals sit in a delay heap served by a timer thread
(ref :758 runDelayedEvalsWatcher).

The broker is also the eval-stream micro-batcher's concurrency oracle:
every dequeue/ack/nack pushes the outstanding-eval count to
solver/microbatch.py, so a worker's small solve knows whether sibling
evals are in flight (worth waiting the coalescing window for) before the
siblings have even reached their own solve call.

The broker is also the first line of overload protection (ISSUE 8):
its backlog is bounded by the hot-reloadable `broker_depth_cap`, and on
overflow the LOWEST-priority queued eval — deterministically by
(priority, seq): lowest priority first, newest arrival within a
priority — is shed into the existing dead-letter lifecycle, where the
leader reaper terminates it and emits a backed-off failed-follow-up.
Shed work retries with backoff instead of vanishing; core/system evals
are never shed. Evals are stamped with an enqueue TTL
(`eval_deadline_s`) so downstream stages can drop work whose caller
already gave up (worker.py, plan_apply.py; docs/OVERLOAD.md).
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Callable, Optional

from .. import faults
from ..metrics import metrics, record_swallowed_error
from ..obs import timing, trace
from ..structs import (
    Evaluation, TRIGGER_FAILED_FOLLOW_UP, TRIGGER_NODE_UPDATE, new_id,
)

DEFAULT_NACK_TIMEOUT = 60.0
DEFAULT_INITIAL_NACK_DELAY = 1.0
DEFAULT_SUBSEQUENT_NACK_DELAY = 20.0

FAILED_QUEUE = "_failed"

# scheduler types exempt from overload shedding: internal housekeeping
# (`_core`) and system jobs keep the cluster itself alive — shedding them
# to make room for user load would trade availability for goodput
SHED_EXEMPT_TYPES = frozenset({"_core", "system"})

# triggers that are never shed victims AND bypass the depth cap:
# failed-follow-ups are the shed/dead-letter lifecycle's own retry
# channel (capping them re-sheds what shedding just parked), and
# node-update evals are the replacement path for work LOST to a node
# failure — dead-lettering those behind user churn would leave dead
# allocs unreplaced exactly when the cluster is busiest (ISSUE 10)
SHED_EXEMPT_TRIGGERS = frozenset({TRIGGER_FAILED_FOLLOW_UP,
                                  TRIGGER_NODE_UPDATE})
# node-update evals also skip the enqueue TTL: replacement of lost
# allocs must complete eventually, not expire behind a burst
DEADLINE_EXEMPT_TRIGGERS = frozenset({TRIGGER_NODE_UPDATE})


class EvalBroker:
    def __init__(self, nack_timeout: float = DEFAULT_NACK_TIMEOUT,
                 initial_nack_delay: float = DEFAULT_INITIAL_NACK_DELAY,
                 subsequent_nack_delay: float = DEFAULT_SUBSEQUENT_NACK_DELAY,
                 delivery_limit: int = 3,
                 config_fn: Optional[Callable] = None):
        self.nack_timeout = nack_timeout
        self.initial_nack_delay = initial_nack_delay
        self.subsequent_nack_delay = subsequent_nack_delay
        self.delivery_limit = delivery_limit
        # overload knobs (ISSUE 8): `config_fn` returns the live
        # SchedulerConfiguration (hot-reloadable; the server wires
        # state.get_scheduler_config); without one the explicit
        # attributes apply (0 = unbounded / no TTL — standalone brokers
        # in unit tests keep the pre-overload behavior)
        self.config_fn = config_fn
        self.depth_cap = 0
        self.eval_deadline_s = 0.0
        # poked whenever the cap trips (shed or exempt-overflow) so the
        # pressure state reacts to a sub-second burst instead of waiting
        # for the next 1s leader tick; the server wires overload.tick
        self.on_overflow: Optional[Callable] = None
        # (priority, seq, eval_id) of recent sheds — the hammer test's
        # determinism witness; bounded so a shed storm cannot leak
        self.shed_log: deque = deque(maxlen=4096)
        # heap entries invalidated by a shed: the eval moved to the
        # FAILED_QUEUE heap but stays in self._evals, so the stale-entry
        # skip in _pick_locked can't key on eval id alone
        self._shed_entries: set = set()
        # delayed failed-follow-ups (the shed/dead-letter RETRY channel)
        # parked in the delay heap: excluded from the depth the cap
        # bounds — they are backoff-parked retries, not offered load,
        # and counting them would let one burst's follow-ups re-trigger
        # shedding forever (shed -> follow-up -> depth -> shed ...)
        self._waiting_follow_ups = 0
        # ids of node-update evals superseded by an already-queued
        # node-update eval for the same job (storm coalescing, ISSUE
        # 10): parked for the leader loop to cancel in state — the
        # broker runs inside the FSM's eval callback, so it can never
        # raft-apply the cancellation itself. Ids only (the cancel path
        # re-reads state by id), drained via take_coalesced().
        self._coalesced: list[str] = []

        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._enabled = False
        self._seq = itertools.count()

        # scheduler type -> heap of (-priority, seq, eval_id)
        self._ready: dict[str, list] = {}
        self._evals: dict[str, Evaluation] = {}        # eval_id -> eval
        self._dequeue_count: dict[str, int] = {}       # eval_id -> deliveries
        # (namespace, job_id) -> blocked evals waiting on the outstanding one
        self._pending: dict[tuple[str, str], list[Evaluation]] = {}
        self._outstanding_jobs: dict[tuple[str, str], str] = {}  # -> eval_id
        self._ready_jobs: dict[tuple[str, str], str] = {}        # -> eval_id
        self._unack: dict[str, dict] = {}              # eval_id -> {token, deadline}
        # eval_id -> perf_counter at its first enqueue, read at dequeue
        # as nomad.broker.wait (delay and job-pending time included)
        self._enqueued: dict[str, float] = {}

        # delayed evals: (wait_until, seq, eval)
        self._delay_heap: list = []
        self._timer: Optional[threading.Thread] = None
        self._shutdown = False

        self.stats = {"total_ready": 0, "total_unacked": 0,
                      "total_pending": 0, "total_waiting": 0,
                      "total_failed": 0, "total_shed": 0}

    def _notify_inflight(self) -> None:
        """Push the outstanding-eval count to the solver micro-batcher
        (its coalescing oracle). Lazy import: the broker must not drag
        jax in; a stripped build without the solver is a no-op."""
        try:
            from ..solver import microbatch
        except ImportError:
            return
        microbatch.broker_in_flight(self.stats["total_unacked"])

    # ------------------------------------------------------------- control

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            was = self._enabled
            self._enabled = enabled
            if not enabled:
                self._flush_locked()
            elif not was:
                self._shutdown = False
                self._timer = threading.Thread(
                    target=self._run_delayed_watcher, daemon=True)
                self._timer.start()
            self._cond.notify_all()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def _flush_locked(self) -> None:
        """Caller holds self._lock (the *_locked convention LOCK001
        checks; ref eval_broker.go flush, called under b.l)."""
        # every live trace this broker started ends here with the flush
        # disposition — the worker processing an outstanding eval may
        # still be mid-span on its own thread, so truncate (no span-leak
        # accounting) rather than demand a clean close (ISSUE 7)
        flushed = set(self._evals) | set(self._unack)
        for pend in self._pending.values():
            flushed.update(ev.id for ev in pend)
        flushed.update(item[2].id for item in self._delay_heap)
        for eval_id in flushed:
            trace.end_eval(eval_id, "flushed", truncate=True,
                           owner=id(self))
        self._ready.clear()
        self._ready_jobs.clear()
        self._evals.clear()
        self._pending.clear()
        self._outstanding_jobs.clear()
        self._unack.clear()
        self._dequeue_count.clear()
        self._enqueued.clear()
        self._delay_heap = []
        self._shed_entries.clear()
        self._waiting_follow_ups = 0
        self._coalesced.clear()
        self._shutdown = True
        # every stat is maintained incrementally (+=/-=) against the
        # queues just cleared — zero them ALL or the stats endpoint
        # reports a phantom backlog for the life of the process
        self.stats["total_ready"] = 0
        self.stats["total_unacked"] = 0
        self.stats["total_pending"] = 0
        self.stats["total_waiting"] = 0
        self.stats["total_failed"] = 0
        metrics.set_gauge("nomad.broker.failed_queue_depth", 0)
        self._notify_inflight()

    # ---------------------------------------------------- overload (ISSUE 8)

    def _overload_knobs(self) -> tuple[int, float]:
        """(depth_cap, eval_deadline_s) from the live scheduler config
        when wired, else the explicit attributes. Reads are two attribute
        lookups on an in-memory dataclass — cheap enough per enqueue."""
        cfg = self.config_fn() if self.config_fn is not None else None
        if cfg is None:
            return self.depth_cap, self.eval_deadline_s
        try:
            return (max(0, int(getattr(cfg, "broker_depth_cap", 0))),
                    max(0.0, float(getattr(cfg, "eval_deadline_s", 0.0))))
        except (TypeError, ValueError):
            return 0, 0.0

    def depth(self) -> int:
        """Queued backlog the depth cap bounds: ready + job-pending +
        delayed, MINUS dead letters (they ride the ready stat but await
        the reaper — counting them would let a shed storm re-trigger
        itself) and unacked (bounded by worker count, already in flight)."""
        with self._lock:
            return self._depth_locked()

    def _depth_locked(self) -> int:
        return max(0, self.stats["total_ready"] - self.stats["total_failed"]
                   + self.stats["total_pending"]
                   + self.stats["total_waiting"]
                   - self._waiting_follow_ups)

    def _delay_push_locked(self, when: float, ev: Evaluation) -> None:
        # callers are bounded: enqueue is depth-cap/shed gated, nack by
        # the delivery limit
        # nomadlint: disable=QUEUE001 — caller-bounded (above)
        heapq.heappush(self._delay_heap, (when, next(self._seq), ev))
        self.stats["total_waiting"] += 1
        if ev.triggered_by == TRIGGER_FAILED_FOLLOW_UP:
            self._waiting_follow_ups += 1

    def _shed_candidates_locked(self):
        """Live, non-exempt ready entries: (neg_priority, seq, eval_id)
        tuples. The victim is max() of these — lowest priority first,
        newest seq within a priority (deterministic by (priority, seq)).
        Deliberately O(ready) per shed: this is the over-cap emergency
        path only (bounded by the cap itself), and a mirrored max-heap
        would need exact-entry liveness tracking across dequeue/nack/
        drain to avoid double-delivery — complexity the correctness
        tests would have to re-prove. Revisit if shed-path lock hold
        time ever shows up in the bench."""
        out = []
        for qname, heap in self._ready.items():
            if qname == FAILED_QUEUE or qname in SHED_EXEMPT_TYPES:
                continue
            out.extend(
                e for e in heap
                if e[2] in self._evals and e not in self._shed_entries
                # exempt triggers are never victims: re-shedding the
                # shed channel's own retries (follow-ups) is a
                # reap<->shed cycle, and shedding lost-alloc
                # replacement work (node-update) dead-letters exactly
                # the evals that keep dead nodes' work alive
                and self._evals[e[2]].triggered_by
                not in SHED_EXEMPT_TRIGGERS)
        return out

    def _shed_locked(self, incoming: Evaluation, incoming_key) -> bool:
        """Make room for `incoming` by dead-lettering the lowest-priority
        queued eval (possibly `incoming` itself). Returns True when the
        incoming eval was the victim (caller must not enqueue it). The
        shed eval re-enters via the failed-eval backoff lifecycle: the
        reaper terminates it and emits a delayed failed-follow-up, so
        shed work retries instead of vanishing (core_sched.py)."""
        victims = self._shed_candidates_locked()
        if incoming.type not in SHED_EXEMPT_TYPES:
            victims.append(incoming_key)
        if not victims:
            # backlog is all core/system work: admit over cap — shedding
            # the cluster's own housekeeping is never the right trade
            metrics.incr("nomad.broker.shed_exempt_overflow")
            return False
        victim = max(victims)
        neg_p, seq, eval_id = victim
        self.shed_log.append((-neg_p, seq, eval_id))
        metrics.incr("nomad.broker.shed")
        self.stats["total_shed"] = self.stats.get("total_shed", 0) + 1
        if victim is incoming_key:
            ev = incoming
            self._evals[eval_id] = ev
            job_key = (ev.namespace, ev.job_id)
            if ev.job_id and job_key not in self._ready_jobs and \
                    job_key not in self._outstanding_jobs:
                # claim the job only when unclaimed: a shed incoming
                # whose job already has a ready/outstanding eval must
                # not steal that eval's dedup registration
                self._ready_jobs[job_key] = eval_id
        else:
            ev = self._evals[eval_id]
            self._shed_entries.add(victim)
            self.stats["total_ready"] -= 1
            # the eval stays in self._evals and keeps its _ready_jobs
            # claim — it is still "ready", just on the dead-letter queue
            # (exactly the nack-at-delivery-limit shape)
        # fresh seq on the dead-letter entry: the tombstone set matches
        # by tuple VALUE, so the failed-queue twin must never compare
        # equal to the invalidated original
        heapq.heappush(self._ready.setdefault(FAILED_QUEUE, []),
                       (neg_p, next(self._seq), eval_id))
        self.stats["total_ready"] += 1
        self.stats["total_failed"] += 1
        metrics.set_gauge("nomad.broker.failed_queue_depth",
                          self.stats["total_failed"])
        # the shed disposition ends the eval's trace (PR-7): the retry
        # is a NEW eval (the follow-up) with its own trace
        trace.end_eval(eval_id, "shed", owner=id(self),
                       priority=ev.priority, shed_seq=seq)
        self._enqueued.pop(eval_id, None)
        self._cond.notify_all()
        return victim is incoming_key

    # ------------------------------------------------------------- enqueue

    def enqueue(self, eval: Evaluation) -> None:
        with self._lock:
            self._enqueue_locked(eval)

    def enqueue_all(self, evals: list[tuple[Evaluation, str]]) -> None:
        """Enqueue evals with optional ack tokens: an eval being re-enqueued
        while outstanding is requeued once its current delivery acks/nacks
        (ref eval_broker.go EnqueueAll)."""
        with self._lock:
            for ev, token in evals:
                if token and ev.id in self._unack:
                    # mark for requeue on ack
                    self._unack[ev.id]["requeue"] = ev
                else:
                    self._enqueue_locked(ev)

    def _enqueue_locked(self, ev: Evaluation) -> None:
        if not self._enabled:
            return
        if ev.id in self._evals:
            return
        if ev.triggered_by == TRIGGER_NODE_UPDATE and ev.job_id and \
                self._node_update_coalesce_locked(ev):
            return
        # the eval's trace begins at broker ENQUEUE: queue/delay/pending
        # wait is attributed as `broker.wait` when it dequeues. Idempotent
        # for live traces (delayed/pending re-enqueues keep theirs); a
        # fresh trace starts after a completed one ended (requeue-on-ack).
        trace.begin_eval(ev.id, "eval", owner=id(self), job=ev.job_id,
                         type=ev.type, trigger=ev.triggered_by,
                         priority=ev.priority)
        self._enqueued.setdefault(ev.id, time.perf_counter())
        now = time.time()
        cap, ttl = self._overload_knobs()
        parking = bool((ev.wait_until_unix and ev.wait_until_unix > now)
                       or ev.wait_sec)
        if ttl > 0 and not ev.deadline_unix and not parking and \
                ev.type not in SHED_EXEMPT_TYPES and \
                ev.triggered_by not in DEADLINE_EXEMPT_TRIGGERS:
            # enqueue TTL (ISSUE 8): stamped on a COPY — the caller's
            # object may be the raft-replicated state eval, which this
            # leader-local deadline must not mutate. The clock starts
            # when the eval becomes RUNNABLE offered load: evals headed
            # for the delay heap (backed-off follow-ups, delayed
            # reschedules) are deliberately parked future work and get
            # their TTL at graduation — stamping them here would expire
            # every retry whose backoff exceeds the TTL, silently
            # voiding the shed/dead-letter contract. Requeues of
            # already-stamped evals (nack delay, pending release) keep
            # the ORIGINAL deadline. Core/system evals are
            # deadline-exempt like they are shed-exempt: expiring
            # housekeeping under load would drop exactly the work that
            # keeps the cluster healthy.
            ev = ev.copy()
            ev.deadline_unix = now + ttl
        if cap > 0 and self._depth_locked() >= cap and \
                ev.triggered_by not in SHED_EXEMPT_TRIGGERS:
            # exempt triggers BYPASS the cap: follow-ups are the shed/
            # dead-letter lifecycle's own retry channel (capping them
            # re-sheds what shedding just parked, a cycle by
            # construction), and node-update replacement work is
            # bounded by the coalescer (at most one per affected job)
            # so admitting it over cap cannot run away
            try:
                faults.fire("broker.shed")
                incoming_was_victim = self._shed_locked(
                    ev, (-ev.priority, next(self._seq), ev.id))
            except Exception as e:   # noqa: BLE001 — injected/shed failure
                # a failed shed (injected fault, accounting error) must
                # not lose the INCOMING eval: admit over cap, loudly —
                # availability beats a strict cap when the shedder breaks
                record_swallowed_error("broker.shed", e)
                incoming_was_victim = False
            if self.on_overflow is not None:
                # pressure reacts NOW, not at the next 1s leader tick —
                # safe under the (reentrant) broker lock: tick reads
                # depth back through it on this same thread
                try:
                    self.on_overflow()
                except Exception as e:   # noqa: BLE001 — telemetry hook
                    record_swallowed_error("broker.overflow_hook", e)
            if incoming_was_victim:
                return
        if ev.wait_until_unix and ev.wait_until_unix > now:
            self._delay_push_locked(ev.wait_until_unix, ev)
            self._cond.notify_all()
            return
        if ev.wait_sec:
            self._delay_push_locked(now + ev.wait_sec, ev)
            self._cond.notify_all()
            return
        job_key = (ev.namespace, ev.job_id)
        if ev.job_id and (job_key in self._outstanding_jobs or
                          job_key in self._ready_jobs):
            # dedup: at most one eval per job ready-or-outstanding; later
            # ones wait in pending until it acks (ref eval_broker.go:182)
            self._pending.setdefault(job_key, []).append(ev)
            self.stats["total_pending"] += 1
            return
        self._evals[ev.id] = ev
        if ev.job_id:
            self._ready_jobs[job_key] = ev.id
        heapq.heappush(self._ready.setdefault(ev.type, []),
                       (-ev.priority, next(self._seq), ev.id))
        self.stats["total_ready"] += 1
        self._cond.notify_all()

    def _node_update_coalesce_locked(self, ev: Evaluation) -> bool:
        """Storm coalescing (ISSUE 10): a node-update eval whose job
        already has a not-yet-dispatched node-update eval queued (ready
        or job-pending) is redundant — the queued one will snapshot
        state AFTER this enqueue, so its scheduler pass covers this
        failure too. Mirrors the blocked-eval dedupe shape: keep the
        earliest, supersede the rest. An OUTSTANDING (dequeued,
        mid-solve) eval does NOT coalesce — its snapshot may predate
        this failure; the normal one-per-job dedupe parks the new eval
        in pending instead, which is exactly the coverage needed.
        Returns True when the incoming eval was superseded; the
        superseded eval is parked for take_coalesced() so the leader
        loop can mark it canceled in state."""
        job_key = (ev.namespace, ev.job_id)
        queued = None
        ready_id = self._ready_jobs.get(job_key)
        if ready_id is not None:
            cand = self._evals.get(ready_id)
            # a DEAD-LETTERED node-update eval never runs a scheduler
            # pass (the reaper terminates it into a backed-off
            # follow-up), so it covers nothing — the newcomer must park
            # via the ordinary one-per-job dedupe instead of being
            # canceled against it
            if cand is not None and \
                    cand.triggered_by == TRIGGER_NODE_UPDATE and \
                    not any(eid == ready_id for _, _, eid in
                            self._ready.get(FAILED_QUEUE, ())):
                queued = cand
        if queued is None:
            for pend in self._pending.get(job_key, ()):
                if pend.triggered_by == TRIGGER_NODE_UPDATE:
                    queued = pend
                    break
        if queued is None:
            return False
        self._coalesced.append(ev.id)
        if len(self._coalesced) > 65536:
            # a drop leaks a permanently-pending state record (the
            # cancel never happens) — the bound exists only as a
            # runaway-memory backstop, so it is ids-only, far above any
            # real storm (one entry per superseded eval between two
            # ~1s leader ticks)
            del self._coalesced[:-65536]
        metrics.incr("nomad.broker.node_update_coalesced")
        return True

    def take_coalesced(self) -> list[str]:
        """Drain the superseded node-update eval ids (leader loop): the
        caller cancels them in state so they terminate instead of
        sitting pending forever."""
        with self._lock:
            out, self._coalesced = self._coalesced, []
            return out

    def restash_coalesced(self, eval_ids: list[str]) -> None:
        """Return drained ids after a FAILED cancel apply — the leader
        re-drains them next tick. Losing them on a transient raft error
        leaks the superseded evals as permanently-pending state records
        (eval GC only reaps terminal evals)."""
        with self._lock:
            self._coalesced[:0] = eval_ids
            if len(self._coalesced) > 65536:
                del self._coalesced[:-65536]

    # ------------------------------------------------------------- dequeue

    def dequeue(self, schedulers: list[str], timeout: Optional[float] = None
                ) -> tuple[Optional[Evaluation], str]:
        """Blocking dequeue; returns (eval, ack_token) (ref :335)."""
        deadline = time.time() + timeout if timeout is not None else None
        with self._lock:
            while True:
                if not self._enabled:
                    return None, ""
                best = self._pick_locked(schedulers)
                if best is not None:
                    self._notify_inflight()
                    eval_id = best[0].id
                    t0 = self._enqueued.pop(eval_id, None)
                    if t0 is not None:
                        timing.waited(
                            "nomad.broker.wait", "broker.wait", t0,
                            trace.eval_ctx(eval_id),
                            deliveries=self._dequeue_count.get(eval_id, 1))
                    return best
                if deadline is not None:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        return None, ""
                    self._cond.wait(remaining)
                else:
                    self._cond.wait(1.0)

    def _pick_locked(self, schedulers: list[str]
                     ) -> Optional[tuple[Evaluation, str]]:
        best_key = None
        best_queue = None
        for sched in schedulers:
            heap = self._ready.get(sched)
            # stale entries: acked/drained evals (id gone) and shed
            # tombstones (the eval moved to the dead-letter queue but
            # keeps its id registration — match by entry VALUE)
            while heap and (heap[0][2] not in self._evals
                            or heap[0] in self._shed_entries):
                self._shed_entries.discard(heap[0])
                heapq.heappop(heap)
            if not heap:
                continue
            if best_key is None or heap[0] < best_key:
                best_key = heap[0]
                best_queue = sched
        if best_queue is None:
            return None
        _, _, eval_id = heapq.heappop(self._ready[best_queue])
        ev = self._evals.pop(eval_id)
        if best_queue == FAILED_QUEUE:
            self.stats["total_failed"] -= 1
            metrics.set_gauge("nomad.broker.failed_queue_depth",
                              self.stats["total_failed"])
        if ev.job_id and self._ready_jobs.get((ev.namespace, ev.job_id)) == eval_id:
            del self._ready_jobs[(ev.namespace, ev.job_id)]
        self.stats["total_ready"] -= 1
        token = new_id()
        self._unack[eval_id] = {
            "token": token,
            "eval": ev,
            "deadline": time.time() + self.nack_timeout,
        }
        self.stats["total_unacked"] += 1
        self._dequeue_count[eval_id] = self._dequeue_count.get(eval_id, 0) + 1
        if ev.job_id:
            self._outstanding_jobs[(ev.namespace, ev.job_id)] = eval_id
        return ev, token

    def outstanding(self, eval_id: str) -> Optional[str]:
        with self._lock:
            rec = self._unack.get(eval_id)
            return rec["token"] if rec else None

    def outstanding_reset(self, eval_id: str, token: str) -> str:
        """Reset the nack timer (heartbeat from a busy worker)."""
        with self._lock:
            rec = self._unack.get(eval_id)
            if rec is None:
                return "not outstanding"
            if rec["token"] != token:
                return "token mismatch"
            rec["deadline"] = time.time() + self.nack_timeout
            return ""

    # ------------------------------------------------------------ ack/nack

    def ack(self, eval_id: str, token: str) -> None:
        """ref :537"""
        with self._lock:
            rec = self._unack.get(eval_id)
            if rec is None or rec["token"] != token:
                raise ValueError(f"token mismatch for eval {eval_id}")
            del self._unack[eval_id]
            self.stats["total_unacked"] -= 1
            self._dequeue_count.pop(eval_id, None)
            ev = rec["eval"]
            job_key = (ev.namespace, ev.job_id)
            if self._outstanding_jobs.get(job_key) == eval_id:
                del self._outstanding_jobs[job_key]
            # release one pending eval for this job
            pending = self._pending.get(job_key)
            if pending:
                nxt = pending.pop(0)
                if not pending:
                    del self._pending[job_key]
                self.stats["total_pending"] -= 1
                self._enqueue_locked(nxt)
            requeue = rec.get("requeue")
            if requeue is not None:
                self._enqueue_locked(requeue)
            self._notify_inflight()
            self._cond.notify_all()

    def nack(self, eval_id: str, token: str) -> None:
        """Failed delivery: requeue with delay or move to failed queue
        (ref :601)."""
        with self._lock:
            rec = self._unack.get(eval_id)
            if rec is None or rec["token"] != token:
                raise ValueError(f"token mismatch for eval {eval_id}")
            del self._unack[eval_id]
            self.stats["total_unacked"] -= 1
            ev = rec["eval"]
            job_key = (ev.namespace, ev.job_id)
            if self._outstanding_jobs.get(job_key) == eval_id:
                del self._outstanding_jobs[job_key]
            count = self._dequeue_count.get(eval_id, 1)
            if count >= self.delivery_limit:
                # dead-letter: deliver once more via the failed queue
                # (the leader's reaper terminates it and emits the
                # backed-off failed-follow-up, ref leader.go:782)
                self._evals[ev.id] = ev
                if ev.job_id:
                    self._ready_jobs[job_key] = ev.id
                heapq.heappush(self._ready.setdefault(FAILED_QUEUE, []),
                               (-ev.priority, next(self._seq), ev.id))
                self.stats["total_ready"] += 1
                self.stats["total_failed"] += 1
                metrics.incr("nomad.broker.dead_letter")
                metrics.set_gauge("nomad.broker.failed_queue_depth",
                                  self.stats["total_failed"])
            else:
                delay = (self.initial_nack_delay if count == 1
                         else self.subsequent_nack_delay)
                self._delay_push_locked(time.time() + delay, ev)
            self._notify_inflight()
            self._cond.notify_all()

    # ------------------------------------------------------ dead letters

    def failed_evals(self) -> list[Evaluation]:
        """The evals currently parked on the dead-letter queue (operator
        visibility via /v1/operator/broker/failed)."""
        with self._lock:
            heap = self._ready.get(FAILED_QUEUE, [])
            return [self._evals[eid] for _, _, eid in heap
                    if eid in self._evals]

    def drain_failed(self) -> tuple[list[Evaluation], list[Evaluation]]:
        """Operator drain: atomically remove every dead-lettered eval
        AND every not-yet-dispatched failed-follow-up (delay heap or
        ready, not outstanding) from the queue. One lock acquisition
        covers both, so the leader reaper — which converts dead letters
        into delayed follow-ups every tick — cannot interleave: whatever
        form the broken eval currently takes, the drain catches it. The
        caller terminates them in state and RESTORES them via
        enqueue/restore_failed if that commit fails. Pending evals
        blocked behind a drained eval's job are released, like an ack
        would. Returns (dead_letters, follow_ups)."""
        with self._lock:
            heap = self._ready.get(FAILED_QUEUE, [])
            drained = [self._evals.pop(eid) for _, _, eid in heap
                       if eid in self._evals]
            self._ready.pop(FAILED_QUEUE, None)
            self.stats["total_ready"] -= len(drained)
            self.stats["total_failed"] -= len(drained)
            # waiting follow-ups in the delay heap
            follows = []
            keep = []
            for item in self._delay_heap:
                if item[2].triggered_by == TRIGGER_FAILED_FOLLOW_UP:
                    follows.append(item[2])
                    self.stats["total_waiting"] -= 1
                    self._waiting_follow_ups = max(
                        0, self._waiting_follow_ups - 1)
                else:
                    keep.append(item)
            if follows:
                heapq.heapify(keep)
                self._delay_heap = keep
            # ready (undelivered) follow-ups; outstanding ones are left
            # to finish — their result commits through the normal path
            for qname, qheap in self._ready.items():
                for _, _, eid in list(qheap):
                    ev = self._evals.get(eid)
                    if ev is not None and \
                            ev.triggered_by == TRIGGER_FAILED_FOLLOW_UP:
                        follows.append(self._evals.pop(eid))
                        self.stats["total_ready"] -= 1
            removed = drained + follows
            for ev in removed:
                self._dequeue_count.pop(ev.id, None)
                self._enqueued.pop(ev.id, None)
                job_key = (ev.namespace, ev.job_id)
                if self._ready_jobs.get(job_key) == ev.id:
                    del self._ready_jobs[job_key]
                pending = self._pending.get(job_key)
                if pending:
                    nxt = pending.pop(0)
                    if not pending:
                        del self._pending[job_key]
                    self.stats["total_pending"] -= 1
                    self._enqueue_locked(nxt)
            metrics.set_gauge("nomad.broker.failed_queue_depth",
                              self.stats["total_failed"])
            self._cond.notify_all()
            return drained, follows

    def restore_failed(self, evals: list[Evaluation]) -> None:
        """Put drained evals back (the drain's raft commit failed): they
        re-enter the normal queues; their preserved dequeue counts send
        repeat offenders straight back to the dead-letter path."""
        with self._lock:
            for ev in evals:
                self._enqueue_locked(ev)

    # -------------------------------------------------------- delay watcher

    def _run_delayed_watcher(self) -> None:
        """ref :758 runDelayedEvalsWatcher"""
        while True:
            with self._lock:
                if self._shutdown or not self._enabled:
                    return
                now = time.time()
                while self._delay_heap and self._delay_heap[0][0] <= now:
                    _, _, ev = heapq.heappop(self._delay_heap)
                    self.stats["total_waiting"] -= 1
                    if ev.triggered_by == TRIGGER_FAILED_FOLLOW_UP:
                        # graduating from backoff: it becomes real
                        # offered load again (counts toward the cap)
                        self._waiting_follow_ups = max(
                            0, self._waiting_follow_ups - 1)
                    ev = ev.copy()
                    ev.wait_sec = 0.0
                    ev.wait_until_unix = 0.0
                    self._enqueue_locked(ev)
                wait = 0.2
                if self._delay_heap:
                    wait = min(wait, max(0.01, self._delay_heap[0][0] - now))
                self._cond.wait(wait)

    def check_nack_timeouts(self) -> list[str]:
        """Requeue unacked evals past their deadline; returns timed-out ids.
        Called by the leader loop tick."""
        out = []
        with self._lock:
            now = time.time()
            for eval_id, rec in list(self._unack.items()):
                if rec["deadline"] <= now:
                    out.append(eval_id)
                    try:
                        self.nack(eval_id, rec["token"])
                    except ValueError:
                        pass
        return out
