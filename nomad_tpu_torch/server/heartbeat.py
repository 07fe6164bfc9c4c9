"""Server-side node heartbeat TTLs (ref nomad/heartbeat.go:34-199).

Each client heartbeat resets its TTL timer; a missed TTL marks the node
down and creates one evaluation per job with allocations on it
(ref nomad/node_endpoint.go:1358 createNodeEvals) so the schedulers replace
the lost work — tier 2 of the failure-detection story (SURVEY.md §5).

Mass-failure semantics (ISSUE 10, docs/NODE_FAILURE.md): a sweep
collects EVERY expired node and commits the whole set as ONE
`BATCH_NODE_UPDATE_STATUS` raft entry, with the replacement evals
deduped to one per (namespace, job) ACROSS the batch — a rack loss that
downs K nodes costs ceil(K / rate-cap) raft rounds plus one eval per
affected job instead of K applies and K×jobs evals. The per-sweep rate
cap (`heartbeat_invalidate_rate_cap`) paces a 10k-node partition over a
few sweeps (carry-over: uninvalidated nodes keep their expired
deadlines and lead the next sweep) so a single sweep can never turn a
partition into a raft megaflood. `heartbeat.sweep` is a fault site; a
failed batch re-arms every member with a short backoff (CAS against
mid-flight heartbeats) exactly like the single-node path always did.

Failover semantics (ISSUE 6 satellite): a freshly-elected leader calls
`initialize_heartbeat_timers(grace=...)` as a recovery-barrier step —
every live node in replicated state gets a FRESH deadline of
ttl + grace. That fixes two failure shapes at once:

  * a server that loses and later REGAINS leadership still holds the
    deadlines of its previous reign; without re-arming, its first sweep
    would instantly mark every node down (their TTLs "expired" while it
    was a follower, though the nodes were heartbeating the interim
    leader perfectly well) and flood the cluster with replacement evals;
  * a node whose heartbeat was in flight to the OLD leader during the
    election gets the grace window to find the new leader before its
    work is rescheduled — while a node that truly died during failover
    IS detected once ttl + grace elapses (a new leader that never
    initialized timers would wait forever).

All deadline arithmetic reads an injectable chrono.Clock and the TTL
jitter draws from a seeded per-instance RNG (DET001 — nomadlint scopes
the rule onto this file), so storm/grace behavior is unit-tested with a
ManualClock and replays bit-identically instead of sleep-and-hope.
"""
from __future__ import annotations

import random
import threading
from typing import Optional

from .. import chrono, faults
from ..metrics import metrics, record_swallowed_error
from ..structs import (
    Evaluation, NODE_STATUS_DOWN, TRIGGER_NODE_UPDATE, JOB_TYPE_SYSTEM,
)
from .fsm import BATCH_NODE_UPDATE_STATUS
from .lifecycle import LoopHandle

DEFAULT_MIN_TTL = 10.0
DEFAULT_TTL_SPREAD = 5.0
DEFAULT_CHECK_INTERVAL = 1.0
# a failed invalidate re-arms the node's deadline this far out, so the
# next sweep retries instead of forgetting the node forever (ISSUE 3)
INVALIDATE_RETRY_BACKOFF_S = 2.0
# post-election grace added on top of the TTL when the new leader
# re-arms node timers (ref nomad/heartbeat.go initializeHeartbeatTimers,
# which grants max(ttl, failover grace)); covers the election window plus
# one client retry round
DEFAULT_FAILOVER_GRACE_S = 10.0


class HeartbeatTimers:
    def __init__(self, server, min_ttl: float = DEFAULT_MIN_TTL,
                 ttl_spread: float = DEFAULT_TTL_SPREAD,
                 failover_grace: float = DEFAULT_FAILOVER_GRACE_S,
                 clock: Optional[chrono.Clock] = None,
                 seed: Optional[int] = None):
        self.server = server
        self.min_ttl = min_ttl
        self.ttl_spread = ttl_spread
        self.failover_grace = failover_grace
        self.clock = clock or chrono.REAL
        # seeded per-instance jitter stream (DET001): the spread only
        # needs to decorrelate node deadlines, not be unpredictable, so
        # a fixed default seed keeps storm tests' expiry order a
        # constant of (arrival order, seed) instead of a statistic
        self._rng = random.Random(0x6e6f6d61 if seed is None else seed)
        self._lock = threading.Lock()
        self._deadlines: dict[str, float] = {}
        # explicit start/join lifecycle state (server/lifecycle.py): the
        # recovery barrier start()s the reaper on the election-callback
        # thread while shutdown/revoke stop() it from another — the old
        # bare-Thread pattern could join a not-yet-started thread, and a
        # racing restart could clear the stop event out from under a
        # mid-join stop(). The handle owns both the event and the thread.
        self._loop = LoopHandle()
        self._stop = self._loop.stop_event

    def start(self) -> None:
        self._loop.start(self._run, "heartbeat-reaper")

    def stop(self) -> None:
        self._loop.stop(timeout=5.0)

    def _ttl(self) -> float:
        return self.min_ttl + self._rng.random() * self.ttl_spread

    def reset_heartbeat_timer(self, node_id: str) -> float:
        """Returns the TTL the client should heartbeat within
        (ref heartbeat.go:56 resetHeartbeatTimer)."""
        ttl = self._ttl()
        with self._lock:
            self._deadlines[node_id] = self.clock.time() + ttl
        return ttl

    def clear_heartbeat_timer(self, node_id: str) -> None:
        with self._lock:
            self._deadlines.pop(node_id, None)

    def initialize_heartbeat_timers(self, grace: Optional[float] = None
                                    ) -> int:
        """Recovery-barrier step (ref heartbeat.go:40
        initializeHeartbeatTimers): re-arm EVERY live node's TTL at
        ttl + grace, replacing whatever deadlines survived a previous
        reign. Returns the number of nodes armed. Leader-only by
        construction (only _establish_leadership calls it)."""
        faults.fire("heartbeat.initialize")
        grace = self.failover_grace if grace is None else grace
        now = self.clock.time()
        armed = 0
        with self._lock:
            self._deadlines.clear()
            for node in self.server.state.iter_nodes():
                if node.terminal_status():
                    continue
                self._deadlines[node.id] = now + self._ttl() + grace
                armed += 1
        return armed

    def _run(self) -> None:
        while not self._stop.is_set():
            self._sweep(self.clock.time())
            self._stop.wait(DEFAULT_CHECK_INTERVAL)

    def _rate_cap(self) -> int:
        """Per-sweep invalidation cap from the live scheduler config
        (hot-reloadable); 0 = uncapped."""
        try:
            cfg = self.server.state.get_scheduler_config()
            return max(0, int(getattr(cfg, "heartbeat_invalidate_rate_cap",
                                      0)))
        except (AttributeError, TypeError, ValueError):
            return 0

    def _sweep(self, now: float) -> None:
        """One reaper pass over ALL expired nodes, committed as a single
        batch (rate-capped; the overflow carries over — expired
        deadlines stay put and, being the oldest, lead the next sweep).
        Deadlines are deleted only AFTER a successful invalidate: the
        pre-ISSUE-3 order (delete, then invalidate) meant a transient
        raft error left a node untracked and "ready" forever. On
        failure every batch member re-arms with a short backoff so the
        next sweep retries — unless a heartbeat landed mid-invalidate
        (deadline moved), in which case the node is alive again and the
        newer deadline wins (per-node CAS)."""
        with self._lock:
            expired = sorted(
                (deadline, node_id)
                for node_id, deadline in self._deadlines.items()
                if deadline <= now)
        if not expired:
            return
        cap = self._rate_cap()
        if cap > 0 and len(expired) > cap:
            metrics.incr("nomad.heartbeat.sweep_carryover",
                         len(expired) - cap)
            expired = expired[:cap]
        observed = {node_id: deadline for deadline, node_id in expired}
        try:
            self._invalidate_batch(list(observed))
        except Exception as e:   # noqa: BLE001
            record_swallowed_error("heartbeat.invalidate", e,
                                   self.server.logger)
            with self._lock:
                retry_at = self.clock.time() + INVALIDATE_RETRY_BACKOFF_S
                for node_id, obs in observed.items():
                    if self._deadlines.get(node_id) == obs:
                        self._deadlines[node_id] = retry_at
        else:
            with self._lock:
                for node_id, obs in observed.items():
                    if self._deadlines.get(node_id) == obs:
                        del self._deadlines[node_id]

    def _invalidate(self, node_id: str) -> None:
        """Single-node invalidate (ref heartbeat.go:135
        invalidateHeartbeat) — the batch path with one member."""
        self._invalidate_batch([node_id])

    def _invalidate_batch(self, node_ids: list[str]) -> int:
        """Missed TTLs => ONE down-batch raft entry carrying BOTH the
        status flips AND the deduped replacement evals (ISSUE 10; ref
        heartbeat.go:135 invalidateHeartbeat per node). One entry means
        atomicity by construction: a crash or leadership loss can never
        commit the flips and strand the down nodes eval-less — the eval
        set is computed from pre-flip state (status is not an input to
        it; only node_modify_index differs, by one bump) and applied by
        the FSM in the same index, the JOB_REGISTER shape. Returns the
        number of nodes actually flipped."""
        faults.fire("heartbeat.sweep")
        faults.fire("heartbeat.invalidate")
        server = self.server
        live = []
        for node_id in node_ids:
            node = server.state.node_by_id(node_id)
            if node is None or node.terminal_status():
                continue
            live.append(node_id)
        if not live:
            return 0
        metrics.incr("nomad.heartbeat.invalidate", len(live))
        metrics.incr("nomad.heartbeat.invalidate_batches")
        server.raft.apply(BATCH_NODE_UPDATE_STATUS, {
            "node_ids": live, "status": NODE_STATUS_DOWN,
            "updated_at": self.clock.time(),
            "evals": create_node_evals_batch(server.state, live)})
        damper = getattr(server, "flap_damper", None)
        if damper is not None:
            damper.record_down_batch(live, self.clock.time())
        return len(live)


def create_node_evals(state, node_id: str) -> list[Evaluation]:
    """One eval per job with allocs on the node (+ system jobs)
    (ref nomad/node_endpoint.go:1358)."""
    return create_node_evals_batch(state, [node_id])


def create_node_evals_batch(state, node_ids: list[str]) -> list[Evaluation]:
    """Replacement evals for a whole down-batch, deduped to ONE eval per
    (namespace, job) across ALL the batch's nodes — the scheduler
    re-reads the full alloc set per eval anyway, so per-(job, node)
    evals during a rack loss were pure eval-flood (ISSUE 10). System
    jobs get their one eval per batch too. Priority/type inherit from
    the job (ref node_endpoint.go:1358 createNodeEvals).

    Per-job failures are isolated: one job whose eval construction
    raises loses its replacement eval (counted + logged) instead of
    failing the whole batch — an exception here would re-arm and retry
    the ENTIRE sweep batch forever, starving invalidation of every
    other expired node behind one poison job."""
    evals: list[Evaluation] = []
    seen: set[tuple[str, str]] = set()
    first_node = node_ids[0] if node_ids else ""
    first = state.node_by_id(first_node) if first_node else None
    first_index = first.modify_index if first else 0
    for node_id in node_ids:
        node = state.node_by_id(node_id)
        node_index = node.modify_index if node else 0
        for alloc in state.allocs_by_node(node_id):
            key = (alloc.namespace, alloc.job_id)
            if key in seen:
                continue
            seen.add(key)
            try:
                job = state.job_by_id(*key)
                evals.append(Evaluation(
                    namespace=alloc.namespace,
                    priority=job.priority if job else 50,
                    type=job.type if job else "service",
                    triggered_by=TRIGGER_NODE_UPDATE,
                    job_id=alloc.job_id,
                    node_id=node_id,
                    node_modify_index=node_index,
                    status="pending",
                ))
            except Exception as e:   # noqa: BLE001
                metrics.incr("nomad.heartbeat.node_eval_errors")
                record_swallowed_error("heartbeat.node_evals", e)
    # system jobs need an eval on node up/down even without allocs —
    # once per BATCH (the system scheduler reconciles every node)
    for job in state.iter_jobs():
        if job.type != JOB_TYPE_SYSTEM or job.stopped():
            continue
        key = (job.namespace, job.id)
        if key in seen:
            continue
        seen.add(key)
        evals.append(Evaluation(
            namespace=job.namespace, priority=job.priority, type=job.type,
            triggered_by=TRIGGER_NODE_UPDATE, job_id=job.id,
            node_id=first_node, node_modify_index=first_index,
            status="pending"))
    return evals


class FlapDamper:
    """Node flap damping (ISSUE 10 layer 3, docs/NODE_FAILURE.md).

    A node that cycles down/up repeatedly (reconnect churn, a sick NIC,
    an agent crash-looping under its supervisor) would otherwise
    oscillate the solver's eligibility mask and re-trigger replacement
    evals on every cycle. The damper counts up-transitions per node
    inside a sliding window; at the threshold the node is HELD
    ineligible (`NODE_UPDATE_ELIGIBILITY` with `flap_until` riding the
    raft entry, so a new leader inherits the hold) and re-admitted by
    the leader loop once the hold expires, with the hold doubling per
    subsequent flap episode up to a cap. Zero threshold disables.

    All decisions read the injectable clock; the damper itself is
    leader-local bookkeeping — `adopt()` rebuilds the hold set from
    replicated state at establish, `reset()` clears it at revoke.
    """

    def __init__(self, server, clock: Optional[chrono.Clock] = None):
        self.server = server
        self._clock = clock
        self._lock = threading.Lock()
        self._ups: dict[str, list[float]] = {}      # node -> up times
        self._gen: dict[str, int] = {}              # node -> hold episode
        self._held: dict[str, float] = {}           # node -> hold deadline
        # node -> last counted up edge: the episode generation (and its
        # doubled backoff) persists until a FULL quiet window passes —
        # `_ups` alone can't tell "re-flapped right after re-admission"
        # (cleared at hold time) from "was quiet for an hour"
        self._last: dict[str, float] = {}

    @property
    def clock(self) -> chrono.Clock:
        """Explicitly-injected clock, else the LIVE heartbeat clock —
        resolved dynamically, so `s.heartbeats.clock = ManualClock()`
        after construction moves the damper too. The two must agree:
        window math mixing manual heartbeat time with wall time makes
        hold decisions nondeterministic."""
        if self._clock is not None:
            return self._clock
        hb = getattr(self.server, "heartbeats", None)
        return hb.clock if hb is not None else chrono.REAL

    @clock.setter
    def clock(self, clock: chrono.Clock) -> None:
        self._clock = clock

    def _knobs(self) -> tuple[int, float, float, float]:
        try:
            cfg = self.server.state.get_scheduler_config()
            return (max(0, int(getattr(cfg, "flap_damping_threshold", 0))),
                    float(getattr(cfg, "flap_damping_window_s", 300.0)),
                    float(getattr(cfg, "flap_damping_backoff_s", 30.0)),
                    float(getattr(cfg, "flap_damping_backoff_max_s", 900.0)))
        except (AttributeError, TypeError, ValueError):
            return 0, 300.0, 30.0, 900.0

    def record_down(self, node_id: str, now: Optional[float] = None) -> None:
        """A down transition opens a potential cycle; nothing to decide
        yet — cycles are counted at the UP edge."""
        now = self.clock.time() if now is None else now
        self.record_down_batch([node_id], now)

    def record_down_batch(self, node_ids: list[str], now: float) -> None:
        """A whole down-batch's transitions in one pass — knobs read
        once, lock taken once (a rate-cap-sized sweep must not pay K
        store-lock round-trips mid-storm). Down edges carry no
        decision, but pruning here keeps the tracking maps from
        accumulating one entry per ever-failed node."""
        threshold, window, _, _ = self._knobs()
        if threshold <= 0:
            return
        with self._lock:
            for node_id in node_ids:
                ups = self._ups.get(node_id)
                if ups is not None:
                    ups[:] = [t for t in ups if t > now - window]
                    if not ups:
                        del self._ups[node_id]
                if node_id not in self._held and \
                        node_id not in self._ups and \
                        now - self._last.get(node_id, now) > window:
                    self._gen.pop(node_id, None)
                    self._last.pop(node_id, None)

    def record_up(self, node_id: str,
                  now: Optional[float] = None) -> Optional[float]:
        """A down->up transition. Returns the hold deadline when this
        cycle crossed the flap threshold (the caller applies the
        eligibility hold through raft), else None."""
        threshold, window, backoff, backoff_max = self._knobs()
        if threshold <= 0:
            return None
        now = self.clock.time() if now is None else now
        with self._lock:
            ups = [t for t in self._ups.get(node_id, ()) if t > now - window]
            if not ups and node_id not in self._held and \
                    now - self._last.get(node_id, float("-inf")) > window:
                # a FULL quiet window ends the episode: the next hold
                # starts back at the base backoff. Re-flapping right
                # after re-admission keeps the doubled hold.
                self._gen.pop(node_id, None)
            self._last[node_id] = now
            ups.append(now)
            self._ups[node_id] = ups
            if len(ups) < threshold:
                return None
            gen = self._gen.get(node_id, 0)
            hold = min(backoff * (2 ** gen), backoff_max)
            self._gen[node_id] = gen + 1
            self._ups[node_id] = []
            deadline = now + hold
            self._held[node_id] = deadline
            metrics.incr("nomad.heartbeat.flap_held")
            return deadline

    def due(self, now: Optional[float] = None) -> list[str]:
        """Held nodes whose hold expired — the leader loop re-admits
        them (eligibility back to eligible, flap_until cleared)."""
        now = self.clock.time() if now is None else now
        with self._lock:
            return sorted(n for n, dl in self._held.items() if dl <= now)

    def release(self, node_id: str) -> None:
        """The hold was lifted (re-admit committed, or an operator
        eligibility write superseded it)."""
        with self._lock:
            self._held.pop(node_id, None)

    def held(self, node_id: str) -> bool:
        with self._lock:
            return node_id in self._held

    def adopt(self, state) -> int:
        """Leadership-establish step: rebuild the hold set from
        replicated node state so holds a deposed leader placed still
        re-admit on schedule. Returns the number of adopted holds."""
        with self._lock:
            self._held.clear()
            for node in state.iter_nodes():
                dl = getattr(node, "flap_held_until", 0.0)
                if dl and dl > 0.0:
                    self._held[node.id] = dl
            return len(self._held)

    def reset(self) -> None:
        """Revoke: a follower must never re-admit anything."""
        with self._lock:
            self._ups.clear()
            self._gen.clear()
            self._held.clear()
            self._last.clear()
