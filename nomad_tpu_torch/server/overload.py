"""Overload protection: ingress admission control + pressure-driven
brownout (ISSUE 8 tentpole).

The solve path is CvxCluster-fast, so under burst traffic the control
plane's QUEUES are the failure mode, not the solver: an unbounded eval
backlog grows memory without bound and spends device time on evals whose
callers gave up long ago. This module is the leader's shared overload
brain; the eval broker's depth cap / priority shed and the worker's
deadline drop (eval_broker.py, worker.py) consume its knobs, and its
pressure state drives the brownout levers.

Three layers, goodput over throughput (docs/OVERLOAD.md):

  * **Admission** — per-endpoint-class token buckets (`write` / `read` /
    `blocking`) at the HTTP and RPC front doors. Over-rate callers get
    429 + Retry-After (HTTP) or a `RateLimitError` envelope (RPC)
    *before* any state is touched; the Python client honors Retry-After
    with jittered backoff (api/client.py). Rates are hot-reloadable
    `SchedulerConfiguration` fields; 0 (the default) disables a class.

  * **Pressure** — broker backlog + plan-queue depth fold into one
    ok -> saturated -> shedding state, exported via /v1/status and
    `nomad.pressure.state` (0/1/2). Transitions are counted
    (`nomad.pressure.transitions`), so the bench can assert a burst
    entered and LEFT the shedding state (recovery, not collapse).

  * **Brownout** — under pressure the micro-batcher's coalescing window
    WIDENS (amortize dispatch: more lanes per device round trip), trace
    head-sampling downshifts (error retention unaffected — trace.py),
    and blocking queries get shortened hold timeouts so parked
    connections return capacity. All three revert on recovery.

The controller is per-Server (pressure is leader-scoped state) but its
brownout levers hit the process-wide singletons (solver/microbatch.py,
obs/trace.py) — only a LEADER's controller ticks, and `reset()` on
revoke restores every lever, so a demoted server cannot keep a stale
brownout pinned.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..metrics import metrics

# pressure states, in escalation order
PRESSURE_OK = "ok"
PRESSURE_SATURATED = "saturated"
PRESSURE_SHEDDING = "shedding"
_PRESSURE_LEVEL = {PRESSURE_OK: 0, PRESSURE_SATURATED: 1,
                   PRESSURE_SHEDDING: 2}

# endpoint classes the admission buckets key on
CLASS_WRITE = "write"
CLASS_READ = "read"
CLASS_BLOCKING = "blocking"

# brownout levers (constants, not knobs: the operator tunes WHEN pressure
# engages via SchedulerConfiguration; what brownout does is a contract)
WINDOW_BOOST_SATURATED = 2.0     # micro-batch window multiplier
WINDOW_BOOST_SHEDDING = 4.0
TRACE_FACTOR_SATURATED = 0.5     # head-sampling multiplier (errors kept)
TRACE_FACTOR_SHEDDING = 0.1
BLOCKING_CAP_OK_S = 30.0         # blocking-query hold ceiling per state
BLOCKING_CAP_SATURATED_S = 5.0
BLOCKING_CAP_SHEDDING_S = 1.0

# hysteresis: saturation engages at `pressure_saturated_frac` of the
# broker cap and releases below half of that, so a backlog hovering at
# the threshold doesn't flap the brownout levers every tick
_RELEASE_FRAC = 0.5


class RateLimitExceeded(Exception):
    """An ingress admission bucket rejected the request. `retry_after_s`
    is the earliest time a retry can succeed (the HTTP layer surfaces it
    as a Retry-After header, the RPC layer in the error envelope)."""

    def __init__(self, endpoint_class: str, retry_after_s: float):
        super().__init__(
            f"rate limit exceeded for {endpoint_class} requests; "
            f"retry after {retry_after_s:.2f}s")
        self.endpoint_class = endpoint_class
        self.retry_after_s = retry_after_s


class TokenBucket:
    """Classic token bucket: `rate` tokens/s, capacity `rate * burst_s`.
    Thread-safe; `rate <= 0` admits everything (the disabled default)."""

    def __init__(self, rate: float = 0.0, burst_s: float = 2.0):
        self._lock = threading.Lock()
        self._rate = 0.0
        self._capacity = 0.0
        self._tokens = 0.0
        self._t_last = time.monotonic()
        self.configure(rate, burst_s)

    def configure(self, rate: float, burst_s: float = 2.0) -> None:
        """Hot-reload. A rate change refills to the new capacity rather
        than carrying debt across a reconfigure — an operator RAISING the
        limit mid-incident expects immediate relief."""
        rate = max(0.0, float(rate))
        burst_s = max(0.1, float(burst_s))
        with self._lock:
            if rate != self._rate or rate * burst_s != self._capacity:
                self._rate = rate
                self._capacity = rate * burst_s
                self._tokens = self._capacity
                self._t_last = time.monotonic()

    @property
    def rate(self) -> float:
        return self._rate

    def take(self, n: float = 1.0) -> float:
        """Take `n` tokens. Returns 0.0 when admitted, else the seconds
        until `n` tokens will be available (the Retry-After hint)."""
        with self._lock:
            if self._rate <= 0.0:
                return 0.0
            now = time.monotonic()
            self._tokens = min(self._capacity,
                               self._tokens + (now - self._t_last)
                               * self._rate)
            self._t_last = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return max(0.001, (n - self._tokens) / self._rate)


class OverloadController:
    """One per server. `broker_depth_fn` / `plan_depth_fn` report the
    live queue backlogs; `config_fn` returns the current (raft-
    replicated, hot-reloadable) SchedulerConfiguration. The bench wires
    its own callables — no Server required."""

    def __init__(self, broker_depth_fn: Callable[[], int] = None,
                 plan_depth_fn: Callable[[], int] = None,
                 config_fn: Callable[[], object] = None):
        self._broker_depth_fn = broker_depth_fn or (lambda: 0)
        self._plan_depth_fn = plan_depth_fn or (lambda: 0)
        self._config_fn = config_fn or (lambda: None)
        self._lock = threading.Lock()
        self._state = PRESSURE_OK
        self.transitions = 0
        self.max_broker_depth = 0
        self._buckets = {CLASS_WRITE: TokenBucket(),
                         CLASS_READ: TokenBucket(),
                         CLASS_BLOCKING: TokenBucket()}

    # ------------------------------------------------------------ admission

    def _cfg(self, name: str, default):
        cfg = self._config_fn()
        try:
            value = getattr(cfg, name, default)
            return type(default)(value)
        except (TypeError, ValueError):
            return default

    def admit(self, endpoint_class: str) -> None:
        """Raise RateLimitExceeded when the class bucket is dry. Buckets
        re-read the hot-reloadable rates on every call (attribute reads
        on the in-memory config; configure() is a no-op when unchanged)."""
        bucket = self._buckets.get(endpoint_class)
        if bucket is None:
            return
        burst = self._cfg("ingress_burst_s", 2.0)
        bucket.configure(
            self._cfg(f"ingress_{endpoint_class}_rate", 0.0), burst)
        wait = bucket.take()
        if wait > 0.0:
            metrics.incr("nomad.ingress.rejected")
            # the three literal endpoint classes (write/read/blocking)
            # nomadlint: disable=OBS001 — bounded per-class breakdown
            metrics.incr(f"nomad.ingress.rejected.{endpoint_class}")
            raise RateLimitExceeded(endpoint_class, wait)

    @staticmethod
    def classify_http(method: str, query: dict) -> str:
        """Endpoint class of an HTTP request: blocking queries are GETs
        carrying a NONZERO ?index= (the handler's blocking() only parks
        then — `?index=0` is a plain read and must bill the read
        bucket); other GETs read; everything else writes (PUT/POST/
        DELETE all reach the raft log)."""
        if method == "GET":
            try:
                if int(query.get("index", 0) or 0) > 0:
                    return CLASS_BLOCKING
            except (TypeError, ValueError):
                pass
            return CLASS_READ
        return CLASS_WRITE

    # ------------------------------------------------------------- pressure

    def tick(self) -> str:
        """Recompute pressure from the live depths and apply/release the
        brownout levers. Called from the leader housekeeping loop (1s
        cadence) and via the broker's `on_overflow` hook whenever the
        depth cap trips (so a burst faster than the tick still engages
        brownout). Returns the current state."""
        broker_depth = int(self._broker_depth_fn())
        plan_depth = int(self._plan_depth_fn())
        cap = self._cfg("broker_depth_cap", 0)
        state = PRESSURE_OK
        if cap > 0:
            depth = broker_depth + plan_depth
            sat = max(1.0, cap * self._cfg("pressure_saturated_frac", 0.5))
            with self._lock:
                prev = self._state
            if depth >= cap:
                state = PRESSURE_SHEDDING
            elif depth >= sat:
                state = PRESSURE_SATURATED
            elif prev != PRESSURE_OK and depth >= sat * _RELEASE_FRAC:
                # hysteresis: stay one level engaged until well clear
                state = PRESSURE_SATURATED
        with self._lock:
            if broker_depth > self.max_broker_depth:
                self.max_broker_depth = broker_depth
            changed = state != self._state
            self._state = state
            if changed:
                self.transitions += 1
        metrics.set_gauge("nomad.pressure.state", _PRESSURE_LEVEL[state])
        metrics.set_gauge("nomad.broker.depth", broker_depth)
        if changed:
            metrics.incr("nomad.pressure.transitions")
            self._apply_brownout(state)
        return state

    def state(self) -> str:
        with self._lock:
            return self._state

    def _apply_brownout(self, state: str) -> None:
        """Point the process-wide levers at the new state. Lazy imports:
        a stripped solver-less build skips the micro-batcher lever."""
        from ..obs import trace
        if state == PRESSURE_SHEDDING:
            boost, factor = WINDOW_BOOST_SHEDDING, TRACE_FACTOR_SHEDDING
        elif state == PRESSURE_SATURATED:
            boost, factor = WINDOW_BOOST_SATURATED, TRACE_FACTOR_SATURATED
        else:
            boost, factor = 1.0, 1.0
        trace.set_pressure_factor(factor)
        try:
            from ..solver import microbatch
            microbatch.set_pressure_boost(boost)
        except ImportError:
            pass

    def blocking_cap_s(self) -> float:
        """The blocking-query hold ceiling for the CURRENT pressure state
        (agent/http.py clamps ?wait= with this): parked long-polls are
        the cheapest capacity to reclaim under load."""
        state = self.state()
        if state == PRESSURE_SHEDDING:
            return BLOCKING_CAP_SHEDDING_S
        if state == PRESSURE_SATURATED:
            return BLOCKING_CAP_SATURATED_S
        return BLOCKING_CAP_OK_S

    def reset(self) -> None:
        """Back to follower shape: levers released, state ok. Counters
        are kept — transitions/max-depth are evidence, not state."""
        with self._lock:
            changed = self._state != PRESSURE_OK
            self._state = PRESSURE_OK
        if changed:
            self._apply_brownout(PRESSURE_OK)
        metrics.set_gauge("nomad.pressure.state", 0)

    # -------------------------------------------------------------- surface

    def snapshot(self) -> dict:
        """The /v1/status pressure block."""
        with self._lock:
            state = self._state
            transitions = self.transitions
            max_depth = self.max_broker_depth
        return {
            "State": state,
            "BrokerDepth": int(self._broker_depth_fn()),
            "PlanQueueDepth": int(self._plan_depth_fn()),
            "BrokerDepthCap": self._cfg("broker_depth_cap", 0),
            "MaxBrokerDepth": max_depth,
            "Transitions": transitions,
            "BlockingCapS": self.blocking_cap_s(),
            "Limits": {c: self._cfg(f"ingress_{c}_rate", 0.0)
                       for c in (CLASS_WRITE, CLASS_READ, CLASS_BLOCKING)},
        }
