"""Retry discipline for the RPC plane (ISSUE 18 tentpole).

The reference client survives hostile networks with a retry/failover
ladder (client/rpc.go canRetry + RPCHoldTimeout backoff, helper/pool
breaker-ish rebalancing); before this module our `RpcClient` walked the
failover list exactly once with no backoff and no budget, so one lossy
link turned into an immediate caller-visible error and one slow link ate
an unbounded socket timeout.

Two pieces, both deterministic under test:

  * `RetryPolicy` — bounded retry ROUNDS over the failover list with
    exponential backoff and SEEDED jitter, sleeping on the injectable
    `chrono.Clock` (never `time.sleep`), so a ManualClock partition sim
    replays the exact same retry schedule every run (nomadlint RPC001
    patrols for ad-hoc retry loops that bypass this).
  * `RpcBreaker` — a per-server-address short-circuit breaker reusing
    the solver ladder's breaker shape (solver/backend.py TierBreaker:
    closed -> open after `threshold` failures inside `window_s` ->
    half-open single probe after `cooldown_s` -> closed on success).
    A tripped address is skipped during failover walks so a dead server
    costs its cooldown once, not one connect-timeout per call. The
    AVAILABILITY FLOOR: if every candidate is open, the walk still
    attempts one server — a breaker must degrade failover, never turn
    "all servers flaky" into "no servers tried".

Deadline propagation rides next door in client.py: the envelope carries
an absolute `deadline` (the caller's clock), every hop's socket timeout
is the REMAINING budget, and rpc/server.py sheds requests whose deadline
already passed (docs/PARTITIONS.md has the full contract table).
"""
from __future__ import annotations

import random
import threading
from typing import Optional

from .. import chrono
from ..metrics import metrics

# breaker knobs — module-level so tests/operators can tune without
# plumbing constructor args through every call site (read at call time,
# the TierBreaker convention)
BREAKER_THRESHOLD = 3          # failures inside the window that trip open
BREAKER_WINDOW_S = 30.0        # sliding failure-counting window
BREAKER_COOLDOWN_S = 5.0       # open -> half-open probe delay


class RetryPolicy:
    """Bounded attempts + exponential backoff with seeded jitter.

    One "attempt" is a full failover-walk round over the candidate
    server list; between rounds the caller sleeps `backoff_s(round)` on
    the policy's clock. `max_attempts=1` reproduces the legacy
    walk-once behavior exactly (the default for framework-internal
    clients: raft replication and leader forwarding carry their own
    retry discipline, and nesting two ladders multiplies tail latency).
    """

    def __init__(self, max_attempts: int = 1, base_s: float = 0.1,
                 multiplier: float = 2.0, max_backoff_s: float = 2.0,
                 seed: int = 0, clock: Optional[chrono.Clock] = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_s = float(base_s)
        self.multiplier = float(multiplier)
        self.max_backoff_s = float(max_backoff_s)
        self.seed = seed
        self.clock = clock or chrono.REAL
        # seeded per-policy jitter stream: the retry schedule is a pure
        # function of (seed, retry ordinal) — partition sims replay it
        self._rng = random.Random(f"rpc-retry:{seed}")
        self._lock = threading.Lock()

    def backoff_s(self, round_idx: int) -> float:
        """Backoff before retry round `round_idx` (0 = first retry):
        min(cap, base * multiplier**round) scaled by a seeded jitter
        factor in [0.5, 1.0) — decorrelates fleets without ever
        collapsing the wait to zero."""
        raw = min(self.max_backoff_s,
                  self.base_s * (self.multiplier ** round_idx))
        with self._lock:
            j = 0.5 + 0.5 * self._rng.random()
        return raw * j

    def shuffle_tail(self, items: list) -> None:
        """Seeded in-place shuffle for the failover tail — the walk
        order is reproducible under a fixed seed (DET001 spirit: no
        process-global RNG on a decision path)."""
        with self._lock:
            self._rng.shuffle(items)


class RpcBreaker:
    """Per-server-address circuit breaker (the TierBreaker shape applied
    to transport targets). Thread-safe; all deadline math reads the
    injectable clock so ManualClock tests step through
    open -> half-open -> closed without sleeping."""

    def __init__(self, clock: Optional[chrono.Clock] = None):
        self.clock = clock or chrono.REAL
        self._lock = threading.Lock()
        # addr -> {"failures": [t, ...], "open_until": t|None, "probing": bool}
        self._addrs: dict[str, dict] = {}

    def _entry(self, addr: str) -> dict:
        e = self._addrs.get(addr)
        if e is None:
            e = self._addrs[addr] = {"failures": [], "open_until": None,
                                     "probing": False}
        return e

    def admit(self, addr: str) -> bool:
        """May a call go to `addr` now? Open => False until the cooldown
        elapses, then exactly ONE caller gets the half-open probe slot
        (others keep getting False until the probe resolves via
        record_success / record_failure)."""
        now = self.clock.monotonic()
        with self._lock:
            e = self._addrs.get(addr)
            if e is None or e["open_until"] is None:
                return True
            if now < e["open_until"]:
                return False
            if e["probing"]:
                return False            # a probe is already in flight
            e["probing"] = True
            metrics.incr("nomad.rpc.breaker_probe")
            return True

    def record_success(self, addr: str) -> None:
        with self._lock:
            e = self._addrs.get(addr)
            if e is None:
                return
            if e["open_until"] is not None:
                metrics.incr("nomad.rpc.breaker_closed")
            e["failures"].clear()
            e["open_until"] = None
            e["probing"] = False

    def record_failure(self, addr: str) -> None:
        now = self.clock.monotonic()
        with self._lock:
            e = self._entry(addr)
            if e["probing"]:
                # failed half-open probe: re-open for a fresh cooldown
                e["probing"] = False
                e["open_until"] = now + BREAKER_COOLDOWN_S
                e["failures"] = [now]
                metrics.incr("nomad.rpc.breaker_open")
                return
            window = [t for t in e["failures"] if t > now - BREAKER_WINDOW_S]
            window.append(now)
            e["failures"] = window
            if e["open_until"] is None and len(window) >= BREAKER_THRESHOLD:
                e["open_until"] = now + BREAKER_COOLDOWN_S
                metrics.incr("nomad.rpc.breaker_open")

    def state(self, addr: str) -> str:
        now = self.clock.monotonic()
        with self._lock:
            e = self._addrs.get(addr)
            if e is None or e["open_until"] is None:
                return "closed"
            if e["probing"]:
                return "half-open"
            return "open" if now < e["open_until"] else "half-open"

    def snapshot(self) -> dict:
        """Operator view for the /v1/operator/debug `Rpc` block: one row
        per ever-failed address."""
        now = self.clock.monotonic()
        with self._lock:
            out = {}
            for addr, e in self._addrs.items():
                out[addr] = {
                    "State": ("closed" if e["open_until"] is None else
                              "half-open" if (e["probing"] or
                                              now >= e["open_until"])
                              else "open"),
                    "RecentFailures": len(
                        [t for t in e["failures"]
                         if t > now - BREAKER_WINDOW_S]),
                    "OpenForS": (round(max(0.0, e["open_until"] - now), 3)
                                 if e["open_until"] is not None else 0.0),
                }
            return out

    def reset(self, addr: Optional[str] = None) -> None:
        with self._lock:
            if addr is None:
                self._addrs.clear()
            else:
                self._addrs.pop(addr, None)
