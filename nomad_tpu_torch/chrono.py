"""Controllable time source (ISSUE 6).

The multi-server raft/operator tests were sleep-and-hope: election
deadlines, heartbeat TTLs, and autopilot thresholds all read the wall
clock directly, so the only way to exercise "a node misses its TTL" or
"the leader goes quiet past the election timeout" was to actually wait —
and under a loaded CI box the waits raced the GIL. A `Clock` abstraction
makes every time-dependent decision injectable:

  * `Clock` — the real thing (`monotonic`/`time`/`sleep`), the default
    everywhere; production code pays one attribute indirection.
  * `ManualClock` — virtual time advanced explicitly by `advance()` /
    `set_time()`. `sleep()` blocks until virtual time passes (woken by
    `advance`), so a component's timers fire exactly when the test says
    so and never otherwise.

Only DECISIONS ride the clock (deadline comparisons, TTL arithmetic);
thread poll cadences stay real — a raft election loop under a
ManualClock still polls every few real milliseconds, but campaigns only
once the test advances virtual time past the (seeded) deadline. That
split keeps the change surface small while making timer behavior
deterministic. See docs/FAILOVER.md.
"""
from __future__ import annotations

import threading
import time


class Clock:
    """Real time. `monotonic()` feeds interval math (raft deadlines),
    `time()` feeds wall-clock timestamps (heartbeat TTL deadlines)."""

    def monotonic(self) -> float:
        return time.monotonic()

    def time(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class ManualClock(Clock):
    """Virtual time under test control. Starts at an arbitrary epoch so
    code that assumes time() > 0 keeps working; monotonic() and time()
    advance in lockstep (tests reason about ONE timeline)."""

    def __init__(self, start: float = 1_000_000.0):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._now = float(start)

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def time(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        """Block until virtual time has advanced past now+seconds. A
        zero/negative sleep yields the thread (like time.sleep(0))."""
        if seconds <= 0:
            time.sleep(0)
            return
        with self._lock:
            deadline = self._now + seconds
            while self._now < deadline:
                self._cond.wait(0.05)

    def advance(self, seconds: float) -> float:
        with self._lock:
            self._now += float(seconds)
            self._cond.notify_all()
            return self._now

    def set_time(self, now: float) -> None:
        with self._lock:
            if now < self._now:
                raise ValueError("ManualClock cannot run backwards")
            self._now = float(now)
            self._cond.notify_all()


# the process default; components take `clock=None` -> REAL
REAL = Clock()
