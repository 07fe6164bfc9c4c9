"""Explicit thread-lifecycle state for restartable daemon loops (ISSUE 11
satellite — the `test_raftnode_fence_rejects_after_term_moves` in-suite
flake).

The old per-component pattern

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

raced two ways. The leadership recovery barrier start()s these loops on
the election-callback thread while Server.shutdown() (or a revoke)
stop()s them from another:

  1. a stop() landing between the `_thread` assignment and the
     `.start()` call joins a thread that was never started —
     `RuntimeError("cannot join thread before it is started")`
     (observed in-suite under load in PR 10);
  2. a start() clearing the SHARED stop event while a stop() is
     mid-join un-stops the loop the join is waiting on — the join burns
     its whole timeout, the still-running loop leaks, and the restart
     spawns a second one beside it.

LoopHandle makes the state explicit by owning BOTH halves: the stop
event and the thread handle mutate under one lock, so `set + join` and
`clear + spawn` are atomic pairs that strictly order against each
other. The handle is only assigned AFTER `Thread.start()` returned (a
visible handle is always a started thread), and a failed spawn
(`can't start new thread` under load) leaves no handle behind.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional


class LoopHandle:
    """Start/stop state for one restartable daemon thread. The owning
    component reads `handle.stop_event` in its loop condition; start()
    clears it and stop() sets it — always under the handle lock."""

    def __init__(self, stop_event: Optional[threading.Event] = None):
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.stop_event = stop_event if stop_event is not None \
            else threading.Event()

    def start(self, target: Callable[[], None], name: str) -> bool:
        """Clear the stop event and spawn the loop thread; no-op (False)
        while a previous incarnation is still alive — a concurrent
        stop() orders strictly before or after on the same lock. An
        incarnation left DRAINING by a timed-out stop() (stop event set,
        thread still alive) is waited for briefly rather than duplicated
        or un-stopped; if it is genuinely wedged the restart is refused
        — one slow loop must never become two concurrent ones."""
        with self._lock:
            t = self._thread
            if t is not None and t.is_alive():
                if not self.stop_event.is_set():
                    return False            # already running healthy
                t.join(timeout=5.0)         # draining: let it finish
                if t.is_alive():
                    return False            # wedged: refuse to duplicate
            self.stop_event.clear()
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()               # raises -> nothing assigned below
            self._thread = t
            return True

    def stop(self, timeout: float = 5.0) -> bool:
        """Set the stop event and join the loop thread. Atomic under the
        handle lock: no concurrent start() can clear the event while the
        join is waiting on it. A join that exhausts `timeout` KEEPS the
        handle (False) — dropping it would let the next start() clear
        the stop event out from under the still-running loop and spawn
        a duplicate beside it."""
        with self._lock:
            self.stop_event.set()
            t = self._thread
            if t is None:
                return True
            t.join(timeout=timeout)
            if t.is_alive():
                return False                # still draining: keep handle
            self._thread = None
            return True

    def is_alive(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()
