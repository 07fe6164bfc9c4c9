"""Agent monitor + profiling (ref command/agent/monitor/monitor.go live log
streaming and command/agent/pprof/pprof.go profile capture).

`LogMonitor` is the hclog-InterceptLogger analog: every agent log line goes
to a ring buffer and to any live subscriber queues (the /v1/agent/monitor
stream). `sample_stacks` is the pprof analog that makes sense for a Python
runtime: a wall-clock stack sampler aggregating frames across all threads.
"""
from __future__ import annotations

import collections
import queue
import sys
import threading
import time
import traceback

LEVELS = {"trace": 0, "debug": 1, "info": 2, "warn": 3, "error": 4}


class LogMonitor:
    """Fan-out log sink with a bounded ring of recent lines."""

    def __init__(self, ring_size: int = 512):
        self._lock = threading.Lock()
        self.ring: collections.deque = collections.deque(maxlen=ring_size)
        self._subs: list[tuple[int, queue.Queue]] = []

    def write(self, line: str, level: str = "info") -> None:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S")
        rec = f"{ts} [{level.upper()}] {line}"
        lvl = LEVELS.get(level, 2)
        with self._lock:
            self.ring.append((lvl, rec))
            for sub_lvl, q in self._subs:
                if lvl >= sub_lvl:
                    try:
                        q.put_nowait(rec)
                    except queue.Full:
                        pass  # slow consumer drops lines (ref monitor.go)

    def logger(self, line: str) -> None:
        """Drop-in for the `logger(msg)` callables used everywhere."""
        level = "info"
        lowered = line.lower()
        if "error" in lowered or "failed" in lowered:
            level = "error"
        self.write(line, level)

    def subscribe(self, level: str = "info",
                  replay: bool = True) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=512)
        lvl = LEVELS.get(level, 2)
        with self._lock:
            if replay:
                for rec_lvl, rec in self.ring:
                    if rec_lvl >= lvl:
                        try:
                            q.put_nowait(rec)
                        except queue.Full:
                            break
            self._subs.append((lvl, q))
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            self._subs = [(lv, s) for lv, s in self._subs if s is not q]


def thread_dump() -> str:
    """All-thread stack dump (the pprof 'goroutine' profile analog)."""
    out = []
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        out.append(f"thread {tid} ({names.get(tid, '?')}):")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


def sample_stacks(seconds: float = 1.0, hz: int = 100) -> str:
    """Wall-clock sampling profiler across every thread (the pprof
    'profile' analog): returns aggregated stack counts, hottest first."""
    seconds = min(seconds, 30.0)
    interval = 1.0 / hz
    counts: collections.Counter = collections.Counter()
    me = threading.get_ident()
    deadline = time.monotonic() + seconds
    samples = 0
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            stack = tuple(
                f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:"
                f"{f.f_code.co_name}"
                for f, _ in traceback.walk_stack(frame))
            counts[stack[::-1]] += 1
        samples += 1
        time.sleep(interval)
    lines = [f"# {samples} samples over {seconds}s at ~{hz}Hz", ""]
    for stack, n in counts.most_common(50):
        lines.append(f"{n:6d}  {' -> '.join(stack[-12:])}")
    return "\n".join(lines)
