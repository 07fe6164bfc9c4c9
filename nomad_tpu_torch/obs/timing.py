"""One call per timed site: a registry sample and the tracer span of the
same site from one clock reading.

The registry (`metrics.py`) is what the benchmark's per-layer metrics
read and `/v1/metrics` exports; the tracer (`obs/trace.py`) is what
`/v1/traces`, `nomad-tpu trace` and the UI read. A site timed here feeds
both: the sample is recorded always, whatever the tracer's switch says,
and the span only where the tracer is on and has a context for it.

  * `timed(sample, span, cpu=...)` times a block; with `cpu` the
    thread's CPU seconds over the block go under a second sample and on
    the span as `cpu_s` (time off the CPU is the rest: the interpreter
    lock, a lock, the card). With `root`, the samples of the blocks
    timed inside it on its thread are recorded right after its own, so
    a window of the registry that counts a part (a client update's FSM
    apply) counts the whole it belongs to;
  * `waited(sample, span, t0, parent)` records a wait measured after the
    fact (a queue's enqueue stamp to its drain);
  * `TimedRLock` is a re-entrant lock that times its contended
    acquisitions and adds each wait to the current span's `lock_wait_s`.

Every name here is bounded (nomadlint OBS001 polices these calls like
`metrics.*`); ids belong in span attributes.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from ..metrics import metrics
from . import trace

# per thread: the samples of blocks timed inside a root block, held until
# the root's own sample is recorded
_held = threading.local()


def _record(name: str, seconds: float) -> None:
    pending = getattr(_held, "samples", None)
    if pending is None:
        metrics.add_sample(name, seconds)
    else:
        pending.append((name, seconds))


@contextmanager
def timed(sample: str, span: str, cpu: str = "", root: bool = False,
          **attrs):
    """Time the block under the registry sample `sample` and the tracer
    span `span`, a child of the current context (with `root`, the root
    of a trace of its own, head-sampled like an eval's). With `cpu`, the
    thread's CPU seconds over the block are recorded under the sample
    `cpu` and put on the span as `cpu_s`. Yields the span."""
    if root:
        sp = trace.begin_root(span, head_sampled=True, **attrs)
        cm = trace.use(sp)
        outer = getattr(_held, "samples", None)
        _held.samples = []
    else:
        sp = None
        cm = trace.span(span, **attrs)
    status = trace.STATUS_OK
    try:
        with cm as inner:
            if sp is None:
                sp = inner
            # the CPU reading inside the wall reading: cpu <= wall
            t0 = time.perf_counter()
            c0 = time.thread_time() if cpu else 0.0
            try:
                yield sp
            except BaseException:
                status = "error"
                raise
            finally:
                c = time.thread_time() - c0 if cpu else 0.0
                dt = time.perf_counter() - t0
                if root:
                    held, _held.samples = _held.samples, outer
                    _record(sample, dt)
                    for name, v in held:
                        _record(name, v)
                else:
                    _record(sample, dt)
                if cpu:
                    _record(cpu, c)
                    sp.annotate(cpu_s=c)
    finally:
        if root:
            sp.end(status)


def waited(sample: str, span: str, t0: float, parent, **attrs) -> None:
    """Record a wait that began at `t0` (a perf_counter stamp) and ends
    now: the registry sample always, the span under `parent` (a SpanCtx)
    where there is one."""
    _record(sample, time.perf_counter() - t0)
    if parent is not None:
        trace.record_span(span, parent, t0, **attrs)


class TimedRLock:
    """A re-entrant lock that times the acquisitions that block.

    A non-blocking attempt comes first: an uncontended acquisition, and
    re-entry by the owner, read no clock and record nothing. Only when it
    fails is the clock read around the blocking acquire; the wait goes to
    the registry sample `sample` (its count: the contended acquisitions)
    and onto the current span's `lock_wait_s`. `threading.Condition`
    over it keeps the lock's semantics: `_release_save`,
    `_acquire_restore` and `_is_owned` are the inner lock's, so `wait()`
    releases every level and restores them (that re-acquisition is the
    condition's wait, not timed here)."""

    __slots__ = ("_lock", "_sample", "release", "_release_save",
                 "_acquire_restore", "_is_owned")

    def __init__(self, sample: str):
        lock = threading.RLock()
        self._lock = lock
        self._sample = sample
        self.release = lock.release
        self._release_save = lock._release_save
        self._acquire_restore = lock._acquire_restore
        self._is_owned = lock._is_owned

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(False):
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        got = self._lock.acquire(True, timeout)
        dt = time.perf_counter() - t0
        metrics.add_sample(self._sample, dt)
        trace.accumulate("lock_wait_s", dt)
        return got

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self._lock.release()
