"""Span-based eval tracing (ISSUE 7 tentpole): causal spans across the
full eval lifecycle, surviving thread handoffs and fan-in/fan-out.

PRs 1-6 made the hot path fast by *sharing* work across evals — a
micro-batched `jit(vmap)` dispatch serves K solves, a coalesced raft
entry carries up to 32 plans — which means a flat timer registry can no
longer say where one eval's latency went. This module restores that
attribution with the standard distributed-tracing model, adapted to an
in-process, multi-threaded control plane:

  * a TRACE per evaluation (or per leader-establish barrier), made of
    SPANS — named, timed, attributed, parented intervals;
  * context propagates by THREAD-LOCAL current-span plus an explicit
    eval-id registry, so a broker enqueue on one thread, the worker
    invoke on another, and the plan applier's commit on a third all
    attach to the same trace (`eval_ctx` + `use`);
  * FAN-IN is modeled with LINKS, not parents: the shared micro-batch
    dispatch span and the shared coalesced-commit span each carry links
    to every participating eval's span, and the store attaches the
    shared span to every linked trace so a per-eval fetch shows the
    shared work it rode (docs/OBSERVABILITY.md).

Sampling is head-based with error retention: `sample_rate` decides at
trace START whether a HEALTHY trace is kept; traces that end with any
non-"ok" status (faulted dispatch, failed eval, leadership lost) are
always retained, so the interesting ones survive a low rate. When
tracing is disabled every entry point is a cheap boolean check and a
shared no-op — the bench gates the enabled-mode overhead at <=5% of
stream throughput (tests/test_bench_regression.py).

Export is Chrome trace-event JSON (`chrome_trace`), loadable in
Perfetto / chrome://tracing; the agent serves it at /v1/traces and the
CLI renders a text waterfall (`nomad-tpu trace <eval-id>`).
"""
from __future__ import annotations

import itertools
import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Optional

DEFAULT_CAPACITY = 2048      # retained (completed) traces
_LIVE_SLACK = 2              # live traces tolerated = slack * capacity

# statuses are free-form strings; "ok" is the only one head-sampling may
# drop. The lifecycle uses: ok, error, nack, leadership_lost, flushed,
# truncated, fanout, demoted.
STATUS_OK = "ok"


class SpanCtx:
    """A propagatable reference to a span: (trace_id, span_id). What the
    micro-batcher's lanes and the plan queue's pendings carry across
    threads, and what fan-in links point at."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanCtx({self.trace_id[:8]}/{self.span_id[:8]})"


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0_perf",
                 "t0_wall", "attrs", "links", "thread", "_tracer", "_done")

    def __init__(self, tracer, name: str, trace_id: str, span_id: str,
                 parent_id: str, links, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0_perf = time.perf_counter()
        self.t0_wall = time.time()
        self.attrs = dict(attrs) if attrs else {}
        self.links = [(c.trace_id, c.span_id) for c in links
                      if c is not None] if links else []
        self.thread = threading.current_thread().name
        self._tracer = tracer
        self._done = False

    def ctx(self) -> SpanCtx:
        return SpanCtx(self.trace_id, self.span_id)

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self, status: str = STATUS_OK, **attrs) -> None:
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        self._tracer._end_span(self, status)


class _NoopSpan:
    """Shared do-nothing span: the disabled/unparented fast path."""

    __slots__ = ()

    def ctx(self):
        return None

    def annotate(self, **attrs):
        pass

    def end(self, status: str = STATUS_OK, **attrs):
        pass


NOOP_SPAN = _NoopSpan()


class _Trace:
    __slots__ = ("trace_id", "eval_id", "name", "status", "sampled",
                 "retain", "t0_perf", "t0_wall", "end_wall", "spans",
                 "linked", "open", "root", "attrs")

    def __init__(self, trace_id: str, eval_id: str, name: str,
                 sampled: bool, retain: bool):
        self.trace_id = trace_id
        self.eval_id = eval_id
        self.name = name
        self.status = ""
        self.sampled = sampled
        self.retain = retain
        self.t0_perf = time.perf_counter()
        self.t0_wall = time.time()
        self.end_wall = 0.0
        self.spans: list[dict] = []       # ended spans, append order
        self.linked: list[dict] = []      # shared fan-in spans linking here
        self.open = 0                     # spans started, not yet ended
        self.root: Optional[Span] = None
        self.attrs: dict = {}

    def as_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "eval_id": self.eval_id,
            "name": self.name, "status": self.status,
            "start_unix": self.t0_wall, "end_unix": self.end_wall,
            "duration_s": max(0.0, (self.end_wall or time.time())
                              - self.t0_wall),
            "attrs": {k: v for k, v in self.attrs.items()
                      if not str(k).startswith("_")},
            "spans": list(self.spans),
            "linked_spans": list(self.linked),
        }


class Tracer:
    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._enabled = os.environ.get("NOMAD_TRACE", "") != "0"
        self._sample_rate = 1.0
        # overload brownout multiplier (ISSUE 8, server/overload.py):
        # under pressure HEALTHY-trace head-sampling downshifts without
        # touching the operator's configured rate — error retention is
        # unaffected (non-ok endings are always kept), so the traces
        # that explain the overload survive it
        self._pressure_factor = 1.0
        self._capacity = DEFAULT_CAPACITY
        self._rng = random.Random()
        self._seq = itertools.count(1)
        self._id_prefix = f"{os.getpid() & 0xffff:04x}"
        self._live: dict[str, _Trace] = {}        # trace_id -> trace
        self._by_eval: dict[str, str] = {}        # eval_id -> trace_id
        self._done: dict[str, _Trace] = {}        # retained, insert order
        self._done_by_eval: dict[str, str] = {}
        self._leaked: list[dict] = []
        self.started = 0
        self.dropped = 0

    # --------------------------------------------------------- configuration

    def configure(self, enabled: Optional[bool] = None,
                  sample_rate: Optional[float] = None,
                  capacity: Optional[int] = None) -> None:
        """Hot-reloadable knobs (the worker pushes the raft-replicated
        SchedulerConfiguration telemetry_* values through here on every
        eval, same path as the micro-batcher's window). NOMAD_TRACE=0
        hard-disables regardless of config; NOMAD_TRACE=1 hard-enables."""
        env = os.environ.get("NOMAD_TRACE", "")
        if enabled is not None:
            self._enabled = bool(enabled) if env == "" else env != "0"
        if sample_rate is not None:
            self._sample_rate = min(1.0, max(0.0, float(sample_rate)))
        if capacity is not None and int(capacity) >= 1:
            self._capacity = int(capacity)

    def set_pressure_factor(self, factor: float) -> None:
        """Overload-controller lever: scales the head-sampling rate for
        healthy traces (1.0 = no downshift). Kept separate from
        configure() — the worker re-pushes the config rate every eval
        and must not erase the controller's downshift."""
        with self._lock:
            self._pressure_factor = min(1.0, max(0.0, float(factor)))

    def enabled(self) -> bool:
        return self._enabled

    # ------------------------------------------------------- current context

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[SpanCtx]:
        st = getattr(self._tls, "stack", None)
        if not st:
            return None
        top = st[-1]
        if isinstance(top, Span):
            return top.ctx()
        if isinstance(top, SpanCtx):
            return top
        return None

    @contextmanager
    def use(self, ctx):
        """Adopt `ctx` (a SpanCtx or Span, e.g. looked up by eval id) as
        this thread's current context — the cross-thread handoff seam
        (broker -> worker -> applier)."""
        if ctx is None or ctx is NOOP_SPAN or not self._enabled:
            yield
            return
        st = self._stack()
        st.append(ctx)
        try:
            yield
        finally:
            if st and st[-1] is ctx:
                st.pop()

    def annotate(self, **attrs) -> None:
        """Merge attributes into the current span, if any (used by deep
        layers — backend demotion chain, raft index assignment — that
        should not know whose span they run under)."""
        if not self._enabled or not attrs:
            return
        st = getattr(self._tls, "stack", None)
        if st:
            top = st[-1]
            if isinstance(top, Span):
                top.attrs.update(attrs)

    def annotate_list(self, key: str, value) -> None:
        """Append `value` to a list-valued attribute of the current span
        (demotion chains record every tier they fell through)."""
        if not self._enabled:
            return
        st = getattr(self._tls, "stack", None)
        if st:
            top = st[-1]
            if isinstance(top, Span):
                top.attrs.setdefault(key, []).append(value)

    # ------------------------------------------------------------ trace API

    def _new_id(self) -> str:
        return f"{self._id_prefix}{next(self._seq):012x}"

    def begin_eval(self, eval_id: str, name: str = "eval",
                   owner=None, **attrs) -> Optional[SpanCtx]:
        """Get-or-create the trace + root span for an evaluation
        (idempotent: the broker calls it at enqueue; the worker and the
        bench harness call it defensively at dequeue). Head sampling
        happens HERE; unsampled traces still record spans so an error
        ending can promote them to retention.

        `owner` scopes the trace to one broker/server: the tracer is
        process-global, and in-process multi-server tests re-run an eval
        on a NEW leader while the old leader's workers may still hold
        the previous trace — a different owner SUPERSEDES the stale
        trace (truncated, status `superseded`) instead of mixing two
        servers' spans into one timeline. `None` matches any owner."""
        if not self._enabled or not eval_id:
            return None
        stale = None
        with self._lock:
            tid = self._by_eval.get(eval_id)
            if tid is not None:
                tr = self._live.get(tid)
                if tr is not None and tr.root is not None:
                    old = tr.attrs.get("_owner")
                    if owner is None or old is None or old == owner:
                        return tr.root.ctx()
                    stale = tr
                    del self._by_eval[eval_id]
            rate = self._sample_rate * self._pressure_factor
            sampled = rate >= 1.0 or self._rng.random() < rate
            tid = self._new_id()
            tr = _Trace(tid, eval_id, name, sampled, retain=False)
            if owner is not None:
                tr.attrs["_owner"] = owner
            self._live[tid] = tr
            self._by_eval[eval_id] = tid
            self.started += 1
            self._evict_live_locked()
        if stale is not None:
            stale.attrs["truncated"] = True
            stale.root.end("superseded")
        root = Span(self, name, tid, self._new_id(), "", None, attrs)
        with self._lock:
            tr.root = root
            tr.open += 1
        return root.ctx()

    def eval_ctx(self, eval_id: str) -> Optional[SpanCtx]:
        if not self._enabled or not eval_id:
            return None
        with self._lock:
            tid = self._by_eval.get(eval_id)
            tr = self._live.get(tid) if tid else None
        if tr is None or tr.root is None:
            return None
        return tr.root.ctx()

    def mark_dequeued(self, eval_id: str, **attrs) -> None:
        """Record the broker queue-wait span: enqueue (trace start) to
        dequeue. Called by the broker with the lock already held —
        must stay allocation-light."""
        if not self._enabled:
            return
        with self._lock:
            tid = self._by_eval.get(eval_id)
            tr = self._live.get(tid) if tid else None
        if tr is None or tr.root is None:
            return
        self.record_span("broker.wait", tr.root.ctx(), tr.t0_perf,
                         t0_wall=tr.t0_wall, **attrs)

    def end_eval(self, eval_id: str, status: str = STATUS_OK,
                 truncate: bool = False, owner=None, **attrs) -> None:
        """End an eval's root span and complete its trace. `truncate`
        marks still-open child spans as truncated WITHOUT counting them
        as leaks — the flush/shutdown paths end traces whose worker
        threads may still be mid-span. `owner` must match the trace's
        begin_eval owner (both non-None) or the end is ignored: a
        deposed server's late completion must not close the trace its
        successor is writing."""
        if not self._enabled or not eval_id:
            return
        with self._lock:
            tid = self._by_eval.get(eval_id)
            tr = self._live.get(tid) if tid else None
            if tr is not None:
                old = tr.attrs.get("_owner")
                if owner is not None and old is not None and old != owner:
                    return
            self._by_eval.pop(eval_id, None)
        if tr is None or tr.root is None:
            return
        if attrs:
            tr.attrs.update(attrs)
        if truncate:
            tr.attrs["truncated"] = True
        tr.root.end(status)

    def begin_root(self, name: str, **attrs) -> Span:
        """A root span NOT tied to an eval (leader-establish barrier,
        failover promotion, revoke). Always retained."""
        if not self._enabled:
            return NOOP_SPAN
        with self._lock:
            tid = self._new_id()
            tr = _Trace(tid, "", name, sampled=True, retain=True)
            self._live[tid] = tr
            self.started += 1
            self._evict_live_locked()
        root = Span(self, name, tid, self._new_id(), "", None, attrs)
        with self._lock:
            tr.root = root
            tr.open += 1
        return root

    # ------------------------------------------------------------- span API

    def _resolve_parent(self, parent) -> Optional[SpanCtx]:
        if parent is None:
            parent = self.current()
        if isinstance(parent, Span):
            return parent.ctx()
        if isinstance(parent, SpanCtx):
            return parent
        return None

    def start_span(self, name: str, parent=None, links=(),
                   **attrs) -> object:
        """Manually-ended span. Returns NOOP_SPAN when tracing is off or
        there is no parent context (unit-test scheduler runs outside any
        trace must not mint orphan roots)."""
        if not self._enabled:
            return NOOP_SPAN
        ctx = self._resolve_parent(parent)
        if ctx is None:
            return NOOP_SPAN
        with self._lock:
            tr = self._live.get(ctx.trace_id)
            if tr is None:
                return NOOP_SPAN
            tr.open += 1
        return Span(self, name, ctx.trace_id, self._new_id(), ctx.span_id,
                    links, attrs)

    @contextmanager
    def span(self, name: str, parent=None, links=(), **attrs):
        """The standard instrumentation block: a child of the current
        (or given) context, made current for the block, ended with
        status ok/error on exit."""
        sp = self.start_span(name, parent=parent, links=links, **attrs)
        if sp is NOOP_SPAN:
            yield sp
            return
        st = self._stack()
        st.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.end("error", error=repr(e)[:200])
            raise
        finally:
            if st and st[-1] is sp:
                st.pop()
            sp.end()
        # (second end() is a no-op when the except path already ended it)

    def record_span(self, name: str, parent, start_perf: float,
                    links=(), status: str = STATUS_OK,
                    t0_wall: Optional[float] = None, **attrs) -> None:
        """An already-elapsed interval (queue waits measured at drain
        time): start given, end now."""
        if not self._enabled:
            return
        ctx = self._resolve_parent(parent)
        if ctx is None:
            return
        with self._lock:
            tr = self._live.get(ctx.trace_id)
            if tr is None:
                return
            tr.open += 1
        sp = Span(self, name, ctx.trace_id, self._new_id(), ctx.span_id,
                  links, attrs)
        sp.t0_perf = start_perf
        sp.t0_wall = t0_wall if t0_wall is not None else \
            time.time() - max(0.0, time.perf_counter() - start_perf)
        sp.end(status)

    # ------------------------------------------------------ span completion

    def _end_span(self, span: Span, status: str) -> None:
        dur = max(0.0, time.perf_counter() - span.t0_perf)
        rec = {"name": span.name, "id": span.span_id,
               "parent": span.parent_id, "trace": span.trace_id,
               "ts": span.t0_wall, "dur": dur, "status": status,
               "thread": span.thread, "attrs": span.attrs,
               "links": span.links}
        with self._lock:
            tr = self._live.get(span.trace_id)
            if tr is None:
                tr = self._done.get(span.trace_id)
            if tr is not None:
                tr.spans.append(rec)
                tr.open = max(0, tr.open - 1)
            # fan-in: attach the shared span to every linked trace so a
            # per-eval fetch shows the shared dispatch/commit it rode
            for (ltid, _lsid) in span.links:
                if ltid == span.trace_id:
                    continue
                ltr = self._live.get(ltid) or self._done.get(ltid)
                if ltr is not None:
                    ltr.linked.append(rec)
            if tr is not None and tr.root is span:
                self._complete_locked(tr, status)

    def _complete_locked(self, tr: _Trace, status: str) -> None:
        tr.status = status
        tr.end_wall = time.time()
        self._live.pop(tr.trace_id, None)
        if tr.open > 0 and not tr.attrs.get("truncated"):
            self._leaked.append({"trace": tr.trace_id, "name": tr.name,
                                 "eval_id": tr.eval_id, "open": tr.open})
        # forced retention is for INTERESTING endings (error, timeout,
        # leadership lost, faulted) — administrative endings (flush on
        # step-down, supersede by a new leader) would otherwise flood
        # the bounded store and evict the very error traces a low
        # sample rate is trying to protect
        interesting = status not in (STATUS_OK, "flushed", "superseded")
        keep = tr.retain or tr.sampled or interesting
        if not keep:
            self.dropped += 1
            return
        self._done[tr.trace_id] = tr
        if tr.eval_id:
            self._done_by_eval[tr.eval_id] = tr.trace_id
        while len(self._done) > self._capacity:
            old_tid, old = next(iter(self._done.items()))
            del self._done[old_tid]
            if old.eval_id and \
                    self._done_by_eval.get(old.eval_id) == old_tid:
                del self._done_by_eval[old.eval_id]

    def _evict_live_locked(self) -> None:
        # abandoned traces (evals whose worker died, shutdown races) must
        # not grow without bound; oldest live traces are dropped silently
        cap = self._capacity * _LIVE_SLACK
        while len(self._live) > cap:
            tid, tr = next(iter(self._live.items()))
            del self._live[tid]
            if tr.eval_id and self._by_eval.get(tr.eval_id) == tid:
                del self._by_eval[tr.eval_id]
            self.dropped += 1

    # --------------------------------------------------------------- readers

    def traces(self, limit: int = 200) -> list[dict]:
        """Most-recent-first summaries of retained traces."""
        with self._lock:
            done = list(self._done.values())
        out = []
        for tr in reversed(done[-limit:] if limit else done):
            out.append({
                "trace_id": tr.trace_id, "eval_id": tr.eval_id,
                "name": tr.name, "status": tr.status,
                "start_unix": tr.t0_wall,
                "duration_s": max(0.0, tr.end_wall - tr.t0_wall),
                "spans": len(tr.spans), "links": len(tr.linked),
            })
        return out

    def get(self, ref: str) -> Optional[dict]:
        """Fetch one trace by trace id, eval id, or unique prefix of
        either."""
        with self._lock:
            tid = self._done_by_eval.get(ref) or \
                (ref if ref in self._done else None)
            if tid is None and len(ref) >= 4:
                hits = {t for e, t in self._done_by_eval.items()
                        if e.startswith(ref)}
                hits |= {t for t in self._done if t.startswith(ref)}
                if len(hits) == 1:
                    tid = hits.pop()
            tr = self._done.get(tid) if tid else None
            return tr.as_dict() if tr is not None else None

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self._enabled,
                    "sample_rate": self._sample_rate,
                    "pressure_factor": self._pressure_factor,
                    "capacity": self._capacity,
                    "live": len(self._live), "retained": len(self._done),
                    "started": self.started, "dropped": self.dropped}

    def take_leaked(self) -> list[dict]:
        """Spans still open when their trace completed (the conftest
        span-leak gate). Reading clears the list."""
        with self._lock:
            out = self._leaked
            self._leaked = []
            return out

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self._by_eval.clear()
            self._done.clear()
            self._done_by_eval.clear()
            self._leaked = []
            self.started = 0
            self.dropped = 0
            self._pressure_factor = 1.0


# ------------------------------------------------------------------ exports

def chrome_trace(traces: list[dict]) -> dict:
    """Chrome trace-event JSON (chrome://tracing / Perfetto "legacy
    chrome JSON"): one complete ("X") event per span on a per-thread
    track, plus flow ("s"/"f") events for every fan-in link so the
    shared micro-batch dispatch / coalesced commit visibly connects to
    each participating eval's lane."""
    events = []
    tids: dict[str, int] = {}
    span_at: dict[str, dict] = {}

    def tid_for(thread: str) -> int:
        if thread not in tids:
            tids[thread] = len(tids) + 1
        return tids[thread]

    seen = set()
    for tr in traces:
        for sp in list(tr.get("spans", ())) + list(tr.get(
                "linked_spans", ())):
            if sp["id"] in seen:
                continue
            seen.add(sp["id"])
            span_at[sp["id"]] = sp
            args = {"trace": sp["trace"], "status": sp["status"]}
            for k, v in (sp.get("attrs") or {}).items():
                args[str(k)] = v
            events.append({
                "ph": "X", "name": sp["name"], "cat": "eval",
                "pid": 1, "tid": tid_for(sp["thread"]),
                "ts": sp["ts"] * 1e6, "dur": max(sp["dur"], 1e-7) * 1e6,
                "args": args,
            })
    flow = itertools.count(1)
    for sp in span_at.values():
        for (_ltid, lsid) in sp.get("links", ()):
            src = span_at.get(lsid)
            if src is None:
                continue
            fid = next(flow)
            events.append({"ph": "s", "id": fid, "name": "fanin",
                           "cat": "link", "pid": 1,
                           "tid": tid_for(src["thread"]),
                           "ts": (src["ts"] + src["dur"] / 2) * 1e6})
            events.append({"ph": "f", "id": fid, "name": "fanin",
                           "cat": "link", "bp": "e", "pid": 1,
                           "tid": tid_for(sp["thread"]),
                           "ts": (sp["ts"] + sp["dur"] / 2) * 1e6})
    for thread, tid in tids.items():
        events.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": tid, "args": {"name": thread}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def chain_summary(tr: dict) -> dict:
    """Which lifecycle stages a retained eval trace covers — the
    completeness predicate behind the bench's trace_complete_frac and
    the chaos continuity tests. `complete` = root-to-commit: the worker
    invoked, a plan was submitted, and its commit outcome is attributed
    (a committed entry, a no-op, or an attributed failure). Fan-in
    coverage is reported separately because solo evals legitimately
    skip the micro-batcher and lone plans commit uncoalesced."""
    names = {}
    for sp in tr.get("spans", ()):
        names.setdefault(sp["name"], []).append(sp)
    linked = {}
    for sp in tr.get("linked_spans", ()):
        linked.setdefault(sp["name"], []).append(sp)
    submitted = "plan.submit" in names or "plan.commit_wait" in names
    committed = ("plan.commit_wait" in names
                 or "plan.commit" in linked or "plan.commit" in names)
    mb_waits = [w for w in names.get("solver.microbatch.wait", [])
                if not (w.get("attrs") or {}).get("solo")]
    mb_linked = all(w.get("links") for w in mb_waits) if mb_waits else None
    commit_waits = names.get("plan.commit_wait", [])
    commit_linked = any("plan.commit" in linked or w.get("links")
                        for w in commit_waits) if commit_waits else None
    return {
        "invoked": "worker.invoke" in names,
        "scheduled": "scheduler.process" in names
        or "scheduler.reconcile" in names,
        "submitted": submitted,
        "committed": committed,
        "microbatched": bool(mb_waits),
        "microbatch_linked": mb_linked,
        "commit_linked": commit_linked,
        "complete": ("worker.invoke" in names and submitted and committed
                     and bool(tr.get("status"))),
    }


tracer = Tracer()

# module-level forwarding API (instrumentation sites import the module,
# not the object — one process-wide tracer matches the one-store,
# one-device reality, exactly like solver/microbatch.py)
configure = tracer.configure
set_pressure_factor = tracer.set_pressure_factor
enabled = tracer.enabled
current = tracer.current
use = tracer.use
annotate = tracer.annotate
annotate_list = tracer.annotate_list
begin_eval = tracer.begin_eval
eval_ctx = tracer.eval_ctx
mark_dequeued = tracer.mark_dequeued
end_eval = tracer.end_eval
begin_root = tracer.begin_root
start_span = tracer.start_span
span = tracer.span
record_span = tracer.record_span
traces = tracer.traces
get = tracer.get
stats = tracer.stats
take_leaked = tracer.take_leaked
reset = tracer.reset
