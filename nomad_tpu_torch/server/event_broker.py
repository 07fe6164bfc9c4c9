"""Event broker: pub/sub of state-change events with per-subscriber
backpressure (ref nomad/stream/event_broker.go:30 EventBroker,
event_buffer.go).

A bounded ring buffer of event batches with per-subscriber queues. A
subscriber that falls behind rides three backpressure rungs, gentlest
first (ISSUE 16):

  1. **coalesce** — above `coalesce_after` queued batches, the queue is
     folded latest-wins per (topic, namespace, key); the threshold
     tightens with the overload pressure state (`pressure_fn`). Opt-in
     at construction (the Server opts in; a bare broker keeps the
     legacy deliver-every-event contract).
  2. **park** — blocking readers wait on `wait_for_index(topics, index)`
     instead of poll-looping the state store, so only writes on the
     watched topics wake them.
  3. **drop** — only when coalescing cannot shrink the queue under
     `max_pending` (that many *distinct* keys in flight) is the
     subscriber closed (the reference's ErrSubscriptionClosed contract,
     `nomad.event.subscriber_dropped`).

Events originate from the state store's `event_sinks` (our analog of
nomad/state/events.go eventsFromChanges). Feeds `/v1/event/stream` and
the HTTP blocking-query helpers.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional, Union

from ..metrics import metrics

ALL_KEYS = "*"

TOPIC_JOB = "Job"
TOPIC_EVAL = "Evaluation"
TOPIC_ALLOC = "Allocation"
TOPIC_DEPLOYMENT = "Deployment"
TOPIC_NODE = "Node"
TOPIC_ALL = "*"


class SubscriptionClosedError(Exception):
    """The subscriber fell behind the ring buffer and was dropped
    (ref stream/subscription.go ErrSubscriptionClosed)."""


@dataclass
class Event:
    topic: str
    type: str
    key: str = ""
    namespace: str = ""
    filter_keys: list[str] = field(default_factory=list)
    index: int = 0
    payload: Any = None

    def to_api(self) -> dict:
        from ..api_codec import to_api
        wrapper_key = {
            TOPIC_JOB: "Job", TOPIC_EVAL: "Evaluation",
            TOPIC_ALLOC: "Allocation", TOPIC_DEPLOYMENT: "Deployment",
            TOPIC_NODE: "Node",
        }.get(self.topic, "Payload")
        payload = self.payload
        if payload is not None and not isinstance(payload, (dict, str, int,
                                                            float, list)):
            payload = to_api(payload)
        return {"Topic": self.topic, "Type": self.type, "Key": self.key,
                "Namespace": self.namespace, "FilterKeys": self.filter_keys,
                "Index": self.index, "Payload": {wrapper_key: payload}}


def _match(req_topics: dict[str, list[str]], ev: Event) -> bool:
    for topic in (ev.topic, TOPIC_ALL):
        keys = req_topics.get(topic)
        if keys is None:
            continue
        for k in keys:
            if k == ALL_KEYS or k == ev.key or k in ev.filter_keys:
                return True
    return False


class Subscription:
    def __init__(self, broker: "EventBroker", topics: dict[str, list[str]],
                 namespace: str = ""):
        self._broker = broker
        self.topics = topics or {TOPIC_ALL: [ALL_KEYS]}
        self.namespace = namespace
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._closed = False

    def _offer(self, index: int, events: list[Event]) -> None:
        wanted = [e for e in events if _match(self.topics, e)
                  and (not self.namespace or not e.namespace
                       or e.namespace == self.namespace)]
        dropped = False
        with self._cond:
            if self._closed:
                return
            if wanted:
                self._queue.append((index, wanted))
                threshold = self._broker._coalesce_threshold()
                if threshold is not None and len(self._queue) > threshold:
                    self._coalesce_locked()
                if len(self._queue) > self._broker.max_pending:
                    self._closed = True   # slow consumer: drop (last rung)
                    self._queue.clear()
                    dropped = True
            self._cond.notify_all()
        if dropped:
            # the per-subscriber cap firing must be visible (ISSUE 8
            # satellite): a fleet of watchers silently re-subscribing in
            # a drop loop looks exactly like healthy streaming otherwise
            metrics.incr("nomad.event.subscriber_dropped")
            self._broker._unsubscribe(self)

    def _coalesce_locked(self) -> None:
        """Fold the queued batches latest-wins per (topic, namespace, key).

        The zero-loss contract is per key, not per event: after a
        coalesce a reader still observes the latest state of every key
        that was ever queued, in index order, but intermediate updates
        to the same key are superseded. Caller holds self._cond."""
        total = sum(len(evs) for _, evs in self._queue)
        latest: dict[tuple[str, str, str], Event] = {}
        max_index = 0
        for idx, evs in self._queue:
            max_index = max(max_index, idx)
            for e in evs:
                latest[(e.topic, e.namespace, e.key)] = e
        superseded = total - len(latest)
        if superseded <= 0:
            return
        merged = sorted(latest.values(), key=lambda e: e.index)
        self._queue.clear()
        # strictly shrinking: N queued batches fold into this single one,
        # and _offer still drops the subscriber past max_pending
        # nomadlint: disable=QUEUE001 — shrinking fold, bound in _offer
        self._queue.append((max_index, merged))
        metrics.incr("nomad.event.coalesced_batches")
        metrics.incr("nomad.event.coalesced_events", superseded)

    def next_events(self, timeout: Optional[float] = None
                    ) -> Optional[tuple[int, list[Event]]]:
        """Block until the next matching batch; None on timeout. Raises
        SubscriptionClosedError if dropped for falling behind."""
        # loop on a deadline: a bare cond.wait(timeout) returns early on
        # notify-without-data (e.g. a publish whose batch matched nothing,
        # or a batch consumed by a racing reader under the RLock), which
        # silently truncated the caller's timeout (ISSUE 16 satellite)
        deadline = (None if timeout is None
                    else time.monotonic() + max(0.0, timeout))
        with self._cond:
            while not self._queue and not self._closed:
                if deadline is None:
                    self._cond.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            if self._closed:
                raise SubscriptionClosedError()
            if self._queue:
                return self._queue.popleft()
            return None

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._broker._unsubscribe(self)


class EventBroker:
    """ref nomad/stream/event_broker.go:30; buffer_size mirrors
    EventBufferSize (default 100 batches)."""

    def __init__(self, buffer_size: int = 256, max_pending: int = 512,
                 coalesce_after: Optional[int] = None,
                 pressure_fn=None):
        # RLock: subscribe() replays into the sub while holding the lock; an
        # overflowing replay re-enters via _unsubscribe
        self._lock = threading.RLock()
        self._buffer: deque[tuple[int, list[Event]]] = deque(
            maxlen=buffer_size)
        self._subs: list[Subscription] = []
        self.max_pending = max_pending
        # backpressure rung 1: queued batches past this start coalescing
        # latest-wins per key. None (the default) keeps the legacy
        # deliver-every-event contract — rung 1 is OPT-IN at
        # construction because folding is only sound for consumers that
        # want latest STATE per key, not an exhaustive event log; the
        # Server opts its broker in (server.py), bare brokers don't
        self.coalesce_after = coalesce_after
        # optional overload pressure feed ("ok"/"saturated"/"shedding");
        # pressure tightens the coalesce threshold so bursty fan-out
        # degrades to latest-state delivery before anything drops
        self.pressure_fn = pressure_fn
        self._latest_index = 0
        # highest published index per topic, for wait_for_index parking
        self._topic_index: dict[str, int] = {}
        self._pub_cond = threading.Condition(self._lock)

    def _coalesce_threshold(self) -> Optional[int]:
        ca = self.coalesce_after
        if ca is None:
            return None
        if self.pressure_fn is not None:
            try:
                pressure = self.pressure_fn()
            except Exception:
                pressure = "ok"
            if pressure == "saturated":
                return max(1, ca // 4)
            if pressure == "shedding":
                return 1
        return ca

    # ------------------------------------------------------------- publish

    def publish(self, index: int, events: list[Event]) -> None:
        """ref event_broker.go:95 Publish"""
        if not events:
            return
        with self._lock:
            self._latest_index = max(self._latest_index, index)
            for ev in events:
                if index > self._topic_index.get(ev.topic, 0):
                    self._topic_index[ev.topic] = index
            # the ring bound lives in __init__: deque(maxlen=buffer_size)
            # nomadlint: disable=QUEUE001 — deque maxlen ring (above)
            self._buffer.append((index, events))
            subs = list(self._subs)
            self._pub_cond.notify_all()
        for sub in subs:
            sub._offer(index, events)

    def sink(self, topic: str, etype: str, index: int, payload) -> None:
        """Adapter matching StateStore.event_sinks signature."""
        self.publish(index, [make_event(topic, etype, index, payload)])

    def sink_batch(self, rows: list) -> None:
        """Adapter matching StateStore.event_batch_sinks (ISSUE 20): a
        whole apply-batch window's events — [(topic, etype, index,
        payload)] — as ONE publish: one broker-lock round, one ring
        batch, one _offer per subscriber, published at the window's
        highest index (each event keeps its own index; a watcher woken
        at the window index re-reads state that already contains the
        whole window, the same visibility rule as the store's
        one-lock-hold batch applies)."""
        if not rows:
            return
        self.publish(max(r[2] for r in rows),
                     [make_event(t, e, i, p) for t, e, i, p in rows])

    # ----------------------------------------------------------- subscribe

    def subscribe(self, topics: Optional[dict[str, list[str]]] = None,
                  index: int = 0, namespace: str = "") -> Subscription:
        """ref event_broker.go:138 Subscribe — replays buffered batches with
        index > `index` before going live."""
        sub = Subscription(self, topics or {}, namespace)
        with self._lock:
            # replay while holding the broker lock, BEFORE the sub becomes
            # visible to publish(), so batch order stays index-monotonic
            if index:
                for i, evs in self._buffer:
                    if i > index:
                        sub._offer(i, evs)
            self._subs.append(sub)
        return sub

    def _unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def latest_index(self) -> int:
        with self._lock:
            return self._latest_index

    def topic_index(self, topic: str) -> int:
        """Highest index that has published an event on `topic`."""
        with self._lock:
            if topic == TOPIC_ALL:
                return self._latest_index
            return self._topic_index.get(topic, 0)

    # ------------------------------------------------------------- parking

    def wait_for_index(self, topics: Union[dict, Iterable[str], None],
                       index: int, timeout: float = 30.0) -> int:
        """Park until an event on one of `topics` carries index > `index`;
        backpressure rung 2 for blocking queries.

        `topics` is a subscribe()-style dict (only the topic names are
        consulted — wakeups are topic-granular), an iterable of topic
        names, or None/"*" for any topic. Returns the highest published
        index across the watched topics at wake time, which may still be
        <= `index` on timeout: writes that emit no event (rare GC paths)
        move the store index without waking the broker, so callers keep
        a deadline re-check of their own index_fn. That bounded re-check
        is the correctness backstop; the broker is the fast path that
        avoids waking every watcher on every unrelated write."""
        names: Optional[list[str]] = None
        if topics:
            names = list(topics.keys() if isinstance(topics, dict)
                         else topics)
            if TOPIC_ALL in names:
                names = None

        def current_locked() -> int:
            if names is None:
                return self._latest_index
            return max((self._topic_index.get(t, 0) for t in names),
                       default=0)

        deadline = time.monotonic() + max(0.0, timeout)
        with self._pub_cond:
            cur = current_locked()
            if cur > index:
                return cur
            metrics.incr("nomad.event.waiters_parked")
            while cur <= index:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._pub_cond.wait(remaining)
                cur = current_locked()
            return cur


def make_event(topic: str, etype: str, index: int, payload) -> Event:
    """Derive key/namespace/filter-keys from the state object
    (ref nomad/state/events.go eventFromChange)."""
    key, ns, fkeys = "", "", []
    if isinstance(payload, tuple):          # (ns, job_id) deregister form
        ns, key = payload
        payload = {"ID": key, "Namespace": ns}
    else:
        key = getattr(payload, "id", "") or ""
        ns = getattr(payload, "namespace", "") or ""
        job_id = getattr(payload, "job_id", "") or ""
        node_id = getattr(payload, "node_id", "") or ""
        if job_id:
            fkeys.append(job_id)
        if node_id:
            fkeys.append(node_id)
    return Event(topic=topic, type=etype, key=key, namespace=ns,
                 filter_keys=fkeys, index=index, payload=payload)
