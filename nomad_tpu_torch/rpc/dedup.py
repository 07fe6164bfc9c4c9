"""Idempotent write dedup for mutating RPCs (ISSUE 18 tentpole).

The "request applied, reply lost" failure shape: a client write reaches
the leader, raft commits it, and the reply frame dies on the wire. The
client sees ConnectionError and retries — without dedup the retry is a
SECOND raft entry and the node status flip / alloc update / service
registration double-applies. The reference design (Nomad's ensureRegistration
idempotency, raft's session-based dedup) answers with a per-request token
checked at apply time.

How a token flows here:

  1. `RpcClient.call_timeout(..., _idempotent=True)` mints ONE token
     `"<client_id>:<request_id>"` before its retry loop — every internal
     retry of the same logical write carries the SAME token.
  2. The request envelope carries it as `env["dedup"]`; the dispatcher
     (rpc/server.py) consults `WriteDedup.lookup()` BEFORE invoking the
     handler. Hit => return the original committed result, no handler
     call, no second raft entry (`nomad.rpc.dedup_hits`).
  3. Miss => the dispatcher wraps the handler call in
     `WriteDedup.pending(token)`, which parks the token in a
     thread-local. Deep below, `RaftNode.apply` / `RaftLog.apply` call
     `stamp(payload)` right before appending — the token RIDES THE
     ENTRY as `payload["_dedup"]` (the PR-10 eval-piggyback pattern:
     one entry, atomically replicated, no second consensus round).
  4. `NomadFSM.apply` records `(token -> index)` into the replicated
     `StateStore.rpc_dedup` table on EVERY server. After a failover the
     new leader's dedup table already knows the ack — a retry against
     it returns `{"index": i, "deduped": True}` instead of re-applying.
  5. On handler success the dispatcher caches the FULL result in a
     bounded local LRU (authoritative while this leader lives; the
     replicated table is the failover fallback, which keeps only the
     index — replicating arbitrary result blobs would bloat the log).

Only the FIRST apply of a multi-apply handler is stamped: the token
marks "this request reached the state machine at least once", which is
exactly the double-apply guard the retry path needs.

`stamp()` must never mutate or pop from the caller's payload: the same
dict object is already referenced by the in-memory log entry headed to
followers, and stripping the token there would desync follower dedup
tables from the leader's.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional

from ..metrics import metrics

# local result-LRU bound — big enough to cover every in-flight retry
# window at chaos load, small enough that a leader never holds more than
# a few MB of acked results
DEDUP_RESULT_CAP = 1024

_PENDING = threading.local()

_MISS = object()


def stamp(payload: Any) -> Any:
    """Attach the calling thread's pending dedup token to a raft payload.

    Called from `RaftNode.apply` / `RaftLog.apply` immediately before the
    entry is built. Returns a NEW dict with `_dedup` set (never mutates
    the input), and consumes the token so only the first apply of a
    multi-apply handler is stamped. No pending token (the overwhelmingly
    common case: internal writes, non-idempotent RPCs) => payload is
    returned unchanged, zero-copy."""
    tok = getattr(_PENDING, "token", None)
    if tok is None or not isinstance(payload, dict):
        return payload
    _PENDING.token = None
    return {**payload, "_dedup": tok}


def peek_pending() -> Optional[str]:
    """Test/debug hook: the calling thread's unconsumed token, if any."""
    return getattr(_PENDING, "token", None)


class WriteDedup:
    """Bounded LRU of committed write results keyed by dedup token,
    backed by the replicated `StateStore.rpc_dedup` table for failover.

    One instance per server process, shared by the TCP and virtual
    dispatchers (wired in `Server.rpc_listen*`)."""

    def __init__(self, state, cap: int = DEDUP_RESULT_CAP):
        self._state = state
        self._cap = int(cap)
        self._lock = threading.Lock()
        self._results: OrderedDict[str, Any] = OrderedDict()
        self._hits = 0
        self._recorded = 0

    class _Pending:
        def __init__(self, token: Optional[str]):
            self._token = token

        def __enter__(self):
            _PENDING.token = self._token
            return self

        def __exit__(self, *exc):
            # always clear: an exception between stamp and commit must
            # not leak the token onto the next request on this thread
            _PENDING.token = None
            return False

    def pending(self, token: Optional[str]) -> "WriteDedup._Pending":
        """Context manager arming `stamp()` for the handler call."""
        return WriteDedup._Pending(token)

    def lookup(self, token: str) -> Any:
        """Committed result for `token`, or the `MISS` sentinel.

        Local LRU first (full original result — authoritative while this
        leader lives), then the replicated table (index-only ack: the
        entry committed, the blob didn't survive the failover). Callers
        compare against `WriteDedup.MISS`."""
        with self._lock:
            if token in self._results:
                self._results.move_to_end(token)
                self._hits += 1
                metrics.incr("nomad.rpc.dedup_hits")
                return self._results[token]
        idx = self._state.rpc_dedup_get(token)
        if idx is not None:
            with self._lock:
                self._hits += 1
            metrics.incr("nomad.rpc.dedup_hits")
            return {"index": idx, "deduped": True}
        return _MISS

    MISS = _MISS

    def record(self, token: str, result: Any) -> None:
        """Cache the full result after a SUCCESSFUL handler run. Failures
        are never recorded — the retry should re-attempt, and the raft
        fence/not-leader taxonomy already tells the client what's safe."""
        with self._lock:
            self._results[token] = result
            self._results.move_to_end(token)
            self._recorded += 1
            while len(self._results) > self._cap:
                self._results.popitem(last=False)

    def stats(self) -> dict:
        with self._lock:
            local = len(self._results)
            hits = self._hits
            recorded = self._recorded
        return {
            "LocalResults": local,
            "LocalCap": self._cap,
            "Hits": hits,
            "Recorded": recorded,
            "ReplicatedTokens": self._state.rpc_dedup_len(),
        }
