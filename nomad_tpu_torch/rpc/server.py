"""RPC server: threaded TCP listener dispatching named methods to registered
handlers, with transparent leader forwarding for leader-only methods (ref
nomad/rpc.go:341 handleConn / :450 forward, nomad/server.go:1146
setupRpcServer).

The dispatch/forwarding logic lives in `RpcDispatcher`, shared by the TCP
server here and the in-memory `rpc/virtual.py` transport the deterministic
multi-server tests ride (ISSUE 6): both route outbound hops through
`client_for`, so follower->leader and cross-region forwarding behave
identically over either transport.

ISSUE 18 partition tolerance, server side:

  * **deadline shed** — a request whose envelope `deadline` already
    passed is answered with `DeadlineExceededError` WITHOUT invoking the
    handler (checked twice: on arrival — before the admission ladder even
    spends a token on doomed work — and again after the leader-discovery
    wait, so a queued write nobody is waiting for never consumes raft
    throughput; composes with the ISSUE-8 overload ladder);
  * **write dedup** — requests stamped `dedup` are checked against the
    `WriteDedup` cache before the handler runs; a hit returns the
    original committed result (exactly-once through lost replies);
  * forwarded hops (`_forward`) propagate BOTH stamps so the leader
    applies the same shed/dedup discipline.
"""
from __future__ import annotations

import socket
import socketserver
import ssl
import threading
import time
from typing import Callable, Optional

from .. import chrono, faults
from ..metrics import metrics
from .codec import (FrameError, NotLeaderError, RpcError, recv_msg, send_msg)

DEFAULT_KEY = b"nomad-tpu-dev-cluster-key"


class RpcDispatcher:
    """Transport-independent half of an RPC server: the handler registry,
    leader/region forwarding, and the dispatch loop body. Subclasses
    provide `addr` and `client_for` (how to reach another server)."""

    addr: str = ""

    def _init_dispatch(self, key: bytes, logger=None, tls=None) -> None:
        self.key = key
        self.logger = logger or (lambda msg: None)
        self.tls = tls
        self._handlers: dict[str, tuple[Callable, bool]] = {}
        # ingress admission hook (ISSUE 8): (method, leader_only) -> None
        # or raise something with `retry_after_s`. Wired by the Server to
        # its OverloadController; None (the default) admits everything.
        self.admission_fn: Optional[Callable] = None
        # wired by the consensus layer: () -> (is_leader, leader_rpc_addr)
        self.leadership_fn: Callable[[], tuple[bool, str]] = lambda: (True, "")
        # cross-region forwarding (ref nomad/rpc.go forwardRegion): wired
        # by Server.gossip_listen — requests stamped with a different
        # region are proxied to a known server of that region
        self.region = ""
        self.region_servers_fn: Callable[[], dict] = lambda: {}
        # deadline arithmetic ONLY (comparisons, never sleeps): virtual
        # transports repoint this at the network's ManualClock so
        # envelope deadlines and server shedding share one timeline
        self.clock: chrono.Clock = chrono.REAL
        # WriteDedup (rpc/dedup.py), wired by Server.rpc_listen*; None
        # (the default) dispatches every request to its handler
        self.dedup = None
        # per-process breaker for OUTBOUND hops (leader/region forwards);
        # shared across client_for handles so failure history accumulates
        from .retry import RpcBreaker
        self.rpc_breaker = RpcBreaker(clock=self.clock)

    # ------------------------------------------------------------ registry
    def register(self, method: str, fn: Callable,
                 leader_only: bool = False) -> None:
        self._handlers[method] = (fn, leader_only)

    def register_endpoints(self, obj, spec: dict[str, tuple[str, bool]]) -> None:
        """spec: {"Node.Register": ("node_register", leader_only), ...}"""
        for method, (attr, leader_only) in spec.items():
            self.register(method, getattr(obj, attr), leader_only=leader_only)

    # ------------------------------------------------------------ transport
    def client_for(self, addr: str, timeout: float = 30.0):
        """An RpcClient-compatible handle on one peer address. The ONLY
        way framework code (raft replication, forwarding) dials out, so
        the virtual transport can intercept every hop."""
        from .client import RpcClient
        return RpcClient([addr], key=self.key, timeout=timeout,
                         tls=self.tls, clock=self.clock,
                         breaker=self.rpc_breaker)

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, req) -> dict:
        if not isinstance(req, dict) or "method" not in req:
            return {"seq": None, "error": "malformed request",
                    "kind": "FrameError"}
        seq = req.get("seq")
        method = req["method"]
        want_region = req.get("region", "")
        if want_region and self.region and want_region != self.region:
            fwd = self._forward_region(method, req, want_region)
            fwd["seq"] = seq
            return fwd
        entry = self._handlers.get(method)
        if entry is None:
            return {"seq": seq, "error": f"unknown rpc method {method!r}",
                    "kind": "RpcError"}
        fn, leader_only = entry
        rpc_deadline = req.get("deadline")
        if self._deadline_passed(rpc_deadline):
            # shed BEFORE admission: no rate-limit token, no handler, no
            # raft throughput for a result nobody is waiting for
            return self._shed(seq, method)
        if self.admission_fn is not None:
            # admission BEFORE leader forwarding: an over-rate write is
            # rejected at whichever server it hit, not proxied to pile
            # onto the leader (the leader's own dispatcher admits again
            # for forwarded traffic — both doors are guarded)
            try:
                self.admission_fn(method, leader_only)
            except Exception as e:      # noqa: BLE001 — envelope, not raise
                retry = getattr(e, "retry_after_s", None)
                if retry is None:
                    # a controller BUG is not throttling: surface the
                    # real error kind so callers fail fast instead of
                    # treating an internal error as a backoff-forever
                    # rate limit
                    return {"seq": seq, "error": str(e),
                            "kind": type(e).__name__}
                return {"seq": seq, "error": str(e),
                        "kind": "RateLimitError", "retry_after": retry}
        if leader_only:
            is_leader, leader_addr = self.leadership_fn()
            if not is_leader and not leader_addr:
                # no known leader yet (mid-election): wait briefly for
                # discovery instead of bouncing the caller
                # (ref nomad/rpc.go:450 forward retries on ErrNoLeader).
                # Deliberately REAL time, not self.clock: under a frozen
                # ManualClock a virtual-time wait here would deadlock the
                # delivering thread; the rpc deadline (caller's clock)
                # still bounds the hold via the re-check below.
                wait_until = time.monotonic() + 2.0
                while time.monotonic() < wait_until:
                    time.sleep(0.05)
                    is_leader, leader_addr = self.leadership_fn()
                    if is_leader or leader_addr:
                        break
                    if self._deadline_passed(rpc_deadline):
                        break
            if not is_leader:
                fwd = self._forward(method, req, leader_addr)
                if fwd is not None:
                    fwd["seq"] = seq
                    return fwd
                return {"seq": seq, "error": leader_addr,
                        "kind": "NotLeaderError"}
        if self._deadline_passed(rpc_deadline):
            # re-check after the (real-time) leader-discovery wait: the
            # budget may have drained while we held the request
            return self._shed(seq, method)
        dedup_tok = req.get("dedup")
        if dedup_tok is not None and self.dedup is not None:
            cached = self.dedup.lookup(dedup_tok)
            if cached is not self.dedup.MISS:
                # retry of an already-committed write: return the
                # original result, never re-apply
                return {"seq": seq, "result": cached}
        faults.fire(f"rpc.server.handler.{method}")
        try:
            if dedup_tok is not None and self.dedup is not None:
                with self.dedup.pending(dedup_tok):
                    result = fn(*req.get("args", ()),
                                **req.get("kwargs", {}))
                self.dedup.record(dedup_tok, result)
            else:
                result = fn(*req.get("args", ()), **req.get("kwargs", {}))
            return {"seq": seq, "result": result}
        except NotLeaderError as e:
            return {"seq": seq, "error": e.leader_addr, "kind": "NotLeaderError"}
        except Exception as e:   # noqa: BLE001
            return {"seq": seq, "error": str(e), "kind": type(e).__name__}

    # -------------------------------------------------- deadline shedding
    def _deadline_passed(self, deadline) -> bool:
        if deadline is None:
            return False
        try:
            return self.clock.time() >= float(deadline)
        except (TypeError, ValueError):
            return False        # garbage stamp: dispatch normally

    def _shed(self, seq, method: str) -> dict:
        metrics.incr("nomad.rpc.deadline_exceeded")
        # method names come from the fixed handler registry (bounded set)
        metrics.incr(f"nomad.rpc.deadline_exceeded.{method}")  # nomadlint: disable=OBS001 — dimension bounded by the RPC handler registry
        return {"seq": seq,
                "error": f"deadline exceeded before {method} dispatched",
                "kind": "DeadlineExceededError"}

    def _forward_region(self, method: str, req, region: str) -> dict:
        """Proxy to a server of the requested region (ref nomad/rpc.go
        forwardRegion: pick a random known server there)."""
        import random
        servers = self.region_servers_fn().get(region, {})
        addrs = [a for a in servers.values() if a]
        if not addrs:
            return {"error": f"no path to region {region!r}",
                    "kind": "NoRegionPathError"}
        from .codec import RpcError
        random.shuffle(addrs)
        last = None
        for addr in addrs[:3]:
            try:
                with self.client_for(addr) as cli:
                    # the target is in `region`, so it serves locally —
                    # the stamp is kept for integrity, not re-forwarded
                    return {"result": cli.call(
                        method, *req.get("args", ()),
                        _region=region, **req.get("kwargs", {}))}
            except RpcError as e:
                # the remote HANDLER answered (e.g. validation error):
                # deterministic — pass it through verbatim, never replay
                # a possibly non-idempotent write against another server
                return {"error": str(e), "kind": e.kind}
            except (ConnectionError, OSError, TimeoutError) as e:
                last = e                # transport failure: try another
        return {"error": f"region {region!r} forward failed: {last}",
                "kind": "RetryableError"}

    def _forward(self, method: str, req, leader_addr: str) -> Optional[dict]:
        """Proxy a leader-only call to the leader (ref nomad/rpc.go:450).

        The deadline and dedup stamps ride the forwarded hop verbatim:
        the leader sheds the same expired work this follower would, and
        a forwarded retry of a committed write still dedups (the token
        lives in the REPLICATED table, so the leader knows acks this
        follower relayed before a partition)."""
        if not leader_addr or leader_addr == self.addr:
            return None
        try:
            with self.client_for(leader_addr) as cli:
                return {"result": cli.call_timeout(
                    None, method, *req.get("args", ()),
                    _deadline=req.get("deadline"),
                    _forward_dedup=req.get("dedup"),
                    **req.get("kwargs", {}))}
        except NotLeaderError as e:
            return {"error": e.leader_addr, "kind": "NotLeaderError"}
        except Exception as e:   # noqa: BLE001
            # RetryableError tells the caller to try another server — the
            # advertised leader may have just died (stale leader_addr)
            return {"error": f"leader forward failed: {e}",
                    "kind": "RetryableError"}


class RpcServer(RpcDispatcher):
    """One per agent process. Handlers are registered as
    ``register("Node.Register", fn, leader_only=True)``; leader-only calls
    arriving on a follower are proxied to the current leader (server-side
    forwarding, matching the reference) when ``leader_addr_fn`` names one.
    """

    def __init__(self, bind: str = "127.0.0.1", port: int = 0,
                 key: bytes = DEFAULT_KEY, logger=None, tls=None):
        # TLSConfig (tlsutil.py) or None; when set, every accepted
        # connection is wrapped in mutual TLS before framing begins (ref
        # nomad/rpc.go listen → tlsutil IncomingTLSConfig), and outbound
        # forwards dial with the client context
        self._init_dispatch(key, logger=logger, tls=tls)
        self._tls_server_ctx = tls.server_context() if tls else None
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock: socket.socket = self.request
                # idle/trickle connections may not pin a thread (and up to
                # MAX_FRAME of pre-auth buffer) forever
                sock.settimeout(300.0)
                if outer._tls_server_ctx is not None:
                    try:
                        sock = outer._tls_server_ctx.wrap_socket(
                            sock, server_side=True)
                    except (ssl.SSLError, OSError) as e:
                        outer.logger(f"rpc: tls handshake failed: {e}")
                        return
                try:
                    while True:
                        try:
                            req = recv_msg(sock, outer.key)
                        except (ConnectionError, OSError):
                            return
                        except FrameError as e:
                            outer.logger(f"rpc: bad frame: {e}")
                            return
                        resp = outer._dispatch(req)
                        try:
                            send_msg(sock, resp, outer.key)
                        except (ConnectionError, OSError):
                            return
                except Exception as e:   # noqa: BLE001
                    outer.logger(f"rpc: connection error: {e!r}")

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._tcp = _Server((bind, port), _Handler)
        self.addr = "%s:%d" % self._tcp.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True, name="rpc-server")
        self._thread.start()

    def shutdown(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()
