"""RPC client: pooled connections with server failover, leader redirect,
bounded retry rounds with deadline propagation, and per-server breakers
(ref helper/pool/pool.go ConnPool, client/servers/manager.go server
registry, client/rpc.go RPC retry/failover + RPCHoldTimeout backoff).

ISSUE 18 partition tolerance, three client-side pieces:

  * every call computes an absolute `deadline` and stamps it into the
    request envelope; each hop's socket timeout is the REMAINING budget
    (never the full per-hop timeout again), and the server sheds work
    whose deadline already passed (rpc/server.py);
  * failed rounds over the failover list repeat up to
    `RetryPolicy.max_attempts` times with seeded exponential backoff,
    sleeping on the injectable clock (default policy is ONE round — the
    legacy walk-once behavior — because framework-internal clients like
    raft replication and leader forwarding carry their own retry
    discipline; `ServerRpc` opts into 3 rounds);
  * `RpcBreaker` short-circuits addresses that keep failing so a dead
    server costs one cooldown instead of one connect-timeout per call.

Idempotent writes (`call_write` / `_idempotent=True`) mint ONE dedup
token before the retry loop; every internal retry carries the same
token, so "applied but reply lost" resolves to the original result
server-side instead of a double apply (rpc/dedup.py).
"""
from __future__ import annotations

import socket
import threading
import uuid
from typing import Optional

from .. import chrono
from ..metrics import metrics
from .codec import (
    DeadlineExceededError, NotLeaderError, RateLimitError, RpcError,
    recv_msg, send_msg,
)
from .retry import RetryPolicy, RpcBreaker
from .server import DEFAULT_KEY


class RpcClient:
    """Thread-safe RPC caller over a set of candidate server addresses.

    A connection is checked out per call (pooled afterwards); on connection
    failure the next server is tried (ref client/servers/manager.go
    rebalancing is simplified to shuffle-on-failure). A NotLeaderError
    response carrying a leader address triggers one transparent retry
    against that leader.
    """

    def __init__(self, servers: list[str], key: bytes = DEFAULT_KEY,
                 timeout: float = 30.0, tls=None,
                 clock: Optional[chrono.Clock] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[RpcBreaker] = None,
                 client_id: str = ""):
        if not servers:
            raise ValueError("RpcClient needs at least one server address")
        self.key = key
        self.timeout = timeout
        # TLSConfig (tlsutil.py) or None; when set every connection is
        # wrapped before framing (ref helper/tlsutil OutgoingTLSConfig +
        # optional VerifyServerHostname against server.<region>.nomad)
        self.tls = tls
        self._tls_ctx = tls.client_context() if tls else None
        self.clock = clock or chrono.REAL
        # default policy = ONE round over the failover list (the legacy
        # behavior); callers that want partition tolerance pass a policy
        # with max_attempts > 1
        self.retry = retry or RetryPolicy(max_attempts=1, clock=self.clock)
        self.breaker = breaker or RpcBreaker(clock=self.clock)
        # stable per-process identity for idempotency tokens; chaos sims
        # pass an explicit id so token streams are seed-reproducible
        self.client_id = client_id or f"rpc-{uuid.uuid4().hex[:12]}"
        self._lock = threading.Lock()
        self._servers = list(servers)
        self._pool: dict[str, list[socket.socket]] = {}
        self._seq = 0
        self._req_id = 0

    # ------------------------------------------------------------- servers
    def set_servers(self, servers: list[str]) -> None:
        with self._lock:
            self._servers = list(servers)

    def servers(self) -> list[str]:
        with self._lock:
            return list(self._servers)

    # ----------------------------------------------------------- transport
    def _connect(self, addr: str) -> socket.socket:
        host, _, port = addr.rpartition(":")
        sock = socket.create_connection((host, int(port)), timeout=self.timeout)
        sock.settimeout(self.timeout)
        if self._tls_ctx is not None:
            sock = self._tls_ctx.wrap_socket(
                sock, server_hostname=self.tls.server_name)
        return sock

    def _checkout(self, addr: str) -> socket.socket:
        with self._lock:
            conns = self._pool.get(addr)
            if conns:
                return conns.pop()
        return self._connect(addr)

    def _checkin(self, addr: str, sock: socket.socket) -> None:
        with self._lock:
            self._pool.setdefault(addr, []).append(sock)

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _next_req_id(self) -> int:
        with self._lock:
            self._req_id += 1
            return self._req_id

    def _build_env(self, method: str, args, kwargs, region: str = "",
                   deadline: Optional[float] = None,
                   dedup: Optional[str] = None) -> dict:
        """Request envelope shared by the TCP and virtual transports so
        deterministic partition tests exercise EXACTLY the production
        wire shape (deadline + dedup stamps included)."""
        env = {"seq": self._next_seq(), "method": method, "args": args,
               "kwargs": kwargs}
        if region:
            # cross-region routing stamp (ref nomad/rpc.go
            # forwardRegion; every reference RPC carries Region)
            env["region"] = region
        if deadline is not None:
            # absolute wall-clock deadline (caller's clock.time()); every
            # downstream hop sheds the request once this passes
            env["deadline"] = deadline
        if dedup is not None:
            env["dedup"] = dedup
        return env

    def _call_addr(self, addr: str, method: str, args, kwargs,
                   sock_timeout: Optional[float] = None,
                   region: str = "", deadline: Optional[float] = None,
                   dedup: Optional[str] = None):
        resp = None
        for attempt in (0, 1):
            with self._lock:
                pooled = bool(self._pool.get(addr))
            sock = self._checkout(addr)
            try:
                sock.settimeout(sock_timeout or self.timeout)
                env = self._build_env(method, args, kwargs, region=region,
                                      deadline=deadline, dedup=dedup)
                send_msg(sock, env, self.key)
                resp = recv_msg(sock, self.key)
                break
            except BaseException as e:
                try:
                    sock.close()
                except OSError:
                    pass
                # a stale pooled socket (server restarted / idle-closed)
                # gets one retry on a fresh connection
                if attempt == 0 and pooled and \
                        isinstance(e, (ConnectionError, OSError)):
                    continue
                raise
        self._checkin(addr, sock)
        return self._raise_for_response(resp)

    @staticmethod
    def _raise_for_response(resp):
        """Response envelope -> result or exception. Shared with the
        virtual transport client (rpc/virtual.py) so the deterministic
        failover tests exercise EXACTLY the production error mapping."""
        if resp.get("kind") == "NotLeaderError":
            raise NotLeaderError(resp.get("error") or "")
        if resp.get("kind") == "DeadlineExceededError":
            # server shed the request past its deadline: typed so the
            # retry loop knows there is no budget left to spend
            raise DeadlineExceededError(resp.get("error") or
                                        "rpc deadline exceeded")
        if resp.get("kind") == "RateLimitError":
            # admission rejection (ISSUE 8): typed so callers can back
            # off for the server's hinted interval instead of retrying
            # against another server (the limit is per ingress door, but
            # hammering siblings is exactly what shed load must not do)
            raise RateLimitError(resp.get("error") or "rate limited",
                                 retry_after_s=resp.get("retry_after", 1.0))
        if "error" in resp and resp["error"] is not None \
                and "result" not in resp:
            raise RpcError(resp["error"], kind=resp.get("kind", "RpcError"))
        return resp.get("result")

    # ---------------------------------------------------------------- call
    def call(self, method: str, *args, **kwargs):
        return self.call_timeout(None, method, *args, **kwargs)

    def call_write(self, method: str, *args, **kwargs):
        """A mutating call carrying an idempotency token: safe to retry
        through lost replies — the server dedups on `(client_id, req_id)`
        and returns the ORIGINAL committed result (rpc/dedup.py)."""
        return self.call_timeout(None, method, *args, _idempotent=True,
                                 **kwargs)

    def _failover_order(self) -> list[str]:
        # deterministic preference for the first configured server keeps
        # -dev single-server behavior snappy; the seeded-shuffled
        # remainder is the failover order (dedup'd so a dead first server
        # costs one timeout)
        first = self.servers()[:1]
        rest = [a for a in self.servers() if a not in first]
        self.retry.shuffle_tail(rest)
        return first + rest

    def call_timeout(self, sock_timeout: Optional[float], method: str,
                     *args, _region: str = "", _deadline: Optional[float] = None,
                     _idempotent: bool = False,
                     _forward_dedup: Optional[str] = None, **kwargs):
        """Like call(); sock_timeout overrides the per-connection socket
        timeout for this call (long-polls must out-wait the server hold).
        `_region` stamps the envelope for cross-region forwarding.

        `_deadline` is an absolute clock.time() budget for the WHOLE call
        including retries (default: now + per-hop timeout); each hop's
        socket timeout is clipped to the remaining budget and the
        envelope carries the deadline so servers shed expired work.
        `_idempotent` mints one dedup token reused by every retry;
        `_forward_dedup` instead carries a token minted UPSTREAM (a
        follower proxying a stamped request to the leader)."""
        per_hop = sock_timeout or self.timeout
        clock = self.clock
        deadline = _deadline if _deadline is not None \
            else clock.time() + per_hop
        dedup_tok = _forward_dedup if _forward_dedup is not None else (
            f"{self.client_id}:{self._next_req_id()}"
            if _idempotent else None)
        last_err: Optional[Exception] = None
        for round_idx in range(self.retry.max_attempts):
            if round_idx > 0:
                remaining = deadline - clock.time()
                if remaining <= 0:
                    break
                metrics.incr("nomad.rpc.retries")
                clock.sleep(min(self.retry.backoff_s(round_idx - 1),
                                remaining))
            candidates = self._failover_order()
            admitted = [a for a in candidates if self.breaker.admit(a)]
            if not admitted:
                # availability floor: every breaker open must never mean
                # "no servers tried" — force one probe of the preferred
                admitted = candidates[:1]
            for addr in admitted:
                remaining = deadline - clock.time()
                if remaining <= 0:
                    break
                hop_timeout = min(per_hop, remaining)
                try:
                    result = self._call_addr(
                        addr, method, args, kwargs,
                        sock_timeout=hop_timeout, region=_region,
                        deadline=deadline, dedup=dedup_tok)
                    self.breaker.record_success(addr)
                    return result
                except NotLeaderError as e:
                    # the server ANSWERED (transport healthy) — a leader
                    # redirect is not a breaker failure
                    self.breaker.record_success(addr)
                    if e.leader_addr and e.leader_addr != addr:
                        try:
                            result = self._call_addr(
                                e.leader_addr, method, args, kwargs,
                                sock_timeout=min(
                                    per_hop,
                                    max(0.001, deadline - clock.time())),
                                region=_region, deadline=deadline,
                                dedup=dedup_tok)
                            self.breaker.record_success(e.leader_addr)
                            return result
                        except RpcError as e2:
                            if e2.kind != "RetryableError":
                                raise
                            last_err = e2
                            continue
                        except NotLeaderError as e2:
                            # leadership moved again mid-call: keep trying
                            # the remaining servers, which may know the
                            # new leader
                            last_err = e2
                            continue
                        except (ConnectionError, OSError,
                                TimeoutError) as e2:
                            self.breaker.record_failure(e.leader_addr)
                            metrics.incr("nomad.rpc.failovers")
                            last_err = e2
                            continue
                    last_err = e
                except RpcError as e:
                    if e.kind != "RetryableError":
                        raise   # includes DeadlineExceededError: no budget
                    last_err = e  # stale-leader forward: try next server
                except (ConnectionError, OSError, TimeoutError) as e:
                    self.breaker.record_failure(addr)
                    metrics.incr("nomad.rpc.failovers")
                    last_err = e
        if deadline - clock.time() <= 0 and \
                (last_err is None or self.retry.max_attempts > 1):
            # budget gone: retrying clients surface the typed deadline
            # error; legacy single-round clients keep their original
            # transport error type below for back-compat
            raise DeadlineExceededError(
                f"rpc deadline exceeded calling {method} "
                f"(last error: {last_err!r})") from last_err
        raise last_err if last_err else RpcError("no servers available")

    def close(self) -> None:
        with self._lock:
            for conns in self._pool.values():
                for sock in conns:
                    try:
                        sock.close()
                    except OSError:
                        pass
            self._pool.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ServerRpc:
    """The client node's view of the control plane over the network — the
    same duck-typed surface Client uses in-process (ref client/rpc.go: the
    client RPCs Node.Register / Node.UpdateStatus / Node.GetClientAllocs /
    Alloc.GetAlloc / Node.UpdateAlloc through its server list)."""

    #: retry rounds for the client->server control plane: the reference
    #: client retries RPCs through partitions (client/rpc.go canRetry),
    #: so ServerRpc opts into 3 failover rounds with seeded backoff
    RETRY_ROUNDS = 3

    def __init__(self, servers: list[str], key: bytes = DEFAULT_KEY,
                 timeout: float = 30.0, tls=None,
                 clock: Optional[chrono.Clock] = None,
                 client_id: str = "", retry_seed: int = 0):
        clock = clock or chrono.REAL
        self.rpc = RpcClient(
            servers, key=key, timeout=timeout, tls=tls, clock=clock,
            retry=RetryPolicy(max_attempts=self.RETRY_ROUNDS,
                              seed=retry_seed, clock=clock),
            client_id=client_id)

    # mutating RPCs go through call_write so a reply lost to a partition
    # is retried with the SAME dedup token — exactly-once commit of node
    # status flips, alloc updates, and service (de)registrations

    def node_register(self, node):
        return self.rpc.call_write("Node.Register", node)

    def node_update_status(self, node_id: str, status: str):
        return self.rpc.call_write("Node.UpdateStatus", node_id, status)

    def node_get_client_allocs(self, node_id: str, min_index: int = 0,
                               timeout: float = 30.0):
        # long-poll: the server may hold the call up to `timeout`, so the
        # socket deadline must strictly exceed the hold time
        return self.rpc.call_timeout(timeout + 15.0, "Node.GetClientAllocs",
                                     node_id, min_index=min_index,
                                     timeout=timeout)

    def alloc_get(self, alloc_id: str):
        return self.rpc.call("Alloc.GetAlloc", alloc_id)

    def node_get_http_addr(self, node_id: str) -> str:
        return self.rpc.call("Node.GetHTTPAddr", node_id)

    def csi_volume_get(self, namespace: str, volume_id: str):
        return self.rpc.call("CSIVolume.Get", namespace, volume_id)

    def csi_volume_claim(self, namespace: str, volume_id: str, claim):
        return self.rpc.call("CSIVolume.Claim", namespace, volume_id, claim)

    def intention_allowed(self, namespace: str, source: str,
                          destination: str) -> bool:
        return self.rpc.call("Intention.Allowed", namespace, source,
                             destination)

    def csi_node_detach_pending(self, node_id: str):
        return self.rpc.call("CSIVolume.NodeDetachPending", node_id)

    def csi_controller_detach_pending(self, plugin_ids: list,
                                      node_id: str = ""):
        return self.rpc.call("CSIVolume.ControllerDetachPending",
                             plugin_ids, node_id)

    def vault_derive_token(self, alloc_id: str, task: str):
        return self.rpc.call("Vault.DeriveToken", alloc_id, task)

    def derive_si_token(self, alloc_id: str, task: str):
        return self.rpc.call("Node.DeriveSIToken", alloc_id, task)

    def vault_renew_token(self, token: str):
        return self.rpc.call("Vault.RenewToken", token)

    def vault_revoke_token(self, token: str):
        return self.rpc.call("Vault.RevokeToken", token)

    def secret_read(self, path: str):
        return self.rpc.call("Vault.Read", path)

    def service_register(self, instances):
        return self.rpc.call_write("Service.Register", instances)

    def service_deregister(self, alloc_id: str = "", keys=None):
        return self.rpc.call_write("Service.Deregister", alloc_id, keys)

    def service_instances(self, namespace: str, name: str):
        return self.rpc.call("Service.Instances", namespace, name)

    def node_update_allocs(self, allocs):
        return self.rpc.call_write("Node.UpdateAlloc", allocs)

    # ------------------------------------------------------------ read plane
    # ISSUE 16: list/get off any server. With stale=False a follower
    # answers NotLeaderError and call_timeout retries transparently
    # against the leader, so the default stays leader-consistent; with
    # stale=True whichever server answers first serves from its local
    # replicated store and stamps QueryMeta accordingly.

    def read_list(self, table: str, namespace=None, stale: bool = False,
                  max_stale_index: int = 0, fields=None,
                  columnar: bool = False, timeout: float = 5.0):
        return self.rpc.call_timeout(
            timeout + 15.0, "Read.List", table, namespace=namespace,
            stale=stale, max_stale_index=max_stale_index, fields=fields,
            columnar=columnar, timeout=timeout)

    def read_get(self, table: str, key: str, namespace: str = "default",
                 stale: bool = False, max_stale_index: int = 0,
                 timeout: float = 5.0):
        return self.rpc.call_timeout(
            timeout + 15.0, "Read.Get", table, key, namespace=namespace,
            stale=stale, max_stale_index=max_stale_index, timeout=timeout)

    def close(self) -> None:
        self.rpc.close()
