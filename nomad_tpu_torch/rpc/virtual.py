"""In-memory virtual RPC transport (ISSUE 6 tentpole).

The multi-server raft/operator tests were the standing tier-1 waiver:
real TCP sockets + real sleeps made elections race the GIL, port churn,
and CI load. This module replaces the wire with a process-local switch
whose failure modes are INJECTED, SEEDED, and INSTANT:

  * `VirtualNetwork` — the switchboard. `server(name)` mints a
    `VirtualRpcServer` (an `RpcDispatcher` with no socket) addressed as
    ``vrt/<name>``; `client(...)`/`client_for` mint `VirtualRpcClient`s
    whose calls are direct function calls through `deliver()`.
  * Link faults — `partition(*groups)`, `isolate(name)`,
    `drop(src, dst, p)` (asymmetric, per-link seeded RNG),
    `delay(src, dst, seconds)`, `flap(src, dst, period_s)` (the link
    cycles healthy/blocked on the network's clock: healthy for the
    first `period_s`, blocked for the next, repeating — a deterministic
    function of clock time, so ManualClock tests step a flap boundary
    exactly), `heal()`, and `crash(name)`/`restart(name)` for a member
    that vanishes mid-protocol. All are runtime-switchable, so a test
    can partition a leader mid-batch at an exact protocol step.

    Rules COMPOSE deterministically per delivery attempt, evaluated in a
    fixed order: crash -> partition/isolate -> flap phase -> delay ->
    drop. A slow lossy link (`delay` + `drop`) therefore costs its
    latency FIRST and may then lose the request — and the drop RNG is
    drawn exactly once per attempt from the per-link seeded stream, so
    the loss pattern for a given (seed, src, dst, attempt ordinal) is
    identical no matter which other rules are active.
  * Fault-plan integration — every hop fires the sites
    ``raft.transport.send.<src>.<dst>`` (request direction) and
    ``raft.transport.recv.<src>.<dst>`` (reply direction), so a
    NOMAD_FAULTS/`faults.install` plan can inject deterministic drops —
    including the nasty "request applied, reply lost" shape — with the
    same seeded `nth_call`/`after`/`probability` machinery every other
    site uses (docs/FAULT_INJECTION.md).
  * Codec fidelity — requests and responses round-trip through the real
    restricted-pickle codec, so each server gets its own object graph
    (no cross-server aliasing) and non-wire-safe payloads fail here
    exactly as they would on TCP.

Injected failures surface as ConnectionError/TimeoutError — the same
exceptions the TCP client raises — so raft replication, leader
forwarding, and client failover code run UNMODIFIED over this transport.
"""
from __future__ import annotations

import random
import threading
from typing import Optional

from .. import chrono, faults
from . import codec
from .client import RpcClient
from .server import DEFAULT_KEY, RpcDispatcher

ADDR_PREFIX = "vrt/"


class VirtualRpcServer(RpcDispatcher):
    """One cluster member's RPC surface on the virtual switch. Same
    registry/forwarding behavior as the TCP RpcServer (shared
    RpcDispatcher); `client_for` routes back through the network so
    raft replication and leader forwarding traverse the fault rules."""

    def __init__(self, network: "VirtualNetwork", name: str,
                 key: bytes = DEFAULT_KEY, logger=None):
        self._init_dispatch(key, logger=logger, tls=None)
        self.network = network
        self.name = name
        self.addr = ADDR_PREFIX + name
        self.closed = False
        # deadline shedding and the outbound breaker ride the network's
        # clock: one virtual timeline for envelope deadlines, link flaps,
        # and breaker cooldowns
        self.clock = network.clock
        self.rpc_breaker.clock = network.clock

    def client_for(self, addr: str, timeout: float = 30.0):
        return self.network.client([addr], src=self.name, key=self.key,
                                   timeout=timeout)

    def start(self) -> None:
        self.closed = False

    def shutdown(self) -> None:
        # a shut-down server must not answer — pooled "connections" on
        # the real wire die the same way
        self.closed = True


class VirtualRpcClient(RpcClient):
    """RpcClient over the switch: identical failover/redirect logic (it
    IS RpcClient), only the per-address hop is replaced."""

    def __init__(self, network: "VirtualNetwork", servers: list[str],
                 src: str = "client", key: bytes = DEFAULT_KEY,
                 timeout: float = 30.0, retry=None, breaker=None,
                 client_id: str = ""):
        # clock = the network's clock: retry backoff, deadline budgets,
        # and breaker cooldowns all compress under ManualClock with the
        # simulated links
        super().__init__(servers, key=key, timeout=timeout, tls=None,
                         clock=network.clock, retry=retry, breaker=breaker,
                         client_id=client_id)
        self.network = network
        self.src = src

    def _call_addr(self, addr: str, method: str, args, kwargs,
                   sock_timeout: Optional[float] = None,
                   region: str = "", deadline: Optional[float] = None,
                   dedup: Optional[str] = None):
        env = self._build_env(method, args, kwargs, region=region,
                              deadline=deadline, dedup=dedup)
        resp = self.network.deliver(self.src, addr, env,
                                    timeout=sock_timeout or self.timeout)
        return self._raise_for_response(resp)

    def close(self) -> None:
        pass                              # nothing pooled


class VirtualNetwork:
    """The switchboard + fault rules. All rule mutation is lock-guarded;
    delivery reads a consistent rule snapshot, then dispatches OUTSIDE
    the lock (a slow handler must not serialize the whole cluster)."""

    def __init__(self, seed: int = 0, clock: Optional[chrono.Clock] = None):
        self.seed = seed
        self.clock = clock or chrono.REAL
        self._lock = threading.Lock()
        self._servers: dict[str, VirtualRpcServer] = {}
        self._crashed: set[str] = set()
        self._blocked: set[tuple[str, str]] = set()     # (src, dst)
        self._drops: dict[tuple[str, str], float] = {}
        self._delays: dict[tuple[str, str], float] = {}
        # (src, dst) -> (period_s, phase_origin): see flap()
        self._flaps: dict[tuple[str, str], tuple[float, float]] = {}
        self._rngs: dict[tuple[str, str], random.Random] = {}

    # ----------------------------------------------------------- endpoints

    def server(self, name: str, key: bytes = DEFAULT_KEY,
               logger=None) -> VirtualRpcServer:
        with self._lock:
            srv = VirtualRpcServer(self, name, key=key, logger=logger)
            self._servers[name] = srv
            self._crashed.discard(name)
            return srv

    def client(self, servers: list[str], src: str = "client",
               key: bytes = DEFAULT_KEY, timeout: float = 30.0,
               retry=None, breaker=None,
               client_id: str = "") -> VirtualRpcClient:
        return VirtualRpcClient(self, servers, src=src, key=key,
                                timeout=timeout, retry=retry,
                                breaker=breaker, client_id=client_id)

    @staticmethod
    def name_of(addr: str) -> str:
        return addr[len(ADDR_PREFIX):] if addr.startswith(ADDR_PREFIX) \
            else addr

    # --------------------------------------------------------- fault rules

    def partition(self, *groups) -> None:
        """Sever every link between members of DIFFERENT groups (both
        directions). Names not listed in any group stay fully connected.
        Replaces previous cuts BETWEEN LISTED MEMBERS only — an earlier
        isolate() of an unlisted member survives (cuts compose; heal()
        clears everything); drops/delays are untouched."""
        gi: dict[str, int] = {}
        for i, group in enumerate(groups):
            for name in group:
                gi[name] = i
        with self._lock:
            self._blocked = {
                (a, b) for (a, b) in self._blocked
                if a not in gi or b not in gi}
            self._blocked |= {
                (a, b)
                for a in gi for b in gi
                if a != b and gi[a] != gi[b]}

    def isolate(self, name: str) -> None:
        """Sever every link to AND from one member."""
        with self._lock:
            peers = set(self._servers) | {n for pair in self._blocked
                                          for n in pair}
            for other in peers - {name}:
                self._blocked.add((name, other))
                self._blocked.add((other, name))

    def drop(self, src: str, dst: str, p: float = 1.0) -> None:
        """Asymmetric request loss on one directed link. p=1.0 is a hard
        one-way cut; p<1 draws from a per-link RNG seeded off
        (network seed, src, dst) — reproducible across runs."""
        with self._lock:
            self._drops[(src, dst)] = float(p)

    def delay(self, src: str, dst: str, seconds: float) -> None:
        with self._lock:
            self._delays[(src, dst)] = float(seconds)

    def flap(self, src: str, dst: str, period_s: float) -> None:
        """The directed link cycles on the network's clock: healthy for
        `period_s` (starting now), blocked for the next `period_s`,
        repeating. Phase is a pure function of clock time, so a
        ManualClock test advances exactly onto a boundary and a
        delivery attempt's outcome is reproducible."""
        if period_s <= 0:
            raise ValueError("flap period must be positive")
        with self._lock:
            self._flaps[(src, dst)] = (float(period_s),
                                       self.clock.monotonic())

    def heal(self) -> None:
        """Clear partitions, drops, delays, and flaps (crashed members
        stay crashed until restart())."""
        with self._lock:
            self._blocked.clear()
            self._drops.clear()
            self._delays.clear()
            self._flaps.clear()

    def crash(self, name: str) -> None:
        """The member vanishes mid-protocol: every in-flight and future
        delivery to or from it fails. Its server object (and any raft
        data_dir) survives for restart()."""
        with self._lock:
            self._crashed.add(name)

    def restart(self, name: str) -> None:
        with self._lock:
            self._crashed.discard(name)

    def _rng(self, src: str, dst: str) -> random.Random:
        key = (src, dst)
        rng = self._rngs.get(key)
        if rng is None:
            rng = self._rngs[key] = random.Random(
                f"{self.seed}:{src}:{dst}")
        return rng

    # ------------------------------------------------------------ delivery

    @staticmethod
    def _fire(direction: str, src: str, dst: str) -> None:
        """Fault-plan hook per hop. Injected failures are translated to
        the transport's native exceptions so callers' failover paths see
        exactly what a dead TCP link produces."""
        site = f"raft.transport.{direction}.{src}.{dst}"
        try:
            faults.fire(site)
        except TimeoutError:
            raise
        except BaseException as e:       # noqa: BLE001 — injected
            raise ConnectionError(f"injected fault at {site}") from e

    def deliver(self, src: str, dst_addr: str, env: dict,
                timeout: float = 30.0) -> dict:
        dst = self.name_of(dst_addr)
        with self._lock:
            server = self._servers.get(dst)
            dead = src in self._crashed or dst in self._crashed
            blocked = (src, dst) in self._blocked
            p = self._drops.get((src, dst), 0.0)
            lag = self._delays.get((src, dst), 0.0)
            flap = self._flaps.get((src, dst))
            rng = self._rng(src, dst) if p else None
        # the send site fires before rule checks so observed-call counts
        # include attempts into a partition (tests assert wiring that way)
        self._fire("send", src, dst)
        if server is None:
            raise ConnectionError(f"no virtual server at {dst_addr!r}")
        if dead:
            raise ConnectionError(f"virtual member crashed ({src}->{dst})")
        if blocked:
            raise ConnectionError(f"partitioned {src}->{dst}")
        if flap is not None:
            period, origin = flap
            # phase 0 = healthy, phase 1 = blocked (starts healthy)
            elapsed = self.clock.monotonic() - origin
            if int(elapsed / period) % 2 == 1:
                raise ConnectionError(f"link flap {src}->{dst} "
                                      f"(down phase @ {elapsed:.3f}s)")
        # composition order (module docstring): latency BEFORE loss — a
        # slow lossy link costs its lag, then may drop the request; the
        # drop RNG is drawn exactly once per attempt either way
        if lag:
            if lag >= timeout:
                self.clock.sleep(timeout)
                raise TimeoutError(f"link {src}->{dst} slower than "
                                   f"the {timeout}s call timeout")
            self.clock.sleep(lag)
        if p and rng.random() < p:
            raise ConnectionError(f"dropped {src}->{dst}")
        if server.closed:
            raise ConnectionError(f"virtual server {dst} is shut down")
        # real-wire fidelity: each side owns its object graph, and
        # non-picklable payloads fail here like they would on TCP
        req = codec.decode(codec.encode(env))
        resp = server._dispatch(req)
        # reply direction: the "request applied, reply lost" injection
        # point — fired after dispatch so state HAS changed on dst
        self._fire("recv", src, dst)
        with self._lock:
            # a crash() that landed while the handler ran loses the
            # reply too (the handler's state change stands — the torn-
            # protocol shape the docstring promises), and a reply into
            # a crashed caller is equally gone
            if src in self._crashed or dst in self._crashed:
                raise ConnectionError(
                    f"virtual member crashed mid-call ({src}->{dst})")
        return codec.decode(codec.encode(resp))
