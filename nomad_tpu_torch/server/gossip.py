"""Gossip membership: SWIM-style failure detection + state dissemination
over UDP (the Serf/memberlist tier, ref nomad/server.go:1388 setupSerf,
nomad/serf.go nodeJoin/nodeFailed, hashicorp/memberlist).

Design (one pool, region-tagged — NOT a translation of the reference's
two-pool LAN/WAN split): every server joins a single gossip pool carrying
tags {role, region, rpc_addr, id}. Same-region members feed Raft peer
management (the LAN pool's job); cross-region members feed the federation
routing table (the WAN pool's job). One SWIM loop does both.

Protocol per period (SWIM):
  * ping a random member, piggybacking pending membership updates;
  * no ack -> ask k random members to ping it for us (indirect probe);
  * still nothing -> broadcast SUSPECT; unrefuted suspicion times out
    to DEAD (failure detected);
  * a member hearing itself suspected refutes with a higher incarnation.
Joins do a full push-pull state sync with a seed, then spread via
piggybacked ALIVE updates.

Messages are HMAC-authenticated JSON datagrams under the cluster key —
unauthenticated packets are dropped before parsing.
"""
from __future__ import annotations

import hashlib
import hmac
import json
import random
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"
LEFT = "left"


@dataclass
class Member:
    name: str
    host: str
    port: int
    incarnation: int = 0
    status: str = ALIVE
    tags: dict = field(default_factory=dict)
    status_time: float = 0.0

    @property
    def addr(self) -> tuple:
        return (self.host, self.port)

    def to_wire(self) -> dict:
        return {"name": self.name, "host": self.host, "port": self.port,
                "inc": self.incarnation, "status": self.status,
                "tags": self.tags}

    @staticmethod
    def from_wire(d: dict) -> "Member":
        return Member(name=d["name"], host=d["host"], port=int(d["port"]),
                      incarnation=int(d.get("inc", 0)),
                      status=d.get("status", ALIVE),
                      tags=dict(d.get("tags", {})))


class Gossip:
    def __init__(self, name: str, bind: str = "127.0.0.1", port: int = 0,
                 tags: Optional[dict] = None, key: bytes = b"nomad-tpu-dev",
                 interval: float = 0.3, suspect_timeout: float = 2.0,
                 probe_timeout: float = 0.5, sync_interval: float = 2.0,
                 logger=None,
                 on_join: Optional[Callable] = None,
                 on_leave: Optional[Callable] = None,
                 on_fail: Optional[Callable] = None):
        self.name = name
        self.key = key
        self.interval = interval
        self.suspect_timeout = suspect_timeout
        self.probe_timeout = probe_timeout
        self.sync_interval = sync_interval
        self._last_sync = 0.0
        self.logger = logger or (lambda msg: None)
        self.on_join = on_join or (lambda m: None)
        self.on_leave = on_leave or (lambda m: None)
        self.on_fail = on_fail or (lambda m: None)

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((bind, port))
        self._sock.settimeout(0.2)
        self.host, self.port = self._sock.getsockname()[:2]

        self._lock = threading.RLock()
        self.members: dict[str, Member] = {}
        me = Member(name=name, host=self.host, port=self.port,
                    incarnation=1, tags=dict(tags or {}),
                    status_time=time.monotonic())
        self.members[name] = me
        # pending updates to piggyback: name -> (retransmits left, member)
        self._updates: dict[str, list] = {}
        self._acks: dict[int, threading.Event] = {}
        self._seq = 0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------- wire

    def _pack(self, msg: dict) -> bytes:
        raw = json.dumps(msg, separators=(",", ":")).encode()
        sig = hmac.new(self.key, raw, hashlib.sha256).digest()[:16]
        return sig + raw

    def _unpack(self, data: bytes) -> Optional[dict]:
        if len(data) < 16:
            return None
        sig, raw = data[:16], data[16:]
        want = hmac.new(self.key, raw, hashlib.sha256).digest()[:16]
        if not hmac.compare_digest(sig, want):
            return None
        try:
            return json.loads(raw.decode())
        except ValueError:
            return None

    def _send(self, addr: tuple, msg: dict) -> None:
        msg["updates"] = self._take_piggyback()
        try:
            self._sock.sendto(self._pack(msg), addr)
        except OSError:
            pass

    # ------------------------------------------------------- dissemination

    def _queue_update(self, member: Member) -> None:
        import math
        with self._lock:
            n = max(len(self.members), 2)
            retransmits = int(math.ceil(math.log2(n))) + 2
            self._updates[member.name] = [retransmits, member.to_wire()]

    def _take_piggyback(self, limit: int = 8) -> list:
        with self._lock:
            out = []
            for name in list(self._updates)[:limit]:
                entry = self._updates[name]
                out.append(entry[1])
                entry[0] -= 1
                if entry[0] <= 0:
                    del self._updates[name]
            return out

    def _apply_update(self, wire: dict) -> None:
        m = Member.from_wire(wire)
        if m.name == self.name:
            # refute rumors about ourselves (SWIM refutation)
            if m.status in (SUSPECT, DEAD) and \
                    m.incarnation >= self.members[self.name].incarnation:
                with self._lock:
                    me = self.members[self.name]
                    me.incarnation = m.incarnation + 1
                    me.status = ALIVE
                    self._queue_update(me)
            return
        with self._lock:
            cur = self.members.get(m.name)
            if cur is None:
                if m.status in (ALIVE, SUSPECT):
                    m.status_time = time.monotonic()
                    self.members[m.name] = m
                    self._queue_update(m)
                    if m.status != ALIVE:
                        # store the rumor but don't announce a join for a
                        # member first heard of as suspect — adopting a
                        # possibly-failing server as a voter stalls quorum
                        return
                    new_member = m
                else:
                    return
            else:
                # incarnation ordering: higher wins; same incarnation,
                # worse status wins (alive < suspect < dead)
                rank = {ALIVE: 0, SUSPECT: 1, DEAD: 2, LEFT: 2}
                if m.incarnation < cur.incarnation:
                    return
                if m.incarnation == cur.incarnation and \
                        rank[m.status] <= rank[cur.status]:
                    return
                was = cur.status
                cur.incarnation = m.incarnation
                cur.status = m.status
                cur.tags = m.tags or cur.tags
                cur.host, cur.port = m.host, m.port
                cur.status_time = time.monotonic()
                self._queue_update(cur)
                if m.status == ALIVE and was != ALIVE:
                    new_member = cur
                elif m.status == DEAD and was != DEAD:
                    threading.Thread(target=self.on_fail, args=(cur,),
                                     daemon=True).start()
                    return
                elif m.status == LEFT and was not in (DEAD, LEFT):
                    threading.Thread(target=self.on_leave, args=(cur,),
                                     daemon=True).start()
                    return
                else:
                    return
        threading.Thread(target=self.on_join, args=(new_member,),
                         daemon=True).start()

    # ------------------------------------------------------------ handlers

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, addr = self._sock.recvfrom(64 * 1024)
            except socket.timeout:
                continue
            except OSError:
                return
            msg = self._unpack(data)
            if msg is None:
                continue
            try:
                self._handle_msg(msg, addr)
            except Exception as e:      # noqa: BLE001 - a malformed (but
                # authenticated) message from a skewed peer must not kill
                # the receive thread and leave this node deaf
                self.logger(f"gossip: bad message from {addr}: {e!r}")

    def _handle_msg(self, msg: dict, addr: tuple) -> None:
        for upd in msg.get("updates", ()):
            self._apply_update(upd)
        t = msg.get("t")
        if t == "ping":
            self._send(addr, {"t": "ack", "seq": msg.get("seq")})
        elif t == "ping-req":
            # indirect probe on behalf of `from`
            target = tuple(msg.get("target", ()))
            seq = msg.get("seq")
            origin = addr

            def relay(target=target, seq=seq, origin=origin):
                ok = self._ping(target)
                if ok:
                    self._send(origin, {"t": "ack", "seq": seq})
            threading.Thread(target=relay, daemon=True).start()
        elif t == "ack":
            ev = self._acks.get(msg.get("seq"))
            if ev is not None:
                ev.set()
        elif t == "push-pull":
            for wire in msg.get("members", ()):
                self._apply_update(wire)
            with self._lock:
                wire_members = [m.to_wire() for m in
                                self.members.values()]
            self._send(addr, {"t": "push-pull-ack",
                              "seq": msg.get("seq"),
                              "members": wire_members})
        elif t == "push-pull-ack":
            for wire in msg.get("members", ()):
                self._apply_update(wire)
            ev = self._acks.get(msg.get("seq"))
            if ev is not None:
                ev.set()

    def _ping(self, addr: tuple, timeout: Optional[float] = None) -> bool:
        with self._lock:
            self._seq += 1
            seq = self._seq
        ev = threading.Event()
        self._acks[seq] = ev
        self._send(addr, {"t": "ping", "seq": seq})
        ok = ev.wait(timeout or self.probe_timeout)
        self._acks.pop(seq, None)
        return ok

    # --------------------------------------------------------- probe loop

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.probe_tick()

    def probe_tick(self) -> None:
        """One probe-loop pass, extracted from the daemon loop so tests
        can drive it directly inside a bounded wait_until poll instead
        of racing the background thread's scheduling on a loaded box
        (the PR-6 gossip / PR-13 deployment-watcher deflake pattern).
        An extra pass is idempotent by construction: probes re-confirm
        state, suspicion/reaping key on wall-clock timeouts."""
        # periodic anti-entropy push-pull with a random member of ANY
        # status (memberlist's full state sync): this is how a node
        # wrongly marked DEAD after a healed partition hears the
        # rumor about itself and refutes — probes alone never reach
        # it because DEAD members leave the probe set
        now = time.monotonic()
        if now - self._last_sync >= self.sync_interval:
            self._last_sync = now
            with self._lock:
                others = [m for m in self.members.values()
                          if m.name != self.name]
            if others:
                target = random.choice(others)
                with self._lock:
                    wire = [m.to_wire() for m in self.members.values()]
                self._send(target.addr, {"t": "push-pull", "seq": 0,
                                         "members": wire})
        with self._lock:
            candidates = [m for m in self.members.values()
                          if m.name != self.name and
                          m.status in (ALIVE, SUSPECT)]
        if not candidates:
            return
        target = random.choice(candidates)
        if self._ping(target.addr):
            self._mark_alive_probe(target)
            return
        # indirect probes via k helpers
        with self._lock:
            helpers = [m for m in candidates
                       if m.name != target.name and m.status == ALIVE]
        random.shuffle(helpers)
        with self._lock:
            self._seq += 1
            seq = self._seq
        ev = threading.Event()
        self._acks[seq] = ev
        for h in helpers[:2]:
            self._send(h.addr, {"t": "ping-req", "seq": seq,
                                "target": [target.host, target.port]})
        ok = ev.wait(self.probe_timeout * 2)
        self._acks.pop(seq, None)
        if ok:
            self._mark_alive_probe(target)
        else:
            self._suspect(target)
        self._reap_suspects()

    def _mark_alive_probe(self, target: Member) -> None:
        with self._lock:
            cur = self.members.get(target.name)
            if cur is not None and cur.status == SUSPECT:
                cur.status = ALIVE
                cur.status_time = time.monotonic()
                self._queue_update(cur)

    def _suspect(self, target: Member) -> None:
        with self._lock:
            cur = self.members.get(target.name)
            if cur is None or cur.status != ALIVE:
                return
            cur.status = SUSPECT
            cur.status_time = time.monotonic()
            self._queue_update(cur)
            self.logger(f"gossip: {self.name}: suspect {cur.name}")

    def _reap_suspects(self) -> None:
        now = time.monotonic()
        failed = []
        with self._lock:
            for m in self.members.values():
                if m.status == SUSPECT and \
                        now - m.status_time > self.suspect_timeout:
                    m.status = DEAD
                    m.status_time = now
                    self._queue_update(m)
                    failed.append(m)
                    self.logger(f"gossip: {self.name}: {m.name} failed")
        for m in failed:
            threading.Thread(target=self.on_fail, args=(m,),
                             daemon=True).start()

    # -------------------------------------------------------------- API

    def start(self) -> None:
        for fn, nm in ((self._recv_loop, "gossip-recv"),
                       (self._probe_loop, "gossip-probe")):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"{nm}-{self.name}")
            t.start()
            self._threads.append(t)

    def join(self, seeds: list[str], timeout: float = 3.0) -> int:
        """Push-pull state sync with seed "host:port" addrs (ref
        serf.Join). Returns the number of seeds reached."""
        reached = 0
        for seed in seeds:
            host, _, port = seed.rpartition(":")
            addr = (host or "127.0.0.1", int(port))
            with self._lock:
                self._seq += 1
                seq = self._seq
                wire_members = [m.to_wire() for m in self.members.values()]
            ev = threading.Event()
            self._acks[seq] = ev
            self._send(addr, {"t": "push-pull", "seq": seq,
                              "members": wire_members})
            if ev.wait(timeout):
                reached += 1
            self._acks.pop(seq, None)
        return reached

    def leave(self) -> None:
        """Graceful departure: broadcast LEFT before stopping."""
        with self._lock:
            me = self.members[self.name]
            me.incarnation += 1
            me.status = LEFT
            self._queue_update(me)
            targets = [m.addr for m in self.members.values()
                       if m.name != self.name and m.status == ALIVE]
        for addr in targets[:8]:
            self._send(addr, {"t": "ping", "seq": 0})   # carries the update
        time.sleep(0.05)
        self.shutdown()

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def alive_members(self) -> list[Member]:
        with self._lock:
            return [m for m in self.members.values() if m.status == ALIVE]

    def members_snapshot(self) -> list[dict]:
        with self._lock:
            return [m.to_wire() for m in self.members.values()]
