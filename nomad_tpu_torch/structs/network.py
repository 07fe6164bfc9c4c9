"""NetworkIndex: per-node port-occupancy bitmaps and bandwidth accounting
(ref nomad/structs/network.go:37, AssignPorts:332, AssignNetwork:422).

Ports are the canonical "inherently sequential" resource (SURVEY.md hard part
3): the TPU solver does coarse feasibility (free-port counts, bandwidth as a
dense dimension), and exact assignment happens host-side here for the chosen
node. The bitmap is a numpy uint64 array so it can also be shipped to the
solver as lanes when needed.
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np

from .resources import NetworkResource, Port

MAX_VALID_PORT = 65536
DEFAULT_MIN_DYNAMIC_PORT = 20000
DEFAULT_MAX_DYNAMIC_PORT = 32000
_WORDS = MAX_VALID_PORT // 64


class Bitmap:
    """Fixed 65536-bit port bitmap over uint64 words."""

    __slots__ = ("words",)

    def __init__(self, words: Optional[np.ndarray] = None):
        self.words = words if words is not None else np.zeros(_WORDS, dtype=np.uint64)

    def set(self, i: int) -> None:
        self.words[i >> 6] |= np.uint64(1 << (i & 63))

    def unset(self, i: int) -> None:
        self.words[i >> 6] &= np.uint64(~(1 << (i & 63)) & 0xFFFFFFFFFFFFFFFF)

    def check(self, i: int) -> bool:
        return bool((int(self.words[i >> 6]) >> (i & 63)) & 1)

    def copy(self) -> "Bitmap":
        return Bitmap(self.words.copy())

    def free_count(self, lo: int, hi: int) -> int:
        """Vectorized popcount over [lo, hi] (solver feasibility path — must
        not be a per-bit Python loop)."""
        span = hi - lo + 1
        w_lo, w_hi = lo >> 6, hi >> 6
        words = self.words[w_lo:w_hi + 1].copy()
        lo_bits = lo & 63
        if lo_bits:
            words[0] &= np.uint64(~((1 << lo_bits) - 1) & 0xFFFFFFFFFFFFFFFF)
        hi_bits = hi & 63
        if hi_bits != 63:
            words[-1] &= np.uint64((1 << (hi_bits + 1)) - 1)
        used = int(np.unpackbits(words.view(np.uint8)).sum())
        return span - used


def parse_port_spec(spec: str) -> list[int]:
    """Parse "80,443,8000-8100" into a port list (ref helper ParsePortRanges)."""
    out: list[int] = []
    if not spec:
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


class NetworkIndex:
    """Tracks port/bandwidth usage for one node across its allocations."""

    def __init__(self):
        self.task_networks: list[NetworkResource] = []
        self.group_networks: list[NetworkResource] = []
        self.host_networks: dict[str, list[str]] = {}   # name -> [device]
        self.used_ports: dict[str, Bitmap] = {}          # ip -> bitmap
        self.available_bandwidth: dict[str, int] = {}    # device -> mbits
        self.used_bandwidth: dict[str, int] = {}
        self.min_dynamic_port = DEFAULT_MIN_DYNAMIC_PORT
        self.max_dynamic_port = DEFAULT_MAX_DYNAMIC_PORT

    # ---- setup ----

    def set_node(self, node) -> bool:
        """Index the node's networks + statically reserved ports. Returns True
        on collision (ref network.go SetNode)."""
        collide = False
        for n in node.node_resources.networks:
            if n.device:
                self.available_bandwidth[n.device] = n.mbits
            if n.ip:
                self.used_ports.setdefault(n.ip, Bitmap())
                self.task_networks.append(n)
        reserved = parse_port_spec(node.reserved_resources.reserved_host_ports)
        for ip in list(self.used_ports):
            for p in reserved:
                if 0 < p < MAX_VALID_PORT:
                    if self.used_ports[ip].check(p):
                        collide = True
                    self.used_ports[ip].set(p)
        return collide

    def add_allocs(self, allocs) -> bool:
        collide = False
        for alloc in allocs:
            if alloc.server_terminal_status():
                continue
            res = alloc.allocated_resources
            # shared.ports is the flattened view OF shared.networks'
            # offer — reserve from one or the other, never both, or a
            # group-network alloc collides with itself (ref
            # structs/network.go AddAllocs: AllocatedPorts preferred,
            # networks as the pre-0.12 fallback)
            if res.shared.ports:
                for port in res.shared.ports:
                    if self._reserve_port(port.get("host_ip", ""),
                                          port.get("value", 0)):
                        collide = True
            else:
                for net in res.shared.networks:
                    if self.add_reserved(net):
                        collide = True
            for tr in res.tasks.values():
                for net in tr.networks:
                    if self.add_reserved(net):
                        collide = True
        return collide

    def add_reserved(self, net: NetworkResource) -> bool:
        collide = False
        for p in list(net.reserved_ports) + list(net.dynamic_ports):
            if self._reserve_port(net.ip, p.value):
                collide = True
        if net.device:
            self.used_bandwidth[net.device] = \
                self.used_bandwidth.get(net.device, 0) + net.mbits
        return collide

    def _reserve_port(self, ip: str, port: int) -> bool:
        if port <= 0 or port >= MAX_VALID_PORT:
            return False
        if ip not in self.used_ports:
            self.used_ports[ip] = Bitmap()
        if self.used_ports[ip].check(port):
            return True
        self.used_ports[ip].set(port)
        return False

    def overcommitted(self) -> bool:
        for dev, used in self.used_bandwidth.items():
            if used > self.available_bandwidth.get(dev, 0) > 0:
                return True
        return False

    # ---- assignment (ref network.go AssignPorts / AssignTaskNetwork) ----

    def assign_network(self, ask: NetworkResource,
                       rng: Optional[random.Random] = None
                       ) -> tuple[Optional[NetworkResource], str]:
        """Pick a host network satisfying the ask; assign static + dynamic
        ports. Returns (offer, error_reason)."""
        rng = rng or random.Random(0)
        if not self.task_networks:
            return None, "no networks available"
        err = "no networks available"
        for net in self.task_networks:
            if ask.mbits and net.device and \
               self.used_bandwidth.get(net.device, 0) + ask.mbits > \
               self.available_bandwidth.get(net.device, 0):
                err = "bandwidth exceeded"
                continue
            bitmap = self.used_ports.setdefault(net.ip, Bitmap())
            # static ports must be free
            ok = True
            for p in ask.reserved_ports:
                if bitmap.check(p.value):
                    ok = False
                    err = f"reserved port collision {p.label}={p.value}"
                    break
            if not ok:
                continue
            dyn_ports = self._pick_dynamic(bitmap,
                                           [p.value for p in ask.reserved_ports],
                                           len(ask.dynamic_ports), rng)
            if dyn_ports is None:
                err = "dynamic port selection failed"
                continue
            offer = NetworkResource(
                mode=ask.mode, device=net.device, ip=net.ip, mbits=ask.mbits,
                reserved_ports=[Port(p.label, p.value, p.to, p.host_network)
                                for p in ask.reserved_ports],
                dynamic_ports=[Port(p.label, dyn_ports[i], p.to, p.host_network)
                               for i, p in enumerate(ask.dynamic_ports)],
            )
            return offer, ""
        return None, err

    def _pick_dynamic(self, bitmap: Bitmap, taken: list[int], n: int,
                      rng: random.Random) -> Optional[list[int]]:
        if n == 0:
            return []
        picked: list[int] = []
        exclude = set(taken)
        # randomized probing, then linear fallback (ref network.go
        # getDynamicPortsStochastic/Precise)
        for _ in range(n * 20):
            if len(picked) == n:
                break
            p = rng.randint(self.min_dynamic_port, self.max_dynamic_port)
            if p in exclude or bitmap.check(p):
                continue
            picked.append(p)
            exclude.add(p)
        if len(picked) < n:
            for p in range(self.min_dynamic_port, self.max_dynamic_port + 1):
                if len(picked) == n:
                    break
                if p in exclude or bitmap.check(p):
                    continue
                picked.append(p)
                exclude.add(p)
        return picked if len(picked) == n else None

    def free_dynamic_port_count(self) -> int:
        """Coarse feasibility signal exported to the TPU solver."""
        if not self.used_ports:
            return self.max_dynamic_port - self.min_dynamic_port + 1
        bm = next(iter(self.used_ports.values()))
        return bm.free_count(self.min_dynamic_port, self.max_dynamic_port)

    def release(self) -> None:
        self.used_ports.clear()
        self.used_bandwidth.clear()
