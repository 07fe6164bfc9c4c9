"""The fleet, made from the seed as plain arrays.

Both sides read this table: the harness builds the program's nodes from
it, and the reference works out each node's capacity from it. Nothing in
it comes from the program.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Fleet:
    ids: list            # node ids, uuid-shaped, from the seed
    cpu: np.ndarray      # MHz, total
    mem: np.ndarray      # MB, total
    disk: np.ndarray     # MB, total
    reserved: tuple      # (cpu MHz, memory MB, disk MB) on every node
    dc: list             # datacenter of each node
    rack: list           # meta.rack of each node ("" where none)
    node_class: list

    def __len__(self) -> int:
        return len(self.ids)

    def capacity(self) -> np.ndarray:
        """[N, 3] float64: what allocations may use (total less reserved)
        of cpu, memory and disk."""
        total = np.stack([self.cpu, self.mem, self.disk], axis=1)
        return total.astype(np.float64) - np.asarray(self.reserved,
                                                     np.float64)


def _uuid(words: np.ndarray) -> str:
    h = "".join(f"{int(w):08x}" for w in words)
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:32]}"


def make(spec: dict, seed: int, nodes: int = 0) -> Fleet:
    """The fleet of a configuration's "fleet" block. Node i takes its
    datacenter from spec["datacenters"][i % len] and its rack from
    r{i % racks}; cpu and memory are drawn from the choices, the node
    class from c0..c{node_classes-1}. `nodes` overrides the count (the
    CPU tests' small fleets)."""
    n = nodes or spec["nodes"]
    rng = np.random.default_rng([seed, 1])
    words = rng.integers(0, 2 ** 32, size=(n, 4), dtype=np.uint64)
    cpu = rng.choice(np.asarray(spec["cpu_mhz_choices"], np.int64), n)
    mem = rng.choice(np.asarray(spec["memory_mb_choices"], np.int64), n)
    classes = rng.integers(0, max(spec.get("node_classes", 1), 1), n)
    dcs = spec["datacenters"]
    racks = spec.get("racks", 0)
    r = spec["reserved"]
    return Fleet(
        ids=[_uuid(w) for w in words],
        cpu=cpu, mem=mem, disk=np.full(n, spec["disk_mb"], np.int64),
        reserved=(r["cpu_mhz"], r["memory_mb"], r["disk_mb"]),
        dc=[dcs[i % len(dcs)] for i in range(n)],
        rack=[f"r{i % racks}" if racks else "" for i in range(n)],
        node_class=[f"c{int(c)}" for c in classes])
