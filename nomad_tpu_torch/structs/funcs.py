"""Fit & scoring math — the kernel the TPU solver vectorizes
(ref nomad/structs/funcs.go:147 AllocsFit, :236 ScoreFitBinPack,
:263 ScoreFitSpread). The scalar forms here are the behavioral oracle for
nomad_tpu.solver's dense versions.
"""
from __future__ import annotations

import math
from typing import Optional

from .alloc import Allocation
from .node import Node
from .resources import ComparableResources
from .network import NetworkIndex

BINPACK_MAX_FIT_SCORE = 18.0


def allocs_fit(node: Node, allocs: list[Allocation],
               net_idx: Optional[NetworkIndex] = None,
               check_devices: bool = False
               ) -> tuple[bool, str, ComparableResources]:
    """Do these allocations all fit on the node?
    Returns (fit, failing dimension, summed utilization).
    Mirrors funcs.go:147 AllocsFit: terminal allocs are ignored; reserved
    cores must not overlap; node resources minus node reservation must be a
    superset of the sum; port collisions and bandwidth overcommit fail."""
    used = ComparableResources()
    seen_cores: set[int] = set()
    core_overlap = False

    for alloc in allocs:
        if alloc.terminal_status():
            continue
        cr = alloc.comparable_resources()
        used.add(cr)
        for core in cr.reserved_cores:
            if core in seen_cores:
                core_overlap = True
            seen_cores.add(core)

    if core_overlap:
        return False, "cores", used

    available = node.comparable_resources()
    available.subtract(node.comparable_reserved_resources())
    ok, dim = available.superset(used)
    if not ok:
        return False, dim, used

    if net_idx is None:
        net_idx = NetworkIndex()
        if net_idx.set_node(node) or net_idx.add_allocs(allocs):
            return False, "reserved port collision", used

    if net_idx.overcommitted():
        return False, "bandwidth exceeded", used

    if check_devices:
        acct = DeviceAccounter(node)
        if acct.add_allocs(allocs):
            return False, "device oversubscribed", used

    return True, "", used


def _free_percentages(node: Node, util: ComparableResources) -> tuple[float, float]:
    reserved = node.comparable_reserved_resources()
    res = node.comparable_resources()
    node_cpu = float(res.cpu_shares) - float(reserved.cpu_shares)
    node_mem = float(res.memory_mb) - float(reserved.memory_mb)
    free_cpu = 1.0 - (float(util.cpu_shares) / node_cpu) if node_cpu else 0.0
    free_mem = 1.0 - (float(util.memory_mb) / node_mem) if node_mem else 0.0
    return free_cpu, free_mem


def score_fit_binpack(node: Node, util: ComparableResources) -> float:
    """BestFit v3: score in [0,18]; fuller node => higher score
    (funcs.go:236)."""
    free_cpu, free_mem = _free_percentages(node, util)
    total = math.pow(10, free_cpu) + math.pow(10, free_mem)
    return min(18.0, max(0.0, 20.0 - total))


def score_fit_spread(node: Node, util: ComparableResources) -> float:
    """Worst Fit: emptier node => higher score (funcs.go:263)."""
    free_cpu, free_mem = _free_percentages(node, util)
    total = math.pow(10, free_cpu) + math.pow(10, free_mem)
    return min(18.0, max(0.0, total - 2.0))


class DeviceAccounter:
    """Tracks device instance usage on a node
    (ref nomad/structs/devices.go DeviceAccounter)."""

    def __init__(self, node: Node):
        # (vendor, type, name) -> {instance_id: count}
        self.devices: dict[tuple, dict[str, int]] = {}
        self._healthy: dict[tuple, set[str]] = {}
        for dev in node.node_resources.devices:
            key = dev.id_tuple()
            self.devices[key] = {inst.id: 0 for inst in dev.instances}
            self._healthy[key] = {inst.id for inst in dev.instances if inst.healthy}

    def add_allocs(self, allocs: list[Allocation]) -> bool:
        """Returns True if devices are oversubscribed (collision)."""
        collision = False
        for alloc in allocs:
            if alloc.terminal_status():
                continue
            for tr in alloc.allocated_resources.tasks.values():
                for ad in tr.devices:
                    key = (ad.vendor, ad.type, ad.name)
                    insts = self.devices.get(key)
                    if insts is None:
                        continue
                    for dev_id in ad.device_ids:
                        if dev_id in insts:
                            insts[dev_id] += 1
                            if insts[dev_id] > 1:
                                collision = True
        return collision

    def free_instances(self, key: tuple) -> list[str]:
        insts = self.devices.get(key, {})
        return [i for i, c in insts.items()
                if c == 0 and i in self._healthy.get(key, set())]


def score_normalize(scores: list[float]) -> float:
    """Mean of component scores (ref scheduler/rank.go
    ScoreNormalizationIterator:737)."""
    if not scores:
        return 0.0
    return sum(scores) / len(scores)
