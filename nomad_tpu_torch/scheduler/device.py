"""Device allocator: selects device instances for a task's device asks with
affinity scoring (ref scheduler/device.go).
"""
from __future__ import annotations

from typing import Optional

from ..structs import AllocatedDeviceResource, Node, RequestedDevice
from .feasible import check_constraint, _resolve_device_target


class DeviceAllocator:
    def __init__(self, ctx, node: Node):
        self.ctx = ctx
        self.node = node
        # (vendor,type,name) -> {instance_id: use_count}
        self.instances: dict[tuple, dict[str, int]] = {}
        self.devices: dict[tuple, object] = {}
        for dev in node.node_resources.devices:
            key = dev.id_tuple()
            self.devices[key] = dev
            self.instances[key] = {inst.id: 0 for inst in dev.instances
                                   if inst.healthy}

    def add_allocs(self, allocs) -> None:
        for alloc in allocs:
            if alloc.terminal_status():
                continue
            for tr in alloc.allocated_resources.tasks.values():
                for ad in tr.devices:
                    key = (ad.vendor, ad.type, ad.name)
                    insts = self.instances.get(key)
                    if insts is None:
                        continue
                    for dev_id in ad.device_ids:
                        if dev_id in insts:
                            insts[dev_id] += 1

    def add_reserved(self, offer: AllocatedDeviceResource) -> None:
        key = (offer.vendor, offer.type, offer.name)
        insts = self.instances.get(key, {})
        for dev_id in offer.device_ids:
            if dev_id in insts:
                insts[dev_id] += 1

    def assign_device(self, ask: RequestedDevice
                      ) -> tuple[Optional[AllocatedDeviceResource], float, str]:
        """Pick the best matching device group with enough free instances.
        Returns (offer, normalized affinity score, error reason)."""
        best = None
        best_score = 0.0
        err = "no devices match request"
        for key, dev in self.devices.items():
            if not dev.matches(ask):
                continue
            if not self._meets_constraints(dev, ask):
                err = "device constraints not met"
                continue
            free = [i for i, c in self.instances.get(key, {}).items() if c == 0]
            if len(free) < ask.count:
                err = "no device instances available"
                continue
            score = self._affinity_score(dev, ask)
            if best is None or score > best_score:
                best = (key, dev, free)
                best_score = score
        if best is None:
            return None, 0.0, err
        key, dev, free = best
        offer = AllocatedDeviceResource(
            vendor=key[0], type=key[1], name=key[2],
            device_ids=free[:ask.count])
        return offer, best_score, ""

    def _meets_constraints(self, dev, ask: RequestedDevice) -> bool:
        for c in ask.constraints:
            lval, lok = _resolve_device_target(c.ltarget, dev)
            rval, rok = _resolve_device_target(c.rtarget, dev)
            if not check_constraint(self.ctx, c.operand, lval, rval, lok, rok):
                return False
        return True

    def _affinity_score(self, dev, ask: RequestedDevice) -> float:
        if not ask.affinities:
            return 0.0
        total, sum_weight = 0.0, 0.0
        for aff in ask.affinities:
            sum_weight += abs(aff.weight)
            lval, lok = _resolve_device_target(aff.ltarget, dev)
            rval, rok = _resolve_device_target(aff.rtarget, dev)
            if check_constraint(self.ctx, aff.operand, lval, rval, lok, rok):
                total += float(aff.weight)
        return total / sum_weight if sum_weight else 0.0
