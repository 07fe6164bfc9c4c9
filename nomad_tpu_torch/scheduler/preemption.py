"""Preemption: distance-based victim selection grouped by priority bands
(ref scheduler/preemption.go:96 Preemptor, PreemptForTaskGroup:198,
PreemptForNetwork:270, PreemptForDevice:472, distance fns:608-661).

The TPU analog is masked iterative top-k over the same distance metric
(SURVEY.md hard part 4); this host version is the oracle.
"""
from __future__ import annotations

import math
from typing import Optional

from ..structs import (
    AllocatedResources, Allocation, NetworkIndex, Node, allocs_fit,
)


class Preemptor:
    def __init__(self, job_priority: int, ctx, job_id: str):
        self.job_priority = job_priority
        self.ctx = ctx
        self.job_id = job_id
        self.node: Optional[Node] = None
        self.current_preemptions: list[Allocation] = []
        self.candidates: list[Allocation] = []

    def set_node(self, node: Node) -> None:
        self.node = node

    def set_preemptions(self, allocs: list[Allocation]) -> None:
        self.current_preemptions = list(allocs)

    def set_candidates(self, allocs: list[Allocation]) -> None:
        """Keep only allocs with strictly lower priority that aren't already
        being preempted in this plan (ref preemption.go
        filterAndGroupPreemptibleAllocs)."""
        preempted_ids = {a.id for a in self.current_preemptions}
        self.candidates = []
        for a in allocs:
            prio = a.job.priority if a.job else 50
            if prio >= self.job_priority:
                continue
            if a.id in preempted_ids:
                continue
            self.candidates.append(a)

    # ---- task-group resources (ref preemption.go:198) ----

    def preempt_for_task_group(self, ask: AllocatedResources
                               ) -> list[Allocation]:
        """Greedy victim selection: lowest priority band first, then minimal
        resource distance; stop when the ask fits."""
        if self.node is None or not self.candidates:
            return []
        ask_alloc = Allocation(allocated_resources=ask)
        # lowest priority band first; within a band, the alloc whose resources
        # are closest to the ask (minimal over-preemption)
        remaining = sorted(
            self.candidates,
            key=lambda a: ((a.job.priority if a.job else 50),
                           _resource_distance(a, ask)))
        victims: list[Allocation] = []
        base = [a for a in self.ctx.proposed_allocs(self.node.id)]
        victim_ids: set[str] = set()
        for candidate in remaining:
            current = [a for a in base if a.id not in victim_ids] + [ask_alloc]
            fit, _, _ = allocs_fit(self.node, current)
            if fit:
                break
            victims.append(candidate)
            victim_ids.add(candidate.id)
        else:
            current = [a for a in base if a.id not in victim_ids] + [ask_alloc]
            fit, _, _ = allocs_fit(self.node, current)
            if not fit:
                return []
        if not victims:
            return []
        # Eliminate unnecessary victims (ref preemption.go
        # eliminateSuperSetAllocations): try adding back from highest priority
        for candidate in sorted(victims,
                                key=lambda a: -(a.job.priority if a.job else 50)):
            trial_ids = victim_ids - {candidate.id}
            current = [a for a in base if a.id not in trial_ids] + [ask_alloc]
            fit, _, _ = allocs_fit(self.node, current)
            if fit:
                victim_ids = trial_ids
        return [v for v in victims if v.id in victim_ids]

    # ---- network (ref preemption.go:270) ----

    def preempt_for_network(self, ask, net_idx: NetworkIndex
                            ) -> Optional[list[Allocation]]:
        """Find victims whose removal frees the ports/bandwidth the ask needs."""
        if self.node is None or not self.candidates:
            return None
        needed_ports = {p.value for p in ask.reserved_ports}
        needed_mbits = ask.mbits

        def uses_needed(alloc: Allocation) -> tuple[bool, int]:
            mbits = 0
            hits = False
            res = alloc.allocated_resources
            nets = list(res.shared.networks)
            for tr in res.tasks.values():
                nets.extend(tr.networks)
            for net in nets:
                mbits += net.mbits
                for p in list(net.reserved_ports) + list(net.dynamic_ports):
                    if p.value in needed_ports:
                        hits = True
            return hits, mbits

        scored = []
        for a in self.candidates:
            hits, mbits = uses_needed(a)
            prio = a.job.priority if a.job else 50
            scored.append((not hits, prio, -mbits, a))
        scored.sort(key=lambda t: t[:3])

        victims: list[Allocation] = []
        victim_ids: set[str] = set()
        base = self.ctx.proposed_allocs(self.node.id)
        for _, _, _, candidate in scored:
            victims.append(candidate)
            victim_ids.add(candidate.id)
            idx = NetworkIndex()
            idx.set_node(self.node)
            idx.add_allocs([a for a in base if a.id not in victim_ids])
            offer, err = idx.assign_network(ask)
            if offer is not None:
                return victims
            if needed_mbits == 0 and not needed_ports and len(victims) >= 3:
                break
        return None

    # ---- devices (ref preemption.go:472) ----

    def preempt_for_device(self, ask, dev_allocator) -> Optional[list[Allocation]]:
        if self.node is None or not self.candidates:
            return None
        holders = []
        for a in self.candidates:
            for tr in a.allocated_resources.tasks.values():
                for d in tr.devices:
                    holders.append((a.job.priority if a.job else 50,
                                    len(d.device_ids), a))
                    break
        holders.sort(key=lambda t: (t[0], -t[1]))
        victims, count = [], 0
        seen = set()
        for _, n, a in holders:
            if a.id in seen:
                continue
            seen.add(a.id)
            victims.append(a)
            count += n
            if count >= ask.count:
                return victims
        return None


def _resource_distance(alloc: Allocation, ask: AllocatedResources) -> float:
    """Normalized euclidean distance between an alloc's resources and the ask
    (ref preemption.go:608 basicResourceDistance)."""
    a = alloc.comparable_resources()
    b = Allocation(allocated_resources=ask).comparable_resources()
    dims = 0
    total = 0.0
    if b.cpu_shares > 0:
        total += ((a.cpu_shares - b.cpu_shares) / b.cpu_shares) ** 2
        dims += 1
    if b.memory_mb > 0:
        total += ((a.memory_mb - b.memory_mb) / b.memory_mb) ** 2
        dims += 1
    if b.disk_mb > 0:
        total += ((a.disk_mb - b.disk_mb) / b.disk_mb) ** 2
        dims += 1
    if dims == 0:
        return 0.0
    return math.sqrt(total / dims)
