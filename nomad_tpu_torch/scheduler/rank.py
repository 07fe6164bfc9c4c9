"""Ranking iterators (ref scheduler/rank.go). BinPackIterator.Next
(rank.go:193-527) is THE hot loop — the scalar oracle that
nomad_tpu.solver reformulates as dense batched tensor ops.
"""
from __future__ import annotations

import math
from typing import Optional

from ..structs import (
    AllocatedResources, AllocatedSharedResources, AllocatedTaskResources,
    Allocation, NetworkIndex, Node, TaskGroup, allocs_fit, score_fit_binpack,
    score_fit_spread, BINPACK_MAX_FIT_SCORE, SCHED_ALG_SPREAD,
)
from .context import EvalContext
from .feasible import resolve_target, check_constraint


class RankedNode:
    """A node option flowing down the rank stack (ref rank.go:21)."""

    __slots__ = ("node", "final_score", "scores", "task_resources",
                 "alloc_resources", "preempted_allocs", "_proposed")

    def __init__(self, node: Node):
        self.node = node
        self.final_score = 0.0
        self.scores: list[float] = []
        self.task_resources: dict[str, AllocatedTaskResources] = {}
        self.alloc_resources: Optional[AllocatedSharedResources] = None
        self.preempted_allocs: Optional[list[Allocation]] = None
        self._proposed: Optional[list[Allocation]] = None

    def proposed_allocs(self, ctx: EvalContext) -> list[Allocation]:
        if self._proposed is None:
            self._proposed = ctx.proposed_allocs(self.node.id)
        return self._proposed

    def set_task_resources(self, task, resources) -> None:
        self.task_resources[task.name] = resources


class RankIterator:
    def next(self) -> Optional[RankedNode]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class FeasibleRankIterator(RankIterator):
    """Adapts a FeasibleIterator into the rank chain (ref rank.go:100)."""

    def __init__(self, ctx: EvalContext, source):
        self.ctx = ctx
        self.source = source

    def next(self) -> Optional[RankedNode]:
        node = self.source.next()
        if node is None:
            return None
        return RankedNode(node)

    def reset(self) -> None:
        self.source.reset()


class BinPackIterator(RankIterator):
    """Scores nodes by fit; assigns ports/devices/cores as it goes
    (ref rank.go:151, Next:193-527)."""

    def __init__(self, ctx: EvalContext, source: RankIterator,
                 evict: bool = False, priority: int = 0,
                 algorithm: str = "binpack"):
        self.ctx = ctx
        self.source = source
        self.evict = evict
        self.priority = priority
        self.job_id = ""
        self.task_group: Optional[TaskGroup] = None
        self.score_fit = (score_fit_spread if algorithm == SCHED_ALG_SPREAD
                          else score_fit_binpack)
        self.memory_oversubscription = \
            ctx.scheduler_config.memory_oversubscription_enabled

    def set_job(self, job) -> None:
        self.job_id = job.id
        if job.priority:
            self.priority = job.priority

    def set_task_group(self, tg: TaskGroup) -> None:
        self.task_group = tg

    def reset(self) -> None:
        self.source.reset()

    def next(self) -> Optional[RankedNode]:
        while True:
            option = self.source.next()
            if option is None:
                return None
            result = self._try_node(option)
            if result is not None:
                return result

    def _try_node(self, option: RankedNode) -> Optional[RankedNode]:
        from .preemption import Preemptor
        ctx, tg = self.ctx, self.task_group
        node = option.node
        proposed = list(option.proposed_allocs(ctx))

        net_idx = NetworkIndex()
        net_idx.set_node(node)
        net_idx.add_allocs(proposed)

        total = AllocatedResources(
            shared=AllocatedSharedResources(disk_mb=tg.ephemeral_disk.size_mb))
        allocs_to_preempt: list[Allocation] = []

        preemptor = None
        if self.evict:
            preemptor = Preemptor(self.priority, ctx, self.job_id)
            preemptor.set_node(node)
            current_preemptions = []
            if ctx.plan is not None:
                for allocs in ctx.plan.node_preemptions.values():
                    current_preemptions.extend(allocs)
            preemptor.set_preemptions(current_preemptions)

        # group-level network (ref rank.go:248-324)
        if tg.networks:
            ask = tg.networks[0]
            offer, err = net_idx.assign_network(ask)
            if offer is None and self.evict and preemptor is not None:
                preemptor.set_candidates(proposed)
                victims = preemptor.preempt_for_network(ask, net_idx)
                if victims:
                    allocs_to_preempt.extend(victims)
                    victim_ids = {v.id for v in victims}
                    proposed = [a for a in proposed if a.id not in victim_ids]
                    net_idx = NetworkIndex()
                    net_idx.set_node(node)
                    net_idx.add_allocs(proposed)
                    offer, err = net_idx.assign_network(ask)
            if offer is None:
                ctx.metrics.exhausted_node(node, f"network: {err}")
                return None
            net_idx.add_reserved(offer)
            total.shared.networks = [offer]
            total.shared.ports = [
                {"label": p.label, "value": p.value, "to": p.to,
                 "host_ip": offer.ip}
                for p in offer.reserved_ports + offer.dynamic_ports]
            option.alloc_resources = AllocatedSharedResources(
                disk_mb=tg.ephemeral_disk.size_mb,
                networks=[offer], ports=total.shared.ports)

        # one device allocator per node attempt — offers reserved as assigned
        # so multiple device asks never double-book an instance
        from .device import DeviceAllocator
        dev_alloc = DeviceAllocator(ctx, node)
        dev_alloc.add_allocs(proposed)

        # per-task resources (ref rank.go:325-470)
        for task in tg.tasks:
            tr = AllocatedTaskResources(
                cpu_shares=task.resources.cpu,
                memory_mb=task.resources.memory_mb)
            if self.memory_oversubscription:
                tr.memory_max_mb = task.resources.memory_max_mb

            if task.resources.networks:
                ask = task.resources.networks[0]
                offer, err = net_idx.assign_network(ask)
                if offer is None and self.evict and preemptor is not None:
                    preemptor.set_candidates(proposed)
                    victims = preemptor.preempt_for_network(ask, net_idx)
                    if victims:
                        allocs_to_preempt.extend(victims)
                        victim_ids = {v.id for v in victims}
                        proposed = [a for a in proposed if a.id not in victim_ids]
                        net_idx = NetworkIndex()
                        net_idx.set_node(node)
                        net_idx.add_allocs(proposed)
                        offer, err = net_idx.assign_network(ask)
                if offer is None:
                    ctx.metrics.exhausted_node(node, f"network: {err}")
                    return None
                net_idx.add_reserved(offer)
                tr.networks = [offer]

            # devices (ref rank.go:389-436)
            for req in task.resources.devices:
                offer_dev, affinity_score, err = dev_alloc.assign_device(req)
                if offer_dev is None:
                    ctx.metrics.exhausted_node(node, f"devices: {err}")
                    return None
                dev_alloc.add_reserved(offer_dev)
                tr.devices.append(offer_dev)
                if req.affinities:
                    option.scores.append(affinity_score)

            # reserved cores (ref rank.go:438-466)
            if task.resources.cores > 0:
                node_cores = set(node.node_resources.cpu.reservable_cores)
                taken: set[int] = set()
                for alloc in proposed:
                    taken |= set(alloc.comparable_resources().reserved_cores)
                for assigned in total.tasks.values():
                    taken |= set(assigned.reserved_cores)
                avail = sorted(node_cores - taken)
                if len(avail) < task.resources.cores:
                    ctx.metrics.exhausted_node(node, "cores")
                    return None
                tr.reserved_cores = tuple(avail[:task.resources.cores])
                total_cores = node.node_resources.cpu.total_core_count or 1
                shares_per_core = node.node_resources.cpu.cpu_shares // total_cores
                tr.cpu_shares = shares_per_core * task.resources.cores

            option.set_task_resources(task, tr)
            total.tasks[task.name] = tr

        # final fit check (ref rank.go:470-510)
        current = proposed
        candidate = Allocation(allocated_resources=total)
        fit, dim, util = allocs_fit(node, proposed + [candidate], net_idx)
        if not fit:
            if not self.evict or preemptor is None:
                ctx.metrics.exhausted_node(node, dim)
                return None
            preemptor.set_candidates(current)
            victims = preemptor.preempt_for_task_group(total)
            if not victims:
                ctx.metrics.exhausted_node(node, dim)
                return None
            allocs_to_preempt.extend(victims)
            victim_ids = {v.id for v in victims}
            remaining = [a for a in proposed if a.id not in victim_ids]
            fit, dim, util = allocs_fit(node, remaining + [candidate])
            if not fit:
                ctx.metrics.exhausted_node(node, dim)
                return None

        if allocs_to_preempt:
            option.preempted_allocs = allocs_to_preempt

        fitness = self.score_fit(node, util)
        normalized = fitness / BINPACK_MAX_FIT_SCORE
        option.scores.append(normalized)
        ctx.metrics.score_node(node.id, "binpack", normalized)
        return option


class JobAntiAffinityIterator(RankIterator):
    """Penalize co-placement with same job+TG allocs (ref rank.go:536)."""

    def __init__(self, ctx: EvalContext, source: RankIterator, job_id: str = ""):
        self.ctx = ctx
        self.source = source
        self.job_id = job_id
        self.task_group = ""
        self.desired_count = 0

    def set_job(self, job) -> None:
        self.job_id = job.id

    def set_task_group(self, tg: TaskGroup) -> None:
        self.task_group = tg.name
        self.desired_count = tg.count

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        proposed = option.proposed_allocs(self.ctx)
        collisions = sum(1 for a in proposed
                         if a.job_id == self.job_id
                         and a.task_group == self.task_group)
        if collisions > 0 and self.desired_count > 0:
            penalty = -1.0 * (collisions + 1) / self.desired_count
            option.scores.append(penalty)
            self.ctx.metrics.score_node(option.node.id, "job-anti-affinity",
                                        penalty)
        return option

    def reset(self) -> None:
        self.source.reset()


class NodeReschedulingPenaltyIterator(RankIterator):
    """-1 score on nodes where this alloc previously failed (ref rank.go:606)."""

    def __init__(self, ctx: EvalContext, source: RankIterator):
        self.ctx = ctx
        self.source = source
        self.penalty_nodes: set[str] = set()

    def set_penalty_nodes(self, nodes: set[str]) -> None:
        self.penalty_nodes = nodes or set()

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        if option.node.id in self.penalty_nodes:
            option.scores.append(-1.0)
            self.ctx.metrics.score_node(option.node.id,
                                        "node-reschedule-penalty", -1.0)
        return option

    def reset(self) -> None:
        self.penalty_nodes = set()
        self.source.reset()


class NodeAffinityIterator(RankIterator):
    """Weighted affinity scoring (ref rank.go:650)."""

    def __init__(self, ctx: EvalContext, source: RankIterator):
        self.ctx = ctx
        self.source = source
        self.job_affinities = []
        self.affinities = []

    def set_job(self, job) -> None:
        self.job_affinities = list(job.affinities)

    def set_task_group(self, tg: TaskGroup) -> None:
        self.affinities = self.job_affinities + list(tg.affinities)
        for task in tg.tasks:
            self.affinities.extend(task.affinities)

    def has_affinities(self) -> bool:
        return bool(self.affinities)

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None or not self.affinities:
            return option
        sum_weight = sum(abs(a.weight) for a in self.affinities)
        total = 0.0
        for aff in self.affinities:
            if self._matches(aff, option.node):
                total += float(aff.weight)
        norm = total / sum_weight if sum_weight else 0.0
        if norm != 0.0:
            # normalized to [-1, 1] like the reference (weights are percents)
            score = norm / 100.0 if abs(norm) > 1 else norm
            option.scores.append(score)
            self.ctx.metrics.score_node(option.node.id, "node-affinity", score)
        return option

    def _matches(self, aff, node: Node) -> bool:
        lval, lok = resolve_target(aff.ltarget, node)
        rval, rok = resolve_target(aff.rtarget, node)
        return check_constraint(self.ctx, aff.operand, lval, rval, lok, rok)

    def reset(self) -> None:
        self.source.reset()


class ScoreNormalizationIterator(RankIterator):
    """final_score = mean(scores) (ref rank.go:737)."""

    def __init__(self, ctx: EvalContext, source: RankIterator):
        self.ctx = ctx
        self.source = source

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None:
            return None
        if option.scores:
            option.final_score = sum(option.scores) / len(option.scores)
        self.ctx.metrics.score_node(option.node.id, "normalized-score",
                                    option.final_score)
        return option

    def reset(self) -> None:
        self.source.reset()


class PreemptionScoringIterator(RankIterator):
    """Logistic preemption score in (0,1) (ref rank.go:775)."""

    def __init__(self, ctx: EvalContext, source: RankIterator):
        self.ctx = ctx
        self.source = source

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None or not option.preempted_allocs:
            return option
        score = preemption_score(net_priority(option.preempted_allocs))
        option.scores.append(score)
        self.ctx.metrics.score_node(option.node.id, "preemption", score)
        return option

    def reset(self) -> None:
        self.source.reset()


def net_priority(allocs: list[Allocation]) -> float:
    """max priority + sum/max penalty (ref rank.go:811)."""
    max_p = 0.0
    total = 0
    for a in allocs:
        p = a.job.priority if a.job else 50
        max_p = max(max_p, float(p))
        total += p
    if max_p == 0:
        return 0.0
    return max_p + (total / max_p)


def preemption_score(netp: float) -> float:
    """Logistic curve, inflection ~2048 (ref rank.go:834)."""
    rate, origin = 0.0048, 2048.0
    return 1.0 / (1.0 + math.exp(rate * (netp - origin)))
