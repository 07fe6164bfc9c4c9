"""Placement stacks: the iterator pipelines assembled per scheduler type
(ref scheduler/stack.go:43 GenericStack, :190 SystemStack, :343
NewGenericStack).
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Optional

from ..structs import Job, Node, TaskGroup
from .context import EvalContext
from .feasible import (
    ConstraintChecker, CSIVolumeChecker, DeviceChecker, DistinctHostsIterator,
    DistinctPropertyIterator, DriverChecker, FeasibilityWrapper,
    HostVolumeChecker, NetworkChecker, StaticIterator,
)
from .rank import (
    BinPackIterator, FeasibleRankIterator, JobAntiAffinityIterator,
    NodeAffinityIterator, NodeReschedulingPenaltyIterator,
    PreemptionScoringIterator, RankedNode, ScoreNormalizationIterator,
)
from .select import LimitIterator, MaxScoreIterator
from .spread import SpreadIterator


@dataclasses.dataclass
class SelectOptions:
    """ref stack.go SelectOptions"""
    penalty_node_ids: set[str] = dataclasses.field(default_factory=set)
    preferred_nodes: list[Node] = dataclasses.field(default_factory=list)
    preempt: bool = False
    alloc_name: str = ""


def _task_group_constraints(tg: TaskGroup):
    """Collect drivers + constraints from the TG and its tasks
    (ref stack.go taskGroupConstraints)."""
    constraints = list(tg.constraints)
    drivers: set[str] = set()
    for task in tg.tasks:
        if task.driver:
            drivers.add(task.driver)
        constraints.extend(task.constraints)
    return drivers, constraints


class GenericStack:
    """ref stack.go:43"""

    def __init__(self, batch: bool, ctx: EvalContext,
                 rng: Optional[random.Random] = None):
        self.batch = batch
        self.ctx = ctx
        # the scheduler passes a per-eval seeded Random (seeded from the
        # eval id) so identical (snapshot, eval, seed) inputs reproduce
        # bit-identical placements; the bare default is deterministic too
        # rather than OS-entropy-seeded (DET001)
        self.rng = rng if rng is not None else random.Random(0)
        self.job_version: Optional[int] = None

        self.source = StaticIterator(ctx, [])
        self.job_constraint = ConstraintChecker(ctx, [])
        self.tg_drivers = DriverChecker(ctx)
        self.tg_constraint = ConstraintChecker(ctx, [])
        self.tg_devices = DeviceChecker(ctx)
        self.tg_host_volumes = HostVolumeChecker(ctx)
        self.tg_csi_volumes = CSIVolumeChecker(ctx)
        self.job_namespace = "default"
        self.job_id = ""
        self.tg_network = NetworkChecker(ctx)

        self.wrapped_checks = FeasibilityWrapper(
            ctx, self.source,
            job_checks=[self.job_constraint],
            tg_checks=[self.tg_drivers, self.tg_constraint,
                       self.tg_host_volumes, self.tg_devices,
                       self.tg_network],
            tg_available=[self.tg_csi_volumes])
        self.distinct_hosts = DistinctHostsIterator(ctx, self.wrapped_checks)
        self.distinct_property = DistinctPropertyIterator(
            ctx, self.distinct_hosts)
        rank_source = FeasibleRankIterator(ctx, self.distinct_property)
        self.bin_pack = BinPackIterator(
            ctx, rank_source, evict=False, priority=0,
            algorithm=ctx.scheduler_config.effective_scheduler_algorithm())
        self.job_anti_aff = JobAntiAffinityIterator(ctx, self.bin_pack)
        self.node_resched_penalty = NodeReschedulingPenaltyIterator(
            ctx, self.job_anti_aff)
        self.node_affinity = NodeAffinityIterator(
            ctx, self.node_resched_penalty)
        self.spread = SpreadIterator(ctx, self.node_affinity)
        preemption_scorer = PreemptionScoringIterator(ctx, self.spread)
        self.score_norm = ScoreNormalizationIterator(ctx, preemption_scorer)
        self.limit = LimitIterator(ctx, self.score_norm, 2)
        self.max_score = MaxScoreIterator(ctx, self.limit)

    def set_nodes(self, nodes: list[Node]) -> None:
        """Shuffle + log2 limit (power-of-two-choices for batch)
        (ref stack.go:71-91)."""
        nodes = list(nodes)
        self.rng.shuffle(nodes)
        self.source.set_nodes(nodes)
        limit = 2
        n = len(nodes)
        if not self.batch and n > 0:
            limit = max(limit, int(math.ceil(math.log2(n))))
        self.limit.set_limit(limit)

    def set_job(self, job: Job) -> None:
        if self.job_version is not None and self.job_version == job.version:
            return
        self.job_version = job.version
        self.job_namespace = job.namespace
        self.job_id = job.id
        self.job_constraint.set_constraints(list(job.constraints))
        self.distinct_hosts.set_job(job)
        self.distinct_property.set_job(job)
        self.bin_pack.set_job(job)
        self.job_anti_aff.set_job(job)
        self.node_affinity.set_job(job)
        self.spread.set_job(job)
        self.ctx.eligibility.set_job(job)

    def select(self, tg: TaskGroup,
               options: Optional[SelectOptions] = None) -> Optional[RankedNode]:
        options = options or SelectOptions()

        if options.preferred_nodes:
            original = self.source.nodes
            self.source.set_nodes(options.preferred_nodes)
            sub = dataclasses.replace(options, preferred_nodes=[])
            option = self.select(tg, sub)
            self.source.set_nodes(original)
            if option is not None:
                return option
            return self.select(tg, sub)

        self.max_score.reset()
        self.ctx.reset_metrics()

        drivers, constraints = _task_group_constraints(tg)
        self.tg_drivers.set_drivers(drivers)
        self.tg_constraint.set_constraints(constraints)
        self.tg_devices.set_task_group(tg)
        self.tg_host_volumes.set_volumes(options.alloc_name, tg.volumes)
        self.tg_csi_volumes.set_volumes(tg.volumes, self.job_namespace,
                                        job_id=self.job_id)
        self.tg_network.set_network(tg.networks[0] if tg.networks else None)
        self.distinct_hosts.set_task_group(tg)
        self.distinct_property.set_task_group(tg)
        self.wrapped_checks.set_task_group(tg.name)
        self.bin_pack.set_task_group(tg)
        self.bin_pack.evict = options.preempt
        self.job_anti_aff.set_task_group(tg)
        self.node_resched_penalty.set_penalty_nodes(options.penalty_node_ids)
        self.node_affinity.set_task_group(tg)
        self.spread.set_task_group(tg)

        if self.node_affinity.has_affinities() or self.spread.has_spread:
            # spread/affinity scoring needs a wider sample (ref stack.go:165)
            self.limit.set_limit(max(tg.count, 100))

        return self.max_score.next()


class SystemStack:
    """Stack for system/sysbatch jobs: every feasible node, no shuffle/limit
    (ref stack.go:190)."""

    def __init__(self, ctx: EvalContext, sysbatch: bool = False):
        self.ctx = ctx
        self.source = StaticIterator(ctx, [])
        self.job_constraint = ConstraintChecker(ctx, [])
        self.tg_drivers = DriverChecker(ctx)
        self.tg_constraint = ConstraintChecker(ctx, [])
        self.tg_devices = DeviceChecker(ctx)
        self.tg_host_volumes = HostVolumeChecker(ctx)
        self.tg_csi_volumes = CSIVolumeChecker(ctx)
        self.job_namespace = "default"
        self.job_id = ""
        self.tg_network = NetworkChecker(ctx)
        self.wrapped_checks = FeasibilityWrapper(
            ctx, self.source,
            job_checks=[self.job_constraint],
            tg_checks=[self.tg_drivers, self.tg_constraint,
                       self.tg_host_volumes, self.tg_devices,
                       self.tg_network],
            tg_available=[self.tg_csi_volumes])
        self.distinct_property = DistinctPropertyIterator(
            ctx, self.wrapped_checks)
        rank_source = FeasibleRankIterator(ctx, self.distinct_property)
        self.bin_pack = BinPackIterator(
            ctx, rank_source, evict=False, priority=0,
            algorithm=ctx.scheduler_config.effective_scheduler_algorithm())
        self.score_norm = ScoreNormalizationIterator(ctx, self.bin_pack)

    def set_nodes(self, nodes: list[Node]) -> None:
        self.source.set_nodes(nodes)

    def set_job(self, job: Job) -> None:
        self.job_namespace = job.namespace
        self.job_id = job.id
        self.job_constraint.set_constraints(list(job.constraints))
        self.distinct_property.set_job(job)
        self.bin_pack.set_job(job)
        self.ctx.eligibility.set_job(job)

    def select(self, tg: TaskGroup,
               options: Optional[SelectOptions] = None) -> Optional[RankedNode]:
        options = options or SelectOptions()
        self.score_norm.reset()
        drivers, constraints = _task_group_constraints(tg)
        self.tg_drivers.set_drivers(drivers)
        self.tg_constraint.set_constraints(constraints)
        self.tg_devices.set_task_group(tg)
        self.tg_host_volumes.set_volumes(options.alloc_name, tg.volumes)
        self.tg_csi_volumes.set_volumes(tg.volumes, self.job_namespace,
                                        job_id=self.job_id)
        self.tg_network.set_network(tg.networks[0] if tg.networks else None)
        self.distinct_property.set_task_group(tg)
        self.wrapped_checks.set_task_group(tg.name)
        self.bin_pack.set_task_group(tg)
        self.bin_pack.evict = options.preempt
        return self.score_norm.next()
