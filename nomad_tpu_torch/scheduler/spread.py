"""Spread scoring iterator (ref scheduler/spread.go): targeted percentages or
even-spread boosts over a property dimension.
"""
from __future__ import annotations

from typing import Optional

from ..structs import TaskGroup
from .context import EvalContext
from .feasible import resolve_target
from .propertyset import PropertySet
from .rank import RankedNode, RankIterator

IMPLICIT_TARGET = "*"


class SpreadIterator(RankIterator):
    def __init__(self, ctx: EvalContext, source: RankIterator):
        self.ctx = ctx
        self.source = source
        self.job = None
        self.tg: Optional[TaskGroup] = None
        self.job_spreads = []
        self.group_property_sets: dict[str, list[PropertySet]] = {}
        # tg -> (attribute -> (weight, desired counts), weight sum)
        self.tg_spread_info: dict[
            str, tuple[dict[str, tuple[int, dict[str, float]]], int]] = {}
        self.has_spread = False

    def set_job(self, job) -> None:
        self.job = job
        self.job_spreads = list(job.spreads)

    def set_task_group(self, tg: TaskGroup) -> None:
        self.tg = tg
        if tg.name not in self.group_property_sets:
            sets = []
            for spread in self.job_spreads + list(tg.spreads):
                ps = PropertySet(self.ctx, self.job)
                ps.set_target_attribute(spread.attribute, tg.name)
                sets.append(ps)
            self.group_property_sets[tg.name] = sets
        self.has_spread = bool(self.group_property_sets[tg.name])
        if tg.name not in self.tg_spread_info:
            self._compute_spread_info(tg)

    def _compute_spread_info(self, tg: TaskGroup) -> None:
        infos: dict[str, tuple[int, dict[str, float]]] = {}
        total = tg.count
        sum_weights = 0
        for spread in list(tg.spreads) + self.job_spreads:
            desired: dict[str, float] = {}
            sum_desired = 0.0
            for st in spread.spread_target:
                d = (st.percent / 100.0) * total
                desired[st.value] = d
                sum_desired += d
            if 0 < sum_desired < total:
                desired[IMPLICIT_TARGET] = total - sum_desired
            infos[spread.attribute] = (spread.weight, desired)
            sum_weights += spread.weight
        self.tg_spread_info[tg.name] = (infos, sum_weights)

    def next(self) -> Optional[RankedNode]:
        option = self.source.next()
        if option is None or not self.has_spread:
            return option
        tg_name = self.tg.name
        infos, sum_weights = self.tg_spread_info[tg_name]
        total_score = 0.0
        for ps in self.group_property_sets[tg_name]:
            val, ok = resolve_target(ps.target_attribute, option.node)
            used = ps.used_counts()
            used_count = used.get(str(val), 0) if ok and val is not None else 0
            used_count += 1  # include this prospective placement
            if not ok or val is None:
                total_score -= 1.0
                continue
            weight, desired = infos.get(ps.target_attribute, (0, {}))
            if not desired:
                total_score += _even_spread_boost(ps, str(val))
            else:
                d = desired.get(str(val), desired.get(IMPLICIT_TARGET))
                if d is None:
                    total_score -= 1.0
                    continue
                spread_weight = weight / sum_weights if sum_weights else 0.0
                total_score += ((d - used_count) / d) * spread_weight
        if total_score != 0.0:
            option.scores.append(total_score)
            self.ctx.metrics.score_node(option.node.id, "allocation-spread",
                                        total_score)
        return option

    def reset(self) -> None:
        self.source.reset()
        # property sets see fresh plan deltas on every select


def _even_spread_boost(ps: PropertySet, value: str) -> float:
    """Even spread when no targets are given (ref spread.go:178
    evenSpreadScoreBoost)."""
    combined = ps.used_counts()
    if not combined:
        return 0.0
    current = combined.get(value, 0)
    counts = list(combined.values())
    min_count = min(counts)
    max_count = max(counts)
    if current != min_count:
        if min_count == 0:
            return -1.0
        return float(min_count - current) / float(min_count)
    if min_count == max_count:
        return -1.0
    if min_count == 0:
        return 1.0
    return float(max_count - min_count) / float(min_count)
