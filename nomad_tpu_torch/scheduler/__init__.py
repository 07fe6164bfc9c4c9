"""Scheduler layer (ref scheduler/): schedulers are pure functions of
(state snapshot, evaluation) -> plan, submitted through a Planner.

Registry mirrors scheduler/scheduler.go:23 BuiltinSchedulers.
"""
from typing import Callable

from .context import EvalContext, EvalEligibility  # noqa: F401
from .generic_sched import GenericScheduler  # noqa: F401
from .system_sched import SystemScheduler  # noqa: F401
from .stack import GenericStack, SystemStack, SelectOptions  # noqa: F401
from .rank import (  # noqa: F401
    BinPackIterator, FeasibleRankIterator, JobAntiAffinityIterator,
    NodeAffinityIterator, NodeReschedulingPenaltyIterator,
    PreemptionScoringIterator, RankedNode, ScoreNormalizationIterator,
)
from .reconcile import AllocReconciler, ReconcileResults  # noqa: F401
from .preemption import Preemptor  # noqa: F401
from .testing import Harness  # noqa: F401


def _service(state, planner):
    return GenericScheduler(state, planner, batch=False)


def _batch(state, planner):
    return GenericScheduler(state, planner, batch=True)


def _system(state, planner):
    return SystemScheduler(state, planner, sysbatch=False)


def _sysbatch(state, planner):
    return SystemScheduler(state, planner, sysbatch=True)


BUILTIN_SCHEDULERS: dict[str, Callable] = {
    "service": _service,
    "batch": _batch,
    "system": _system,
    "sysbatch": _sysbatch,
}


def new_scheduler(name: str, state, planner):
    """ref scheduler/scheduler.go:32 NewScheduler"""
    factory = BUILTIN_SCHEDULERS.get(name)
    if factory is None:
        raise ValueError(f"unknown scheduler {name!r}")
    return factory(state, planner)
