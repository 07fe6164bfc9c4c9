"""Control-plane pieces on the placement path: the FSM and the serial
plan applier. The broker, workers, raft and the server itself are not
ported yet."""
from .fsm import NomadFSM  # noqa: F401
from .plan_apply import Planner, PlanQueue  # noqa: F401

__all__ = ["NomadFSM", "Planner", "PlanQueue"]
