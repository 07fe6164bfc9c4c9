"""Control plane (ref nomad/): replicated log + FSM, eval broker, serial
plan applier, scheduler workers, heartbeats, periodic dispatch, core GC,
blocked evals."""
from .eval_broker import EvalBroker  # noqa: F401
from .blocked_evals import BlockedEvals  # noqa: F401
from .fsm import NomadFSM, RaftLog, PlanApplyRequest  # noqa: F401
from .plan_apply import Planner, PlanQueue  # noqa: F401
from .worker import Worker  # noqa: F401
from .heartbeat import HeartbeatTimers, create_node_evals  # noqa: F401
from .periodic import PeriodicDispatch, cron_next  # noqa: F401
from .core_sched import CoreScheduler  # noqa: F401
from .deployment_watcher import DeploymentWatcher  # noqa: F401
from .drainer import NodeDrainer  # noqa: F401
from .server import Server  # noqa: F401
