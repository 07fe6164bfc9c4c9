"""Node agent (ref client/): alloc/task runners, drivers, fingerprinting,
local state persistence + task reattach."""
from .client import Client  # noqa: F401
from .driver import (  # noqa: F401
    BUILTIN_DRIVERS, Driver, ExitResult, MockDriver, RawExecDriver, TaskHandle,
)
from .alloc_runner import AllocRunner  # noqa: F401
from .task_runner import TaskRunner  # noqa: F401
from .fingerprint import fingerprint_node  # noqa: F401
from .state_db import StateDB  # noqa: F401
from .taskenv import build_task_env, interpolate  # noqa: F401
