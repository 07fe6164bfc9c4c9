"""Job summary rollups maintained by the state store
(ref nomad/structs/structs.go JobSummary / TaskGroupSummary and
nomad/state/state_store.go summary maintenance)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class TaskGroupSummary:
    queued: int = 0
    complete: int = 0
    failed: int = 0
    running: int = 0
    starting: int = 0
    lost: int = 0
    unknown: int = 0


@dataclass
class JobSummary:
    job_id: str = ""
    namespace: str = "default"
    summary: dict[str, TaskGroupSummary] = field(default_factory=dict)
    children_pending: int = 0
    children_running: int = 0
    children_dead: int = 0
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "JobSummary":
        return dataclasses.replace(
            self,
            summary={k: dataclasses.replace(v) for k, v in self.summary.items()})
