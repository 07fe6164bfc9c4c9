"""Node model (ref nomad/structs/structs.go:1853, node_class.go).

A Node is the fingerprinted description of one agent: attributes map,
total/reserved resources, drain/eligibility state, and a computed node class
used to cache scheduler feasibility per *equivalence class* of nodes.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass, field
from typing import Optional

from .resources import NodeReservedResources, NodeResources, ComparableResources

# Node statuses (ref structs.go NodeStatus*)
NODE_STATUS_INIT = "initializing"
NODE_STATUS_READY = "ready"
NODE_STATUS_DOWN = "down"
NODE_STATUS_DISCONNECTED = "disconnected"

# Scheduling eligibility (ref structs.go NodeScheduling*)
NODE_SCHED_ELIGIBLE = "eligible"
NODE_SCHED_INELIGIBLE = "ineligible"


@dataclass
class DrainStrategy:
    """Node drain spec (ref structs.go DrainStrategy)."""
    deadline_sec: float = 0.0        # <0: force drain, 0: no deadline
    ignore_system_jobs: bool = False
    force_deadline_unix: float = 0.0  # absolute time the drain deadlines


@dataclass
class NodeEvent:
    message: str = ""
    subsystem: str = ""
    timestamp_unix: float = 0.0
    details: dict[str, str] = field(default_factory=dict)


@dataclass
class HostVolumeInfo:
    path: str = ""
    read_only: bool = False


@dataclass
class Node:
    id: str = ""
    name: str = ""
    datacenter: str = "dc1"
    node_class: str = ""
    status: str = NODE_STATUS_INIT
    status_description: str = ""
    scheduling_eligibility: str = NODE_SCHED_ELIGIBLE
    drain_strategy: Optional[DrainStrategy] = None

    http_addr: str = ""
    attributes: dict[str, str] = field(default_factory=dict)
    node_resources: NodeResources = field(default_factory=NodeResources)
    reserved_resources: NodeReservedResources = field(default_factory=NodeReservedResources)
    links: dict[str, str] = field(default_factory=dict)
    meta: dict[str, str] = field(default_factory=dict)
    host_volumes: dict[str, HostVolumeInfo] = field(default_factory=dict)
    csi_node_plugins: dict[str, dict] = field(default_factory=dict)
    csi_controller_plugins: dict[str, dict] = field(default_factory=dict)
    drivers: dict[str, "DriverInfo"] = field(default_factory=dict)
    events: list[NodeEvent] = field(default_factory=list)

    computed_class: str = ""
    status_updated_at: float = 0.0
    # flap damping (ISSUE 10, docs/NODE_FAILURE.md): while nonzero, the
    # node was held ineligible by the leader's flap damper until this
    # wall-clock deadline. Rides raft (NODE_UPDATE_ELIGIBILITY payload)
    # so a NEW leader re-admits nodes a deposed damper held; operator
    # eligibility writes clear it.
    flap_held_until: float = 0.0
    create_index: int = 0
    modify_index: int = 0

    # ---- lifecycle predicates (ref structs.go Node.Ready / Canonicalize) ----

    def ready(self) -> bool:
        return (self.status == NODE_STATUS_READY
                and self.drain_strategy is None
                and self.scheduling_eligibility == NODE_SCHED_ELIGIBLE)

    @property
    def drain(self) -> bool:
        return self.drain_strategy is not None

    def terminal_status(self) -> bool:
        return self.status == NODE_STATUS_DOWN

    def copy(self) -> "Node":
        return dataclasses.replace(
            self,
            attributes=dict(self.attributes),
            meta=dict(self.meta),
            links=dict(self.links),
            host_volumes=dict(self.host_volumes),
            drivers=dict(self.drivers),
            events=list(self.events),
            node_resources=self.node_resources.copy(),
            reserved_resources=dataclasses.replace(self.reserved_resources),
            drain_strategy=(dataclasses.replace(self.drain_strategy)
                            if self.drain_strategy else None),
        )

    def comparable_resources(self) -> ComparableResources:
        return self.node_resources.comparable()

    def comparable_reserved_resources(self) -> ComparableResources:
        return self.reserved_resources.comparable()

    # ---- computed node class (ref nomad/structs/node_class.go) ----

    def compute_class(self) -> None:
        """Hash of the scheduling-relevant fields. Nodes with equal computed
        class are interchangeable for feasibility, enabling the per-class
        eligibility cache (ref scheduler/context.go:190) and blocked-eval
        unblocking keyed by class (ref nomad/blocked_evals.go)."""
        h = hashlib.sha1()
        h.update(self.datacenter.encode())
        h.update(self.node_class.encode())
        for k in sorted(self.attributes):
            if k.startswith("unique."):
                continue
            h.update(k.encode())
            h.update(str(self.attributes[k]).encode())
        for k in sorted(self.meta):
            if k.startswith("unique."):
                continue
            h.update(k.encode())
            h.update(str(self.meta[k]).encode())
        for d in sorted(self.drivers):
            info = self.drivers[d]
            h.update(d.encode())
            h.update(b"1" if info.detected else b"0")
            h.update(b"1" if info.healthy else b"0")
        cpu = self.node_resources.cpu
        h.update(str(cpu.cpu_shares).encode())
        h.update(str(self.node_resources.memory.memory_mb).encode())
        h.update(str(self.node_resources.disk.disk_mb).encode())
        for dev in self.node_resources.devices:
            h.update("/".join(dev.id_tuple()).encode())
            h.update(str(len(dev.instances)).encode())
        for name in sorted(self.host_volumes):
            h.update(name.encode())
        self.computed_class = "v1:" + h.hexdigest()[:16]


@dataclass
class DriverInfo:
    detected: bool = False
    healthy: bool = False
    health_description: str = ""
    attributes: dict[str, str] = field(default_factory=dict)
    update_time: float = 0.0
