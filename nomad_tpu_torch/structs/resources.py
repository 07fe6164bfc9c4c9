"""Resource model: asks, node capacities, and the flattened comparable form.

Behavioral reference: nomad/structs/structs.go:2251 (Resources),
:2859 (NodeResources), :3931 (ComparableResources), nomad/structs/devices.go.
Re-designed for a dual representation: the object form here, and a dense
tensor form produced by nomad_tpu.solver.tensorize for the TPU solver.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Port:
    label: str = ""
    value: int = 0          # static port (0 = dynamic)
    to: int = 0             # mapped port inside the task namespace
    host_network: str = "default"


@dataclass
class DNSConfig:
    servers: list[str] = field(default_factory=list)
    searches: list[str] = field(default_factory=list)
    options: list[str] = field(default_factory=list)


@dataclass
class NetworkResource:
    """One requested/allocated network (ref structs.go NetworkResource).

    mbits participates in bandwidth overcommit checks
    (nomad/structs/network.go Overcommitted); ports are allocated against the
    node's NetworkIndex bitmaps.
    """
    mode: str = "host"              # host | bridge | none | cni/*
    device: str = ""
    cidr: str = ""
    ip: str = ""
    mbits: int = 0
    dns: Optional[DNSConfig] = None
    reserved_ports: list[Port] = field(default_factory=list)
    dynamic_ports: list[Port] = field(default_factory=list)

    def copy(self) -> "NetworkResource":
        return dataclasses.replace(
            self,
            dns=dataclasses.replace(self.dns) if self.dns else None,
            reserved_ports=[dataclasses.replace(p) for p in self.reserved_ports],
            dynamic_ports=[dataclasses.replace(p) for p in self.dynamic_ports],
        )

    def port_labels(self) -> dict[str, int]:
        out = {}
        for p in self.reserved_ports:
            out[p.label] = p.value
        for p in self.dynamic_ports:
            out[p.label] = p.value
        return out


@dataclass
class RequestedDevice:
    """Device ask, `vendor/type/name` hierarchy (ref nomad/structs/devices.go,
    structs.go RequestedDevice)."""
    name: str = ""                  # e.g. "gpu", "nvidia/gpu", "nvidia/gpu/1080ti"
    count: int = 1
    constraints: list = field(default_factory=list)   # list[Constraint]
    affinities: list = field(default_factory=list)    # list[Affinity]

    def id_tuple(self) -> tuple[str, str, str]:
        """Split name into (vendor, type, name) with wildcards as ''."""
        parts = self.name.split("/")
        if len(parts) == 1:
            return ("", parts[0], "")
        if len(parts) == 2:
            return (parts[0], parts[1], "")
        return (parts[0], parts[1], "/".join(parts[2:]))


@dataclass
class Resources:
    """A task's resource ask (ref structs.go:2251)."""
    cpu: int = 100                  # MHz
    cores: int = 0                  # reserved whole cores (exclusive cpuset)
    memory_mb: int = 300
    memory_max_mb: int = 0          # oversubscription ceiling
    disk_mb: int = 0
    networks: list[NetworkResource] = field(default_factory=list)
    devices: list[RequestedDevice] = field(default_factory=list)

    def copy(self) -> "Resources":
        return dataclasses.replace(
            self,
            networks=[n.copy() for n in self.networks],
            devices=[dataclasses.replace(d) for d in self.devices],
        )

    def add(self, other: "Resources") -> None:
        self.cpu += other.cpu
        self.cores += other.cores
        self.memory_mb += other.memory_mb
        self.memory_max_mb += other.memory_max_mb
        self.disk_mb += other.disk_mb
        self.networks.extend(n.copy() for n in other.networks)


@dataclass
class NodeCpuResources:
    cpu_shares: int = 0             # total MHz
    total_core_count: int = 0
    reservable_cores: list[int] = field(default_factory=list)


@dataclass
class NodeMemoryResources:
    memory_mb: int = 0


@dataclass
class NodeDiskResources:
    disk_mb: int = 0


@dataclass
class NodeDeviceResource:
    """An installed device group on a node (ref structs.go NodeDeviceResource)."""
    vendor: str = ""
    type: str = ""
    name: str = ""
    instances: list["NodeDevice"] = field(default_factory=list)
    attributes: dict[str, object] = field(default_factory=dict)

    def id_tuple(self) -> tuple[str, str, str]:
        return (self.vendor, self.type, self.name)

    def matches(self, ask: RequestedDevice) -> bool:
        """Hierarchical match: ask may specify type, vendor/type, or
        vendor/type/name (ref nomad/structs/devices.go IDMatches)."""
        v, t, n = ask.id_tuple()
        if t and t != self.type:
            return False
        if v and v != self.vendor:
            return False
        if n and n != self.name:
            return False
        return True


@dataclass
class NodeDevice:
    id: str = ""
    healthy: bool = True
    locality: Optional[str] = None


@dataclass
class NodeNetworkResource:
    mode: str = "host"
    device: str = ""
    mac_address: str = ""
    speed: int = 1000               # mbits
    addresses: list[dict] = field(default_factory=list)


@dataclass
class NodeResources:
    """Total resources on a node (ref structs.go:2859)."""
    cpu: NodeCpuResources = field(default_factory=NodeCpuResources)
    memory: NodeMemoryResources = field(default_factory=NodeMemoryResources)
    disk: NodeDiskResources = field(default_factory=NodeDiskResources)
    networks: list[NetworkResource] = field(default_factory=list)
    node_networks: list[NodeNetworkResource] = field(default_factory=list)
    devices: list[NodeDeviceResource] = field(default_factory=list)

    def copy(self) -> "NodeResources":
        return dataclasses.replace(
            self,
            cpu=dataclasses.replace(self.cpu, reservable_cores=list(self.cpu.reservable_cores)),
            memory=dataclasses.replace(self.memory),
            disk=dataclasses.replace(self.disk),
            networks=[n.copy() for n in self.networks],
            node_networks=list(self.node_networks),
            devices=list(self.devices),
        )

    def comparable(self) -> "ComparableResources":
        return ComparableResources(
            cpu_shares=self.cpu.cpu_shares,
            reserved_cores=tuple(self.cpu.reservable_cores),
            memory_mb=self.memory.memory_mb,
            disk_mb=self.disk.disk_mb,
        )


@dataclass
class NodeReservedResources:
    """Resources the client reserves for the host OS (ref structs.go
    NodeReservedResources)."""
    cpu_shares: int = 0
    cores: list[int] = field(default_factory=list)
    memory_mb: int = 0
    disk_mb: int = 0
    reserved_host_ports: str = ""   # port spec string, e.g. "22,80,8000-8100"

    def comparable(self) -> "ComparableResources":
        return ComparableResources(
            cpu_shares=self.cpu_shares,
            reserved_cores=tuple(self.cores),
            memory_mb=self.memory_mb,
            disk_mb=self.disk_mb,
        )


@dataclass
class ComparableResources:
    """Flattened resource vector used by fit checks and preemption distance
    (ref structs.go:3931). This is the object twin of one row of the solver's
    dense resource matrices."""
    cpu_shares: int = 0
    reserved_cores: tuple[int, ...] = ()
    memory_mb: int = 0
    memory_max_mb: int = 0
    disk_mb: int = 0
    networks: list[NetworkResource] = field(default_factory=list)

    def add(self, other: Optional["ComparableResources"]) -> None:
        if other is None:
            return
        self.cpu_shares += other.cpu_shares
        self.reserved_cores = tuple(self.reserved_cores) + tuple(other.reserved_cores)
        self.memory_mb += other.memory_mb
        # memory_max falls back to memory when unset, so the summed max is the
        # true oversubscription claim (ref structs.go:3824 AllocatedMemoryResources.Add)
        self.memory_max_mb += (other.memory_max_mb
                               if other.memory_max_mb else other.memory_mb)
        self.disk_mb += other.disk_mb
        self.networks.extend(other.networks)

    def subtract(self, other: Optional["ComparableResources"]) -> None:
        if other is None:
            return
        self.cpu_shares -= other.cpu_shares
        self.reserved_cores = tuple(c for c in self.reserved_cores
                                    if c not in set(other.reserved_cores))
        self.memory_mb -= other.memory_mb
        self.memory_max_mb -= (other.memory_max_mb
                               if other.memory_max_mb else other.memory_mb)
        self.disk_mb -= other.disk_mb

    def copy(self) -> "ComparableResources":
        return dataclasses.replace(self, networks=[n.copy() for n in self.networks])

    def superset(self, other: "ComparableResources") -> tuple[bool, str]:
        """Is self a superset of other? Returns (ok, failing dimension)
        (ref structs.go ComparableResources.Superset)."""
        if self.cpu_shares < other.cpu_shares:
            return False, "cpu"
        if other.reserved_cores and \
           not set(other.reserved_cores) <= set(self.reserved_cores):
            return False, "cores"
        # memory_max (if set) is the claim against capacity under
        # oversubscription; otherwise memory.
        mem_claim = other.memory_max_mb if other.memory_max_mb > other.memory_mb else other.memory_mb
        if self.memory_mb < mem_claim:
            return False, "memory"
        if self.disk_mb < other.disk_mb:
            return False, "disk"
        return True, ""


# Vector layout shared with the solver: index of each scalar dimension in the
# dense [*, R] resource matrices. Ports/devices are handled by separate masks.
RESOURCE_DIMS = ("cpu", "memory", "disk")
R_CPU, R_MEM, R_DISK = 0, 1, 2
NUM_RESOURCE_DIMS = len(RESOURCE_DIMS)


def comparable_to_vector(c: ComparableResources) -> list[float]:
    """Flatten to the solver's dense layout. Memory uses the oversubscription
    claim (max(memory, memory_max)) to mirror Superset above."""
    mem = c.memory_max_mb if c.memory_max_mb > c.memory_mb else c.memory_mb
    return [float(c.cpu_shares), float(mem), float(c.disk_mb)]
