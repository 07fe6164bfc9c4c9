"""Client device plugin manager (ref client/devicemanager/manager.go +
plugins/device/device.go DevicePlugin: Fingerprint / Reserve / Stats).

The reference runs device plugins as go-plugin gRPC subprocesses; here the
boundary is the `DevicePlugin` interface. `StaticDevicePlugin` is the
built-in reference implementation (the mock/example device plugin analog):
a fixed set of instances whose reservation exposes an env var with the
reserved ids — the NVIDIA_VISIBLE_DEVICES pattern.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..structs import NodeDevice, NodeDeviceResource


@dataclass
class ContainerReservation:
    """What a task gets for its reserved device ids (ref
    plugins/device/device.go ContainerReservation)."""
    envs: dict[str, str] = field(default_factory=dict)
    mounts: list = field(default_factory=list)
    devices: list = field(default_factory=list)   # host device files


class DevicePlugin:
    """ref plugins/device DevicePlugin"""

    def fingerprint(self) -> list[NodeDeviceResource]:
        raise NotImplementedError

    def reserve(self, device_ids: list[str]) -> ContainerReservation:
        raise NotImplementedError

    def stats(self) -> dict[str, dict]:
        """instance id -> stats map"""
        return {}


class StaticDevicePlugin(DevicePlugin):
    """Fixed device inventory (the example/mock device plugin pattern)."""

    def __init__(self, vendor: str, type_: str, name: str,
                 instance_ids: list[str],
                 env_var: str = "", attributes: dict | None = None):
        self.vendor = vendor
        self.type = type_
        self.name = name
        self.instance_ids = list(instance_ids)
        self.unhealthy: set[str] = set()
        self.env_var = env_var or \
            f"{vendor}_{type_}_VISIBLE_DEVICES".upper().replace("-", "_")
        self.attributes = dict(attributes or {})

    def fingerprint(self) -> list[NodeDeviceResource]:
        return [NodeDeviceResource(
            vendor=self.vendor, type=self.type, name=self.name,
            instances=[NodeDevice(id=i, healthy=i not in self.unhealthy)
                       for i in self.instance_ids],
            attributes=dict(self.attributes))]

    def reserve(self, device_ids: list[str]) -> ContainerReservation:
        unknown = [i for i in device_ids if i not in self.instance_ids]
        if unknown:
            raise ValueError(f"unknown device ids {unknown}")
        return ContainerReservation(
            envs={self.env_var: ",".join(device_ids)})

    def stats(self) -> dict[str, dict]:
        return {i: {"healthy": i not in self.unhealthy}
                for i in self.instance_ids}


class DeviceManager:
    """ref client/devicemanager: owns plugins, folds their fingerprints
    into the node, and serves task reservations."""

    def __init__(self, client):
        self.client = client
        self.plugins: dict[tuple[str, str, str], DevicePlugin] = {}

    def register_plugin(self, plugin: DevicePlugin) -> None:
        for group in plugin.fingerprint():
            self.plugins[group.id_tuple()] = plugin

    def fingerprint(self) -> list[NodeDeviceResource]:
        out = []
        seen = set()
        for plugin in self.plugins.values():
            if id(plugin) in seen:
                continue
            seen.add(id(plugin))
            out.extend(plugin.fingerprint())
        return out

    def reserve(self, allocated_device) -> ContainerReservation:
        """AllocatedDeviceResource -> reservation (ref manager.go Reserve)."""
        key = (allocated_device.vendor, allocated_device.type,
               allocated_device.name)
        plugin = self.plugins.get(key)
        if plugin is None:
            raise ValueError(f"no device plugin for {key}")
        return plugin.reserve(list(allocated_device.device_ids))

    def all_stats(self) -> dict:
        out = {}
        for key, plugin in self.plugins.items():
            out["/".join(k for k in key if k)] = plugin.stats()
        return out
