"""CSI volume + plugin model (ref nomad/structs/csi.go: CSIVolume,
CSIPlugin, CSIVolumeClaim; state tables ref nomad/state/schema.go
csi_volumes / csi_plugins).

Plugins are not stored directly — they are derived: every node that
fingerprints a CSI plugin (node.csi_node_plugins / csi_controller_plugins)
contributes to the plugin's aggregated health counts, exactly like the
reference's CSIPlugin.AddPlugin/DeleteNode bookkeeping.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

# access modes (ref csi.go CSIVolumeAccessMode)
ACCESS_MODE_SINGLE_NODE_READER = "single-node-reader-only"
ACCESS_MODE_SINGLE_NODE_WRITER = "single-node-writer"
ACCESS_MODE_MULTI_NODE_READER = "multi-node-reader-only"
ACCESS_MODE_MULTI_NODE_SINGLE_WRITER = "multi-node-single-writer"
ACCESS_MODE_MULTI_NODE_MULTI_WRITER = "multi-node-multi-writer"

# attachment modes (ref csi.go CSIVolumeAttachmentMode)
ATTACHMENT_MODE_BLOCK = "block-device"
ATTACHMENT_MODE_FS = "file-system"

# claim modes
CLAIM_READ = "read"
CLAIM_WRITE = "write"

# claim states (ref csi.go CSIVolumeClaimState)
CLAIM_STATE_TAKEN = "taken"
CLAIM_STATE_NODE_DETACHED = "node-detached"
CLAIM_STATE_CONTROLLER_DETACHED = "controller-detached"
CLAIM_STATE_READY_TO_FREE = "ready-to-free"


@dataclass
class CSIVolumeClaim:
    """One alloc's claim on a volume (ref csi.go CSIVolumeClaim)."""
    alloc_id: str = ""
    node_id: str = ""
    mode: str = CLAIM_READ
    state: str = CLAIM_STATE_TAKEN

    def copy(self) -> "CSIVolumeClaim":
        return dataclasses.replace(self)


@dataclass
class CSIVolume:
    """ref csi.go CSIVolume"""
    id: str = ""
    namespace: str = "default"
    name: str = ""
    external_id: str = ""
    plugin_id: str = ""
    access_mode: str = ACCESS_MODE_SINGLE_NODE_WRITER
    attachment_mode: str = ATTACHMENT_MODE_FS
    mount_options: dict = field(default_factory=dict)
    secrets: dict = field(default_factory=dict)
    parameters: dict = field(default_factory=dict)
    context: dict = field(default_factory=dict)
    capacity_min_bytes: int = 0
    capacity_max_bytes: int = 0
    # claims: alloc_id -> CSIVolumeClaim
    read_claims: dict[str, CSIVolumeClaim] = field(default_factory=dict)
    write_claims: dict[str, CSIVolumeClaim] = field(default_factory=dict)
    # plugin health rollup, denormalized at read time
    schedulable: bool = True
    controller_required: bool = False
    controllers_healthy: int = 0
    nodes_healthy: int = 0
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "CSIVolume":
        return dataclasses.replace(
            self,
            mount_options=dict(self.mount_options),
            secrets=dict(self.secrets),
            parameters=dict(self.parameters),
            context=dict(self.context),
            read_claims={k: v.copy() for k, v in self.read_claims.items()},
            write_claims={k: v.copy() for k, v in self.write_claims.items()},
        )

    # ------------------------------------------------------------- claims

    def write_free(self) -> bool:
        """ref csi.go WriteFreeClaims"""
        if self.access_mode in (ACCESS_MODE_SINGLE_NODE_WRITER,
                                ACCESS_MODE_MULTI_NODE_SINGLE_WRITER):
            return len(self.write_claims) == 0
        if self.access_mode == ACCESS_MODE_MULTI_NODE_MULTI_WRITER:
            return True
        return False

    def read_allowed(self) -> bool:
        return self.access_mode in (
            ACCESS_MODE_SINGLE_NODE_READER, ACCESS_MODE_MULTI_NODE_READER,
            ACCESS_MODE_MULTI_NODE_SINGLE_WRITER,
            ACCESS_MODE_MULTI_NODE_MULTI_WRITER,
            ACCESS_MODE_SINGLE_NODE_WRITER)

    def claim_ok(self, mode: str) -> bool:
        """ref csi.go CSIVolume.Claim* checks"""
        if mode == CLAIM_WRITE:
            return self.write_free()
        return self.read_allowed()

    def in_use(self) -> bool:
        return bool(self.read_claims or self.write_claims)


@dataclass
class CSIPlugin:
    """Aggregated plugin health across the fleet (ref csi.go CSIPlugin)."""
    id: str = ""
    provider: str = ""
    version: str = ""
    controller_required: bool = False
    # node_id -> healthy
    controllers: dict[str, bool] = field(default_factory=dict)
    nodes: dict[str, bool] = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "CSIPlugin":
        return dataclasses.replace(self, controllers=dict(self.controllers),
                                   nodes=dict(self.nodes))

    @property
    def controllers_healthy(self) -> int:
        return sum(1 for h in self.controllers.values() if h)

    @property
    def nodes_healthy(self) -> int:
        return sum(1 for h in self.nodes.values() if h)

    def is_empty(self) -> bool:
        return not self.controllers and not self.nodes


def volume_stub(vol: CSIVolume) -> dict:
    """List-endpoint projection (ref structs.CSIVolListStub)."""
    return {
        "ID": vol.id, "Namespace": vol.namespace, "Name": vol.name,
        "PluginID": vol.plugin_id, "Schedulable": vol.schedulable,
        "AccessMode": vol.access_mode, "AttachmentMode": vol.attachment_mode,
        "CurrentReaders": len(vol.read_claims),
        "CurrentWriters": len(vol.write_claims),
        "ControllerRequired": vol.controller_required,
        "ControllersHealthy": vol.controllers_healthy,
        "NodesHealthy": vol.nodes_healthy,
        "CreateIndex": vol.create_index, "ModifyIndex": vol.modify_index,
    }


def plugin_stub(p: CSIPlugin) -> dict:
    """ref structs.CSIPluginListStub"""
    return {
        "ID": p.id, "Provider": p.provider, "Version": p.version,
        "ControllerRequired": p.controller_required,
        "ControllersHealthy": p.controllers_healthy,
        "ControllersExpected": len(p.controllers),
        "NodesHealthy": p.nodes_healthy, "NodesExpected": len(p.nodes),
        "CreateIndex": p.create_index, "ModifyIndex": p.modify_index,
    }
