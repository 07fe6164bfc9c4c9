"""Client CSI manager (ref client/pluginmanager/csimanager/: volume
staging/publishing for allocs + plugin fingerprinting into the node).

The reference talks gRPC to external CSI plugin processes (plugins/csi/).
Here the plugin boundary is the `CSIPluginClient` interface; the built-in
`HostPathCSIPlugin` implements it with node-local directories (the upstream
csi-driver-host-path analog), which is also what tests exercise. Real
drivers slot in behind the same stage/publish/unpublish contract.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

from ..structs.csi import CSIVolumeClaim, CLAIM_READ, CLAIM_STATE_READY_TO_FREE, CLAIM_WRITE


class CSIPluginClient:
    """ref plugins/csi CSIPlugin interface (node service subset)."""

    name = "csi-plugin"
    requires_controller = False

    def fingerprint(self) -> dict:
        return {"healthy": True, "provider": self.name,
                "provider_version": "0.1.0",
                "requires_controller": self.requires_controller}

    def node_stage_volume(self, volume_id: str, context: dict) -> None:
        pass

    def node_publish_volume(self, volume_id: str, target_path: str,
                            readonly: bool, context: dict) -> None:
        raise NotImplementedError

    def node_unpublish_volume(self, volume_id: str,
                              target_path: str) -> None:
        raise NotImplementedError

    def controller_unpublish_volume(self, volume_id: str,
                                    node_id: str) -> None:
        """Detach the volume from the node at the storage backend (ref
        plugins/csi ControllerUnpublishVolume). Only meaningful for
        plugins with requires_controller; default no-op."""


class HostPathCSIPlugin(CSIPluginClient):
    """Node-local directory-backed volumes (the csi-driver-host-path
    pattern): publish = symlink the per-volume dir at the target path."""

    name = "hostpath"

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)

    def _vol_dir(self, volume_id: str) -> str:
        return os.path.join(self.base_dir, volume_id)

    def node_stage_volume(self, volume_id: str, context: dict) -> None:
        os.makedirs(self._vol_dir(volume_id), exist_ok=True)

    def node_publish_volume(self, volume_id, target_path, readonly, context):
        os.makedirs(os.path.dirname(target_path), exist_ok=True)
        if os.path.islink(target_path):
            os.unlink(target_path)
        os.symlink(self._vol_dir(volume_id), target_path)

    def node_unpublish_volume(self, volume_id, target_path):
        if os.path.islink(target_path):
            os.unlink(target_path)
        elif os.path.isdir(target_path):
            shutil.rmtree(target_path, ignore_errors=True)


class CSIManager:
    """Per-client manager: claims volumes through the servers and drives the
    node plugin's stage/publish lifecycle for each alloc (ref
    csimanager/volume.go MountVolume/UnmountVolume)."""

    def __init__(self, client):
        self.client = client
        self.plugins: dict[str, CSIPluginClient] = {}
        self.controller_plugins: dict[str, CSIPluginClient] = {}
        # (alloc_id, vol_id) -> (plugin_id, target_path)
        self._mounts: dict[tuple[str, str], tuple[str, str]] = {}

    def register_plugin(self, plugin_id: str, plugin: CSIPluginClient,
                        controller: bool = False) -> None:
        self.plugins[plugin_id] = plugin
        if controller or plugin.requires_controller:
            self.controller_plugins[plugin_id] = plugin

    def fingerprint(self) -> dict[str, dict]:
        """node.csi_node_plugins payload."""
        return {pid: p.fingerprint() for pid, p in self.plugins.items()}

    def fingerprint_controllers(self) -> dict[str, dict]:
        """node.csi_controller_plugins payload."""
        return {pid: p.fingerprint()
                for pid, p in self.controller_plugins.items()}

    # ------------------------------------------------------------- mounts

    def mount_volume(self, alloc, req) -> str:
        """Claim + stage + publish; returns the alloc-local mount path
        (ref csimanager MountVolume)."""
        ns = alloc.namespace
        vol = self.client.rpc.csi_volume_get(ns, req.source)
        if vol is None:
            raise ValueError(f"CSI volume {req.source!r} not found")
        plugin = self.plugins.get(vol.plugin_id)
        if plugin is None:
            raise ValueError(
                f"node has no CSI plugin {vol.plugin_id!r}")
        mode = CLAIM_READ if req.read_only else CLAIM_WRITE
        claim = CSIVolumeClaim(alloc_id=alloc.id,
                               node_id=self.client.node.id, mode=mode)
        self.client.rpc.csi_volume_claim(ns, vol.id, claim)
        # record before publish: a failed stage/publish must still release
        # the claim in Postrun (unmount_all)
        target = os.path.join(self.client.alloc_dir_root, alloc.id,
                              "volumes", req.name)
        self._mounts[(alloc.id, vol.id)] = (vol.plugin_id, target)
        plugin.node_stage_volume(vol.id, vol.context)
        plugin.node_publish_volume(vol.id, target, req.read_only,
                                   vol.context)
        return target

    # ---------------------------------------------- watcher-driven detach

    def reconcile_claims(self) -> int:
        """The client half of the volume watcher's unpublish state machine
        (ref volumewatcher/volume_watcher.go + csi_hook): the server marks
        which claims need node/controller detach; this node performs the
        plugin RPCs it can serve and confirms via claim updates. Pull
        model — the client polls, matching the alloc-watch design — so no
        server->client channel is needed. Returns detaches performed."""
        from ..structs.csi import (
            CLAIM_STATE_CONTROLLER_DETACHED, CLAIM_STATE_NODE_DETACHED,
        )
        done = 0
        node_id = self.client.node.id
        try:
            pending = self.client.rpc.csi_node_detach_pending(node_id)
        except Exception:           # noqa: BLE001 — servers unreachable
            return done
        for item in pending:
            plugin = self.plugins.get(item["plugin_id"])
            if plugin is None:
                continue
            target = self._detach_target(item["alloc_id"], item["volume_id"])
            try:
                plugin.node_unpublish_volume(item["volume_id"], target)
                self.client.rpc.csi_volume_claim(
                    item["namespace"], item["volume_id"],
                    CSIVolumeClaim(alloc_id=item["alloc_id"],
                                   node_id=node_id,
                                   state=CLAIM_STATE_NODE_DETACHED))
                done += 1
            except Exception as e:  # noqa: BLE001 — retried next pass
                self.client.logger(f"csi: node detach failed: {e!r}")
        try:
            pending = self.client.rpc.csi_controller_detach_pending(
                list(self.controller_plugins), node_id)
        except Exception:           # noqa: BLE001
            return done
        for item in pending:
            plugin = self.controller_plugins.get(item["plugin_id"])
            if plugin is None:
                continue
            try:
                plugin.controller_unpublish_volume(item["volume_id"],
                                                   item["node_id"])
                self.client.rpc.csi_volume_claim(
                    item["namespace"], item["volume_id"],
                    CSIVolumeClaim(alloc_id=item["alloc_id"],
                                   node_id=item["node_id"],
                                   state=CLAIM_STATE_CONTROLLER_DETACHED))
                done += 1
            except Exception as e:  # noqa: BLE001 — retried next pass
                self.client.logger(f"csi: controller detach failed: {e!r}")
        return done

    def _detach_target(self, alloc_id: str, vol_id: str) -> str:
        """Mount target for a claim — from the live mount record, or the
        conventional path when this client restarted and lost the map."""
        rec = self._mounts.get((alloc_id, vol_id))
        if rec is not None:
            return rec[1]
        vol_dir = os.path.join(self.client.alloc_dir_root, alloc_id,
                               "volumes")
        if os.path.isdir(vol_dir):
            for name in os.listdir(vol_dir):
                path = os.path.join(vol_dir, name)
                if os.path.islink(path) and \
                        os.path.basename(os.readlink(path)) == vol_id:
                    return path
        return os.path.join(vol_dir, vol_id)

    def unmount_all(self, alloc) -> None:
        """Unpublish + release every claim this alloc holds (ref
        csimanager UnmountVolume + csi_hook Postrun)."""
        for (alloc_id, vol_id), (plugin_id, target) in \
                list(self._mounts.items()):
            if alloc_id != alloc.id:
                continue
            plugin = self.plugins.get(plugin_id)
            if plugin is not None:
                try:
                    plugin.node_unpublish_volume(vol_id, target)
                except Exception as e:  # noqa: BLE001 — must keep releasing
                    self.client.logger(f"csi: unpublish failed: {e!r}")
            # a requires_controller plugin still owes the CONTROLLER
            # unpublish round: release only to node-detached and let the
            # volume watcher drive the controller RPC (free would leave
            # the volume attached at the storage backend). Controller-
            # less plugins free directly — the common fast path.
            from ..structs.csi import CLAIM_STATE_NODE_DETACHED
            state = CLAIM_STATE_READY_TO_FREE
            if plugin is not None and plugin.requires_controller:
                state = CLAIM_STATE_NODE_DETACHED
            try:
                self.client.rpc.csi_volume_claim(
                    alloc.namespace, vol_id,
                    CSIVolumeClaim(alloc_id=alloc.id,
                                   node_id=self.client.node.id,
                                   state=state))
            except Exception as e:      # noqa: BLE001 — server may be gone
                self.client.logger(f"csi: release claim failed: {e!r}")
            del self._mounts[(alloc_id, vol_id)]
