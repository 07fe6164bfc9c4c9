"""Volume watcher: the CSI claim-detach state machine (ref
nomad/volumewatcher/volumes_watcher.go + volume_watcher.go — the
leader-only loop that releases claims held by terminal allocations so
volumes become schedulable again).

Claim lifecycle (ref volume_watcher.go volumeReapImpl):

    taken --node unpublish--> node-detached
          --controller unpublish (if plugin requires one)-->
    controller-detached --> ready-to-free (claim dropped)

The reference pushes Node/ControllerUnpublish RPCs to clients; here the
detach RPCs ride the PULL model the rest of the client does (alloc watch,
heartbeats): this watcher gates claim-state transitions, the claimed
node's csimanager polls CSIVolume.NodeDetachPending / a controller node
polls ControllerDetachPending, performs the plugin RPC, and confirms via
a claim update. A claim reaches ready-to-free ONLY after the plugin
round succeeds — except when the claimed node is gone from state (its
plugin can never answer; the reference force-detaches there too).
"""
from __future__ import annotations

import threading

from ..structs.csi import (
    CSIVolumeClaim, CLAIM_STATE_CONTROLLER_DETACHED,
    CLAIM_STATE_NODE_DETACHED, CLAIM_STATE_READY_TO_FREE,
    CLAIM_STATE_TAKEN,
)
from .lifecycle import LoopHandle


class VolumeWatcher:
    """ref volumeswatcher.Watcher"""

    def __init__(self, server, interval: float = 5.0):
        self.server = server
        self.interval = interval
        # explicit start/join lifecycle state (server/lifecycle.py):
        # see deployment_watcher — the handle owns the stop event
        self._loop = LoopHandle()
        self._stop = self._loop.stop_event

    def start(self) -> None:
        self._loop.start(self._run, "volume-watcher")

    def stop(self) -> None:
        self._loop.stop(timeout=self.interval + 5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.reap_once()
            except Exception as e:      # noqa: BLE001
                self.server.logger(f"volumewatcher: {e!r}")

    def reap_once(self) -> int:
        """Advance past-claims through the detach machine (ref
        volume_watcher.go volumeReapImpl). Returns transitions applied."""
        from .fsm import CSI_VOLUME_CLAIM
        state = self.server.state
        moved = 0
        for vol in state.iter_csi_volumes():
            plug = state.csi_plugin_by_id(vol.plugin_id)
            needs_controller = bool(plug and plug.controller_required)
            claims = list(vol.read_claims.values()) + \
                list(vol.write_claims.values())
            for claim in claims:
                alloc = state.alloc_by_id(claim.alloc_id)
                if alloc is not None and not alloc.terminal_status():
                    continue            # live claim: nothing to reap
                cur = claim.state
                # chain the transitions this pass can decide WITHOUT a
                # client confirmation (forced node round, controller-less
                # free) so a reapable claim frees in one pass
                while True:
                    nxt = None
                    if cur == CLAIM_STATE_TAKEN:
                        node = state.node_by_id(claim.node_id)
                        if node is None or node.status == "down":
                            # the node left the cluster (or is down with
                            # its alloc already terminal): its plugin
                            # can't confirm — force past the node round,
                            # like the reference's no-node past-claim path
                            nxt = CLAIM_STATE_NODE_DETACHED
                        # else: wait for the node csimanager's
                        # NodeDetachPending pull; recoverable on failure
                    elif cur == CLAIM_STATE_NODE_DETACHED:
                        if not needs_controller:
                            nxt = CLAIM_STATE_READY_TO_FREE
                        # else: wait for a controller node's confirmation
                    elif cur == CLAIM_STATE_CONTROLLER_DETACHED:
                        nxt = CLAIM_STATE_READY_TO_FREE
                    if nxt is None:
                        break
                    self.server.raft.apply(CSI_VOLUME_CLAIM, {
                        "namespace": vol.namespace, "volume_id": vol.id,
                        "claim": CSIVolumeClaim(
                            alloc_id=claim.alloc_id, node_id=claim.node_id,
                            state=nxt)})
                    moved += 1
                    if nxt == CLAIM_STATE_READY_TO_FREE:
                        break
                    cur = nxt
        return moved
