"""The solver's device layout on one card — the single-card part of
nomad_tpu/solver/sharding.py that the server, the micro-batcher and the
device-runtime telemetry read.

One card, no mesh: `MeshSnapshot` always carries mesh None and one
shard, the generation stays where `reset` put it (nothing rebuilds a
mesh), and the quarantine is empty. `fire_device_loss_sites` is the
`device.lost.d0` fault seam the micro-batcher's coalesced dispatch fires,
as the reference fires it at every dispatch seam. `describe` is the
operator debug bundle's Mesh block.

Not ported: the mesh itself, its rebuild on device loss and every
sharded solve (`sharded_fill_depth`, `sharded_place_chunked`,
`cross_shard_top_k`, ...). They wait for the multi-device port (M10,
ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import threading

from .. import faults
from ..metrics import metrics

NODE_AXIS = "nodes"

# replay ceiling per in-flight dispatch in the reference's mesh rebuild;
# kept for its readers (one card replays nothing)
MAX_REPLAYS = 8

_lock = threading.Lock()
_generation: int = 0
_quarantined: set[int] = set()


class MeshSnapshot:
    """Mesh + generation + shard count captured in one read. One card:
    mesh None, one shard."""

    __slots__ = ("mesh", "generation", "shards")

    def __init__(self, mesh, generation: int):
        self.mesh = mesh
        self.generation = generation
        self.shards = 1


def snapshot() -> MeshSnapshot:
    with _lock:
        return MeshSnapshot(None, _generation)


def generation() -> int:
    """The current mesh generation (one card: nothing bumps it)."""
    return _generation


def quarantined() -> frozenset:
    """Device ids quarantined out of the mesh (one card: none)."""
    return frozenset(_quarantined)


def fire_device_loss_sites() -> None:
    """The `device.lost.d0` fault site, fired at a dispatch seam's entry,
    so a test can lose the card at the n-th dispatch. Costs one module
    attribute read when no plan is armed."""
    if faults.active() is None:
        return
    faults.fire("device.lost.d0")


def describe() -> dict:
    """The operator debug bundle's Mesh block: generation, quarantine and
    the shard count."""
    with _lock:
        return {
            "Generation": _generation,
            "QuarantinedDevices": sorted(_quarantined),
            "HealthyDevices": 1,
            "Shards": 1,
            "AxisName": NODE_AXIS,
        }


def reset() -> None:
    """Tests: the generation back to 0 and the quarantine emptied."""
    global _generation
    with _lock:
        _generation = 0
        _quarantined.clear()
        metrics.set_gauge("nomad.mesh.generation", 0)
        metrics.set_gauge("nomad.mesh.quarantined_devices", 0)
