"""Shape bucketing — the ONE place the solver rounds axes to pow2. Every
padded axis is one shape the kernels see, so padding decisions scattered
across tensorize/placer meant N call sites could silently disagree.

  node_bucket(n)   the padded node axis for n live nodes (floor 8),
                   rounded to a multiple of the device count. The port
                   solves on one card with no mesh, so the count is 1.
  pow2(n, floor)   generic pow2 round-up (spread/distinct stanza axes,
                   preemption victim axes, scatter-batch padding).
  BATCH_LANES      the eval-stream micro-batch lane count.
"""
from __future__ import annotations

NODE_BUCKET_FLOOR = 8
BATCH_LANES = 8


def pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, 1), at least `floor`."""
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


def mesh_shards() -> int:
    """Device count the node axis is split over: one card, no mesh."""
    return 1


def node_bucket(n: int, shards: int = None) -> int:
    """The padded node-axis bucket for `n` live nodes: pow2 (floor 8),
    then rounded up to a multiple of `shards` (default mesh_shards())."""
    b = pow2(n, NODE_BUCKET_FLOOR)
    s = mesh_shards() if shards is None else max(1, int(shards))
    if s > 1 and b % s:
        b += s - (b % s)
    return b
