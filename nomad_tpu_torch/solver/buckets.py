"""Shape bucketing — the ONE place the solver rounds axes to pow2. Every
padded axis is one shape the kernels see, so padding decisions scattered
across tensorize/placer meant N call sites could silently disagree.

  node_bucket(n)   the padded node axis for n live nodes (floor 8),
                   rounded to a multiple of the mesh's shard count so
                   every shard of the sharded tier gets bucket/S rows
                   (padding rows are infeasible and inert). tensorize,
                   the placer's host padding and the state cache's twins
                   must agree on it.
  pow2(n, floor)   generic pow2 round-up (spread/distinct stanza axes,
                   preemption victim axes, scatter-batch padding).
  BATCH_LANES      the eval-stream micro-batch lane count.

For power-of-two shard counts the mesh rounding is a no-op — a pow2
bucket >= 8 already divides by 1, 2, 4 or 8 shards — but a mesh rebuilt
over survivors (3 of 4, 7 of 8) must not silently unshard every solve,
so the rounding is explicit.
"""
from __future__ import annotations

NODE_BUCKET_FLOOR = 8
BATCH_LANES = 8


def pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, 1), at least `floor`."""
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


def mesh_shards() -> int:
    """The shard count the node axis splits over (1 = solo): the HEALTHY
    shards of the device set (sharding.healthy_devices), re-read on every
    call, so buckets track a quarantine at once — 7 survivors of 8 pad
    every bucket to a multiple of 7. Nothing is cached, so there is no
    count to reset when a test changes the device set (the reference's
    `_reset_shards` drops the fallback it keeps for a jax it cannot
    import)."""
    from . import sharding
    return max(1, len(sharding.healthy_devices()))


def node_bucket(n: int, shards: int = None) -> int:
    """The padded node-axis bucket for `n` live nodes: pow2 (floor 8),
    then rounded up to a multiple of the shard count so every shard of
    the sharded tier sees the same [bucket/S, R'] block shape. Callers
    that hold a `sharding.MeshSnapshot` pass its `shards`, so the bucket
    and the launch layout describe the SAME device set even when a
    rebuild races the eval."""
    b = pow2(n, NODE_BUCKET_FLOOR)
    s = mesh_shards() if shards is None else max(1, int(shards))
    if s > 1 and b % s:
        b += s - (b % s)
    return b
