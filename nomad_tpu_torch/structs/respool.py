"""Pooled copy-on-write AllocatedResources construction (ISSUE 5: the
zero-copy half of alloc materialization).

Every instance of a task group is identical up to its SEQUENTIAL
resources (ports, device instances, cpuset cores) — yet the placement
paths used to rebuild the whole AllocatedResources object tree per
allocation: one AllocatedSharedResources, one AllocatedTaskResources per
task, per alloc, 50k times for a 50k-task job. A `ResourceSkeleton` is
built once per task group and hands out:

  * for fully-simple groups (no networks/devices/cores anywhere): the ONE
    shared `AllocatedResources` — the exact sharing `_prepare_stamp` /
    `stamp_batch` already rely on (`structs/fastbatch.py`), now available
    to the per-alloc paths too;
  * for groups with sequential tasks: a shallow copy-on-write frame —
    fresh `AllocatedResources` + a fresh shared-resources row only when
    the group reserves networks, with the task dict PRE-SEEDED from the
    shared base rows. The caller replaces only the rows of tasks that
    carry per-alloc sequential state; simple tasks keep pointing at the
    shared base objects.

Sharing contract (same as fastbatch's): shared sub-objects are immutable
by convention — the state store's update paths copy before mutating, and
the usage index's `_xr_usage`/`_xr_seq` caches ride along for free (one
XR-row computation per task group instead of one per alloc).
"""
from __future__ import annotations

from .alloc import (
    AllocatedResources, AllocatedSharedResources, AllocatedTaskResources,
)


class ResourceSkeleton:
    """One task group's immutable resource base + CoW materializer."""

    __slots__ = ("tg", "oversub", "task_base", "seq_task_names", "simple",
                 "shared_total")

    def __init__(self, tg, oversub: bool):
        self.tg = tg
        self.oversub = bool(oversub)
        self.task_base: dict[str, AllocatedTaskResources] = {}
        self.seq_task_names: tuple[str, ...] = ()
        seq = []
        for task in tg.tasks:
            r = task.resources
            tr = AllocatedTaskResources(cpu_shares=r.cpu,
                                        memory_mb=r.memory_mb)
            if self.oversub:
                tr.memory_max_mb = r.memory_max_mb
            self.task_base[task.name] = tr
            if r.networks or r.devices or r.cores > 0:
                seq.append(task.name)
        self.seq_task_names = tuple(seq)
        self.simple = not tg.networks and not seq
        self.shared_total = AllocatedResources(
            shared=AllocatedSharedResources(
                disk_mb=tg.ephemeral_disk.size_mb),
            tasks=dict(self.task_base))

    def task_is_sequential(self, name: str) -> bool:
        return name in self.seq_task_names

    def materialize(self) -> AllocatedResources:
        """One alloc's AllocatedResources. Fully-simple groups share THE
        skeleton object (zero construction); anything else gets a CoW
        frame whose simple task rows still point at the shared base —
        the caller overwrites only the sequential rows it assigns."""
        if self.simple:
            return self.shared_total
        if self.tg.networks:
            shared = AllocatedSharedResources(
                disk_mb=self.tg.ephemeral_disk.size_mb)
        else:
            shared = self.shared_total.shared
        return AllocatedResources(shared=shared,
                                  tasks=dict(self.task_base))


def skeleton_for(cache: dict, tg, oversub: bool) -> ResourceSkeleton:
    """Get-or-build from a caller-owned cache (typically per-eval: task
    group objects are stable for an eval's lifetime). Keyed by identity —
    a job update hands the scheduler new TaskGroup objects, so a stale
    hit is impossible within one cache's lifetime."""
    key = (id(tg), bool(oversub))
    sk = cache.get(key)
    if sk is None or sk.tg is not tg:
        sk = cache[key] = ResourceSkeleton(tg, oversub)
    return sk
