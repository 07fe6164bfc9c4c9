"""Device-runtime telemetry over torch.cuda: what the card's runtime is
doing, surfaced next to the scheduler's own counters. Counterpart of
nomad_tpu/obs/devruntime.py, with the same `snapshot()` keys.

Three families, all bounded-cardinality:

  * per-card memory/buffer gauges
    `nomad.device.{mem_bytes_in_use,mem_peak_bytes,live_buffers}.d<N>`,
    from torch.cuda.memory_allocated, max_memory_allocated and the
    caching allocator's `active.all.current` block count;
  * compile-cache counters `nomad.compile_cache.{hits,misses}`, fed by
    solver/cuda_kernels.py: a hit when a kernel's library is found built,
    a miss when nvcc has to build it (the built libraries are the port's
    compiled artifacts; runtime.enable_compile_cache points them at a
    durable directory);
  * the mesh layout, from solver/sharding.describe() (one card: one
    shard, no mesh).

Best-effort and exception-proof: telemetry never takes down a scheduler.
A process that has not touched the card lists no device rows (reading
the allocator's statistics does not create a CUDA context).
`refresh_gauges()` runs on every debug-bundle capture (pull-driven, no
background thread)."""
from __future__ import annotations

import os
import threading

from ..metrics import metrics

_lock = threading.Lock()
_installed = False


def install() -> None:
    """Make the compile-cache counters exist even when nothing was built
    or loaded yet (idempotent)."""
    global _installed
    with _lock:
        if _installed:
            return
        _installed = True
    metrics.incr("nomad.compile_cache.hits", 0)
    metrics.incr("nomad.compile_cache.misses", 0)


def _device_rows() -> list[dict]:
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    rows = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        stats = torch.cuda.memory_stats(i)
        rows.append({
            "id": i,
            "platform": "gpu",
            "kind": props.name,
            "process_index": 0,
            "mem_bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "mem_peak_bytes": int(torch.cuda.max_memory_allocated(i)),
            "mem_limit_bytes": int(props.total_memory),
            "live_buffers": int(stats.get("active.all.current", 0)),
        })
    return rows


def _mesh_layout() -> dict:
    try:
        from ..solver import sharding
        shards = sharding.describe()["Shards"]
        return {"sharded": shards > 1, "devices": shards}
    except Exception:       # noqa: BLE001
        return {"sharded": False, "devices": 0}


def refresh_gauges() -> list[dict]:
    """Re-sample the per-card gauges into the registry and return the
    rows. Called per capture — no background cadence to tune."""
    install()
    try:
        rows = _device_rows()
    except Exception:       # noqa: BLE001 — no card runtime, no gauges
        return []
    for row in rows:
        suffix = f"d{row['id']}"
        metrics.set_gauge(f"nomad.device.mem_bytes_in_use.{suffix}",
                          row["mem_bytes_in_use"])
        metrics.set_gauge(f"nomad.device.mem_peak_bytes.{suffix}",
                          row["mem_peak_bytes"])
        metrics.set_gauge(f"nomad.device.live_buffers.{suffix}",
                          row["live_buffers"])
    return rows


def snapshot() -> dict:
    """The debug-bundle block: devices + mesh layout + compile-cache
    counters + where the compiled kernels persist."""
    rows = refresh_gauges()
    return {
        "devices": rows,
        "mesh": _mesh_layout(),
        "compile_cache": {
            "hits": int(metrics.counter("nomad.compile_cache.hits")),
            "misses": int(metrics.counter("nomad.compile_cache.misses")),
            "persistent_dir": os.environ.get("NOMAD_COMPILE_CACHE", ""),
        },
    }
