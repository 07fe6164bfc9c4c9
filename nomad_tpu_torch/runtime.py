"""Process-level runtime tuning for long-lived server processes (a copy
of nomad_tpu/runtime.py, but for the compile cache, which here holds the
CUDA kernels' built libraries).

CPython's default GC thresholds (700 gen0 allocations) make a 50k-alloc
plan pay hundreds of stop-the-world generational scans across the
scheduler -> plan-apply -> FSM pipeline (the reference measured a
visible share of its end-to-end headline), smeared across whichever phase
the collector happened to fire in. The Go reference pays none of this (concurrent GC + arena-friendly
structs; ref nomad/plan_apply.go:204 applyPlan). Raising the thresholds
amortizes cycle detection to a sane cadence for an allocation-heavy
server: reference-counting still frees the (acyclic) bulk — plans,
allocations, tensors — immediately; the cycle collector only needs to run
occasionally for the rare cyclic leftovers.

Called from Server.start(), and by chip_smoke.py before its first eval.
"""
from __future__ import annotations

import gc
import os
import subprocess

# gen0: collections per ~200k container allocations instead of 700 —
# a 50k-alloc plan triggers a handful of scans, not ~300.
GC_GEN0 = 200_000
GC_GEN1 = 100
GC_GEN2 = 100

_tuned = False


def tune_gc(freeze_baseline: bool = False) -> None:
    """Apply server GC thresholds (idempotent). With freeze_baseline=True,
    objects alive NOW (module/import graph, restored snapshot) move to the
    permanent generation so future full collections skip them."""
    global _tuned
    if not _tuned:
        gc.set_threshold(GC_GEN0, GC_GEN1, GC_GEN2)
        _tuned = True
    if freeze_baseline:
        gc.freeze()


_cache_enabled = False


def enable_compile_cache(path: str = "") -> str:
    """Point the CUDA kernels' build directory (solver/cuda_kernels.py
    BUILD_DIR) at a durable directory: `path`, else NOMAD_COMPILE_CACHE,
    else the directory the kernels already build into. The built `.so`
    files are the port's compiled artifacts, named by a hash of their
    sources and flags, so a warm restart loads them and skips nvcc
    (counted as `nomad.compile_cache.hits`). Idempotent; returns the
    directory. Call before the first kernel loads."""
    global _cache_enabled
    from pathlib import Path

    from .solver import cuda_kernels
    if not path:
        path = os.environ.get("NOMAD_COMPILE_CACHE",
                              str(cuda_kernels.BUILD_DIR))
    if _cache_enabled:
        return path
    os.makedirs(path, exist_ok=True)
    cuda_kernels.BUILD_DIR = Path(path)
    _cache_enabled = True
    return path


_native_built = False


def ensure_native(timeout: float = 120.0) -> bool:
    """Build the native sidecars (native/Makefile: executor, logmon,
    allocstamp extension) if the toolchain is present — compiled artifacts
    are NOT committed (ADVICE r4: unreviewable + silently stale vs their
    sources); deploy/test/bench entrypoints call this once instead. make
    is a fast no-op when everything is current; a flock serializes
    concurrent builders. Returns False (and stays quiet) when no
    toolchain exists — every native consumer has a pure-Python fallback.
    """
    global _native_built
    if _native_built:
        return True
    native_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    if not os.path.isfile(os.path.join(native_dir, "Makefile")):
        return False
    try:
        import fcntl
        with open(os.path.join(native_dir, ".build.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            r = subprocess.run(
                ["make", "-C", native_dir, "all"], timeout=timeout,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        _native_built = r.returncode == 0
    except Exception:
        _native_built = False
    return _native_built
