"""Per-eval host↔device transition accounting (ISSUE 15 satellite).

Every seam that launches a compiled device program for an in-flight eval
notes itself here — the state cache's per-eval gather, the backend
chain's tier dispatches, the micro-batcher's shared window, the explain
reduce's device route, the sharded preemption scan, and the fused
whole-eval program. `compute_placements` brackets the eval; at exit the
total lands in the `nomad.solver.device_round_trips` histogram and the
per-phase counts in `nomad.solver.dispatches.<phase>` counters.

This is the STRUCTURAL lineage behind the fused-dispatch contract: on
the fused stream an eval's count is exactly 1 (one program, one
device_get at the placer's sync seam), where the unfused device-resident
path paid gather + solve + explain (3). Wall-clock-insensitive, so the
bench gate on it arms even on the 1-core box (BENCH note pattern).

Counting rule: a "round trip" is one compiled-program dispatch issued on
behalf of the current eval, on any non-host tier (the host tier never
leaves the host). Counts accrue on the EVAL's own thread — shared
micro-batch windows are counted once per lane rider at its blocking
seam, which is exactly "how many times did THIS eval touch the device".
Phases are a bounded enum (metric-name hygiene, OBS001).
"""
from __future__ import annotations

import threading

from ..metrics import metrics

# bounded phase enum — these feed metric names
PHASES = ("gather", "solve", "explain", "preempt", "fused")

_tls = threading.local()


def begin() -> None:
    """Open the per-eval accounting scope (placer.compute_placements)."""
    _tls.counts = {}
    _tls.active = True


def note(phase: str, n: int = 1) -> None:
    """Record `n` device dispatches for `phase`. No-op outside an eval
    scope (applier-thread cache feeds, warmup, bench probes)."""
    if phase not in PHASES:
        phase = "solve"
    metrics.incr(f"nomad.solver.dispatches.{phase}", n)
    if getattr(_tls, "active", False):
        _tls.counts[phase] = _tls.counts.get(phase, 0) + n


def end() -> int:
    """Close the eval scope: emit the histogram sample, return the
    eval's total transition count."""
    counts = getattr(_tls, "counts", None)
    _tls.active = False
    if counts is None:
        return 0
    total = sum(counts.values())
    metrics.add_sample("nomad.solver.device_round_trips", total)
    _tls.counts = {}
    return total
