"""What a traced window hands each per-layer metric's reader.

A reader (metrics/<name>.py) is a module with read(w) -> float | None,
where `w` is a Window: the program's timers and counters over the window
(the registry's values at the close less those at the open), the evals
the workers processed in it, the clients' waits, the device trace and the
hand kernels' recorded calls with their rooflines. A reader that finds nothing to read
returns None, and the harness leaves the metric out of the line.
"""
from __future__ import annotations

import statistics

INVOKE = "nomad.worker.invoke_scheduler_"


class Probe:
    """The registry's sample sums, counts and counters at the open; the
    same at the close."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.open = self._read()
        self.shut = None

    def _read(self) -> dict:
        m = self.metrics
        return {"samples": {k: (s.sum, s.total)
                            for k, s in list(m.samples.items())},
                "counters": dict(m.counters)}

    def close(self) -> None:
        self.shut = self._read()
        # the raw values recorded in the window, read now, before later
        # samples can push them out of the ring
        self.raw = {}
        for k, (_, total) in self.shut["samples"].items():
            skip = self.open["samples"].get(k, (0.0, 0))[1]
            if total > skip:
                self.raw[k] = self.metrics.samples[k].raw_window(skip)


class Window:
    def __init__(self, probe: Probe, device_trace=None, kernel_calls=(),
                 rooflines=None, window_s: float = 0.0, latencies=()):
        self.probe = probe
        # the clients' register -> complete waits in the window (s)
        self.latencies = sorted(latencies)
        self.device = device_trace
        self.kernel_calls = list(kernel_calls)
        self.rooflines = rooflines or {}
        self.window_s = window_s

    def timer_sum(self, name: str) -> float:
        s1, _ = self.probe.shut["samples"].get(name, (0.0, 0))
        s0, _ = self.probe.open["samples"].get(name, (0.0, 0))
        return s1 - s0

    def timer_count(self, name: str) -> int:
        _, n1 = self.probe.shut["samples"].get(name, (0.0, 0))
        _, n0 = self.probe.open["samples"].get(name, (0.0, 0))
        return n1 - n0

    def samples(self, name: str) -> list:
        return list(self.probe.raw.get(name, ()))

    def names(self, prefix: str) -> list:
        return sorted(k for k in self.probe.shut["samples"]
                      if k.startswith(prefix))

    def counter(self, name: str) -> float:
        return (self.probe.shut["counters"].get(name, 0.0)
                - self.probe.open["counters"].get(name, 0.0))

    def evals_processed(self) -> int:
        """Scheduler invocations in the window, of every eval type."""
        return sum(self.timer_count(k) for k in self.names(INVOKE))

    def per_eval_ms(self, name: str):
        """A timer's sum in the window over the evals processed in it, in
        ms; None where the timer recorded nothing in the window."""
        n = self.evals_processed()
        if not n or not self.timer_count(name):
            return None
        return self.timer_sum(name) / n * 1e3

    def median_ms(self, name: str):
        vals = self.samples(name)
        return statistics.median(vals) * 1e3 if vals else None
