"""In-process telemetry: counters + latency samples + labeled fixed-bucket
histograms on the scheduler hot path (ref nomad/worker.go:461,553
`nomad.worker.invoke_scheduler_*`, nomad/plan_apply.go:185,204
`nomad.plan.evaluate`/`nomad.plan.submit`, armon/go-metrics used
throughout the reference).

A single process-global registry; the agent surfaces it at /v1/metrics and
bench.py reads it for the per-phase breakdown. Lock-free fast path: CPython
dict/float ops are atomic enough for monitoring data, and the hot loop
(50k-alloc plans) must not take a lock per sample.

Every sample keeps (a) a bounded RING of raw values for in-process
percentiles — newest-N, so a long-running stream reports steady state,
not startup (ISSUE 7 satellite) — and (b) cumulative fixed-bucket counts
so the Prometheus exposition carries real quantiles (histogram type with
`_bucket{le=...}` lines, not a `_count`/`_sum`-only summary). Labeled
histograms (`observe(name, v, labels=...)`) serve the few metrics where a
bounded dimension (tier, scheduler type, disposition) is worth a real
label instead of a metric-name suffix — nomadlint OBS001 polices the
unbounded-name-interpolation anti-pattern.
"""
from __future__ import annotations

import bisect
import time
from contextlib import contextmanager

RAW_VALUES_CAP = 4096       # per-sample raw-value ring for percentiles

# fixed bucket bounds (seconds-oriented; counts/sizes reuse them as plain
# magnitudes). FIXED per process lifetime: cumulative bucket counts are
# only mergeable/exposable if the bounds never move under them.
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0)


class _Sample:
    __slots__ = ("count", "sum", "min", "max", "last", "values", "total",
                 "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0
        self.last = 0.0
        # bounded raw-value RING so readers can compute percentiles over
        # the newest RAW_VALUES_CAP values (p50 stream batch size, p50
        # submit latency); list append/setitem is atomic under the GIL,
        # matching the lock-free writer contract. `total` counts every
        # value ever recorded — the ring write position AND the `skip`
        # checkpoint unit for windowed bench percentiles.
        self.values: list = []
        self.total = 0
        # cumulative fixed-bucket counts (len(DEFAULT_BUCKETS)+1, last is
        # +Inf) for the Prometheus histogram exposition
        self.buckets = [0] * (len(DEFAULT_BUCKETS) + 1)

    def add(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.last = v
        if len(self.values) < RAW_VALUES_CAP:
            self.values.append(v)
        else:
            self.values[self.total % RAW_VALUES_CAP] = v
        self.total += 1
        self.buckets[bisect.bisect_left(DEFAULT_BUCKETS, v)] += 1

    def raw_window(self, skip: int = 0) -> list:
        """Values recorded after the `skip` checkpoint, oldest-first,
        bounded by what the ring still holds (the newest
        RAW_VALUES_CAP). A checkpoint older than the ring returns the
        whole ring — every surviving value IS inside the window."""
        n = len(self.values)
        if n == 0 or skip >= self.total:
            return []
        if self.total <= RAW_VALUES_CAP:
            return self.values[skip:]
        head = self.total % RAW_VALUES_CAP
        ordered = self.values[head:] + self.values[:head]
        want = min(self.total - skip, RAW_VALUES_CAP)
        return ordered[-want:]

    def as_dict(self) -> dict:
        mean = self.sum / self.count if self.count else 0.0
        bounds = list(DEFAULT_BUCKETS) + ["+Inf"]
        return {"count": self.count, "sum": round(self.sum, 6),
                "min": round(self.min, 6) if self.count else 0.0,
                "max": round(self.max, 6), "mean": round(mean, 6),
                "last": round(self.last, 6),
                # non-cumulative nonzero buckets: what the UI's metrics
                # page renders as a distribution (ISSUE 7 satellite)
                "buckets": [[bounds[i], c]
                            for i, c in enumerate(self.buckets) if c]}


class _Hist:
    """One labeled histogram series: cumulative fixed buckets + sum/count
    (the Prometheus histogram data model, per label set)."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float, bounds) -> None:
        self.counts[bisect.bisect_left(bounds, v)] += 1
        self.sum += v
        self.count += 1


class _HistFamily:
    __slots__ = ("bounds", "series", "help")

    def __init__(self, bounds=DEFAULT_BUCKETS, help_text: str = ""):
        self.bounds = tuple(bounds)
        self.series: dict[tuple, _Hist] = {}   # sorted label items -> series
        self.help = help_text


class Registry:
    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.samples: dict[str, _Sample] = {}
        self.hists: dict[str, _HistFamily] = {}
        self.help: dict[str, str] = {}         # metric name -> # HELP text

    # ------------------------------------------------------------- writers

    def incr(self, name: str, v: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + v

    def set_gauge(self, name: str, v: float) -> None:
        self.gauges[name] = v

    def add_sample(self, name: str, seconds: float) -> None:
        s = self.samples.get(name)
        if s is None:
            s = self.samples[name] = _Sample()
        s.add(seconds)

    def observe(self, name: str, v: float, labels: dict = None,
                buckets=None) -> None:
        """Labeled fixed-bucket histogram observation. Labels must be a
        BOUNDED dimension (tier, scheduler type, disposition); ids and
        node names belong in trace attributes, not metric labels
        (OBS001). `buckets` applies only on first touch of `name`."""
        fam = self.hists.get(name)
        if fam is None:
            fam = self.hists[name] = _HistFamily(buckets or DEFAULT_BUCKETS)
        key = tuple(sorted(labels.items())) if labels else ()
        h = fam.series.get(key)
        if h is None:
            h = fam.series[key] = _Hist(len(fam.bounds))
        h.observe(v, fam.bounds)

    def describe(self, name: str, help_text: str) -> None:
        """Attach Prometheus `# HELP` text to a metric name (counters,
        gauges, samples, and histograms all honor it)."""
        self.help[name] = help_text

    @contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_sample(name, time.perf_counter() - t0)

    # ------------------------------------------------------------- readers

    def timer_sum(self, name: str) -> float:
        s = self.samples.get(name)
        return s.sum if s else 0.0

    def percentile(self, name: str, q: float, skip: int = 0) -> float:
        """q in [0, 1] over the sample's raw-value ring. The ring keeps
        the NEWEST RAW_VALUES_CAP values (a long-running stream reports
        steady state, not the first 4096 startup samples). `skip` drops
        values recorded before a checkpoint taken with sample_count(),
        so a caller can window the percentile to samples recorded after
        it (the bench's timed-stream windows)."""
        s = self.samples.get(name)
        if s is None:
            return 0.0
        vals = sorted(s.raw_window(skip))
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, max(0, int(q * len(vals))))
        return vals[idx]

    def sample_count(self, name: str) -> int:
        """How many raw values the sample has EVER recorded — the `skip`
        checkpoint for a later windowed percentile()."""
        s = self.samples.get(name)
        return s.total if s else 0

    def ratio(self, num: str, den: str) -> float:
        """timer_sum(num) / timer_sum(den), 0.0 when the denominator is
        empty — e.g. phase_overlap_fraction = time the host spent working
        while device/applier work was in flight, over all host time."""
        d = self.timer_sum(den)
        return self.timer_sum(num) / d if d else 0.0

    def counter(self, name: str) -> float:
        return self.counters.get(name, 0.0)

    def snapshot(self) -> dict:
        # lock-free writers can insert a first-seen key mid-iteration;
        # retry the copy rather than taking a lock on the hot path
        for _ in range(16):
            try:
                counters = dict(self.counters)
                gauges = dict(self.gauges)
                samples = dict(self.samples)
                # the per-family series dicts grow lock-free too (first
                # observe() of a new label set) — copy them INSIDE the
                # retry, or a concurrent insert crashes the scrape
                hists = {k: (fam.bounds, dict(fam.series))
                         for k, fam in dict(self.hists).items()}
                break
            except RuntimeError:
                continue
        return {
            "counters": {k: counters[k] for k in sorted(counters)},
            "gauges": {k: gauges[k] for k in sorted(gauges)},
            "samples": {k: samples[k].as_dict() for k in sorted(samples)},
            "histograms": {
                k: {
                    "buckets": list(hists[k][0]),
                    "series": {
                        "" if not key else ",".join(
                            f"{lk}={lv}" for lk, lv in key): {
                            "counts": list(h.counts),
                            "sum": round(h.sum, 6), "count": h.count}
                        for key, h in sorted(hists[k][1].items())},
                } for k in sorted(hists)},
        }

    # --------------------------------------------------------- prometheus

    def _sanitizer(self):
        """Collision-safe name sanitization: two distinct metric names
        must never sanitize to the same exposition name (ISSUE 7
        satellite — `a.b-c` and `a.b_c` used to collide silently). The
        first claimant keeps the clean form; later colliders get a
        short stable hash suffix."""
        import hashlib
        taken: dict[str, str] = {}

        def san(name: str) -> str:
            base = "".join(c if c.isalnum() or c == "_" else "_"
                           for c in name)
            owner = taken.get(base)
            if owner is None:
                taken[base] = name
                return base
            if owner == name:
                return base
            suffix = hashlib.sha1(name.encode()).hexdigest()[:6]
            out = f"{base}_{suffix}"
            taken[out] = name
            return out
        return san

    def prometheus(self, extra_gauges: dict = None) -> str:
        """Prometheus text exposition of the registry (ref
        telemetry.prometheus_metrics + armon/go-metrics' prometheus
        sink): counters as counters, gauges as gauges, samples and
        labeled histograms as real histograms (`_bucket{le=...}` +
        `_sum` + `_count`) with `_min`/`_max`/`_mean` companion gauges
        and `# HELP` lines."""
        san = self._sanitizer()
        lines = []
        # copy only what this exposition reads (snapshot() would also
        # serialize every sample/histogram into dicts we'd discard);
        # same lock-free-writer retry as snapshot()
        for _ in range(16):
            try:
                counters = {k: self.counters[k]
                            for k in sorted(self.counters)}
                gauges = dict(self.gauges)
                break
            except RuntimeError:
                continue

        def emit_head(n: str, orig: str, mtype: str) -> None:
            lines.append(f"# HELP {n} {self.help.get(orig, orig)}")
            lines.append(f"# TYPE {n} {mtype}")

        for k, v in counters.items():
            n = san(k)
            emit_head(n, k, "counter")
            lines.append(f"{n} {v}")
        gauges.update(extra_gauges or {})
        for k, v in sorted(gauges.items()):
            n = san(k)
            emit_head(n, k, "gauge")
            lines.append(f"{n} {v}")
        for _ in range(16):     # lock-free writers, like snapshot()
            try:
                samples = dict(self.samples)
                break
            except RuntimeError:
                continue
        for k in sorted(samples):
            s = samples[k]
            n = san(k)
            emit_head(n, k, "histogram")
            acc = 0
            for bound, c in zip(DEFAULT_BUCKETS, s.buckets):
                acc += c
                lines.append(f'{n}_bucket{{le="{bound}"}} {acc}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {s.count}')
            lines.append(f"{n}_sum {round(s.sum, 6)}")
            lines.append(f"{n}_count {s.count}")
            d = s.as_dict()
            for stat in ("min", "max", "mean"):
                sn = san(f"{k}.{stat}")
                lines.append(f"# TYPE {sn} gauge")
                lines.append(f"{sn} {d[stat]}")
        for _ in range(16):
            try:
                hists = {k: (fam.bounds, dict(fam.series))
                         for k, fam in dict(self.hists).items()}
                break
            except RuntimeError:
                continue
        for k in sorted(hists):
            bounds, series = hists[k]
            n = san(k)
            emit_head(n, k, "histogram")
            for key, h in sorted(series.items()):
                lbl = ",".join(f'{lk}="{lv}"' for lk, lv in key)
                pre = f"{lbl}," if lbl else ""
                acc = 0
                for bound, c in zip(bounds, h.counts):
                    acc += c
                    lines.append(f'{n}_bucket{{{pre}le="{bound}"}} {acc}')
                lines.append(f'{n}_bucket{{{pre}le="+Inf"}} {h.count}')
                tail = f"{{{lbl}}}" if lbl else ""
                lines.append(f"{n}_sum{tail} {round(h.sum, 6)}")
                lines.append(f"{n}_count{tail} {h.count}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.samples.clear()
        self.hists.clear()


metrics = Registry()

# read-path scale-out telemetry (ISSUE 16): pre-registered HELP text so
# the Prometheus page documents the staleness/backpressure counters even
# before they first move (reset() keeps help, so tests see these too)
metrics.describe("nomad.read.leader_served",
                 "list/get reads served from the leader's store")
metrics.describe("nomad.read.follower_served",
                 "list/get reads served from a follower's replicated "
                 "store (stale reads)")
metrics.describe("nomad.event.subscriber_dropped",
                 "event subscribers closed for falling behind after "
                 "coalescing could not shrink their queue (last rung)")
metrics.describe("nomad.event.coalesced_batches",
                 "per-subscriber queue folds (backpressure rung 1)")
metrics.describe("nomad.event.coalesced_events",
                 "events superseded latest-wins-per-key by coalescing")
metrics.describe("nomad.event.waiters_parked",
                 "blocking queries parked on the event broker instead "
                 "of poll-looping the state store")


def record_swallowed_error(site: str, err: BaseException,
                           logger=None) -> None:
    """EXC001 discipline: daemon paths that deliberately survive an
    exception must still surface it — a total `nomad.swallowed_errors`
    counter (plus a per-site breakdown) moves on the /v1/metrics page,
    and the owning component's logger gets one line. `logger=None` keeps
    the counter for components without one (e.g. the state store's event
    sinks)."""
    metrics.incr("nomad.swallowed_errors")
    # sites are short literals at the call sites, never interpolated ids
    # nomadlint: disable=OBS001 — bounded per-site breakdown
    metrics.incr(f"nomad.swallowed_errors.{site}")
    if logger is not None:
        try:
            logger(f"{site}: swallowed {err!r}")
        except Exception:       # noqa: BLE001 — telemetry must not throw
            pass
