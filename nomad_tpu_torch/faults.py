"""Deterministic fault injection (ISSUE 3 tentpole).

An accelerator-backed control plane inherits a failure domain the host
reference never had: device dispatch can OOM, hang, or lose the
accelerator mid-solve. Gavel (arXiv:2008.09213) and Tesserae (arXiv:2508.04953)
treat accelerator loss as a first-class scheduling event; to *prove* the
recovery paths in tier-1 we need failures that are injectable, seeded,
and bit-reproducible — not `kill -9` roulette.

A `FaultPlan` maps *site names* (dotted paths baked into the production
code: `solver.dispatch.pallas`, `raft.apply`, `heartbeat.invalidate`,
...) to specs. Each spec has a mode:

  raise        fire on every call
  delay        sleep `delay_ms` then continue (slow disk, busy device)
  nth_call     fire on every n-th call at that site (1-based)
  after        fire on EVERY call from the n-th onward (1-based) — the
               partition shape: a link that works N-1 times and then
               stays dead until the plan is cleared/healed
  probability  fire with probability `p` from a PER-SITE seeded RNG —
               same seed => same fire pattern over the site's call
               sequence, independent of other sites' traffic
  torn         BYTES sites only (`faults.mangle(site, data)`): from the
               n-th call onward (default 1), raise TornWriteError
               carrying a seeded PREFIX of the payload — the write site
               writes the prefix, then propagates (power loss mid-write)
  corrupt      BYTES sites only: from the n-th call onward, return the
               payload with ONE seeded bit flipped and continue — the
               write "succeeds" but what reached the platter is damaged
               (silent media corruption, detected later by CRC)

plus common knobs: `times` caps total fires (-1 = unlimited; `times: 1`
is a one-shot), and `exc` picks the raised type (`fault` -> FaultError,
`timeout` -> TimeoutError, `oom` -> MemoryError, `runtime` ->
RuntimeError, `device_lost` -> DeviceLostError, a RuntimeError-shaped
accelerator loss — the default at `device.lost.d<N>` sites) so a site
can simulate its real failure shape.

Install via the test API (`faults.install({...})`) or the environment:

    NOMAD_FAULTS='{"solver.dispatch.pallas": {"mode": "raise"},
                   "raft.apply": {"mode": "nth_call", "n": 3, "times": 2}}'

The env form crosses process boundaries, so the multi-process e2e tier
can chaos a real agent. A site key ending in `.*` prefix-matches
(`solver.dispatch.*` faults every tier); exact keys win over wildcards.

Call sites invoke `faults.fire("<site>")`, a no-op costing one module
attribute read when no plan is installed — the production hot path pays
nothing. Fired/observed counts per site are queryable (`faults.fired`)
and mirrored into metrics (`nomad.faults.fired.<site>`), so tests and
the bench can assert the chaos actually happened.

Site catalog: docs/FAULT_INJECTION.md.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Optional

from .metrics import metrics


class FaultError(RuntimeError):
    """An injected failure. Solver dispatch sites treat it exactly like a
    device-tier error (a CUDA RuntimeError), so failure paths can be
    exercised without a sick card."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at {site}")
        self.site = site


class TornWriteError(FaultError):
    """A `torn`-mode fire at a bytes site (ISSUE 13): `.prefix` is the
    seeded prefix of the payload that "reached the disk" before the
    simulated power loss. The write site's contract: write the prefix,
    flush it, then let this propagate as the crash."""

    def __init__(self, site: str, prefix: bytes):
        super().__init__(site)
        self.prefix = prefix


# The device-loss error type: an accelerator loss raised at the
# `device.lost.d<N>` sites. It derives FaultError, so every dispatch seam
# that demotes on injected faults catches it, and RuntimeError, the base
# class PyTorch raises CUDA runtime failures with.
class DeviceLostError(FaultError, RuntimeError):
    """An injected device loss (`device.lost.d<N>` sites): the
    accelerator behind `device_id` is gone — a reset card, a lost
    host. Dispatch seams classify this as device loss rather than a
    transient failure."""

    def __init__(self, site: str):
        did = -1
        tail = site.rsplit(".", 1)[-1]
        if tail.startswith("d") and tail[1:].isdigit():
            did = int(tail[1:])
        RuntimeError.__init__(
            self, f"INTERNAL: injected DEVICE_LOST at {site}: "
            f"device d{did} handle is invalid")
        self.site = site
        self.device_id = did


def device_lost_error_type():
    """The DeviceLostError class."""
    return DeviceLostError


_EXC_TYPES = {
    "fault": FaultError,
    "timeout": TimeoutError,
    "oom": MemoryError,
    "runtime": RuntimeError,
    "device_lost": None,        # resolved lazily (device_lost_error_type)
}

_MODES = ("raise", "delay", "nth_call", "after", "probability",
          "torn", "corrupt")
# modes that only act on byte payloads (via mangle()); a plain fire()
# at a site matched by one of these is counted but never raises — the
# site has no bytes to tear/corrupt
_BYTES_MODES = ("torn", "corrupt")


class FaultSpec:
    """One site pattern's behavior + its call/fire bookkeeping."""

    __slots__ = ("pattern", "mode", "n", "p", "seed", "delay_ms", "times",
                 "exc", "calls", "fires", "_rng")

    def __init__(self, pattern: str, mode: str, n: int = 1, p: float = 1.0,
                 seed: int = 0, delay_ms: float = 0.0, times: int = -1,
                 exc: str = "fault"):
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r} (one of {_MODES})")
        if exc not in _EXC_TYPES:
            raise ValueError(f"unknown fault exc {exc!r} "
                             f"(one of {tuple(_EXC_TYPES)})")
        if mode in ("nth_call", "after", "torn", "corrupt") and n < 1:
            raise ValueError(f"{mode} requires n >= 1")
        if exc == "fault" and pattern.startswith("device.lost."):
            # device.lost.d<N> sites default to the DeviceLostError-shaped
            # loss (a plain FaultError there would classify as transient
            # and never exercise the rebuild path the site exists for)
            exc = "device_lost"
        self.pattern = pattern
        self.mode = mode
        self.n = int(n)
        self.p = float(p)
        self.seed = int(seed)
        self.delay_ms = float(delay_ms)
        self.times = int(times)
        self.exc = exc
        self.calls = 0
        self.fires = 0
        # per-spec stream seeded off (seed, pattern): a site's fire
        # pattern is a pure function of its own call sequence — other
        # sites' traffic can't perturb it (the determinism contract)
        self._rng = random.Random(f"{self.seed}:{pattern}")

    def should_fire(self) -> bool:
        """Caller already counted the call (self.calls is 1-based)."""
        if 0 <= self.times <= self.fires:
            return False
        if self.mode in ("raise", "delay"):
            return True
        if self.mode == "nth_call":
            return self.calls % self.n == 0
        if self.mode in ("after", "torn", "corrupt"):
            # torn/corrupt compose with `n` + `times` so a crash-point
            # fuzzer can say "tear exactly the k-th write at this site"
            return self.calls >= self.n
        return self._rng.random() < self.p          # probability

    def raise_now(self, site: str) -> None:
        if self.exc == "device_lost":
            raise device_lost_error_type()(site)
        exc_type = _EXC_TYPES[self.exc]
        if exc_type is FaultError:
            raise FaultError(site)
        raise exc_type(f"injected fault at {site}")

    def mangle_now(self, site: str, data: bytes) -> bytes:
        """Apply a fired bytes-mode spec to a payload (under the plan
        lock). `torn` raises with the seeded prefix; `corrupt` returns
        the payload with one seeded bit flipped."""
        if not data:
            if self.mode == "torn":
                raise TornWriteError(site, b"")
            return data
        if self.mode == "torn":
            k = self._rng.randrange(len(data))
            raise TornWriteError(site, data[:k])
        pos = self._rng.randrange(len(data))
        bit = 1 << self._rng.randrange(8)
        return data[:pos] + bytes([data[pos] ^ bit]) + data[pos + 1:]


class FaultPlan:
    """A set of FaultSpecs + thread-safe fire bookkeeping."""

    def __init__(self, specs: dict):
        self._lock = threading.Lock()
        self.specs: dict[str, FaultSpec] = {}
        # site -> (calls, fires) for sites observed but not matched, so
        # tests can assert a site is *wired* without faulting it
        self.observed: dict[str, int] = {}
        for pattern, raw in (specs or {}).items():
            if isinstance(raw, FaultSpec):
                spec = raw
            else:
                spec = FaultSpec(pattern, **{str(k): v
                                             for k, v in dict(raw).items()})
            self.specs[pattern] = spec

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        doc = json.loads(text)
        if not isinstance(doc, dict):
            raise ValueError("NOMAD_FAULTS must be a JSON object "
                             "{site: spec}")
        return cls(doc)

    def _match(self, site: str) -> Optional[FaultSpec]:
        spec = self.specs.get(site)
        if spec is not None:
            return spec
        for pattern, cand in self.specs.items():
            if pattern.endswith(".*") and site.startswith(pattern[:-1]):
                # instantiate a per-site spec on first wildcard match:
                # sharing one RNG/counter across sites would make the
                # fire pattern thread-interleaving-dependent, breaking
                # the per-site determinism contract. `times` therefore
                # caps each concrete site independently.
                child = FaultSpec(site, cand.mode, n=cand.n, p=cand.p,
                                  seed=cand.seed, delay_ms=cand.delay_ms,
                                  times=cand.times, exc=cand.exc)
                self.specs[site] = child
                return child
        return None

    def fire(self, site: str) -> None:
        delay_s = 0.0
        spec = None
        with self._lock:
            self.observed[site] = self.observed.get(site, 0) + 1
            spec = self._match(site)
            if spec is None:
                return
            if spec.mode in _BYTES_MODES:
                # bytes-only modes act through mangle(); a plain fire()
                # at the same site is observed but can't tear anything
                return
            spec.calls += 1
            if not spec.should_fire():
                return
            spec.fires += 1
            metrics.incr("nomad.faults.fired")
            metrics.incr(f"nomad.faults.fired.{site}")
            if spec.mode == "delay":
                delay_s = spec.delay_ms / 1000.0
        if spec.mode == "delay":
            time.sleep(delay_s)                     # outside the lock
            return
        spec.raise_now(site)

    def mangle(self, site: str, data: bytes) -> bytes:
        """Bytes-site injection point (ISSUE 13): returns the payload to
        actually write. `corrupt` returns a seeded one-bit-flipped copy;
        `torn` raises TornWriteError carrying the seeded prefix; every
        NON-bytes mode behaves exactly like fire() here, so one spec can
        target a write site whichever way the test needs."""
        delay_s = 0.0
        spec = None
        with self._lock:
            self.observed[site] = self.observed.get(site, 0) + 1
            spec = self._match(site)
            if spec is None:
                return data
            spec.calls += 1
            if not spec.should_fire():
                return data
            spec.fires += 1
            metrics.incr("nomad.faults.fired")
            metrics.incr(f"nomad.faults.fired.{site}")
            if spec.mode in _BYTES_MODES:
                return spec.mangle_now(site, data)
            if spec.mode == "delay":
                delay_s = spec.delay_ms / 1000.0
        if spec.mode == "delay":
            time.sleep(delay_s)                     # outside the lock
            return data
        spec.raise_now(site)

    def fired(self, site_or_pattern: str) -> int:
        with self._lock:
            spec = self.specs.get(site_or_pattern) \
                or self._match(site_or_pattern)
            return spec.fires if spec else 0

    def calls(self, site: str) -> int:
        with self._lock:
            return self.observed.get(site, 0)


# ------------------------------------------------------------ module API

_plan: Optional[FaultPlan] = None


def install(plan) -> FaultPlan:
    """Install a plan (FaultPlan, dict, or JSON string). Test API twin of
    the NOMAD_FAULTS env install."""
    global _plan
    if isinstance(plan, str):
        plan = FaultPlan.from_json(plan)
    elif isinstance(plan, dict):
        plan = FaultPlan(plan)
    _plan = plan
    return plan


def install_from_env() -> Optional[FaultPlan]:
    text = os.environ.get("NOMAD_FAULTS", "")
    if not text:
        return None
    return install(FaultPlan.from_json(text))


def clear() -> None:
    global _plan
    _plan = None


def active() -> Optional[FaultPlan]:
    return _plan


def fire(site: str) -> None:
    """The injection point. No plan installed => one attribute read."""
    plan = _plan
    if plan is None:
        return
    plan.fire(site)


def mangle(site: str, data: bytes) -> bytes:
    """Bytes-site injection point: the caller writes whatever comes
    back. No plan installed => one attribute read and the same bytes.
    A `torn` spec raises TornWriteError — the site writes `.prefix`,
    flushes, and re-raises (the simulated power loss)."""
    plan = _plan
    if plan is None:
        return data
    return plan.mangle(site, data)


def fired(site: str) -> int:
    plan = _plan
    return plan.fired(site) if plan else 0


# one env read at import: agent/e2e processes inherit NOMAD_FAULTS at
# spawn; in-process tests use install()/clear()
install_from_env()
