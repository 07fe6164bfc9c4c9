"""Periodic job dispatch (ref nomad/periodic.go:22 PeriodicDispatch): a
leader-only cron launcher that materializes child jobs `<id>/periodic-<ts>`
and tracks launches in the periodic_launch table.
"""
from __future__ import annotations

import threading
import time
from datetime import datetime, timedelta, timezone
from typing import Optional

from ..structs import Evaluation, Job, TRIGGER_PERIODIC_JOB
from .fsm import JOB_REGISTER, PERIODIC_LAUNCH


def parse_cron_field(field: str, lo: int, hi: int) -> set[int]:
    out: set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            rng = range(lo, hi + 1)
        elif "-" in part:
            a, b = part.split("-", 1)
            rng = range(int(a), int(b) + 1)
        else:
            rng = range(int(part), int(part) + 1)
        out.update(v for v in rng if (v - lo) % step == 0)
    return out


def cron_next(spec: str, after: float, tz: str = "UTC") -> Optional[float]:
    """Next fire time strictly after `after` for a 5-field cron spec, or
    '@every <seconds>s' shorthand. The cron fields are interpreted in
    `tz` (ref structs.PeriodicConfig.TimeZone + GetLocation:
    "3 am every day" means 3 am IN THAT ZONE, across DST shifts)."""
    spec = spec.strip()
    if spec.startswith("@every"):
        arg = spec.split(None, 1)[1].strip()
        if arg.endswith("ms"):
            period = float(arg[:-2]) / 1000.0
        elif arg.endswith("s"):
            period = float(arg[:-1])
        elif arg.endswith("m"):
            period = float(arg[:-1]) * 60
        elif arg.endswith("h"):
            period = float(arg[:-1]) * 3600
        else:
            period = float(arg)
        return after + period
    fields = spec.split()
    if len(fields) != 5:
        return None
    mins = parse_cron_field(fields[0], 0, 59)
    hours = parse_cron_field(fields[1], 0, 23)
    doms = parse_cron_field(fields[2], 1, 31)
    months = parse_cron_field(fields[3], 1, 12)
    # cron DOW: Sun=0 (and 7 as the common Sunday alias)
    dows = {v % 7 for v in parse_cron_field(fields[4], 0, 7)}
    zone = timezone.utc
    if tz and tz.upper() != "UTC":
        try:
            from zoneinfo import ZoneInfo
            zone = ZoneInfo(tz)
        # unknown zone name: UTC fallback below is the documented
        # behavior, not a silent drop
        except Exception:  # nomadlint: disable=EXC001 — UTC fallback
            pass
    t = datetime.fromtimestamp(after, tz=zone).replace(
        second=0, microsecond=0) + timedelta(minutes=1)
    for _ in range(366 * 24 * 60):   # bounded search: one year of minutes
        cron_dow = (t.weekday() + 1) % 7   # Python Mon=0 -> cron Sun=0
        if (t.minute in mins and t.hour in hours and t.day in doms and
                t.month in months and cron_dow in dows):
            return t.timestamp()
        t += timedelta(minutes=1)
    return None


class PeriodicDispatch:
    """ref periodic.go:22"""

    def __init__(self, server):
        self.server = server
        self._lock = threading.Lock()
        self._tracked: dict[tuple[str, str], Job] = {}
        self._enabled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._enabled = enabled
            if enabled and self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(target=self._run, daemon=True,
                                                name="periodic-dispatch")
                self._thread.start()
            if not enabled:
                self._tracked.clear()

    def add(self, job: Job) -> None:
        """Track (or update) a periodic job (ref periodic.go Add)."""
        with self._lock:
            if not self._enabled:
                return
            if not job.is_periodic() or job.stopped():
                self._tracked.pop((job.namespace, job.id), None)
                return
            self._tracked[(job.namespace, job.id)] = job

    def remove(self, namespace: str, job_id: str) -> None:
        with self._lock:
            self._tracked.pop((namespace, job_id), None)

    def tracked(self) -> list[Job]:
        with self._lock:
            return list(self._tracked.values())

    def _run(self) -> None:
        """ref periodic.go:335 run"""
        while not self._stop.wait(1.0):
            with self._lock:
                if not self._enabled:
                    return
                jobs = list(self._tracked.values())
            now = time.time()
            for job in jobs:
                try:
                    self._maybe_launch(job, now)
                except Exception as e:   # noqa: BLE001
                    self.server.logger(f"periodic: {job.id}: {e!r}")

    def _maybe_launch(self, job: Job, now: float) -> None:
        state = self.server.state
        launch = state.periodic_launch_by_id(job.namespace, job.id)
        last = launch["launch"] if launch else 0.0
        tz = job.periodic.timezone or "UTC"
        nxt = cron_next(job.periodic.spec, last or now - 1.0, tz)
        if nxt is None or nxt > now:
            return
        # fast-forward past windows missed while down: launch at most once,
        # at the latest elapsed boundary (ref periodic.go nextLaunch)
        while True:
            after = cron_next(job.periodic.spec, nxt, tz)
            if after is None or after > now:
                break
            nxt = after
        if job.periodic.prohibit_overlap:
            for child in state.iter_jobs(job.namespace):
                # any non-terminal child (pending/blocked included) blocks
                if child.parent_id == job.id and child.status != "dead":
                    return
        self.force_launch(job, nxt)

    def force_launch(self, job: Job, launch_time: Optional[float] = None
                     ) -> Job:
        """Materialize + register the child job (ref periodic.go:413
        createEval / derivedJob)."""
        launch_time = launch_time or time.time()
        child = job.copy()
        child.id = f"{job.id}/periodic-{int(launch_time)}"
        child.parent_id = job.id
        child.periodic = None
        ev = Evaluation(
            namespace=child.namespace, priority=child.priority,
            type=child.type, triggered_by=TRIGGER_PERIODIC_JOB,
            job_id=child.id, status="pending")
        self.server.raft.apply(JOB_REGISTER, {"job": child, "evals": [ev]})
        self.server.raft.apply(PERIODIC_LAUNCH, {
            "namespace": job.namespace, "job_id": job.id,
            "launch": launch_time})
        return child
