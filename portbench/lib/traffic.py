"""The one traffic generator: a closed loop of clients, each registering
jobs drawn from a mix's parameters (traffic/<mix>.json).

A mix holds:

    clients        how many clients run the loop at once; each sends its
                   next job only after the eval of the last one completed
    job            the job's shape: type (batch or service), cpu_mhz,
                   memory_mb, disk_mb, priority, datacenters, and
                   optionally spread (a node attribute, e.g.
                   "${meta.rack}", and its weight)
    count          {"fixed": n}, or {"log_uniform": [lo, hi], "levels":
                   L}: the L quantiles of the log-uniform law over
                   [lo, hi], which every client walks in one order drawn
                   from the seed, client c starting at its c-th entry
                   (every seed sends the same sizes)
    after_commit   what a client does once its job's eval completed, in
                   order: {"do": "complete", "lag": k} reports the
                   allocations of its job of k cycles before complete,
                   as the nodes' clients would, in one update that the
                   client makes itself and waits for, and then waits for
                   the evals that the completion creates;
                   {"do": "deregister", "lag": k} stops its job of k
                   cycles before (k = 0: the job just placed) and waits
                   for that eval; {"do": "refill"} registers the filler
                   again and waits for its eval
    filler         optional: a job that set-up registers to fill every
                   node (its count is what the fleet holds of its ask),
                   with type, cpu_mhz, memory_mb, disk_mb, priority,
                   datacenters
    limits         the reference's numbers this mix is judged by, each
                   with its limit (reference.py or checks/<limit>.py,
                   and misplaced_pct, placement.py and scan.py)
    compare_passes how many of the register evals' passes the reference
                   of the placements works out again, drawn from the
                   seed with the largest always in (0 or absent: all)

Nothing here imports the program: a job is a plain record, which the
driver turns into the program's job and the reference reads as it is.
"""
from __future__ import annotations

import math

import numpy as np

ACTIONS = ("complete", "deregister", "refill")


def validate(mix: dict) -> None:
    if int(mix["clients"]) < 1:
        raise ValueError("a mix needs at least one client")
    c = mix["count"]
    if ("fixed" in c) == ("log_uniform" in c):
        raise ValueError("count takes one of fixed and log_uniform")
    for act in mix.get("after_commit", []):
        if act["do"] not in ACTIONS:
            raise ValueError(f"unknown action {act['do']!r}")
        if act["do"] == "refill" and not mix.get("filler"):
            raise ValueError("refill needs a filler")


def count_levels(count: dict) -> list:
    """The instance counts a client walks."""
    if "fixed" in count:
        return [int(count["fixed"])]
    lo, hi = count["log_uniform"]
    levels = int(count["levels"])
    a, b = math.log(lo), math.log(hi)
    return [int(round(math.exp(a + (i + 0.5) / levels * (b - a))))
            for i in range(levels)]


class Client:
    """One client's sequence of jobs: cycle k's job record. The seed
    draws one order of the levels, which every client walks from its own
    offset: in each round of cycles, clients 0..L-1 ask for every level
    once, so every seed sends the same sizes at the same time, in
    another arrangement."""

    def __init__(self, mix: dict, seed: int, client: int, tag: str):
        self.mix = mix
        self.client = client
        self.tag = tag
        levels = count_levels(mix["count"])
        rng = np.random.default_rng([seed, 2])
        self.order = [levels[i] for i in rng.permutation(len(levels))]

    def job(self, k: int) -> dict:
        rec = dict(self.mix["job"])
        rec["id"] = f"{self.tag}-c{self.client}-{k}"
        rec["count"] = self.order[(self.client + k) % len(self.order)]
        return rec


def filler_job(mix: dict, tag: str, count: int) -> dict:
    rec = dict(mix["filler"])
    rec["id"] = f"{tag}-filler"
    rec["count"] = int(count)
    return rec


def fill_count(capacity: np.ndarray, ask: tuple) -> int:
    """Instances of `ask` (cpu, memory, disk) that an empty fleet of
    `capacity` [N, 3] holds, node by node."""
    per = np.floor(np.min(capacity / np.asarray(ask, np.float64), axis=1))
    return int(per.clip(min=0).sum())
