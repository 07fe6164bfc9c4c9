"""Helpers shared by the port's tests and chip_smoke.py.

Run as a program, it is the node simulator (`NodeSimulator`):

    python -m nomad_tpu_torch.testing simulate -servers H:P,H:P,H:P \
        -nodes 10000 -seed 42 -key <cluster key>
"""
from __future__ import annotations

import argparse
import contextlib
import heapq
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np


@contextlib.contextmanager
def seeded_urandom(seed):
    """os.urandom from a seeded stream for the block's length: two runs of
    one eval, each in such a block with the same seed, mint the same
    allocation ids."""
    rng = np.random.default_rng(seed)
    real = os.urandom
    os.urandom = lambda n: rng.bytes(n)
    try:
        yield
    finally:
        os.urandom = real


def park_follower_workers(server) -> None:
    """Let a reference Server's idle workers wait while its broker is off.

    The reference's worker loop (nomad_tpu/server/worker.py `run`)
    dequeues from its own server's broker, which a follower keeps
    disabled: `dequeue` then returns at once and the loop spins. The
    port's worker waits on the broker's condition instead
    (server/worker.py); a test that runs reference servers in the same
    process as the port's parks theirs with this, or their spinning
    holds the interpreter lock between the port's torch calls. This
    wraps the server's `eval_broker.dequeue` so that, while the broker is
    disabled, a call first waits on the broker's condition for its
    timeout; enabling the broker (the server becoming leader) wakes it
    at once. Nothing else changes."""
    broker = server.eval_broker
    inner = broker.dequeue

    def dequeue(schedulers, timeout=None):
        with broker._lock:
            if not broker._enabled:
                broker._cond.wait(0.5 if timeout is None else timeout)
        return inner(schedulers, timeout=timeout)

    broker.dequeue = dequeue


def fill_count(view, cpu, mem) -> int:
    """Instances of (cpu MHz, mem MB) that fit on a usage view's free
    capacity, node by node."""
    free = view.cap[:, :2] - view.used[:, :2]
    return int(np.floor(np.min(free / np.array([cpu, mem], np.float32),
                               axis=1)).clip(min=0).sum())


# ------------------------------------------------ chunked-scan fixtures
#
# Seeded numpy inputs of place_chunked, shared by the CPU tests (against
# the JAX package's place_chunked), the card tests and chip_smoke.py
# (the scan kernel against the plain scan). chunked_case(name) -> (args in
# place_chunked's positional order, kwargs).

BENCH_CPU = (4_000, 8_000, 16_000, 32_000)
BENCH_MEM = (8_192, 16_384, 32_768, 65_536)


def _fleet(rng, n, integer=True, fill=0.5):
    cap = np.zeros((n, 5), np.float32)
    cap[:, 0] = rng.choice(BENCH_CPU, n)
    cap[:, 1] = rng.choice(BENCH_MEM, n)
    cap[:, 2] = 500_000
    cap[:, 3] = 100
    cap[:, 4] = 1_000
    used = np.zeros_like(cap)
    frac = rng.random((n, 2)).astype(np.float32) * fill
    used[:, :2] = cap[:, :2] * frac
    if integer:
        used = np.floor(used)
    return cap, used


def _no_spread(n):
    return (np.full((1, n), -1, np.int32), np.full((1, 2), -1, np.int32),
            np.full((1, 2), -1.0, np.float32), np.full(1, -1, np.int32),
            np.zeros(1, np.float32))


def _no_distinct(n):
    return np.full((1, n), -1, np.int32), np.full((1, 2), -1, np.int32)


def _targeted(rng, n, values, percents, count, weight, sum_weights):
    """One targeted stanza over `values` (id per node by rng), lowered as
    tensorize._lower_spreads lowers it."""
    ids = rng.integers(0, len(values), n).astype(np.int32)
    p = max(2, 1 << (len(values) - 1).bit_length())
    counts = np.full(p, -1, np.int32)
    counts[:len(values)] = 0
    desired = np.full(p, -1.0, np.float32)
    desired[:len(values)] = [pc / 100.0 * count for pc in percents]
    return ids, counts, desired, 1, weight / sum_weights


def _racks(n, live, count, racks=100, cap_per_rack=None):
    """Datacenters targeted 50/30/20 (weight 0.7) and racks even (0.3) by
    node index, as the service path lays them out; with `cap_per_rack`,
    a distinct_property quota per rack instead of the spreads."""
    on = np.arange(n) < live
    dc = np.where(on, np.arange(n) % 3, -1).astype(np.int32)
    rack = np.where(on, np.arange(n) % racks, -1).astype(np.int32)
    p = max(2, 1 << (racks - 1).bit_length())
    if cap_per_rack is not None:
        rem = np.zeros((1, p), np.int32)
        rem[0, :racks] = cap_per_rack
        return _no_spread(n), (rack[None], rem)
    counts = np.full((2, p), -1, np.int32)
    counts[0, :3] = 0
    counts[1, :racks] = 0
    desired = np.full((2, p), -1.0, np.float32)
    desired[0, :3] = [0.5 * count, 0.3 * count, 0.2 * count]
    sp = (np.stack([dc, rack]), counts, desired, np.array([1, 0], np.int32),
          np.array([0.7, 0.3], np.float32))
    return sp, _no_distinct(n)


def chunked_case(name):
    """-> (args tuple in the reference's positional order, kwargs)."""
    rng = np.random.default_rng(SCAN_CASES.index(name) + 11)
    n = 128
    ask = np.array([250, 512, 300, 0, 0], np.float32)
    feas = rng.random(n) > 0.1
    coll = np.zeros(n, np.int32)
    aff = np.zeros(n, np.float32)
    sp = _no_spread(n)
    dp = _no_distinct(n)
    kw = dict(max_steps=64)
    desired_count = 10
    if name == "even_spread":
        cap, used = _fleet(rng, n)
        count = 300                                  # 5 per step
        ids = rng.integers(0, 3, n).astype(np.int32)
        sp = (ids[None], np.array([[4, 0, 2, -1]], np.int32),
              np.full((1, 4), -1.0, np.float32), np.array([0], np.int32),
              np.ones(1, np.float32))
    elif name == "targeted_fractional":
        cap, used = _fleet(rng, n)
        count = 200
        ids, counts, desired, mode, w = _targeted(
            rng, n, ("dc1", "dc2", "dc3"), (50, 30, 20), count, 70, 100)
        sp = (ids[None], counts[None], desired[None],
              np.array([mode], np.int32), np.array([w], np.float32))
    elif name == "two_stanzas_missing":
        cap, used = _fleet(rng, n, integer=False)
        ask = np.array([251.5, 517.25, 300, 0, 0], np.float32)
        count = 150
        ids0, counts0, desired0, _, w0 = _targeted(
            rng, n, ("a", "b", "c"), (50, 30, 20), count, 70, 100)
        ids0[rng.random(n) < 0.15] = -1              # value missing
        ids1 = rng.integers(0, 7, n).astype(np.int32)
        ids1[rng.random(n) < 0.1] = -1
        counts1 = np.full(8, -1, np.int32)
        counts1[:7] = rng.integers(0, 3, 7)
        pad = np.full(8, -1, np.int32)
        pad[:4] = counts0
        dpad = np.full(8, -1.0, np.float32)
        dpad[:4] = desired0
        sp = (np.stack([ids0, ids1]), np.stack([pad, counts1]),
              np.stack([dpad, np.full(8, -1.0, np.float32)]),
              np.array([1, 0], np.int32), np.array([w0, 0.3], np.float32))
    elif name == "distinct_mpn1":
        cap, used = _fleet(rng, n)
        count = 90
        ids = rng.integers(0, 12, n).astype(np.int32)
        ids[rng.random(n) < 0.1] = -1
        rem = np.full((2, 16), -1, np.int32)
        rem[0, :] = 0
        rem[0, :12] = rng.integers(0, 6, 12)
        dp = (np.stack([ids, np.full(n, -1, np.int32)]), rem)
        kw.update(max_per_node=1, max_steps=32)      # 3 per step
    elif name == "affinity_collisions_spread_alg":
        cap, used = _fleet(rng, n, integer=False)
        count = 120
        coll = (rng.integers(0, 4, n) * (rng.random(n) < 0.4)).astype(
            np.int32)
        aff = np.where(rng.random(n) < 0.3, rng.uniform(-1, 1, n),
                       0.0).astype(np.float32)
        desired_count = 7
        kw.update(spread_algorithm=True)
    elif name == "bench_ties":
        # the bench fleet empty: 16 node shapes, exact score ties everywhere
        cap, _ = _fleet(rng, n)
        used = np.zeros_like(cap)
        count = 700
        ids = (np.arange(n) % 3).astype(np.int32)
        rack = (np.arange(n) % 10).astype(np.int32)
        sp = (np.stack([ids, rack]),
              np.stack([np.array([0, 0, 0, -1] + [-1] * 12, np.int32),
                        np.array([0] * 10 + [-1] * 6, np.int32)]),
              np.stack([np.array([350, 210, 140, -1] + [-1] * 12,
                                 np.float32), np.full(16, -1.0, np.float32)]),
              np.array([1, 0], np.int32),
              np.array([0.7, 0.3], np.float32))
    elif name == "fma_tie":
        # two nodes only the fused multiply-add of base and anti orders:
        # rounded separately, node 0 would score higher
        n = 8
        cap = np.zeros((n, 5), np.float32)
        cap[:2] = [8_000, 16_384, 500_000, 100, 1_000]
        used = np.zeros_like(cap)
        used[0, :2] = [3897.56005859375, 3293.0244140625]
        used[1, :2] = [1715.9468994140625, 3386.6640625]
        feas = np.arange(n) < 2
        coll = np.array([2, 1] + [0] * 6, np.int32)
        aff = np.zeros(n, np.float32)
        sp, dp = _no_spread(n), _no_distinct(n)
        count, desired_count = 1, 7
        kw = dict(max_steps=1)
    elif name == "ties_run_out":
        # the bench fleet empty (16 shapes: exact ties) under an ask it
        # cannot hold: 79 a step until the capacity runs out mid-scan
        cap, _ = _fleet(rng, n)
        used = np.zeros_like(cap)
        ask = np.array([2_000, 4_096, 300, 0, 0], np.float32)
        count = 5_000
        rack = (np.arange(n) % 10).astype(np.int32)
        sp = (rack[None], np.array([[0] * 10 + [-1] * 6], np.int32),
              np.full((1, 16), -1.0, np.float32), np.array([0], np.int32),
              np.ones(1, np.float32))
    elif name == "rack_capped":
        # chunk 1, 150 steps: the service path's rack-capped job
        n, live = 1_024, 700
        cap, used = _fleet(rng, n)
        feas = np.arange(n) < live
        count = 150
        sp, dp = _racks(n, live, count, cap_per_rack=2)
        aff, coll = np.zeros(n, np.float32), np.zeros(n, np.int32)
        kw = dict(max_steps=256)
    elif name == "nothing_feasible":
        cap, used = _fleet(rng, n)
        feas = np.zeros(n, bool)
        count = 300
    elif name == "done_mid_scan":
        # remaining reaches 0 after 60 of 64 steps (5 a step)
        n, live = 1_024, 900
        cap, used = _fleet(rng, n)
        feas = np.arange(n) < live
        count = 300
        sp, dp = _racks(n, live, count)
        aff, coll = np.zeros(n, np.float32), np.zeros(n, np.int32)
    elif name == "mpn1":
        cap, used = _fleet(rng, n)
        count = 400                                  # 25 a step
        coll = (rng.random(n) < 0.3).astype(np.int32)
        kw = dict(max_steps=16, max_per_node=1)
    elif name.startswith("bucket") or name == "split":
        # "split": 5,120 instances over 1,024 nodes at max_steps 4, more
        # than one solve covers (split_solves carries them over)
        n = 1_024 if name == "split" else int(name[len("bucket"):])
        live = max(n * 5 // 8, 1)
        cap, used = _fleet(rng, n)
        feas = (np.arange(n) < live) & (rng.random(n) > 0.05)
        count = min(8 * live, 20_000)
        sp, _ = _racks(n, live, count, racks=min(100, n))
        racks = min(100, n)
        p = max(2, 1 << (racks - 1).bit_length())
        rem = np.zeros((1, p), np.int32)
        rem[0, :racks] = rng.integers(count // racks, 2 * count // racks + 2,
                                      racks)
        dp = (sp[0][1:2].copy(), rem)
        coll = (rng.random(n) < 0.2).astype(np.int32)
        aff = np.where(rng.random(n) < 0.2, rng.uniform(-1, 1, n),
                       0.0).astype(np.float32)
        kw = dict(max_steps=4 if name == "split" else 256)
    else:
        raise AssertionError(name)
    args = (cap, used, ask, np.int32(count), feas, coll,
            np.int32(desired_count)) + tuple(sp) + (aff,) + tuple(dp)
    return args, kw


# held against the JAX package's place_chunked on the CPU (each places)
CHUNKED_CASES = ("even_spread", "targeted_fractional", "two_stanzas_missing",
                 "distinct_mpn1", "affinity_collisions_spread_alg",
                 "bench_ties", "fma_tie", "ties_run_out")
# the scan kernel's edges: chunk 1, nothing feasible, done mid-scan,
# max_per_node 1, an ask split across solves, the node buckets 8, 1,024
# and 65,536 (run every case through split_solves)
EDGE_CASES = ("rack_capped", "nothing_feasible", "done_mid_scan", "mpn1",
              "split", "bucket8", "bucket1024", "bucket65536")
SCAN_CASES = CHUNKED_CASES + EDGE_CASES


def split_solves(place, args, kw):
    """An ask above max_steps * min(N, 256) split across solves as
    placer._scan_dispatch splits it: each solve fed the last one's
    placements (`placed_init`), usage, spread counts and quotas. `place`
    is a place_chunked; args in its positional order. -> the last
    solve's four returns."""
    args = list(args)
    count = int(args[3])
    cover = int(kw.get("max_steps", 256)) * min(args[0].shape[0], 256)
    left, last, placed = count, 0, kw.get("placed_init")
    kw = {k: v for k, v in kw.items() if k != "placed_init"}
    while True:
        out = place(*args[:3], min(left, cover), *args[4:], **kw,
                    placed_init=placed)
        placed, args[1], args[8], args[14] = out
        if left <= cover:
            return out
        total = int(placed.sum())
        left = count - total
        if left <= 0 or total == last:
            return out
        last = total


# ------------------------------------------------------ explain fixtures
#
# Seeded numpy inputs of kernels.explain_reduce in its positional order
# (cap, used, ask, feasible, collisions, placed, class_ids,
# distinct_hosts), shared by the CPU tests, the card tests and
# chip_smoke.py.

def explain_case(seed=0, n=16, n_classes=4):
    """tests/test_explain.py's reduce inputs: random float usage on a
    two-size fleet, a fifth infeasible, collisions, up to 2 placed per
    row, class ids in [-1, n_classes)."""
    rng = np.random.default_rng(seed)
    cap = np.zeros((n, 5), np.float32)
    cap[:, 0] = rng.choice([2000.0, 4000.0], n)
    cap[:, 1] = rng.choice([4096.0, 8192.0], n)
    cap[:, 2] = 50_000.0
    used = (cap * rng.uniform(0.0, 0.9, (n, 5))).astype(np.float32)
    ask = np.zeros(5, np.float32)
    ask[0], ask[1] = 1500.0, 2048.0
    feas = rng.random(n) > 0.2
    coll = rng.integers(0, 2, n).astype(np.int32)
    placed = rng.integers(0, 3, n).astype(np.int32)
    cls = rng.integers(-1, n_classes, n).astype(np.int32)
    return (cap, used, ask, feas, coll, placed, cls, np.bool_(True))


# a float32 rounding boundary of used + placed * ask (found by a seeded
# search): rounded twice (the product, then the sum) the row lands
# exactly one ask below cap; rounded once it overflows cap
BOUNDARY = (np.float32(948.94366), np.float32(4.6004515), np.int32(49))


def explain_boundary_case(n=8):
    """Every row on BOUNDARY: the two-rounding reduce calls each row fit,
    a once-rounded (fused multiply-add) one calls it exhausted on cpu."""
    u, a, p = BOUNDARY
    cap = np.full((n, 5), 1e6, np.float32)
    used = np.zeros((n, 5), np.float32)
    ask = np.zeros(5, np.float32)
    ask[0] = a
    cap[:, 0] = np.float32(np.float32(np.float32(p) * a) + u) + a
    used[:, 0] = u
    placed = np.full(n, p, np.int32)
    cls = np.arange(n, dtype=np.int32) % 2
    return (cap, used, ask, np.ones(n, bool), np.zeros(n, np.int32),
            placed, cls, np.bool_(False))


# ------------------------------------------------------- convex fixtures

def convex_case(n=10_000, bucket=16_384, seed=1910, count=3_000):
    """bench.py `_convex_run`'s fragmented cluster (seed 1910): uniform
    caps, beta-skewed usage (most nodes part-full, a tail nearly
    exhausted), 5% infeasible, same-job collisions 0..3; n live rows in
    a `bucket`-row solve (padding rows zero and infeasible), as the
    placer pads. -> (cap, used, feasible, coll, ask, count)."""
    rng = np.random.default_rng(seed)
    cap = np.zeros((bucket, 5), np.float32)
    cap[:n] = (4_000.0, 8_192.0, 500_000.0, 12_001.0, 10_000.0)
    used = np.zeros_like(cap)
    used[:n, 0] = (rng.beta(2, 3, n) * 3_900).astype(np.float32)
    used[:n, 1] = (rng.beta(2, 3, n) * 8_000).astype(np.float32)
    used[:n, 2] = (rng.beta(2, 5, n) * 400_000).astype(np.float32)
    feasible = np.zeros(bucket, bool)
    feasible[:n] = rng.random(n) > 0.05
    coll = np.zeros(bucket, np.int32)
    coll[:n] = rng.integers(0, 4, n)
    ask = np.zeros(5, np.float32)
    ask[:3] = (250.0, 512.0, 300.0)
    return cap, used, feasible, coll, ask, count


def convex_fuzz_cluster(rng, b=128):
    """tests/test_convex.py's fragmented cluster of `b` rows: uniform
    caps, beta-skewed usage, 10% infeasible, random same-job collisions.
    -> (cap, used, feasible, coll, ask)."""
    cap = np.zeros((b, 5), np.float32)
    cap[:] = (4_000.0, 8_192.0, 500_000.0, 12_001.0, 10_000.0)
    used = np.zeros_like(cap)
    used[:, 0] = (rng.beta(2, 3, b) * 3_900).astype(np.float32)
    used[:, 1] = (rng.beta(2, 3, b) * 8_000).astype(np.float32)
    used[:, 2] = (rng.beta(2, 5, b) * 400_000).astype(np.float32)
    feasible = rng.random(b) > 0.1
    coll = rng.integers(0, 4, b).astype(np.int32)
    ask = np.zeros(5, np.float32)
    ask[:3] = (250.0, 512.0, 300.0)
    return cap, used, feasible, coll, ask


# the convex solve's fixtures for the card tests and chip_smoke.py: the
# kernel against the plain version. The bench_* cases are the main
# path's shape (10,000 nodes, 16,384 rows); small_spread_deep runs all
# 200 iterations (the objective keeps moving by float32 noise);
# bucket_65536 is the largest bucket whose rows the kernel keeps in
# shared memory, bucket_131072 one that takes its global scratch;
# fuzz_full has no capacity anywhere (sum u = 0: budget 0)
CONVEX_CASES = ("bench_binpack", "bench_spread", "bench_binpack_deep",
                "bench_spread_deep", "fuzz_quota", "fuzz_distinct",
                "fuzz_affinity", "fuzz_zero", "fuzz_above_cap",
                "homogeneous", "small_spread_deep", "bucket_65536",
                "bucket_131072", "fuzz_full")


def convex_fixture(name):
    """-> (cap, used, feasible, coll, ask, count, kw): convex_eval's
    inputs for CONVEX_CASES[name]; kw holds spread_algorithm, tolerance,
    max_iters, fairness_weight, quota_budget, max_per_node and
    affinity_boost (None: zeros)."""
    kw = dict(spread_algorithm=name.endswith(("spread", "spread_deep")),
              tolerance=1e-9 if name.endswith("deep") else 1e-4,
              max_iters=200, fairness_weight=0.05,
              quota_budget=float(2 ** 30), max_per_node=2 ** 30,
              affinity_boost=None)
    if name.startswith("bench"):
        return (*convex_case(), kw)
    if name == "small_spread_deep":
        return (*convex_case(100, 128, count=300), kw)
    if name == "bucket_65536":
        return (*convex_case(50_000, 65_536, count=15_000), kw)
    if name == "bucket_131072":
        return (*convex_case(100_000, 131_072, count=30_000), kw)
    if name == "homogeneous":
        cap = np.zeros((64, 5), np.float32)
        cap[:] = (4_000.0, 8_192.0, 500_000.0, 12_001.0, 10_000.0)
        used = np.zeros_like(cap)
        used[:, 0], used[:, 1] = 1_000.0, 2_048.0
        ask = np.zeros(5, np.float32)
        ask[:3] = (250.0, 512.0, 300.0)
        return (cap, used, np.ones(64, bool), np.zeros(64, np.int32), ask,
                37, kw)
    rng = np.random.default_rng(41)
    case = convex_fuzz_cluster(rng)
    count = {"fuzz_zero": 0, "fuzz_above_cap": 100_000}.get(name, 60)
    if name == "fuzz_quota":
        kw["quota_budget"] = 5.0
    if name == "fuzz_distinct":
        kw["max_per_node"] = 1
    if name == "fuzz_full":
        case[1][:, 0] = case[0][:, 0]
    if name == "fuzz_affinity":
        kw["affinity_boost"] = np.where(
            rng.random(128) < 0.3, rng.uniform(-0.5, 0.5, 128),
            0.0).astype(np.float32)
    return (*case, count, kw)


# ------------------------------------------------ agents as processes
#
# The port's agents as a deployment runs them, each its own OS process
# (`python -m nomad_tpu_torch.cli agent -config <file>`) driven over HTTP,
# and the node simulator, which stands in for a fleet of client agents
# over the servers' socket RPC. chip_smoke.py's agent phase and
# tests/test_torch_agent_cluster.py use them.

REPO_ROOT = Path(__file__).resolve().parents[1]


def free_ports(n: int) -> list:
    """`n` distinct free TCP ports on 127.0.0.1."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def wait_until(fn, timeout: float, interval: float = 0.05):
    """Poll `fn` until it returns something true (returned) or `timeout`
    seconds pass (-> None). An exception counts as not yet."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            got = fn()
            if got:
                return got
        except (OSError, ValueError, KeyError):
            pass
        if time.monotonic() >= deadline:
            return None
        time.sleep(interval)


def cpu_seconds(pid: int) -> float:
    """User + system CPU seconds of process `pid`, all its threads
    (/proc/<pid>/stat)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def reap_tasks(base: str) -> list:
    """SIGKILL every process whose working directory lies under `base`
    (an agent's data dir): raw_exec tasks are session leaders and outlive
    their agent. -> the pids killed."""
    base = os.path.realpath(base)
    killed = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            cwd = os.path.realpath(f"/proc/{pid}/cwd")
        except OSError:
            continue
        if cwd == base or cwd.startswith(base + os.sep):
            try:
                os.kill(int(pid), signal.SIGKILL)
                killed.append(int(pid))
            except OSError:
                pass
    return killed


def task_pids(base: str, needle: str) -> list:
    """Live processes whose cwd lies under `base` and whose command line
    holds `needle`."""
    base = os.path.realpath(base)
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            cwd = os.path.realpath(f"/proc/{pid}/cwd")
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if cwd.startswith(base + os.sep) and needle in cmd:
            out.append(int(pid))
    return sorted(out)


def child_env(**extra) -> dict:
    """The environment of a spawned port process: this one's, with the
    repository on PYTHONPATH and `extra` (NOMAD_SOLVER_DEVICE, ...)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT)
    env.update({k: str(v) for k, v in extra.items()})
    return env


class AgentProcess:
    """One port agent in its own OS process, `python -m
    nomad_tpu_torch.cli agent -config <dir>/agent.json`, with its log in
    <dir>/agent.log; driven over its HTTP API."""

    def __init__(self, name: str, config: dict, base_dir: str,
                 env: dict = None, args: tuple = ()):
        self.name = name
        self.dir = os.path.join(base_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.config = dict(config, data_dir=self.dir)
        self.http_port = self.config["ports"]["http"]
        self.env = env if env is not None else child_env()
        self.args = tuple(args)
        self.proc = None

    def start(self) -> "AgentProcess":
        cfg = os.path.join(self.dir, "agent.json")
        with open(cfg, "w") as f:
            json.dump(self.config, f)
        with open(os.path.join(self.dir, "agent.log"), "ab") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "nomad_tpu_torch.cli", "agent",
                 "-config", cfg, *self.args],
                cwd=self.dir, env=self.env, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True)
        return self

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill9(self) -> None:
        if self.alive():
            os.kill(self.proc.pid, signal.SIGKILL)
        if self.proc is not None:
            self.proc.wait(timeout=30)

    def stop(self, timeout: float = 30.0) -> None:
        """SIGTERM (the agent shuts down), SIGKILL after `timeout`."""
        if self.alive():
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.kill9()

    def url(self, path: str) -> str:
        return f"http://127.0.0.1:{self.http_port}{path}"

    def raw(self, path: str, timeout: float = 60.0) -> bytes:
        with urllib.request.urlopen(self.url(path), timeout=timeout) as r:
            return r.read()

    def get(self, path: str, timeout: float = 60.0):
        return json.loads(self.raw(path, timeout) or b"null")

    def put(self, path: str, body, timeout: float = 120.0):
        req = urllib.request.Request(
            self.url(path), data=json.dumps(body).encode(), method="PUT",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
        return json.loads(raw) if raw else None

    def wait_http(self, timeout: float) -> bool:
        return bool(wait_until(
            lambda: self.alive() and self.get("/v1/agent/health", 2.0)
            is not None, timeout, 0.1))

    def is_leader(self) -> bool:
        try:
            return bool(self.get("/v1/status/leader", 5.0))
        except (OSError, ValueError):
            return False

    def tail(self, nbytes: int = 3000) -> str:
        try:
            with open(os.path.join(self.dir, "agent.log"), "rb") as f:
                f.seek(0, 2)
                f.seek(max(0, f.tell() - nbytes))
                return f.read().decode(errors="replace")
        except OSError:
            return ""


def server_agent(name: str, base_dir: str, ports: dict, n_servers: int,
                 join: list, key: str, env: dict = None) -> AgentProcess:
    """A server agent as Nomad's production shape runs it: TCP RPC,
    gossip `join` to its peers, `bootstrap_expect` = `n_servers`, Raft on
    the agent's defaults (WAL under its data dir, raft_fsync always)."""
    return AgentProcess(name, {
        "name": name,
        "ports": {"http": ports["http"], "rpc": ports["rpc"],
                  "serf": ports["serf"]},
        "server": {"enabled": True, "bootstrap_expect": n_servers,
                   "encrypt": key, "retry_join": list(join)},
        "client": {"enabled": False},
    }, base_dir, env)


def client_agent(name: str, base_dir: str, http_port: int, servers: list,
                 key: str, datacenter: str, env: dict = None
                 ) -> AgentProcess:
    """A client-only agent that runs real tasks, in `datacenter`,
    registered through the servers' RPC."""
    return AgentProcess(name, {
        "name": name, "datacenter": datacenter,
        "ports": {"http": http_port},
        "server": {"enabled": False, "encrypt": key},
        "client": {"enabled": True, "servers": list(servers)},
    }, base_dir, env)


def bench_node(mock, i, rng, pin="", racks=0):
    """bench.py's heterogeneous fleet node (10,000 of them make the main
    path's cluster). With `racks`, the service layout: datacenter
    dc1..dc3 by i % 3 and meta.rack r0.. by i % racks."""
    n = mock.node()
    if pin:
        n.id = f"{pin}{i:06d}"
    n.name = f"bench-{i}"
    n.node_class = f"c{int(rng.integers(0, 4))}"
    n.datacenter = "dc1" if i % 2 == 0 else "dc2"
    if racks:
        n.datacenter = f"dc{i % 3 + 1}"
        n.meta["rack"] = f"r{i % racks}"
    n.node_resources.cpu.cpu_shares = int(
        rng.choice([4_000, 8_000, 16_000, 32_000]))
    n.node_resources.memory.memory_mb = int(
        rng.choice([8_192, 16_384, 32_768, 65_536]))
    n.node_resources.disk.disk_mb = 500_000
    return n


# the TTL a node assumes when a write's answer names none (the client's
# default, client/client.py)
DEFAULT_TTL_S = 10.0
# the simulator's threads, each with its own connection pool, and how
# often it asks the servers who leads
SIM_THREADS = 16
LEADER_POLL_S = 0.25


def _ttl(resp, prior: float) -> float:
    """The heartbeat TTL a Node.Register / Node.UpdateStatus answer gives;
    `prior` when it gives none (a retried write answered from another
    server's dedup record, `{"index": i, "deduped": True}`), as the
    client agent reads it."""
    return float(resp.get("heartbeat_ttl", prior))


class NodeSimulator:
    """Stands in for `n_nodes` client agents (bench_node rows from
    `seed`): registers each over the servers' socket RPC
    (`ServerRpc.node_register`) and heartbeats it as the client agent
    does (`Node.UpdateStatus` ready, every half TTL: client/client.py
    `_heartbeat_loop`), from SIM_THREADS threads with a connection pool
    each. A thread registers its share of the fleet and heartbeats the
    nodes it has registered as they fall due, so no node waits on the
    rest of the registration. A watcher asks the servers for the Raft
    leader every LEADER_POLL_S and points every thread's server list
    at it first (a follower would forward each call to the leader).

    A heartbeat `missed` when it returned after its node's TTL, counted
    from the start of the last call that succeeded."""

    def __init__(self, servers: list, n_nodes: int, seed: int,
                 key: bytes = None):
        from . import mock
        from .rpc import ServerRpc
        from .rpc.server import DEFAULT_KEY
        self.servers = list(servers)
        self.key = key or DEFAULT_KEY
        rng = np.random.default_rng(seed)
        self.nodes = [bench_node(mock, i, rng) for i in range(n_nodes)]
        self.threads = max(1, min(SIM_THREADS, n_nodes))
        self.rpcs = [ServerRpc(self.servers, key=self.key, timeout=30.0,
                               retry_seed=seed * 1000 + t)
                     for t in range(self.threads)]
        self._lock = threading.Lock()
        self.registered = 0
        self.heartbeats = 0
        self.missed = 0
        self.errors: dict = {}
        self.max_age = 0.0          # the longest gap between good calls / TTL
        self.leaders: list = []     # (seconds since start, leader addr)
        self.t0 = time.monotonic()
        self.register_s = None

    def _error(self, e: Exception) -> None:
        with self._lock:
            k = type(e).__name__
            self.errors[k] = self.errors.get(k, 0) + 1

    def _shard(self, t: int, stop: threading.Event) -> None:
        rpc = self.rpcs[t]
        todo = list(range(t, len(self.nodes), self.threads))
        todo.reverse()
        due: list = []              # (due, node index)
        ok_at, ttl = {}, {}
        while not stop.is_set():
            now = time.monotonic()
            if due and due[0][0] <= now:
                _, i = heapq.heappop(due)
                start = time.monotonic()
                try:
                    resp = rpc.node_update_status(self.nodes[i].id, "ready")
                except Exception as e:      # noqa: BLE001 — counted, retried
                    self._error(e)
                    heapq.heappush(due, (time.monotonic() + 0.1, i))
                    continue
                end = time.monotonic()
                age = (end - ok_at[i]) / ttl[i]
                with self._lock:
                    self.heartbeats += 1
                    self.missed += age > 1.0
                    self.max_age = max(self.max_age, age)
                ok_at[i], ttl[i] = start, _ttl(resp, ttl[i])
                heapq.heappush(due, (start + ttl[i] / 2, i))
            elif todo:
                i = todo[-1]
                start = time.monotonic()
                try:
                    resp = rpc.node_register(self.nodes[i])
                except Exception as e:      # noqa: BLE001 — counted, retried
                    self._error(e)
                    stop.wait(0.1)
                    continue
                todo.pop()
                ok_at[i], ttl[i] = start, _ttl(resp, DEFAULT_TTL_S)
                heapq.heappush(due, (start + ttl[i] / 2, i))
                with self._lock:
                    self.registered += 1
            else:
                stop.wait(min(0.05, max(0.0, due[0][0] - now))
                          if due else 0.05)

    def _watch_leader(self, stop: threading.Event) -> None:
        from .rpc import RpcClient
        rpc = RpcClient(self.servers, key=self.key, timeout=5.0)
        try:
            while not stop.wait(LEADER_POLL_S):
                try:
                    cfg = rpc.call("Operator.RaftGetConfiguration")
                except Exception as e:      # noqa: BLE001 — counted
                    self._error(e)
                    continue
                lead = [s["Address"] for s in cfg["Servers"] if s["Leader"]]
                if not lead or (self.leaders and
                                self.leaders[-1][1] == lead[0]):
                    continue
                with self._lock:
                    self.leaders.append((time.monotonic() - self.t0,
                                         lead[0]))
                order = lead[:1] + [a for a in self.servers
                                    if a != lead[0]]
                for r in self.rpcs:
                    r.rpc.set_servers(order)
        finally:
            rpc.close()

    def stats(self) -> dict:
        with self._lock:
            now = time.monotonic()
            return {"t": now - self.t0, "mono": now,
                    "nodes": len(self.nodes), "registered": self.registered,
                    "register_s": self.register_s,
                    "heartbeats": self.heartbeats, "missed": self.missed,
                    "max_age_ttl": self.max_age, "errors": dict(self.errors),
                    "leaders": list(self.leaders)}

    def run(self, stop: threading.Event, report, every: float = 1.0) -> None:
        """Register and heartbeat until `stop`; `report(event, stats)`
        once the fleet is registered and every `every` seconds."""
        threads = [threading.Thread(target=self._shard, args=(t, stop),
                                    daemon=True, name=f"sim-{t}")
                   for t in range(self.threads)]
        threads.append(threading.Thread(target=self._watch_leader,
                                        args=(stop,), daemon=True,
                                        name="sim-leader"))
        for th in threads:
            th.start()
        try:
            while not stop.wait(every):
                st = self.stats()
                if self.register_s is None and \
                        st["registered"] == len(self.nodes):
                    self.register_s = st["t"]
                    report("registered", self.stats())
                report("stats", st)
        finally:
            stop.set()
            for th in threads:
                th.join(30.0)
            for r in self.rpcs:
                r.close()
        report("stopped", self.stats())


def simulate_main(argv) -> int:
    p = argparse.ArgumentParser(prog="nomad_tpu_torch.testing simulate")
    p.add_argument("-servers", required=True,
                   help="comma-separated host:port RPC addresses")
    p.add_argument("-nodes", type=int, required=True)
    p.add_argument("-seed", type=int, default=42)
    p.add_argument("-key", default="", help="the cluster's encrypt key")
    args = p.parse_args(argv)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    sim = NodeSimulator(args.servers.split(","), args.nodes, args.seed,
                        key=args.key.encode() or None)

    def report(event, st):
        print(json.dumps(dict(st, event=event)), flush=True)
    sim.run(stop, report)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] != ["simulate"]:
        sys.exit("usage: python -m nomad_tpu_torch.testing simulate ...")
    sys.exit(simulate_main(sys.argv[2:]))
