#!/usr/bin/env python3
"""Chip smoke test of nomad_tpu_torch: the quickest proof that the port
starts on the card and that its main path goes through its kernels.

    python3 chip_smoke.py          # from the repo root, one CUDA card

Phases (any failed check raises; the script then exits non-zero and
prints no result):

  1. device   torch/CUDA versions, whether nvcc and triton exist, the card
              (`nvidia-smi --query-gpu=name,power.limit`).
  2. build    both CUDA kernels from nomad_tpu_torch/solver/csrc, one nvcc
              per source, started together; ptxas register counts.
  3. kernels  each kernel against its plain PyTorch version on the card, on
              seeded inputs at the main path's shapes: 10,000 live nodes in
              the 16,384 bucket, the depth curve dense at K=128, on the
              sampled grid (DEPTH_GRID <= 128), with max_per_node=1 and with
              a block of infeasible rows; the score/capacity pass at 16,384.
              Capacities exactly equal, densities and scores to atol 1e-4,
              k_star exactly equal except on rows whose top two plain
              densities lie within 1e-5 (counted); the fill tails' placements
              equal except on nodes such near ties move (counted). Median
              times over 30 launches (CUDA events), kernel and plain.
  4. main     the port's placement path at the north-star size: an FSM with
              10,000 bench-fleet nodes under scheduler_algorithm=tpu-batch,
              three evals through new_scheduler("batch") -> process ->
              Planner.apply_plan -> FSM commit: a 50,000-task batch job (the
              dense depth curve), a 2,000-task job (the grid) and a count-1
              job (the greedy pass). Every instance committed, no usage row
              over capacity, each kernel launched, the plain tier untouched.
              The launch counts are zeroed just before and read just after.
  5. small    a 200-node cluster's three evals on the card and on the CPU
              (the plain tier): identical alloc -> node maps.

Then a `kernels` JSON line and, last, the device line.
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_LIVE = 10_000
N_BUCKET = 16_384
SEED = 20261016
ATOL = 1e-4
NEAR_TIE = 1e-5
REPS = 30
BIG_COUNT, MID_COUNT = 50_000, 2_000
# per-eval layer timers (seconds, metrics.timer_sum deltas)
LAYERS = ("nomad.scheduler.reconcile", "nomad.solver.tensorize",
          "nomad.solver.device", "nomad.solver.solve",
          "nomad.solver.materialize", "nomad.plan.evaluate",
          "nomad.plan.apply")

# H100 SXM published peaks (HBM3 bandwidth, dense f32 CUDA-core rate)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per evaluated dense depth / per node, read off the kernels'
# source; a pow counts as ONE operation, so the bound is a lower bound
DEPTH_OPS_DENSE, DEPTH_OPS_NODE = 31, 30
SCORE_OPS_NODE = 35


class CheckFailed(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------ phase 1

def device_phase(torch) -> str:
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"nvcc {nvcc or 'missing'}; triton "
        f"{'present' if importlib.util.find_spec('triton') else 'missing'}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch sees {torch.cuda.device_count()} device(s): "
        f"{torch.cuda.get_device_name(0)}")
    return card


# ------------------------------------------------------------ phase 3

def _inputs(np, torch, dev):
    """Seeded node matrices at the main path's bucket: bench-fleet
    capacities, partial usage, ~5% infeasible live rows, padding rows
    zero and infeasible (as the placer pads)."""
    from nomad_tpu_torch.solver.tensorize import DYN_PORT_SPAN
    rng = np.random.default_rng(SEED)
    cap = np.zeros((N_BUCKET, 5), np.float32)
    cap[:N_LIVE, 0] = rng.choice([4_000, 8_000, 16_000, 32_000], N_LIVE)
    cap[:N_LIVE, 1] = rng.choice([8_192, 16_384, 32_768, 65_536], N_LIVE)
    cap[:N_LIVE, 2] = 500_000
    cap[:N_LIVE, 3] = DYN_PORT_SPAN
    cap[:N_LIVE, 4] = 1_000
    used = np.zeros_like(cap)
    used[:N_LIVE, 0] = np.floor(cap[:N_LIVE, 0] * rng.random(N_LIVE) * 0.6)
    used[:N_LIVE, 1] = np.floor(cap[:N_LIVE, 1] * rng.random(N_LIVE) * 0.6)
    used[:N_LIVE, 2] = rng.integers(0, 100_000, N_LIVE)
    feas = np.zeros(N_BUCKET, bool)
    feas[:N_LIVE] = rng.random(N_LIVE) > 0.05
    coll = np.zeros(N_BUCKET, np.int32)
    coll[:N_LIVE] = (rng.random(N_LIVE) < 0.1).astype(np.int32)
    aff = np.zeros(N_BUCKET, np.float32)
    jitter = rng.random(N_BUCKET, dtype=np.float32)
    ask = np.array([250, 512, 300, 0, 0], np.float32)

    def t(a):
        return torch.from_numpy(a).to(dev)
    return dict(cap=t(cap), used=t(used), ask=t(ask), feasible=t(feas),
                coll=t(coll), aff=t(aff), jitter=t(jitter))


def _median_ms(torch, fn, reps=REPS) -> float:
    """Median wall time of one call on the card's clock (CUDA events):
    the kernel plus whatever host work keeps the card waiting between
    the events (wrapper checks, allocation, launch)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(torch, fn, kernel: str, reps=REPS) -> tuple:
    """(kernel ms, all device ms) per call from a torch.profiler trace of
    `reps` calls: the named kernel's own device time, and the device time
    of every kernel the call launches. (None, None) when the profiler
    records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:           # no CUPTI: CUDA events instead
        log(f"profiler unavailable ({e}); timing with CUDA events")
        return None, None
    mine = total = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        total += us
        if kernel in e.name:
            mine += us
    if total <= 0:
        return None, None
    return mine / reps / 1e3, total / reps / 1e3


def _placements_agree(torch, got, want, producer_differs: bool, what: str):
    """-> nodes the near ties moved (0 when the placements are equal).
    Unequal placements are allowed only where the producers disagree
    within tolerance (a near tie reorders nodes)."""
    torch.cuda.synchronize()
    check(int(got.sum()) == int(want.sum()),
          f"{what}: placed {int(got.sum())} vs plain {int(want.sum())}")
    moved = int((got != want).sum())
    check(moved == 0 or producer_differs,
          f"{what}: {moved} nodes placed differently from the plain "
          f"version although the producers agree bit for bit")
    return moved


def kernels_phase(np, torch, dev) -> dict:
    from nomad_tpu_torch.solver import cuda_kernels, kernels
    inp = _inputs(np, torch, dev)
    base = (inp["cap"], inp["used"], inp["ask"])
    grid128 = tuple(g for g in kernels.DEPTH_GRID if g <= 128)
    infeasible_block = inp["feasible"].clone()
    infeasible_block[2_000:4_000] = False
    cases = [
        # name, feasible, max_per_node, grid, count, jitter_samples
        ("dense_k128", inp["feasible"], 2 ** 30, None, BIG_COUNT, 0.0),
        ("grid_k128", inp["feasible"], 2 ** 30, grid128, MID_COUNT, 0.4),
        ("max_per_node_1", inp["feasible"], 1, None, 8_000, 0.0),
        ("infeasible_block", infeasible_block, 2 ** 30, None, BIG_COUNT,
         0.0),
    ]
    k1 = {"max_abs_err": 0.0, "near_tie_rows": 0, "moved_nodes": 0,
          "cases": []}
    for name, feas, mpn, grid, count, js in cases:
        args = base + (feas, inp["coll"], BIG_COUNT, inp["aff"])
        kw = dict(max_per_node=mpn, k_max=128, depth_grid=grid)
        d_k, k_k, c_k = cuda_kernels.depth_curve(*args, **kw)
        d_p, k_p, c_p = kernels.depth_curve_ref(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(c_k, c_p), f"K1 {name}: k_cap differs")
        fin = torch.isfinite(d_p)
        check(torch.equal(torch.isfinite(d_k), fin),
              f"K1 {name}: rows with no fitting depth differ")
        err = float((d_k[fin] - d_p[fin]).abs().max()) if fin.any() else 0.0
        check(err <= ATOL, f"K1 {name}: d_star max abs err {err}")
        bad = torch.nonzero((k_k != k_p) & fin).flatten()
        ties = 0
        if len(bad):
            dens, _, _ = kernels.depth_density(*args, **kw)
            top2 = torch.topk(dens[bad], 2, dim=1).values
            gap = (top2[:, 0] - top2[:, 1]).abs()
            check(bool((gap <= NEAR_TIE).all()),
                  f"K1 {name}: k_star differs on {len(bad)} rows, not all "
                  f"near ties (largest top-two gap {float(gap.max())})")
            ties = len(bad)
        tail = (count, inp["jitter"], 1.5, js)
        p_k = kernels._depth_order_take(d_k, k_k, c_k, *tail)
        p_p = kernels.fill_depth(*base, count, feas, inp["coll"], BIG_COUNT,
                                 inp["aff"], max_per_node=mpn, k_max=128,
                                 order_jitter=inp["jitter"],
                                 jitter_scale=1.5, jitter_samples=js,
                                 depth_grid=grid)
        differs = bool(ties) or not torch.equal(d_k[fin], d_p[fin])
        moved = _placements_agree(torch, p_k, p_p, differs, f"K1 {name}")
        if mpn == 1:
            check(int(p_k.max()) <= 1, "K1 max_per_node_1: depth > 1")
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        k1["near_tie_rows"] += ties
        k1["moved_nodes"] += moved
        k1["cases"].append(name)
        log(f"K1 {name}: k_cap equal, d_star max abs err {err:.3g}, "
            f"k_star near-tie rows {ties}, placed {int(p_k.sum())}, "
            f"nodes moved by near ties {moved}")

    # K1 time and bound on the 50k eval's inputs: the same fleet empty
    # (no usage, no collisions), dense K=128
    empty = (inp["cap"], torch.zeros_like(inp["used"]), inp["ask"],
             inp["feasible"], torch.zeros_like(inp["coll"]), BIG_COUNT,
             inp["aff"])
    k1.update(_times(torch, "depth_curve_kernel",
                     lambda: cuda_kernels.launch_depth_curve(*empty,
                                                             k_max=128),
                     lambda: kernels.depth_curve_ref(*empty, k_max=128)))
    _, _, c_p = kernels.depth_curve_ref(*empty, k_max=128)
    depths = int(torch.clamp(c_p, max=128).sum())     # depths evaluated
    k1_bytes = N_BUCKET * (2 * 5 * 4 + 1 + 4 + 4 + 3 * 4) + 5 * 4
    k1_ops = depths * DEPTH_OPS_DENSE + N_BUCKET * DEPTH_OPS_NODE
    k1.update(_bound(k1_bytes, k1_ops))
    k1["depths_evaluated"] = depths
    log(f"K1 50k-eval inputs: kernel {k1['ms']} ms device "
        f"({k1['call_ms']} ms per wrapper call), plain {k1['plain_ms']} ms "
        f"({k1['plain_device_ms']} ms device), bound {k1['bound_ms']} ms "
        f"({k1['bound_by']}: {k1_bytes} B, {k1_ops} ops, {depths} depths)")
    grid = _times(torch, "depth_curve_kernel",
                  lambda: cuda_kernels.launch_depth_curve(
                      *args, k_max=128, depth_grid=grid128), None)
    k1["grid_ms"] = grid["ms"]
    log(f"K1 grid_k128 (partly used fleet): kernel {grid['ms']} ms device")

    # K2 at the bucket: capacity exact, score to atol, greedy tail
    k2 = {"near_tie_rows": 0, "moved_nodes": 0}
    c_k, s_k = cuda_kernels.score_capacity_fused(*base, inp["feasible"])
    c_p, s_p = kernels.score_capacity_ref(*base, inp["feasible"])
    torch.cuda.synchronize()
    check(torch.equal(c_k, c_p), "K2: capacity differs")
    err = float((s_k - s_p).abs().max())
    check(err <= ATOL, f"K2: score max abs err {err}")
    k2["max_abs_err"] = err
    for count in (1, 5_000):
        p_k = kernels._greedy_take(c_k, s_k, count, 2 ** 30)
        p_p = kernels.fill_greedy_binpack(*base, count, inp["feasible"])
        moved = _placements_agree(torch, p_k, p_p,
                                  not torch.equal(s_k, s_p),
                                  f"K2 count={count}")
        k2["moved_nodes"] += moved
        log(f"K2 count={count}: capacity equal, score max abs err "
            f"{err:.3g}, placed {int(p_k.sum())}, nodes moved {moved}")
    k2.update(_times(torch, "score_capacity_kernel",
                     lambda: cuda_kernels.score_capacity_fused(
                         *base, inp["feasible"]),
                     lambda: kernels.score_capacity_ref(
                         *base, inp["feasible"])))
    k2_bytes = N_BUCKET * (2 * 5 * 4 + 1 + 4 + 4) + 5 * 4
    k2.update(_bound(k2_bytes, N_BUCKET * SCORE_OPS_NODE))
    log(f"K2: kernel {k2['ms']} ms device ({k2['call_ms']} ms per wrapper "
        f"call), plain {k2['plain_ms']} ms ({k2['plain_device_ms']} ms "
        f"device), bound {k2['bound_ms']} ms ({k2['bound_by']})")
    return {"depth_curve": k1, "score_capacity": k2}


def _times(torch, kernel: str, run, plain) -> dict:
    """The kernel's device time per launch (profiler; the CUDA events'
    per-call time where the profiler sees no device activity), the
    wrapper's per-call time, and the plain version's per-call time and
    device time."""
    ms, _ = _device_ms(torch, run, kernel)
    out = {"call_ms": _median_ms(torch, run), "timing": "profiler"}
    if not ms:
        ms, out["timing"] = out["call_ms"], "events"
    out["ms"] = ms
    if plain is not None:
        out["plain_ms"] = _median_ms(torch, plain)
        out["plain_device_ms"] = _device_ms(torch, plain, "")[1]
    return out


def _bound(nbytes: int, ops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ------------------------------------------------------------ phase 4

def _mk_node(mock, i, rng, pin=""):
    """bench.py's heterogeneous fleet node."""
    n = mock.node()
    if pin:
        n.id = f"{pin}{i:06d}"
    n.name = f"bench-{i}"
    n.node_class = f"c{int(rng.integers(0, 4))}"
    n.datacenter = "dc1" if i % 2 == 0 else "dc2"
    n.node_resources.cpu.cpu_shares = int(
        rng.choice([4_000, 8_000, 16_000, 32_000]))
    n.node_resources.memory.memory_mb = int(
        rng.choice([8_192, 16_384, 32_768, 65_536]))
    n.node_resources.disk.disk_mb = 500_000
    return n


def _mk_batch_job(mock, job_id, count, cpu=250, mem=512, disk=300):
    job = mock.batch_job()
    job.id = job.name = job_id
    job.datacenters = ["dc1", "dc2"]
    tg = job.task_groups[0]
    tg.count = count
    tg.ephemeral_disk.size_mb = disk
    task = tg.tasks[0]
    task.resources.cpu = cpu
    task.resources.memory_mb = mem
    task.resources.networks = []
    tg.networks = []
    return job


class _Shim:
    """The planner interface a server worker provides, over the real
    serial applier."""

    def __init__(self, planner, state):
        self.planner = planner
        self.state = state

    def submit_plan(self, plan):
        return self.planner.apply_plan(plan)

    def update_eval(self, ev):
        self.state.upsert_evals(self.state.latest_index() + 1, [ev])

    def create_eval(self, ev):
        self.state.upsert_evals(self.state.latest_index() + 1, [ev])

    def refresh_snapshot(self, old):
        return self.state.snapshot()


def _cluster(n_nodes, seed, pin=""):
    import numpy as np
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import NomadFSM, Planner
    from nomad_tpu_torch.server.fsm import RaftLog
    from nomad_tpu_torch.structs import SchedulerConfiguration
    rng = np.random.default_rng(seed)
    fsm = NomadFSM()
    s = fsm.state
    s.set_scheduler_config(
        1, SchedulerConfiguration(scheduler_algorithm="tpu-batch"))
    for i in range(n_nodes):
        s.upsert_node(i + 2, _mk_node(mock, i, rng, pin))
    return fsm, Planner(RaftLog(fsm), s)


def _run_eval(fsm, planner, job, eval_id):
    from nomad_tpu_torch.scheduler import new_scheduler
    from nomad_tpu_torch.structs import Evaluation
    s = fsm.state
    s.upsert_job(s.latest_index() + 1, job)
    ev = Evaluation(id=eval_id, namespace="default", job_id=job.id,
                    type="batch", priority=50)
    s.upsert_evals(s.latest_index() + 1, [ev])
    sched = new_scheduler("batch", s.snapshot(), _Shim(planner, s))
    sched.process(ev)
    return s.eval_by_id(ev.id)


def main_path_phase(torch) -> dict:
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.solver import cuda_kernels
    t0 = time.perf_counter()
    fsm, planner = _cluster(N_LIVE, seed=42)
    log(f"main: seeded {N_LIVE} nodes in "
        f"{time.perf_counter() - t0:.3f} s")
    s = fsm.state
    evals = [("big", BIG_COUNT, "depth", "depth_curve"),
             ("mid", MID_COUNT, "depth", "depth_curve"),
             ("one", 1, "greedy", "score_capacity")]
    out = {"evals": {}}
    torch_tier = {k: metrics.counter(f"nomad.solver.kernel.{k}.torch")
                  for k in ("depth", "greedy")}
    cuda_kernels.reset_launches()                 # the main path's window
    for job_id, count, kernel, kname in evals:
        before = dict(cuda_kernels.LAUNCHES)
        solves = metrics.counter(f"nomad.solver.kernel.{kernel}.cuda")
        layers0 = {k: metrics.timer_sum(k) for k in LAYERS}
        t0 = time.perf_counter()
        ev = _run_eval(fsm, planner, _mk_batch_job(mock, job_id, count),
                       f"chip-smoke-{job_id}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        layers = {k.split(".", 1)[1]: metrics.timer_sum(k) - v
                  for k, v in layers0.items()}
        placed = len(s.allocs_by_job("default", job_id))
        check(placed == count, f"{job_id}: committed {placed}/{count}")
        check(ev is not None and ev.status == "complete",
              f"{job_id}: eval status {getattr(ev, 'status', None)}")
        view = s.usage.view()
        over = int((view.used > view.cap + 1e-3).any(axis=1).sum())
        check(over == 0, f"{job_id}: {over} usage rows over capacity")
        rose = cuda_kernels.LAUNCHES[kname] - before[kname]
        check(rose >= 1, f"{job_id}: {kname} kernel never launched")
        check(metrics.counter(f"nomad.solver.kernel.{kernel}.cuda") >
              solves, f"{job_id}: no cuda-tier {kernel} solve recorded")
        out["evals"][job_id] = {"count": count, "committed": placed,
                                "wall_s": wall, "kernel": kname,
                                "launches": rose, "layers_s": layers}
        log(f"main {job_id}: {placed}/{count} committed in {wall} s "
            f"({kname} launches +{rose}, overcommitted rows 0); layers "
            f"{json.dumps(layers)}")
    out["launches"] = dict(cuda_kernels.LAUNCHES)  # read just after
    for k, v in torch_tier.items():
        check(metrics.counter(f"nomad.solver.kernel.{k}.torch") == v,
              f"the plain torch tier served a {k} solve on the card")
    for name, n in out["launches"].items():
        check(n >= 1, f"kernel {name} was not launched on the main path")
    return out


def profile_phase(torch) -> dict:
    """The 50k eval once more on a fresh cluster under torch.profiler
    (device activity only): the card's busy time against the eval's wall
    time. Separate from the main path so its timing is unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    from nomad_tpu_torch import mock
    fsm, planner = _cluster(N_LIVE, seed=43)
    job = _mk_batch_job(mock, "big-profiled", BIG_COUNT)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _run_eval(fsm, planner, job, "chip-smoke-big-profiled")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_s": wall, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / (wall * 1e3),
           "top_device_ms": {k[:60]: v for k, v in top}}
    log(f"profiled 50k eval: wall {wall} s, device busy {busy} ms, idle "
        f"share {out['idle_share']}; top {json.dumps(out['top_device_ms'])}")
    return out


def small_phase(torch) -> None:
    """A 200-node cluster's evals on the card and on the CPU's plain
    tier: the committed alloc -> node maps must be identical."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.solver import backend
    from nomad_tpu_torch.solver.device import use_device
    maps = []
    for dev in ("cuda:0", "cpu"):
        use_device(dev)
        backend.reset()
        fsm, planner = _cluster(200, seed=7, pin="small-node-")
        m = {}
        for job_id, count in (("s-dense", 200), ("s-grid", 60),
                              ("s-one", 1)):
            _run_eval(fsm, planner, _mk_batch_job(mock, job_id, count),
                      f"chip-smoke-{job_id}")
            m.update({a.name: a.node_id for a in fsm.state.iter_allocs()})
        maps.append(m)
    use_device("cuda:0")
    backend.reset()
    check(len(maps[0]) == 261, f"small: placed {len(maps[0])}/261")
    diff = sum(maps[0][k] != maps[1].get(k) for k in maps[0])
    check(diff == 0, f"small: {diff} allocs placed differently on the "
          f"card than on the CPU")
    log("small: 261 allocs, card and CPU maps identical")


# ------------------------------------------------------------------ main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import numpy as np
        from nomad_tpu_torch.solver import cuda_kernels
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    card = device_phase(torch)
    secs = cuda_kernels.build()
    log(f"build: {secs:.2f} s")
    for name, text in cuda_kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    res = kernels_phase(np, torch, dev)
    main = main_path_phase(torch)
    prof = profile_phase(torch)
    small_phase(torch)

    meta = {
        "depth_curve": ("nomad_tpu_torch/solver/csrc/depth_curve.cu",
                        "nomad_tpu/solver/pallas_kernels.py:174"),
        "score_capacity": ("nomad_tpu_torch/solver/csrc/score_capacity.cu",
                           "nomad_tpu/solver/pallas_kernels.py:31"),
    }
    rows = []
    for name, (src, rep) in meta.items():
        r = res[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": rep, "launches": main["launches"][name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None,
               "near_tie_rows": r["near_tie_rows"],
               "moved_nodes": r["moved_nodes"]}
        for k in ("grid_ms", "depths_evaluated"):
            if k in r:
                row[k] = r[k]
        rows.append(row)
    log(json.dumps({"e2e": main["evals"], "profiled_50k": prof,
                    "card": card,
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
