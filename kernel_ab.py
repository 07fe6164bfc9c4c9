#!/usr/bin/env python3
"""A/B timing of nomad_tpu_torch's CUDA kernels on one card: the seeded
inputs of chip_smoke.py, through the package of each checkout given.

    python3 kernel_ab.py ROOT [ROOT ...]   # parent, change, change, parent

Each root runs in a process of its own, in the order given, and builds its
kernels into its own build/kernels/. For each, one JSON line with:

  k1_ms, k1_call_ms      the depth-curve kernel's device time per launch
                         (profiler, 30 launches) and the per-call time of
                         `depth_curve` (CUDA events, median of 200 calls),
                         on the 50k eval's inputs: the fleet empty, dense
                         K=128
  depth_fill_call_ms     one `fill_depth_fused` call, count 50,000
  k2_ms, k2_call_ms      the score/capacity kernel, `score_capacity_fused`
  greedy_fill            one `fill_greedy_binpack_fused` call (count 1): its
                         device kernels (name -> [launches, device ms]),
                         their device time and the call's time
  step_ms, step_call_ms  the chunked-step kernel's device time per launch
                         and `chunked_step`'s per-call time, on the scan's
                         inputs at the 16,384 bucket (chip_smoke.py
                         `_scan_inputs`)
  scan_device_ms,        one `place_chunked` solve of the web job on those
  scan_call_ms           inputs: the device time of every kernel it runs
                         (profiler, 10 solves) and its wall (CUDA events,
                         median of 10); a checkout with the whole-scan
                         kernel runs one launch, an older one a step
                         launch and a torch tail a step
  convex_ms,             the convex-solve kernel's device time per solve on
  convex_spread_ms       bench.py `_convex_run`'s cluster (16,384 rows,
                         binpack and spread, tolerance 1e-4: 2 iterations),
                         each checkout's kernel as its wrapper launches it
  verdict_ms             the fit-verdict kernel's device time per launch on
                         the fused route's inputs (chip_smoke.py
                         `_fused_inputs`: 10,000 live rows of 16,384
                         through a shuffled idx)
  shard_scan_ms,         the mesh's two kernels, each one's device time a
  shard_convex_ms        solve on 4 virtual shards of the card (chip_smoke.py
                         `_mesh_world`): `chunked_shard` on the scan's
                         inputs above (250 steps), `convex_solve_sharded`
                         on the convex fixture above (binpack, 39 rounds);
                         every launch of the solve, however the checkout
                         lays them out (one a shard a step, or one a step)
  shard_launches         the launches of one such solve, of each
  timing                 how each *_ms above was taken, where not from a
                         whole trace: "profiler (n of 30 launches)",
                         "queued events" or null (chip_smoke.py
                         `_device_ms`)

then the card's name and power limit. Exits non-zero without a card.

    python3 kernel_ab.py --evals ROOT [ROOT ...]

runs, for each root in a process of its own and in the order given, that
root's own `chip_smoke.py` compare phase (the 50k-task / 10k-node eval on
fresh clusters in turns, as that checkout configures it) and prints one
JSON line per root with its walls and their medians per cell.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def one(root: str) -> dict:
    import importlib.util

    import numpy as np
    import torch
    # this checkout's chip_smoke.py (its inputs and timers) for every root
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(Path(root).resolve()))
    import nomad_tpu_torch
    from nomad_tpu_torch.solver import cuda_kernels
    pkg = Path(nomad_tpu_torch.__file__).resolve()
    cs.check(Path(root).resolve() in pkg.parents,
             f"imported {pkg}, not the package under {root}")
    cuda_kernels.build()
    dev = torch.device("cuda:0")
    inp = cs._inputs(np, torch, dev)
    empty = (inp["cap"], torch.zeros_like(inp["used"]), inp["ask"],
             inp["feasible"], torch.zeros_like(inp["coll"]), cs.BIG_COUNT,
             inp["aff"])
    base = (inp["cap"], inp["used"], inp["ask"], inp["feasible"])

    def k1():
        return cuda_kernels.depth_curve(*empty, k_max=128)

    def depth_fill():
        return cuda_kernels.fill_depth_fused(
            *empty[:3], cs.BIG_COUNT, *empty[3:], k_max=128)

    def k2():
        return cuda_kernels.score_capacity_fused(*base)

    def greedy_fill():
        return cuda_kernels.fill_greedy_binpack_fused(*base[:3], 1, base[3])

    timing = {}

    def device_ms(key, fn, kernel):
        ms, _, how = cs._device_ms(torch, fn, kernel)
        if how != "profiler":
            timing[key] = how
        return ms

    out = {"root": root,
           "k1_ms": device_ms("k1_ms", k1, "depth_curve_kernel"),
           "k1_call_ms": cs._median_ms(torch, k1, cs.CALL_REPS),
           "depth_fill_call_ms": cs._median_ms(torch, depth_fill),
           "k2_ms": device_ms("k2_ms", k2, "score_capacity_kernel"),
           "k2_call_ms": cs._median_ms(torch, k2, cs.CALL_REPS),
           "greedy_fill": cs._kernel_list(torch, greedy_fill)}
    out["greedy_fill"]["call_ms"] = cs._median_ms(torch, greedy_fill,
                                                  cs.CALL_REPS)
    scan_args, d_active = cs._scan_inputs(np, torch, dev)
    placed = torch.zeros(cs.N_BUCKET, dtype=torch.int32, device=dev)
    step_args = cs._step_args(scan_args, placed, d_active)

    def step():
        return cuda_kernels.chunked_step(*step_args)

    def scan():
        return cuda_kernels.place_chunked(*scan_args)

    out.update(step_ms=device_ms("step_ms", step, "chunked_step_kernel"),
               step_call_ms=cs._median_ms(torch, step, cs.CALL_REPS),
               scan_device_ms=cs._device_ms(torch, scan, "", reps=10)[1],
               scan_call_ms=cs._median_ms(torch, scan, 10))
    for key, name in (("convex_ms", "bench_binpack"),
                      ("convex_spread_ms", "bench_spread")):
        solve, _, spread, _ = cs._convex_args(np, torch, dev, name)
        out[key] = device_ms(
            key, lambda: cuda_kernels.convex_solve(
                *solve, spread_algorithm=spread), "convex_solve")
    fin = cs._fused_inputs(np, torch, dev)
    placed = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        0, 3, cs.N_BUCKET).astype(np.int32)).to(dev)
    out["verdict_ms"] = device_ms(
        "verdict_ms", lambda: cuda_kernels.fit_verdict(
            fin["cap"], fin["used"], fin["idx"], fin["valid"], fin["ask"],
            placed), "fit_verdict_kernel")
    out.update(_shard_ms(np, torch, cs, cuda_kernels, dev, scan_args,
                         timing))
    out["timing"] = timing
    return out


def _shard_ms(np, torch, cs, cuda_kernels, dev, scan_args, timing) -> dict:
    """The mesh's two kernels on cs.MESH_SHARDS virtual shards of `dev`:
    each one's device time a solve (the profiler's, over 5 solves of every
    launch a solve makes; queued CUDA events where no trace records
    them) and its launches a solve."""
    from nomad_tpu_torch.solver import sharding
    cs._mesh_world([str(dev)] * cs.MESH_SHARDS)
    m = sharding.mesh()
    blocks = cs._shard_scan_blocks(torch, m, scan_args)
    solve, _, spread, _ = cs._convex_args(np, torch, dev, "bench_binpack")

    def blk(x):
        return list(sharding.node_blocks(x, m))
    sargs = (blk(solve[0]), blk(solve[1]), [solve[2]] * m.size,
             blk(solve[3]), blk(solve[4]), blk(solve[5])) + solve[6:]
    out = {"shard_launches": {}}
    for key, name, fn in (
            ("shard_scan_ms", "chunked_shard",
             lambda: cuda_kernels.chunked_shard(*blocks)),
            ("shard_convex_ms", "convex_shard",
             lambda: cuda_kernels.convex_solve_sharded(
                 *sargs, spread_algorithm=spread))):
        cuda_kernels.reset_launches()
        fn()
        torch.cuda.synchronize()
        per = cuda_kernels.LAUNCHES[name]
        ms, _, how = cs._device_ms(torch, fn, f"{name}_kernel", reps=5,
                                   per_call=per, scale_missing=True)
        if not ms:
            ms, how = cs._queued_ms(torch, fn, 5), "queued events"
        if how != "profiler":
            timing[key] = how
        out[key] = ms
        out["shard_launches"][name] = per
    cs._mesh_world(None)
    return out


def one_evals(root: str) -> dict:
    """`root`'s own chip_smoke.py compare phase, in this process."""
    import importlib.util

    import torch
    root_path = Path(root).resolve()
    sys.path.insert(0, str(root_path))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root_path / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import nomad_tpu_torch
    from nomad_tpu_torch.solver import cuda_kernels
    pkg = Path(nomad_tpu_torch.__file__).resolve()
    cs.check(root_path in pkg.parents,
             f"imported {pkg}, not the package under {root}")
    cuda_kernels.build()
    out = cs.compare_phase(torch)
    return {"root": root, "median_wall_s": out["median_wall_s"],
            "walls_s": out.get("cells_s", out["walls_s"])}


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    if argv[:1] == ["--one-evals"]:
        print(json.dumps(one_evals(argv[1])))
        return 0
    mode = "--one"
    if argv[:1] == ["--evals"]:
        mode, argv = "--one-evals", argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        run = subprocess.run([sys.executable, __file__, mode, root],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
