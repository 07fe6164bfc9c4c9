#!/usr/bin/env python3
"""The batch tier's count sweep on one card, with enough pairs of runs to
tell coalescing from noise: chip_smoke.py's stream phase (16 jobs
registered back to back on a fresh 10,000-node server with 4 workers,
micro-batching on and off), PAIRS pairs a count at 1,000, 500, 2,000 and
4,000.

    python3 stream_sweep.py [PAIRS]        # default 10

Each pair runs on and off back to back, on first in even pairs and off
first in odd ones. A count qualifies for backend.BATCH_MAX_COUNT where
the coalesced run was faster in enough pairs for a one-sided sign test at
p <= 0.05 (9 of 10); the pick is the largest count that qualifies, else 0.
Prints chip_smoke.py's `stream` lines, the card's name and power limit,
and last one JSON line: per count the pairs' per-eval wall differences
(on - off, seconds), the wins, the sign test's p, and the pick. Exits
non-zero without a card.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("stream_sweep: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from nomad_tpu_torch import runtime
    from nomad_tpu_torch.solver import cuda_kernels
    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    card = cs.device_phase(torch)
    cs.log(f"build: {cuda_kernels.build():.2f} s; native stamping "
           f"extension built {runtime.ensure_native()}")
    srv = cs._server(1)
    try:
        cs._register_fleet(srv, np, cs.N_LIVE, 42)
        nodes = srv.snapshot_save()
    finally:
        cs._shutdown(srv)
    out = cs.stream_phase(np, torch, nodes, card, pairs=pairs)
    cs.log(card)
    cs.log(json.dumps({
        "pairs": pairs, "card": card,
        "batch_max_count_pick": out["batch_max_count_pick"],
        "summary": {c: {k: cell[k] for k in (
            "pair_diff_s", "wins", "median_pair_diff_s", "sign_test_p",
            "qualifies")} | {"median_eval_wall_s": {
                side: cell[side]["median_eval_wall_s"]
                for side in ("on", "off")}}
            for c, cell in out["summary"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
