#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, portbench/ and
nomad_tpu_torch/, on a machine with an NVIDIA card. The cell's
configuration, traffic mix and per-layer metrics are found by the names
BENCHMARK.json gives them (portbench/README.md). Prints, as the last line
of standard output, one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer ones),
device, with --trace 1 breakdown, and last the numbers the reference
compared, each beside its limit (which also end standard error).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# a run that has not ended by then prints every thread's stack and exits
# non-zero, inside the 360 s a run is given
WATCHDOG_S = 350


def _process_age() -> float:
    """Seconds since this process started (/proc), else since this file
    began to run."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"),
                   time.perf_counter() - T_START)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a cell's first run there builds; nothing that would
    load JAX through a library."""
    os.environ["NOMAD_COMPILE_CACHE"] = str(BUILD / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _fail(msg: str, code: int = 2) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    age0 = _process_age() - (time.perf_counter() - T_START)
    _caches()
    sys.path.insert(0, str(ROOT))
    from portbench.lib import guard, report, spec
    try:
        bench = spec.load_benchmark(ROOT)
        cell = spec.workload(bench, args.workload)
    except spec.SpecError as e:
        _fail(str(e))
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        _fail(f"the cell asks for {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}")
    from portbench.lib import driver
    run = driver.Run(bench, args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start=T_START - age0)
    run.setup()
    run.window()
    loaded = guard.forbidden_loaded()
    if loaded:
        _fail(f"the run loaded {loaded}: the benchmark measures the port "
              "alone", code=3)
    out = run.finish()
    line, numbers = report.result(run, out, bench)
    for k, v in numbers.items():
        print(f"[portbench] check {k} {v['value']} limit {v['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
