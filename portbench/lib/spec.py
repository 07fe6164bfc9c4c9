"""Finding a cell's parts by name.

BENCHMARK.json, at the checkout's root, names every cell, configuration
and metric. Each part lives in a file of its own under portbench/, found
here from its name and never listed in code:

    configs/<file named by BENCHMARK.json>   the deployment (fleet, server)
    traffic/<mix>.json                       the traffic mix's parameters
    metrics/<metric>.py                      one per-layer metric's reader
    rooflines/<kernel>.py                    one hand kernel's bytes and ops
    checks/<limit>.py                        one correctness number's reader
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(RuntimeError):
    """A cell, configuration, mix or metric that the files do not hold."""


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration entry `name` with its file's contents under
    "spec"."""
    for c in bench["configs"]:
        if c["name"] == name:
            return dict(c, spec=json.loads((root / c["file"]).read_text()))
    raise SpecError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    path = bench_dir / "traffic" / f"{name}.json"
    if not path.is_file():
        raise SpecError(f"no traffic mix {path}")
    return json.loads(path.read_text())


def _module(path: Path, qualname: str):
    spec = importlib.util.spec_from_file_location(qualname, path)
    if spec is None or spec.loader is None:
        raise SpecError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """metrics/<name>.py: a module with read(window) -> float | None."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no reader {path} for per-layer metric {name!r}")
    return _module(path, f"portbench_metric_{name.replace('.', '_')}")


def check_reader(name: str, bench_dir: Path = BENCH_DIR):
    """checks/<name>.py: a module with read(run) -> number, the number a
    mix's limit `name` holds a run to (reference.judge)."""
    path = bench_dir / "checks" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no reader {path} for check {name!r}")
    return _module(path, "portbench_check_" + name.replace(".", "_")
                   .replace("-", "_"))


def rooflines(bench_dir: Path = BENCH_DIR) -> dict:
    """Every rooflines/<kernel>.py by the launch name it counts (its
    stem): modules with KERNEL (the device function's name) and
    cost(call) -> (bytes, ops)."""
    out = {}
    for path in sorted((bench_dir / "rooflines").glob("*.py")):
        if path.stem.startswith("_"):
            continue
        out[path.stem] = _module(path, f"portbench_roofline_{path.stem}")
    return out


def end_to_end_for(bench: dict, cell: str) -> list:
    """The end-to-end metrics that `cell` reports: those with no
    "workloads" key, and those that name it."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_for(bench: dict, cell: str) -> list:
    """The per-layer metrics that `cell` reports: those that name it, and
    those with no "workloads" key whose end-to-end metric it reports."""
    reported = {m["name"] for m in end_to_end_for(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
