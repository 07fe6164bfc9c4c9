"""The result line of a run."""
from __future__ import annotations

from . import driver, reference, spec
from .layers import Window

# an end-to-end metric's value from a run's outcome
END_TO_END = {
    "placements_per_s": lambda run, out: out["placed"] / out["window_s"],
    "eval_p50_s": lambda run, out: driver.quantile(out["latencies"], 0.5)
    if out["latencies"] else None,
    "setup_s": lambda run, out: run.t_open - run.t_start,
}


def _device(run, out) -> dict:
    import torch
    dev = {"platform": "gpu" if run.device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if run.device != "cpu"
           else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    tr = getattr(run, "device_trace", None)
    if run.trace and tr is not None and tr["on_card"]:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
    return dev


def per_layer(run, bench: dict) -> dict:
    """Each per-layer metric of the cell that its reader found."""
    win = Window(run.probe, run.device_trace, run.kernel_calls,
                 spec.rooflines(run.bench_dir), run.t_close - run.t_open,
                 latencies=run.latencies)
    got = {}
    for m in spec.per_layer_for(bench, run.cell["name"]):
        v = spec.metric_reader(m["name"], run.bench_dir).read(win)
        if v is not None:
            got[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return got


def result(run, out: dict, bench: dict) -> tuple:
    numbers = out["numbers"]
    ok = reference.correct(numbers) and not out["stragglers_alive"]
    if run.trace:
        metrics = per_layer(run, bench)
    else:
        metrics = {}
        for m in spec.end_to_end_for(bench, run.cell["name"]):
            v = END_TO_END[m["name"]](run, out)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    line = {"correct": bool(ok), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": _device(run, out)}
    tr = getattr(run, "device_trace", None)
    if run.trace and tr is not None and tr["on_card"]:
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = numbers
    return line, numbers
