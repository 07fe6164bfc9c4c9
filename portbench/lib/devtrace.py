"""The traced window: torch.profiler over the whole window, the hand
kernels' calls with their shapes, and the harness's host spans.

Device time is the union of every device activity (kernels, copies,
sets) that the profiler recorded in the window; the host spans are the
harness's own, around its calls into the program's layers, on the
profiler's clock (ns since the epoch).
"""
from __future__ import annotations

import functools
import time

# the hand kernels' entries in cuda_kernels whose calls are recorded:
# wrapper name -> how to read the launch name and shapes from its args
WRAPPED = ("_launch_depth_curve", "_launch_score_capacity",
           "score_capacity_gather", "fit_verdict", "chunked_scan")
# the program's layers whose spans the idle gaps are named by, innermost
# first: (module, class, method, span name)
HOST_LAYERS = (
    ("nomad_tpu_torch.server.plan_apply", "Planner", "apply_plan_batch",
     "plan_apply"),
    ("nomad_tpu_torch.scheduler.generic_sched", "GenericScheduler",
     "process", "scheduler"),
)
GAP_ORDER = ("plan_apply", "scheduler", "client.complete",
             "client.register", "client.deregister", "client.wait")
TOP = 10


def _count(t):
    """A device-side count of a bool tensor's true entries, taken without
    waiting for the device."""
    import torch
    return torch.count_nonzero(t)


def _record_call(name: str, args: tuple, kwargs: dict, out) -> dict:
    """The shapes a roofline needs, as ints or device scalars read after
    the window."""
    if name == "_launch_depth_curve":
        (launch, lead, cap, used, ask, feasible) = args[:6]
        gather = kwargs.get("gather") if len(args) < 14 else args[13]
        rec = {"launch": launch, "lanes": lead[0] if lead else 1,
               "n": feasible.shape[-1]}
        if gather is not None:
            rec["n_res"] = cap.shape[0]
            rec["live"] = _count(gather[1])
        return rec
    if name == "_launch_score_capacity":
        return {"launch": "score_capacity", "lanes": 1,
                "n": args[3].shape[-1]}
    if name == "score_capacity_gather":
        return {"launch": "score_capacity_gather", "lanes": 1,
                "n": args[2].shape[-1], "n_res": args[0].shape[0],
                "live": _count(args[3])}
    if name == "fit_verdict":
        idx, valid = args[2], args[3]
        return {"launch": "fit_verdict",
                "lanes": idx.shape[0] if idx.dim() > 1 else 1,
                "n": idx.shape[-1], "n_res": args[0].shape[0],
                "live": _count(valid)}
    if name == "chunked_scan":
        feasible = args[4]
        placed, steps = out[0], out[4]
        sc, dr = args[8], args[14]
        return {"launch": "chunked_scan", "lanes": 1, "n": feasible.shape[0],
                "feasible": _count(feasible), "selected": _count(placed),
                "steps": steps.clone(), "n_s": sc.shape[0],
                "n_p": sc.shape[1], "n_d": dr.shape[0], "n_dp": dr.shape[1],
                "placed_init": kwargs.get("placed_init") is not None}
    raise KeyError(name)


def _resolve(rec: dict) -> dict:
    out = {}
    for k, v in rec.items():
        out[k] = int(v.reshape(-1)[0].item()) if hasattr(v, "item") else v
    return out


class Profiler:
    def __init__(self, run):
        self.run = run
        self.on_card = run.device != "cpu"
        self.restore: list = []

    def _wrap(self, owner, attr: str, wrapper) -> None:
        orig = getattr(owner, attr)
        self.restore.append((owner, attr, orig))
        setattr(owner, attr, wrapper(orig))

    def _install(self) -> None:
        import importlib
        from nomad_tpu_torch.solver import cuda_kernels
        calls = self.run.kernel_calls

        def kernel(name):
            def wrap(orig):
                @functools.wraps(orig)
                def inner(*a, **kw):
                    out = orig(*a, **kw)
                    if getattr(a[2] if name == "_launch_depth_curve"
                               else a[0], "is_cuda", False):
                        try:
                            calls.append(_record_call(name, a, kw, out))
                        except (IndexError, KeyError, AttributeError,
                                TypeError) as e:
                            calls.append({"launch": name, "error": repr(e)})
                    return out
                return inner
            return wrap
        for name in WRAPPED:
            self._wrap(cuda_kernels, name, kernel(name))
        spans = self.run.spans

        def layer(span):
            def wrap(orig):
                @functools.wraps(orig)
                def inner(*a, **kw):
                    with spans.span(span):
                        return orig(*a, **kw)
                return inner
            return wrap
        for mod, cls, meth, span in HOST_LAYERS:
            owner = getattr(importlib.import_module(mod), cls)
            self._wrap(owner, meth, layer(span))

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        # the card's activity alone: recording every host op of every
        # thread would slow the host layers the window measures
        acts = [ProfilerActivity.CUDA if self.on_card
                else ProfilerActivity.CPU]
        self._install()
        self.run.spans.on = True
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.time_ns()
        if self.on_card:
            torch.cuda.synchronize()

    def stop(self) -> dict:
        import torch
        t1 = time.time_ns()
        if self.on_card:
            torch.cuda.synchronize()
        self.prof.stop()
        self.run.spans.on = False
        for owner, attr, orig in reversed(self.restore):
            setattr(owner, attr, orig)
        # the profiler stamps its events in ns since the epoch, the clock
        # of time.time_ns() that the window and the spans are read on
        dev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() != torch.autograd.DeviceType.CPU]
        self.run.kernel_calls[:] = [_resolve(c)
                                    for c in self.run.kernel_calls]
        out = summarize(dev, self.t0, t1, list(self.run.spans.items))
        out["on_card"] = self.on_card
        return out


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(spans: list, t: int) -> str:
    active = {n for n, s, e in spans if s <= t < e}
    for name in GAP_ORDER:
        if name in active:
            return name
    return "host, outside the harness's spans"


def summarize(dev: list, t0: int, t1: int, spans: list) -> dict:
    """busy_s (the union of device activity clipped to [t0, t1]),
    window_s, each kernel's total seconds and count, and the TOP longest
    idle gaps named by the host span they fell in. Times in ns on one
    clock."""
    clipped = [(n, max(s, t0), min(e, t1)) for n, s, e in dev
               if e > t0 and s < t1]
    merged = _union([(s, e) for _, s, e in clipped])
    busy = sum(e - s for s, e in merged)
    by_name: dict = {}
    for n, s, e in clipped:
        tot, cnt = by_name.get(n, (0, 0))
        by_name[n] = (tot + (e - s), cnt + 1)
    gaps, prev = [], t0
    for s, e in merged + [[t1, t1]]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    return {
        "busy_s": busy / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "kernels": {n: {"seconds": tot / 1e9, "count": cnt}
                    for n, (tot, cnt) in by_name.items()},
        "device_ops": [[n[:160], tot / 1e9] for n, (tot, _) in sorted(
            by_name.items(), key=lambda kv: -kv[1][0])[:TOP]],
        "idle_gaps": [[_label(spans, (s + e) // 2), d / 1e9]
                      for d, s, e in gaps[:TOP]],
    }
