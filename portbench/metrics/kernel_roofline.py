"""kernels layer: the hand kernels' least time on the card's published
peaks (rooflines/<launch>.py, from each recorded call's shapes) over
their device time in the profiler's table, across the traced window (%).

A kernel's least time is taken per call, its mean over the calls recorded
multiplied by the launches the profiler recorded, so a launch record the
profiler drops takes its bound with it. Nothing where the window
launched no hand kernel."""
import re

from portbench.lib import peaks


def shares(w) -> dict:
    """{device kernel name: (least seconds, device seconds)}."""
    d = w.device
    if not d or not d.get("on_card"):
        return {}
    bounds: dict = {}
    for c in w.kernel_calls:
        mod = w.rooflines.get(c.get("launch"))
        if mod is None or "error" in c:
            continue
        b, o = mod.cost(c)
        bounds.setdefault(mod.KERNEL, []).append(peaks.bound_s(b, o))
    out = {}
    for kernel, bs in bounds.items():
        name = re.compile(rf"\b{kernel}\b")
        rows = [v for n, v in d["kernels"].items() if name.search(n)]
        count = sum(v["count"] for v in rows)
        secs = sum(v["seconds"] for v in rows)
        if count and secs:
            out[kernel] = (sum(bs) / len(bs) * count, secs)
    return out


def read(w):
    s = shares(w)
    dev = sum(v[1] for v in s.values())
    return 100.0 * sum(v[0] for v in s.values()) / dev if dev else None
