"""device layer: the share of the traced window in which no operation ran
on the card (%): 1 - the union of the profiler's device intervals over
the window."""


def read(w):
    d = w.device
    if not d or not d.get("on_card") or not d["window_s"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
