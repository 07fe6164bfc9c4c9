"""server layer: the median of nomad.worker.submit_plan, the wait of a
worker for the applier's answer, over the plans submitted in the window
(ms)."""


def read(w):
    return w.median_ms("nomad.worker.submit_plan")
