"""server layer: nomad.worker.invoke_scheduler_<type>, every type, a
mean per eval processed in the window (ms)."""


def read(w):
    n = w.evals_processed()
    if not n:
        return None
    return sum(w.timer_sum(k) for k in w.names(
        "nomad.worker.invoke_scheduler_")) / n * 1e3
