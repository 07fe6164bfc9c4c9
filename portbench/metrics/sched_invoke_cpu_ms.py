"""server layer: nomad.worker.invoke_cpu, the worker thread's CPU seconds
over the block nomad.worker.invoke_scheduler_<type> times, their sum in
the window over the evals processed in it (ms); the rest of
sched_invoke_ms is time off the CPU. Nothing where the timer recorded
nothing in the window."""

TIMER = "nomad.worker.invoke_cpu"


def read(w):
    return w.per_eval_ms(TIMER)
