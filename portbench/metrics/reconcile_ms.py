"""scheduler layer: nomad.scheduler.reconcile, its sum in the window over the evals processed
in it (ms); nothing where the timer recorded nothing in the window."""

TIMER = "nomad.scheduler.reconcile"


def read(w):
    return w.per_eval_ms(TIMER)
