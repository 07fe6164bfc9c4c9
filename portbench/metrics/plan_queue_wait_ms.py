"""plan applier layer: nomad.plan.queue_wait, each plan's wait from its
submission to the applier's drain, its sum in the window over the evals
processed in it (ms); nothing where the timer recorded nothing in the
window."""

TIMER = "nomad.plan.queue_wait"


def read(w):
    return w.per_eval_ms(TIMER)
