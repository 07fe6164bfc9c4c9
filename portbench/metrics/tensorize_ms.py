"""solver host layer: nomad.solver.tensorize, its sum in the window over the evals processed
in it (ms); nothing where the timer recorded nothing in the window."""

TIMER = "nomad.solver.tensorize"


def read(w):
    return w.per_eval_ms(TIMER)
