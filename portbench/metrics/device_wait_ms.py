"""solve layer: nomad.solver.device, the solve's waits for the card's
answer at its host syncs (one sample a sync, on every route), their sum
in the window over the evals processed in it (ms); nothing where the
timer recorded nothing in the window."""

TIMER = "nomad.solver.device"


def read(w):
    return w.per_eval_ms(TIMER)
