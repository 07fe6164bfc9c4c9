"""server layer: nomad.broker.wait, each eval's wait in the broker from its
enqueue to its dequeue (delay and job-pending time included), its sum in
the window over the evals processed in it (ms); nothing where the timer
recorded nothing in the window."""

TIMER = "nomad.broker.wait"


def read(w):
    return w.per_eval_ms(TIMER)
