"""client update layer: nomad.fsm.alloc_client_update, the FSM's apply of
a client update (the store's update_allocs_from_client), its sum in the
window over the evals processed in it (ms); nothing where the timer
recorded nothing in the window."""

TIMER = "nomad.fsm.alloc_client_update"


def read(w):
    return w.per_eval_ms(TIMER)
