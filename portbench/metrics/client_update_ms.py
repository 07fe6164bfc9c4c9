"""client update layer: nomad.client.update_alloc, the whole of a client
update (its raft apply, the lookups, the follow-up evals' apply), its sum
in the window over the evals processed in it (ms); nothing where the
timer recorded nothing in the window."""

TIMER = "nomad.client.update_alloc"


def read(w):
    return w.per_eval_ms(TIMER)
