"""state store layer: nomad.state.lock_wait, the waits of the state
store's lock acquisitions that blocked, their sum in the window over the
evals processed in it (ms). 0.0 where evals were processed and no
acquisition blocked; nothing where no eval was processed, or where the
program does not time its store's lock."""
import importlib.util

TIMER = "nomad.state.lock_wait"


def read(w):
    n = w.evals_processed()
    if not n or importlib.util.find_spec("nomad_tpu_torch.obs.timing") is None:
        return None
    return w.timer_sum(TIMER) / n * 1e3
