"""server layer, seen from the clients: the 95th percentile of the
register -> complete waits of the clients' jobs in the window (s); in a
closed loop the waits set the rate (placements_per_s); nothing with
fewer than 20 waits."""
from portbench.lib import driver

MIN_WAITS = 20


def read(w):
    if len(w.latencies) < MIN_WAITS:
        return None
    return driver.quantile(w.latencies, 0.95)
