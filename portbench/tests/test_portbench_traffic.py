"""The generator and the fleet are functions of the seed alone."""
import json

import numpy as np
import pytest

from portbench.lib import fleet, spec, traffic

STREAM = spec.traffic("stream")


def test_levels_are_the_log_uniform_quantiles():
    levels = traffic.count_levels({"log_uniform": [50, 2000], "levels": 16})
    assert len(levels) == 16 and levels == sorted(levels)
    assert levels[0] == 56 and levels[-1] == 1782   # cell midpoints
    assert traffic.count_levels({"fixed": 600}) == [600]


def test_a_seed_gives_the_same_jobs():
    a = [traffic.Client(STREAM, 2 ** 31 + 77, c, "t").job(k)
         for c in range(16) for k in range(40)]
    b = [traffic.Client(STREAM, 2 ** 31 + 77, c, "t").job(k)
         for c in range(16) for k in range(40)]
    assert a == b


def test_every_seed_sends_the_same_sizes_each_round():
    """In every round of cycles the clients together ask for each level
    once, whatever the seed: seeds change the arrangement, not the
    work."""
    levels = sorted(traffic.count_levels(STREAM["count"]))
    orders = set()
    for seed in (1, 2, 2 ** 33 + 5):
        clients = [traffic.Client(STREAM, seed, c, "t") for c in range(16)]
        for k in range(5):
            assert sorted(c.job(k)["count"] for c in clients) == levels
        orders.add(tuple(clients[0].job(k)["count"] for k in range(16)))
    assert len(orders) == 3


def test_fleet_is_a_function_of_the_seed():
    cfg = spec.config(spec.load_benchmark(), "c2m-batch-10k")["spec"]
    a, b = fleet.make(cfg["fleet"], 9, 500), fleet.make(cfg["fleet"], 9, 500)
    c = fleet.make(cfg["fleet"], 10, 500)
    assert a.ids == b.ids and (a.cpu == b.cpu).all() and (a.mem == b.mem).all()
    assert a.ids != c.ids
    assert len(set(a.ids)) == 500
    assert set(a.cpu.tolist()) <= set(cfg["fleet"]["cpu_mhz_choices"])
    assert a.dc[:4] == ["dc1", "dc2", "dc1", "dc2"]
    assert (a.capacity()[:, 0] == a.cpu - 100).all()


def test_racks_and_fill_count():
    cfg = json.loads((spec.BENCH_DIR / "configs/sched-service-5k.json")
                     .read_text())
    f = fleet.make(cfg["fleet"], 3, 250)
    assert f.rack[:3] == ["r0", "r1", "r2"] and f.rack[100] == "r0"
    # a mock node less its reserve holds one 2,000 MHz / 4,096 MB filler
    assert traffic.fill_count(f.capacity(), (2000, 4096, 300)) == 250


@pytest.mark.parametrize("bad", [
    {"clients": 0, "count": {"fixed": 1}},
    {"clients": 1, "count": {"fixed": 1, "log_uniform": [1, 2]}},
    {"clients": 1, "count": {"fixed": 1},
     "after_commit": [{"do": "refill"}]},
    {"clients": 1, "count": {"fixed": 1}, "after_commit": [{"do": "x"}]}])
def test_a_malformed_mix_is_refused(bad):
    with pytest.raises(ValueError):
        traffic.validate(bad)


def test_fill_count_matches_a_loop():
    rng = np.random.default_rng(4)
    cap = rng.integers(0, 10_000, (50, 3)).astype(np.float64)
    ask = (300, 700, 50)
    want = sum(int(min(c[0] // 300, c[1] // 700, c[2] // 50)) for c in cap)
    assert traffic.fill_count(cap, ask) == want
