"""The metric arithmetic on synthetic readings: a p95 over every eval, a
window's rate, per-eval layer means, the idle share and the roofline
share from a synthetic profiler table."""
import statistics
from types import SimpleNamespace

import pytest

from portbench.lib import devtrace, driver, layers, peaks, report, spec


def test_p95_is_over_every_eval():
    lat = [float(i) for i in range(1, 201)]
    assert driver.quantile(lat, 0.95) == pytest.approx(
        statistics.quantiles(lat, n=100, method="inclusive")[94])
    assert driver.quantile(lat, 0.5) == pytest.approx(statistics.median(lat))
    assert driver.quantile([3.0], 0.95) == 3.0


def test_end_to_end_from_an_outcome():
    run = SimpleNamespace(t_open=12.5, t_start=2.0)
    out = {"placed": 3000, "window_s": 30.0,
           "latencies": [0.1, 0.2, 0.3, 0.4]}
    e2e = report.END_TO_END
    assert e2e["placements_per_s"](run, out) == 100.0
    assert e2e["setup_s"](run, out) == 10.5
    assert e2e["eval_p50_s"](run, out) == pytest.approx(0.25)
    assert e2e["eval_p50_s"](run, dict(out, latencies=[])) is None


class _Sample:
    def __init__(self, vals):
        self.vals = list(vals)

    @property
    def sum(self):
        return sum(self.vals)

    @property
    def total(self):
        return len(self.vals)

    def raw_window(self, skip):
        return self.vals[skip:]


def _window(before: dict, after: dict, **kw) -> layers.Window:
    reg = SimpleNamespace(samples={k: _Sample(v) for k, v in before.items()},
                          counters={})
    probe = layers.Probe(reg)
    for k, v in after.items():
        reg.samples.setdefault(k, _Sample([])).vals.extend(v)
    probe.close()
    return layers.Window(probe, **kw)


def test_layer_means_are_per_eval_processed_in_the_window():
    w = _window({"nomad.solver.tensorize": [5.0],
                 "nomad.worker.invoke_scheduler_batch": [1.0]},
                {"nomad.solver.tensorize": [0.010, 0.030],
                 "nomad.worker.invoke_scheduler_batch": [0.1, 0.1, 0.1],
                 "nomad.worker.invoke_scheduler_service": [0.2],
                 "nomad.worker.submit_plan": [0.004, 0.001, 0.002]})
    assert w.evals_processed() == 4
    tens = spec.metric_reader("tensorize_ms").read(w)
    assert tens == pytest.approx(40.0 / 4)
    assert spec.metric_reader("plan_submit_p50_ms").read(w) == \
        pytest.approx(2.0)
    assert spec.metric_reader("sched_invoke_ms").read(w) == \
        pytest.approx(500.0 / 4)
    assert spec.metric_reader("preempt_ms").read(w) is None


def test_idle_share_from_a_synthetic_table():
    s = 1_000_000_000
    dev = [("k1", 0, s // 10), ("k2", s // 20, s // 5),      # overlap
           ("copy", s // 2, s // 2 + s // 10),
           ("late", 2 * s, 3 * s)]                          # past the window
    spans = [("plan_apply", s // 5, s // 2), ("scheduler", 0, s)]
    summ = devtrace.summarize(dev, 0, s, spans)
    assert summ["busy_s"] == pytest.approx(0.3)
    assert summ["window_s"] == pytest.approx(1.0)
    # the longest gap first, each named by the innermost span over it
    assert summ["idle_gaps"] == [["scheduler", pytest.approx(0.4)],
                                 ["plan_apply", pytest.approx(0.3)]]
    assert summ["device_ops"][0] == ["k2", pytest.approx(0.15)]
    w = layers.Window(None, dict(summ, on_card=True))
    assert spec.metric_reader("device_idle_share").read(w) == \
        pytest.approx(70.0)
    assert spec.metric_reader("device_idle_share").read(
        layers.Window(None, dict(summ, on_card=False))) is None


def test_roofline_share_scales_by_the_launches_recorded():
    roofs = spec.rooflines()
    calls = [{"launch": "score_capacity", "lanes": 1, "n": 16384}] * 3
    nbytes, ops = roofs["score_capacity"].cost(calls[0])
    least = peaks.bound_s(nbytes, ops)
    table = {"kernels": {
        "void score_capacity_kernel(float const*, float const*)":
            {"seconds": 2 * 10 * least, "count": 2},   # one launch dropped
        "void other_kernel()": {"seconds": 1.0, "count": 5}},
        "on_card": True}
    w = layers.Window(None, table, calls, roofs)
    assert spec.metric_reader("kernel_roofline").read(w) == \
        pytest.approx(10.0)
    assert spec.metric_reader("kernel_roofline").read(
        layers.Window(None, table, [], roofs)) is None
