"""Cells, configurations, mixes, metrics and rooflines are found by the
names BENCHMARK.json gives them; a cell added as files alone is found."""
import json
import shutil

import pytest

import numpy as np

from portbench.lib import driver, fleet, reference, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_its_parts(cell):
    w = spec.workload(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    assert cfg["spec"]["name"] == w["config"]
    mix = spec.traffic(w["traffic"])
    assert mix["limits"]
    layers = spec.per_layer_for(BENCH, cell)
    assert layers
    for m in layers:
        assert callable(spec.metric_reader(m["name"]).read)
    names = {m["name"] for m in spec.end_to_end_for(BENCH, cell)}
    assert {"setup_s", "placements_per_s"} <= names


def test_every_roofline_names_its_kernel():
    roofs = spec.rooflines()
    assert {"depth_curve", "depth_curve_gather", "score_capacity",
            "score_capacity_gather", "fit_verdict", "chunked_scan"} <= \
        set(roofs)
    for mod in roofs.values():
        assert mod.KERNEL.endswith("_kernel")


def test_unknown_names_are_refused():
    with pytest.raises(spec.SpecError):
        spec.workload(BENCH, "no-such-cell")
    with pytest.raises(spec.SpecError):
        spec.traffic("no-such-mix")
    with pytest.raises(spec.SpecError):
        spec.metric_reader("no_such_metric")
    with pytest.raises(spec.SpecError):
        spec.check_reader("no_such_check")


def test_per_layer_metrics_follow_their_workloads_key():
    stream = [m["name"] for m in spec.per_layer_for(
        BENCH, "c2m-batch-10k.stream")]
    bigjob = [m["name"] for m in spec.per_layer_for(
        BENCH, "c2m-batch-10k.bigjob")]
    assert "eval_p95_s.tail" in stream and "eval_p95_s.tail" not in bigjob
    assert "device_idle_share" in bigjob


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A later change adds a configuration, a mix and a metric as new
    files and new entries: the harness finds and loads them by name, and
    builds the run, measuring nothing."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (root / "portbench/configs/dummy-fleet.json").write_text(json.dumps({
        "name": "dummy-fleet",
        "fleet": {"nodes": 7, "cpu_mhz_choices": [1000],
                  "memory_mb_choices": [2048], "disk_mb": 10000,
                  "reserved": {"cpu_mhz": 0, "memory_mb": 0, "disk_mb": 0},
                  "datacenters": ["dc9"], "racks": 0, "node_classes": 1},
        "server": {"workers": 1, "scheduler": {}, "gc": {
            "interval_s": 5, "job_threshold_s": 5, "eval_threshold_s": 5}}
    }))
    (root / "portbench/traffic/dummy-mix.json").write_text(json.dumps({
        "clients": 2, "count": {"fixed": 3},
        "job": {"type": "batch", "cpu_mhz": 10, "memory_mb": 10,
                "disk_mb": 10, "priority": 50, "datacenters": ["dc9"]},
        "after_commit": [], "limits": {"unplaced": 0}}))
    (root / "portbench/metrics/dummy_metric.py").write_text(
        "def read(w):\n    return 42.0\n")
    bench["configs"].append({
        "name": "dummy-fleet", "source": "https://example.org/dummy",
        "file": "portbench/configs/dummy-fleet.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "dummy-fleet.dummy-mix", "config": "dummy-fleet",
        "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "dummy_metric", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "dummy",
        "moves": "placements_per_s",
        "workloads": ["dummy-fleet.dummy-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = spec.load_benchmark(root)
    run = driver.Run(loaded, "dummy-fleet.dummy-mix", 5, 1.0, False,
                     device="cpu", bench_dir=root / "portbench")
    assert len(run.fleet) == 7 and run.fleet.dc == ["dc9"] * 7
    assert run.mix["clients"] == 2
    names = [m["name"] for m in spec.per_layer_for(
        loaded, "dummy-fleet.dummy-mix")]
    assert "dummy_metric" in names
    reader = spec.metric_reader("dummy_metric", root / "portbench")
    assert reader.read(None) == 42.0


def test_a_check_added_as_a_file_is_read_by_the_reference(tmp_path):
    """A limit that reference.judge has no reader for is read by
    checks/<limit>.py, given the run; a limit with no such file is
    refused, naming the file looked for."""
    (tmp_path / "checks").mkdir()
    (tmp_path / "checks" / "late-stops.py").write_text(
        "def read(run):\n    return len(run['stops']) * 2\n")
    assert spec.check_reader("late-stops", tmp_path).read(
        {"stops": [1]}) == 2
    fl = fleet.make({"nodes": 2, "cpu_mhz_choices": [1000],
                     "memory_mb_choices": [1000], "disk_mb": 1000,
                     "reserved": {"cpu_mhz": 0, "memory_mb": 0,
                                  "disk_mb": 0},
                     "datacenters": ["dc1"], "racks": 0,
                     "node_classes": 1}, 1)
    none = reference.Allocs(name=np.zeros(0, np.int64),
                            row=np.zeros(0, np.int64))
    got = reference.judge(fl, none, {}, [], {"unplaced": 0,
                                             "late-stops": 3},
                          run={"stops": [1, 2]}, bench_dir=tmp_path)
    assert got == {"unplaced": {"value": 0, "limit": 0},
                   "late-stops": {"value": 4, "limit": 3}}
    assert not reference.correct(got)
    with pytest.raises(spec.SpecError,
                       match=str(tmp_path / "checks" / "lost-writes.py")):
        reference.judge(fl, none, {}, [], {"lost-writes": 0}, run=None,
                        bench_dir=tmp_path)
