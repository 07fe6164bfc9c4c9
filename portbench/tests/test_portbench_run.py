"""Whole runs with the look for a card skipped: each cell at a small
size on the CPU comes out correct, and comes out not correct under both
controls (placements moved blind to earlier commits; a solve that fills
nodes in row order and scores nothing) and under each fault the timed
path can have (the state left unchanged, half the placements left out,
an answer altered where it is produced, and in a cell whose jobs spread,
the scan's spread term dropped). The cuda-marked tests run each cell at
its own size on the card: a dozen sound seeds, both controls on three
seeds, and the dropped spread term on three."""
import pytest

from portbench.lib import control, driver, placement, report, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
# a cell whose configuration and mix portbench/ holds but BENCHMARK.json
# does not yet (PERF.md, Open questions): run on the CPU beside the
# cells, so that the spread mix drives the scan's reference and control;
# it leaves this list once BENCHMARK.json has it
HELD = [w for w in ({"name": "sched-service-5k.spread",
                     "config": "sched-service-5k", "traffic": "spread",
                     "chips": 1},)
        if w["name"] not in CELLS]
CPU_BENCH = dict(BENCH, configs=BENCH["configs"] + [
    {"name": n, "file": f"portbench/configs/{n}.json", "reduced": []}
    for n in sorted({w["config"] for w in HELD}
                    - {c["name"] for c in BENCH["configs"]})],
    workloads=BENCH["workloads"] + HELD)
CPU_CELLS = CELLS + [w["name"] for w in HELD]


def _spread_cells(bench: dict) -> list:
    """The cells whose jobs carry a spread: the scan's own fault applies."""
    return [w["name"] for w in bench["workloads"]
            if spec.traffic(w["traffic"])["job"].get("spread")]
# a small fleet and jobs cut to a share of their size, for the CPU
SMALL = {"nodes": 200, "count_scale": 0.02}
HOOKS = {"control": {"plan_hook": control.control},
         "first_fit": {"solve_hook": control.first_fit_solve},
         **{k: {"plan_hook": f} for k, f in control.FAULTS.items()}}
SPREAD_HOOKS = {k: {"solve_hook": f} for k, f in control.SOLVE_FAULTS.items()}
SOUND_SEEDS = [2 ** 31 + 3001 + 17 * i for i in range(12)]
CONTROL_SEEDS = [2 ** 31 + 101, 2 ** 32 + 7, 3 * 10 ** 9]


def _run(cell, hooks=None, seed=2 ** 31 + 9, seconds=1.5, device="cpu",
         pipeline_min=None, **size):
    run = driver.Run(CPU_BENCH, cell, seed, seconds, False, device=device,
                     **(hooks or {}), **(size or SMALL))
    if pipeline_min is not None:
        run.config["spec"]["server"]["scheduler"][
            "plan_pipeline_min_count"] = pipeline_min
    run.setup()
    run.window()
    out = run.finish()
    line, numbers = report.result(run, out, CPU_BENCH)
    run.line = line
    return run, numbers


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("cell", CPU_CELLS)
def test_a_sound_run_is_correct(cell):
    run, numbers = _run(cell)
    line = run.line
    assert line["correct"], numbers
    # on the CPU the reference of the placements meets every node
    assert numbers["misplaced_pct"]["value"] == 0.0
    assert line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {
        m["name"] for m in spec.end_to_end_for(CPU_BENCH, cell)}


@pytest.mark.parametrize("hook", sorted(HOOKS))
@pytest.mark.parametrize("cell", CPU_CELLS)
def test_the_control_and_each_fault_come_out_not_correct(cell, hook):
    run, numbers = _run(cell, HOOKS[hook])
    assert not run.line["correct"], numbers
    if hook == "first_fit":
        # it stays within capacity: only the placements' reference sees it
        assert numbers["over_capacity"]["value"] == 0
        assert numbers["misplaced_pct"]["value"] > \
            numbers["misplaced_pct"]["limit"]


@pytest.mark.parametrize("hook", sorted(SPREAD_HOOKS))
@pytest.mark.parametrize("cell", _spread_cells(CPU_BENCH))
def test_a_scan_without_its_spread_term_comes_out_not_correct(cell, hook):
    """Binpack and anti-affinity alone: the racks stay within rack_skew's
    limit at this size, and only the placements' reference sees it."""
    run, numbers = _run(cell, SPREAD_HOOKS[hook])
    print(f"{hook} {cell}: "
          f"{ {k: v['value'] for k, v in numbers.items()} }")
    assert not run.line["correct"], numbers
    assert numbers["misplaced_pct"]["value"] > \
        numbers["misplaced_pct"]["limit"]
    assert numbers["rack_skew"]["value"] <= numbers["rack_skew"]["limit"]


@pytest.mark.parametrize("hook", [None, "first_fit"])
def test_a_pipelined_eval_is_judged_chunk_by_chunk(hook):
    """The large cell's path at a small size: evals of 1,000 instances
    pipelined in 4 chunk plans, each pass judged whole."""
    cell = next(c for c in CELLS if c.endswith(".bigjob"))
    run, numbers = _run(cell, HOOKS.get(hook), pipeline_min=256)
    passes = placement.group(run.proposals)
    assert passes and len(run.proposals) == 4 * len(passes)
    if hook is None:
        assert run.line["correct"], numbers
        assert numbers["misplaced_pct"]["value"] == 0.0
    else:
        assert not run.line["correct"], numbers


def _card_run(cell, seed, hooks=None, seconds=5.0):
    return _run(cell, hooks, seed=seed, seconds=seconds, device="cuda",
                nodes=0, count_scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SOUND_SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_on_the_card_at_the_cells_size(cell, seed, capsys):
    _card()
    run, numbers = _card_run(cell, seed)
    with capsys.disabled():
        print(f"\nsound {cell} seed {seed}: "
              f"{ {k: v['value'] for k, v in numbers.items()} }")
    assert run.line["correct"], numbers


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("hook", ["control", "first_fit"])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_on_the_card_at_the_cells_size(cell, hook, seed,
                                                    capsys):
    _card()
    run, numbers = _card_run(cell, seed, HOOKS[hook], seconds=8.0)
    with capsys.disabled():
        print(f"\n{hook} {cell} seed {seed}: "
              f"{ {k: v['value'] for k, v in numbers.items()} }")
    assert not run.line["correct"], numbers


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("hook", sorted(SPREAD_HOOKS))
@pytest.mark.parametrize("cell", _spread_cells(BENCH))
def test_the_scans_fault_on_the_card_at_the_cells_size(cell, hook, seed,
                                                       capsys):
    _card()
    run, numbers = _card_run(cell, seed, SPREAD_HOOKS[hook], seconds=8.0)
    with capsys.disabled():
        print(f"\n{hook} {cell} seed {seed}: "
              f"{ {k: v['value'] for k, v in numbers.items()} }")
    assert not run.line["correct"], numbers
