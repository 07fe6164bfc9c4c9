"""Whole runs with the look for a card skipped: each cell at a small
size on the CPU comes out correct, and comes out not correct under both
controls (placements moved blind to earlier commits; a solve that fills
nodes in row order and scores nothing) and under each fault the timed
path can have (the state left unchanged, half the placements left out,
an answer altered where it is produced). The cuda-marked tests run each
cell at its own size on the card: a dozen sound seeds, and both controls
on three seeds."""
import pytest

from portbench.lib import control, driver, placement, report, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
# a small fleet and jobs cut to a share of their size, for the CPU
SMALL = {"nodes": 200, "count_scale": 0.02}
HOOKS = {"control": {"plan_hook": control.control},
         "first_fit": {"solve_hook": control.first_fit_solve},
         **{k: {"plan_hook": f} for k, f in control.FAULTS.items()}}
SOUND_SEEDS = [2 ** 31 + 3001 + 17 * i for i in range(12)]
CONTROL_SEEDS = [2 ** 31 + 101, 2 ** 32 + 7, 3 * 10 ** 9]


def _run(cell, hooks=None, seed=2 ** 31 + 9, seconds=1.5, device="cpu",
         pipeline_min=None, **size):
    run = driver.Run(BENCH, cell, seed, seconds, False, device=device,
                     **(hooks or {}), **(size or SMALL))
    if pipeline_min is not None:
        run.config["spec"]["server"]["scheduler"][
            "plan_pipeline_min_count"] = pipeline_min
    run.setup()
    run.window()
    out = run.finish()
    line, numbers = report.result(run, out, BENCH)
    run.line = line
    return run, numbers


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    run, numbers = _run(cell)
    line = run.line
    assert line["correct"], numbers
    # on the CPU the reference of the placements meets every node
    assert numbers["misplaced_pct"]["value"] == 0.0
    assert line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {
        m["name"] for m in spec.end_to_end_for(BENCH, cell)}


@pytest.mark.parametrize("hook", sorted(HOOKS))
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_each_fault_come_out_not_correct(cell, hook):
    run, numbers = _run(cell, HOOKS[hook])
    assert not run.line["correct"], numbers
    if hook == "first_fit":
        # it stays within capacity: only the placements' reference sees it
        assert numbers["over_capacity"]["value"] == 0
        assert numbers["misplaced_pct"]["value"] > \
            numbers["misplaced_pct"]["limit"]


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
