"""The control: the reference put in the program's place, with one
guarantee broken on purpose.

Each committed plan's placements are moved to where a first-fit over the
fleet's nominal capacity would put them, blind to every allocation that
earlier plans committed: the stale view of usage that a faster state
cache would tempt a later change into. The check has to find the nodes
it overfills; a run under the control comes out not correct.

The control of the placements (`first_fit_solve`) puts a solve in the
program's place that stays within capacity but scores nothing: each
solve's instances go to the nodes in the solve's own row order, each
filled to what it holds. The applier accepts every plan; the reference
of the placements has to find the nodes it chose differently.

And the faults a run can have, each planted in the plan results the
store commits: the plan committed as if nothing was placed (the state
left unchanged), half of the placements left out, and every placement
of a plan moved onto its first node (an answer altered where it is
produced).
"""
from __future__ import annotations

import numpy as np


def first_fit_blind(capacity: np.ndarray, ask, n: int) -> np.ndarray:
    """Rows for `n` instances of `ask` [3], first fit in fleet order on
    the nominal `capacity` [N, 3], as if the fleet were empty."""
    per = np.floor(np.min(capacity / np.asarray(ask, np.float64),
                          axis=1)).clip(min=0).astype(np.int64)
    rows = np.repeat(np.arange(len(per)), per)
    if len(rows) < n:                       # wrap: the fleet is too small
        rows = np.resize(rows, n)
    return rows[:n]


def control(result, run) -> None:
    cap = run.fleet.capacity()
    by_job: dict = {}
    for a in result.alloc_placements:
        if a.job_id in run.jobs:
            by_job.setdefault(a.job_id, []).append(a)
    for job_id, allocs in by_job.items():
        r = run.jobs[job_id]
        rows = first_fit_blind(cap, (r["cpu_mhz"], r["memory_mb"],
                                     r["disk_mb"]), len(allocs))
        for a, row in zip(allocs, rows.tolist()):
            a.node_id = run.fleet.ids[row]
            a.node_name = f"pb-{row}"


def unchanged(result, run) -> None:
    result.alloc_placements = []


def half(result, run) -> None:
    result.alloc_placements = result.alloc_placements[
        :len(result.alloc_placements) // 2]


def altered(result, run) -> None:
    if result.alloc_placements:
        first = result.alloc_placements[0]
        for a in result.alloc_placements:
            a.node_id, a.node_name = first.node_id, first.node_name


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}


def _first_fit(cap, used, ask, count, feasible) -> np.ndarray:
    """Instances per row: rows in order, each filled to what it holds."""
    cap, used, ask = (np.asarray(x, np.float32) for x in (cap, used, ask))
    pos = ask > 0
    per = np.where(pos[None, :], np.floor(
        (cap - used) / np.where(pos, ask, 1.0)[None, :]), 1e9).min(axis=1)
    per = np.where(np.asarray(feasible, bool), per, 0.0).clip(min=0)
    per = per.astype(np.int64)
    prior = np.cumsum(per) - per
    return np.minimum(np.maximum(int(count) - prior, 0), per).astype(
        np.int32)


def _host(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def first_fit_solve(run):
    """Install the control of the placements in this process; returns
    what undoes it. The program's own solve still runs (its random
    draws and its launches stay as they are); its answer is replaced."""
    from nomad_tpu_torch.solver import backend, placer
    orig_dispatch = placer.SolverPlacer._dispatch
    orig_select = backend.select

    def dispatch(self, prep, tg, count):
        orig_dispatch(self, prep, tg, count)
        self.plan.solver_verdict = None      # the applier checks it all
        gt = prep.gt
        return _first_fit(gt.cap, gt.used, gt.ask, count, gt.feasible)

    def select(kernel, *a, **kw):
        name, fn = orig_select(kernel, *a, **kw)
        if kernel != "depth":
            return name, fn

        def first_fit(cap, used, ask, count, feasible, *rest, **kw2):
            import torch
            out = fn(cap, used, ask, count, feasible, *rest, **kw2)
            placed = _first_fit(*(_host(x) for x in (cap, used, ask)),
                                count, _host(feasible))
            dev = out.device if hasattr(out, "device") else "cpu"
            return torch.from_numpy(placed).to(dev)
        return name, first_fit
    placer.SolverPlacer._dispatch = dispatch
    backend.select = select

    def undo():
        placer.SolverPlacer._dispatch = orig_dispatch
        backend.select = orig_select
    return undo
