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
filled to what it holds, on every route (the greedy and depth solves
and the chunked scan). The applier accepts every plan; the reference of
the placements has to find the nodes it chose differently.

And the faults a run can have, each planted in the plan results the
store commits: the plan committed as if nothing was placed (the state
left unchanged), half of the placements left out, and every placement
of a plan moved onto its first node (an answer altered where it is
produced); and one planted in the solve (SOLVE_FAULTS): the scan's
spread term dropped.
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

    def first_fit(fn):
        def run(cap, used, ask, count, feasible, *rest, **kw):
            import torch
            out = fn(cap, used, ask, count, feasible, *rest, **kw)
            placed = _first_fit(*(_host(x) for x in (cap, used, ask)),
                                count, _host(feasible))
            dev = out.device if hasattr(out, "device") else "cpu"
            return torch.from_numpy(placed).to(dev)
        return run

    def first_fit_scan(fn):
        """The scan's answer (placed, used, spread counts, distinct
        quotas) with its placements and usage those of the first fit,
        on top of the placements it carried in."""
        def run(cap, used, ask, count, feasible, *rest, finish=None, **kw):
            import torch
            out = fn(cap, used, ask, count, feasible, *rest,
                     finish=lambda o: o, **kw)
            placed = _first_fit(*(_host(x) for x in (cap, used, ask)),
                                count, _host(feasible))
            add = torch.from_numpy(placed).to(out[0].device)
            new = (rest[10] + add, used + add[:, None].to(used.dtype) * ask,
                   *out[2:])
            return finish(new) if finish is not None else \
                backend.to_host(new)
        return run

    def select(kernel, *a, **kw):
        name, fn = orig_select(kernel, *a, **kw)
        wrap = {"depth": first_fit, "chunked": first_fit_scan}.get(kernel)
        return name, (fn if wrap is None else wrap(fn))
    placer.SolverPlacer._dispatch = dispatch
    backend.select = select

    def undo():
        placer.SolverPlacer._dispatch = orig_dispatch
        backend.select = orig_select
    return undo


def no_spread_solve(run):
    """Plant a fault in the program's scan, installed as first_fit_solve
    is: every spread stanza it is given marked as padding, so it scores
    binpack and anti-affinity alone. Returns what undoes it."""
    from nomad_tpu_torch.solver import backend
    orig_select = backend.select

    def select(kernel, *a, **kw):
        name, fn = orig_select(kernel, *a, **kw)
        if kernel != "chunked":
            return name, fn

        def run(*args, **kw2):
            args = list(args)
            mode = args[10]                 # sp_mode: -1 is a pad stanza
            args[10] = mode.new_full(mode.shape, -1) \
                if hasattr(mode, "new_full") else np.full_like(mode, -1)
            return fn(*args, **kw2)
        return name, run
    backend.select = select

    def undo():
        backend.select = orig_select
    return undo


SOLVE_FAULTS = {"no_spread": no_spread_solve}
