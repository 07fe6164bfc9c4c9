"""The convex placement tier's plain PyTorch version: the whole eval's
allocation as one projected-gradient solve over the node axis
(counterpart of nomad_tpu/solver/convex.py, less its in-program explain
reduce: the placer reduces every solve on the host).

  1. gather the eval's rows from the state cache's twins (gather_rows);
  2. relax placement to x in R^N with box 0 <= x_i <= u_i (u = the dense
     AllocsFit instance capacity, capped at max_per_node) and budget
     sum(x) = min(count, quota_budget, sum(u));
  3. minimize f(x) = <cost, x> + (curv/2)|x|^2 + (w_f/2)|coll + x|^2,
     cost = the binpack/spread preference as a [0, 1] cost less the
     affinity boost, coll = the same-job collision counts;
  4. project each iterate onto the capped simplex by bisecting the
     water-filling threshold (PROJECT_ITERS halvings);
  5. round: floor, then the remaining budget to the largest fractional
     parts, never above u_i;
  6. compare the rounded placement with the greedy fill of the same
     budget on f, and emit the better.

Steps 1-4 are `convex_solve_ref`, the plain version of the hand kernel
csrc/convex_solve.cu (cuda_kernels.convex_solve): the iteration runs as a
Python loop over torch ops here, in one launch there. Steps 5-6 are
torch ops on whichever device the inputs lie on (`finish`).

Numerics follow the reference's compiled program on XLA's CPU backend,
read from its dump, where it matters for the placement:
  * XLA contracts the gradient step into three fused multiply-adds, the
    cost into one, the objective's scalar tail into two and the fit
    verdict's `used + k * ask` into one (kernels._fma_f32 here,
    __fmaf_rn in the kernel), folds the division by 18 into a multiply
    by float32(1/18) and reassociates the step size's constant,
    1 / (w_f + float32(curv + 1e-6));
  * the fractional parts sort stably with -0.0 read as +0.0, as jnp's
    sort canonicalizes;
  * every float sum over the node axis takes ONE fixed order, that of
    the kernel's cluster reduction (tree_sum), so the kernel and this
    version agree bit for bit on every iterate, the iteration count and
    the gap. XLA sums in another order: the gap differs from the
    reference's in its last bits, and the iteration count can only
    differ where the tolerance lies below float32 noise.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernels import (
    BINPACK_MAX_SCORE, FIT_EPS, _INV_MAX_SCORE, _fma_f32,
    fill_greedy_binpack, gather_rows, instance_capacity, score_fit,
)

# per-unit curvature of the fragmentation term: small for binpack (the
# linear cost dominates), larger for spread (the quadratic disperses)
CURV_BINPACK = 0.05
CURV_SPREAD = 1.0

# water-filling bisection depth: 50 halvings of a float32 bracket
PROJECT_ITERS = 50

# the kernel's reduction layout (csrc/convex_solve.cu): a cluster of
# SUM_CTAS blocks of SUM_WARPS warps of 32 lanes, one partial sum a thread
SUM_CTAS = 8
SUM_WARPS = 32
SUM_THREADS = SUM_CTAS * SUM_WARPS * 32


def curvature(spread: bool) -> float:
    return CURV_SPREAD if spread else CURV_BINPACK


def step_offset(spread: bool) -> float:
    """float32(curv + 1e-6): XLA evaluates the reference's step
    1 / (curv + w_f + 1e-6) as 1 / (w_f + this constant)."""
    return float(np.float32(curvature(spread)) + np.float32(1e-6))


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """The float32 sum over the last axis of `v` in the kernel's order ->
    v.shape[:-1]. Element i belongs to thread i mod SUM_THREADS, which
    adds its elements in index order; then the thread partials combine
    pairwise by halving, first across the 32 lanes of a warp (lane l + 16
    into l, then + 8, ...), then across the warps of a block, then across
    the blocks. Every add is one float32 rounding, the same on any
    device; leading axes are independent sums."""
    pad = (-v.shape[-1]) % SUM_THREADS
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    rows = v.reshape(*v.shape[:-1], -1, SUM_THREADS)
    acc = rows[..., 0, :]
    for r in range(1, rows.shape[-2]):
        acc = acc + rows[..., r, :]
    t = acc.reshape(*acc.shape[:-1], SUM_CTAS, SUM_WARPS, 32)
    for dim in (-1, -2, -3):
        while t.shape[dim] > 1:
            h = t.shape[dim] // 2
            t = t.narrow(dim, 0, h) + t.narrow(dim, h, h)
    return t.reshape(v.shape[:-1])


def _objective(x: torch.Tensor, cost: torch.Tensor, curv: float,
               coll: torch.Tensor, fairness_weight: torch.Tensor
               ) -> torch.Tensor:
    """f(x) = <cost, x> + (curv/2)|x|^2 + (w_f/2)|coll + x|^2 over the
    last axis of x (leading axes: independent placements): the formula
    the solve minimizes and the rounded candidates are compared by, with
    XLA's two contracted multiply-adds in its tail."""
    f32 = dict(dtype=torch.float32, device=x.device)
    t = coll + x
    cx, xx, ff = tree_sum(torch.stack((cost * x, x * x, t * t))).unbind(0)
    frag = _fma_f32(xx, torch.tensor(np.float32(0.5) * np.float32(curv),
                                     **f32), cx)
    half_w = fairness_weight * torch.tensor(0.5, **f32)
    return _fma_f32(half_w, ff, frag)


def _projection_bracket(y: torch.Tensor, u: torch.Tensor,
                        budget: torch.Tensor) -> torch.Tensor:
    """Project y onto {x : 0 <= x <= u, sum(x) = budget}: x_i =
    clip(y_i - tau, 0, u_i), tau bisected PROJECT_ITERS times (the sum
    decreases in tau)."""
    one = torch.tensor(1.0, dtype=torch.float32, device=y.device)
    half = torch.tensor(0.5, dtype=torch.float32, device=y.device)
    zero = torch.zeros((), dtype=torch.float32, device=y.device)
    lo = torch.min(y - u) - one
    hi = torch.max(y) + one
    for _ in range(PROJECT_ITERS):
        mid = half * (lo + hi)
        s = tree_sum(torch.minimum(torch.maximum(y - mid, zero), u))
        too_big = s > budget
        lo = torch.where(too_big, mid, lo)
        hi = torch.where(too_big, hi, mid)
    tau = half * (lo + hi)
    return torch.minimum(torch.maximum(y - tau, zero), u)


def convex_inputs(cap, used, ask, feasible, job_collisions, affinity_boost,
                  max_per_node, spread_algorithm: bool) -> tuple:
    """Per node: u_int i32 (instance capacity capped at max_per_node),
    cost f32 and coll f32, as the reference computes them."""
    u_int = torch.clamp(instance_capacity(cap, used, ask, feasible),
                        max=int(max_per_node))
    pref = score_fit(cap, used + ask[None, :], spread=spread_algorithm)
    max_score = torch.tensor(BINPACK_MAX_SCORE, dtype=torch.float32,
                             device=cap.device)
    inv = torch.tensor(_INV_MAX_SCORE, dtype=torch.float32,
                       device=cap.device)
    cost = _fma_f32(max_score - pref, inv, -affinity_boost)
    return u_int, cost, job_collisions.to(torch.float32)


def convex_solve_ref(cap, used, ask, feasible, job_collisions,
                     affinity_boost, count, max_per_node, max_iters,
                     tolerance, fairness_weight, quota_budget,
                     spread_algorithm: bool = False) -> tuple:
    """Plain version of the convex-solve kernel: the budget, the
    projected-gradient iteration and its stopping rule (ref convex.py
    :141-184). -> (x f32[N] the final iterate, u_int i32[N], cost f32[N],
    budget_int i32 0-dim, iterations i32 0-dim, gap f32 0-dim)."""
    dev = cap.device
    f32 = dict(dtype=torch.float32, device=dev)
    u_int, cost, coll = convex_inputs(cap, used, ask, feasible,
                                      job_collisions, affinity_boost,
                                      max_per_node, spread_algorithm)
    u = u_int.to(torch.float32)
    curv = curvature(spread_algorithm)
    w_f = torch.tensor(np.float32(fairness_weight), **f32)
    sum_u = tree_sum(u)
    budget = torch.minimum(torch.minimum(
        torch.tensor(np.float32(np.int32(count)), **f32),
        torch.tensor(np.float32(quota_budget), **f32)), sum_u)
    budget = torch.clamp(budget, min=0.0)
    budget_int = budget.to(torch.int32)
    step = torch.tensor(1.0, **f32) / (
        w_f + torch.tensor(step_offset(spread_algorithm), **f32))
    curv_t = torch.tensor(curv, **f32)
    x = u * (budget / torch.clamp(sum_u, min=1.0))
    tol = float(np.float32(tolerance))
    it, gap = 0, float("inf")
    one = torch.tensor(1.0, **f32)
    while it < int(max_iters) and gap > tol:
        g = _fma_f32(coll + x, w_f, _fma_f32(x, curv_t, cost))
        x2 = _projection_bracket(_fma_f32(-step, g, x), u, budget)
        f_old, f_new = _objective(torch.stack((x, x2)), cost, curv, coll,
                                  w_f).unbind(0)
        gap = float(torch.abs(f_old - f_new) / (one + torch.abs(f_new)))
        x = x2
        it += 1
    return (x, u_int, cost, budget_int,
            torch.tensor(it, dtype=torch.int32, device=dev),
            torch.tensor(gap, **f32))


def _round_to_budget(x: torch.Tensor, u_int: torch.Tensor,
                     budget_int: torch.Tensor) -> torch.Tensor:
    """Fractional iterate -> integral placement: floor, then the rest of
    the budget to the largest fractional parts (ties by node index),
    never above a node's u_int."""
    base = torch.minimum(torch.floor(x).to(torch.int32), u_int)
    rem = torch.clamp(budget_int - base.sum(dtype=torch.int32), min=0)
    open_ = base < u_int
    frac = torch.where(open_, x - base.to(torch.float32), -1.0)
    # 0 - frac, not -frac: a +0.0 fraction must not sort as -0.0
    order = torch.argsort(0.0 - frac, stable=True)
    eligible = open_[order] & (frac[order] >= 0.0)
    take = eligible & (torch.cumsum(eligible.to(torch.int32), 0,
                                    dtype=torch.int32) <= rem)
    placed = torch.empty_like(base)
    placed[order] = base[order] + take.to(torch.int32)
    return placed


def _fit_verdict(cap, used, ask, placed) -> torch.Tensor:
    """kernels.plan_fit_verdict as the reference's convex program
    compiles it: `used + k * ask` is one fused multiply-add there."""
    post = _fma_f32(placed[:, None].to(torch.float32), ask[None, :], used)
    return torch.all(post <= cap + FIT_EPS, dim=1)


def finish(cap, used, ask, feasible, job_collisions, max_per_node, solved,
           fairness_weight, spread_algorithm: bool, greedy=None) -> tuple:
    """Steps 5-6 on the solve's device, no host sync: round the final
    iterate, check it, fill greedily on the same budget (`greedy`, the
    fill_greedy_binpack signature; the plain one by default) and keep the
    better. -> the reference's (placed i32[N], fit bool[N], iterations,
    objective_gap, convex_won)."""
    x, u_int, cost, budget_int, iters, gap = solved
    greedy = fill_greedy_binpack if greedy is None else greedy
    coll = job_collisions.to(torch.float32)
    curv = curvature(spread_algorithm)
    w_f = torch.tensor(np.float32(fairness_weight), dtype=torch.float32,
                       device=x.device)
    placed_cvx = _round_to_budget(x, u_int, budget_int)
    fit_cvx = _fit_verdict(cap, used, ask, placed_cvx)
    placed_greedy = greedy(cap, used, ask, budget_int, feasible,
                           max_per_node)
    obj_cvx, obj_greedy = _objective(
        torch.stack((placed_cvx, placed_greedy)).to(torch.float32), cost,
        curv, coll, w_f).unbind(0)
    won = (fit_cvx.all() & (obj_cvx <= obj_greedy + 1e-6)
           & (placed_cvx.sum() >= placed_greedy.sum()))
    placed = torch.where(won, placed_cvx, placed_greedy)
    return (placed, _fit_verdict(cap, used, ask, placed), iters, gap, won)


def convex_eval(cap_res, used_res, idx, valid, ask, count, feasible,
                max_per_node, affinity_boost, job_collisions, class_ids,
                distinct_hosts, max_iters, tolerance, fairness_weight,
                quota_budget, spread_algorithm: bool = False,
                n_classes: int = 0, solve=None, greedy=None) -> tuple:
    """The whole convex eval on tensors, the reference's signature:
    gather, solve (`solve`, convex_solve_ref's signature; the plain
    version by default), round, verdict, greedy baseline, selection.
    -> (placed i32[B], fit bool[B], iterations i32, objective_gap f32,
    convex_won bool), all on the inputs' device. `class_ids`,
    `distinct_hosts` and `n_classes` feed the reference's in-program
    explain reduce; here explain runs on the host over the placement
    (explain.dispatch_reduce), so they must describe no classes."""
    if n_classes:
        raise ValueError("convex_eval reduces no explain classes: the "
                         "placer explains on the host")
    del class_ids, distinct_hosts
    solve = convex_solve_ref if solve is None else solve
    cap, used = gather_rows(cap_res, used_res, idx, valid)
    solved = solve(cap, used, ask, feasible, job_collisions,
                   affinity_boost, count, max_per_node, max_iters,
                   tolerance, fairness_weight, quota_budget,
                   spread_algorithm=spread_algorithm)
    return finish(cap, used, ask, feasible, job_collisions, max_per_node,
                  solved, fairness_weight, spread_algorithm, greedy=greedy)


def to_host(out: tuple) -> tuple:
    """convex_eval's outputs as numpy through ONE device-to-host copy:
    (placed i32[B], fit bool[B], iterations int, gap float32, won bool)."""
    placed, fit, iters, gap, won = out
    buf = torch.cat((placed.to(torch.int32), fit.to(torch.int32),
                     iters.to(torch.int32).reshape(1),
                     gap.to(torch.float32).reshape(1).view(torch.int32),
                     won.to(torch.int32).reshape(1))).cpu().numpy()
    b = placed.shape[0]
    return (buf[:b], buf[b:2 * b].astype(bool), int(buf[2 * b]),
            buf[2 * b + 1:2 * b + 2].view(np.float32)[0],
            bool(buf[2 * b + 2]))


def placement_objective(cap, used, ask, placed, job_collisions=None,
                        spread: bool = False,
                        fairness_weight: float = 0.0) -> dict:
    """The convex objective of an INTEGRAL placement on the host (the
    oracle tests and scripts compare greedy with convex by). Returns
    {"total", "fragmentation", "fairness"} as floats."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    x = t(placed)
    cap, used, ask = t(cap), t(used), t(ask)
    pref = score_fit(cap, used + ask[None, :], spread=spread)
    cost = (torch.tensor(BINPACK_MAX_SCORE) - pref) / \
        torch.tensor(BINPACK_MAX_SCORE)
    curv = torch.tensor(curvature(spread), dtype=torch.float32)
    coll = torch.zeros_like(x) if job_collisions is None \
        else t(job_collisions)
    frag = float(tree_sum(cost * x) + 0.5 * curv * tree_sum(x * x))
    fair = float(torch.tensor(np.float32(0.5) * np.float32(fairness_weight))
                 * tree_sum((coll + x) ** 2))
    return {"total": frag + fair, "fragmentation": frag, "fairness": fair}
