"""Placement kernels' plain PyTorch versions and the torch tails: the
BinPackIterator hot loop (ref scheduler/rank.go:193-527) and
ScoreFitBinPack/Spread (ref nomad/structs/funcs.go:236,263) as dense
batched tensor programs over the node axis.

Counterpart of nomad_tpu/solver/kernels.py (main-path subset). Two
placement paths:
  * fill-greedy (binpack): exact equivalence to sequential greedy
    placement via one sort + cumsum — the binpack score increases with
    utilization, so greedy fills the currently-best node to capacity
    before moving on.
  * depth: the density-greedy solve over the per-node [N, K] score curve
    (fill_depth below).

Each hand kernel in cuda_kernels.py computes what one producer here
computes: `depth_curve_ref` for the depth-curve kernel and
`score_capacity_ref` for the score/capacity kernel. The tails
(`_depth_order_take`, `_greedy_take`) run as torch ops on whichever
device the inputs lie on.

Numerics follow the reference on purpose:
  * every sort is stable (`jnp.argsort` is; `torch.argsort` is only when
    asked), so the shuffled node order breaks score ties;
  * 10**x is evaluated in float64 and rounded to float32, which agrees
    with XLA's float32 power far more often than torch's float32 pow;
  * prefix sums over the depth axis run left to right in float32, the
    order the hand kernel uses too;
  * integer prefix sums stay int32, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

# extended resource axis layout — single-sourced from the state-side usage
# index so the incrementally-maintained matrices and the kernels agree
from ..state.usage_index import (       # noqa: F401  (re-exported)
    NUM_XR, XR_CPU, XR_DISK, XR_MBITS, XR_MEM, XR_PORTS,
)

BINPACK_MAX_SCORE = 18.0
MAX_PER_NODE_CAP = 2 ** 30
# per-dimension capacity where the ask is 0 (the dimension never binds);
# the hand kernels use the same finite stand-in for +inf
_BIG = 1e9

# geometric depth grid for the sampled curve: exact at shallow depths
# (the jittered regime's take is capped at ceil(m)+1 <= 4) and
# log-spaced above, so full-depth density RANKING survives at ~1/8 the
# [N, K] work.
DEPTH_GRID = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192,
              256, 384, 512)

# the plan-evaluate fit tolerance — equals plan_apply._FIT_EPS: the
# verdict is the literal compare the applier's vectorized AllocsFit runs
FIT_EPS = 1e-3


def _pow10(x: torch.Tensor) -> torch.Tensor:
    """10**x for f32 `x`, computed in f64 and rounded to f32."""
    return torch.pow(10.0, x.to(torch.float64)).to(torch.float32)


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right f32 prefix sum along axis 1 of [N, K] (the hand
    kernel's running sum; torch.cumsum accumulates in another order)."""
    out = torch.empty_like(x)
    if x.shape[1] == 0:
        return out
    acc = x[:, 0]
    out[:, 0] = acc
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
        out[:, k] = acc
    return out


def score_fit(cap: torch.Tensor, used: torch.Tensor,
              spread: bool = False) -> torch.Tensor:
    """Vectorized ScoreFitBinPack/Spread over [N, R'] (funcs.go:236,263).

    cap/used: f32[N, R'] — only the cpu and mem columns participate.
    Returns f32[N] in [0, 18]."""
    safe_cap = torch.where(cap[:, :2] > 0, cap[:, :2], 1.0)
    free_pct = 1.0 - used[:, :2] / safe_cap
    p = _pow10(free_pct)
    total = p[:, 0] + p[:, 1]
    score = total - 2.0 if spread else 20.0 - total
    return score.clamp(0.0, BINPACK_MAX_SCORE)


def instance_capacity(cap: torch.Tensor, used: torch.Tensor,
                      ask: torch.Tensor,
                      feasible: torch.Tensor) -> torch.Tensor:
    """How many instances of `ask` fit on each node: the dense AllocsFit
    (funcs.go:147). i32[N]."""
    free = cap - used
    ask_pos = ask > 0
    per_dim = torch.where(ask_pos[None, :],
                          torch.floor(free / torch.where(ask_pos, ask,
                                                         1.0)[None, :]),
                          _BIG)
    capacity = per_dim.min(dim=1).values
    capacity = torch.where(feasible, capacity, 0.0)
    return capacity.clamp(min=0.0).to(torch.int32)


def score_capacity_ref(cap: torch.Tensor, used: torch.Tensor,
                       ask: torch.Tensor, feasible: torch.Tensor,
                       spread: bool = False) -> tuple:
    """Plain version of the score/capacity kernel: (capacity i32[N],
    score f32[N]). The score is taken WITH the candidate instance placed
    (rank.go:479) and is -1 where nothing fits."""
    capacity = instance_capacity(cap, used, ask, feasible)
    score = score_fit(cap, used + ask[None, :], spread=spread)
    score = torch.where(capacity > 0, score, -1.0)
    return capacity, score


def _greedy_key(capacity: torch.Tensor, score: torch.Tensor,
                max_per_node) -> tuple:
    """Greedy tail, key step: (capacity clamped to max_per_node, sort key
    f32[N]) — the key is -score where the clamped capacity is > 0, else
    1.0. The score/capacity kernel's greedy entry computes the same."""
    capacity = torch.clamp(capacity, max=int(max_per_node))
    score = torch.where(capacity > 0, score, -1.0)
    return capacity, -score


def _greedy_fill(capacity: torch.Tensor, key: torch.Tensor,
                 count) -> torch.Tensor:
    """Greedy tail, take step: smallest key (best score) first, each node
    to its capacity. One stable sort + cumsum. i32[N] instances per
    node."""
    order = torch.argsort(key, stable=True)                 # best first
    cap_sorted = capacity[order]
    prior = torch.cumsum(cap_sorted, 0, dtype=torch.int32) - cap_sorted
    take = torch.minimum((int(count) - prior).clamp(min=0), cap_sorted)
    placed = torch.zeros_like(capacity)
    placed[order] = take
    return placed


def _greedy_take(capacity: torch.Tensor, score: torch.Tensor, count,
                 max_per_node) -> torch.Tensor:
    """Greedy fill tail: best score first, each node to its capacity.
    i32[N] instances per node."""
    return _greedy_fill(*_greedy_key(capacity, score, max_per_node), count)


def fill_greedy_binpack(cap: torch.Tensor, used: torch.Tensor,
                        ask: torch.Tensor, count, feasible: torch.Tensor,
                        max_per_node=MAX_PER_NODE_CAP) -> torch.Tensor:
    """Exact sequential-greedy binpack placement of `count` identical
    instances (ref kernels.fill_greedy_binpack). Returns i32[N]."""
    capacity, score = score_capacity_ref(cap, used, ask, feasible)
    return _greedy_take(capacity, score, count, max_per_node)


def _depth_axis(k_max: int, depth_grid: Optional[tuple], device
               ) -> torch.Tensor:
    """The depths the curve is evaluated at: 1..k_max, or the grid."""
    if depth_grid is not None:
        return torch.tensor(depth_grid, dtype=torch.float32, device=device)
    return torch.arange(1, k_max + 1, dtype=torch.float32, device=device)


def depth_density(cap: torch.Tensor, used: torch.Tensor,
                  ask: torch.Tensor, feasible: torch.Tensor,
                  job_collisions: torch.Tensor, desired_count,
                  affinity_boost: torch.Tensor,
                  max_per_node=MAX_PER_NODE_CAP, k_max: int = 128,
                  spread_algorithm: bool = False,
                  depth_grid: Optional[tuple] = None) -> tuple:
    """The per-node density curve F(k)/k over the depth axis:
    -> (density f32[N, K] (-inf where depth k does not fit), depths
    f32[K], capacity f32[N]).

    The score model is the reference fill_depth's: binpack/spread base
    score WITH the j-th instance placed, job anti-affinity (rank.go:536)
    and affinity boost, averaged over the components present
    (rank.go:737). Dense mode prefix-sums every depth 1..k_max; grid mode
    samples DEPTH_GRID and integrates across the gaps by trapezoids."""
    j = _depth_axis(k_max, depth_grid, cap.device)
    mpn = float(min(int(max_per_node), MAX_PER_NODE_CAP))
    # depth feasibility without the [N, K, R'] tensor: resources are
    # linear in depth, so "k instances fit" == k <= instance capacity
    ask_pos = ask > 0
    free = cap - used
    per_dim = torch.where(ask_pos[None, :],
                          torch.floor((free + 1e-6) /
                                      torch.where(ask_pos, ask,
                                                  1.0)[None, :]),
                          _BIG)
    capacity = per_dim.min(dim=1).values.clamp(min=0.0)        # [N]
    fits = (j[None, :] <= capacity[:, None]) & feasible[:, None] & \
        (j[None, :] <= mpn)                                    # [N, K]

    safe_cap = torch.where(cap[:, :2] > 0, cap[:, :2], 1.0)    # [N, 2]
    used_j2 = used[:, None, :2] + j[None, :, None] * ask[None, None, :2]
    free_pct = 1.0 - used_j2 / safe_cap[:, None, :]            # [N, K, 2]
    p = _pow10(free_pct)
    tot = p[..., 0] + p[..., 1]                                # [N, K]
    raw = tot - 2.0 if spread_algorithm else 20.0 - tot
    base = raw.clamp(0.0, BINPACK_MAX_SCORE) / BINPACK_MAX_SCORE

    coll_before = job_collisions[:, None].to(torch.float32) + \
        (j[None, :] - 1.0)                                     # [N, K]
    desired = float(max(int(desired_count), 1))
    anti = -(coll_before + 1.0) / desired
    anti_on = coll_before > 0
    aff_on = (affinity_boost != 0.0)[:, None]
    s = (base + torch.where(anti_on, anti, 0.0)
         + torch.where(aff_on, affinity_boost[:, None], 0.0)) / \
        (1.0 + anti_on.to(torch.float32) + aff_on.to(torch.float32))
    sz = torch.where(fits, s, 0.0)
    if depth_grid is not None:
        # trapezoid prefix: F(g_t) = F(g_0) + sum of gap * mean(endpoints)
        gaps = j[1:] - j[:-1]
        trap = (sz[:, 1:] + sz[:, :-1]) * 0.5 * gaps[None, :]
        F = torch.cat([sz[:, :1], sz[:, :1] + _prefix_sum(trap)], dim=1)
    else:
        F = _prefix_sum(sz)
    F = torch.where(fits, F, -math.inf)
    return F / j[None, :], j, capacity


def depth_curve_ref(cap: torch.Tensor, used: torch.Tensor,
                    ask: torch.Tensor, feasible: torch.Tensor,
                    job_collisions: torch.Tensor, desired_count,
                    affinity_boost: torch.Tensor,
                    max_per_node=MAX_PER_NODE_CAP, k_max: int = 128,
                    spread_algorithm: bool = False,
                    depth_grid: Optional[tuple] = None) -> tuple:
    """Plain version of the depth-curve kernel: per node, the best
    density d_star = max_k F(k)/k (-inf where no depth fits), the depth
    k_star at its first argmax and the exact capacity k_cap =
    min(capacity, max_per_node) (0 where infeasible).
    -> (d_star f32[N], k_star i32[N], k_cap i32[N])."""
    density, j, capacity = depth_density(
        cap, used, ask, feasible, job_collisions, desired_count,
        affinity_boost, max_per_node=max_per_node, k_max=k_max,
        spread_algorithm=spread_algorithm, depth_grid=depth_grid)
    mpn = float(min(int(max_per_node), MAX_PER_NODE_CAP))
    d_star = density.max(dim=1).values
    k_star = j[density.argmax(dim=1)].to(torch.int32)          # first max
    k_cap = torch.where(feasible, torch.clamp(capacity, max=mpn),
                        0.0).to(torch.int32)
    return d_star, k_star, k_cap


def _depth_order_take(d_star: torch.Tensor, k_star: torch.Tensor,
                      k_cap: torch.Tensor, count,
                      order_jitter: Optional[torch.Tensor],
                      jitter_scale, jitter_samples) -> torch.Tensor:
    """Shared tail of the depth solver (ref kernels._depth_order_take):
    Efraimidis-Spirakis ordering over the full-depth density ranking,
    depth take, and leftover deepening to exact capacity, best density
    first. jitter_samples <= 0 selects the deterministic regime (no
    gumbel noise, depth uncapped); otherwise the take per node is capped
    at ceil(jitter_samples) + 1, the host stack's resurfacing bound."""
    n = d_star.shape[0]
    dev = d_star.device
    js = float(np.float32(jitter_samples))
    det = js <= 0.0
    jcap = MAX_PER_NODE_CAP if det else int(math.ceil(js)) + 1
    k_star = torch.clamp(k_star, max=max(jcap, 1))
    fin = torch.isfinite(d_star)
    k_star = torch.where(fin, k_star, 0)
    rank = torch.argsort(torch.argsort(-d_star, stable=True), stable=True)
    n_fin = torch.clamp(fin.sum(dtype=torch.int32), min=1)
    # E-S order in LOG space: argmax u^(1/w) == argmin
    # log(-log u) - g*log(2(n-r)+1); w itself overflows f32 at scale
    base_w = 2.0 * (n_fin - rank).to(torch.float32) + 1.0
    if order_jitter is None:
        order_jitter = torch.full((n,), 0.5, dtype=torch.float32,
                                  device=dev)
    u = torch.clamp(order_jitter, 1e-9, 1.0 - 1e-9)
    if det:
        gumbel = torch.zeros((n,), dtype=torch.float32, device=dev)
    else:
        gumbel = torch.log(-torch.log(u))
    scale = torch.full((), float(np.float32(jitter_scale)), dtype=torch.float32,
                       device=dev)
    key = gumbel - scale * torch.log(base_w)
    key = torch.where(fin, key, math.inf)
    order = torch.argsort(key, stable=True)           # smaller = earlier
    count = int(count)
    ks = k_star[order]
    prior = torch.cumsum(ks, 0, dtype=torch.int32) - ks
    take = torch.minimum((count - prior).clamp(min=0), ks)
    placed = torch.zeros((n,), dtype=torch.int32, device=dev)
    placed[order] = take

    # leftover beyond sum(k_star): deepen already-filled nodes to their
    # feasible max, best density first
    leftover = count - placed.sum(dtype=torch.int32)
    room = torch.where(take > 0, k_cap[order] - take, 0)
    prior_r = torch.cumsum(room, 0, dtype=torch.int32) - room
    extra = torch.minimum((leftover - prior_r).clamp(min=0), room)
    placed[order] += extra.to(torch.int32)
    return placed


def fill_depth(cap: torch.Tensor, used: torch.Tensor, ask: torch.Tensor,
               count, feasible: torch.Tensor,
               job_collisions: torch.Tensor, desired_count,
               affinity_boost: torch.Tensor,
               max_per_node=MAX_PER_NODE_CAP, k_max: int = 128,
               spread_algorithm: bool = False,
               order_jitter: Optional[torch.Tensor] = None,
               jitter_scale=0.5, jitter_samples=0.0,
               depth_grid: Optional[tuple] = None) -> torch.Tensor:
    """Depth-optimal placement of identical instances under the full
    binpack + job-anti-affinity + affinity score model (ref
    kernels.fill_depth): per-node depth curve, then density-greedy fill
    in E-S order. Returns i32[N] placements per node."""
    d_star, k_star, k_cap = depth_curve_ref(
        cap, used, ask, feasible, job_collisions, desired_count,
        affinity_boost, max_per_node=max_per_node, k_max=k_max,
        spread_algorithm=spread_algorithm, depth_grid=depth_grid)
    return _depth_order_take(d_star, k_star, k_cap, count, order_jitter,
                             jitter_scale, jitter_samples)


def plan_fit_verdict(cap: torch.Tensor, used: torch.Tensor,
                     ask: torch.Tensor, placed: torch.Tensor
                     ) -> torch.Tensor:
    """The plan-evaluate feasibility verdict at solve-snapshot state:
    bool[N], True where the node still fits its placements post-solve —
    the `used + k·ask <= cap + eps` compare the applier's dense vector
    pass runs (plan_apply._vector_pass)."""
    post = used + placed[:, None].to(torch.float32) * ask[None, :]
    return torch.all(post <= cap + FIT_EPS, dim=1)
