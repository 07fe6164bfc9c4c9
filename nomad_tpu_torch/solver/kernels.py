"""Placement kernels' plain PyTorch versions and the torch tails: the
BinPackIterator hot loop (ref scheduler/rank.go:193-527) and
ScoreFitBinPack/Spread (ref nomad/structs/funcs.go:236,263) as dense
batched tensor programs over the node axis.

Counterpart of nomad_tpu/solver/kernels.py. Three placement paths, the
whole-eval programs and the preemption pass:
  * fill-greedy (binpack): exact equivalence to sequential greedy
    placement via one sort + cumsum — the binpack score increases with
    utilization, so greedy fills the currently-best node to capacity
    before moving on.
  * depth: the density-greedy solve over the per-node [N, K] score curve
    (fill_depth below).
  * the chunked scan (place_chunked): the full interacting score model
    (spreads, distinct_property quotas, affinity, anti-affinity) with
    the running state carried step by step.
  * fill_depth_lanes: the depth solve over a lane axis, the eval-stream
    micro-batch window (one row a coalesced eval; each row equal to its
    solo fill_depth).
  * fused_eval_depth / fused_eval_greedy (and fused_eval_depth_lanes for
    a window): the whole eval on the device — gather from the state
    cache's resident twins, the depth or greedy solve, the plan-fit
    verdict (fused_fit_verdict) and optionally the explain reduce.
  * preempt_top_k: victim selection over every candidate node at once.
    It stays plain torch on the card too — one pass of a few dozen
    tensor operations per preemption eval, with no Pallas counterpart
    and no loop over the candidates.

Each hand kernel in cuda_kernels.py computes what one producer here
computes: `depth_curve_ref` for the depth-curve kernel (and
`depth_curve_lanes_ref` for its launch over a window's lanes),
`score_capacity_ref` for the score/capacity kernel,
`chunked_step_ref` for the chunked-step kernel and `fit_verdict_ref` for
the fit-verdict kernel; the gather entries of the depth-curve and
score/capacity kernels compute what these do on gather_rows' output. The tails
(`_depth_order_take`, `_greedy_take`, `_chunked_take` and the scan's
state update) run as torch ops on whichever device the inputs lie on.

Numerics follow the reference on purpose:
  * every sort is stable (`jnp.argsort` is; `torch.argsort` is only when
    asked), so the shuffled node order breaks score ties;
  * 10**x is evaluated in float64 and rounded to float32, which agrees
    with XLA's float32 power far more often than torch's float32 pow;
  * prefix sums over the depth axis run left to right in float32, the
    order the hand kernel uses too; over the victim axis in XLA's blocks
    of 16 (_xla_prefix_sum);
  * where XLA's CPU backend fuses a multiply and an add into one FMA in
    the reference's compiled program, the plain version rounds once too
    (_fma_f32);
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
from .device import device_program

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
    node. `count` is a host integer or a 0-dim int32 tensor on the
    solve device (the convex solve's budget), read there without a host
    sync."""
    order = torch.argsort(key, stable=True)                 # best first
    cap_sorted = capacity[order]
    prior = torch.cumsum(cap_sorted, 0, dtype=torch.int32) - cap_sorted
    if not isinstance(count, torch.Tensor):
        count = int(count)
    take = torch.minimum((count - prior).clamp(min=0), cap_sorted)
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


def _lane_values(values, dtype, dev):
    """Per-lane host scalars as an operand of the [L, N] tail: the one
    value itself when every lane has it (a solo solve, or a window of
    equal settings: no host-to-device copy), else an [L, 1] column on
    `dev`."""
    if all(v == values[0] for v in values):
        return values[0]
    return torch.tensor([[v] for v in values], dtype=dtype, device=dev)


def _depth_order_take(d_star: torch.Tensor, k_star: torch.Tensor,
                      k_cap: torch.Tensor, counts,
                      order_jitter: Optional[torch.Tensor],
                      jitter_scales, jitter_samples) -> torch.Tensor:
    """Shared tail of the depth solver (ref kernels._depth_order_take)
    over a lane axis: row l of each [L, N] input is one solve, with
    counts[l], jitter_scales[l] and jitter_samples[l] (sequences of L
    host scalars; None: 0.5 and 0.0 for every lane, the solo defaults);
    a solo solve is one lane (_depth_order_take_one). Efraimidis-Spirakis
    ordering over the full-depth density ranking, depth take, and
    leftover deepening to exact capacity, best density first.
    jitter_samples <= 0 selects the deterministic regime (no gumbel noise,
    depth uncapped); otherwise the take per node is capped at
    ceil(jitter_samples) + 1, the host stack's resurfacing bound. Row l
    of the result depends on row l alone: the sorts are stable along the
    row, the prefix sums are int32 (exact in any order) and the float
    operations elementwise."""
    dev = d_star.device
    n_lanes = d_star.shape[0]
    if jitter_scales is None:
        jitter_scales = [0.5] * n_lanes
    if jitter_samples is None:
        jitter_samples = [0.0] * n_lanes
    js = [float(np.float32(x)) for x in jitter_samples]
    det = [x <= 0.0 for x in js]
    jcap = [MAX_PER_NODE_CAP if d else int(math.ceil(x)) + 1
            for d, x in zip(det, js)]
    k_star = torch.clamp(k_star, max=_lane_values(
        [max(c, 1) for c in jcap], torch.int32, dev))
    fin = torch.isfinite(d_star)
    k_star = torch.where(fin, k_star, 0)
    rank = torch.argsort(torch.argsort(-d_star, dim=1, stable=True), dim=1,
                         stable=True)
    n_fin = torch.clamp(fin.sum(dim=1, dtype=torch.int32, keepdim=True),
                        min=1)
    # E-S order in LOG space: argmax u^(1/w) == argmin
    # log(-log u) - g*log(2(n-r)+1); w itself overflows f32 at scale
    base_w = 2.0 * (n_fin - rank).to(torch.float32) + 1.0
    if order_jitter is None:
        order_jitter = torch.full(d_star.shape, 0.5, dtype=torch.float32,
                                  device=dev)
    u = torch.clamp(order_jitter, 1e-9, 1.0 - 1e-9)
    det_l = _lane_values(det, torch.bool, dev)
    if det_l is True:
        gumbel = torch.zeros(d_star.shape, dtype=torch.float32, device=dev)
    elif det_l is False:
        gumbel = torch.log(-torch.log(u))
    else:
        gumbel = torch.where(det_l, 0.0, torch.log(-torch.log(u)))
    scale = _lane_values([float(np.float32(s)) for s in jitter_scales],
                         torch.float32, dev)
    if not isinstance(scale, torch.Tensor):
        scale = torch.full((), scale, dtype=torch.float32, device=dev)
    key = gumbel - scale * torch.log(base_w)
    key = torch.where(fin, key, math.inf)
    order = torch.argsort(key, dim=1, stable=True)    # smaller = earlier
    count = _lane_values([int(c) for c in counts], torch.int32, dev)
    ks = torch.gather(k_star, 1, order)
    prior = torch.cumsum(ks, 1, dtype=torch.int32) - ks
    take = torch.minimum((count - prior).clamp(min=0), ks)
    placed = torch.zeros(d_star.shape, dtype=torch.int32, device=dev)
    placed.scatter_(1, order, take)

    # leftover beyond sum(k_star): deepen already-filled nodes to their
    # feasible max, best density first
    leftover = count - placed.sum(dim=1, dtype=torch.int32, keepdim=True)
    room = torch.where(take > 0, torch.gather(k_cap, 1, order) - take, 0)
    prior_r = torch.cumsum(room, 1, dtype=torch.int32) - room
    extra = torch.minimum((leftover - prior_r).clamp(min=0), room)
    placed.scatter_add_(1, order, extra.to(torch.int32))
    return placed


def _depth_order_take_one(d_star, k_star, k_cap, count, order_jitter,
                          jitter_scale, jitter_samples) -> torch.Tensor:
    """The tail of one solo solve: _depth_order_take over one lane of
    [N] inputs. -> placed i32[N]."""
    return _depth_order_take(
        d_star[None], k_star[None], k_cap[None], (count,),
        None if order_jitter is None else order_jitter[None],
        (jitter_scale,), (jitter_samples,))[0]


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
    return _depth_order_take_one(d_star, k_star, k_cap, count, order_jitter,
                                 jitter_scale, jitter_samples)


def depth_curve_lanes_ref(cap, used, ask, feasible, job_collisions,
                          desired_counts, affinity_boost, max_per_node,
                          k_max: int = 128, spread_algorithm: bool = False,
                          depth_grid: Optional[tuple] = None) -> tuple:
    """Plain version of the depth-curve kernel over a window: lane l of
    the stacked inputs (cap/used [L, N, R'], ask [L, R'], the rest
    [L, N]; desired_counts and max_per_node L host scalars) through
    depth_curve_ref. -> (d_star f32[L, N], k_star i32[L, N],
    k_cap i32[L, N])."""
    rows = [depth_curve_ref(
        cap[lane], used[lane], ask[lane], feasible[lane],
        job_collisions[lane], desired_counts[lane], affinity_boost[lane],
        max_per_node=max_per_node[lane], k_max=k_max,
        spread_algorithm=spread_algorithm, depth_grid=depth_grid)
        for lane in range(cap.shape[0])]
    return tuple(torch.stack(col) for col in zip(*rows))


def fill_depth_lanes(cap, used, ask, counts, feasible, job_collisions,
                     desired_counts, affinity_boost, max_per_node,
                     order_jitter=None, jitter_scales=None,
                     jitter_samples=None, k_max: int = 128,
                     spread_algorithm: bool = False,
                     depth_grid: Optional[tuple] = None) -> torch.Tensor:
    """fill_depth over a lane axis — the eval-stream micro-batch window
    (ref microbatch.py `_batched_fn`, jit(vmap(fill_depth))): row l of
    the stacked inputs is one solve; -> placed i32[L, N], row l equal to
    fill_depth on lane l alone. The per-lane scalars (counts,
    desired_counts, max_per_node, jitter_scales, jitter_samples) are
    sequences of L host scalars; order_jitter is [L, N] or None."""
    d_star, k_star, k_cap = depth_curve_lanes_ref(
        cap, used, ask, feasible, job_collisions, desired_counts,
        affinity_boost, max_per_node, k_max=k_max,
        spread_algorithm=spread_algorithm, depth_grid=depth_grid)
    return _depth_order_take(d_star, k_star, k_cap, counts, order_jitter,
                             jitter_scales, jitter_samples)


def gather_rows(cap_res: torch.Tensor, used_res: torch.Tensor,
                idx: torch.Tensor, valid: torch.Tensor) -> tuple:
    """Rows `idx` of the state cache's bucket-padded twins in eval
    (shuffled) order, rows where `valid` is False zeroed, as the host
    np.pad path pads (ref kernels.gather_rows). Torch indexing on the
    twins' device: enqueued, no host sync."""
    m2 = valid[:, None]
    rows = idx.to(torch.int64)
    return (torch.where(m2, cap_res[rows], 0.0),
            torch.where(m2, used_res[rows], 0.0))


def gather_lanes(cap_res: torch.Tensor, used_res: torch.Tensor,
                 idx: torch.Tensor, valid: torch.Tensor) -> tuple:
    """gather_rows over a window's lanes: idx/valid [L, B] -> (cap, used)
    [L, B, R'], lane l the rows idx[l] of the one twin pair."""
    rows = [gather_rows(cap_res, used_res, idx[lane], valid[lane])
            for lane in range(idx.shape[0])]
    return (torch.stack([r[0] for r in rows]),
            torch.stack([r[1] for r in rows]))


def plan_fit_verdict(cap: torch.Tensor, used: torch.Tensor,
                     ask: torch.Tensor, placed: torch.Tensor
                     ) -> torch.Tensor:
    """The plan-evaluate feasibility verdict at solve-snapshot state:
    bool[N], True where the node still fits its placements post-solve —
    the `used + k·ask <= cap + eps` compare the applier's dense vector
    pass runs (plan_apply._vector_pass), rounded as the reference's
    eager function rounds it (a product, then a sum)."""
    post = used + placed[:, None].to(torch.float32) * ask[None, :]
    return torch.all(post <= cap + FIT_EPS, dim=1)


def fused_fit_verdict(cap: torch.Tensor, used: torch.Tensor,
                      ask: torch.Tensor, placed: torch.Tensor
                      ) -> torch.Tensor:
    """plan_fit_verdict as the reference's compiled whole-eval programs
    (fused and convex) compute it: XLA's CPU backend contracts
    `used + k * ask` into one fused multiply-add there, so the sum is
    rounded once (tests/test_torch_fused.py holds a seeded row where the
    two roundings disagree). Rows are [..., R']: a lane axis may lead."""
    post = _fma_f32(placed[..., None].to(torch.float32), ask[..., None, :],
                    used)
    return torch.all(post <= cap + FIT_EPS, dim=-1)


def fit_verdict_ref(cap_res: torch.Tensor, used_res: torch.Tensor,
                    idx: torch.Tensor, valid: torch.Tensor,
                    ask: torch.Tensor, placed: torch.Tensor) -> torch.Tensor:
    """Plain version of the fit-verdict kernel (csrc/fit_verdict.cu):
    fused_fit_verdict on rows `idx` of the resident twins (gather_rows).
    idx/valid/placed [B] with ask [R'], or [L, B] with ask [L, R'] for a
    window's lanes. -> bool of placed's shape."""
    gather = gather_rows if idx.dim() == 1 else gather_lanes
    cap, used = gather(cap_res, used_res, idx, valid)
    return fused_fit_verdict(cap, used, ask, placed)


def _fused_explain(cap, used, ask, feasible, job_collisions, placed,
                   class_ids, distinct_hosts, n_classes: int) -> tuple:
    """The whole-eval programs' explain tail: explain_reduce as the
    reference's compiled program rounds it (post-solve usage by one
    fused multiply-add), split into (counts, dim_exhausted,
    class_exhausted, class_dh)."""
    buf = explain_reduce(cap, used, ask, feasible, job_collisions, placed,
                         class_ids, bool(distinct_hosts),
                         n_classes=n_classes, contract=True)
    d = 6 + cap.shape[1]
    return (buf[:6], buf[6:d], buf[d:d + n_classes],
            buf[d + n_classes:d + 2 * n_classes])


@device_program
def fused_eval_depth(cap_res, used_res, idx, valid, ask, count, feasible,
                     job_collisions, desired_count, affinity_boost,
                     max_per_node, order_jitter, jitter_scale,
                     jitter_samples, class_ids, distinct_hosts,
                     k_max: int = 128, spread_algorithm: bool = False,
                     depth_grid: Optional[tuple] = None,
                     n_classes: int = 0) -> tuple:
    """The whole depth eval on the device (ref kernels.fused_eval_depth):
    gather the eval's rows from the resident twins, the depth solve
    (fill_depth), the plan-fit verdict (fused_fit_verdict) and, when
    `n_classes` > 0, the explain reduce. -> (placed i32[B], fit bool[B]
    [, counts, dim_exh, class_exh, class_dh]). The placer calls it with
    n_classes 0: it explains on the host (explain.dispatch_reduce)."""
    cap, used = gather_rows(cap_res, used_res, idx, valid)
    placed = fill_depth(cap, used, ask, count, feasible, job_collisions,
                        desired_count, affinity_boost,
                        max_per_node=max_per_node, k_max=k_max,
                        spread_algorithm=spread_algorithm,
                        order_jitter=order_jitter, jitter_scale=jitter_scale,
                        jitter_samples=jitter_samples, depth_grid=depth_grid)
    out = (placed, fused_fit_verdict(cap, used, ask, placed))
    if not n_classes:
        return out
    return out + _fused_explain(cap, used, ask, feasible, job_collisions,
                                placed, class_ids, distinct_hosts, n_classes)


@device_program
def fused_eval_greedy(cap_res, used_res, idx, valid, ask, count, feasible,
                      max_per_node, class_ids, distinct_hosts,
                      job_collisions, n_classes: int = 0) -> tuple:
    """fused_eval_depth's greedy sibling (ref kernels.fused_eval_greedy):
    gather, fill_greedy_binpack, verdict (+ explain). `job_collisions`
    feeds only the explain reduce."""
    cap, used = gather_rows(cap_res, used_res, idx, valid)
    placed = fill_greedy_binpack(cap, used, ask, count, feasible,
                                 max_per_node=max_per_node)
    out = (placed, fused_fit_verdict(cap, used, ask, placed))
    if not n_classes:
        return out
    return out + _fused_explain(cap, used, ask, feasible, job_collisions,
                                placed, class_ids, distinct_hosts, n_classes)


@device_program
def fused_eval_depth_lanes(cap_res, used_res, idx, valid, ask, counts,
                           feasible, job_collisions, desired_counts,
                           affinity_boost, max_per_node, order_jitter=None,
                           jitter_scales=None, jitter_samples=None,
                           k_max: int = 128, spread_algorithm: bool = False,
                           depth_grid: Optional[tuple] = None) -> tuple:
    """fused_eval_depth over a window's lanes (ref microbatch
    `_fused_fn`, jit(vmap(fused_eval_depth)) with the twins broadcast):
    one resident twin pair, the lanes' columns stacked ([L, B] idx,
    valid, feasible, job_collisions, affinity_boost, order_jitter;
    ask [L, R']; the scalars L host values). -> (placed i32[L, B],
    fit bool[L, B]), lane l equal to fused_eval_depth on lane l."""
    cap, used = gather_lanes(cap_res, used_res, idx, valid)
    placed = fill_depth_lanes(cap, used, ask, counts, feasible,
                              job_collisions, desired_counts, affinity_boost,
                              max_per_node, order_jitter=order_jitter,
                              jitter_scales=jitter_scales,
                              jitter_samples=jitter_samples, k_max=k_max,
                              spread_algorithm=spread_algorithm,
                              depth_grid=depth_grid)
    return placed, fused_fit_verdict(cap, used, ask, placed)


# ------------------------------------------------------ the chunked scan

# 1/18 rounded to float32: XLA folds the reference's `score / 18` into a
# multiply by this constant
_INV_MAX_SCORE = float(np.float32(1.0) / np.float32(BINPACK_MAX_SCORE))


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """float32 a*b + c rounded ONCE, as a fused multiply-add computes it.
    XLA's CPU backend contracts some of the reference's multiply-adds into
    FMAs; the plain versions reproduce them exactly on any device. The
    product of two float32s is exact in float64; the float64 sum is made
    round-to-odd (TwoSum gives its exact error), so rounding it to float32
    rounds the exact a*b + c once."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _even_spread_boost_vec(node_pc: torch.Tensor, pcounts: torch.Tensor,
                           valid_p: torch.Tensor) -> torch.Tensor:
    """Vectorized evenSpreadScoreBoost (ref spread.go:178) over the node
    axis, for one stanza. node_pc: i32[N] running count of each node's
    value; pcounts: i32[P] running counts; valid_p: bool[P] live
    columns. Integer quotients are taken in float32, as jnp's true
    division of int32 does."""
    min_c = torch.where(valid_p, pcounts, 2 ** 30).min()
    min_c = torch.where(valid_p.any(), min_c, 0)
    max_c = torch.where(valid_p, pcounts, 0).max()
    any_placed = max_c > 0
    at_min = node_pc == min_c
    div = torch.clamp(min_c, min=1).to(torch.float32)
    boost_nonmin = torch.where(min_c == 0, -1.0,
                               (min_c - node_pc).to(torch.float32) / div)
    boost_min = torch.where(min_c == max_c, -1.0,
                            torch.where(min_c == 0, 1.0,
                                        (max_c - min_c).to(torch.float32)
                                        / div))
    boost = torch.where(at_min, boost_min, boost_nonmin)
    return torch.where(any_placed, boost, 0.0)


def chunked_step_ref(cap, used, ask, feasible, job_collisions, placed,
                     max_per_node, desired_count, spread_ids, spread_counts,
                     spread_desired, spread_mode, spread_weights,
                     affinity_boost, distinct_ids, distinct_remaining,
                     d_active, spread_algorithm: bool = False
                     ) -> torch.Tensor:
    """Plain version of the chunked-step kernel: the score of one scan
    step of place_chunked over the node axis, f32[N], -inf where the node
    cannot take an instance now (capacity, max_per_node, a
    distinct_property quota spent or its value missing).

    Score components (mean of present, ref rank.go:737), in this order:
      base      ScoreFitBinPack/Spread with the candidate placed, times
                float32(1/18)
      anti      -(collisions+1)/desired when collisions > 0 (rank.go:536)
      affinity  the static per-node boost, where nonzero (rank.go:650)
      spread    the sum over active stanzas of the even-spread boost
                (spread.go:178) or the targeted one ((desired-(count+1))
                /desired * weight); -1 per stanza for a missing value
    The reference's compiled program adds `base` and `anti` in one fused
    multiply-add; so do this and the kernel.

    `d_active` bool[D] marks the distinct_property stanzas that were live
    when the scan started (the initial distinct_remaining[:, 0] >= 0)."""
    dev = cap.device
    n = cap.shape[0]
    capacity = instance_capacity(cap, used, ask, feasible)
    can_place = (capacity > 0) & (placed < int(max_per_node))
    n_d, n_dvals = distinct_remaining.shape
    did_safe = distinct_ids.clamp(0, n_dvals - 1).long()
    for d in range(n_d):
        ok_d = (distinct_ids[d] >= 0) & \
            (distinct_remaining[d][did_safe[d]] > 0)
        can_place &= torch.where(d_active[d], ok_d, True)

    raw = score_fit(cap, used + ask[None, :], spread=spread_algorithm)
    collisions = job_collisions + placed
    anti_present = collisions > 0
    desired = torch.full((), float(max(int(desired_count), 1)),
                         dtype=torch.float32, device=dev)
    anti = -(collisions.to(torch.float32) + 1.0) / desired
    inv = torch.full((), _INV_MAX_SCORE, dtype=torch.float32, device=dev)
    base_anti = _fma_f32(raw, inv, torch.where(anti_present, anti, 0.0))

    n_s, n_props = spread_counts.shape
    sid_safe = spread_ids.clamp(0, n_props - 1).long()
    s_active = spread_mode >= 0
    spread_total = torch.zeros((n,), dtype=torch.float32, device=dev)
    for s in range(n_s):
        ids_s = spread_ids[s]
        pc_s = spread_counts[s]
        node_pc = torch.where(ids_s >= 0, pc_s[sid_safe[s]], 0)
        even = _even_spread_boost_vec(node_pc, pc_s, pc_s >= 0)
        d_s = torch.where(ids_s >= 0, spread_desired[s][sid_safe[s]], -1.0)
        targeted = torch.where(
            d_s > 0,
            ((d_s - (node_pc.to(torch.float32) + 1.0)) / d_s)
            * spread_weights[s], -1.0)
        per_node = torch.where(spread_mode[s] == 1, targeted, even)
        per_node = torch.where(ids_s >= 0, per_node, -1.0)
        spread_total = spread_total + torch.where(s_active[s], per_node,
                                                  0.0)
    spread_present = s_active.any() & (spread_total != 0.0)
    affinity_present = affinity_boost != 0.0

    # the reference's _mean_scores over [base, anti, affinity, spread],
    # with base and anti in one fused multiply-add
    total = base_anti + torch.where(affinity_present, affinity_boost, 0.0)
    total = total + torch.where(spread_present, spread_total, 0.0)
    n_present = (1.0 + anti_present.to(torch.float32)
                 + affinity_present.to(torch.float32)
                 + spread_present.to(torch.float32))
    return torch.where(can_place, total / torch.clamp(n_present, min=1.0),
                       -math.inf)


def chunked_key(score: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """The scan's selection key, int64[N], unique per node: the
    order-preserving bits of the float32 score in the high word (-0.0
    read as +0.0, which the sort takes as equal), ~index in the low word
    (the index is `offset` + the row: a shard's block keys its rows by
    their place in the whole bucket). Keys descending are scores
    descending, then node index ascending: the order of a stable
    descending sort, and lax.top_k's. csrc/chunked_scan.cu and
    csrc/chunked_shard.cu select by the same key (as uint64, its high
    word offset by 2**31). A score is never NaN (chunked_step_ref divides
    only by values >= 1 or > 0)."""
    s = torch.where(score == 0.0, 0.0, score)
    bits = s.view(torch.int32).to(torch.int64)
    hi = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.arange(score.shape[0], dtype=torch.int64,
                       device=score.device) + int(offset)
    return hi * 2 ** 32 + (2 ** 32 - 1 - idx)


def _chunked_take(score: torch.Tensor, k: int, take_now: torch.Tensor
                  ) -> torch.Tensor:
    """One step's selection: the first `take_now` nodes by (score
    descending, node index ascending) among the top k with a finite
    score, one instance each -> add i32[N]. The order is chunked_key's,
    the rule the scan kernel applies."""
    top_i = torch.topk(chunked_key(score), k).indices
    rank = torch.arange(k, device=score.device)
    select = (rank < take_now) & torch.isfinite(score[top_i])
    add = torch.zeros(score.shape, dtype=torch.int32, device=score.device)
    add[top_i] = select.to(torch.int32)
    return add


def _place_chunked_loop(step, cap, used, ask, count, feasible,
                        job_collisions, desired_count, spread_ids,
                        spread_counts, spread_desired, spread_mode,
                        spread_weights, affinity_boost, distinct_ids,
                        distinct_remaining, max_per_node, max_steps,
                        spread_algorithm, placed_init) -> tuple:
    """place_chunked's scan with `step` as the score producer
    (chunked_step_ref): a Python loop over max_steps steps, the running
    state on the inputs' device. A step with nothing left to place
    changes no state, so the loop reads `remaining` once, after the
    ceil(count/chunk) steps that can place all of it, and stops there if
    it is 0 — the only host sync. (The scan kernel also stops at the
    first step that selects nothing; this loop runs on.)"""
    dev = cap.device
    n = cap.shape[0]
    count = int(count)
    k = min(n, 256)
    chunk = min(max((count + max_steps - 1) // max_steps, 1), k)
    mpn = min(int(max_per_node), MAX_PER_NODE_CAP)
    desired = int(desired_count)
    n_s, n_props = spread_counts.shape
    n_d, n_dvals = distinct_remaining.shape
    d_active = distinct_remaining[:, 0] >= 0
    flat_sid = (spread_ids.clamp(0, n_props - 1).long()
                + torch.arange(n_s, device=dev)[:, None] * n_props).view(-1)
    flat_did = (distinct_ids.clamp(0, n_dvals - 1).long()
                + torch.arange(n_d, device=dev)[:, None] * n_dvals).view(-1)
    s_valid, d_valid = spread_ids >= 0, distinct_ids >= 0
    placed = torch.zeros((n,), dtype=torch.int32, device=dev) \
        if placed_init is None else placed_init
    pcounts, drem = spread_counts, distinct_remaining
    remaining = torch.full((), count, dtype=torch.int32, device=dev)
    check_at = -(-count // chunk)
    for t in range(max_steps):
        if t == check_at and int(remaining) == 0:
            break
        score = step(cap, used, ask, feasible, job_collisions, placed, mpn,
                     desired, spread_ids, pcounts, spread_desired,
                     spread_mode, spread_weights, affinity_boost,
                     distinct_ids, drem, d_active, spread_algorithm)
        add = _chunked_take(score, k, torch.clamp(remaining, max=chunk))
        used = used + add[:, None].to(torch.float32) * ask[None, :]
        placed = placed + add
        remaining = remaining - add.sum(dtype=torch.int32)
        pcounts = pcounts.reshape(-1).index_add(
            0, flat_sid, torch.where(s_valid, add[None, :], 0).view(-1)
        ).view(n_s, n_props)
        drem = drem.reshape(-1).index_add(
            0, flat_did, torch.where(d_valid, -add[None, :], 0).view(-1)
        ).view(n_d, n_dvals)
    return placed, used, pcounts, drem


def place_chunked(cap, used, ask, count, feasible, job_collisions,
                  desired_count, spread_ids, spread_counts, spread_desired,
                  spread_mode, spread_weights, affinity_boost, distinct_ids,
                  distinct_remaining, max_per_node=MAX_PER_NODE_CAP,
                  max_steps: int = 256, spread_algorithm: bool = False,
                  placed_init: Optional[torch.Tensor] = None) -> tuple:
    """Chunked greedy placement with the full interacting GenericStack
    score model (ref kernels.place_chunked): each of max_steps steps
    scores every node with the running state (chunked_step_ref) and
    places ceil(count/max_steps) instances, one per node, on the best
    nodes; chunk 1 is exact sequential greedy.

    Inputs (as the reference): cap/used f32[N, R']; ask f32[R']; count;
    feasible bool[N]; job_collisions i32[N]; desired_count; spread_ids
    i32[S, N] (-1 missing); spread_counts i32[S, P] (-1 dead column);
    spread_desired f32[S, P] (-1 no target); spread_mode i32[S] (0 even,
    1 targeted, -1 pad); spread_weights f32[S]; affinity_boost f32[N];
    distinct_ids i32[D, N] (-1 missing); distinct_remaining i32[D, P]
    (remaining[d, 0] < 0 marks a pad stanza).

    One solve covers at most max_steps * min(N, 256) instances; the
    placer splits larger asks across solves, feeding the returned state
    back (`placed_init` carries earlier placements). Returns (placed_total
    i32[N] including placed_init, final_used f32[N, R'], spread_counts
    i32[S, P], distinct_remaining i32[D, P]); the inputs are not
    modified."""
    return _place_chunked_loop(
        chunked_step_ref, cap, used, ask, count, feasible, job_collisions,
        desired_count, spread_ids, spread_counts, spread_desired,
        spread_mode, spread_weights, affinity_boost, distinct_ids,
        distinct_remaining, max_per_node, max_steps, spread_algorithm,
        placed_init)


def chunked_shard_ref(caps, useds, asks, count, feasibles, collisions,
                      desired_count, spread_ids, spread_counts,
                      spread_desired, spread_modes, spread_weights,
                      affinities, distinct_ids, distinct_remaining, placed,
                      max_per_node=MAX_PER_NODE_CAP, max_steps: int = 256,
                      spread_algorithm: bool = False) -> tuple:
    """Plain version of the sharded scan kernel (csrc/chunked_shard.cu):
    place_chunked with the node axis split into S row blocks of R rows,
    every argument a list of S per-shard values (the node-axis ones shard
    s's block: cap/used [R, R'], feasible/collisions/affinity/placed [R],
    spread_ids/distinct_ids [stanzas, R]; the others each shard's copy).
    Each step every shard scores its block against its own copy of the
    spread counts and distinct quotas (chunked_step_ref) and offers its
    first take = min(chunk, remaining) rows by chunked_key over the bucket
    (offset s R); the step's winners are the first take of the S offers
    by key, and every shard applies them to its copy of the tables and to
    its own rows. It stops where the scan kernel stops (remaining 0, a
    step that selects nothing, max_steps). -> (placed blocks, used blocks,
    spread_counts per shard, distinct_remaining per shard, steps run),
    equal bit for bit to place_chunked over the whole bucket (the tables
    equal on every shard)."""
    n_shards = len(caps)
    rows = int(caps[0].shape[0])
    count = int(count)
    k = min(rows * n_shards, 256)
    chunk = min(max((count + max_steps - 1) // max_steps, 1), k)
    mpn = min(int(max_per_node), MAX_PER_NODE_CAP)
    desired = int(desired_count)
    pcounts = list(spread_counts)
    drem = list(distinct_remaining)
    n_s, n_props = pcounts[0].shape
    n_d, n_dvals = drem[0].shape
    d_active = [dr[:, 0] >= 0 for dr in drem]
    used = list(useds)
    placed = list(placed)
    remaining, steps = count, 0
    # the plain version's step loop over the shards: the card queues the
    # same steps as launches — nomadlint: disable=CVX001
    for t in range(max_steps):
        take = min(remaining, chunk)
        if take <= 0:
            break
        offers = []             # (key, shard, row) of every shard's offer
        for s in range(n_shards):
            score = chunked_step_ref(
                caps[s], used[s], asks[s], feasibles[s], collisions[s],
                placed[s], mpn, desired, spread_ids[s], pcounts[s],
                spread_desired[s], spread_modes[s], spread_weights[s],
                affinities[s], distinct_ids[s], drem[s], d_active[s],
                spread_algorithm)
            fin = torch.isfinite(score)
            key = chunked_key(score, offset=s * rows)
            key = torch.where(fin, key, torch.iinfo(torch.int64).min)
            n_offer = min(int(fin.sum()), take)
            top = torch.topk(key, n_offer).indices
            offers += [(int(key[j]), s, int(j)) for j in top]
        offers.sort(reverse=True)
        winners = offers[:take]
        n_sel = len(winners)
        sp_add = torch.zeros((n_s, n_props), dtype=torch.int32)
        dp_sub = torch.zeros((n_d, n_dvals), dtype=torch.int32)
        for _, s, j in winners:
            for v in range(n_s):
                sid = int(spread_ids[s][v, j])
                if sid >= 0:
                    sp_add[v, min(sid, n_props - 1)] += 1
            for v in range(n_d):
                did = int(distinct_ids[s][v, j])
                if did >= 0:
                    dp_sub[v, min(did, n_dvals - 1)] += 1
        for s in range(n_shards):
            add = torch.zeros((rows,), dtype=torch.int32,
                              device=caps[s].device)
            own = [j for _, r, j in winners if r == s]
            if own:
                add[torch.tensor(own, device=add.device)] = 1
            used[s] = used[s] + add[:, None].to(torch.float32) * \
                asks[s][None, :]
            placed[s] = placed[s] + add
            pcounts[s] = pcounts[s] + sp_add.to(pcounts[s].device)
            drem[s] = drem[s] - dp_sub.to(drem[s].device)
        remaining -= n_sel
        steps = t + 1
        if n_sel == 0:
            break
    return placed, used, pcounts, drem, steps


# ------------------------------------------------------------ preemption

def _xla_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum along axis 1 of [C, V, R'] in the
    order XLA's CPU backend sums the reference's jnp.cumsum: left to
    right within blocks of 16, then each block offset by the prefix sum
    (the same way, recursively) of the block totals before it. For V <= 16
    that is plain left to right."""
    c, v = x.shape[0], x.shape[1]
    blk = 16
    if v <= blk:
        out = torch.empty_like(x)
        acc = x[:, 0]
        out[:, 0] = acc
        for j in range(1, v):
            acc = acc + x[:, j]
            out[:, j] = acc
        return out
    nb = -(-v // blk)
    pad = torch.zeros((c, nb * blk - v) + tuple(x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    xb = torch.cat([x, pad], dim=1).view((c * nb, blk) + tuple(x.shape[2:]))
    inner = _xla_prefix_sum(xb).view((c, nb, blk) + tuple(x.shape[2:]))
    totals = _xla_prefix_sum(inner[:, :, -1])               # [C, nb, R']
    offset = torch.cat([torch.zeros_like(totals[:, :1]), totals[:, :-1]],
                       dim=1)
    out = inner + offset[:, :, None]
    return out.view((c, nb * blk) + tuple(x.shape[2:]))[:, :v]


def preemption_distance(victim_res: torch.Tensor, ask: torch.Tensor
                        ) -> torch.Tensor:
    """Batched basicResourceDistance (ref preemption.go:608): normalized
    euclidean distance of each victim's resources to the ask.
    victim_res f32[C, V, R'], ask f32[R'] -> f32[C, V]. The sum of
    squares runs over R' in order as a chain of fused multiply-adds, as
    the reference's compiled program computes it."""
    ask_pos = ask > 0
    delta = torch.where(ask_pos, (victim_res - ask) /
                        torch.where(ask_pos, ask, 1.0), 0.0)
    acc = torch.zeros(victim_res.shape[:-1], dtype=torch.float32,
                      device=victim_res.device)
    for r in range(victim_res.shape[-1]):
        acc = _fma_f32(delta[..., r], delta[..., r], acc)
    dims = torch.clamp(ask_pos.sum(), min=1).to(torch.float32)
    return torch.sqrt(acc / dims)


def preempt_top_k(victim_res: torch.Tensor, victim_priority: torch.Tensor,
                  ask: torch.Tensor, free: torch.Tensor, job_priority
                  ) -> torch.Tensor:
    """Masked victim selection over C candidate nodes at once (ref
    kernels.preempt_top_k under jax.vmap, the candidate axis written out
    as the leading dimension): per node, order the eligible victims
    (priority below the job's) by priority, then distance to the ask, and
    take the shortest prefix whose reclaimed resources close the deficit
    ask - free. victim_res f32[C, V, R'], victim_priority i32[C, V], ask
    f32[R'], free f32[C, R'] -> bool[C, V] victim mask.

    The key keeps the reference's float32 `priority * 1e6 + distance`
    (one fused multiply-add there; the product is exact): from priority
    17 on it no longer tells small distances apart, as in the reference.
    The sort is stable, the prefix sums run in XLA's order, and a row
    with no deficit or no eligible cover takes nothing.

    Plain torch on whichever device the inputs lie on: one pass of a few
    dozen tensor operations per preemption eval, with no Pallas
    counterpart and no loop over candidates."""
    dev = victim_res.device
    c, v = victim_priority.shape
    eligible = victim_priority < int(job_priority)
    dist = preemption_distance(victim_res, ask)
    key = _fma_f32(victim_priority.to(torch.float32),
                   torch.full((), 1e6, dtype=torch.float32, device=dev),
                   dist)
    key = torch.where(eligible, key, math.inf)
    order = torch.argsort(key, dim=1, stable=True)
    res_sorted = torch.gather(
        victim_res, 1, order[:, :, None].expand(-1, -1, victim_res.shape[2]))
    cum = _xla_prefix_sum(res_sorted)
    deficit = torch.clamp(ask[None, :] - free, min=0.0)           # [C, R']
    enough = (cum >= deficit[:, None, :]).all(dim=2)              # [C, V]
    first = torch.argmax(enough.to(torch.int32), dim=1)
    needed = torch.where(enough.any(dim=1) & (deficit > 0).any(dim=1),
                         first + 1, 0)
    take_sorted = (torch.arange(v, device=dev)[None, :] < needed[:, None]) \
        & torch.isfinite(torch.gather(key, 1, order))
    return torch.zeros((c, v), dtype=torch.bool, device=dev).scatter(
        1, order, take_sorted)


# ------------------------------------------------------------- explain

def explain_reduce(cap: torch.Tensor, used: torch.Tensor, ask: torch.Tensor,
                   feasible: torch.Tensor, collisions: torch.Tensor,
                   placed: torch.Tensor, class_ids: torch.Tensor,
                   distinct_hosts: bool, n_classes: int = 2,
                   contract: bool = False) -> torch.Tensor:
    """Elimination attribution of one solve (ref kernels._explain_reduce_
    impl), at POST-solve usage used + placed ⊗ ask — the state a host
    iterator-stack re-walk over the same cluster would see:

      * distinct-hosts: a feasible row whose post-solve same-job
        collision count is positive (what DistinctHostsIterator filters);
      * exhaustion: a candidate row where one more instance overflows a
        dimension, attributed to the FIRST failing dimension in extended-
        resource order (ComparableResources.superset's cpu -> memory ->
        disk order);
      * per-node-class histograms over a pre-lowered id column (-1 = no
        class or padding).

    Torch ops on whichever device the inputs lie on, all compares and one
    sum over an [N, 11 + 2C] int32 column block — no scatter. The sums
    round as explain.reduce_numpy does (the product, the sum and the
    second sum each to float32), so the two agree bit for bit. Returns
    ONE int32 buffer [6 + R' + 2 * n_classes]: counts [feasible,
    dh_filtered, exhausted, fit, placed_nodes, placed_total], then the
    per-dimension, per-class exhausted and per-class dh counts
    (explain.unpack splits it). Pure reduction: never touches the
    placement math. The placer does not run it: every solve reduces on
    the host (explain.dispatch_reduce), which chip_smoke.py's explain
    phase times against this reduce enqueued behind a card solve.
    `contract` rounds the post-solve usage once (a fused multiply-add),
    as the reference's compiled whole-eval programs do."""
    dev = cap.device
    placed_i = placed.to(torch.int32)
    k = placed_i[:, None].to(torch.float32)
    post = _fma_f32(k, ask[None, :], used) if contract \
        else used + k * ask[None, :]
    feas = feasible.to(torch.bool)
    if distinct_hosts:
        dh = feas & ((collisions + placed_i) > 0)
    else:
        dh = torch.zeros_like(feas)
    cand = feas & ~dh
    over = (post + ask[None, :]) > cap                       # bool[N, R']
    exh = cand & over.any(dim=1)
    # first failing dim as a one-hot: the first True column is where the
    # running count of Trues reaches exactly 1
    first = over & (torch.cumsum(over, dim=1) == 1)
    onehot = class_ids[:, None] == torch.arange(n_classes, device=dev)
    cols = torch.cat((
        torch.stack((feas, dh, exh, cand & ~exh, placed_i > 0), dim=1),
        first & exh[:, None], onehot & exh[:, None], onehot & dh[:, None]),
        dim=1).to(torch.int32)
    sums = torch.cat((cols.sum(dim=0, dtype=torch.int32),
                      placed_i.sum(dtype=torch.int32).reshape(1)))
    # order the buffer: the six counts, then dims and classes
    return torch.cat((sums[:5], sums[-1:], sums[5:-1]))
