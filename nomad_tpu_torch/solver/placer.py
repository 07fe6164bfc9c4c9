"""SolverPlacer: the bridge between GenericScheduler and the batched
solver on the card — the SchedulerAlgorithm="tpu-batch" implementation
(north star, BASELINE.json). Counterpart of nomad_tpu/solver/placer.py:
the serial route (depth, greedy and the chunked scan), the pipelined
plan lifecycle and batched preemption.

Division of labor:
  * device: feasibility-masked capacity + scoring + placement counts over
    the whole node axis at once (no log2(N) sampling — the full matrix),
    through the hand kernels (backend.select);
  * host: exact sequential resources for the chosen nodes only — ports via
    NetworkIndex, device instances, cpuset cores — with per-node retry.

Serial route: each task group's solve runs once, on the state cache's
twins where they served the eval, and reaches the host at one sync; its
placements go into the eval's single plan. Groups with spread stanzas or
distinct_property constraints, or too deep for the [N, K] depth curve,
take the chunked scan (kernels.place_chunked; on a card the whole scan is
one launch of the scan kernel, cuda_kernels.place_chunked). Instances
left over once capacity runs out go through the batched preemption pass
(kernels.preempt_top_k over every candidate node at once, each winner
verified exactly on the host) before the host stack.

Every dispatch — serial, scan, preemption — goes through the backend's
dispatch chain (backend.select): a classified device error feeds the
tier's breaker and raises out of the eval; the solve never moves to the
CPU. Explain (explain.py) rides every solve at its default: its reduce
runs on the host over the placement vector the solve's one sync brought
back.

Pipelined plan lifecycle (ref nomad/plan_apply.go:71-177, where the
applier overlaps plan evaluation with the previous raft commit): large
simple evals split their solve into chunks whose dispatches are all
queued on the card up front — chunk N+1's solve consumes chunk N's
placements through a device-side usage update, so the card never waits
while the host materializes, evaluates and commits chunk N through the
real serial applier. Each chunk is a real Plan carrying the eval's
snapshot index; the applier's per-node re-check against latest state
runs per chunk, so optimistic-concurrency rejections surface exactly as
on the serial path (a partially-committed chunk flags the eval for the
standard refresh-and-retry). `plan_pipeline_enabled=False` (or
NOMAD_PLAN_PIPELINE=0) forces the serial path.

A device error in a pipelined chunk — at its dispatch or when its result
reaches the host — feeds the breaker and raises PipelineChunkError out of
the eval, naming the chunk. The reference's degrade path, which re-solves
the remaining chunks on the host, is not ported: card work never moves to
the CPU.

Eval micro-batching (microbatch.py): every eval configures the batcher
from the scheduler config and marks itself in flight around
`_compute_placements`, as the reference's placer does; a serial depth
solve passes its count to backend.select, which may send it to the
batch tier. Pipelined chunk solves never batch (their counts are far
above BATCH_MAX_COUNT, and their chained usage stays on the card).

Convex tier (scheduler_algorithm "convex"): a depth or greedy solve
first tries `_convex_solve`, the whole eval as one projected-gradient
solve over the state cache's resident twins (backend.select_convex; on a
card one launch of csrc/convex_solve.cu), as the reference's placer
does; it declines to the routes below where the reference declines. The
scan and the pipelined lifecycle never take it.

Fused route (on by default; SchedulerConfiguration.solver_fused_enabled,
NOMAD_SOLVER_FUSED=0/1): a serial depth or greedy solve that convex did
not take tries `_fused_solve`, the eval's gather, solve and plan-fit
verdict on the card from the resident twins behind ONE host sync
(backend.select_fused: the gather entry of the depth-curve or
score/capacity kernel, the torch tail, csrc/fit_verdict.cu). The verdict
rides the plan to the applier's fast path (`_stamp_verdict`). The scan
and the pipelined lifecycle keep the classic route: they gather the
eval's rows from the resident twins when they dispatch (`_dev_mats`).

On the device mesh (sharding.py) one MeshSnapshot, taken where the
node axis is padded, pins the bucket and every selection of the eval to
one device set (`prep.snap`): a greedy or depth solve at a bucket the
mesh takes runs on the sharded tier, the fused route over the state
cache's sharded twins, and the batched preemption scan shards its
candidate axis from PREEMPT_SHARD_MIN candidates. Each still ends at the
eval's one host copy. The scan, the convex solve and micro-batch windows
run solo on the mesh's first device.
"""
from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from ..metrics import metrics
from ..structs import (
    AllocatedResources, AllocatedTaskResources, Allocation, AllocMetric,
    AllocDeploymentStatus, NetworkIndex, Plan, new_id, new_ids,
    skeleton_for,
)
from ..scheduler.stack import SelectOptions
from . import backend, device as _device, explain as explain_mod
from . import microbatch, roundtrip, sharding
from ..obs import timing
from .buckets import node_bucket, pow2
from .tensorize import (
    build_group_tensors, _lower_affinities, _lower_distinct, _lower_spreads,
)

# candidate-node axes at least this long shard their preemption victim
# scan over the mesh (ref placer.py:61; sharding.sharded_preempt_top_k)
PREEMPT_SHARD_MIN = 1024


class PipelineChunkError(RuntimeError):
    """A device error surfaced while dispatching or materializing one
    chunk of a pipelined eval."""


def _usage_update(used, coll, placed, ask):
    """(used', coll') = (used + placed ⊗ ask, coll + placed) on the
    solve's device — the mirror of what committing chunk N does to the
    usage index (utilization AND same-job collision counts, the
    anti-affinity input), so chunk N+1 scores post-chunk-N state without
    a host round trip. The reference's operation order: a float32
    product, then a float32 sum, each rounded."""
    return (used + placed[:, None].float() * ask[None, :],
            coll + placed.int())


class _Chunk:
    """One pipelined chunk's placement vector on its way to the host. On
    a card it is copied without blocking into pinned memory right behind
    the chunk's solve, with an event recorded after the copy: waiting on
    that event waits for this chunk alone, not for the chunks queued
    after it (a plain .cpu() would wait for the whole stream)."""

    __slots__ = ("host", "event")

    def __init__(self, placed: torch.Tensor):
        if placed.device.type == "cuda":
            self.host = torch.empty(placed.shape, dtype=placed.dtype,
                                    pin_memory=True)
            self.host.copy_(placed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(placed.device))
        else:
            self.host, self.event = placed, None

    def numpy(self) -> np.ndarray:
        """The placement vector, waiting for this chunk's copy only."""
        if self.event is not None:
            # the pipelined chunk seam, waiting for this chunk's copy
            # alone — nomadlint: disable=SYNC001
            self.event.synchronize()
        return self.host.numpy()


def _in_flight(chunk: _Chunk) -> bool:
    """True while a chunk's solve or copy is still running on the card;
    always False on the CPU."""
    return chunk.event is not None and not chunk.event.query()


class _SolvePrep:
    """Per-(eval, TG) solve setup shared by the serial and pipelined
    paths: shuffled+padded tensors, kernel routing and the depth-regime
    parameters (computed from the TOTAL count, so a chunked solve uses
    the same regime as the one-shot solve)."""
    __slots__ = ("gt", "n", "count", "use_scan", "use_depth", "k_max",
                 "sp", "dp", "aff", "max_per_node", "spread_alg",
                 "depth_grid", "jitter", "bias_g", "m", "distincts",
                 "ex", "ex_ids", "ex_ncls", "snap")


class SolverPlacer:
    def __init__(self, sched):
        self.sched = sched                # GenericScheduler
        self.ctx = sched.ctx
        self.state = sched.state
        self.plan = sched.plan
        # per-eval ResourceSkeleton pool (structs/respool.py): one
        # immutable resource base per task group, shared copy-on-write
        # by every materialization path below
        self._skel: dict = {}

    def compute_placements(self, destructive, place) -> bool:
        cfg = self.ctx.scheduler_config
        # hot-reload the stream-coalescing knobs from the replicated
        # scheduler config (same path as the SchedulerAlgorithm enum) and
        # mark this eval in flight so concurrent small solves can find
        # each other in the micro-batcher
        microbatch.configure(
            enabled=(getattr(cfg, "eval_batch_enabled", True)
                     and os.environ.get("NOMAD_EVAL_BATCH", "") != "0"),
            window_s=getattr(cfg, "eval_batch_window_ms", 8.0) / 1000.0)
        # hot-reload the explain ring capacity from the same config
        # (enabled-ness is resolved per solve in _prep_solve)
        explain_mod.configure(
            capacity=getattr(cfg, "placement_explain_recent", 256))
        microbatch.eval_started()
        # per-eval host↔device transition accounting: every dispatch
        # seam notes itself; the total lands in the
        # nomad.solver.device_round_trips histogram at eval exit
        roundtrip.begin()
        try:
            return self._compute_placements(destructive, place)
        finally:
            roundtrip.end()
            microbatch.eval_finished()

    def _compute_placements(self, destructive, place) -> bool:
        sched = self.sched
        from ..scheduler.reconcile import AllocPlaceResult

        deployment_id = ""
        if sched.deployment is not None and sched.deployment.active():
            deployment_id = sched.deployment.id
        if sched.plan.deployment is not None:
            deployment_id = sched.plan.deployment.id

        # stop destructive old allocs first (atomic place/stop pairing)
        for missing in destructive:
            self.plan.append_stopped_alloc(
                missing.stop_alloc, missing.stop_status_description)

        # group placements by task group; instances of one TG are identical.
        # Placements tied to a previous alloc (reschedules, migrations,
        # sticky disks) keep the host path: they carry penalty/preference
        # state the batched kernel doesn't model.
        by_tg: dict[str, list] = {}
        leftovers: list = []
        for missing in list(destructive) + list(place):
            is_place = isinstance(missing, AllocPlaceResult)
            tg = missing.task_group if is_place else missing.place_task_group
            if sched.job.lookup_task_group(tg.name) is None:
                continue
            prev = missing.previous_alloc if is_place else None
            if prev is not None or (is_place and (
                    missing.canary or missing.downgrade_non_canary)):
                # downgrade_non_canary placements need the old job
                # version's group spec — host path resolves it
                leftovers.append(missing)
            else:
                by_tg.setdefault(tg.name, []).append(missing)

        nodes = sched._ready_nodes
        for tg_name, missings in by_tg.items():
            tg = sched.job.lookup_task_group(tg_name)
            mi = -1
            prep = None
            if self._pipeline_eligible(tg, missings, by_tg, leftovers):
                pipelined, prep = self._pipelined_place(
                    tg, nodes, missings, deployment_id)
                if pipelined is not None:
                    mi = pipelined
            if mi < 0:           # serial path (ineligible or declined)
                # a declined pipeline hands its prep over: tensorize,
                # shuffle, and the per-eval RNG draws must not run twice
                with timing.timed("nomad.solver.solve", "solver.solve",
                                  cpu="nomad.solver.solve_cpu",
                                  tg=tg_name, count=len(missings)):
                    placed_map = self._solve_group(tg, nodes, len(missings),
                                                   prep=prep)
                node_iter = [(node, k) for node, k in placed_map if k > 0]
                # TGs with no sequential resources (ports/devices/cores)
                # need no per-alloc exact pass: stamp out the allocations
                # in one batch with shared (immutable-by-convention)
                # resource/metric objects
                with timing.timed("nomad.solver.materialize",
                                  "solver.materialize", tg=tg_name):
                    if node_iter and self._is_simple(tg):
                        mi = self._place_batch_simple(missings, tg,
                                                      node_iter,
                                                      deployment_id)
                    else:
                        # expand per-node counts into concrete allocations
                        mi = 0
                        for node, k in node_iter:
                            for _ in range(int(k)):
                                if mi >= len(missings):
                                    break
                                missing = missings[mi]
                                if self._place_one(missing, tg, node,
                                                   deployment_id):
                                    mi += 1
                                else:
                                    break  # node rejected exact assignment
            rest = missings[mi:]
            if rest:
                # capacity exhausted: batched preemption pass (masked
                # victim selection over every candidate node at once on
                # the device, exact host verify)
                with timing.timed("nomad.solver.preempt",
                                  "solver.preempt", tg=tg_name):
                    rest = self._preempt_batch(tg, rest, deployment_id)
            leftovers.extend(rest)

        # host fallback for anything the batched pass couldn't place
        # (port-exhausted nodes, sticky disks, canaries with preferred
        # nodes, non-simple preemption); rate logged per eval
        total = len(list(destructive)) + len(list(place))
        sched.solver_stats = {"total": total, "host_fallback": len(leftovers)}
        metrics.incr("nomad.solver.placements_host_fallback", len(leftovers))
        if leftovers and self.ctx.logger:
            self.ctx.logger(
                f"solver: eval {sched.eval.id[:8]} fell back to the host "
                f"stack for {len(leftovers)}/{total} placements")
        if leftovers:
            return self._fallback(leftovers, deployment_id)
        return True

    # ------------------------------------------------------------- solving

    def _prep_solve(self, tg, nodes, count: int):
        """Everything a depth/greedy/scan solve needs BEFORE the kernel call:
        shuffled node order, lowered+padded tensors, kernel routing and
        the depth-regime parameters. RNG draws follow the reference in
        kind and order, so the same eval shuffles and jitters the same."""
        if not nodes or count == 0:
            return None
        job = self.sched.job

        # shuffle the node axis (the RandomIterator analog, ref
        # scheduler/stack.go:71): concurrent workers planning from the same
        # snapshot must not all fill the same equal-scored nodes. The
        # kernels' stable sorts follow this order for score ties, exactly
        # like the host stack's shuffle. Seeded from the stack's per-eval
        # rng, so identical (snapshot, eval, seed) inputs shuffle
        # identically.
        perm = np.random.default_rng(
            self.sched.stack.rng.getrandbits(64)).permutation(len(nodes))
        nodes = [nodes[i] for i in perm]

        feasible_fn = self._feasibility_fn(tg)
        # explain attribution: the irregular host walk runs against a
        # SCRATCH AllocMetric so the checker objects' filter reasons
        # (plus the class-cached repeats _feasibility_fn records) become
        # stage 1 of the attribution instead of vanishing into the
        # eval-wide metric. The swap changes no placement input.
        ex_rec = None
        with metrics.measure("nomad.solver.tensorize"):
            if explain_mod.enabled(self.ctx.scheduler_config):
                ex_rec = explain_mod.ExplainRecord(
                    self.sched.eval.id, self.sched.eval.job_id, tg.name)
                ex_rec.nodes_total = len(nodes)
                scratch = AllocMetric()
                # marks the tensorize walk for _feasibility_fn: cached-
                # class rejections record their reason ONLY here
                scratch.explain_walk = True
                saved = self.ctx.metrics
                self.ctx.metrics = scratch
                try:
                    gt = build_group_tensors(self.ctx, job, tg, nodes,
                                             feasible_fn, count=count,
                                             explain=True)
                finally:
                    self.ctx.metrics = saved
                ex_rec.irregular = scratch
                st = gt.ex_stages or {}
                ex_rec.elig_filtered = st.get("elig_filtered", 0)
                ex_rec.dh_pre = st.get("dh_pre", 0)
                ex_rec.dh_pre_classes = st.get("dh_pre_classes", {})
            else:
                gt = build_group_tensors(self.ctx, job, tg, nodes,
                                         feasible_fn, count=count)
        spreads = list(tg.spreads) + list(job.spreads)
        affinities = list(job.affinities) + list(tg.affinities)
        for t in tg.tasks:
            affinities.extend(t.affinities)
        distincts = self._distinct_property_sets(tg)
        spread_alg = (self.ctx.scheduler_config
                      .effective_scheduler_algorithm() == "spread")
        # kernel routing (the host GenericStack ALWAYS chains
        # JobAntiAffinityIterator, ref rank.go:536):
        #   scan   — spread stanzas / distinct_property: cross-node score
        #            interactions need the running-state scan;
        #   depth  — multi-instance / collision / affinity placements
        #            with per-node-separable scores: the [N, K] depth
        #            solver dominates sequential greedy;
        #   greedy — collision-free single instances: binpack sort.
        use_scan = bool(spreads) or bool(distincts)
        use_depth = (not use_scan
                     and (count > 1 or bool(affinities) or spread_alg
                          or bool(gt.job_collisions.any())))
        k_max = 0
        if use_depth:
            ask_pos = gt.ask > 0
            if ask_pos.any():
                free = np.maximum(gt.cap - gt.used, 0.0)
                per_node = np.floor(np.min(np.where(
                    ask_pos[None, :], free / np.where(ask_pos, gt.ask, 1.0),
                    np.inf), axis=1))
                per_node = per_node[np.asarray(gt.feasible, bool)]
                deepest = int(per_node.max()) if per_node.size else 0
            else:
                deepest = count
            k_needed = max(1, min(deepest, count))
            k_max = max(8, 1 << (k_needed - 1).bit_length())
            if k_max > 512:
                use_scan = True        # too deep for the [N, K] curve
                use_depth = False

        # the reference lowers spreads and distinct_property for depth
        # solves too; with neither in scope they are pad stanzas no depth
        # solve reads, so only the scan lowers them here
        sp = _lower_spreads(self.ctx, job, tg, spreads, nodes) \
            if use_scan else None
        dp = _lower_distinct(self.ctx, distincts, nodes) \
            if use_scan else None
        aff = _lower_affinities(self.ctx, affinities, nodes) \
            if use_scan or use_depth else None

        # pad the node axis to the shared pow2 bucket (buckets.node_bucket)
        # so the kernels see one shape per bucket, not one per cluster
        # size; padding rows are infeasible and can never be chosen. ONE
        # MeshSnapshot pins the shard count here and every selection of
        # this eval below: a rebuild in the middle of the eval cannot
        # split the bucket from the launch layout
        snap = sharding.snapshot()
        n = gt.cap.shape[0]
        padded = node_bucket(n, shards=snap.shards)
        if padded != n:
            pad = padded - n
            gt.cap = np.pad(gt.cap, ((0, pad), (0, 0)))
            gt.used = np.pad(gt.used, ((0, pad), (0, 0)))
            gt.feasible = np.pad(gt.feasible, (0, pad))
            gt.job_collisions = np.pad(gt.job_collisions, (0, pad))
            if sp is not None:
                sp.ids = np.pad(sp.ids, ((0, 0), (0, pad)),
                                constant_values=-1)
            if dp is not None:
                dp.ids = np.pad(dp.ids, ((0, 0), (0, pad)),
                                constant_values=-1)
            if aff is not None:
                aff = np.pad(aff, (0, pad))
        prep = _SolvePrep()
        prep.snap = snap
        prep.gt = gt
        prep.n = n
        prep.count = count
        prep.distincts = distincts
        prep.ex = ex_rec
        prep.ex_ids = None
        prep.ex_ncls = 0
        if ex_rec is not None:
            # node-class id column for the histogram, padded to the solve
            # bucket (padding = -1). The dense path gathered it from the
            # usage index's class column; the object-walk fallback lowers
            # it per node here (small test clusters only).
            bucket = gt.cap.shape[0]
            st = gt.ex_stages or {}
            ids = st.get("class_ids")
            if ids is not None:
                ex_rec.classes = st.get("class_names", [])
                prep.ex_ids = np.full(bucket, -1, np.int32)
                prep.ex_ids[:len(ids)] = ids
            else:
                prep.ex_ids, ex_rec.classes = explain_mod.class_ids_for(
                    gt.nodes, bucket)
            prep.ex_ncls = explain_mod.class_pad(len(ex_rec.classes))
        prep.use_scan = use_scan
        prep.use_depth = use_depth
        prep.k_max = k_max
        prep.sp, prep.dp, prep.aff = sp, dp, aff
        prep.max_per_node = 1 if gt.distinct_hosts else 2 ** 30
        prep.spread_alg = spread_alg
        prep.depth_grid = None
        prep.jitter = None
        prep.bias_g = 1.0
        prep.m = 0.0
        if use_depth:
            # per-eval order jitter: the worker-decorrelation analog of
            # the host stack's 2-way sampling (see kernels.fill_depth).
            # The host's per-placement sampling width (stack.go:71-91):
            # best-of-2 for batch (power-of-two-choices), best-of-
            # ceil(log2(n)) for service. m = width*count/n is the
            # expected samples per node over the eval. Three regimes:
            #   * affinities: the reference raises its limit to >= 100
            #     (stack.go:170) — max-score, deterministic;
            #   * m > 3: repeated draws concentrate on the best nodes —
            #     effectively deterministic, so the density fill runs
            #     unjittered at full depth;
            #   * else: E-S weighted random order emulating best-of-w,
            #     with per-node depth capped at ceil(m)+1, ranked on the
            #     sampled DEPTH_GRID curve.
            n_feas = max(int(np.count_nonzero(gt.feasible)), 1)
            width = 2.0 if self.sched.batch else \
                max(2.0, float(np.ceil(np.log2(max(n_feas, 2)))))
            m = width * count / n_feas
            # the jitter array is ALWAYS drawn, whatever the regime, so
            # the per-eval rng stream advances the same way
            rng = np.random.default_rng(
                self.sched.stack.rng.getrandbits(64))
            prep.jitter = rng.random(gt.cap.shape[0], dtype=np.float32)
            if affinities or m > 3.0:
                prep.bias_g = 1.0
                prep.m = 0.0
            else:
                prep.bias_g = float(np.clip(
                    (width - 1.0) + max(m - 1.0, 0.0), 1.0, 8.0))
                prep.m = m
                from .kernels import DEPTH_GRID
                prep.depth_grid = tuple(
                    g for g in DEPTH_GRID if g <= k_max) or (1,)
        return prep

    def _depth_solve_args(self, prep, tg, count):
        """The normalized depth-kernel positional args for `count`
        instances (numpy arrays and host scalars; the backend moves them
        to the solve device)."""
        gt = prep.gt
        return (gt.cap, gt.used, gt.ask, np.int32(count), gt.feasible,
                gt.job_collisions, np.int32(tg.count), prep.aff,
                np.int32(prep.max_per_node), prep.jitter,
                np.float32(prep.bias_g), np.float32(prep.m))

    def _solve_group(self, tg, nodes, count: int, prep=None):
        """Run the batched kernel; returns [(node, count)] sorted
        best-first. `prep` reuses a declined pipeline's solve prep (same
        regime, same RNG stream position) instead of rebuilding it.

        The GenericStack feature matrix is tensorized: affinities,
        multiple/targeted spreads, distinct_property and distinct_hosts
        all lower to kernel inputs. Reschedules, migrations and canaries
        keep the host path (compute_placements routes them to
        `leftovers`)."""
        if prep is None:
            prep = self._prep_solve(tg, nodes, count)
        if prep is None:
            return []
        gt = prep.gt
        n = prep.n
        kernel = ("chunked" if prep.use_scan
                  else "depth" if prep.use_depth else "greedy")
        if prep.use_scan:
            placed_h = self._scan_dispatch(prep, tg, count)
        else:
            placed_h = self._dispatch(prep, tg, count)
        placed = placed_h[:n]
        if prep.use_scan and prep.distincts:
            placed = self._trim_distinct(prep, placed)
        if prep.ex is not None:
            # attribution describes the committed (trimmed) placements
            self._explain_tail(tg, prep, kernel, backend.tier(), placed)
        return self._placed_node_iter(gt.nodes, placed)

    def _explain_tail(self, tg, prep, kernel: str, tier: str,
                      placed) -> None:
        """Fold a solve's reduce over its host-resident placements (the
        serial solve's, trimmed where the scan overshot a quota, or the
        pipelined chunks' sum) into its explain record and register it.
        `tier` is the tier that served the solve."""
        gt = prep.gt
        prep.ex.tier = tier
        prep.ex.kernel = kernel
        try:
            with metrics.measure("nomad.solver.explain.seconds"):
                out = explain_mod.dispatch_reduce(gt, placed, prep.ex_ids,
                                                  prep.ex_ncls)
                prep.ex.absorb_reduce(out, gt, placed)
        except Exception:       # noqa: BLE001 — never fail the solve
            metrics.incr("nomad.solver.explain.errors")
        self._register_explain(tg, prep.ex)

    def _register_explain(self, tg, rec) -> None:
        """Retain the solve's explain record where its consumers find it:
        keyed per task group on the owning scheduler (a failure the
        host stack could not place either attaches rec.failed_metric
        instead of the stack's walk) and in the process-wide ring."""
        ex_map = getattr(self.sched, "solver_explains", None)
        if ex_map is None:
            ex_map = self.sched.solver_explains = {}
        ex_map[tg.name] = rec
        explain_mod.note(rec)

    @staticmethod
    def _dev_mats(gt, bname: str = ""):
        """The eval's rows of the state cache's twins (values identical to
        gt.cap/gt.used, already on the device) for a solve on tier
        `bname` — else None, and the solve takes the host copies. Where the
        cache handed back the resident twins (the fused or convex route
        was asked for) and the solve takes the classic route, the rows
        are gathered from them here, once per eval (the same device gather
        the cache runs otherwise). Twins of an older mesh generation are
        declined (their buffers may be of the dead mesh). Rows gathered
        from sharded twins stay row blocks for the sharded tier alone: a
        solo tier (a window, the pipelined chunks' fed-forward usage)
        takes the host copies, so no whole row set is assembled from the
        shards; solo twins serve a solo tier on the solve device and the
        sharded tier, which splits them."""
        if gt.gen is not None and gt.gen != sharding.generation():
            return None
        dev = _device.solve_device()
        if gt.cap_dev is None and gt.resident is not None and \
                gt.rows is not None and gt.resident[0].device == dev:
            from . import state_cache
            gt.cap_dev, gt.used_dev = state_cache.gather_twins(
                gt.resident, gt.rows, gt.cap.shape[0], gen=gt.gen)
        if gt.cap_dev is None or gt.used_dev is None or \
                gt.cap_dev.device != dev or \
                gt.cap_dev.shape[0] != gt.cap.shape[0]:
            return None
        if sharding.is_node_sharded(gt.cap_dev) and bname != "sharded":
            return None
        return gt.cap_dev, gt.used_dev

    def _convex_solve(self, kernel: str, prep, count: int):
        """The convex tier (ref placer._convex_solve): the eval's
        allocation as ONE projected-gradient solve over the state cache's
        resident twins — gather, iterate, round, fit verdict and greedy
        baseline on the device, brought back at one host sync
        (backend.select_convex). -> (placed_h padded, fit_h, tier), or
        None when the route declines: the algorithm or the kill switch
        is off, there are no resident twins (cache disabled, unversioned
        view, a stale view, in-plan corrections), or their generation or
        device differs from the solve's. The iteration-count and
        objective-gap gauges and the won/fell_back counters ride the same
        sync. A device error raises out of the eval (the chain counts it
        and feeds the breaker)."""
        cfg = self.ctx.scheduler_config
        if not backend.convex_enabled(
                cfg, cfg.effective_scheduler_algorithm()):
            return None
        res = self._resident(prep)
        if res is None:
            return None
        cap_res, used_res, idx, valid = res
        gt = prep.gt
        bucket = gt.cap.shape[0]
        # sharded twins feed the sharded convex solve in place
        # (sharding.sharded_convex), solo twins the solo one
        sel = backend.select_convex(
            kernel, bucket, spread_algorithm=prep.spread_alg,
            twins_device=cap_res.device,
            sharded_twins=sharding.is_node_sharded(cap_res),
            mesh_snap=prep.snap)
        if sel is None:
            return None
        tier, run = sel
        aff = (prep.aff if prep.aff is not None
               else np.zeros(bucket, np.float32))
        # per-tenant quota -> a hard budget cap for THIS eval's
        # placements: quota minus the namespace's current allocations
        quota = int(getattr(cfg, "solver_convex_namespace_quota", 0) or 0)
        if quota > 0:
            ns = getattr(self.sched.job, "namespace", "default")
            try:
                ns_used = self.state.namespace_alloc_counts().get(ns, 0)
            except AttributeError:
                ns_used = 0     # restored pre-knob state views
            budget = float(max(0, quota - ns_used))
        else:
            budget = float(2 ** 30)
        rest = (gt.ask, np.int32(count), gt.feasible,
                np.int32(prep.max_per_node), aff, gt.job_collisions,
                np.zeros(bucket, np.int32), np.bool_(gt.distinct_hosts),
                np.int32(getattr(cfg, "solver_convex_max_iters", 200)),
                np.float32(getattr(cfg, "solver_convex_tolerance", 1e-4)),
                np.float32(getattr(cfg, "solver_convex_fairness_weight",
                                   0.05)),
                np.float32(budget))
        # a sharded solve that loses a shard replays the eval's host rows
        # as the twins (idx the identity), never the twins it held
        host = (gt.cap, gt.used, np.arange(bucket, dtype=np.int32),
                valid) + rest
        # THE single sync of the convex eval: the chain's one copy to the
        # host (convex.to_host) brings placement, verdict, iteration count,
        # gap and the won flag back together
        # nomadlint: disable=SYNC001 — the designated single-sync seam
        placed_h, fit_h, iters, gap, won = run(
            cap_res, used_res, idx, valid, *rest, host_args=host)
        metrics.set_gauge("nomad.solver.convex.iterations", iters)
        metrics.set_gauge("nomad.solver.convex.objective_gap", float(gap))
        metrics.incr("nomad.solver.convex.won" if won
                     else "nomad.solver.convex.fell_back")
        return placed_h, fit_h, tier

    @staticmethod
    def _resident(prep):
        """(cap_res, used_res, idx, valid) for a solve over the state
        cache's resident twins: the eval's view rows as idx over its
        bucket, padding rows invalid. None where there are none (cache
        disabled, unversioned or stale view, in-plan corrections) or they
        are of another generation."""
        gt = prep.gt
        if gt.resident is None or gt.rows is None:
            return None
        if gt.gen is not None and gt.gen != sharding.generation():
            return None
        bucket = gt.cap.shape[0]
        idx = np.zeros(bucket, np.int32)
        idx[:prep.n] = gt.rows
        valid = np.zeros(bucket, bool)
        valid[:prep.n] = True
        return gt.resident + (idx, valid)

    def _fused_solve(self, kernel: str, prep, tg, count: int):
        """The whole-eval fused route (ref placer._fused_solve): the
        eval's gather, its depth or greedy solve and the plan-fit verdict
        on the device from the state cache's resident twins, brought back
        at ONE host sync (backend.select_fused). -> (placed_h padded,
        fit_h, tier), or None when the route declines: fusion is off
        (SchedulerConfiguration.solver_fused_enabled, NOMAD_SOLVER_FUSED),
        there are no resident twins (cache disabled, unversioned view, a
        stale view, in-plan corrections), or their generation or device
        differs from the solve's. Explain stays on the host (the program
        reduces no classes). A device error raises out of the eval (the
        chain counts it and feeds the breaker)."""
        if not backend.fused_enabled(self.ctx.scheduler_config):
            return None
        res = self._resident(prep)
        if res is None:
            return None
        cap_res, used_res, idx, valid = res
        gt = prep.gt
        sel = backend.select_fused(
            kernel, gt.cap.shape[0], count=count, k_max=prep.k_max,
            spread_algorithm=prep.spread_alg,
            depth_grid=prep.depth_grid if kernel == "depth" else None,
            twins_device=cap_res.device,
            sharded_twins=sharding.is_node_sharded(cap_res),
            mesh_snap=prep.snap)
        if sel is None:
            return None
        tier, run = sel
        # no explain classes: the program's class ids are never read
        dh = np.bool_(gt.distinct_hosts)
        if kernel == "depth":
            host = self._depth_solve_args(prep, tg, count)
            args = (cap_res, used_res, idx, valid) + host[2:] + (None, dh)
        else:
            host = (gt.cap, gt.used, gt.ask, np.int32(count), gt.feasible,
                    np.int32(prep.max_per_node))
            args = (cap_res, used_res, idx, valid, gt.ask, np.int32(count),
                    gt.feasible, np.int32(prep.max_per_node), None, dh,
                    gt.job_collisions)
        # THE single sync of the fused eval: the chain's one copy to the
        # host (cuda_kernels.fused_to_host) brings placement and verdict;
        # `host` is the classic route's inputs for a replay after a lost
        # shard (no verdict then: fit_h None)
        # nomadlint: disable=SYNC001 — the designated single-sync seam
        placed_h, fit_h = run(*args, host_args=host)
        return placed_h, fit_h, tier

    def _stamp_verdict(self, prep, placed: np.ndarray,
                       fit: np.ndarray) -> None:
        """Attach the convex or fused solve's plan-evaluate verdict to the
        eval's plan (ref placer._stamp_verdict): per view row, the verified ask
        k * ask at the solve's journal version for placed rows whose
        post-solve fit held. The applier takes it as a monotone fast
        path (plan_apply._shape_dense): a True row whose actual ask is
        elementwise <= the verified one fits at the same usage bits, so
        its dense re-compare is skipped; anything else re-checks. Solves
        of one plan at different journal versions void the stamp."""
        gt = prep.gt
        if gt.version < 0 or gt.rows is None or fit is None:
            return
        plan = self.plan
        sv = getattr(plan, "solver_verdict", None)
        if sv is not None and (sv.get("version") != gt.version or
                               sv.get("uid") != gt.uid or
                               sv.get("epoch") != gt.epoch):
            plan.solver_verdict = None
            return
        if sv is None:
            sv = plan.solver_verdict = {
                "version": gt.version, "uid": gt.uid, "epoch": gt.epoch,
                "rows": {}}
        ask = np.asarray(gt.ask, np.float32)
        for i in np.flatnonzero(placed > 0):
            if not fit[i]:
                continue
            row = int(gt.rows[i])
            if row in sv["rows"]:
                # two solves verified the same node independently: the
                # row re-checks normally
                del sv["rows"][row]
                continue
            sv["rows"][row] = np.float32(placed[i]) * ask

    def _dispatch(self, prep, tg, count: int) -> np.ndarray:
        """The solve through the backend's dispatch chain: the convex
        tier where it engages, else the fused route, else select the
        tier, launch (on the cache's twins where they served the eval),
        and bring the placement vector back at the one host sync."""
        gt = prep.gt
        kernel = "depth" if prep.use_depth else "greedy"
        cvx = self._convex_solve(kernel, prep, count)
        if cvx is None:
            cvx = self._fused_solve(kernel, prep, tg, count)
        if cvx is not None:
            placed_h, fit_h, bname = cvx
            backend.record(kernel, bname)
            self._stamp_verdict(prep, placed_h[:prep.n], fit_h)
            return placed_h
        if prep.use_depth:
            # `count` lets a small solve take the batch tier while other
            # evals are in flight (backend._batch_eligible)
            bname, fn = backend.select(
                "depth", gt.cap.shape[0], count=count, k_max=prep.k_max,
                spread_algorithm=prep.spread_alg,
                depth_grid=prep.depth_grid, mesh_snap=prep.snap)
            backend.record("depth", bname)
            args = self._depth_solve_args(prep, tg, count)
        else:
            bname, fn = backend.select("greedy", gt.cap.shape[0],
                                       mesh_snap=prep.snap)
            backend.record("greedy", bname)
            args = (gt.cap, gt.used, gt.ask, np.int32(count), gt.feasible,
                    np.int32(prep.max_per_node))
        dev = self._dev_mats(gt, bname)
        if dev is not None:
            metrics.incr("nomad.solver.state_cache.twin_dispatches")
            # a sharded rung that loses a shard replays the host arrays,
            # never the twins (they may be of the lost mesh)
            fn = functools.partial(fn, host_args=args)
            args = dev + args[2:]
        # the single device-to-host sync of the solve, inside the chain
        # nomadlint: disable=SYNC001 — the designated single-sync seam
        return fn(*args).numpy()

    def _scan_dispatch(self, prep, tg, count: int) -> np.ndarray:
        """The chunked scan through the backend's dispatch chain. One
        solve covers max_steps * min(N, 256) instances; larger asks split
        across solves that carry the running state (usage, placements,
        spread counts, distinct quotas) on the device, with one host sync
        of the placement total per extra solve. The placement vector
        reaches the host at the last solve's sync."""
        gt, sp, dp = prep.gt, prep.sp, prep.dp
        max_steps = 256
        cover = max_steps * min(gt.cap.shape[0], 256)
        bname, chunked_fn = backend.select(
            "chunked", gt.cap.shape[0], max_steps=max_steps,
            spread_algorithm=prep.spread_alg, mesh_snap=prep.snap)
        backend.record("chunked", bname)
        args = (gt.cap, gt.used, gt.ask, 0, gt.feasible, gt.job_collisions,
                np.int32(tg.count), sp.ids, sp.counts, sp.desired, sp.mode,
                sp.weights, prep.aff, dp.ids, dp.remaining,
                np.zeros((gt.cap.shape[0],), np.int32))
        dev = self._dev_mats(gt, bname)
        host = args
        if dev is not None:
            args = dev + args[2:]
            metrics.incr("nomad.solver.state_cache.twin_dispatches")
        if bname != "sharded":
            # every input on the device once; the carried state stays there
            args = backend.on_device("chunked", args)
        # (on the mesh the sharded scan splits the host arrays, or takes
        # the twins' row blocks in place; its carried usage and placements
        # stay row blocks on the shards)
        used, sp_counts, d_rem, placed = args[1], args[8], args[14], args[15]
        left = int(count)
        last_total = 0
        while True:
            a = (args[0], used, args[2], np.int32(min(left, cover)),
                 *args[4:8], sp_counts, *args[9:14], d_rem, placed,
                 np.int32(prep.max_per_node))
            # a sharded solve that loses a shard replays host arrays, never
            # the twins: the first solve its own inputs from the host
            run = functools.partial(
                chunked_fn, host_args=(host[:2] + a[2:]) if used is args[1]
                and bname == "sharded" else None)
            if left <= cover:   # one solve covers the rest of the ask
                # nomadlint: disable=SYNC001 — the scan's single-sync seam
                return run(*a, finish=lambda out: out[0].cpu().numpy())
            # a refill: only the placement total reaches the host
            (placed, used, sp_counts, d_rem), total = run(
                *a,
                # the refill's total: one sync per extra solve of an ask
                # past one solve's cover — nomadlint: disable=SYNC001
                finish=lambda out: (out, int(out[0].sum())))
            left = int(count) - total
            if left <= 0 or total == last_total:
                # done, or capacity exhausted
                with backend.host_sync():
                    # nomadlint: disable=SYNC001 — the scan's one sync
                    return placed.cpu().numpy()
            last_total = total

    @staticmethod
    def _trim_distinct(prep, placed: np.ndarray) -> np.ndarray:
        """A scan step places up to ceil(count/256) instances at once,
        which can overshoot a distinct_property value quota within that
        step: re-walk the counts best-first and trim the surplus (trimmed
        instances retry through the host fallback, which is exact)."""
        dp = prep.dp
        placed = np.array(placed)           # writable for the trim
        remaining = [row.copy() for row in dp.remaining]
        for i in np.argsort(-placed):
            k = int(placed[i])
            if k <= 0:
                continue
            allowed = k
            for d in range(len(prep.distincts)):
                vid = int(dp.ids[d, i])
                if vid < 0:
                    allowed = 0
                    break
                allowed = min(allowed, int(remaining[d][vid]))
            allowed = max(0, allowed)
            for d in range(len(prep.distincts)):
                vid = int(dp.ids[d, i])
                if vid >= 0:
                    remaining[d][vid] -= allowed
            placed[i] = allowed
        return placed

    @staticmethod
    def _placed_node_iter(nodes, placed: np.ndarray) -> list:
        """[(node, count)] best-first via columnar selection: one
        flatnonzero + one argsort over the PLACED rows only; node objects
        are only touched for the selected rows."""
        sel = np.flatnonzero(placed > 0)
        if not len(sel):
            return []
        sel = sel[np.argsort(-placed[sel], kind="stable")]
        return [(nodes[i], k)
                for i, k in zip(sel.tolist(), placed[sel].tolist())]

    # ------------------------------------------------ pipelined lifecycle

    def _pipeline_knobs(self) -> tuple[bool, int, int]:
        """-> (enabled, chunks, min_count) from the hot-reloadable
        scheduler config; NOMAD_PLAN_PIPELINE=0/1 force-overrides.
        getattr defaults keep restored pre-knob config snapshots valid."""
        cfg = self.ctx.scheduler_config
        enabled = bool(getattr(cfg, "plan_pipeline_enabled", True))
        env = os.environ.get("NOMAD_PLAN_PIPELINE", "")
        if env == "0":
            enabled = False
        elif env == "1":
            enabled = True
        # chunks=1 is honored as "stay serial" (validated as >= 1): a
        # one-chunk pipeline would commit nothing early
        chunks = max(1, int(getattr(cfg, "plan_pipeline_chunks", 4)))
        min_count = max(0, int(getattr(cfg, "plan_pipeline_min_count",
                                       8192)))
        return enabled and chunks >= 2, chunks, min_count

    def _pipeline_eligible(self, tg, missings, by_tg, leftovers) -> bool:
        """The pipelined lifecycle commits intermediate chunk plans while
        the eval is still running, so it only engages where that is
        provably equivalent to one big plan: a single simple task group
        whose plan carries nothing but these placements (no stops,
        updates, preemptions, deployments, annotations, all_at_once)."""
        enabled, _, min_count = self._pipeline_knobs()
        if not enabled or len(by_tg) != 1 or leftovers:
            return False
        if len(missings) < min_count or not self._is_simple(tg):
            return False
        plan = self.plan
        if plan.all_at_once or plan.annotations is not None:
            return False
        if plan.node_update or plan.node_allocation or plan.node_preemptions:
            return False
        if plan.deployment is not None or plan.deployment_updates:
            return False
        if self.sched.deployment is not None:
            return False
        return True

    def _pipelined_place(self, tg, nodes, missings, deployment_id: str):
        """Chunked solve + per-chunk materialize/evaluate/commit with all
        device dispatches queued up front. Returns (placed_count, prep);
        placed_count is None on a decline (scan-shaped or jittered
        solves, distinct_hosts, degenerate preps), and the serial path
        reuses `prep` so tensorize/shuffle/RNG draws never run twice.

        Timeline for C chunks (device work ▓, host work ░):

            device  ▓1▓▓2▓▓3▓▓4▓            (queued, usage fed forward)
            placer      ░mat 1░░mat 2░...    (materialize chunk N)
            applier       ░eval+commit 1░... (serial applier thread)

        Chunk N+1's solve consumes chunk N's placements via a device-side
        usage update, which is what committing chunk N does to the dense
        usage index — so per-chunk re-checks see no self-conflicts, and
        any CONCURRENT writer landing between chunk commits is caught by
        the applier's latest-state re-check exactly as on the serial path
        (the eval then refreshes and retries, ref plan_apply.go:638).

        A device error in chunk N — at its dispatch or when its result
        reaches the host — feeds the breaker and raises PipelineChunkError
        out of the eval once the chunks already submitted have resolved.
        The reference's degrade path, which re-solves the rest on the
        host, is not ported: card work never moves to the CPU."""
        sched = self.sched
        count = len(missings)
        _, n_chunks, _ = self._pipeline_knobs()
        with timing.timed("nomad.solver.solve", "solver.solve",
                          cpu="nomad.solver.solve_cpu", tg=tg.name,
                          count=count, pipelined=True):
            prep = self._prep_solve(tg, nodes, count)
            # deterministic full-curve depth solves only: the jittered
            # sampled-grid regime caps each SOLVE's per-node take at
            # ceil(m)+1, so C chunked solves could stack C times that cap
            # onto the jitter-favored nodes. distinct_hosts is the same
            # failure shape: max_per_node=1 binds per SOLVE, so C chunks
            # could land C same-job instances on one node — stay serial.
            if prep is None or not prep.use_depth or \
                    prep.depth_grid is not None or prep.gt.distinct_hosts:
                return None, prep
            bname, depth_fn = backend.select(
                "depth", prep.gt.cap.shape[0], k_max=prep.k_max,
                spread_algorithm=prep.spread_alg,
                depth_grid=prep.depth_grid, mesh_snap=prep.snap)
            backend.record("depth", bname)
            base = count // n_chunks
            chunk_counts = [base + (1 if i < count % n_chunks else 0)
                            for i in range(n_chunks)]
            chunk_counts = [c for c in chunk_counts if c > 0]
            # every input on the solve device once (the cache's twins where
            # they served the eval): chunk dispatches then copy nothing
            # and never wait for the chunks queued before them
            args = self._depth_solve_args(prep, tg, count)
            # the chunks feed usage forward as one tensor on the solve
            # device (the mesh's first): rows of sharded twins meet there,
            # and each sharded chunk splits them over the shards again
            dev = self._dev_mats(prep.gt)
            if dev is not None:
                args = dev + args[2:]
                metrics.incr("nomad.solver.state_cache.twin_dispatches")
            args = backend.on_device("depth", args)
            used_cur, coll_cur = args[1], args[5]
            chunks: list[_Chunk] = []
            with backend.async_dispatch():
                for ci, ccount in enumerate(chunk_counts):
                    a = (args[0], used_cur, args[2], np.int32(ccount),
                         args[4], coll_cur) + args[6:]
                    try:
                        placed = depth_fn(*a)
                    except backend.device_error_types() as e:
                        # the chain has fed the breaker
                        raise PipelineChunkError(
                            f"eval {sched.eval.id[:8]}: chunk {ci} of "
                            f"{len(chunk_counts)} failed to dispatch on "
                            f"{bname}: {e}") from e
                    chunks.append(_Chunk(placed))
                    if ci < len(chunk_counts) - 1:
                        used_cur, coll_cur = _usage_update(
                            used_cur, coll_cur, placed, args[2])
        # host side of the pipeline: ids/names/shared objects are built
        # while chunk 1 is still in flight on the device
        host_t0 = time.perf_counter()
        shared, ids, names, prev_ids = self._prepare_stamp(
            missings, tg, deployment_id)
        plan = self.plan
        submit_async = getattr(sched.planner, "submit_plan_async", None)
        pendings = []            # (chunk_plan, pending) in submit order
        results = []             # (chunk_plan, result) once resolved
        last_chunk = chunks[-1]
        last_pending = None
        prep_s = time.perf_counter() - host_t0
        metrics.add_sample("nomad.plan.pipeline.host", prep_s)
        if _in_flight(last_chunk):
            metrics.add_sample("nomad.plan.pipeline.overlap", prep_s)
        mi = 0
        chunk_done: list = []    # materialized padded chunk results
        for ci, chunk in enumerate(chunks):
            with timing.timed("nomad.solver.solve", "solver.solve",
                              cpu="nomad.solver.solve_cpu", tg=tg.name,
                              chunk=ci):
                try:
                    with backend.host_sync():
                        # the pipeline's designed per-chunk sync point
                        # nomadlint: disable=SYNC001 — chunk seam
                        placed_pad = chunk.numpy()
                except backend.device_error_types() as e:
                    backend.note_dispatch_failure(bname, e)
                    # the chunks already submitted resolve first, so the
                    # applier holds nothing of this eval when it fails
                    for _, pending in pendings:
                        pending.wait(60.0)
                    raise PipelineChunkError(
                        f"eval {sched.eval.id[:8]}: chunk {ci} of "
                        f"{len(chunks)} failed on the device: {e}") from e
                # async dispatch defers breaker feedback to HERE: only a
                # result on the host proves the card healthy
                backend.breaker_record(bname, ok=True)
                chunk_done.append(placed_pad)
                placed = np.array(placed_pad[:prep.n])
            host_t0 = time.perf_counter()
            solves_behind = ci < len(chunks) - 1 and _in_flight(last_chunk)
            is_last = ci == len(chunks) - 1
            node_iter = self._placed_node_iter(prep.gt.nodes, placed)
            target = plan.node_allocation if is_last else {}
            with timing.timed("nomad.solver.materialize",
                              "solver.materialize", tg=tg.name,
                              pipelined=True):
                mi = self._stamp_slice(shared, ids, names, prev_ids,
                                       node_iter, mi, len(missings), target)
            if not is_last and target:
                cplan = Plan(eval_id=plan.eval_id,
                             eval_token=plan.eval_token,
                             priority=plan.priority, job=plan.job,
                             snapshot_index=plan.snapshot_index)
                cplan.node_allocation = target
                if submit_async is not None:
                    last_pending = submit_async(cplan)
                    pendings.append((cplan, last_pending))
                else:
                    results.append((cplan, sched.planner.submit_plan(cplan)))
            applier_behind = (last_pending is not None
                              and not last_pending.event.is_set())
            host_s = time.perf_counter() - host_t0
            metrics.add_sample("nomad.plan.pipeline.host", host_s)
            if solves_behind or applier_behind:
                metrics.add_sample("nomad.plan.pipeline.overlap", host_s)
        metrics.incr("nomad.plan.pipeline.evals")
        metrics.incr("nomad.plan.pipeline.chunks", len(chunks))
        # collect every async chunk result BEFORE returning: the eval's
        # final plan is submitted by the normal path, which in test shims
        # may apply inline — commit order must stay chunk 1..C-1, final
        for cplan, pending in pendings:
            result, err = pending.wait(60.0)
            results.append((cplan, None if err else result))
        partial = False
        for cplan, result in results:
            if result is None:
                partial = True
                continue
            full, _, _ = result.full_commit(cplan)
            if not full:
                partial = True
        if partial:
            # a chunk under-committed (concurrent writer won a node, or a
            # submit failed): flag the eval so _process refreshes state
            # and retries the remainder — the serial path's partial-
            # commit semantics, applied per chunk
            sched._pipeline_partial = True
        if prep.ex is not None:
            # pipelined attribution: the reduce runs over the SUMMED
            # chunk placements (all on the host by now), so the record
            # describes the whole eval's post-solve state
            total = np.sum(chunk_done, axis=0, dtype=np.int32)
            self._explain_tail(tg, prep, "depth", bname, total[:prep.n])
        return mi, prep

    def _distinct_property_sets(self, tg):
        """PropertySets for every distinct_property constraint in scope
        (ref feasible.go:604 DistinctPropertyIterator)."""
        from ..scheduler.propertyset import PropertySet
        from ..structs import OP_DISTINCT_PROPERTY
        job = self.sched.job
        sets = []
        for c in job.constraints:
            if c.operand == OP_DISTINCT_PROPERTY:
                ps = PropertySet(self.ctx, job)
                ps.set_job_constraint(c)
                sets.append(ps)
        for c in tg.constraints:
            if c.operand == OP_DISTINCT_PROPERTY:
                ps = PropertySet(self.ctx, job)
                ps.set_tg_constraint(c, tg.name)
                sets.append(ps)
        return sets

    def _feasibility_fn(self, tg):
        """Irregular host-side checks with per-class caching — the solver's
        escape hatch for non-tensorizable constraints."""
        stack = self.sched.stack
        from ..scheduler.stack import _task_group_constraints
        drivers, constraints = _task_group_constraints(tg)
        stack.tg_drivers.set_drivers(drivers)
        stack.tg_constraint.set_constraints(constraints)
        stack.tg_devices.set_task_group(tg)
        job = self.sched.job
        stack.tg_host_volumes.set_volumes("", tg.volumes)
        stack.tg_csi_volumes.set_volumes(
            tg.volumes, job.namespace if job else "default",
            job_id=job.id if job else "")
        stack.tg_network.set_network(tg.networks[0] if tg.networks else None)
        elig = self.ctx.eligibility
        job_checks = [stack.job_constraint]
        tg_checks = [stack.tg_drivers, stack.tg_constraint,
                     stack.tg_host_volumes, stack.tg_devices,
                     stack.tg_network, stack.tg_csi_volumes]

        from ..scheduler.context import (
            EVAL_COMPUTED_CLASS_ELIGIBLE, EVAL_COMPUTED_CLASS_INELIGIBLE,
            EVAL_COMPUTED_CLASS_UNKNOWN)

        ctx = self.ctx

        def feasible(node) -> bool:
            klass = node.computed_class
            # cached-ineligible fast paths count "computed class
            # ineligible" exactly like the host FeasibilityWrapper — but
            # ONLY into the explain scratch metric the tensorize walk
            # runs against: later re-walks over the same closure (the
            # preemption pass's candidate filter) must not double-count
            # into the live eval-wide metric
            record = getattr(ctx.metrics, "explain_walk", False)
            st = elig.job_status(klass)
            if st == EVAL_COMPUTED_CLASS_INELIGIBLE:
                if record:
                    ctx.metrics.filter_node(node,
                                            "computed class ineligible")
                return False
            if st != EVAL_COMPUTED_CLASS_ELIGIBLE:
                ok = all(c.feasible(node) for c in job_checks)
                if st == EVAL_COMPUTED_CLASS_UNKNOWN:
                    elig.set_job_eligibility(ok, klass)
                if not ok:
                    return False
            st = elig.task_group_status(tg.name, klass)
            if st == EVAL_COMPUTED_CLASS_INELIGIBLE:
                if record:
                    ctx.metrics.filter_node(node,
                                            "computed class ineligible")
                return False
            if st != EVAL_COMPUTED_CLASS_ELIGIBLE:
                ok = all(c.feasible(node) for c in tg_checks)
                if st == EVAL_COMPUTED_CLASS_UNKNOWN:
                    elig.set_task_group_eligibility(ok, tg.name, klass)
                if not ok:
                    return False
            return True

        return feasible

    # ------------------------------------------------- batched preemption

    def _preempt_batch(self, tg, missings, deployment_id: str) -> list:
        """Batched preemption: victim selection runs as one masked pass
        over every candidate node (kernels.preempt_top_k); each winning
        node is then verified exactly host-side with allocs_fit before its
        victims enter the plan. Returns the missings still unplaced
        (non-simple TGs skip straight to the host fallback, which retries
        with the scalar Preemptor)."""
        from ..state.usage_index import (
            alloc_usage_tuple, node_capacity_tuple,
        )
        from ..structs import OP_DISTINCT_HOSTS, allocs_fit
        from .kernels import NUM_XR
        from .tensorize import group_ask_row

        sched = self.sched
        cfg = self.ctx.scheduler_config.preemption_config
        enabled = (cfg.batch_scheduler_enabled if sched.batch
                   else cfg.service_scheduler_enabled)
        if not enabled or not missings or not self._is_simple(tg):
            return missings
        job_prio = sched.job.priority

        distinct_hosts = any(
            c.operand == OP_DISTINCT_HOSTS
            for c in list(sched.job.constraints) + list(tg.constraints))
        distinct_sets = self._distinct_property_sets(tg)

        feasible_fn = self._feasibility_fn(tg)
        candidates = []          # (node, proposed, victims)
        max_v = 0
        for node in sched._ready_nodes:
            if not feasible_fn(node):
                continue
            proposed = self.ctx.proposed_allocs(node.id)
            # distinct_hosts: a node already running this job+TG is out
            if distinct_hosts and any(
                    a.job_id == sched.job.id and a.task_group == tg.name
                    for a in proposed):
                continue
            # distinct_property value quotas (plan-aware via PropertySet)
            if any(not ps.satisfies_distinct_properties(node)[0]
                   for ps in distinct_sets):
                continue
            victims = [a for a in proposed
                       if (a.job.priority if a.job else 50) < job_prio]
            if victims:
                candidates.append((node, proposed, victims))
                max_v = max(max_v, len(victims))
        if not candidates:
            return missings

        c = len(candidates)
        v_pad = pow2(max_v)             # victim axis shares the bucketing
        victim_res = np.zeros((c, v_pad, NUM_XR), np.float32)
        victim_prio = np.full((c, v_pad), 2 ** 20, np.int32)  # pad: ineligible
        free = np.zeros((c, NUM_XR), np.float32)
        for i, (node, proposed, victims) in enumerate(candidates):
            for j, a in enumerate(victims):
                victim_res[i, j] = alloc_usage_tuple(a)
                victim_prio[i, j] = a.job.priority if a.job else 50
            free[i] = np.asarray(node_capacity_tuple(node), np.float32)
            for a in proposed:
                free[i] -= alloc_usage_tuple(a)
        ask = group_ask_row(tg)

        masks = self._preempt_masks(victim_res, victim_prio, ask, free,
                                    job_prio)

        # fewest-victims nodes first (minimal disruption, the
        # PreemptionScoringIterator's preference, ref rank.go:775)
        order = sorted(range(c), key=lambda i: (masks[i].sum() == 0,
                                                int(masks[i].sum())))
        remaining = list(missings)
        # ONE trial alloc probes every candidate node: the ask is the
        # group's pooled resource skeleton, identical per instance
        ask_alloc = Allocation(
            allocated_resources=skeleton_for(self._skel, tg,
                                             False).shared_total)
        for i in order:
            if not remaining:
                break
            if not masks[i].any():
                continue
            node, proposed, victims = candidates[i]
            # re-check distinct quotas: placements earlier in this loop
            # shifted the plan-aware counts (used_counts reads the plan)
            if any(not ps.satisfies_distinct_properties(node)[0]
                   for ps in distinct_sets):
                continue
            chosen = [victims[j] for j in range(len(victims)) if masks[i][j]]
            chosen_ids = {a.id for a in chosen}
            trial = [a for a in proposed if a.id not in chosen_ids] + \
                [ask_alloc]
            fit, _, _ = allocs_fit(node, trial)
            if not fit:
                continue                # device said yes, exact said no
            missing = remaining.pop(0)
            if self._place_one(missing, tg, node, deployment_id):
                for victim in chosen:
                    self.plan.append_preempted_alloc(victim, sched.eval.id)
            else:
                remaining.insert(0, missing)
        rec = getattr(sched, "solver_explains", {}).get(tg.name)
        if rec is not None:
            # preemption candidacy (explain stage 5): how many candidate
            # nodes the victim scan considered, how many produced a
            # viable victim set, and how many placements it rescued
            rec.preempt_candidates = c
            rec.preempt_with_victims = int(masks.any(axis=1).sum())
            rec.preempt_placed = len(missings) - len(remaining)
        return remaining

    @staticmethod
    def _preempt_masks(victim_res, victim_prio, ask, free,
                       job_prio) -> np.ndarray:
        """Victim-mask solve over all candidate nodes -> bool[C, V]: one
        kernels.preempt_top_k pass through the backend's dispatch chain,
        brought to the host at preemption's own sync (the masks gate an
        exact host verify; nothing overlaps them). A device error raises
        out of the eval (one rung, backend.py). From PREEMPT_SHARD_MIN
        candidates on a mesh the candidate axis shards over it
        (sharding.sharded_preempt_top_k: each shard scans its own
        candidates), and a lost shard replays the identical scan on the
        survivors."""
        _, fn = backend.select_preempt(
            victim_res.shape[0] >= PREEMPT_SHARD_MIN)
        # nomadlint: disable=SYNC001 — preemption sync seam
        return fn(victim_res, victim_prio, ask, free,
                  np.int32(job_prio)).numpy()

    # ------------------------------------------- batched alloc materialization

    @staticmethod
    def _is_simple(tg) -> bool:
        """No sequential per-node resources: nothing for the exact host pass
        to assign, so placement counts translate directly to allocations."""
        if tg.networks:
            return False
        for t in tg.tasks:
            r = t.resources
            if r.networks or r.devices or r.cores > 0:
                return False
        return True

    def _prepare_stamp(self, missings, tg, deployment_id: str):
        """Placed-independent stamping inputs for a TG's placements —
        shared resource/metrics objects plus batch-minted ids and name
        columns. Built once per TG."""
        from ..scheduler.reconcile import AllocPlaceResult
        sched = self.sched
        oversub = self.ctx.scheduler_config.memory_oversubscription_enabled
        # pooled skeleton: the shared AllocatedResources all instances of
        # the TG point at
        total = skeleton_for(self._skel, tg, oversub).shared_total
        metrics_obj = self.ctx.metrics.copy()
        rec = getattr(sched, "solver_explains", {}).get(tg.name)
        if rec is not None:
            # `alloc status` explainability: the walk's filter counts plus
            # the winning rows' score metadata ride the shared metrics
            # object every stamped alloc points at
            rec.enrich_placed_metric(metrics_obj)
        shared = {"namespace": sched.eval.namespace,
                  "eval_id": sched.eval.id,
                  "job_id": sched.eval.job_id, "job": self.plan.job,
                  "task_group": tg.name, "allocated_resources": total,
                  "metrics": metrics_obj,
                  "deployment_id": deployment_id}
        n_missing = len(missings)
        ids = new_ids(n_missing)
        names = [None] * n_missing
        prev_ids = [""] * n_missing
        for i, missing in enumerate(missings):
            if isinstance(missing, AllocPlaceResult):
                names[i] = missing.name
            else:
                names[i] = missing.place_name
                prev_ids[i] = missing.stop_alloc.id
        return shared, ids, names, prev_ids

    def _stamp_slice(self, shared, ids, names, prev_ids, node_iter,
                     mi: int, n_missing: int, node_allocation: dict) -> int:
        """Stamp allocations for `node_iter` placement counts, consuming
        missings[mi:] and merging into a plan-shaped node_allocation dict.
        Returns the new mi. Ids are minted in one batch, the node columns
        are materialized as flat per-index lists, and the Allocation
        objects are stamped by structs/fastbatch.py. All instances share
        the resource / metrics / default objects (immutable by convention
        — the state store's update paths copy before mutating)."""
        start = mi
        node_ids: list[str] = []
        node_names: list[str] = []
        slices: list[tuple[str, int, int]] = []
        for node, k in node_iter:
            if mi >= n_missing:
                break
            take = min(int(k), n_missing - mi)
            slices.append((node.id, mi - start, mi - start + take))
            node_ids.extend([node.id] * take)
            node_names.extend([node.name] * take)
            mi += take
        if mi == start:
            return mi
        from ..structs.fastbatch import stamp_batch
        allocs = stamp_batch(
            Allocation, mi - start,
            shared=shared,
            varying={"id": ids[start:mi], "name": names[start:mi],
                     "node_id": node_ids, "node_name": node_names,
                     "previous_allocation": prev_ids[start:mi]})
        for node_id, s, e in slices:
            bucket = node_allocation.get(node_id)
            if bucket is None:
                node_allocation[node_id] = allocs[s:e]
            else:
                bucket.extend(allocs[s:e])
        return mi

    def _place_batch_simple(self, missings, tg, node_iter,
                            deployment_id: str) -> int:
        """Stamp out allocations for solver placement counts in one pass.
        All instances of a TG are identical, so they share ONE
        AllocatedResources and ONE metrics object."""
        shared, ids, names, prev_ids = self._prepare_stamp(
            missings, tg, deployment_id)
        return self._stamp_slice(shared, ids, names, prev_ids, node_iter,
                                 0, len(missings), self.plan.node_allocation)

    # ------------------------------------------------- exact host assignment

    def _place_one(self, missing, tg, node, deployment_id: str) -> bool:
        """Exact sequential-resource assignment on the chosen node (ports,
        devices, cores) and plan append. Returns False if the node rejects."""
        from ..scheduler.reconcile import AllocPlaceResult
        sched = self.sched
        name = (missing.name if isinstance(missing, AllocPlaceResult)
                else missing.place_name)
        prev = (missing.previous_alloc
                if isinstance(missing, AllocPlaceResult)
                else missing.stop_alloc)

        proposed = self.ctx.proposed_allocs(node.id)
        net_idx = NetworkIndex()
        net_idx.set_node(node)
        net_idx.add_allocs(proposed)

        from ..scheduler.device import DeviceAllocator
        dev_alloc = DeviceAllocator(self.ctx, node)
        dev_alloc.add_allocs(proposed)

        # copy-on-write materialization: the pooled skeleton seeds every
        # task row; only tasks carrying SEQUENTIAL per-alloc state
        # (ports/devices/cores) are rebuilt below
        oversub = self.ctx.scheduler_config.memory_oversubscription_enabled
        skel = skeleton_for(self._skel, tg, oversub)
        total = skel.materialize()
        if tg.networks:
            offer, err = net_idx.assign_network(tg.networks[0])
            if offer is None:
                return False
            net_idx.add_reserved(offer)
            total.shared.networks = [offer]
            total.shared.ports = [
                {"label": p.label, "value": p.value, "to": p.to,
                 "host_ip": offer.ip}
                for p in offer.reserved_ports + offer.dynamic_ports]
        for task in tg.tasks:
            if not skel.task_is_sequential(task.name):
                continue            # shared CoW row already seeded
            # genuinely per-alloc: the assigned ports/devices/cores below
            # differ per instance — nomadlint: disable=PERF001
            tr = AllocatedTaskResources(
                cpu_shares=task.resources.cpu,
                memory_mb=task.resources.memory_mb)
            if oversub:
                tr.memory_max_mb = task.resources.memory_max_mb
            if task.resources.networks:
                offer, err = net_idx.assign_network(task.resources.networks[0])
                if offer is None:
                    return False
                net_idx.add_reserved(offer)
                tr.networks = [offer]
            for req in task.resources.devices:
                offer_dev, _, err = dev_alloc.assign_device(req)
                if offer_dev is None:
                    return False
                dev_alloc.add_reserved(offer_dev)
                tr.devices.append(offer_dev)
            if task.resources.cores > 0:
                node_cores = set(node.node_resources.cpu.reservable_cores)
                taken = set()
                for a in proposed:
                    taken |= set(a.comparable_resources().reserved_cores)
                for assigned in total.tasks.values():
                    taken |= set(assigned.reserved_cores)
                avail = sorted(node_cores - taken)
                if len(avail) < task.resources.cores:
                    return False
                tr.reserved_cores = tuple(avail[:task.resources.cores])
            total.tasks[task.name] = tr

        alloc = Allocation(
            id=new_id(),
            namespace=sched.eval.namespace,
            eval_id=sched.eval.id,
            name=name,
            job_id=sched.eval.job_id,
            task_group=tg.name,
            metrics=self.ctx.metrics.copy(),
            node_id=node.id,
            node_name=node.name,
            deployment_id=deployment_id,
            allocated_resources=total,
            desired_status="run",
            client_status="pending",
        )
        if prev is not None:
            alloc.previous_allocation = prev.id
            if isinstance(missing, AllocPlaceResult) and missing.reschedule:
                sched._update_reschedule_tracker(alloc, prev)
        if deployment_id and isinstance(missing, AllocPlaceResult) and \
           missing.canary:
            alloc.deployment_status = AllocDeploymentStatus(canary=True)
            if self.plan.deployment is not None:
                ds = self.plan.deployment.task_groups.get(tg.name)
                if ds is not None:
                    ds.placed_canaries.append(alloc.id)
        self.plan.append_alloc(alloc, None)
        return True

    def _failed_metric(self, tg) -> AllocMetric:
        """The AllocMetric a failed placement reports. When the solve
        explained this task group, materialize ITS attribution instead of
        whatever the fallback stack's last reset-and-re-walk left in
        ctx.metrics. Task groups that never reached the solve
        (reschedules, canaries) keep the stack's own metric."""
        rec = getattr(self.sched, "solver_explains", {}).get(tg.name)
        if rec is not None:
            if not rec.rejected:
                rec.rejected = True
                metrics.incr("nomad.solver.explain.rejections")
            return rec.failed_metric(dict(self.sched._nodes_by_dc))
        return self.sched.ctx.metrics.copy()

    def _fallback(self, leftovers, deployment_id: str) -> bool:
        """Per-alloc stack selection for what batching couldn't handle."""
        from ..scheduler.reconcile import AllocPlaceResult
        sched = self.sched
        for missing in leftovers:
            tg = (missing.task_group if isinstance(missing, AllocPlaceResult)
                  else missing.place_task_group)
            name = (missing.name if isinstance(missing, AllocPlaceResult)
                    else missing.place_name)
            prev = (missing.previous_alloc
                    if isinstance(missing, AllocPlaceResult)
                    else missing.stop_alloc)
            tg, place_job, place_dep_id = sched.resolve_placement_job(
                missing, tg, deployment_id)
            if place_job is not None:
                sched.stack.set_job(place_job)
            options = SelectOptions(alloc_name=name)
            if prev is not None:
                options.penalty_node_ids = {prev.node_id}
            option = sched._select_next_option(tg, options)
            if place_job is not None:
                sched.stack.set_job(sched.job)
            sched.ctx.metrics.nodes_available = dict(sched._nodes_by_dc)
            if option is None:
                is_destructive = not isinstance(missing, AllocPlaceResult)
                if is_destructive:
                    self.plan.pop_update(prev)
                    sched.queued_allocs[tg.name] = \
                        sched.queued_allocs.get(tg.name, 0) - 1
                sched.failed_tg_allocs[tg.name] = self._failed_metric(tg)
                continue
            sched._handle_preemptions(option)
            # the stack's ranked task_resources genuinely vary per option
            # (penalized nodes, assigned ports) so the wrapper is
            # per-alloc; the disk-only shared row is pooled
            # nomadlint: disable=PERF001 — wrapper differs per alloc
            resources = AllocatedResources(
                tasks=dict(option.task_resources),
                shared=option.alloc_resources or
                skeleton_for(self._skel, tg, False).shared_total.shared)
            alloc = Allocation(
                id=new_id(), namespace=sched.eval.namespace,
                eval_id=sched.eval.id, name=name, job_id=sched.eval.job_id,
                task_group=tg.name, metrics=sched.ctx.metrics.copy(),
                node_id=option.node.id, node_name=option.node.name,
                deployment_id=place_dep_id, allocated_resources=resources,
                desired_status="run", client_status="pending")
            if prev is not None:
                alloc.previous_allocation = prev.id
                if isinstance(missing, AllocPlaceResult) and \
                        missing.reschedule:
                    # the tracker must carry across generations on the
                    # solver path too, or attempts never exhaust and the
                    # penalty set forgets prior failed nodes
                    sched._update_reschedule_tracker(alloc, prev)
            if place_dep_id and isinstance(missing, AllocPlaceResult) and \
                    missing.canary:
                alloc.deployment_status = AllocDeploymentStatus(canary=True)
                if self.plan.deployment is not None:
                    ds = self.plan.deployment.task_groups.get(tg.name)
                    if ds is not None:
                        ds.placed_canaries.append(alloc.id)
            self.plan.append_alloc(alloc, place_job)
        return True
