"""SolverPlacer: the bridge between GenericScheduler and the batched
solver on the card — the SchedulerAlgorithm="tpu-batch" implementation
(north star, BASELINE.json). Counterpart of nomad_tpu/solver/placer.py,
serial route only.

Division of labor:
  * device: feasibility-masked capacity + scoring + placement counts over
    the whole node axis at once (no log2(N) sampling — the full matrix),
    through the hand kernels (backend.select);
  * host: exact sequential resources for the chosen nodes only — ports via
    NetworkIndex, device instances, cpuset cores — with per-node retry.

Each task group's solve runs once and reaches the host at one sync; its
placements go into the eval's single plan, which the scheduler submits to
the serial plan applier.
"""
from __future__ import annotations

import numpy as np

from ..metrics import metrics
from ..structs import (
    AllocatedResources, AllocatedTaskResources, Allocation,
    AllocDeploymentStatus, NetworkIndex, new_id, new_ids, skeleton_for,
)
from ..scheduler.stack import SelectOptions
from . import backend, roundtrip
from ..obs import trace
from .buckets import node_bucket
from .tensorize import build_group_tensors, _lower_affinities


class _SolvePrep:
    """Per-(eval, TG) solve setup: shuffled+padded tensors, kernel routing
    and the depth-regime parameters."""
    __slots__ = ("gt", "n", "use_scan", "use_depth", "k_max",
                 "aff", "max_per_node", "spread_alg", "depth_grid",
                 "jitter", "bias_g", "m")


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
        # per-eval host↔device transition accounting: every dispatch
        # seam notes itself; the total lands in the
        # nomad.solver.device_round_trips histogram at eval exit
        roundtrip.begin()
        try:
            return self._compute_placements(destructive, place)
        finally:
            roundtrip.end()
            backend.breaker_release_all()

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
            # serial path only: the pipelined plan lifecycle, the fused
            # and convex routes and eval micro-batching are not ported
            with metrics.measure("nomad.solver.solve"), \
                    trace.span("solver.solve", tg=tg_name,
                               count=len(missings)):
                placed_map = self._solve_group(tg, nodes, len(missings))
            if placed_map is None:
                # scan-shaped group (spreads, distinct_property, or deeper
                # than the [N, K] curve): the chunked scan is not ported,
                # so the host GenericStack places it in _fallback
                leftovers.extend(missings)
                continue
            node_iter = [(node, k) for node, k in placed_map if k > 0]
            # TGs with no sequential resources (ports/devices/cores)
            # need no per-alloc exact pass: stamp out the allocations
            # in one batch with shared (immutable-by-convention)
            # resource/metric objects
            with metrics.measure("nomad.solver.materialize"), \
                    trace.span("solver.materialize", tg=tg_name):
                if node_iter and self._is_simple(tg):
                    mi = self._place_batch_simple(missings, tg, node_iter,
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
            metrics.incr("nomad.solver.placements_batched",
                         len(missings) - len(rest))
            # capacity exhausted: the batched preemption pass is not
            # ported, so the host stack (with its scalar Preemptor) gets
            # what is left
            leftovers.extend(rest)

        # host fallback for anything the batched pass couldn't place
        # (port-exhausted nodes, sticky disks, canaries with preferred
        # nodes, scan-shaped groups, preemption); rate logged per eval
        total = len(list(destructive)) + len(list(place))
        sched.solver_stats = {"total": total, "host_fallback": len(leftovers)}
        metrics.incr("nomad.solver.placements_total", total)
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
        """Everything a depth/greedy solve needs BEFORE the kernel call:
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
        # explain is not ported: the lowering records no attribution
        with metrics.measure("nomad.solver.tensorize"):
            gt = build_group_tensors(self.ctx, job, tg, nodes, feasible_fn,
                                     count=count)
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

        prep = _SolvePrep()
        prep.use_scan = use_scan
        prep.use_depth = use_depth
        if use_scan:
            return prep                # _solve_group hands it to the host
        aff = _lower_affinities(self.ctx, affinities, nodes) \
            if use_depth else None

        # pad the node axis to the shared pow2 bucket (buckets.node_bucket)
        # so the kernels see one shape per bucket, not one per cluster
        # size; padding rows are infeasible and can never be chosen
        n = gt.cap.shape[0]
        padded = node_bucket(n)
        if padded != n:
            pad = padded - n
            gt.cap = np.pad(gt.cap, ((0, pad), (0, 0)))
            gt.used = np.pad(gt.used, ((0, pad), (0, 0)))
            gt.feasible = np.pad(gt.feasible, (0, pad))
            gt.job_collisions = np.pad(gt.job_collisions, (0, pad))
            if aff is not None:
                aff = np.pad(aff, (0, pad))
        prep.gt = gt
        prep.n = n
        prep.k_max = k_max
        prep.aff = aff
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

    def _solve_group(self, tg, nodes, count: int):
        """Run the batched kernel; returns [(node, count)] sorted
        best-first, or None for a scan-shaped group the host stack must
        place (the chunked scan is not ported)."""
        prep = self._prep_solve(tg, nodes, count)
        if prep is None:
            return []
        if prep.use_scan:
            return None
        gt = prep.gt
        n = prep.n
        metrics.incr(
            "nomad.solver.kernel.fill_depth" if prep.use_depth
            else "nomad.solver.kernel.fill_greedy_binpack")
        with metrics.measure("nomad.solver.device"):
            placed_h = self._dispatch(prep, tg, count)
        return self._placed_node_iter(gt.nodes, placed_h[:n])

    def _dispatch(self, prep, tg, count: int) -> np.ndarray:
        """The solve on the device: select the tier, launch, and bring the
        placement vector back at the one host sync."""
        gt = prep.gt
        if prep.use_depth:
            bname, depth_fn = backend.select(
                "depth", gt.cap.shape[0], k_max=prep.k_max,
                spread_algorithm=prep.spread_alg,
                depth_grid=prep.depth_grid)
            backend.record("depth", bname)
            placed = depth_fn(*self._depth_solve_args(prep, tg, count))
        else:
            bname, greedy = backend.select("greedy", gt.cap.shape[0])
            backend.record("greedy", bname)
            placed = greedy(gt.cap, gt.used, gt.ask, np.int32(count),
                            gt.feasible, np.int32(prep.max_per_node))
        # the single device-to-host sync of the solve
        return placed.cpu().numpy()

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

        def feasible(node) -> bool:
            klass = node.computed_class
            st = elig.job_status(klass)
            if st == EVAL_COMPUTED_CLASS_INELIGIBLE:
                return False
            if st != EVAL_COMPUTED_CLASS_ELIGIBLE:
                ok = all(c.feasible(node) for c in job_checks)
                if st == EVAL_COMPUTED_CLASS_UNKNOWN:
                    elig.set_job_eligibility(ok, klass)
                if not ok:
                    return False
            st = elig.task_group_status(tg.name, klass)
            if st == EVAL_COMPUTED_CLASS_INELIGIBLE:
                return False
            if st != EVAL_COMPUTED_CLASS_ELIGIBLE:
                ok = all(c.feasible(node) for c in tg_checks)
                if st == EVAL_COMPUTED_CLASS_UNKNOWN:
                    elig.set_task_group_eligibility(ok, tg.name, klass)
                if not ok:
                    return False
            return True

        return feasible

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
                sched.failed_tg_allocs[tg.name] = \
                    self.sched.ctx.metrics.copy()
                continue
            sched._handle_preemptions(option)
            # the stack's ranked task_resources genuinely vary per option
            # (penalized nodes, assigned ports) so the wrapper is
            # per-alloc; the disk-only shared row is pooled
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
