"""Serial plan applier + plan queue (ref nomad/plan_apply.go:71 planApply,
nomad/plan_queue.go) with cross-eval commit coalescing (ISSUE 5).

The optimistic-concurrency heart of the design (kept untouched per the
north star): workers submit plans computed against possibly-stale snapshots;
the leader-serial applier re-checks every touched node against latest state
(ref :638 evaluateNodePlan) and commits only the slices that still fit.
Workers see rejections in the PlanResult and retry with a fresher snapshot.

Commit coalescing (Tesserae's observation that placement pipelines are
throughput-bound on the commit path): the applier drains up to
`plan_commit_batch_max` verified pending plans per cycle and lands them as
ONE raft entry / FSM batch apply — one payload encode, one shared
`snapshot_min_index` fetch, one `state_cache.note_commit` replay window —
while preserving the serial path's observable semantics:

  * per-plan commit ORDERING: plans are drained in queue (priority, FIFO)
    order and evaluated in that order against the shared snapshot PLUS the
    accumulated effects of every earlier plan in the batch (`_BatchCtx`),
    exactly the state each plan would have seen had the previous plans
    committed one at a time;
  * per-plan FAILURE isolation at evaluation: a plan whose evaluation
    raises (or whose nodes are all rejected) fails alone — it contributes
    nothing to the batch entry and later plans evaluate as if it never
    queued. Only a failure of the single batch raft commit fails every
    plan in that entry (the entry is atomic by construction);
  * the 30s raft-apply budget covers the WHOLE batch, not 30s per
    message: a timeout surfaces `nomad.plan.commit_timeout` per plan
    instead of letting one slow entry starve the queue.

Plan evaluation itself is tensorized (CvxCluster: keep allocation
*evaluation* in batched tensor form): the touched node rows of every plan
in the batch are gathered once — straight from the solver's device-resident
TensorCache when it is current (state_cache.gather: same bits as the view
by construction), else from the snapshot's dense usage view — and all
dense-eligible (plan, node) pairs are verdicted in one vectorized AllocsFit
pass. Rows where plans interact (overlapping placements with stops /
negative deltas / exact-path neighbors) fall back to an ordered per-plan
pass with the accumulated in-batch deltas, and nodes with sequential
resources keep the scalar `_evaluate_node_plan` oracle — which is also the
whole-batch path under NOMAD_PLAN_TENSOR_EVAL=0 (the differential tests'
oracle switch). Knobs + semantics: docs/COMMIT_COALESCING.md.
"""
from __future__ import annotations

import heapq
import itertools
import os
import threading
import time
from typing import Optional

import numpy as np

from .. import faults
from ..metrics import metrics
from ..obs import trace
from ..rpc.codec import NotLeaderError
from ..state import StateStore
from ..structs import (
    Allocation, NetworkIndex, Plan, PlanResult, allocs_fit,
)
from .fsm import (
    APPLY_PLAN_RESULTS, APPLY_PLAN_RESULTS_BATCH, PlanApplyRequest, RaftLog,
)

_FIT_EPS = 1e-3

# the distinct disposition a pending plan gets when the applier loses
# leadership under it (step-down, fence rejection, revoke): workers see
# it instead of a generic failure, and `nomad.plan.leadership_lost`
# counts every occurrence (ISSUE 6 satellite)
LEADERSHIP_LOST = "leadership lost"

# _fence_token sentinel: "fencing is supported and we are NOT leader"
# (None means "no fencing on this log at all")
_NOT_LEADER = object()


class PlanExpiredError(RuntimeError):
    """The submitting eval's enqueue deadline lapsed before this plan
    reached the applier (ISSUE 8): the plan is rejected BEFORE the raft
    round — the caller already gave up, so committing it would spend a
    consensus round-trip (and follower applies) on anti-goodput. The
    worker sees the distinct `expired` disposition; an expired plan can
    never reach a raft entry by construction."""

    def __init__(self, plan: Plan, now: float):
        super().__init__(
            f"plan for eval {plan.eval_id[:8]} expired "
            f"{now - plan.deadline_unix:.2f}s past its deadline")


class LeadershipLostPlanError(RuntimeError):
    """A plan (or whole drained batch) could not commit because this
    server stopped being the leader. NotLeaderError/FencedWriteError
    from the log, or the revoke path failing pendings, all collapse to
    this one worker-visible disposition."""

    def __init__(self, detail: str = ""):
        super().__init__(LEADERSHIP_LOST + (f": {detail}" if detail else ""))


class _PendingPlan:
    __slots__ = ("plan", "event", "result", "error", "ctx", "t0")

    def __init__(self, plan: Plan):
        self.plan = plan
        self.event = threading.Event()
        self.result: Optional[PlanResult] = None
        self.error: Optional[str] = None
        # trace context of the submitting eval + enqueue time: the
        # applier attributes `plan.queue_wait` from these at drain
        self.ctx = trace.eval_ctx(plan.eval_id) or trace.current()
        self.t0 = time.perf_counter()

    def respond(self, result, error) -> None:
        self.result = result
        self.error = error
        self.event.set()

    def wait(self, timeout: Optional[float] = None
             ) -> tuple[Optional[PlanResult], Optional[str]]:
        self.event.wait(timeout)
        return self.result, self.error


class PlanQueue:
    """Priority FIFO of pending plans (ref nomad/plan_queue.go)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._heap: list = []
        self._seq = itertools.count()
        self._enabled = False

    def set_enabled(self, enabled: bool,
                    reason: str = "plan queue disabled") -> int:
        """Returns the number of pendings failed by a disable (0 when
        enabling) — the caller's metric source, exact under the lock."""
        failed = 0
        with self._lock:
            self._enabled = enabled
            if not enabled:
                for _, _, pending in self._heap:
                    pending.respond(None, reason)
                    failed += 1
                self._heap = []
            self._cond.notify_all()
        return failed

    def drain_stale(self, reason: str) -> int:
        """Fail every queued pending WITHOUT toggling enablement — the
        new leader's recovery barrier empties anything that survived the
        previous leadership before scheduling resumes (ISSUE 6)."""
        with self._lock:
            stale = [pending for _, _, pending in self._heap]
            self._heap = []
            for pending in stale:
                pending.respond(None, reason)
            return len(stale)

    def enqueue(self, plan: Plan) -> _PendingPlan:
        pending = _PendingPlan(plan)
        with self._lock:
            if not self._enabled:
                pending.respond(None, "plan queue disabled")
                return pending
            heapq.heappush(self._heap,
                           (-plan.priority, next(self._seq), pending))
            self._cond.notify_all()
        return pending

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)

    def dequeue(self, timeout: float = 1.0) -> Optional[_PendingPlan]:
        with self._lock:
            if not self._heap:
                self._cond.wait(timeout)
            if not self._heap:
                return None
            _, _, pending = heapq.heappop(self._heap)
            return pending

    def drain(self, max_n: int, timeout: float = 1.0,
              linger_s: float = 0.0,
              expected: int = 0) -> list[_PendingPlan]:
        """Pop up to `max_n` pendings in (priority, FIFO) order — the
        coalescing batch. Blocks for `timeout` only when empty. A lone
        plan with nothing behind it commits immediately; the short
        `linger_s` window only engages while MORE evals than the drained
        count are known to be in flight (`expected`, the micro-batcher's
        concurrency signal) — the commit-path twin of the eval-stream
        coalescing window, bounded at a few ms so it can never starve a
        quiet queue."""
        with self._lock:
            if not self._heap:
                self._cond.wait(timeout)
            if not self._heap:
                return []
            out: list[_PendingPlan] = []

            def _pop_ready() -> None:
                while self._heap and len(out) < max_n:
                    out.append(heapq.heappop(self._heap)[2])

            _pop_ready()
            if linger_s > 0 and expected > len(out):
                deadline = time.monotonic() + linger_s
                while len(out) < min(max_n, expected) and self._enabled:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(min(remaining, 0.001))
                    _pop_ready()
            # queue_depth = everything that was waiting when the applier
            # came around (pressure); queue_residual = what the drain
            # left behind — nonzero residual means plan_commit_batch_max
            # is saturating, which healthy coalescing alone never shows
            depth = len(out) + len(self._heap)
            metrics.set_gauge("nomad.plan.queue_depth", depth)
            metrics.add_sample("nomad.plan.queue_depth", depth)
            metrics.set_gauge("nomad.plan.queue_residual", len(self._heap))
            metrics.add_sample("nomad.plan.queue_residual",
                               len(self._heap))
            return out


class _BatchCtx:
    """The committed effects of earlier plans in a coalescing batch,
    overlaid on the shared snapshot: row-wise usage deltas for the dense
    check plus object-level placements/removals for the exact oracle.
    A plan evaluated with this ctx sees exactly the state it would have
    seen on the serial path after those plans committed one at a time."""

    __slots__ = ("used_delta", "placed_by_node", "placed_ids",
                 "removed_ids")

    def __init__(self):
        # row -> accumulated XR delta as a plain python list: the absorb
        # loop runs per ALLOC (50k for a headline plan), so it must stay
        # scalar-python-add cheap — consumers lift to numpy per ROW once
        self.used_delta: dict[int, list] = {}
        self.placed_by_node: dict[str, list] = {}
        self.placed_ids: dict[str, Allocation] = {}
        self.removed_ids: set[str] = set()

    def empty(self) -> bool:
        return not (self.used_delta or self.placed_by_node
                    or self.removed_ids)

    def _add(self, row: int, delta, sign: float) -> None:
        acc = self.used_delta.get(row)
        if acc is None:
            acc = self.used_delta[row] = [0.0] * len(delta)
        for i, x in enumerate(delta):
            acc[i] += x * sign

    def live_twin(self, snap, alloc_id: str):
        """The live alloc this batch currently knows under `alloc_id` —
        an in-batch placement wins over the snapshot; a removed id is
        dead."""
        twin = self.placed_ids.get(alloc_id)
        if twin is not None:
            return twin
        if alloc_id in self.removed_ids:
            return None
        a = snap.alloc_by_id(alloc_id)
        if a is not None and not a.terminal_status():
            return a
        return None

    def absorb(self, snap, view, plan: Plan, result: PlanResult) -> None:
        """Fold one plan's COMMITTED slices in, mirroring what
        upsert_plan_results does to the usage matrices."""
        from ..state.usage_index import alloc_usage_tuple

        def retire(a) -> None:
            src = self.live_twin(snap, a.id)
            if src is None:
                return
            if a.id in self.placed_ids:
                del self.placed_ids[a.id]
                bucket = self.placed_by_node.get(src.node_id)
                if bucket:
                    self.placed_by_node[src.node_id] = \
                        [x for x in bucket if x.id != a.id]
            self.removed_ids.add(a.id)
            if view is not None:
                r = view.row.get(src.node_id)
                if r is not None:
                    self._add(r, alloc_usage_tuple(src), -1.0)

        for allocs in result.node_update.values():
            for a in allocs:
                retire(a)
        for allocs in result.node_preemptions.values():
            for a in allocs:
                retire(a)
        for node_id, allocs in result.node_allocation.items():
            r = view.row.get(node_id) if view is not None else None
            for a in allocs:
                prev = self.live_twin(snap, a.id)
                if prev is not None:
                    # in-place update: the old twin's usage retires with
                    # the replacement (upsert_plan_results semantics).
                    # retire() may REBIND placed_by_node[node_id], so the
                    # bucket must be fetched after it, per alloc
                    retire(prev)
                self.removed_ids.discard(a.id)
                self.placed_ids[a.id] = a
                self.placed_by_node.setdefault(node_id, []).append(a)
                if r is not None:
                    self._add(r, alloc_usage_tuple(a), +1.0)


class _PlanShape:
    """Phase-1 product for one plan of a batch: dense-eligible (node, row,
    ask) triples, exact-path node ids, and pre-resolved verdicts."""

    __slots__ = ("plan", "error", "dense_nodes", "dense_rows", "dense_asks",
                 "exact_nodes", "verdicts")

    def __init__(self, plan: Plan):
        self.plan = plan
        self.error: Optional[BaseException] = None
        self.dense_nodes: list[str] = []
        self.dense_rows: list[int] = []
        self.dense_asks: list[tuple] = []
        self.exact_nodes: list[str] = []
        self.verdicts: dict[str, bool] = {}


def _tensor_eval_enabled() -> bool:
    return os.environ.get("NOMAD_PLAN_TENSOR_EVAL", "") != "0"


class Planner:
    """The serial applier thread (ref plan_apply.go planApply:71), now
    draining coalesced batches per cycle."""

    def __init__(self, raft: RaftLog, state: StateStore):
        self.raft = raft
        self.state = state
        self.queue = PlanQueue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # the batch the applier thread has drained but not yet responded
        # to — stop() must fail it if the thread dies/outlives the join,
        # or a pipelined worker blocks on wait() forever (ISSUE 3)
        self._inflight: list[_PendingPlan] = []

    # -------------------------------------------------------------- knobs

    def _coalesce_max(self) -> int:
        """Batch ceiling from the hot-reloadable scheduler config;
        NOMAD_PLAN_COALESCE=0 forces the serial one-plan path."""
        if os.environ.get("NOMAD_PLAN_COALESCE", "") == "0":
            return 1
        cfg = getattr(self.state, "scheduler_config", None)
        try:
            return max(1, int(getattr(cfg, "plan_commit_batch_max", 32)))
        except (TypeError, ValueError):
            return 32

    def _commit_budget(self) -> float:
        cfg = getattr(self.state, "scheduler_config", None)
        try:
            return max(0.1, float(getattr(cfg, "plan_commit_timeout_s",
                                          30.0)))
        except (TypeError, ValueError):
            return 30.0

    def _commit_window_s(self) -> float:
        cfg = getattr(self.state, "scheduler_config", None)
        try:
            return max(0.0, float(getattr(cfg, "plan_commit_window_ms",
                                          5.0))) / 1000.0
        except (TypeError, ValueError):
            return 0.005

    @staticmethod
    def _expected_in_flight() -> int:
        """The eval-stream's in-flight signal (placer + eval broker feed
        the micro-batcher): how many evals might still submit a plan.
        Gates the drain linger so an idle cluster's lone plan never
        waits; a stripped solver-less build just reports 0."""
        try:
            from ..solver import microbatch
            return microbatch.concurrency()
        except Exception:   # noqa: BLE001 — optional signal
            return 0

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.queue.set_enabled(True)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="plan-applier")
        self._thread.start()

    def stop(self, timeout: float = 5.0,
             reason: str = "planner stopped") -> None:
        """`reason` becomes every failed pending's disposition. The
        revoke-leadership path passes LEADERSHIP_LOST so workers (and
        `nomad.plan.leadership_lost`) can tell a step-down from a crash
        (ISSUE 6 satellite)."""
        lost = reason.startswith(LEADERSHIP_LOST)
        self._stop.set()
        n_queued = self.queue.set_enabled(False, reason=reason)
        if self._thread:
            try:
                self._thread.join(timeout=timeout)
            except RuntimeError:
                # start() raced us between Thread() and .start() (a
                # shutdown landing mid-establish): the daemon thread
                # sees _stop set on its first drain and exits
                pass
        # a batch mid-apply when the join gave up (or the thread died)
        # must still resolve — waiters see an error, not a hang. respond
        # after a late applier respond is a harmless overwrite: every
        # waiter already woke on the first event.set(). These are NOT
        # counted toward nomad.plan.leadership_lost: the applier's own
        # commit-error path owns that count for drained plans, and a
        # late-resolving applier would double-count them here.
        for pending in self._inflight:
            if not pending.event.is_set():
                pending.respond(None, reason)
        if lost and n_queued:
            metrics.incr("nomad.plan.leadership_lost", n_queued)

    def _run(self) -> None:
        while not self._stop.is_set():
            max_n = self._coalesce_max()
            batch = self.queue.drain(
                max_n, timeout=0.5,
                linger_s=self._commit_window_s() if max_n > 1 else 0.0,
                expected=self._expected_in_flight() if max_n > 1 else 0)
            if not batch:
                continue
            self._inflight = batch
            t_drain = time.perf_counter()
            for pending in batch:
                trace.record_span("plan.queue_wait", pending.ctx,
                                  pending.t0, drained=len(batch))
            try:
                # the batch's fence: captured ONCE at drain, checked
                # atomically at the raft append — a step-down anywhere in
                # the evaluate window rejects the whole entry instead of
                # racing the new leader's commits (docs/FAILOVER.md)
                fence = self._fence_token()
                if fence is _NOT_LEADER:
                    # measured from DRAIN like the commit path's t_batch —
                    # from pending.t0 it would re-count the queue wait the
                    # span above already attributed
                    for pending in batch:
                        trace.record_span("plan.commit_wait", pending.ctx,
                                          t_drain,
                                          status="leadership_lost")
                        pending.respond(None, LEADERSHIP_LOST)
                    metrics.incr("nomad.plan.leadership_lost", len(batch))
                    continue
                outcomes = self.apply_plan_batch([p.plan for p in batch],
                                                 fence=fence)
                for pending, (result, err) in zip(batch, outcomes):
                    pending.respond(result,
                                    str(err) if err is not None else None)
            except Exception as e:   # noqa: BLE001 - report to workers
                for pending in batch:
                    if not pending.event.is_set():
                        pending.respond(None, str(e))
            finally:
                self._inflight = []

    def _fence_token(self):
        """The raft fence for one drained batch: None on logs without
        fencing (plain test fakes), the sentinel when this server is not
        currently the leader (drain raced a revoke)."""
        fence_fn = getattr(self.raft, "fence_token", None)
        if fence_fn is None:
            return None
        fence = fence_fn()
        return _NOT_LEADER if fence is None else fence

    # ------------------------------------------------------------ evaluate

    def apply_plan(self, plan: Plan) -> PlanResult:
        """Evaluate one plan against latest state, then commit via the log
        (ref :204 applyPlan / :400 evaluatePlan) — a coalescing batch of
        one, byte-compatible with the pre-coalescing serial path."""
        result, err = self.apply_plan_batch([plan])[0]
        if err is not None:
            raise err
        return result

    def apply_plan_batch(self, plans: list[Plan], fence=None
                         ) -> list[tuple[Optional[PlanResult],
                                         Optional[BaseException]]]:
        """Evaluate + commit a drained batch. Returns (result, error)
        aligned with `plans`; raises only on batch-wide pre-evaluation
        failures (the shared snapshot fetch). `fence` (the drain-time
        fence_token) makes the raft commit atomic with the leadership
        check — a deposed applier's batch is rejected whole, reported as
        LEADERSHIP_LOST per plan, and never lands after the new leader's
        commits."""
        deadline = time.monotonic() + self._commit_budget()
        t_batch = time.perf_counter()
        # per-plan trace contexts: drained plans resolve via eval id
        # (their worker is on another thread); the inline apply_plan
        # path (a batch of one on the caller's thread) via current()
        ctxs = [trace.eval_ctx(p.eval_id) or trace.current()
                for p in plans]
        # ONE SnapshotMinIndex fetch shared by every plan of the batch
        # (each plan used to snapshot independently); the store memoizes
        # the snapshot per write-generation, so concurrent worker lanes
        # share the same fetch too (state/store.py).
        snap_index = max((p.snapshot_index for p in plans), default=0)
        snap = self.state.snapshot_min_index(snap_index, timeout=5.0)

        t0 = time.perf_counter()
        evaluated = self._evaluate_batch(snap, plans)
        # ref plan_apply.go:185 `nomad.plan.evaluate` (whole-batch sample)
        metrics.add_sample("nomad.plan.evaluate", time.perf_counter() - t0)

        # ------------------------------------------------------- commit
        reqs: list[PlanApplyRequest] = []
        committed_results: list[PlanResult] = []
        noop_results: list[PlanResult] = []
        commit_ctxs = []                # trace ctxs of committing plans
        for (plan, result, err), pctx in zip(evaluated, ctxs):
            if err is not None or result is None:
                continue
            if result.is_no_op() and not result.node_update:
                noop_results.append(result)
                continue
            if pctx is not None:
                commit_ctxs.append(pctx)
            reqs.append(PlanApplyRequest(
                alloc_updates=[a for allocs in result.node_update.values()
                               for a in allocs],
                alloc_placements=[a for allocs
                                  in result.node_allocation.values()
                                  for a in allocs],
                alloc_preemptions=[a for allocs
                                   in result.node_preemptions.values()
                                   for a in allocs],
                deployment=result.deployment,
                deployment_updates=result.deployment_updates,
                eval_id=plan.eval_id,
            ))
            committed_results.append(result)

        commit_err: Optional[BaseException] = None
        commit_ctx = None
        if reqs:
            # ref plan_apply.go:204 `nomad.plan.apply` (raft commit + FSM);
            # the budget spans the WHOLE batch — one slow entry may not
            # hold the queue for 30s per message (ISSUE 5 satellite).
            # ONE shared raft-apply span for the coalesced entry, linked
            # to every committing plan's eval span — the commit-path
            # fan-in twin of the micro-batch dispatch span (ISSUE 7).
            # Two amortization layers compose here, by design: this
            # coalescer folds queued PLANS into one log entry, and the
            # raft group-commit window (ISSUE 20, docs/DURABILITY.md)
            # then folds that entry with whatever OTHER writers —
            # heartbeat sweeps, client alloc updates, dedup records —
            # enqueued during the previous window's fsync. Neither
            # subsumes the other: coalescing cuts entries per fsync,
            # group commit cuts fsyncs per entry.
            remaining = deadline - time.monotonic()
            commit_sp = trace.start_span(
                "plan.commit",
                parent=commit_ctxs[0] if commit_ctxs else None,
                links=commit_ctxs, plans=len(reqs),
                coalesced=len(reqs) > 1)
            commit_ctx = commit_sp.ctx()
            try:
                if remaining <= 0:
                    raise TimeoutError(
                        "plan commit budget exhausted before raft apply")
                with metrics.measure("nomad.plan.apply"), \
                        trace.use(commit_sp):
                    if len(reqs) == 1:
                        index = self.raft.apply(
                            APPLY_PLAN_RESULTS, {"result": reqs[0]},
                            timeout=remaining, fence=fence)
                    else:
                        index = self.raft.apply(
                            APPLY_PLAN_RESULTS_BATCH, {"results": reqs},
                            timeout=remaining, fence=fence)
                        metrics.incr("nomad.plan.coalesced_commits")
                        metrics.incr("nomad.plan.coalesced_plans",
                                     len(reqs))
                metrics.add_sample("nomad.plan.commit_batch_size",
                                   len(reqs))
                commit_sp.end("ok")
            except TimeoutError as e:
                metrics.incr("nomad.plan.commit_timeout", len(reqs))
                commit_sp.end("timeout", error=repr(e)[:200])  # nomadlint: disable=RPC001 — closes the trace span with the failure verdict, not a re-attempt
                commit_err = e
            except NotLeaderError as e:
                # FencedWriteError (entry never appended) and
                # LeadershipLostError (appended, outcome unknown) both
                # surface as the distinct leadership-lost disposition:
                # either way THIS applier must not claim the commit
                metrics.incr("nomad.plan.leadership_lost", len(reqs))
                commit_sp.end("leadership_lost", error=repr(e)[:200])
                commit_err = LeadershipLostPlanError(str(e))
            except Exception as e:   # noqa: BLE001 — per-plan surfaced
                commit_sp.end("error", error=repr(e)[:200])
                commit_err = e
            if commit_err is None:
                for result in committed_results:
                    result.alloc_index = index
                # feed the committed batch's usage deltas to the solver's
                # device-resident tensor cache HERE, on the leader-serial
                # applier thread — ONE replay window covering every plan
                # of the batch (docs/DEVICE_STATE_CACHE.md). The plans ARE
                # committed at this point — no cache-feed failure may
                # surface as a failed apply; lazy import keeps a stripped
                # solver-less build booting.
                try:
                    from ..solver import state_cache
                    state_cache.note_commit(self.state)
                except Exception as e:   # noqa: BLE001 — telemetry feed
                    from ..metrics import record_swallowed_error
                    record_swallowed_error("plan_apply.state_cache_feed", e)
        for result in noop_results:
            result.alloc_index = self.raft.barrier()

        committed_ids = {id(r) for r in committed_results}
        noop_ids = {id(r) for r in noop_results}
        out = []
        for (plan, result, err), pctx in zip(evaluated, ctxs):
            if err is not None:
                out.append((None, err))
                status = "expired" if isinstance(err, PlanExpiredError) \
                    else "error"
                attrs = {"error": repr(err)[:200]}
            elif commit_err is not None and id(result) in committed_ids:
                out.append((None, commit_err))
                status = "leadership_lost" if isinstance(
                    commit_err, LeadershipLostPlanError) else \
                    "timeout" if isinstance(commit_err, TimeoutError) \
                    else "error"
                attrs = {"error": repr(commit_err)[:200]}
            else:
                out.append((result, None))
                status = "ok"
                attrs = {"noop": True} if id(result) in noop_ids else \
                    {"index": getattr(result, "alloc_index", 0),
                     "rejected": len(result.rejected_nodes)}
            # per-plan commit attribution in the EVAL's own trace,
            # linked to the shared raft-apply span it rode (fan-in),
            # plus the disposition-labeled commit-wait histogram
            trace.record_span(
                "plan.commit_wait", pctx, t_batch,
                links=(commit_ctx,)
                if commit_ctx is not None and id(result) in committed_ids
                else (), status=status, batch=len(plans), **attrs)
            metrics.observe("nomad.plan.commit_wait_seconds",
                            time.perf_counter() - t_batch,
                            labels={"disposition": status})
        return out

    # --------------------------------------------------- batch evaluation

    def _evaluate_batch(self, snap, plans: list[Plan]):
        """-> [(plan, result|None, error|None)] in plan order. One
        vectorized feasibility pass over every dense-eligible (plan, node)
        pair whose row is free of cross-plan interaction; interacting rows
        and sequential-resource nodes resolve in an ordered per-plan pass
        over the same gathered tensors."""
        view = getattr(snap, "usage", None)
        ctx = _BatchCtx()
        tensor = _tensor_eval_enabled()

        # phase 1: per-plan gather — fire the plan's fault site BEFORE
        # touching any shared state for it (a failed apply must not move
        # the tensor cache), then classify nodes dense vs exact and build
        # the dense ask rows against the shared snapshot. Plans whose
        # referenced alloc ids overlap an earlier plan's (impossible for
        # broker-serialized evals; pipelined chunks place disjoint fresh
        # allocs) drop to the exact ordered pass wholesale.
        # fused solver verdict (ISSUE 15): trusted ONLY for a batch of
        # one — the monotone fast path has no view of sibling plans'
        # asks on a shared row, and the batch machinery's prefix-order
        # verdicts must stay authoritative whenever plans can interact.
        # The stamp binds iff it describes exactly the usage bits this
        # evaluation reads (same uid/epoch/version).
        verdict_rows = None
        if tensor and view is not None and len(plans) == 1:
            sv = getattr(plans[0], "solver_verdict", None)
            if sv and sv.get("uid") == getattr(view, "uid", 0) and \
                    sv.get("epoch") == getattr(view, "epoch", -1) and \
                    sv.get("version") == getattr(view, "version", -2):
                verdict_rows = sv.get("rows") or None

        shapes: list[_PlanShape] = []
        seen_refs: set[str] = set()
        for plan in plans:
            shape = _PlanShape(plan)
            shapes.append(shape)
            try:
                # deadline gate FIRST (ISSUE 8): a past-deadline plan
                # fails alone — no shared-state work, no raft entry —
                # with the distinct `expired` disposition
                if plan.deadline_unix and \
                        time.time() >= plan.deadline_unix:
                    metrics.incr("nomad.plan.expired")
                    raise PlanExpiredError(plan, time.time())
                faults.fire("planner.apply")
                refs = self._plan_refs(plan)
                conflicted = bool(refs & seen_refs)
                seen_refs |= refs
                if view is None or not tensor or conflicted:
                    shape.exact_nodes = list(plan.node_allocation)
                    continue
                self._shape_dense(snap, view, plan, shape,
                                  verdict_rows=verdict_rows)
            except BaseException as e:   # noqa: BLE001 — isolate the plan
                # a malformed plan (bad alloc shapes, poisoned resources)
                # fails ALONE: it contributes no dense/exact work and the
                # siblings evaluate as if it never queued
                shape.error = e
                shape.dense_nodes = []
                shape.dense_rows = []
                shape.dense_asks = []
                shape.exact_nodes = []

        # gather every touched row ONCE — from the TensorCache when it is
        # current (same bits as the view by construction), else from the
        # view itself (the fallback when the cache misses or is disabled)
        all_rows = [r for s in shapes for r in s.dense_rows]
        cap_r = used_r = urow = None
        if all_rows:
            urow = np.unique(np.asarray(all_rows, np.int64))
            got = None
            try:
                from ..solver import state_cache
                got = state_cache.gather(view, urow)
            except Exception:   # noqa: BLE001 — view arrays serve below
                got = None
            if got is not None:
                cap_r, used_r = got.cap, got.used
            else:
                cap_r, used_r = view.cap[urow], view.used[urow]

        row_local = ({int(r): i for i, r in enumerate(urow)}
                     if urow is not None else {})

        # phase 2: the single vectorized pass. A row is "clean" when no
        # exact-path node maps to it, no plan's stops/preemptions touch
        # it, and its dense asks are either from one plan or all
        # non-negative — there the prefix-order verdicts collapse to one
        # elementwise compare (sum fits => every prefix fits).
        if all_rows:
            self._vector_pass(shapes, view, row_local, cap_r, used_r)

        # phase 3: ordered resolution. Each plan's remaining pairs see the
        # gathered rows plus the accumulated in-batch deltas; exact nodes
        # run the scalar oracle with the object-level ctx overlay.
        out = []
        live = [s for s in shapes if s.error is None]
        for shape in shapes:
            plan = shape.plan
            if shape.error is not None:
                out.append((plan, None, shape.error))
                continue
            try:
                result = self._resolve_plan(snap, view, plan, shape, ctx,
                                            row_local, cap_r, used_r)
            except BaseException as e:   # noqa: BLE001 — isolate the plan
                out.append((plan, None, e))
                continue
            # nothing after the LAST live plan consumes the overlay, so
            # a batch of one (the inline apply_plan path — the 50k
            # headline) never pays the per-alloc absorb walk at all
            if shape is not live[-1]:
                ctx.absorb(snap, view, plan, result)
            out.append((plan, result, None))
        return out

    @staticmethod
    def _plan_refs(plan: Plan) -> set:
        refs = set()
        for table in (plan.node_allocation, plan.node_update,
                      plan.node_preemptions):
            for allocs in table.values():
                for a in allocs:
                    refs.add(a.id)
        return refs

    def _shape_dense(self, snap, view, plan: Plan, shape: _PlanShape,
                     verdict_rows: dict = None) -> None:
        """Classify one plan's nodes and build its dense ask rows (the
        former per-plan `_evaluate_plan_dense` gather, ctx-free: phase 1
        runs before any in-batch commits exist for these plans)."""
        from ..state.usage_index import (
            alloc_usage_tuple, resources_sequential,
        )
        width = len(view.cap[0]) if len(view.cap) else 0
        for node_id, new_allocs in plan.node_allocation.items():
            node = snap.node_by_id(node_id)
            if node is None:
                shape.verdicts[node_id] = False
                continue
            r = view.row.get(node_id)
            if r is None or view.seq_rows.get(r):
                shape.exact_nodes.append(node_id)
                continue
            # NOTE: a node's own reserved_host_ports can't collide here —
            # no involved alloc uses ports (seq_rows + the per-alloc check
            # below), so the NetworkIndex part of allocs_fit is vacuous
            if node.drain or node.scheduling_eligibility != "eligible" or \
                    node.status != "ready":
                existing_ids = {a.id for a in snap.allocs_by_node(node_id)}
                if not all(a.id in existing_ids for a in new_allocs):
                    shape.verdicts[node_id] = False
                    continue
            ask = [0.0] * width
            seq = False
            for a in new_allocs:
                if resources_sequential(a.allocated_resources):
                    seq = True
                    break
                u = alloc_usage_tuple(a)
                for i, x in enumerate(u):
                    ask[i] += x
                existing = snap.alloc_by_id(a.id)
                if existing is not None and not existing.terminal_status() \
                        and existing.node_id == node_id:
                    # in-place update: replaces its state twin on this node
                    old = alloc_usage_tuple(existing)
                    for i, x in enumerate(old):
                        ask[i] -= x
            if seq:
                shape.exact_nodes.append(node_id)
                continue
            for a in list(plan.node_update.get(node_id, ())) + \
                    list(plan.node_preemptions.get(node_id, ())):
                existing = snap.alloc_by_id(a.id)
                if existing is not None and not existing.terminal_status() \
                        and existing.node_id == node_id:
                    old = alloc_usage_tuple(existing)
                    for i, x in enumerate(old):
                        ask[i] -= x
            if verdict_rows is not None:
                v = verdict_rows.get(r)
                if v is not None and np.all(
                        np.asarray(ask, np.float32) <= v):
                    # fused verdict fast path (ISSUE 15): the device
                    # proved used[r] + verified <= cap + eps at these
                    # exact usage bits; this plan's ask is elementwise
                    # <= verified and IEEE addition is monotone, so the
                    # dense compare must also pass. Node-status checks
                    # above still ran against LATEST state; only the
                    # row-fit re-gather is skipped. A False/absent/
                    # larger-ask row re-checks normally — fit is not
                    # monotone in the other direction.
                    shape.verdicts[node_id] = True
                    metrics.incr("nomad.plan.verdict_fastpath")
                    continue
            shape.dense_nodes.append(node_id)
            shape.dense_rows.append(r)
            shape.dense_asks.append(tuple(ask))

    def _vector_pass(self, shapes, view, local, cap_r, used_r) -> None:
        """Verdict every dense pair on a clean row — ONE vectorized
        compare over all (plan, node) pairs of the batch; the residual
        python loop is dict stores only. `local` is the caller's
        row -> gathered-index map (shared with phase 3)."""
        n_rows = cap_r.shape[0]
        # flatten all pairs into columns
        pair_li: list[int] = []
        for shape in shapes:
            if shape.error is not None:
                continue
            pair_li.extend(local[r] for r in shape.dense_rows)
        if not pair_li:
            return
        li = np.asarray(pair_li, np.int64)
        asks = np.asarray(
            [a for s in shapes if s.error is None for a in s.dense_asks],
            np.float32)
        touch = np.bincount(li, minlength=n_rows)
        total = np.zeros((n_rows, cap_r.shape[1]), np.float32)
        np.add.at(total, li, asks)
        neg = np.zeros(n_rows, bool)
        np.logical_or.at(neg, li, (asks < 0).any(axis=1))
        dirty = np.zeros(n_rows, bool)            # cross-plan interaction
        for shape in shapes:
            if shape.error is not None:
                continue
            for node_id in shape.exact_nodes:
                r = view.row.get(node_id)
                if r is not None and r in local:
                    dirty[local[r]] = True
            for table in (shape.plan.node_update,
                          shape.plan.node_preemptions):
                for node_id in table:
                    r = view.row.get(node_id)
                    if r is not None and r in local:
                        dirty[local[r]] = True
        fits_total = np.all(used_r + total <= cap_r + _FIT_EPS, axis=1)
        # clean single-toucher rows: the pair's own fit IS the verdict;
        # clean nonneg multi-toucher rows: total fits => all prefixes fit
        clean_multi = (~dirty) & (~neg) & (touch > 1) & fits_total
        clean_single = (~dirty) & (touch == 1)
        fit_pair = np.all(used_r[li] + asks <= cap_r[li] + _FIT_EPS,
                          axis=1)                 # the one AllocsFit pass
        cm, cs = clean_multi[li], clean_single[li]
        k = 0
        for shape in shapes:
            if shape.error is not None:
                continue
            kn: list = []
            kr: list = []
            ka: list = []
            for node_id, r, ask in zip(shape.dense_nodes, shape.dense_rows,
                                       shape.dense_asks):
                if cm[k]:
                    shape.verdicts[node_id] = True
                elif cs[k]:
                    shape.verdicts[node_id] = bool(fit_pair[k])
                else:
                    kn.append(node_id)
                    kr.append(r)
                    ka.append(ask)
                k += 1
            shape.dense_nodes, shape.dense_rows, shape.dense_asks = \
                kn, kr, ka

    def _resolve_plan(self, snap, view, plan: Plan, shape: _PlanShape,
                      ctx: _BatchCtx, row_local: dict, cap_r,
                      used_r) -> PlanResult:
        """Finish one plan: ordered dense pairs (with in-batch deltas),
        exact nodes via the scalar oracle, then the serial path's result
        assembly (all_at_once, refresh_index, no-op barrier handled by
        the caller)."""
        result = PlanResult(
            node_update=dict(plan.node_update),
            deployment=plan.deployment,
            deployment_updates=list(plan.deployment_updates),
        )
        verdicts = shape.verdicts
        if shape.dense_rows:
            li = np.asarray([row_local[r] for r in shape.dense_rows],
                            np.int64)
            asks = np.asarray(shape.dense_asks, np.float32)
            used = used_r[li]
            if ctx.used_delta:
                used = used.copy()
                for k, r in enumerate(shape.dense_rows):
                    acc = ctx.used_delta.get(r)
                    if acc is not None:
                        used[k] += np.asarray(acc, np.float32)
            ok = np.all(used + asks <= cap_r[li] + _FIT_EPS, axis=1)
            for node_id, fit in zip(shape.dense_nodes, ok):
                verdicts[node_id] = bool(fit)
        for node_id in shape.exact_nodes:
            verdicts[node_id] = self._evaluate_node_plan(snap, plan,
                                                         node_id, ctx)
        for node_id, allocs in plan.node_allocation.items():
            if verdicts.get(node_id, False):
                result.node_allocation[node_id] = allocs
                if node_id in plan.node_preemptions:
                    result.node_preemptions[node_id] = \
                        plan.node_preemptions[node_id]
            else:
                result.rejected_nodes.append(node_id)

        if plan.all_at_once and result.rejected_nodes:
            # all-or-nothing (ref structs.go Plan.AllAtOnce)
            result.node_allocation = {}
            result.node_preemptions = {}
            result.deployment = None
            result.deployment_updates = []

        if result.rejected_nodes:
            result.refresh_index = snap.latest_index()
        return result

    def _evaluate_plan_dense(self, snap, plan: Plan) -> dict:
        """Vectorized per-node re-check for nodes where every involved
        allocation is free of sequential resources (ports/cores/devices):
        there the exact allocs_fit reduces to an elementwise compare on the
        dense XR matrices the store maintains incrementally. Nodes needing
        the exact path are absent from the dict (ref plan_apply.go:638
        evaluateNodePlan — behavior identical, cost O(N·R')). Kept as the
        single-plan wrapper over the batch machinery (the differential
        tests' dense-vs-exact witness)."""
        view = getattr(snap, "usage", None)
        verdicts: dict = {}
        if view is None or not plan.node_allocation:
            return verdicts
        shape = _PlanShape(plan)
        self._shape_dense(snap, view, plan, shape)
        if shape.dense_rows:
            rows = np.asarray(shape.dense_rows, np.int64)
            asks = np.asarray(shape.dense_asks, np.float32)
            ok = np.all(view.used[rows] + asks <= view.cap[rows] + _FIT_EPS,
                        axis=1)
            for node_id, fit in zip(shape.dense_nodes, ok):
                shape.verdicts[node_id] = bool(fit)
        verdicts.update(shape.verdicts)
        return verdicts

    def _evaluate_node_plan(self, snap, plan: Plan, node_id: str,
                            ctx: Optional[_BatchCtx] = None) -> bool:
        """Per-node re-check against current state (ref :638
        evaluateNodePlan) — the vmapped fit check's scalar twin AND the
        whole batch's oracle under NOMAD_PLAN_TENSOR_EVAL=0. `ctx`
        overlays the effects of plans committed earlier in the same
        coalescing batch."""
        new_allocs = plan.node_allocation.get(node_id, [])
        if not new_allocs:
            return True
        node = snap.node_by_id(node_id)
        if node is None:
            return False
        batch_placed = (ctx.placed_by_node.get(node_id, ())
                        if ctx is not None else ())
        if node.drain or node.scheduling_eligibility != "eligible" or \
           node.status != "ready":
            # an existing-alloc update (inplace) is still allowed on
            # draining nodes; new placements are not
            existing_ids = {a.id for a in snap.allocs_by_node(node_id)}
            existing_ids |= {a.id for a in batch_placed}
            if not all(a.id in existing_ids for a in new_allocs):
                return False

        existing = [a for a in snap.allocs_by_node(node_id)
                    if not a.terminal_status()]
        if ctx is not None and not ctx.empty():
            existing = [a for a in existing
                        if a.id not in ctx.removed_ids
                        and a.id not in ctx.placed_ids]
            existing.extend(batch_placed)
        remove_ids = {a.id for a in plan.node_update.get(node_id, ())}
        remove_ids |= {a.id for a in plan.node_preemptions.get(node_id, ())}
        proposed = [a for a in existing if a.id not in remove_ids]
        new_ids = {a.id for a in new_allocs}
        proposed = [a for a in proposed if a.id not in new_ids]
        proposed.extend(new_allocs)
        fit, _, _ = allocs_fit(node, proposed)
        return fit

    # --------------------------------------------------- worker-facing API

    def submit_plan(self, plan: Plan,
                    timeout: float = 10.0) -> Optional[PlanResult]:
        # the queue's enabled flag IS the fence here: a non-leader's
        # queue is disabled and fails the pending immediately; the
        # commit itself is fence-checked in _run
        # nomadlint: disable=LEAD001 — queue-gated (see comment above)
        pending = self.queue.enqueue(plan)
        result, err = pending.wait(timeout)
        if err:
            return None
        return result

    def submit_plan_async(self, plan: Plan) -> _PendingPlan:
        """Enqueue without blocking (the pipelined plan lifecycle): the
        applier thread evaluates and commits in queue order while the
        caller keeps materializing later chunks; callers resolve the
        returned pending before submitting anything that must order
        after it. Chunk plans enqueued back-to-back coalesce into one
        commit batch (ordering preserved: drain is priority+FIFO)."""
        # nomadlint: disable=LEAD001 — queue-gated like submit_plan
        pending = self.queue.enqueue(plan)
        # depth is a LEVEL, not an event: gauge+sample like the sync
        # drain path above (the old `queue_depth_async` counter only
        # ever counted submissions — ISSUE 8 satellite)
        depth = self.queue.depth()
        metrics.set_gauge("nomad.plan.queue_depth", depth)
        metrics.add_sample("nomad.plan.queue_depth", depth)
        return pending
