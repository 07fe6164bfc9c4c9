"""Guards on the port package nomad_tpu_torch:

  * it runs evals (the depth solve, the chunked scan and the convex
    solve, then a job through a two-worker in-process server, then one
    through a three-server Raft cluster with durable WALs) with neither
    jax nor any nomad_tpu module loaded;
  * no module of it, and not chip_smoke.py, imports jax or nomad_tpu;
  * each module it copies verbatim from nomad_tpu is byte-equal to its
    original (the reference is frozen, so drift is a port fault), and
    the adapted copies differ only where they name the port's package
    (rpc/codec.py's allow-list, server/server.py:57), where
    server/server.py's standby warmup waits while its server leads and
    where it times a client update and reads its allocs in one call,
    and, for the copies that time their sites through obs/timing.py,
    leave out registry names nothing reads or pay a client update's
    per-job work once, at their pinned blocks (TELEMETRY_ADAPTED);
  * with no card and no use_device("cpu") or NOMAD_SOLVER_DEVICE=cpu,
    the first solve raises, in process and in a spawned agent;
  * agent/http.py differs from the reference only where it names the
    port's UI package (:1370), and server/worker.py only where its loop
    waits on a disabled broker instead of spinning, and where it keeps
    its eval while its scheduler runs and refuses the plans and eval
    writes of an eval it no longer holds (Nomad's Plan.Submit and
    Eval.Update token checks);
  * the analyzer's framework-neutral rule modules are byte copies, and
    its adapted modules (the framework, the CLI, the rules that name the
    package or its rule table) differ from the reference only at the
    pinned lines (ANALYSIS_ADAPTED).
"""
import ast
import difflib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "nomad_tpu_torch"
REF = ROOT / "nomad_tpu"

# modules the port carries over byte for byte (paths under each package)
VERBATIM = (
    ["metrics.py", "chrono.py", "mock.py", "api_codec.py", "obs/__init__.py",
     "state/__init__.py", "state/usage_index.py", "rpc/__init__.py",
     "rpc/dedup.py", "rpc/server.py", "server/__init__.py",
     "server/lifecycle.py", "server/blocked_evals.py", "server/worker.py",
     "server/periodic.py", "server/deployment_watcher.py", "server/drainer.py",
     "server/volume_watcher.py", "server/event_broker.py", "server/search.py",
     "server/acl_endpoint.py", "integrations/__init__.py",
     "integrations/connect.py", "integrations/services.py",
     "integrations/secrets.py", "integrations/template.py",
     "solver/roundtrip.py", "tlsutil.py", "rpc/virtual.py", "server/gossip.py",
     "cli.py", "ui/__init__.py", "ui/index.html", "agent/__init__.py",
     "agent/agent.py", "agent/config_file.py", "agent/monitor.py",
     "analysis/rules_lint.py", "analysis/rules_dur.py",
     "analysis/rules_lead.py", "analysis/rules_lock.py",
     "analysis/rules_perf.py", "analysis/rules_queue.py",
     "analysis/rules_read.py", "analysis/rules_rpc.py",
     "analysis/rules_mesh.py"]
    + sorted(f"api/{p.name}" for p in (REF / "api").glob("*.py"))
    + sorted(f"client/{p.name}" for p in (REF / "client").glob("*.py"))
    + sorted(f"jobspec/{p.name}" for p in (REF / "jobspec").glob("*.py"))
    + sorted(f"acl/{p.name}" for p in (REF / "acl").glob("*.py"))
    + sorted(f"structs/{p.name}" for p in (REF / "structs").glob("*.py"))
    + sorted(f"scheduler/{p.name}" for p in (REF / "scheduler").glob("*.py"))
)

# the worker's blocks that differ from the reference: (first reference
# line, reference lines replaced, the port's lines in their place) — the
# loop's wait on a disabled broker, the eval held while its scheduler
# runs and its writes refused once it is not, the plan's answer awaited
# with no deadline, the sites timed through obs/timing.py, and the
# registry names nothing reads left out
WORKER_ADAPTED = [
    (16, 1, [
        'from ..obs import timing, trace',
    ]),
    (24, 0, [
        '',
        '',
        'class EvalNotHeld(RuntimeError):',
        '    """The worker\'s eval is no longer outstanding under its token: the',
        '    broker took it back (a flush at a leadership change, a nack timeout)',
        "    and may have handed it to another worker, so this worker's plans and",
        '    eval writes are refused."""',
    ]),
    (57, 0, [
        "                # a disabled broker (every follower's) answers at once:",
        '                # wait on its condition, which enabling it (leadership)',
        '                # notifies, instead of spinning on the interpreter lock',
        "                # that the server's Raft threads need",
        '                broker = self.server.eval_broker',
        '                with broker._lock:',
        '                    if not broker._enabled and not self._stop.is_set():',
        '                        broker._cond.wait(DEQUEUE_TIMEOUT)',
    ]),
    (85, 3, []),
    (98, 1, [
        '            # the broker keeps the eval while its scheduler runs: in',
        '            # process a worker stops only with its server, so the nack',
        '            # timer would only ever race a live one (a host binpack of',
        '            # thousands of instances outlasts it under a busy interpreter)',
        '            broker = self.server.eval_broker',
        '            with broker._lock:',
        '                rec = broker._unack.get(ev.id)',
        '                if rec is not None and rec["token"] == token:',
        '                    rec["deadline"] = float("inf")',
    ]),
    (105, 6, []),
    (126, 3, []),
    (142, 2, [
        '        with timing.timed("nomad.worker.wait_for_index",',
        '                          "worker.wait_for_index", index=wait_index):',
    ]),
    (147, 3, [
        '        # ref worker.go:553 `nomad.worker.invoke_scheduler_<type>`; the',
        "        # thread's CPU seconds over the same block under a name outside",
        '        # that prefix, which counts the evals processed',
        '        with timing.timed(f"nomad.worker.invoke_scheduler_{ev.type}",',
        '                          "scheduler.process",',
        '                          cpu="nomad.worker.invoke_cpu", type=ev.type):',
    ]),
    (153, 0, [
        '',
        '    def _hold(self) -> None:',
        '        """Refuse a write for an eval this worker no longer holds (ref',
        '        plan_endpoint.go Submit and eval_endpoint.go Update/Create check',
        "        the eval's token): an eval the broker took back is placed by",
        '        another worker, and both plans would commit."""',
        '        if self._eval is None or not self._eval_token:',
        '            return',
        '        if self.server.eval_broker.outstanding(self._eval.id) != \\',
        '                self._eval_token:',
        '            raise EvalNotHeld(f"eval {self._eval.id[:8]} is no longer "',
        '                              f"held by worker-{self.id}")',
    ]),
    (160, 3, [
        '        self._hold()',
        '        with timing.timed("nomad.worker.submit_plan", "plan.submit"):',
        "            # wait for the applier's answer (ref: no deadline): a plan",
        '            # given up on while still queued commits later, under a retry',
        '            # that places the same instances again',
        '            result = self.server.planner.submit_plan(plan, timeout=None)',
    ]),
    (189, 1, [
        '        self._hold()',
    ]),
    (194, 0, [
        '        self._hold()',
    ]),
    (200, 0, [
        '        self._hold()',
    ]),
]


# the analyzer's adapted modules: (first reference line, reference lines
# replaced, the port's lines in their place) for each block that differs
# — the package's name, its rule table and fixture file, and the
# docstrings that describe them
ANALYSIS_ADAPTED = {
    'analysis/__init__.py': [
        (1, 2, [
            '"""nomadlint for the PyTorch/CUDA package: AST-based static analysis',
            '(host-sync and kernel-build discipline, lock discipline, determinism,',
            'exception hygiene). Run it locally with',
        ]),
        (4, 1, [
            '    python -m nomad_tpu_torch.analysis [--json] [paths...]',
        ]),
        (6, 1, [
            'and see analysis/RULES.md for the rule catalog and the',
        ]),
    ],
    'analysis/__main__.py': [
        (1, 1, [
            '"""CLI entry point:',
            '`python -m nomad_tpu_torch.analysis [--json] [paths...]`.',
        ]),
        (5, 3, [
            'tests/test_torch_analysis.py enforces in tier-1. `--changed` is the',
            'edit-loop fast path (git-dirty files, per-file rules only); `--graph`',
            'dumps the whole-program ProjectIndex for debugging rule resolution.',
        ]),
        (59, 1, [
            '        prog="python -m nomad_tpu_torch.analysis",',
        ]),
        (62, 1, [
            '    ap.add_argument("paths", nargs="*", default=["nomad_tpu_torch"],',
        ]),
        (64, 1, [
            '                         "(default: nomad_tpu_torch)")',
        ]),
    ],
    'analysis/core.py': [
        (1, 1, [
            '"""nomadlint core: the framework behind `python -m nomad_tpu_torch.analysis`.',
        ]),
        (3, 7, [
            "The PyTorch/CUDA package's own copy of the analyzer. The bug classes that",
            "bite it are the reference package's, in torch's idiom: host syncs on the",
            "solver's per-eval path and inside device programs, kernel libraries",
            'rebuilt or reloaded per call, unlocked mutation of lock-owning classes,',
            'unseeded randomness on scheduler decision paths, silently swallowed',
            'daemon exceptions — all statically detectable from the AST, so tier-1',
            'runs this analyzer over `nomad_tpu_torch/` (tests/test_torch_analysis.py).',
        ]),
        (208, 2, [
            '        ("nomad_tpu_torch/server/raft.py" -> "nomad_tpu_torch.server.raft")',
            '        — the namespace the ProjectIndex files this module\'s defs under."""',
        ]),
        (253, 1, [
            '        # while `cd nomad_tpu_torch/solver && nomadlint placer.py` still does',
        ]),
        (423, 1, [
            '        # nothing (the CLI default "nomad_tpu_torch" exists only at repo root)',
        ]),
    ],
    'analysis/project.py': [
        (23, 3, [
            '    (docs/FAULT_INJECTION.md site catalog, the analysis/RULES.md rule',
            '    table, tests/test_torch_analysis.py text), found by walking up from',
            '    the scan roots. No docs found => drift rules stay quiet, so fixture',
        ]),
        (136, 0, [
            "# the port's rule table and fixture file, relative to the root that",
            '# holds docs/FAULT_INJECTION.md',
            'RULES_DOC = ("nomad_tpu_torch", "analysis", "RULES.md")',
            'FIXTURES = ("tests", "test_torch_analysis.py")',
            '',
            '',
        ]),
        (150, 0, [
            '        """The first ancestor of a scan root holding the fault catalog',
            "        (docs/FAULT_INJECTION.md, which the port's sites share with the",
            "        reference) or the port's rule table (RULES_DOC): both tables and",
            '        the fixture file (FIXTURES) are read under it."""',
        ]),
        (156, 3, [
            '                fault = os.path.join(cur, "docs", "FAULT_INJECTION.md")',
            '                rules = os.path.join(cur, *RULES_DOC)',
        ]),
        (165, 1, [
            '                    tl = os.path.join(cur, *FIXTURES)',
        ]),
        (362, 1, [
            '        "nomad_tpu_torch.solver.sharding._launch_lock")."""',
        ]),
    ],
    'analysis/rules_det.py': [
        (10, 1, [
            'Flagged inside `nomad_tpu_torch/scheduler/` and `nomad_tpu_torch/solver/`:',
        ]),
        (93, 1, [
            '    The versioned tensor cache (nomad_tpu_torch/solver/state_cache.py) and the',
        ]),
    ],
    'analysis/rules_exc.py': [
        (7, 1, [
            '(`nomad_tpu_torch.metrics.record_swallowed_error`), so operators see a',
        ]),
    ],
    'analysis/rules_lockorder.py': [
        (57, 1, [
            '    """Shorten `nomad_tpu_torch.server.eval_broker.EvalBroker._lock` to',
        ]),
    ],
    'analysis/rules_obs.py': [
        (14, 1, [
            "     ATTRIBUTES (nomad_tpu_torch/obs), which are bounded by the trace store's",
        ]),
        (33, 1, [
            '               "describe", "timed", "waited")',
        ]),
        (42, 1, [
            '_CM_SINKS = ("measure", "span", "use", "timed")',
        ]),
        (56, 3, [
            '    if owner in ("metrics", "trace", "tracer", "timing") or \\',
            '            d.startswith("nomad_tpu_torch.metrics") or \\',
            '            d.startswith("nomad_tpu_torch.obs"):',
        ]),
        (140, 1, [
            '            f"attribute (nomad_tpu_torch/obs), or allowlist a provably "',
        ]),
    ],



    'analysis/rules_registry.py': [
        (5, 5, [
            'rule ids vs the analysis/RULES.md table (and their',
            'tests/test_torch_analysis.py fixtures), and SchedulerConfiguration fields',
            'vs their docstring/validate() coverage. Every one of them has drifted',
            'silently at least once ("the table forgot the new row"). These rules',
            'end the class mechanically.',
        ]),
        (78, 3, [
            '    short = ("registered rule without analysis/RULES.md row or "',
            '             "test_torch_analysis fixture; SchedulerConfiguration field "',
            '             "without docstring/validate coverage")',
        ]),
    ],
}


# the copies that time their sites through obs/timing.py (the broker
# and plan queue waits, the FSM's client update, the store's lock) or
# leave out registry names nothing reads, and the store's client update
# that pays its per-job work once an update: the blocks that differ
# from the reference, as ANALYSIS_ADAPTED's
TELEMETRY_ADAPTED = {
    'obs/trace.py': [
        (256, 0, [
            '    def accumulate(self, key: str, value: float) -> None:',
            '        """Add `value` to a numeric attribute of the current span (the',
            '        state store\'s lock waits sum into `lock_wait_s`)."""',
            '        if not self._enabled:',
            '            return',
            '        st = getattr(self._tls, "stack", None)',
            '        if st:',
            '            top = st[-1]',
            '            if isinstance(top, Span):',
            '                top.attrs[key] = top.attrs.get(key, 0.0) + value',
            '',
        ]),
        (328, 5, [
            '    def link_eval(self, eval_id: str, span) -> None:',
            '        """Link the live trace of `eval_id` to `span`: the eval was',
            "        caused by that span's work (a client update's follow-up evals).",
            "        The link rides the eval's root span, so its record joins the",
            '        linked trace when the eval ends."""',
            '        if not self._enabled or not isinstance(span, Span):',
        ]),
        (337, 4, [
            '            if tr is not None and tr.root is not None:',
            '                tr.root.links.append((span.trace_id, span.span_id))',
        ]),
        (369, 1, [
            '    def begin_root(self, name: str, head_sampled: bool = False,',
            '                   **attrs) -> Span:',
        ]),
        (371, 1, [
            '        failover promotion, revoke). Always retained, unless',
            "        `head_sampled`: then kept like an eval's trace (the head sample,",
            '        or a non-ok ending), so a frequent root (a client update) does',
            '        not push eval traces out of the store."""',
        ]),
        (376, 1, [
            '            if head_sampled:',
            '                rate = self._sample_rate * self._pressure_factor',
            '                sampled = rate >= 1.0 or self._rng.random() < rate',
            '            else:',
            '                sampled = True',
            '            tr = _Trace(tid, "", name, sampled=sampled,',
            '                        retain=not head_sampled)',
        ]),
        (689, 0, [
            'accumulate = tracer.accumulate',
        ]),
        (691, 1, [
            'link_eval = tracer.link_eval',
        ]),
    ],
    'rpc/client.py': [
        (296, 1, []),
        (306, 1, []),
    ],
    'rpc/retry.py': [
        (39, 1, []),
        (129, 1, []),
        (137, 2, []),
        (152, 1, []),
        (159, 1, []),
    ],
    'server/core_sched.py': [
        (98, 1, []),
    ],
    'server/durable.py': [
        (244, 1, []),
        (258, 1, []),
        (339, 1, []),
        (405, 1, []),
        (429, 1, []),
    ],
    'server/eval_broker.py': [
        (38, 1, [
            'from ..obs import timing, trace',
        ]),
        (124, 0, [
            '        # eval_id -> perf_counter at its first enqueue, read at dequeue',
            '        # as nomad.broker.wait (delay and job-pending time included)',
            '        self._enqueued: dict[str, float] = {}',
        ]),
        (184, 0, [
            '        self._enqueued.clear()',
        ]),
        (314, 0, [
            '        self._enqueued.pop(eval_id, None)',
        ]),
        (350, 0, [
            '        self._enqueued.setdefault(ev.id, time.perf_counter())',
        ]),
        (466, 3, [
            '            # ~1s leader ticks)',
        ]),
        (489, 2, []),
        (506, 3, [
            '                    eval_id = best[0].id',
            '                    t0 = self._enqueued.pop(eval_id, None)',
            '                    if t0 is not None:',
            '                        timing.waited(',
            '                            "nomad.broker.wait", "broker.wait", t0,',
            '                            trace.eval_ctx(eval_id),',
            '                            deliveries=self._dequeue_count.get(eval_id, 1))',
        ]),
        (693, 0, [
            '                self._enqueued.pop(ev.id, None)',
        ]),
        (703, 3, []),
    ],
    'server/fsm.py': [
        (182, 1, [
            '            from ..obs import timing',
            '            with timing.timed("nomad.fsm.alloc_client_update", "fsm.apply",',
            '                              index=index, type="alloc_client_update",',
            '                              allocs=len(payload["allocs"])) as sp:',
            '                sp.annotate(jobs=s.update_allocs_from_client(',
            '                    index, payload["allocs"]))',
        ]),
    ],
    'server/heartbeat.py': [
        (135, 1, []),
        (409, 1, []),
    ],
    'server/overload.py': [
        (176, 4, []),
        (230, 1, []),
    ],
    'server/plan_apply.py': [
        (57, 1, [
            'from ..obs import timing, trace',
        ]),
        (448, 2, [
            '                timing.waited("nomad.plan.queue_wait", "plan.queue_wait",',
            '                              pending.t0, pending.ctx, drained=len(batch))',
        ]),
        (658, 2, [
            '            # linked to the shared raft-apply span it rode (fan-in)',
        ]),
        (665, 3, []),
    ],
    'server/raft.py': [
        (660, 1, []),
        (990, 1, []),
        (1073, 1, []),
        (1113, 1, []),
        (1293, 1, []),
        (1328, 1, []),
        (1408, 1, []),
        (1474, 1, []),
    ],
    'state/store.py': [
        (19, 0, [
            'import dataclasses',
        ]),
        (23, 0, [
            'from operator import attrgetter',
        ]),
        (28, 0, [
            'from ..obs.timing import TimedRLock',
        ]),
        (44, 0, [
            '# every field of an Allocation in one call, for a field-wise shallow copy',
            '# (`copy.copy` of a slotted dataclass takes the slow __reduce_ex__ path)',
            '# that passes them all to the constructor in order, so none may be init=False',
            'if not all(f.init for f in dataclasses.fields(Allocation)):',
            '    raise TypeError("Allocation has an init=False field: the client "',
            '                    "update\'s shallow copy cannot pass it")',
            '_alloc_fields = attrgetter(*(f.name for f in dataclasses.fields(Allocation)))',
            '',
        ]),
        (47, 1, [
            '        # its contended acquisitions are timed (nomad.state.lock_wait)',
            '        self._lock = TimedRLock("nomad.state.lock_wait")',
        ]),
        (1090, 1, [
            '                                  allocs: list[Allocation]) -> int:',
        ]),
        (1092, 1, [
            '        (ref state_store.go UpdateAllocsFromClient/nestedUpdateAllocFromClient).',
            "        A job's summary is copied and its status computed once an update,",
            '        not once an alloc. Returns the number of jobs the update touched."""',
        ]),
        (1095, 0, [
            '            summaries: dict = {}',
            '            touched: set[tuple[str, str]] = set()',
        ]),
        (1099, 1, [
            '                # a shallow copy: the nested records this update does not',
            '                # write are shared with the stored alloc, which no writer',
            '                # changes in place',
            '                alloc = Allocation(*_alloc_fields(existing))',
        ]),
        (1136, 1, [
            '                self._reconcile_summary(idx, existing, alloc, summaries)',
        ]),
        (1138, 2, [
            '                touched.add((alloc.namespace, alloc.job_id))',
            '            # job status may flip (e.g. batch job completes): once a job',
            '            # an update (ref state_store.go setJobStatuses)',
            '            for key in touched:',
            '                job = self.jobs.get(key)',
        ]),
        (1146, 1, [
            '                        self.jobs[key] = job',
        ]),
        (1148, 0, [
            '            return len(touched)',
        ]),
        (1175, 0, [
            '',
            '    def allocs_by_ids(self, alloc_ids: Iterable[str]) -> dict[str, Allocation]:',
            '        """The stored allocs of `alloc_ids` (unknown ids left out), read',
            '        under one hold of the lock."""',
            '        with self._lock:',
            '            allocs = self.allocs',
            '            return {aid: allocs[aid] for aid in alloc_ids if aid in allocs}',
        ]),
        (1237, 2, [
            '        with self._lock:',
        ]),
    ],
}


# server.py's blocks: its backend module's name (:57), its standby
# warmup loop waiting while its server leads (:1023), the client update
# timed whole as the root of a trace of its own, and its follow-up
# evals' allocs read in one hold of the store's lock
SERVER_ADAPTED = [
    (18, 1, [
        'from ..obs import timing, trace',
    ]),
    (57, 1, [
        '    backend = sys.modules.get("nomad_tpu_torch.solver.backend")',
    ]),
    (1023, 1, [
        '                continue        # leading: warm once a follower again',
    ]),
    (2085, 1, [
        '        terminal transitions trigger new evals. Timed whole as',
        "        `nomad.client.update_alloc` (Nomad's Node.UpdateAlloc), the root",
        '        of a trace of its own that the follow-up evals link to."""',
        '        with timing.timed("nomad.client.update_alloc", "client.update_alloc",',
        '                          root=True, allocs=len(allocs)) as sp:',
        '            out = self._node_update_allocs(allocs)',
        '            for eval_id in out["eval_ids"]:',
        '                trace.link_eval(eval_id, sp)',
        '        return out',
        '',
        '    def _node_update_allocs(self, allocs: list[Allocation]) -> dict:',
    ]),
    (2089, 0, [
        '        # only a failed or complete alloc can make an eval: their stored',
        '        # records in one read of the store',
        '        stored_by_id = self.state.allocs_by_ids(',
        '            [a.id for a in allocs if a.client_status in (',
        '                ALLOC_CLIENT_FAILED, ALLOC_CLIENT_COMPLETE)])',
    ]),
    (2090, 1, [
        '            stored = stored_by_id.get(alloc.id)',
    ]),
]


_EVAL = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})

    class _Unimportable:
        # jax and the reference package cannot be imported at all here
        def find_spec(self, name, path=None, target=None):
            if name in ("jax", "jaxlib", "nomad_tpu") or name.startswith(
                    ("jax.", "jaxlib.", "nomad_tpu.")):
                raise ImportError(f"{{name}} is unimportable in this test")
            return None

    sys.meta_path.insert(0, _Unimportable())
    import nomad_tpu_torch
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.scheduler import Harness, new_scheduler
    from nomad_tpu_torch.solver.device import use_device
    from nomad_tpu_torch.structs import Evaluation, SchedulerConfiguration
    use_device("cpu")
    h = Harness()
    h.state.set_scheduler_config(
        h.get_next_index(),
        SchedulerConfiguration(scheduler_algorithm="tpu-batch"))
    for _ in range(16):
        h.state.upsert_node(h.get_next_index(), mock.node())
    job = mock.job()
    job.task_groups[0].count = 6
    job.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.get_next_index(), job)
    ev = Evaluation(job_id=job.id, type=job.type)
    h.process(lambda s, p: new_scheduler(job.type, s, p), ev)
    assert len(h.state.allocs_by_job("default", job.id)) == 6
    assert metrics.counter("nomad.solver.kernel.depth.torch") == 1
    # a spread job: the chunked scan
    from nomad_tpu_torch.structs import Spread
    job = mock.job()
    job.task_groups[0].count = 4
    job.task_groups[0].tasks[0].resources.networks = []
    job.spreads = [Spread(attribute="${{node.datacenter}}", weight=50)]
    h.state.upsert_job(h.get_next_index(), job)
    ev = Evaluation(job_id=job.id, type=job.type)
    h.process(lambda s, p: new_scheduler(job.type, s, p), ev)
    assert len(h.state.allocs_by_job("default", job.id)) == 4
    assert metrics.counter("nomad.solver.kernel.chunked.torch") == 1
    # the "convex" algorithm: the projected-gradient solve (convex.py)
    h.state.set_scheduler_config(
        h.get_next_index(),
        SchedulerConfiguration(scheduler_algorithm="convex"))
    job = mock.batch_job()
    job.task_groups[0].count = 7
    job.task_groups[0].networks = []
    job.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.get_next_index(), job)
    ev = Evaluation(job_id=job.id, type=job.type)
    h.process(lambda s, p: new_scheduler(job.type, s, p), ev)
    assert len(h.state.allocs_by_job("default", job.id)) == 7
    assert metrics.counter("nomad.solver.dispatch.convex.torch") == 1
    assert "nomad_tpu_torch.solver.convex" in sys.modules
    # the in-process server: two workers, a job through the broker
    import time
    from nomad_tpu_torch.server import Server
    srv = Server(num_workers=2, gc_interval=9999)
    srv.heartbeats.min_ttl = 3600.0
    srv.start()
    try:
        srv.set_scheduler_configuration(
            SchedulerConfiguration(scheduler_algorithm="tpu-batch"))
        for _ in range(8):
            srv.node_register(mock.node())
        job = mock.batch_job()
        job.task_groups[0].count = 5
        job.task_groups[0].networks = []
        job.task_groups[0].tasks[0].resources.networks = []
        eval_id = srv.job_register(job)["eval_id"]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            ev = srv.state.eval_by_id(eval_id)
            if ev is not None and ev.status == "complete":
                break
            time.sleep(0.02)
        assert srv.state.eval_by_id(eval_id).status == "complete"
        assert len(srv.state.allocs_by_job("default", job.id)) == 5
    finally:
        srv.shutdown()
    # three Raft servers on the in-memory transport, one durable WAL
    # each: a job committed through the elected leader
    import tempfile
    from nomad_tpu_torch.rpc.virtual import VirtualNetwork
    net = VirtualNetwork(seed=2)
    servers = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for i in range(3):
                s = Server(num_workers=1, gc_interval=9999)
                s.heartbeats.min_ttl = 3600.0
                s.rpc_listen_virtual(net, f"s{{i}}")
                servers.append(s)
            peers = {{f"s{{i}}": s.rpc_addr for i, s in enumerate(servers)}}
            for i, s in enumerate(servers):
                s.enable_raft(f"s{{i}}", peers, data_dir=f"{{tmp}}/raft{{i}}",
                              seed=2000 + i, election_timeout=(1.0, 2.0),
                              heartbeat_interval=0.1)
                s.start()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                led = [s for s in servers if s.raft_node.is_leader()
                       and s.is_leader]
                if len(led) == 1:
                    break
                time.sleep(0.02)
            leader = led[0]
            leader.set_scheduler_configuration(
                SchedulerConfiguration(scheduler_algorithm="tpu-batch"))
            for _ in range(6):
                leader.node_register(mock.node())
            job = mock.batch_job()
            job.task_groups[0].count = 4
            job.task_groups[0].networks = []
            job.task_groups[0].tasks[0].resources.networks = []
            eval_id = leader.job_register(job)["eval_id"]
            while time.monotonic() < deadline:
                if all(len(s.state.allocs_by_job("default", job.id)) == 4
                       for s in servers):
                    break
                time.sleep(0.02)
            assert leader.state.eval_by_id(eval_id).status == "complete"
            assert all(len(s.state.allocs_by_job("default", job.id)) == 4
                       for s in servers)
        finally:
            for s in servers:
                s.shutdown()
    assert "nomad_tpu_torch.server.durable" in sys.modules
    # a dev agent: a job placed over HTTP through the port's SDK, and /ui
    import urllib.request
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.api.client import Client as Api
    agent = Agent(AgentConfig(dev_mode=True, client_enabled=False,
                              http_port=0))
    agent.server.heartbeats.min_ttl = 3600.0
    agent.start()
    try:
        api = Api(agent.http_addr)
        api.operator.scheduler_set_configuration(
            {{"SchedulerAlgorithm": "tpu-batch"}})
        for _ in range(4):
            agent.server.node_register(mock.node())
        job = {{"ID": "guard-http", "Name": "guard-http", "Type": "batch",
               "Datacenters": ["dc1"],
               "TaskGroups": [{{"Name": "g", "Count": 3, "Tasks": [{{
                   "Name": "t", "Driver": "mock_driver",
                   "Resources": {{"CPU": 100, "MemoryMB": 64}}}}]}}]}}
        eval_id = api.jobs.register(job)["eval_id"]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            ev = agent.server.state.eval_by_id(eval_id)
            if ev is not None and ev.status == "complete":
                break
            time.sleep(0.02)
        allocs = api.jobs.allocations("guard-http")
        allocs = allocs[0] if isinstance(allocs, tuple) else allocs
        assert len(allocs) == 3, allocs
        with urllib.request.urlopen(agent.http_addr + "/ui",
                                    timeout=30) as r:
            assert r.status == 200 and b"<html" in r.read(4096).lower()
    finally:
        agent.shutdown()
    assert "nomad_tpu_torch.ui" in sys.modules
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "jaxlib",
                                                   "nomad_tpu.")))
    print("LOADED", loaded)
""")


def test_port_runs_an_eval_without_jax_or_the_reference():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _EVAL.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "LOADED []" in out.stdout, out.stdout


def _sources():
    yield ROOT / "chip_smoke.py"
    yield from sorted(PORT.rglob("*.py"))


def _imported_modules(path: Path):
    """Absolute module names imported by `path` (relative imports are
    resolved against the file's package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    rel = path.relative_to(ROOT).with_suffix("").parts
    pkg = list(rel[:-1])
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - (node.level - 1)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            yield mod
            for alias in node.names:
                yield f"{mod}.{alias.name}"
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__"):
            yield node.args[0].value


def test_no_port_source_imports_jax_or_the_reference():
    assert (ROOT / "chip_smoke.py").exists()
    bad = []
    for path in _sources():
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "nomad_tpu"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


@pytest.mark.parametrize("rel", ["solver/convex.py", "solver/kernels.py",
                                 "solver/cuda_kernels.py"])
def test_convex_route_imports_neither_jax_nor_the_reference(rel):
    """The convex tier's modules are among the guarded sources and import
    only torch, numpy and the port."""
    path = PORT / rel
    assert path in set(_sources())
    tops = {m.split(".")[0] for m in _imported_modules(path) if m}
    assert tops <= {"__future__", "numpy", "torch", "nomad_tpu_torch",
                    "ctypes", "functools", "hashlib", "os", "shutil",
                    "subprocess", "threading", "time", "pathlib", "math",
                    "typing"}, sorted(tops)


def _worker_adapted(ref: bytes) -> bytes:
    """The reference's worker.py with the port's two changes: its loop
    waits on a disabled broker instead of spinning (ROADMAP Queue 3
    item 13), and it holds its eval while it schedules and writes for it
    only while it holds it (item 24)."""
    lines = ref.decode().splitlines(keepends=True)
    assert lines[55] == "            if ev is None:\n"
    for at, n, new in reversed(WORKER_ADAPTED):
        lines[at - 1:at - 1 + n] = [ln + "\n" for ln in new]
    return "".join(lines).encode()


# copies that differ from the reference by stated changes
ADAPTED = {"server/worker.py": _worker_adapted}


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_is_byte_equal(rel):
    want = (REF / rel).read_bytes()
    if rel in ADAPTED:
        want = ADAPTED[rel](want)
    assert (PORT / rel).read_bytes() == want, rel


def _changed_blocks(rel: str) -> list:
    ref = (REF / rel).read_text().splitlines()
    port = (PORT / rel).read_text().splitlines()
    sm = difflib.SequenceMatcher(a=ref, b=port, autojunk=False)
    return [(i1 + 1, i2 - i1, port[j1:j2])
            for tag, i1, i2, j1, j2 in sm.get_opcodes() if tag != "equal"]


@pytest.mark.parametrize("rel", sorted(ANALYSIS_ADAPTED))
def test_analyzer_copy_differs_only_at_its_pinned_lines(rel):
    assert _changed_blocks(rel) == ANALYSIS_ADAPTED[rel]


@pytest.mark.parametrize("rel", sorted(TELEMETRY_ADAPTED))
def test_telemetry_copy_differs_only_at_its_pinned_blocks(rel):
    assert _changed_blocks(rel) == TELEMETRY_ADAPTED[rel]


def test_rpc_codec_differs_only_in_its_package_allow_list():
    ref = (REF / "rpc/codec.py").read_text().splitlines()
    port = (PORT / "rpc/codec.py").read_text().splitlines()
    diff = [(a, b) for a, b in zip(ref, port) if a != b]
    assert len(ref) == len(port)
    assert diff == [('_ALLOWED_PREFIXES = ("nomad_tpu.",)',
                     '_ALLOWED_PREFIXES = ("nomad_tpu_torch.",)')]


def test_server_differs_only_in_its_backend_module_name():
    """server.py names the port's backend module (:57), its standby
    warmup loop waits while its server leads instead of returning
    (:1023), so a leader that established below the warmup floor warms
    once it is a follower again (ROADMAP Queue 3 item 15), and it times a
    client update whole (`nomad.client.update_alloc`) as the root of a
    trace of its own and reads the allocs its follow-up evals need in one
    call: the blocks of SERVER_ADAPTED and no others."""
    assert _changed_blocks("server/server.py") == SERVER_ADAPTED


def test_port_server_warms_as_a_standby_once_it_stops_leading(monkeypatch):
    """The standby warmup loop outlives its server's reign: nothing is
    warmed while it leads, and the warmup runs (and the warm-standby
    gauge is set) once it follows again."""
    import threading
    import time as _time
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.server import server as server_mod
    from nomad_tpu_torch.solver import backend
    calls = []
    monkeypatch.delenv("NOMAD_STANDBY_WARMUP", raising=False)
    monkeypatch.setattr(server_mod, "_warmup_floor", lambda: 0)
    monkeypatch.setattr(backend, "warmup", lambda n, cfg=None: (
        calls.append(n), {"skipped": True})[1])
    monkeypatch.setitem(metrics.gauges, "nomad.standby.warmed", 0)
    srv = Server(num_workers=1, gc_interval=9999)
    srv.is_leader = True
    loop = threading.Thread(target=srv._standby_warmup_loop, daemon=True)
    loop.start()
    try:
        _time.sleep(4.5)
        assert calls == [] and loop.is_alive()
        srv.is_leader = False
        loop.join(5.0)
        assert not loop.is_alive()
        assert calls == [0]
        assert metrics.gauges["nomad.standby.warmed"] == 1
    finally:
        srv._shutdown_ev.set()
        loop.join(5.0)


def test_http_differs_only_in_its_ui_package():
    ref = (REF / "agent/http.py").read_text().splitlines()
    port = (PORT / "agent/http.py").read_text().splitlines()
    diff = [(i + 1, a, b) for i, (a, b) in enumerate(zip(ref, port))
            if a != b]
    assert len(ref) == len(port)
    assert diff == [(
        1370,
        '                html = (res.files("nomad_tpu.ui") / '
        '"index.html").read_bytes()',
        '                html = (res.files("nomad_tpu_torch.ui") / '
        '"index.html").read_bytes()')]




def test_port_worker_waits_while_its_broker_is_off():
    """A follower's worker parks on its disabled broker: a second of it
    costs the process a few dozen dequeue calls, not a spinning core."""
    import time as _time
    from nomad_tpu_torch.server import Server
    srv = Server(num_workers=2, gc_interval=9999)
    srv.eval_broker.set_enabled(False)
    calls = []
    inner = srv.eval_broker.dequeue

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)
    srv.eval_broker.dequeue = counted
    try:
        for w in srv.workers:
            w.start()
        _time.sleep(1.0)
    finally:
        for w in srv.workers:
            w.stop()
        with srv.eval_broker._lock:
            srv.eval_broker._cond.notify_all()
        for w in srv.workers:
            w.join(5.0)
    assert not any(w._thread.is_alive() for w in srv.workers)
    assert len(calls) <= 20, len(calls)


def _held_eval(srv):
    """A batch job's eval dequeued by the server's one worker by hand:
    the worker then holds it as its loop would."""
    from nomad_tpu_torch import mock
    for _ in range(4):
        srv.node_register(mock.node())
    job = mock.batch_job()
    job.task_groups[0].count = 3
    job.task_groups[0].networks = []
    job.task_groups[0].tasks[0].resources.networks = []
    srv.job_register(job)
    ev, token = srv.eval_broker.dequeue(["batch"], timeout=5.0)
    w = srv.workers[0]
    w._eval, w._eval_token = ev, token
    w._snapshot = srv.state.snapshot()
    return w, ev, job


def test_port_worker_refuses_writes_for_an_eval_it_no_longer_holds():
    """A nack timeout redelivers the eval: the first worker's plan, eval
    update and follow-up eval are refused, and nothing is committed."""
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.server.worker import EvalNotHeld
    from nomad_tpu_torch.structs import Plan
    srv = Server(num_workers=1, gc_interval=9999)
    srv.heartbeats.min_ttl = 3600.0
    srv.start()
    srv.workers[0].stop()
    srv.workers[0].join()
    try:
        w, ev, job = _held_eval(srv)
        srv.eval_broker._unack[ev.id]["deadline"] = 0.0
        assert srv.eval_broker.check_nack_timeouts() == [ev.id]
        again, token = srv.eval_broker.dequeue(["batch"], timeout=5.0)
        assert again.id == ev.id and token != w._eval_token
        plan = ev.make_plan(job)
        submitted = []
        inner = srv.planner.submit_plan
        srv.planner.submit_plan = lambda p, **kw: submitted.append(p) \
            or inner(p, **kw)
        for write in (lambda: w.submit_plan(plan),
                      lambda: w.submit_plan_async(plan),
                      lambda: w.update_eval(ev),
                      lambda: w.create_eval(ev.copy())):
            with pytest.raises(EvalNotHeld):
                write()
        assert submitted == [] and srv.planner.queue.depth() == 0
    finally:
        srv.shutdown()


def test_port_worker_waits_for_its_plans_answer():
    """The worker waits on the applier with no deadline: a plan given up
    on while queued would commit under the retry's second plan."""
    from nomad_tpu_torch.server import Server
    srv = Server(num_workers=1, gc_interval=9999)
    srv.heartbeats.min_ttl = 3600.0
    srv.start()
    srv.workers[0].stop()
    srv.workers[0].join()
    try:
        w, ev, job = _held_eval(srv)
        seen = []
        inner = srv.planner.submit_plan

        def submit(p, **kw):
            seen.append(kw)
            return inner(p, **kw)
        srv.planner.submit_plan = submit
        assert w.submit_plan(ev.make_plan(job)) is not None
        assert seen == [{"timeout": None}]
    finally:
        srv.shutdown()


def test_long_schedule_keeps_its_eval():
    """A scheduler that runs past the broker's nack timeout keeps its
    eval: it is delivered once, and the job ends with its count of
    allocations, each name once (the reference's worker loses it to a
    second worker mid-schedule, and both plans commit)."""
    import time as _time
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.server import worker as worker_mod
    srv = Server(num_workers=2, gc_interval=9999)
    srv.heartbeats.min_ttl = 3600.0
    srv.eval_broker.nack_timeout = 0.2
    inner = worker_mod.new_scheduler
    built = []

    def slow(kind, state, planner):
        sched = inner(kind, state, planner)
        built.append(planner.id)
        process = sched.process

        def late(ev):
            # a long solve: past the timeout, and past the leader loop's
            # once-a-second sweep of timed-out evals
            _time.sleep(2.5)
            return process(ev)
        sched.process = late
        return sched
    worker_mod.new_scheduler = slow
    srv.start()
    try:
        for _ in range(4):
            srv.node_register(mock.node())
        job = mock.batch_job()
        job.task_groups[0].count = 5
        job.task_groups[0].networks = []
        job.task_groups[0].tasks[0].resources.networks = []
        eval_id = srv.job_register(job)["eval_id"]
        deadline = _time.monotonic() + 30
        while _time.monotonic() < deadline:
            if srv.state.eval_by_id(eval_id).status == "complete" and \
                    not srv.eval_broker._unack:
                break
            _time.sleep(0.02)
        _time.sleep(1.5)
        allocs = srv.state.allocs_by_job("default", job.id)
        names = sorted(a.name for a in allocs)
        assert srv.state.eval_by_id(eval_id).status == "complete"
        assert len(built) == 1, built
        assert len(allocs) == 5 and len(set(names)) == 5, names
    finally:
        worker_mod.new_scheduler = inner
        srv.shutdown()


def test_many_workers_past_the_nack_timeout_place_each_job_once():
    """Stress: more workers than cores, a short switch interval, and every
    scheduler slower than the nack timeout and the leader's sweep: each
    job ends with its count, each name once, and no eval is swept."""
    import time as _time
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.server import worker as worker_mod
    n_workers = 2 * (os.cpu_count() or 1) + 2
    srv = Server(num_workers=n_workers, gc_interval=9999)
    srv.heartbeats.min_ttl = 3600.0
    srv.eval_broker.nack_timeout = 0.05
    swept = []
    sweep = srv.eval_broker.check_nack_timeouts
    srv.eval_broker.check_nack_timeouts = lambda: swept.extend(sweep()) \
        or []
    inner = worker_mod.new_scheduler

    def slow(kind, state, planner):
        sched = inner(kind, state, planner)
        process = sched.process

        def late(ev):
            _time.sleep(1.2)
            return process(ev)
        sched.process = late
        return sched
    worker_mod.new_scheduler = slow
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    srv.start()
    try:
        for _ in range(8):
            srv.node_register(mock.node())
        jobs = []
        for _ in range(12):
            job = mock.batch_job()
            job.task_groups[0].count = 3
            job.task_groups[0].networks = []
            job.task_groups[0].tasks[0].resources.networks = []
            jobs.append((job, srv.job_register(job)["eval_id"]))
        deadline = _time.monotonic() + 60
        while _time.monotonic() < deadline and not all(
                srv.state.eval_by_id(e).status == "complete"
                for _, e in jobs):
            _time.sleep(0.05)
        _time.sleep(1.5)
        for job, eval_id in jobs:
            names = [a.name for a in
                     srv.state.allocs_by_job("default", job.id)]
            assert srv.state.eval_by_id(eval_id).status == "complete"
            assert len(names) == len(set(names)) == 3, names
        assert swept == []
    finally:
        sys.setswitchinterval(switch)
        worker_mod.new_scheduler = inner
        srv.shutdown()


_DEVICE = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    from nomad_tpu_torch.solver import device
    print("DEVICE", device._device)
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.scheduler import Harness, new_scheduler
    from nomad_tpu_torch.structs import Evaluation, SchedulerConfiguration
    h = Harness()
    h.state.set_scheduler_config(
        h.get_next_index(),
        SchedulerConfiguration(scheduler_algorithm="tpu-batch"))
    for _ in range(4):
        h.state.upsert_node(h.get_next_index(), mock.node())
    job = mock.job()
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.get_next_index(), job)
    ev = Evaluation(job_id=job.id, type=job.type)
    try:
        h.process(lambda s, p: new_scheduler(job.type, s, p), ev)
    except RuntimeError as e:
        print("RAISED", e)
    # solves served by the CPU's plain tier, classic or fused
    print("PLACED", len(h.state.allocs_by_job("default", job.id)),
          "TORCH", metrics.counter("nomad.solver.dispatch.torch")
          + metrics.counter("nomad.solver.dispatch.fused.torch"))
""")


@pytest.mark.parametrize("value,want", [
    (None, ["DEVICE cuda:0", "RAISED solve device is cuda:0 but no CUDA "
            "device is present", "PLACED 0 TORCH 0"]),
    ("cpu", ["DEVICE cpu", "PLACED 2 TORCH 1"]),
    ("cuda", ["DEVICE cuda:0", "RAISED", "PLACED 0 TORCH 0"]),
])
def test_solver_device_env_is_a_request(value, want):
    """NOMAD_SOLVER_DEVICE, read at import, is a spawned process's
    use_device: unset the device is cuda:0 and, with no card here, the
    first solve raises; `cpu` solves on the CPU; no value falls back."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("NOMAD_SOLVER_DEVICE", None)
    if value is not None:
        env["NOMAD_SOLVER_DEVICE"] = value
    out = subprocess.run(
        [sys.executable, "-c", _DEVICE.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    for line in want:
        assert line in out.stdout, out.stdout


@pytest.mark.parametrize("value", ["gpu0", "meta", "cuda:x"])
def test_malformed_solver_device_env_raises_at_import(value):
    env = dict(os.environ, NOMAD_SOLVER_DEVICE=value)
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, "
         f"{str(ROOT)!r}); import nomad_tpu_torch.solver.device"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode != 0
    assert "ValueError: NOMAD_SOLVER_DEVICE=" in out.stderr, out.stderr


def test_agent_without_a_card_or_a_request_places_nothing(tmp_path):
    """A port -dev agent started with no card and no NOMAD_SOLVER_DEVICE:
    its first solve raises the "no CUDA device" error, the worker nacks
    the eval (it never completes), nothing is placed and nothing is
    solved on the CPU."""
    from nomad_tpu_torch.testing import (
        AgentProcess, child_env, free_ports, wait_until)
    env = child_env()
    env.pop("NOMAD_SOLVER_DEVICE", None)
    agent = AgentProcess("nocard", {"ports": {"http": free_ports(1)[0]}},
                         str(tmp_path), env, args=("-dev",)).start()
    try:
        assert agent.wait_http(90.0), agent.tail()
        assert wait_until(lambda: [n for n in agent.get("/v1/nodes")
                                   if n["Status"] == "ready"], 60.0, 0.1)
        agent.put("/v1/operator/scheduler/configuration",
                  {"SchedulerAlgorithm": "tpu-batch"})
        job = {"ID": "nocard", "Name": "nocard", "Type": "batch",
               "Datacenters": ["dc1"],
               "TaskGroups": [{"Name": "g", "Count": 2, "Tasks": [{
                   "Name": "t", "Driver": "mock_driver",
                   "Resources": {"CPU": 100, "MemoryMB": 64}}]}]}
        eval_id = agent.put("/v1/jobs", {"Job": job})["eval_id"]
        assert wait_until(lambda: "no CUDA device is present" in
                          agent.tail(20000), 60.0, 0.1), agent.tail()
        counters = agent.get("/v1/metrics")["telemetry"]["counters"]
        assert counters.get("nomad.worker.eval_failures", 0) >= 1
        assert not counters.get("nomad.solver.dispatch.torch")
        assert not counters.get("nomad.solver.dispatch.fused.torch")
        assert agent.get(f"/v1/evaluation/{eval_id}")["Status"] != \
            "complete"
        assert agent.get("/v1/job/nocard/allocations") == []
    finally:
        agent.stop()


def test_first_solve_raises_without_a_card_or_a_cpu_request(monkeypatch):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler import Harness, new_scheduler
    from nomad_tpu_torch.solver import backend
    from nomad_tpu_torch.solver.device import use_device
    from nomad_tpu_torch.structs import Evaluation, SchedulerConfiguration

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = use_device("cuda:0")
    backend.reset()
    try:
        h = Harness()
        h.state.set_scheduler_config(
            h.get_next_index(),
            SchedulerConfiguration(scheduler_algorithm="tpu-batch"))
        for _ in range(4):
            h.state.upsert_node(h.get_next_index(), mock.node())
        job = mock.job()
        job.task_groups[0].count = 2
        job.task_groups[0].tasks[0].resources.networks = []
        h.state.upsert_job(h.get_next_index(), job)
        ev = Evaluation(job_id=job.id, type=job.type)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            h.process(lambda s, p: new_scheduler(job.type, s, p), ev)
        assert not h.state.allocs_by_job("default", job.id)
    finally:
        use_device(prev)
        backend.reset()


# the reference's solver exports that wait for the multi-device port
MESH_EXPORTS = {"make_mesh", "sharded_fill_greedy"}


def _exports(path: Path) -> set:
    """Names a package __init__ imports for export."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


def test_port_solver_exports_the_references_names_less_the_mesh():
    want = _exports(REF / "solver" / "__init__.py") - MESH_EXPORTS
    got = _exports(PORT / "solver" / "__init__.py")
    assert want <= got, sorted(want - got)
    import nomad_tpu_torch.solver as solver
    for name in sorted(want):
        assert callable(getattr(solver, name)) or \
            isinstance(getattr(solver, name), int), name
