"""One run of one cell: the port's in-process server, a fleet and a
closed loop of clients, a measured window, and the reference's verdict.

The entry that the window drives is Server.job_register and
Server.job_deregister, through the broker, a worker, the scheduler, the
solver and the plan applier, as far as the FSM commit. The clients stand
in for `nomad job run` and `nomad job stop` (which wait for their eval)
and for the nodes' client agents (which report allocations complete).
"""
from __future__ import annotations

import math
import statistics
import sys
import threading
import time
from contextlib import contextmanager

import numpy as np

from . import fleet as fleet_mod
from . import placement, reference, spec
from . import traffic as traffic_mod

CLIENT_TERMINAL = ("complete", "failed", "lost")
STRAGGLER_S = 60.0      # how long past the close a waited eval may take
SETUP_WAIT_S = 300.0    # the bound of every wait of the set-up
POLL_S = 0.002          # the eval watcher's period


def log(*a) -> None:
    print("[portbench]", *a, file=sys.stderr, flush=True)


class ClientUpdate:
    """What a node's client agent reports of one allocation: the fields
    the server merges onto the stored allocation (Node.UpdateAlloc)."""

    __slots__ = ("id", "client_status", "client_description", "task_states",
                 "network_status", "deployment_status", "modify_time_unix")

    def __init__(self, alloc_id: str, status: str):
        self.id = alloc_id
        self.client_status = status
        self.client_description = ""
        self.task_states = {}
        self.network_status = None
        self.deployment_status = None
        self.modify_time_unix = 0.0


class Watcher:
    """One thread that polls the store for the evals clients wait on and
    stamps each with the time it reached a terminal status."""

    TERMINAL = ("complete", "failed", "cancelled")

    def __init__(self, state):
        self.state = state
        self.pending: dict = {}          # eval_id -> (record, Event)
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, name="pb-watcher",
                                       daemon=True)
        self.thread.start()

    def watch(self, rec: dict) -> threading.Event:
        done = threading.Event()
        with self.lock:
            self.pending[rec["eval_id"]] = (rec, done)
        return done

    def _run(self) -> None:
        while not self.stop.is_set():
            with self.lock:
                items = list(self.pending.items())
            now = time.perf_counter()
            for eid, (rec, done) in items:
                ev = self.state.eval_by_id(eid)
                if ev is not None and ev.status in self.TERMINAL:
                    rec["status"] = ev.status
                    rec["t_done"] = now
                    with self.lock:
                        self.pending.pop(eid, None)
                    done.set()
            time.sleep(POLL_S)

    def close(self) -> None:
        self.stop.set()
        self.thread.join(10.0)


class Spans:
    """The harness's own spans around its calls into the program's layers
    (traced runs only): (name, start ns, end ns) since the epoch, the
    profiler's clock."""

    def __init__(self):
        self.on = False
        self.items: list = []

    @contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))


class Run:
    """One run. `device` "cuda" is the benchmark; the CPU tests pass
    "cpu" with a small `nodes` and `count_scale`, and may pass
    `plan_hook(result, run)`, called on every committed plan result before
    the store applies it (the control and the planted faults), and
    `solve_hook(run)`, which changes the solve layer once the server is
    up and returns what undoes it (the control of the placements)."""

    def __init__(self, bench: dict, cell: str, seed: int, seconds: float,
                 trace: bool, device: str = "cuda", nodes: int = 0,
                 count_scale: float = 1.0, plan_hook=None, solve_hook=None,
                 t_start: float = None, bench_dir=spec.BENCH_DIR):
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.bench = bench
        self.cell = spec.workload(bench, cell)
        self.config = spec.config(bench, self.cell["config"],
                                  root=bench_dir.parent)
        self.mix = spec.traffic(self.cell["traffic"], bench_dir)
        traffic_mod.validate(self.mix)
        self.seed, self.seconds, self.trace = int(seed), float(seconds), \
            bool(trace)
        self.device, self.nodes, self.scale = device, nodes, count_scale
        self.plan_hook, self.solve_hook = plan_hook, solve_hook
        self.undo_solve_hook = None
        self.bench_dir = bench_dir
        self.spans = Spans()
        self.jobs: dict = {}          # job id -> record (the reference's)
        self.evals: list = []         # every waited eval
        self.fleet = fleet_mod.make(self.config["spec"]["fleet"], self.seed,
                                    nodes)
        self.row_of = {nid: i for i, nid in enumerate(self.fleet.ids)}
        self.kernel_calls: list = []
        self.close_at = math.inf
        self.commits: list = []       # (index, placed, ended, evicted)
        self.client_ends: list = []   # (index, alloc ids)
        self.proposals: list = []     # every plan the workers submitted
        self.allocs = None            # the committed allocations (finish)

    # ------------------------------------------------------------ program

    def _job(self, rec: dict):
        """The program's job for a record."""
        from nomad_tpu_torch import mock, structs
        job = mock.batch_job() if rec["type"] == "batch" else mock.job()
        job.id = job.name = rec["id"]
        job.priority = rec["priority"]
        job.datacenters = list(rec["datacenters"])
        tg = job.task_groups[0]
        tg.count = rec["count"]
        tg.ephemeral_disk.size_mb = rec["disk_mb"]
        tg.networks = []
        task = tg.tasks[0]
        task.resources.cpu = rec["cpu_mhz"]
        task.resources.memory_mb = rec["memory_mb"]
        task.resources.networks = []
        sp = rec.get("spread")
        if sp:
            job.spreads = [structs.Spread(attribute=sp["attribute"],
                                          weight=sp["weight"])]
        return job

    def _record(self, rec: dict, scale: bool = True) -> dict:
        rec = dict(rec)
        if scale and self.scale != 1.0:
            rec["count"] = max(1, int(rec["count"] * self.scale))
        self.jobs[rec["id"]] = rec
        return rec

    def _nodes(self):
        from nomad_tpu_torch import mock
        f = self.fleet
        out = []
        for i, nid in enumerate(f.ids):
            n = mock.node()
            n.id = nid
            n.name = f"pb-{i}"
            n.datacenter = f.dc[i]
            n.node_class = f.node_class[i]
            if f.rack[i]:
                n.meta["rack"] = f.rack[i]
            r = n.node_resources
            r.cpu.cpu_shares = int(f.cpu[i])
            r.memory.memory_mb = int(f.mem[i])
            r.disk.disk_mb = int(f.disk[i])
            res = n.reserved_resources
            res.cpu_shares, res.memory_mb, res.disk_mb = f.reserved
            n.compute_class()
            out.append(n)
        return out

    def _server(self):
        from nomad_tpu_torch import structs
        from nomad_tpu_torch.server import Server
        srv_spec = self.config["spec"]["server"]
        gc = srv_spec["gc"]
        srv = Server(num_workers=srv_spec["workers"],
                     gc_interval=gc["interval_s"])
        srv.core_scheduler.job_gc_threshold = gc["job_threshold_s"]
        srv.core_scheduler.eval_gc_threshold = gc["eval_threshold_s"]
        # the simulated clients send no heartbeats: their nodes' TTL
        # outlasts the run
        srv.heartbeats.min_ttl = 3600.0
        srv.start()
        sched = dict(srv_spec["scheduler"])
        pre = sched.pop("preemption_config", None)
        if pre is not None:
            sched["preemption_config"] = structs.PreemptionConfig(**pre)
        srv.set_scheduler_configuration(
            structs.SchedulerConfiguration(**sched))
        return srv

    def _tap(self, srv) -> None:
        """Record every commit the store applies, in commit order: the
        placements of each plan result, and the allocations it stops or
        evicts and that clients report terminal, by raft index. The
        reference reads these, so the server's own garbage collection of
        finished jobs takes nothing from it. A `plan_hook` (the control,
        a planted fault) sees each plan result first."""
        store = srv.state
        plans, clients = store.upsert_plan_results, \
            store.update_allocs_from_client
        run, hook = self, self.plan_hook

        def upsert(index, result):
            if hook is not None:
                hook(result, run)
            placed = list(result.alloc_placements)
            ended = [a for a in result.alloc_updates if a.terminal_status()]
            evicted = list(getattr(result, "alloc_preemptions", ()) or ())
            out = plans(index, result)
            run.commits.append((index, placed, ended, evicted))
            return out

        def client_update(index, allocs):
            out = clients(index, allocs)
            run.client_ends.append(
                (index, [a.id for a in allocs
                         if a.client_status in CLIENT_TERMINAL]))
            return out
        store.upsert_plan_results = upsert
        store.update_allocs_from_client = client_update

        # the plans as the solve proposed them, before the applier: what
        # the reference of the placements judges, node by node
        planner = srv.planner
        sub, sub_async = planner.submit_plan, planner.submit_plan_async

        def propose(plan):
            if plan.node_allocation:
                run.proposals.append((
                    plan.eval_id, plan.snapshot_index,
                    plan.job.id if plan.job is not None else "",
                    [(nid, len(v)) for nid, v in
                     plan.node_allocation.items()]))

        def submit(plan, *a, **kw):
            propose(plan)
            return sub(plan, *a, **kw)

        def submit_async(plan, *a, **kw):
            propose(plan)
            return sub_async(plan, *a, **kw)
        planner.submit_plan = submit
        planner.submit_plan_async = submit_async

    # ------------------------------------------------------------ clients

    def _wait(self, rec: dict) -> None:
        """Wait for the eval: until STRAGGLER_S past the window's close,
        or in set-up SETUP_WAIT_S."""
        done = self.watcher.watch(rec)
        self.evals.append(rec)
        end = self.close_at + STRAGGLER_S if self.close_at < math.inf \
            else time.perf_counter() + SETUP_WAIT_S
        done.wait(max(0.0, end - time.perf_counter()))

    def _register(self, rec: dict, kind: str) -> dict:
        t0 = time.perf_counter()
        with self.spans.span("client.register"):
            eid = self.srv.job_register(self._job(rec))["eval_id"]
        ev = {"eval_id": eid, "job_id": rec["id"], "kind": kind,
              "t_call": t0, "t_done": None, "status": "pending"}
        with self.spans.span("client.wait"):
            self._wait(ev)
        return ev

    def _deregister(self, job_id: str) -> dict:
        t0 = time.perf_counter()
        with self.spans.span("client.deregister"):
            eid = self.srv.job_deregister("default", job_id)["eval_id"]
        ev = {"eval_id": eid, "job_id": job_id, "kind": "deregister",
              "t_call": t0, "t_done": None, "status": "pending"}
        with self.spans.span("client.wait"):
            self._wait(ev)
        return ev

    def _complete(self, job_id: str) -> None:
        """The nodes' clients report every allocation of the job complete:
        node by node, as each client agent reports its own, coalesced into
        one update as the server coalesces client updates into one log
        entry."""
        with self.spans.span("client.complete"):
            live = sorted((a.node_id, a.id) for a in
                          self.srv.state.allocs_by_job("default", job_id)
                          if not a.terminal_status())
            follow = []
            if live:
                follow = self.srv.node_update_allocs(
                    [ClientUpdate(aid, "complete") for _, aid in live]
                )["eval_ids"]
        # the evals the completion creates run before the client's next
        # job, so that job's eval meets no other in flight; no latency is
        # taken of them
        with self.spans.span("client.wait"):
            for eid in follow:
                self._wait({"eval_id": eid, "job_id": job_id,
                            "kind": "follow-up", "t_call": time.perf_counter(),
                            "t_done": None, "status": "pending"})

    def _cycle(self, client, k: int, history: list,
               placed_lag_override: int = None) -> None:
        rec = self._record(client.job(k))
        history.append(rec["id"])
        self._register(rec, "register")
        for act in self.mix.get("after_commit", []):
            lag = act.get("lag", 0) if placed_lag_override is None \
                else placed_lag_override
            if act["do"] == "complete" and len(history) > lag:
                self._complete(history[-1 - lag])
            elif act["do"] == "deregister" and len(history) > lag:
                self._deregister(history[-1 - lag])
            elif act["do"] == "refill":
                self._register(self.jobs[self.filler_id], "refill")

    def _client_loop(self, client, i: int) -> None:
        """A client's closed loop, until the window closes."""
        history: list = []
        k = 0
        while time.perf_counter() < self.close_at:
            self._cycle(client, k, history)
            k += 1
            self.cycles[i] = k

    # --------------------------------------------------------------- run

    def _idle(self, timeout: float) -> None:
        """Wait until the broker holds no eval and no worker one."""
        b = self.srv.eval_broker
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            if b.depth() == 0 and not b._unack:
                return
            time.sleep(0.005)
        raise RuntimeError("the server did not go idle in set-up")

    def setup(self) -> None:
        from nomad_tpu_torch.solver import device as solver_device
        solver_device.use_device("cpu" if self.device == "cpu" else
                                 "cuda:0")
        log(f"the port imported at {time.perf_counter() - self.t_start:.2f} s")
        self.srv = self._server()
        self._tap(self.srv)
        if self.solve_hook is not None:
            self.undo_solve_hook = self.solve_hook(self)
        self.watcher = Watcher(self.srv.state)
        log(f"server up at {time.perf_counter() - self.t_start:.2f} s")
        for n in self._nodes():
            self.srv.node_register(n)
        log(f"{len(self.fleet)} nodes registered at "
            f"{time.perf_counter() - self.t_start:.2f} s")
        tag = f"pb{self.seed}"
        self.filler_id = None
        if self.mix.get("filler"):
            f = self.mix["filler"]
            ask = (f["cpu_mhz"], f["memory_mb"], f["disk_mb"])
            rec = self._record(traffic_mod.filler_job(
                self.mix, tag, traffic_mod.fill_count(
                    self.fleet.capacity(), ask)), scale=False)
            self.filler_id = rec["id"]
            self._register(rec, "refill")
            log(f"filler of {rec['count']} placed at "
                f"{time.perf_counter() - self.t_start:.2f} s")
        # one cycle of every kind the mix sends, each with its own
        # follow-up at once, so the window meets nothing unbuilt
        warm = traffic_mod.Client(self.mix, self.seed, 0, f"{tag}-warm")
        sizes = sorted(set(warm.order))
        for k in sorted({warm.order.index(sizes[0]),
                         warm.order.index(sizes[-1])}):
            self._cycle(warm, k, [], placed_lag_override=0)
            log(f"warm cycle of {warm.order[k]} at "
                f"{time.perf_counter() - self.t_start:.2f} s")
        self._idle(SETUP_WAIT_S)
        log(f"idle at {time.perf_counter() - self.t_start:.2f} s")
        self.clients = [traffic_mod.Client(self.mix, self.seed, c,
                                           f"{tag}-w")
                        for c in range(int(self.mix["clients"]))]

    def window(self) -> None:
        """Start the clients; open the window once each has run the cycles
        its mix's longest lag needs to reach its steady state (set-up);
        close it `seconds` later. Evals in flight at the close are waited
        for, STRAGGLER_S at the most."""
        from nomad_tpu_torch.metrics import metrics
        from . import layers
        self.n_setup_evals = len(self.evals)
        self.cycles = [0] * len(self.clients)
        threads = [threading.Thread(target=self._client_loop, args=(c, i),
                                    name=f"pb-client-{i}")
                   for i, c in enumerate(self.clients)]
        for t in threads:
            t.start()
        ramp = 1 + max([a.get("lag", 0)
                        for a in self.mix.get("after_commit", [])] or [0])
        end = time.perf_counter() + SETUP_WAIT_S
        while min(self.cycles) < ramp:
            if time.perf_counter() > end:
                raise RuntimeError(f"the clients ran {self.cycles} cycles "
                                   f"of the {ramp} the ramp needs")
            time.sleep(0.002)
        log(f"ramp of {ramp} cycles a client done at "
            f"{time.perf_counter() - self.t_start:.2f} s")
        self.probe = layers.Probe(metrics) if self.trace else None
        prof = None
        if self.trace:
            from . import devtrace
            prof = devtrace.Profiler(self)
            prof.start()
        self.i_open = self.srv.state.latest_index()
        self.t_open = time.perf_counter()
        self.close_at = self.t_open + self.seconds
        time.sleep(max(0.0, self.close_at - time.perf_counter()))
        self.t_close = time.perf_counter()
        self.i_close = self.srv.state.latest_index()
        if self.probe is not None:
            self.probe.close()
        self.device_trace = prof.stop() if prof is not None else None
        if prof is not None:
            launches: dict = {}
            for c in self.kernel_calls:
                key = c.get("launch", "?") + (" (error)" if "error" in c
                                              else "")
                launches[key] = launches.get(key, 0) + 1
            log(f"hand-kernel calls recorded in the window: {launches}")
        for t in threads:
            t.join(STRAGGLER_S + 30.0)
        self.stragglers_alive = sum(t.is_alive() for t in threads)
        log(f"window closed; {len(self.evals) - self.n_setup_evals} evals "
            f"waited on since the ramp began, {self.stragglers_alive} "
            f"clients still waiting")

    def _extract(self) -> reference.Allocs:
        """The committed allocations, from the commits recorded."""
        end: dict = {}
        preempted_by: dict = {}

        def ended(aid, index):
            if index < end.get(aid, reference.LIVE):
                end[aid] = index
        for index, ids in self.client_ends:
            for aid in ids:
                ended(aid, index)
        placed = []
        for index, new, stopped, evicted in self.commits:
            placed.extend(a for a in new if a.create_index == index)
            for a in stopped:
                ended(a.id, index)
            for a in evicted:
                ended(a.id, index)
                preempted_by[a.id] = a.preempted_by_allocation
        out = reference.Allocs()
        n = len(placed)
        out.ids = [a.id for a in placed]
        out.job = [a.job_id for a in placed]
        out.name = np.fromiter((int(a.name[a.name.rindex("[") + 1:-1])
                                for a in placed), np.int64, n)
        out.row = np.fromiter((self.row_of.get(a.node_id, -1)
                               for a in placed), np.int64, n)
        out.create = np.fromiter((a.create_index for a in placed), np.int64,
                                 n)
        out.end = np.fromiter((end.get(i, reference.LIVE) for i in out.ids),
                              np.int64, n)
        out.evicted = np.fromiter((i in preempted_by for i in out.ids),
                                  bool, n)
        out.eval_id = [a.eval_id for a in placed]
        out.preempted_by = [preempted_by.get(i, "") for i in out.ids]
        return out

    def _judge_placements(self, allocs) -> dict:
        """The reference of the solve layer over the passes the clients'
        register evals made (placement.judge)."""
        sched = self.config["spec"]["server"]["scheduler"]
        if not sched.get("plan_pipeline_enabled", True):
            pipeline = None
        elif "plan_pipeline_min_count" in sched:
            pipeline = {"min_count": int(sched["plan_pipeline_min_count"]),
                        "chunks": int(sched["plan_pipeline_chunks"])}
        else:
            pipeline = placement.UNSTATED
        waited = {e["eval_id"] for e in self.evals
                  if e["kind"] == "register"}
        passes = [p for p in placement.group(self.proposals)
                  if p.eval_id in waited]
        return placement.judge(self.fleet, allocs, self.jobs, passes,
                               self.row_of, pipeline,
                               int(self.mix.get("compare_passes", 0)),
                               self.seed,
                               sched.get("scheduler_algorithm", "tpu-batch"))

    def finish(self) -> dict:
        import torch
        on_card = self.device != "cpu"
        peak = torch.cuda.max_memory_allocated(0) if on_card else 0
        self.srv.shutdown()
        for w in self.srv.workers:
            w.join(60.0)
        self.watcher.close()
        if self.undo_solve_hook is not None:
            self.undo_solve_hook()
        log(f"server stopped at {time.perf_counter() - self.t_start:.2f} s")
        allocs = self.allocs = self._extract()
        limits = self.mix["limits"]
        t0 = time.perf_counter()
        numbers = reference.judge(
            self.fleet, allocs, self.jobs, self.evals,
            {k: v for k, v in limits.items() if k != "misplaced_pct"},
            run=self, bench_dir=self.bench_dir)
        t1 = time.perf_counter()
        log(f"{len(allocs)} allocations judged in {t1 - t0:.2f} s")
        if "misplaced_pct" in limits:
            got = self._judge_placements(allocs)
            numbers["misplaced_pct"] = {
                "value": 100.0 * got["misplaced"] / max(got["compared"], 1),
                "limit": limits["misplaced_pct"]}
            log(f"placements of {got['passes']} passes ({got['compared']} "
                f"instances) worked out again in "
                f"{time.perf_counter() - t1:.2f} s: {got['misplaced']} "
                f"misplaced")
        self.reference_s = time.perf_counter() - t0
        win = [e for e in self.evals[self.n_setup_evals:]
               if self.t_open <= e["t_call"] < self.t_close
               and e["kind"] != "follow-up"]
        # the wait `nomad job run` shows: the clients' own jobs, from the
        # register call to the eval complete (stops and refills are
        # traffic, and their evals are judged, but not timed here)
        lat = sorted(e["t_done"] - e["t_call"] for e in win
                     if e["kind"] == "register" and e["status"] == "complete"
                     and e["t_done"])
        placed = int(((allocs.create > self.i_open)
                      & (allocs.create <= self.i_close)).sum())
        miss = _missing_by_eval(allocs, self.jobs, win)
        failed = sum(1 for e in win if e["status"] != "complete"
                     or miss.get(e["eval_id"], 0) > 0)
        self.latencies = lat
        return {"numbers": numbers, "latencies": lat, "placed": placed,
                "window_s": self.t_close - self.t_open,
                "attempted": len(win), "failed": failed,
                "memory_peak_bytes": int(peak),
                "stragglers_alive": self.stragglers_alive,
                "allocs": len(allocs)}


def _missing_by_eval(allocs, jobs: dict, evals: list) -> dict:
    got: dict = {}
    for e, n in zip(allocs.eval_id, allocs.name.tolist()):
        got.setdefault(e, set()).add(n)
    return {e["eval_id"]: jobs[e["job_id"]]["count"]
            - len(got.get(e["eval_id"], set())
                  & set(range(jobs[e["job_id"]]["count"])))
            for e in evals if e["kind"] == "register"}


def quantile(values: list, q: float) -> float:
    """The q-quantile of all values, by linear interpolation between
    order statistics (statistics.quantiles' inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    n = 100
    cuts = statistics.quantiles(values, n=n, method="inclusive")
    return float(cuts[int(round(q * n)) - 1])
