"""Client / node agent (ref client/client.go:325 NewClient, run:1710,
registerAndHeartbeat:1584, watchAllocations:2033, runAllocs:2263,
restoreState:1090).

Talks to the server through an RPC interface (in-process for -dev mode,
HTTP otherwise): node_register / node_heartbeat / node_update_status /
node_get_client_allocs / node_update_allocs.
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Optional

from .. import chrono
from ..metrics import metrics, record_swallowed_error
from ..structs import (
    Allocation, Node, ALLOC_DESIRED_STOP, NODE_STATUS_DOWN,
    NODE_STATUS_INIT, NODE_STATUS_READY, new_id,
)
from .alloc_runner import AllocRunner
from .driver import BUILTIN_DRIVERS, Driver
from .fingerprint import fingerprint_drivers, fingerprint_node
from .state_db import StateDB


class Client:
    def __init__(self, rpc, data_dir: str, datacenter: str = "dc1",
                 node_class: str = "", name: str = "",
                 drivers: Optional[dict[str, Driver]] = None,
                 logger=None, plugin_dir: str = "",
                 clock: Optional[chrono.Clock] = None, seed: int = 0):
        self.rpc = rpc
        self.data_dir = data_dir
        # heartbeat bookkeeping and retry jitter ride the injectable
        # clock (ISSUE 18): partition sims time-compress the whole
        # disconnect/reconnect cycle on a ManualClock; `seed` makes the
        # retry jitter stream reproducible
        self._clock = clock or chrono.REAL
        self._hb_rng = random.Random(f"client-hb:{seed}:{name}")
        self.alloc_dir_root = os.path.join(data_dir, "allocs")
        self.logger = logger or (lambda msg: None)
        os.makedirs(self.alloc_dir_root, exist_ok=True)

        self.state_db = StateDB(os.path.join(data_dir, "client_state.db"))
        self.drivers: dict[str, Driver] = drivers if drivers is not None \
            else {name: cls() for name, cls in BUILTIN_DRIVERS.items()}
        # external plugins (ref client config plugin_dir + go-plugin
        # Discover): subprocess drivers join the same registry; CSI
        # plugins register with the csimanager below once it exists
        if plugin_dir:
            from .plugin_host import discover_all
            found = discover_all(plugin_dir, self.logger)
            self.plugin_drivers = found["driver"]
            self._plugin_csi = found["csi"]
            self.drivers.update(self.plugin_drivers)
        else:
            self.plugin_drivers = {}
            self._plugin_csi = {}
        for d in self.drivers.values():
            # catalog access (connect proxy); ext drivers are duck-typed
            bind = getattr(d, "bind_client", None)
            if bind is not None:
                bind(self)

        from .csimanager import CSIManager
        self.csi_manager = CSIManager(self)
        for plug_id, plug in self._plugin_csi.items():
            # discovered subprocess CSI plugins (ref plugins/csi/client.go:
            # external processes behind the node/controller contract); the
            # node fingerprint picks them up below
            self.csi_manager.register_plugin(
                plug_id, plug, controller=plug.requires_controller)
        from .devicemanager import DeviceManager
        self.device_manager = DeviceManager(self)
        # shared bridge-network hook: one IP allocator + one nomad bridge
        # per client (ref client/allocrunner/networkmanager_linux.go)
        from .network_hook import NetworkHook
        self.network_hook = NetworkHook(logger=self.logger)

        node_id = self.state_db.get_node_id()
        self.node: Node = fingerprint_node(data_dir, datacenter, node_class,
                                           name, node_id)
        self.state_db.put_node_id(self.node.id)
        self.node.drivers = fingerprint_drivers(self.drivers)
        for dname, info in self.node.drivers.items():
            if info.detected:
                self.node.attributes[f"driver.{dname}"] = "1"
        if self._plugin_csi:
            self.node.csi_node_plugins = self.csi_manager.fingerprint()
            self.node.csi_controller_plugins = \
                self.csi_manager.fingerprint_controllers()
        self.node.status = NODE_STATUS_INIT
        self.node.compute_class()

        # GC knobs (ref client/config gc_interval, gc_disk_usage_threshold,
        # gc_max_allocs)
        self.gc_interval_sec = 60.0
        # template watch cadence (consul-template's re-render loop analog)
        self.template_interval_sec = 2.0
        self.gc_max_allocs = 50
        self.gc_disk_usage_threshold = 80.0

        self._lock = threading.Lock()
        self.alloc_runners: dict[str, AllocRunner] = {}
        self._alloc_versions: dict[str, int] = {}   # alloc_id -> modify_index
        self._last_alloc_index = 0
        self._heartbeat_ttl = 10.0
        # heartbeat-stop (ref client/heartbeatstop.go): allocs whose TG
        # sets stop_after_client_disconnect are stopped LOCALLY when the
        # client has been unable to heartbeat for that long — the client
        # half of the server-side lost-alloc handling
        # (reconcile_util.delay_by_stop_after_client_disconnect)
        self._last_heartbeat_ok = self._clock.monotonic()
        self._shutdown = threading.Event()
        # consecutive _watch_allocations failures; >0 marks a suspected
        # partition, and the first successful poll after one triggers a
        # full reconcile against the server's view (ISSUE 18)
        self._watch_failures = 0
        self._dirty_allocs: set[str] = set()
        self._dirty_cond = threading.Condition()
        self._exec_sessions: dict[str, list] = {}  # sid -> [session, last]
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._restore_state()
        self._register()
        for target, name in ((self._heartbeat_loop, "client-heartbeat"),
                             (self._watch_allocations, "client-watch-allocs"),
                             (self._sync_allocs_loop, "client-alloc-sync"),
                             (self._heartbeat_stop_loop,
                              "client-heartbeat-stop"),
                             (self._gc_loop, "client-gc"),
                             (self._stats_loop, "client-task-stats")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    # stats hook cadence (ref taskrunner/stats_hook.go driving
    # DriverStats at the telemetry collection interval)
    stats_interval_sec = 1.0

    def _stats_loop(self) -> None:
        """Periodic per-task usage sampling (ref
        client/allocrunner/taskrunner/stats_hook.go + setGaugeForMemory/
        CpuStats in client.go:2600 emitStats): every running task's
        cpu/rss is pulled from its driver and published as gauges keyed
        by job/group/task — never by alloc id, which would grow metric
        cardinality without bound. The on-demand alloc_stats API keeps
        serving point-in-time reads independently of this loop."""
        from ..metrics import metrics
        published: set[tuple] = set()
        while not self._shutdown.wait(self.stats_interval_sec):
            try:
                with self._lock:
                    runners = list(self.alloc_runners.values())
                rollup: dict[tuple, tuple] = {}
                for ar in runners:
                    alloc = ar.alloc
                    # snapshot under the runner's own lock: task starts
                    # mutate the dict concurrently, and an unguarded
                    # iteration error would kill this daemon thread
                    with ar._lock:
                        task_runners = dict(ar.task_runners)
                    for name, tr in task_runners.items():
                        try:
                            st = tr.stats()
                        except Exception:  # noqa: BLE001 — mid-stop
                            continue
                        key = (alloc.job_id, alloc.task_group, name)
                        cpu, rss = rollup.get(key, (0.0, 0))
                        rollup[key] = (cpu + st.get("cpu_percent", 0.0),
                                       rss + st.get("memory_rss_bytes", 0))
                for (job, tg, task), (cpu, rss) in rollup.items():
                    base = f"nomad.client.allocs.{job}.{tg}.{task}"
                    # per-live-task gauges: bounded by tasks on THIS
                    # client, and the retire pass below deletes rows on
                    # churn — cardinality cannot grow without bound
                    # nomadlint: disable=OBS001 — bounded + retired below
                    metrics.set_gauge(f"{base}.cpu_percent", cpu)
                    # nomadlint: disable=OBS001 — bounded + retired below
                    metrics.set_gauge(f"{base}.memory_rss_bytes",
                                      float(rss))
                # retire gauges for tasks that stopped since last cycle:
                # without this, dead jobs report phantom usage forever
                # and job churn grows the gauge set without bound
                for job, tg, task in published - set(rollup):
                    base = f"nomad.client.allocs.{job}.{tg}.{task}"
                    metrics.gauges.pop(f"{base}.cpu_percent", None)
                    metrics.gauges.pop(f"{base}.memory_rss_bytes", None)
                published = set(rollup)
            except Exception as e:      # noqa: BLE001 — sampler survives
                self.logger(f"client: stats sample failed: {e!r}")

    def shutdown(self) -> None:
        self._shutdown.set()
        with self._dirty_cond:
            self._dirty_cond.notify_all()
        with self._lock:
            runners = list(self.alloc_runners.values())
        for ar in runners:
            for tr in list(ar.task_runners.values()):
                tr.kill("client shutting down")
        # kill() only signals; wait for the runner threads to actually
        # stop their drivers so subprocesses and proxy listeners are gone
        # when shutdown returns — a fresh client on this host may be
        # assigned the same dynamic ports immediately. ONE shared
        # deadline: many slow-dying tasks must not serialize into
        # minutes of shutdown
        deadline = time.monotonic() + 5.0
        for ar in runners:
            for tr in list(ar.task_runners.values()):
                try:
                    tr.wait_done(timeout=max(0.0,
                                             deadline - time.monotonic()))
                # shutdown path: a runner that outlives the shared
                # deadline is logged by its own kill path; nothing to do
                except Exception:  # nomadlint: disable=EXC001 — shutdown best-effort
                    pass
        for drv in self.plugin_drivers.values():
            drv.shutdown()
        for plug in self._plugin_csi.values():
            plug.shutdown()

    # ---------------------------------------------------------- registration

    def _register(self) -> None:
        """ref client.go:1584 registerAndHeartbeat (register half)"""
        while not self._shutdown.is_set():
            try:
                resp = self.rpc.node_register(self.node)
                self._heartbeat_ttl = resp.get("heartbeat_ttl", 10.0)
                break
            except Exception as e:      # noqa: BLE001
                self.logger(f"client: register failed: {e!r}")
                self._shutdown.wait(1.0)
        try:
            self.rpc.node_update_status(self.node.id, NODE_STATUS_READY)
            self.node.status = NODE_STATUS_READY
        except Exception as e:          # noqa: BLE001
            self.logger(f"client: ready update failed: {e!r}")

    # a failed beat is retried this many times within ONE loop tick,
    # after short seeded jitter — N dropped requests must not cost
    # N * TTL/2 of silence and an invalidation (ISSUE 18)
    HEARTBEAT_RETRIES = 3
    HEARTBEAT_RETRY_JITTER_S = (0.1, 0.5)

    def _heartbeat_once(self) -> bool:
        """One heartbeat with bounded in-tick retries. Returns True when
        a beat landed. Test-drivable without the loop thread."""
        last_exc: Optional[Exception] = None
        for attempt in range(1 + self.HEARTBEAT_RETRIES):
            if self._shutdown.is_set():
                return False
            if attempt:
                metrics.incr("nomad.client.heartbeat_retries")
                lo, hi = self.HEARTBEAT_RETRY_JITTER_S
                self._clock.sleep(lo + (hi - lo) * self._hb_rng.random())
            try:
                resp = self.rpc.node_update_status(self.node.id,
                                                   NODE_STATUS_READY)
                self._heartbeat_ttl = resp.get("heartbeat_ttl",
                                               self._heartbeat_ttl)
                self._last_heartbeat_ok = self._clock.monotonic()
                return True
            except Exception as e:      # noqa: BLE001
                last_exc = e
                self.logger(f"client: heartbeat failed "
                            f"(attempt {attempt + 1}): {e!r}")
        # retries exhausted — re-register OUTSIDE the retry ladder: the
        # server may have GC'd us. A silent re-register failure leaves
        # the node invisibly dead (EXC001) — count + log it; the loop
        # retries next tick
        self.logger(f"client: heartbeat gave up after "
                    f"{1 + self.HEARTBEAT_RETRIES} attempts: {last_exc!r}")
        try:
            self.rpc.node_register(self.node)
            self.rpc.node_update_status(self.node.id, NODE_STATUS_READY)
            self._last_heartbeat_ok = self._clock.monotonic()
            return True
        except Exception as e2:         # noqa: BLE001
            record_swallowed_error("client.heartbeat.reregister",
                                   e2, self.logger)
            return False

    def _heartbeat_loop(self) -> None:
        # heartbeats go through UpdateStatus(ready), not a bare TTL reset,
        # so a node the server marked down transitions back to ready and
        # blocked evals unblock (ref client.go registerAndHeartbeat ->
        # Node.UpdateStatus)
        while not self._shutdown.wait(max(0.2, self._heartbeat_ttl / 2)):
            self._heartbeat_once()

    def _heartbeat_stop_loop(self) -> None:
        """Stop allocs locally after prolonged server disconnection (ref
        client/heartbeatstop.go watch): a TG opting in via
        stop_after_client_disconnect must not keep running on a
        partitioned node past that grace — the server will have replaced
        it, and two live copies of (say) a singleton service is exactly
        what the knob exists to prevent."""
        while not self._shutdown.wait(1.0):
            silence = self._clock.monotonic() - self._last_heartbeat_ok
            if silence <= self._heartbeat_ttl:
                continue
            with self._lock:
                runners = list(self.alloc_runners.values())
            for ar in runners:
                alloc = ar.alloc
                job = alloc.job
                tg = job.lookup_task_group(alloc.task_group) if job else None
                if tg is None or tg.stop_after_client_disconnect_sec is None:
                    continue
                if silence <= tg.stop_after_client_disconnect_sec:
                    continue
                if alloc.terminal_status():
                    continue
                self.logger(
                    f"client: stopping alloc {alloc.id[:8]} after "
                    f"{silence:.0f}s without a successful heartbeat "
                    f"(stop_after_client_disconnect)")
                for tr in list(ar.task_runners.values()):
                    tr.kill("client disconnected from servers")

    # --------------------------------------------------------- alloc watch

    def _watch_allocations(self) -> None:
        """Long-poll the server for alloc changes (ref client.go:2033).

        Reconnect reconciliation (ISSUE 18): after ANY poll failure the
        next contact does a full `_reconcile_allocs()` instead of
        resuming the incremental long-poll — during the outage the
        server may have replaced/stopped allocs at indexes this client
        never saw, and trusting `_last_alloc_index` would silently skip
        them."""
        while not self._shutdown.is_set():
            if self._watch_failures:
                if self._reconcile_allocs():
                    self._watch_failures = 0
                else:
                    self._shutdown.wait(1.0)
                continue
            try:
                resp = self.rpc.node_get_client_allocs(
                    self.node.id, min_index=self._last_alloc_index,
                    timeout=5.0)
            except Exception as e:      # noqa: BLE001
                self.logger(f"client: watch allocs failed: {e!r}")
                self._watch_failures += 1
                self._shutdown.wait(1.0)
                continue
            self._last_alloc_index = max(self._last_alloc_index,
                                         resp.get("index", 0))
            self._run_allocs(resp.get("allocs", {}))

    def _reconcile_allocs(self) -> bool:
        """Resync alloc state against the server's CURRENT view at a
        known index (the heal half of a partition). timeout=0.0 makes
        Node.GetClientAllocs return immediately with the full alloc map
        + the server's index; `_run_allocs` then applies adds/updates
        AND removals, and every surviving alloc is marked dirty so the
        sync loop re-pushes client status the server may have missed.
        Returns True once the resync landed."""
        try:
            resp = self.rpc.node_get_client_allocs(
                self.node.id, min_index=0, timeout=0.0)
        except Exception as e:          # noqa: BLE001
            self.logger(f"client: reconcile failed: {e!r}")
            return False
        index = resp.get("index", 0)
        self._run_allocs(resp.get("allocs", {}))
        # adopt the server's index only AFTER the diff applied: a crash
        # in between re-reconciles rather than skipping the window
        self._last_alloc_index = max(self._last_alloc_index, index)
        with self._lock:
            survivors = list(self.alloc_runners)
        with self._dirty_cond:
            self._dirty_allocs.update(survivors)
            self._dirty_cond.notify_all()
        metrics.incr("nomad.client.reconnect_reconciles")
        self.logger(f"client: reconciled {len(survivors)} allocs at "
                    f"server index {index} after reconnect")
        return True

    def _run_allocs(self, server_allocs: dict[str, int]) -> None:
        """Diff desired vs running (ref client.go:2263 runAllocs)."""
        with self._lock:
            known = dict(self._alloc_versions)
        # removed allocs: server no longer tracks them => destroy
        for alloc_id in set(known) - set(server_allocs):
            self._remove_alloc(alloc_id)
        # new or updated
        for alloc_id, modify_index in server_allocs.items():
            if known.get(alloc_id) == modify_index:
                continue
            try:
                alloc = self.rpc.alloc_get(alloc_id)
            except Exception as e:      # noqa: BLE001
                self.logger(f"client: fetch alloc {alloc_id[:8]}: {e!r}")
                continue
            if alloc is None:
                continue
            with self._lock:
                self._alloc_versions[alloc_id] = modify_index
                existing = self.alloc_runners.get(alloc_id)
            if existing is not None:
                existing.update(alloc)
            elif not alloc.terminal_status():
                self._add_alloc(alloc)

    def _add_alloc(self, alloc: Allocation) -> None:
        ar = AllocRunner(self, alloc)
        with self._lock:
            self.alloc_runners[alloc.id] = ar
        self.state_db.put_allocation(alloc)
        ar.run()

    def _remove_alloc(self, alloc_id: str) -> None:
        with self._lock:
            ar = self.alloc_runners.pop(alloc_id, None)
            self._alloc_versions.pop(alloc_id, None)
        if ar is not None:
            ar.destroy()
        self.state_db.delete_allocation(alloc_id)

    # ----------------------------------------------------------- alloc sync

    def alloc_state_updated(self, ar: AllocRunner) -> None:
        with self._dirty_cond:
            self._dirty_allocs.add(ar.alloc.id)
            self._dirty_cond.notify_all()
        # persist reattach handles on every transition
        self.state_db.put_task_handles(ar.alloc.id, ar.persistable_handles())

    def _sync_allocs_loop(self) -> None:
        """Batched client->server status updates (ref client.go
        allocSync)."""
        while not self._shutdown.is_set():
            with self._dirty_cond:
                if not self._dirty_allocs:
                    self._dirty_cond.wait(0.5)
                dirty = list(self._dirty_allocs)
                self._dirty_allocs.clear()
            # service registration retry (the consul sync-loop analog): a
            # running alloc whose register RPC failed re-attempts each pass
            with self._lock:
                runners = list(self.alloc_runners.values())
            for ar in runners:
                with ar._lock:
                    any_running = any(s.state == "running"
                                      for s in ar.task_states.values())
                if not ar._services_registered and any_running:
                    try:
                        ar._register_services()
                    except Exception as e:      # noqa: BLE001
                        self.logger(f"client: service sync: {e!r}")
            # deployment health is time-based (min_healthy_time elapses with
            # no task-state change), so allocs with an undecided verdict are
            # re-evaluated every pass (ref allocrunner health_hook's timer)
            with self._lock:
                for alloc_id, ar in self.alloc_runners.items():
                    if alloc_id in dirty:
                        continue
                    if ar.alloc.deployment_id and (
                            ar.alloc.deployment_status is None or
                            ar.alloc.deployment_status.healthy is None):
                        dirty.append(alloc_id)
            if not dirty:
                continue
            updates = []
            with self._lock:
                for alloc_id in dirty:
                    ar = self.alloc_runners.get(alloc_id)
                    if ar is not None:
                        updates.append(ar.client_alloc())
            if not updates:
                continue
            try:
                self.rpc.node_update_allocs(updates)
                # GC eligibility: a terminal status the server has acked
                # (ref client/gc.go — collection waits for server sync)
                with self._lock:
                    for u in updates:
                        if u.client_terminal_status() and \
                                u.id in self.alloc_runners:
                            self.alloc_runners[u.id].synced_terminal = True
            except Exception as e:      # noqa: BLE001
                self.logger(f"client: alloc sync failed: {e!r}")
                with self._dirty_cond:
                    self._dirty_allocs.update(dirty)
                self._shutdown.wait(0.5)

    # -------------------------------------------------------------- restore

    def _restore_state(self) -> None:
        """Reattach to allocs from the local state DB (ref client.go:1090
        restoreState)."""
        for alloc in self.state_db.get_all_allocations():
            if alloc.server_terminal_status():
                self.state_db.delete_allocation(alloc.id)
                continue
            handles = self.state_db.get_task_handles(alloc.id)
            ar = AllocRunner(self, alloc)
            with self._lock:
                self.alloc_runners[alloc.id] = ar
            if handles:
                ar.restore(handles)

    # -------------------------------------------------------------- helpers

    # ------------------------------------------------- client API surface
    # (ref client/alloc_endpoint.go, client/fs_endpoint.go — served over
    # HTTP by the agent, reachable directly or via server proxy)

    def _runner(self, alloc_id: str) -> AllocRunner:
        with self._lock:
            ar = self.alloc_runners.get(alloc_id)
        if ar is None:
            raise KeyError(f"unknown allocation {alloc_id!r}")
        return ar

    def alloc_signal(self, alloc_id: str, task: str = "",
                     sig: str = "SIGUSR1") -> None:
        self._runner(alloc_id).signal(task, sig)

    def alloc_restart(self, alloc_id: str, task: str = "") -> None:
        self._runner(alloc_id).restart_task(task)

    def alloc_stats(self, alloc_id: str) -> dict:
        return self._runner(alloc_id).stats()

    def alloc_namespace(self, alloc_id: str) -> str:
        return self._runner(alloc_id).alloc.namespace

    def _fs_path(self, alloc_id: str, path: str) -> str:
        """Resolve a path inside the alloc dir, refusing escapes (the
        reference's alloc-dir sandboxing, client/allocdir)."""
        root = os.path.realpath(self._runner(alloc_id).alloc_dir)
        full = os.path.realpath(os.path.join(root, path.lstrip("/")))
        if full != root and not full.startswith(root + os.sep):
            raise ValueError("path escapes allocation directory")
        return full

    def fs_list(self, alloc_id: str, path: str = "/") -> list[dict]:
        """ref client/fs_endpoint.go List"""
        full = self._fs_path(alloc_id, path)
        out = []
        for name in sorted(os.listdir(full)):
            st = os.stat(os.path.join(full, name))
            out.append({
                "Name": name,
                "IsDir": os.path.isdir(os.path.join(full, name)),
                "Size": st.st_size,
                "FileMode": oct(st.st_mode & 0o7777),
                "ModTime": st.st_mtime,
            })
        return out

    def fs_stat(self, alloc_id: str, path: str) -> dict:
        full = self._fs_path(alloc_id, path)
        st = os.stat(full)
        return {
            "Name": os.path.basename(full) or "/",
            "IsDir": os.path.isdir(full),
            "Size": st.st_size,
            "FileMode": oct(st.st_mode & 0o7777),
            "ModTime": st.st_mtime,
        }

    def fs_read(self, alloc_id: str, path: str, offset: int = 0,
                limit: int = -1) -> bytes:
        """ref fs_endpoint.go Cat/ReadAt"""
        full = self._fs_path(alloc_id, path)
        with open(full, "rb") as f:
            if offset:
                f.seek(offset)
            return f.read(limit if limit >= 0 else -1)

    # ------------------------------------------------------- exec streams

    def alloc_exec_start(self, alloc_id: str, task: str, command: list,
                         tty: bool = False) -> str:
        """Open an interactive exec session inside a running task (ref
        client/alloc_endpoint.go exec + drivers ExecTaskStreaming).
        Returns a session id for the stdin/output/close calls."""
        ar = self._runner(alloc_id)
        tr = ar.task_runners.get(task)
        if tr is None or tr.handle is None:
            raise ValueError(f"task {task!r} is not running")
        session = tr.driver.exec_task(
            tr.handle.task_id, list(command), tty=tty,
            cwd=tr.task_dir, env=tr.env)
        sid = new_id()
        with self._lock:
            self._exec_sessions[sid] = [session, time.monotonic()]
        return sid

    def _exec_session(self, sid: str):
        with self._lock:
            entry = self._exec_sessions.get(sid)
            if entry is None:
                raise KeyError(f"unknown exec session {sid!r}")
            entry[1] = time.monotonic()      # any touch counts as activity
            return entry[0]

    def alloc_exec_stdin(self, sid: str, data: bytes) -> None:
        self._exec_session(sid).write_stdin(data)

    def alloc_exec_stdin_close(self, sid: str) -> None:
        """EOF the session's stdin (stdin-consuming commands like `cat`
        terminate on it; ref exec streaming close of the stdin frame)."""
        self._exec_session(sid).close_stdin()

    def alloc_exec_output(self, sid: str, wait: float = 1.0) -> dict:
        return self._exec_session(sid).read_output(wait=min(wait, 30.0))

    def alloc_exec_resize(self, sid: str, rows: int, cols: int) -> None:
        self._exec_session(sid).resize(rows, cols)

    def alloc_exec_close(self, sid: str) -> None:
        with self._lock:
            entry = self._exec_sessions.pop(sid, None)
        if entry is not None:
            entry[0].terminate()

    def _reap_exec_sessions(self) -> None:
        """Abandoned sessions are terminated by the GC tick. Idle is
        measured from LAST ACTIVITY (any stdin/output/resize touch), so
        a polling client never loses the tail output of a long command
        and an active interactive shell is never reaped."""
        now = time.monotonic()
        with self._lock:
            stale = [sid for sid, (s, last) in self._exec_sessions.items()
                     if (s.exit_code is not None and now - last > 300)
                     or now - last > 3600]
            for sid in stale:
                s, _ = self._exec_sessions.pop(sid)
                s.terminate()

    def fs_logs_follow(self, alloc_id: str, task: str,
                       log_type: str = "stdout", offset: int = 0,
                       wait: float = 10.0) -> tuple[bytes, int]:
        """Long-poll tail of a task log (ref fs_endpoint.go Logs with
        follow=true): blocks until bytes exist past `offset` or the wait
        expires; returns (data, next_offset)."""
        deadline = time.monotonic() + min(wait, 30.0)
        while True:
            # logmon copy-truncates on rotation: a shrunken file means
            # our offset points past EOF of the NEW file — restart from
            # its beginning instead of polling empty reads forever
            try:
                st = self.fs_stat(alloc_id, f"{task}/{task}.{log_type}.log")
                if int(st.get("Size", 0)) < offset:
                    offset = 0
            except (ValueError, OSError, KeyError):
                pass
            data = self.fs_logs(alloc_id, task, log_type, offset, "start",
                                -1)
            if data or time.monotonic() >= deadline:
                return data, offset + len(data)
            # local log-tail poll cadence (fs_stat reads the local disk),
            # not an RPC retry backoff
            time.sleep(0.1)  # nomadlint: disable=RPC001 — log-follow poll, no transport involved

    def fs_logs(self, alloc_id: str, task: str, log_type: str = "stdout",
                offset: int = 0, origin: str = "start",
                limit: int = -1) -> bytes:
        """Task log access (ref fs_endpoint.go Logs). Logs live at
        <alloc>/<task>/<task>.<type>.log (driver log convention)."""
        if log_type not in ("stdout", "stderr"):
            raise ValueError("type must be stdout or stderr")
        ar = self._runner(alloc_id)
        alloc = ar.alloc
        tg = alloc.job.lookup_task_group(alloc.task_group) if alloc.job \
            else None
        if tg is None or tg.lookup_task(task) is None:
            raise ValueError(f"unknown task {task!r} in allocation")
        path = f"{task}/{task}.{log_type}.log"
        full = self._fs_path(alloc_id, path)
        if not os.path.exists(full):
            return b""
        size = os.path.getsize(full)
        with open(full, "rb") as f:
            if origin == "end":
                # offset counts back from EOF (ref api/fs.go Logs origin)
                f.seek(max(0, size - offset) if offset else
                       (max(0, size - limit) if limit >= 0 else 0))
            elif offset:
                f.seek(offset)
            return f.read(limit if limit >= 0 else -1)

    def host_stats(self) -> dict:
        """ref client/stats/host.go HostStats"""
        # nomadlint: disable=DET001 — capture timestamp, not a decision
        stats = {"Timestamp": time.time(), "CPUTicksConsumed": 0.0}
        try:
            load1, load5, load15 = os.getloadavg()
            stats["CPU"] = [{"CPU": "cpu-total", "Total": load1 * 100}]
            stats["LoadAvg"] = [load1, load5, load15]
        except OSError:
            pass
        try:
            meminfo = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, _, v = line.partition(":")
                    meminfo[k] = int(v.split()[0]) * 1024
            stats["Memory"] = {
                "Total": meminfo.get("MemTotal", 0),
                "Available": meminfo.get("MemAvailable", 0),
                "Free": meminfo.get("MemFree", 0),
                "Used": meminfo.get("MemTotal", 0)
                - meminfo.get("MemAvailable", 0),
            }
        except OSError:
            pass
        try:
            st = os.statvfs(self.data_dir)
            stats["DiskStats"] = [{
                "Device": self.data_dir,
                "Size": st.f_blocks * st.f_frsize,
                "Available": st.f_bavail * st.f_frsize,
                "UsedPercent": 100.0 * (1 - st.f_bavail / st.f_blocks)
                if st.f_blocks else 0.0,
            }]
        except OSError:
            pass
        stats["AllocDirStats"] = {"Allocs": self.num_allocs()}
        stats["DeviceStats"] = self.device_manager.all_stats()
        stats["Uptime"] = time.monotonic()
        return stats

    def _gc_loop(self) -> None:
        """Disk-pressure / alloc-count driven GC (ref client/gc.go
        AllocGarbageCollector.run: checks every interval, evicts oldest
        terminal allocs while above thresholds)."""
        while not self._shutdown.wait(self.gc_interval_sec):
            try:
                self._gc_check()
                self._reap_exec_sessions()
                # the client half of the volume watcher's detach machine
                self.csi_manager.reconcile_claims()
            except Exception as e:      # noqa: BLE001
                self.logger(f"client: gc pass failed: {e!r}")

    def _gc_check(self) -> None:
        with self._lock:
            runners = dict(self.alloc_runners)
        terminal = sorted(
            (ar for ar in runners.values()
             if ar.alloc.terminal_status() or ar.synced_terminal),
            key=lambda ar: ar.alloc.modify_index)  # oldest first
        if not terminal:
            return
        over_count = len(runners) > self.gc_max_allocs

        def disk_pressure() -> bool:
            try:
                st = os.statvfs(self.alloc_dir_root)
            except OSError:
                return False
            if not st.f_blocks:
                return False
            used = 100.0 * (1 - st.f_bavail / st.f_blocks)
            return used >= self.gc_disk_usage_threshold
        for ar in terminal:
            if not over_count and not disk_pressure():
                return
            try:
                self.gc_alloc(ar.alloc.id)
                self.logger(f"client: gc'd alloc {ar.alloc.id[:8]}")
            except (KeyError, ValueError):
                pass
            with self._lock:
                over_count = len(self.alloc_runners) > self.gc_max_allocs

    def gc_alloc(self, alloc_id: str) -> None:
        """Destroy one terminal alloc and remove its dir (ref
        client/gc.go Collect)."""
        import shutil
        ar = self._runner(alloc_id)
        # eligible once the SERVER knows it's over: either the server marked
        # it terminal (our stored copy reflects server desired/client state)
        # or we've successfully synced a terminal client status. A merely
        # is_done() runner whose status hasn't synced yet would be re-added
        # by the next alloc-watch pass after GC.
        if not (ar.alloc.terminal_status() or ar.synced_terminal):
            raise ValueError(f"allocation {alloc_id!r} is not terminal")
        ar.destroy()
        # wait for task processes to actually exit before deleting their
        # dirs (ref client/allocrunner destroy channel)
        for tr in list(ar.task_runners.values()):
            tr.wait_done(timeout=tr.task.kill_timeout_sec + 5.0)
        with self._lock:
            self.alloc_runners.pop(alloc_id, None)
            self._alloc_versions.pop(alloc_id, None)
        self.state_db.delete_allocation(alloc_id)
        shutil.rmtree(ar.alloc_dir, ignore_errors=True)

    def gc_all(self) -> int:
        """Destroy all terminal allocs (ref client/gc.go CollectAll)."""
        with self._lock:
            candidates = [aid for aid, ar in self.alloc_runners.items()
                          if ar.alloc.terminal_status() or ar.synced_terminal]
        n = 0
        for aid in candidates:
            try:
                self.gc_alloc(aid)
                n += 1
            except (KeyError, ValueError):
                pass
        return n

    def register_device_plugin(self, plugin) -> None:
        """Attach a device plugin and refresh the node's device inventory
        (ref client/devicemanager fingerprint -> updateNodeFromDevices)."""
        self.device_manager.register_plugin(plugin)
        self.node.node_resources.devices = self.device_manager.fingerprint()
        try:
            self.rpc.node_register(self.node)
        except Exception as e:          # noqa: BLE001
            self.logger(f"client: device fingerprint update failed: {e!r}")

    def register_csi_plugin(self, plugin_id: str, plugin,
                            controller: bool = False) -> None:
        """Attach a CSI node (and optionally controller) plugin and
        refresh the node fingerprint (ref client/pluginmanager/csimanager
        fingerprint loop)."""
        self.csi_manager.register_plugin(plugin_id, plugin,
                                         controller=controller)
        self.node.csi_node_plugins = self.csi_manager.fingerprint()
        self.node.csi_controller_plugins = \
            self.csi_manager.fingerprint_controllers()
        try:
            self.rpc.node_register(self.node)
        except Exception as e:          # noqa: BLE001
            self.logger(f"client: csi fingerprint update failed: {e!r}")

    def get_driver(self, name: str) -> Driver:
        driver = self.drivers.get(name)
        if driver is None:
            raise ValueError(f"driver {name!r} not available")
        return driver

    def num_allocs(self) -> int:
        with self._lock:
            return len(self.alloc_runners)
