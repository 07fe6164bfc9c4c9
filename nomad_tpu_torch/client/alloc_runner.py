"""AllocRunner: one allocation's state machine (ref
client/allocrunner/alloc_runner.go:299 Run, clientAlloc:653, Update:809,
Restore:417).

Runs the group's TaskRunners with lifecycle ordering (prestart -> main ->
poststop), rolls task states up into a client status, tracks deployment
health (min_healthy_time), and reacts to server-desired stops.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from ..metrics import record_swallowed_error
from ..structs import (
    Allocation, AllocDeploymentStatus, TaskState,
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED, ALLOC_CLIENT_PENDING,
    ALLOC_CLIENT_RUNNING, ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT,
    TASK_STATE_DEAD, TASK_STATE_RUNNING,
)
from .driver import Driver
from .task_runner import TaskRunner
from .taskenv import build_task_env


class AllocRunner:
    def __init__(self, client, alloc: Allocation):
        self.client = client
        self.alloc = alloc
        self._lock = threading.Lock()
        self.task_runners: dict[str, TaskRunner] = {}
        self._template_watchers: dict[str, object] = {}
        self.task_states: dict[str, TaskState] = {}
        self._thread: Optional[threading.Thread] = None
        self._destroyed = threading.Event()
        self._waiters_done = threading.Event()
        self._dirty = threading.Event()   # state changed, sync to server
        self.deployment_healthy_at: float = 0.0
        # set once a terminal client status was acked by the server —
        # gates local GC (client.gc_alloc)
        self.synced_terminal = False
        self._vault_tokens: dict[str, str] = {}      # task -> token
        self._services_registered = False
        self._check_runners: list = []
        # serializes the WHOLE service register/deregister lifecycle
        # (claim + RPC + check-runner spawn vs teardown) — a dedicated
        # lock so the hot-path _lock never waits on a service RPC
        self._services_lock = threading.Lock()
        self._services_closed = False
        # bridge-mode netns status ({"ip","netns","gateway"}) or None
        self.network_status: Optional[dict] = None

        self.alloc_dir = os.path.join(client.alloc_dir_root, alloc.id)

    # ---------------------------------------------------------------- run

    def run(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"alloc-{self.alloc.id[:8]}")
        self._thread.start()

    def _run(self) -> None:
        try:
            self._run_impl()
        finally:
            # postrun hooks, whatever path we exited on: CSI unmount
            # (csi_hook.go), network namespace teardown (network_hook.go
            # Postrun), service deregistration (the consul group services
            # hook), vault token revocation (vault_hook.go Stop)
            try:
                job = self.alloc.job
                tg = job.lookup_task_group(self.alloc.task_group) \
                    if job else None
                self.client.network_hook.postrun(self.alloc, tg)
            except Exception as e:      # noqa: BLE001 — best effort
                self.client.logger(f"network_hook: teardown: {e!r}")
            self.client.csi_manager.unmount_all(self.alloc)
            self._deregister_services()
            for token in self._vault_tokens.values():
                try:
                    self.client.rpc.vault_revoke_token(token)
                except Exception as e:  # noqa: BLE001 — keep revoking
                    # an unrevoked token outlives the alloc until TTL —
                    # that deserves a log line and a counter (EXC001)
                    record_swallowed_error("client.vault.revoke", e,
                                           self.client.logger)
            self._vault_tokens.clear()

    def _start_vault_renewal(self, task, start_token: str,
                             ttl_sec: float) -> None:
        """Half-TTL renewal loop; a failed renewal applies the task's vault
        change_mode (ref client/vaultclient token renewal +
        taskrunner/vault_hook.go watch loop)."""
        def renew_loop():
            token = start_token
            interval = max(1.0, ttl_sec / 2)
            while not self._destroyed.wait(interval):
                if self._vault_tokens.get(task.name) != token:
                    return   # replaced or revoked
                try:
                    self.client.rpc.vault_renew_token(token)
                except Exception as e:  # noqa: BLE001
                    self.client.logger(
                        f"vault: renew failed for {task.name}: {e!r}")
                    tr = self.task_runners.get(task.name)
                    # re-derive a fresh token (the failure path after e.g. a
                    # leader failover wiped the in-memory backend), update
                    # the env + secrets file, THEN notify per change_mode
                    try:
                        out = self.client.rpc.vault_derive_token(
                            self.alloc.id, task.name)
                        token = out["token"]
                        self._vault_tokens[task.name] = token
                        if tr is not None:
                            if task.vault.env:
                                tr.env["VAULT_TOKEN"] = token
                            tok_path = os.path.join(tr.task_dir, "secrets",
                                                    "vault_token")
                            fd = os.open(tok_path,
                                         os.O_WRONLY | os.O_CREAT
                                         | os.O_TRUNC, 0o600)
                            with os.fdopen(fd, "w") as f:
                                f.write(token)
                    except Exception as e2:  # noqa: BLE001
                        self.client.logger(
                            f"vault: re-derive failed for {task.name}: "
                            f"{e2!r}")
                        return
                    mode = task.vault.change_mode
                    try:
                        if tr is not None and mode == "restart":
                            tr.restart("vault token rotated")
                        elif tr is not None and mode == "signal":
                            tr.signal(task.vault.change_signal or "SIGHUP",
                                      "vault token rotated")
                    except ValueError:
                        pass   # task not running: nothing to notify
        threading.Thread(target=renew_loop, daemon=True,
                         name=f"vault-renew-{task.name}").start()

    # ------------------------------------------------------------- services

    def _service_instances(self):
        """Build catalog rows for every tg- and task-level service (ref
        command/agent/consul service registration)."""
        from ..integrations.services import ServiceInstance
        alloc = self.alloc
        tg = alloc.job.lookup_task_group(alloc.task_group) \
            if alloc.job else None
        if tg is None:
            return []
        address = (self.client.node.http_addr.rsplit(":", 1)[0]
                   if self.client.node.http_addr else "127.0.0.1")
        out = []

        def port_for(label: str, task_name: str = "") -> int:
            if label.isdigit():
                return int(label)
            tres = alloc.allocated_resources.tasks.get(task_name) \
                if task_name else None
            nets = (tres.networks if tres else []) or []
            for net in nets:
                for p in list(net.reserved_ports) + list(net.dynamic_ports):
                    if p.label == label:
                        return p.value
            # group-network ports live in shared resources
            # (ref scheduler/rank.py shared.ports / structs AllocatedPorts)
            for p in alloc.allocated_resources.shared.ports:
                if p.get("label") == label:
                    return p.get("value", 0)
            return 0

        for svc, task_name in (
                [(s, "") for s in tg.services]
                + [(s, t.name) for t in tg.tasks for s in t.services]):
            checks = [dict(c) for c in svc.checks]
            for c in checks:
                # an exposed check targets its own proxy listener port
                # (connect._expose_admission rewrote its port_label);
                # resolve it here where the allocation's ports are known
                lbl = c.get("port_label") or c.get("PortLabel") or ""
                if lbl:
                    c["port"] = port_for(lbl, task_name)
            out.append((ServiceInstance(
                service_name=svc.name, namespace=alloc.namespace,
                job_id=alloc.job_id, alloc_id=alloc.id,
                node_id=alloc.node_id, task=task_name, address=address,
                port=port_for(svc.port_label, task_name),
                tags=tuple(svc.tags)), checks))
        return out

    def _register_services(self) -> None:
        """Register this alloc's services + spawn check runners. The
        whole body holds _services_lock: a flag-only claim would let
        teardown interleave between the claim and the register RPC,
        leaving the registration leaked server-side forever and check
        runners pushing status for a dead alloc."""
        from ..integrations.services import CheckRunner
        with self._services_lock:
            if self._services_closed or self._services_registered:
                return
            pairs = self._service_instances()
            if not pairs:
                self._services_registered = True    # nothing to register
                return
            try:
                self.client.rpc.service_register(
                    [inst for inst, _ in pairs])
            except Exception as e:      # noqa: BLE001
                self.client.logger(f"service register failed: {e!r}")
                return                  # retried by the sync loop

            def on_status(instance, status):
                instance = instance.copy()
                instance.status = status
                try:
                    self.client.rpc.service_register([instance])
                except Exception as e:  # noqa: BLE001
                    self.client.logger(f"check status push failed: {e!r}")
            self._services_registered = True
            for inst, checks in pairs:
                if checks:
                    cr = CheckRunner(inst, checks, on_status)
                    cr.start()
                    self._check_runners.append(cr)

    def _deregister_services(self) -> None:
        """Terminal: close the service lifecycle (no later register can
        claim), stop check runners, deregister. Serialized against
        _register_services by _services_lock, so whichever side wins the
        race, the final server-side state is deregistered."""
        with self._services_lock:
            self._services_closed = True
            for cr in self._check_runners:
                cr.stop()
            self._check_runners.clear()
            if not self._services_registered:
                return
            self._services_registered = False
            try:
                self.client.rpc.service_deregister(alloc_id=self.alloc.id)
            except Exception as e:      # noqa: BLE001
                self.client.logger(f"service deregister failed: {e!r}")

    def _run_impl(self) -> None:
        alloc = self.alloc
        if alloc.server_terminal_status():
            return
        job = alloc.job
        tg = job.lookup_task_group(alloc.task_group) if job else None
        if tg is None:
            self._set_client_status(ALLOC_CLIENT_FAILED,
                                    "task group not found in job")
            return
        os.makedirs(self.alloc_dir, exist_ok=True)

        # previous-alloc wait + ephemeral disk migration (ref
        # client/allocwatcher; the migrate_hook in alloc_runner_hooks.go)
        if alloc.previous_allocation:
            from .alloc_watcher import PrevAllocWatcher
            try:
                PrevAllocWatcher(self.client, alloc,
                                 logger=self.client.logger).wait_and_migrate()
            except Exception as e:      # noqa: BLE001 — best-effort
                self.client.logger(f"allocwatcher: migrate failed: {e!r}")

        # bridge-mode network namespace before any task starts (ref
        # client/allocrunner/network_hook.go Prerun); the netns status is
        # exposed to tasks via NOMAD_ALLOC_IP / NOMAD_ALLOC_NETNS
        try:
            self.network_status = self.client.network_hook.prerun(alloc, tg)
        except Exception as e:          # noqa: BLE001
            self._set_client_status(ALLOC_CLIENT_FAILED,
                                    f"network setup failed: {e}")
            return

        # CSI volumes: claim + stage + publish before any task starts
        # (ref client/allocrunner/csi_hook.go Prerun)
        csi_reqs = [r for r in tg.volumes.values() if r.type == "csi"]
        if csi_reqs:
            try:
                for req in csi_reqs:
                    self.client.csi_manager.mount_volume(alloc, req)
            except Exception as e:      # noqa: BLE001
                self._set_client_status(ALLOC_CLIENT_FAILED,
                                        f"CSI volume mount failed: {e}")
                return

        prestart = [t for t in tg.tasks if t.is_prestart()]
        main = [t for t in tg.tasks
                if t.lifecycle is None or (t.is_prestart() and t.lifecycle.sidecar)]
        poststart = [t for t in tg.tasks if t.is_poststart()]
        poststop = [t for t in tg.tasks if t.is_poststop()]

        # prestart (non-sidecar) must finish before main starts
        # (ref client/allocrunner/task_hook_coordinator.go)
        blockers = []
        for task in prestart:
            tr = self._make_runner(task)
            tr.start()
            if not task.lifecycle.sidecar:
                blockers.append(tr)
        for tr in blockers:
            tr.wait_done()
            if tr.state.failed:
                self._set_client_status(ALLOC_CLIENT_FAILED,
                                        "prestart task failed")
                self._run_poststop(poststop)
                return

        runners = []
        for task in main:
            if task.is_prestart():
                continue  # sidecars already started
            tr = self._make_runner(task)
            tr.start()
            runners.append(tr)
        for task in poststart:
            tr = self._make_runner(task)
            tr.start()
            runners.append(tr)

        for tr in runners:
            tr.wait_done()
        # main work done: stop prestart sidecars
        for task in prestart:
            if task.lifecycle.sidecar:
                tr = self.task_runners.get(task.name)
                if tr:
                    tr.kill("main tasks finished")
                    tr.wait_done(timeout=10)
        self._run_poststop(poststop)
        self._waiters_done.set()

    def _run_poststop(self, tasks) -> None:
        runners = []
        for task in tasks:
            tr = self._make_runner(task)
            tr.start()
            runners.append(tr)
        for tr in runners:
            tr.wait_done(timeout=60)

    def _make_runner(self, task) -> TaskRunner:
        driver = self.client.get_driver(task.driver)
        task_dir = os.path.join(self.alloc_dir, task.name)
        env = build_task_env(self.alloc, task, self.client.node, task_dir,
                             self.alloc_dir,
                             os.path.join(task_dir, "secrets"),
                             network_status=self.network_status)
        # device hook: reserved device instances -> visibility env vars
        # (ref taskrunner/device_hook.go); a reservation failure fails the
        # task rather than launching it without its devices
        setup_error = ""
        # driver config schema validation (the hclspec analog, ref
        # plugins/shared/hclspec): a malformed config fails the task with
        # a decode-style error instead of a mid-start crash
        schema = None
        if driver is not None:
            get_schema = getattr(driver, "config_schema", None)
            schema = get_schema() if get_schema else None
        if schema is not None:
            from .driver import validate_config
            err = validate_config(task.config or {}, schema)
            if err:
                setup_error = f"driver config validation failed: {err}"
                self.client.logger(
                    f"task {task.name!r}: {setup_error}")
        tres = self.alloc.allocated_resources.tasks.get(task.name)
        for ad in (tres.devices if tres else []):
            try:
                res = self.client.device_manager.reserve(ad)
                env.update(res.envs)
            except ValueError as e:
                setup_error = f"device reservation failed: {e}"
                self.client.logger(setup_error)

        # artifact hook: download declared artifacts into the task dir
        # before start; a failure fails setup like the reference's
        # recoverable prestart error (ref taskrunner/artifact_hook.go)
        if task.artifacts and not setup_error:
            from .artifact import ArtifactError, fetch_artifact
            for art in task.artifacts:
                try:
                    fetch_artifact(art, task_dir)
                except ArtifactError as e:
                    setup_error = f"artifact download failed: {e}"
                    self.client.logger(setup_error)
                    break

        rendered: list[tuple[str, str, str]] = []
        # vault hook: derive a task token, expose VAULT_TOKEN + the
        # secrets/vault_token file (ref taskrunner/vault_hook.go)
        if task.vault is not None and not setup_error:
            try:
                out = self.client.rpc.vault_derive_token(self.alloc.id,
                                                         task.name)
                token = out["token"]
                self._vault_tokens[task.name] = token
                self._start_vault_renewal(task, token,
                                          float(out.get("ttl_sec", 3600)))
                if task.vault.env:
                    env["VAULT_TOKEN"] = token
                rendered.append(("secrets/vault_token", token, "0600"))
            except Exception as e:      # noqa: BLE001
                setup_error = f"vault token derivation failed: {e}"
                self.client.logger(setup_error)

        # sids hook: a connect sidecar task gets a SERVICE IDENTITY token
        # (ref taskrunner/sids_hook.go deriving Consul SI tokens) written
        # to secrets/si_token — the credential a real mesh data plane
        # authenticates with. Derivation failure degrades, not fails: the
        # reference retries in the background and so does our next
        # restart; the in-process proxy authorizes via server RPC anyway.
        from ..integrations.connect import PROXY_PREFIX
        if task.name.startswith(PROXY_PREFIX) and not setup_error:
            try:
                out = self.client.rpc.derive_si_token(self.alloc.id,
                                                      task.name)
                rendered.append(("secrets/si_token", out["token"], "0600"))
            except Exception as e:      # noqa: BLE001
                self.client.logger(
                    f"sids: SI token derivation failed for "
                    f"{task.name}: {e!r}")

        # template hook: render embedded templates against env + secrets +
        # the service catalog (ref taskrunner/template_hook.go)
        tmpl_rendered: list = []
        if task.templates and not setup_error:
            from ..integrations.template import TemplateError, render_template
            for tmpl in task.templates:
                try:
                    content = render_template(
                        tmpl.embedded_tmpl, env,
                        secret_reader=self.client.rpc.secret_read,
                        service_lookup=lambda name: self.client.rpc
                        .service_instances(self.alloc.namespace, name))
                    tmpl_rendered.append((tmpl.dest_path or "local/template",
                                          content, tmpl.perms))
                except TemplateError as e:
                    setup_error = f"template render failed: {e}"
                    self.client.logger(setup_error)
                    break
            rendered.extend(tmpl_rendered)

        tr = TaskRunner(self.alloc, task, driver, task_dir, env,
                        self._on_task_state, setup_error=setup_error,
                        rendered_files=rendered)
        with self._lock:
            self.task_runners[task.name] = tr

        # template watch loop: re-render on service/KV/secret change and
        # deliver change_mode (ref template.go handleTemplateRerenders)
        if task.templates and not setup_error:
            from ..integrations.template import TemplateWatcher
            watcher = TemplateWatcher(
                tr, task.templates, env,
                secret_reader=self.client.rpc.secret_read,
                service_lookup=lambda name: self.client.rpc
                .service_instances(self.alloc.namespace, name),
                interval=self.client.template_interval_sec,
                logger=self.client.logger)
            watcher.prime(tmpl_rendered)
            watcher.start()
            with self._lock:
                self._template_watchers[task.name] = watcher
        return tr

    # --------------------------------------------------------------- state

    def _on_task_state(self, task_name: str, state: TaskState) -> None:
        """ref alloc_runner.go:486 handleTaskStateUpdates"""
        with self._lock:
            self.task_states[task_name] = state
            # a task that reached a terminal state takes its template
            # watcher with it — otherwise completed tasks leak a thread
            # polling the catalog and firing doomed change_mode restarts
            if state.state == TASK_STATE_DEAD:
                watcher = self._template_watchers.pop(task_name, None)
                if watcher is not None:
                    watcher.stop()
            # a failed leader/main task takes the others down
            if state.state == TASK_STATE_DEAD and state.failed:
                for name, tr in self.task_runners.items():
                    if name != task_name and not tr.state.failed:
                        tr.kill("sibling task failed")
        if state.state == TASK_STATE_RUNNING \
                and not self._services_registered:
            # first task up: publish the alloc's services (ref the consul
            # group-services + service hooks firing at poststart)
            self._register_services()
        self._dirty.set()
        self.client.alloc_state_updated(self)

    def client_alloc(self) -> Allocation:
        """Roll task states up into the alloc's client view
        (ref alloc_runner.go:653 clientAlloc)."""
        with self._lock:
            states = dict(self.task_states)
        a = self.alloc.copy()
        a.task_states = states
        if not states:
            a.client_status = ALLOC_CLIENT_PENDING
        else:
            any_failed = any(s.failed for s in states.values())
            all_dead = all(s.state == TASK_STATE_DEAD for s in states.values())
            any_running = any(s.state == TASK_STATE_RUNNING
                              for s in states.values())
            if all_dead:
                a.client_status = (ALLOC_CLIENT_FAILED if any_failed
                                   else ALLOC_CLIENT_COMPLETE)
            elif any_failed:
                a.client_status = ALLOC_CLIENT_FAILED
            elif any_running:
                a.client_status = ALLOC_CLIENT_RUNNING
            else:
                a.client_status = ALLOC_CLIENT_PENDING
        a.deployment_status = self._deployment_status(a)
        a.modify_time_unix = time.time()
        return a

    def _deployment_status(self, a: Allocation
                           ) -> Optional[AllocDeploymentStatus]:
        """Deployment health (ref client/allocrunner/health_hook.go +
        allochealth tracker): healthy once all tasks run for
        min_healthy_time; unhealthy on failure."""
        if not self.alloc.deployment_id:
            return self.alloc.deployment_status
        tg = (self.alloc.job.lookup_task_group(self.alloc.task_group)
              if self.alloc.job else None)
        update = tg.update if tg else None
        min_healthy = update.min_healthy_time_sec if update else 10.0
        prev = self.alloc.deployment_status
        canary = bool(prev and prev.canary)
        if a.client_status == ALLOC_CLIENT_FAILED:
            return AllocDeploymentStatus(healthy=False, canary=canary,
                                         timestamp_unix=time.time())
        states = a.task_states
        if states and all(s.state == TASK_STATE_RUNNING and not s.failed
                          for s in states.values()):
            started = max(s.started_at for s in states.values())
            if time.time() - started >= min_healthy:
                return AllocDeploymentStatus(healthy=True, canary=canary,
                                             timestamp_unix=time.time())
        if prev is not None and prev.healthy is not None:
            return prev
        return AllocDeploymentStatus(healthy=None, canary=canary)

    # -------------------------------------------------------------- update

    def update(self, alloc: Allocation) -> None:
        """Server pushed a new alloc version (ref alloc_runner.go:809)."""
        old_desired = self.alloc.desired_status
        self.alloc = alloc
        if alloc.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT) \
           and old_desired not in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT):
            self.stop()

    def stop(self) -> None:
        with self._lock:
            runners = list(self.task_runners.values())
            watchers = list(self._template_watchers.values())
        for w in watchers:
            w.stop()
        for tr in runners:
            tr.kill("alloc stopped by server")
        self._dirty.set()
        self.client.alloc_state_updated(self)

    def destroy(self) -> None:
        self.stop()
        self._destroyed.set()

    def signal(self, task_name: str, sig: str) -> None:
        """Signal one task, or every task when task_name is empty (ref
        client/allocrunner Signal)."""
        from ..structs import TASK_STATE_RUNNING
        with self._lock:
            runners = dict(self.task_runners)
        if task_name:
            tr = runners.get(task_name)
            if tr is None:
                raise ValueError(f"unknown task {task_name!r}")
            tr.signal(sig)
            return
        # all-task signal: act only on running tasks, and check eligibility
        # up front so we never partially apply then error
        eligible = [tr for tr in runners.values()
                    if tr.state.state == TASK_STATE_RUNNING]
        if not eligible:
            raise ValueError("allocation has no running tasks")
        for tr in eligible:
            tr.signal(sig)

    def restart_task(self, task_name: str = "") -> None:
        """Restart one task or the whole alloc (ref allocrunner Restart)."""
        with self._lock:
            runners = dict(self.task_runners)
        if task_name:
            tr = runners.get(task_name)
            if tr is None:
                raise ValueError(f"unknown task {task_name!r}")
            tr.restart()
            return
        eligible = [tr for tr in runners.values()
                    if not tr._done.is_set()]
        if not eligible:
            raise ValueError("allocation has no restartable tasks")
        for tr in eligible:
            tr.restart()

    def stats(self) -> dict:
        """Per-task + rolled-up resource usage (ref
        client/allocrunner AllocStats / structs.AllocResourceUsage)."""
        with self._lock:
            runners = dict(self.task_runners)
        tasks = {name: tr.stats() for name, tr in runners.items()}
        return {
            "ResourceUsage": {
                "MemoryStats": {"RSS": sum(
                    t.get("memory_rss_bytes", 0) for t in tasks.values())},
                "CpuStats": {"TotalTicks": sum(
                    t.get("cpu_total_ticks", 0.0) for t in tasks.values())},
            },
            "Tasks": {
                name: {"ResourceUsage": {
                    "MemoryStats": {"RSS": t.get("memory_rss_bytes", 0)},
                    "CpuStats": {
                        "TotalTicks": t.get("cpu_total_ticks", 0.0),
                        "Percent": t.get("cpu_percent", 0.0)},
                }} for name, t in tasks.items()
            },
            "Timestamp": time.time(),
        }

    def is_done(self) -> bool:
        with self._lock:
            states = dict(self.task_states)
        return bool(states) and all(s.state == TASK_STATE_DEAD
                                    for s in states.values())

    # ------------------------------------------------------------- restore

    def restore(self, handles: dict[str, dict]) -> None:
        """Reattach task runners to live tasks (ref alloc_runner.go:417)."""
        alloc = self.alloc
        job = alloc.job
        tg = job.lookup_task_group(alloc.task_group) if job else None
        if tg is None:
            return
        from .driver import TaskHandle
        for task in tg.tasks:
            h = handles.get(task.name)
            if not h:
                continue
            tr = self._make_runner(task)
            handle = TaskHandle(**h)
            if not tr.restore(handle):
                # task died while client was down
                tr.state.state = TASK_STATE_DEAD
                tr.state.failed = True
                tr.state.finished_at = time.time()
                self._on_task_state(task.name, tr.state)

    def persistable_handles(self) -> dict[str, dict]:
        with self._lock:
            out = {}
            for name, tr in self.task_runners.items():
                if tr.handle is not None and \
                   tr.state.state == TASK_STATE_RUNNING:
                    out[name] = {
                        "task_id": tr.handle.task_id,
                        "driver": tr.handle.driver,
                        "pid": tr.handle.pid,
                        "config": tr.handle.config,
                        "started_at": tr.handle.started_at,
                    }
            return out
