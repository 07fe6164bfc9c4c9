"""TaskRunner: one task's lifecycle (ref
client/allocrunner/taskrunner/task_runner.go:480 Run, restart logic :738,
restoreHandle :1129).

Loop: prestart hooks (dirs, env, artifacts/templates as stubs) -> driver
start -> wait -> restart policy (attempts within interval, delay,
mode fail|delay) -> terminal state. Task events accumulate on TaskState.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from ..structs import (
    Task, TaskEvent, TaskState, TASK_STATE_DEAD, TASK_STATE_PENDING,
    TASK_STATE_RUNNING,
)
from .driver import Driver, ExitResult, TaskHandle

EVENT_RECEIVED = "Received"
EVENT_TASK_SETUP = "Task Setup"
EVENT_STARTED = "Started"
EVENT_TERMINATED = "Terminated"
EVENT_RESTARTING = "Restarting"
EVENT_NOT_RESTARTING = "Not Restarting"
EVENT_KILLING = "Killing"
EVENT_KILLED = "Killed"
EVENT_DRIVER_FAILURE = "Driver Failure"
EVENT_SIGNALING = "Signaling"
EVENT_RESTART_SIGNAL = "Restart Signaled"


class TaskRunner:
    def __init__(self, alloc, task: Task, driver: Driver, task_dir: str,
                 env: dict[str, str],
                 on_state_change: Callable[[str, TaskState], None],
                 setup_error: str = "",
                 rendered_files: Optional[list] = None):
        self.alloc = alloc
        self.task = task
        self.driver = driver
        self.task_dir = task_dir
        self.env = env
        self.on_state_change = on_state_change

        self.state = TaskState()
        self.handle: Optional[TaskHandle] = None
        self._kill = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._restarts_in_window: list[float] = []
        self._restart_req = False
        self._logmon = None
        self.setup_error = setup_error   # pre-start hook failure (devices)
        # (relative_path, content, perms) written into the task dir at
        # setup: rendered templates, vault token (ref template/vault hooks)
        self.rendered_files = rendered_files or []

        tg = alloc.job.lookup_task_group(alloc.task_group) if alloc.job else None
        self.restart_policy = tg.restart_policy if tg else None

    @property
    def task_id(self) -> str:
        return f"{self.alloc.id}/{self.task.name}"

    # ---------------------------------------------------------------- run

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=f"task-{self.task.name}")
        self._thread.start()

    def run(self) -> None:
        self._emit(EVENT_RECEIVED, "task received by client")
        if self.setup_error:
            # a failed pre-start hook (e.g. device reservation) fails the
            # task rather than launching it degraded (ref device_hook.go)
            self._fail(EVENT_TASK_SETUP, self.setup_error)
            return
        try:
            self._setup()
        except Exception as e:          # noqa: BLE001
            self._fail(EVENT_TASK_SETUP, f"setup failed: {e}")
            return
        while not self._kill.is_set():
            try:
                self.handle = self.driver.start_task(
                    self.task_id, self.task, self.task_dir, self.env)
            except Exception as e:      # noqa: BLE001
                if not self._should_restart(failed=True,
                                            reason=f"driver start: {e}"):
                    self._fail(EVENT_DRIVER_FAILURE, str(e))
                    return
                continue
            self._set_state(TASK_STATE_RUNNING, EVENT_STARTED,
                            "task started by client")
            result = self._wait_for_exit()
            if self._kill.is_set():
                self._emit(EVENT_KILLED, "task killed")
                self._finish(failed=False)
                return
            failed = result is None or not result.successful()
            code = result.exit_code if result else -1
            # between exit and restart the task is pending, not running —
            # deployment health must not count it as live
            self._set_state(TASK_STATE_PENDING, EVENT_TERMINATED,
                            f"exit code: {code}")
            if not self._should_restart(failed=failed,
                                        reason=f"exit {code}"):
                self._finish(failed=failed)
                return
        self._emit(EVENT_KILLED, "task killed")
        self._finish(failed=False)

    def _setup(self) -> None:
        os.makedirs(self.task_dir, exist_ok=True)
        os.makedirs(os.path.join(self.task_dir, "local"), exist_ok=True)
        os.makedirs(os.path.join(self.task_dir, "secrets"), exist_ok=True)
        for rel, content, perms in self.rendered_files:
            self.write_rendered_file(rel, content, perms)
        # log rotation per the task's log stanza (ref logmon_hook.go).
        # When THIS task's driver pipes output through the native
        # nomad-logmon sidecar, the sidecar owns rotation — running the
        # copy-truncate rotator on top would race its rename rotation.
        # Drivers that write files directly (exec's executor, docker's
        # log collection) still need the in-process rotator.
        from .logmon import LogRotator
        uses_sidecar = getattr(self.driver, "uses_logmon", None)
        if not (uses_sidecar is not None and uses_sidecar()):
            self._logmon = LogRotator(self.task_dir, self.task.name,
                                      self.task.log_config)
            self._logmon.start()

    def _wait_for_exit(self) -> Optional[ExitResult]:
        while not self._kill.is_set():
            result = self.driver.wait_task(self.task_id, timeout=0.2)
            if result is not None:
                return result
        # killed: stop the task
        self.driver.stop_task(self.task_id,
                              kill_timeout=self.task.kill_timeout_sec,
                              sig=self.task.kill_signal)
        return None

    # ------------------------------------------------------------ restarts

    def _should_restart(self, failed: bool, reason: str) -> bool:
        """ref taskrunner/restarts/restarts.go"""
        if self._restart_req and not self._kill.is_set():
            # user-initiated restart (alloc restart API): bypasses the
            # restart-policy accounting (ref restarts.go SetRestartTriggered)
            self._restart_req = False
            self._emit(EVENT_RESTARTING, "restarting: user requested")
            return True
        pol = self.restart_policy
        if pol is None or self._kill.is_set():
            return False
        if not failed and self.alloc.job is not None and \
           self.alloc.job.type == "service":
            # service tasks restart even on clean exit
            pass
        elif not failed:
            return False
        now = time.time()
        window_start = now - pol.interval_sec
        self._restarts_in_window = [t for t in self._restarts_in_window
                                    if t >= window_start]
        if len(self._restarts_in_window) >= pol.attempts:
            if pol.mode == "delay":
                self._emit(EVENT_RESTARTING,
                           f"exceeded attempts, delaying {pol.interval_sec}s")
                if self._kill.wait(pol.interval_sec):
                    return False
                self._restarts_in_window = []
            else:
                self._emit(EVENT_NOT_RESTARTING, "exceeded restart attempts")
                return False
        self._restarts_in_window.append(now)
        self.state.restarts += 1
        self.state.last_restart_unix = now
        self._emit(EVENT_RESTARTING, f"restarting: {reason}")
        if self._kill.wait(pol.delay_sec):
            return False
        return True

    # ---------------------------------------------------------------- kill

    def write_rendered_file(self, rel: str, content: str,
                            perms: str = "0644") -> str:
        """Write a rendered template/secret into the task dir. Also the
        re-render path of the template watcher (change_mode flow)."""
        path = os.path.join(self.task_dir, rel.lstrip("/"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            mode = int(perms, 8)
        except (ValueError, TypeError):
            mode = 0o600
        # create with the final mode from the start: secrets must never
        # transit through a umask-default world-readable window
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, mode)
        with os.fdopen(fd, "w") as f:
            f.write(content)
        os.chmod(path, mode)   # existing file: tighten to the ask
        return path

    def kill(self, reason: str = "") -> None:
        self._emit(EVENT_KILLING, reason or "task is being killed")
        self._kill.set()

    def signal(self, sig: str, reason: str = "") -> None:
        """Deliver a signal to the running task (ref taskrunner Signal /
        client/alloc_endpoint.go Allocations.Signal)."""
        if self.state.state != TASK_STATE_RUNNING:
            raise ValueError(f"task {self.task.name!r} is not running")
        self._emit(EVENT_SIGNALING, reason or f"signal {sig}")
        self.driver.signal_task(self.task_id, sig)

    def restart(self, reason: str = "") -> None:
        """Stop and rerun the task, bypassing restart-policy limits (ref
        taskrunner Restart / client/alloc_endpoint.go Allocations.Restart)."""
        if self.state.state != TASK_STATE_RUNNING:
            # pending (between runs) or dead: stop_task would be a no-op and
            # the flag would fire a spurious restart on the NEXT exit
            raise ValueError(f"task {self.task.name!r} is not running")
        self._emit(EVENT_RESTART_SIGNAL,
                   reason or "restart requested by user")
        self._restart_req = True
        self.driver.stop_task(self.task_id,
                              kill_timeout=self.task.kill_timeout_sec,
                              sig=self.task.kill_signal)

    def stats(self) -> dict:
        if self.state.state != TASK_STATE_RUNNING:
            return {"cpu_percent": 0.0, "memory_rss_bytes": 0}
        return self.driver.task_stats(self.task_id)

    def wait_done(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def restore(self, handle: TaskHandle) -> bool:
        """Reattach to a live task after client restart (ref
        task_runner.go:1129 restoreHandle)."""
        if self.driver.recover_task(handle):
            self.handle = handle
            self._thread = threading.Thread(
                target=self._run_restored, daemon=True,
                name=f"task-{self.task.name}")
            self._thread.start()
            return True
        return False

    def _run_restored(self) -> None:
        self._set_state(TASK_STATE_RUNNING, EVENT_RECEIVED,
                        "task reattached after client restart")
        result = self._wait_for_exit()
        if self._kill.is_set():
            self._emit(EVENT_KILLED, "task killed")
            self._finish(failed=False)
            return
        failed = result is None or not result.successful()
        self._set_state(TASK_STATE_PENDING, EVENT_TERMINATED,
                        f"exit code: {result.exit_code if result else -1}")
        if self._should_restart(failed=failed, reason="post-restore exit"):
            self.run()
            return
        self._finish(failed=failed)

    # --------------------------------------------------------------- state

    def _emit(self, etype: str, message: str) -> None:
        self.state.events.append(TaskEvent(type=etype, time_unix=time.time(),
                                           message=message))
        self.on_state_change(self.task.name, self.state)

    def _set_state(self, state: str, etype: str, message: str) -> None:
        self.state.state = state
        if state == TASK_STATE_RUNNING:
            self.state.started_at = time.time()
        self.state.events.append(TaskEvent(type=etype, time_unix=time.time(),
                                           message=message))
        self.on_state_change(self.task.name, self.state)

    def _finish(self, failed: bool) -> None:
        self.state.state = TASK_STATE_DEAD
        self.state.failed = failed
        self.state.finished_at = time.time()
        if self._logmon is not None:
            self._logmon.stop()
        self.driver.destroy_task(self.task_id)
        self.on_state_change(self.task.name, self.state)
        self._done.set()

    def _fail(self, etype: str, message: str) -> None:
        self._emit(etype, message)
        self._finish(failed=True)
