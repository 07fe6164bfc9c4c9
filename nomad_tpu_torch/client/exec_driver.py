"""exec driver backed by the native C++ executor supervisor
(ref drivers/exec + drivers/shared/executor: the re-exec'd subprocess
boundary, here a compiled sidecar binary).

Each task gets one `nomad-executor` process that owns the task's session,
applies resource limits, supervises the workload, and persists the exit
status to a result file — so task state survives client restarts (the
reattach contract, ref task_runner.go:1129).
"""
from __future__ import annotations

import json
import os
import shlex
import signal
import subprocess
import threading
import time
from typing import Optional

from ..structs import DriverInfo
from .driver import Driver, ExitResult, TaskHandle

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_BIN = os.path.join(_REPO_ROOT, "native", "nomad-executor")

_build_lock = threading.Lock()


def ensure_executor_binary(path: str = DEFAULT_BIN) -> Optional[str]:
    """Build the executor on first use (g++ baked into the image)."""
    if os.path.exists(path):
        return path
    with _build_lock:
        if os.path.exists(path):
            return path
        src_dir = os.path.dirname(path)
        if not os.path.exists(os.path.join(src_dir, "executor.cc")):
            return None
        try:
            subprocess.run(["make", "-C", src_dir], check=True,
                           capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                FileNotFoundError):
            return None
        return path if os.path.exists(path) else None


def _cgroup_parent() -> str:
    """A writable cgroup v2 parent for task leaves, or "" (the executor
    then falls back to rlimit/nice). Prefers a dedicated nomad-tpu group
    under the root; inside a delegated container, the process's own
    cgroup is the only writable subtree (ref cgutil.CgroupScope)."""
    root = "/sys/fs/cgroup"
    if not os.path.exists(os.path.join(root, "cgroup.controllers")):
        return ""                        # not unified cgroup v2
    dedicated = os.path.join(root, "nomad-tpu")
    try:
        os.makedirs(dedicated, exist_ok=True)
        if os.access(dedicated, os.W_OK):    # a pre-existing root-owned
            return dedicated                 # dir must not shadow the
    except OSError:                          # delegated-cgroup fallback
        pass
    try:
        with open("/proc/self/cgroup") as f:
            for line in f:
                if line.startswith("0::"):
                    own = root + line.split("::", 1)[1].strip()
                    if os.access(own, os.W_OK):
                        return own
    except OSError:
        pass
    return ""


class ExecDriver(Driver):
    """config keys: command, args; resources drive the limits."""

    name = "exec"

    def __init__(self, executor_bin: str = DEFAULT_BIN):
        self.executor_bin = executor_bin
        self._lock = threading.Lock()
        # task_id -> {proc or pid, result_path}
        self._tasks: dict[str, dict] = {}

    def fingerprint(self) -> DriverInfo:
        ok = ensure_executor_binary(self.executor_bin) is not None
        return DriverInfo(detected=ok, healthy=ok,
                          health_description="" if ok
                          else "nomad-executor binary unavailable",
                          attributes={"driver.exec.executor": "native"})

    def start_task(self, task_id: str, task, task_dir: str,
                   env: dict[str, str]) -> TaskHandle:
        binary = ensure_executor_binary(self.executor_bin)
        if binary is None:
            raise RuntimeError("nomad-executor binary unavailable")
        cfg = task.config
        command = cfg.get("command", "")
        if not command:
            raise ValueError("exec requires config.command")
        args = cfg.get("args", [])
        if isinstance(args, str):
            args = shlex.split(args)

        safe_id = task_id.replace("/", "_")
        spec_path = os.path.join(task_dir, f".{safe_id}.spec")
        result_path = os.path.join(task_dir, f".{safe_id}.result.json")
        pid_path = os.path.join(task_dir, f".{safe_id}.pid")
        for stale in (result_path, pid_path):
            if os.path.exists(stale):
                os.unlink(stale)

        full_env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin")}
        full_env.update(env)

        # execve does no PATH search: resolve bare commands against the
        # task's PATH (matching the raw_exec/Popen behavior)
        if "/" not in command:
            import shutil
            resolved = shutil.which(command, path=full_env.get("PATH"))
            if resolved is None:
                raise ValueError(f"command {command!r} not found on PATH")
            command = resolved

        # the spec file is line-oriented: embedded newlines would inject
        # directives (e.g. a second command=), so reject them outright
        for label, value in ([("command", command)] +
                             [("arg", a) for a in args] +
                             [(f"env {k}", f"{k}={v}")
                              for k, v in full_env.items()]):
            if "\n" in str(value) or "\r" in str(value):
                raise ValueError(f"{label} contains a newline")

        lines = [f"command={command}"]
        lines += [f"arg={a}" for a in args]
        lines += [f"env={k}={v}" for k, v in full_env.items()]
        lines += [
            f"cwd={task_dir}",
            f"stdout={os.path.join(task_dir, task.name + '.stdout.log')}",
            f"stderr={os.path.join(task_dir, task.name + '.stderr.log')}",
            f"result={result_path}",
            f"pidfile={pid_path}",
            f"memory_mb={task.resources.memory_mb or 0}",
            f"cpu_nice={int(cfg.get('nice', 0))}",
            f"cpu_shares={task.resources.cpu or 0}",
        ]
        cg = _cgroup_parent()
        if cg:
            lines.append(f"cgroup_parent={cg}")
        with open(spec_path, "w") as f:
            f.write("\n".join(lines) + "\n")

        proc = subprocess.Popen([binary, spec_path],
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL,
                                start_new_session=True)
        with self._lock:
            self._tasks[task_id] = {"pid": proc.pid, "proc": proc,
                                    "result": result_path,
                                    "pidfile": pid_path}
        return TaskHandle(task_id=task_id, driver=self.name, pid=proc.pid,
                          config={"result": result_path,
                                  "pidfile": pid_path},
                          started_at=time.time())

    def wait_task(self, task_id: str, timeout: Optional[float] = None
                  ) -> Optional[ExitResult]:
        with self._lock:
            rec = self._tasks.get(task_id)
        if rec is None:
            return ExitResult(err="unknown task")
        deadline = time.time() + timeout if timeout is not None else None
        while True:
            result = self._read_result(rec["result"])
            if result is not None:
                return result
            if not self._executor_alive(rec):
                # the executor may have written the result between our two
                # checks — re-read before declaring it dead
                time.sleep(0.05)
                result = self._read_result(rec["result"])
                if result is not None:
                    return result
                self._kill_task_group(rec)   # don't leak the task tree
                return ExitResult(exit_code=-1, err="executor died")
            if deadline is not None and time.time() >= deadline:
                return None
            time.sleep(0.05)

    def _read_result(self, path: str) -> Optional[ExitResult]:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        return ExitResult(exit_code=int(data.get("exit_code", -1)),
                          signal=int(data.get("signal", 0)),
                          err=data.get("err", ""))

    def _executor_alive(self, rec: dict) -> bool:
        proc = rec.get("proc")
        if proc is not None:
            return proc.poll() is None
        try:
            os.kill(rec["pid"], 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:
            return True

    def stop_task(self, task_id: str, kill_timeout: float = 5.0,
                  sig: str = "") -> None:
        with self._lock:
            rec = self._tasks.get(task_id)
        if rec is None:
            return
        signum = getattr(signal, sig, signal.SIGTERM) if sig else signal.SIGTERM
        try:
            os.kill(rec["pid"], signum)   # executor forwards to the task group
        except ProcessLookupError:
            return
        deadline = time.time() + kill_timeout
        while time.time() < deadline:
            if self._read_result(rec["result"]) is not None or \
               not self._executor_alive(rec):
                return
            time.sleep(0.05)
        # escalation: the task ignored its signal — SIGKILL the TASK's
        # process group (from the pidfile), then give the executor a
        # moment to reap the child and persist the result. SIGKILLing
        # the executor immediately (the old order) raced its waitpid:
        # in a container whose PID 1 never reaps orphans, the killed
        # child stayed a zombie forever and `kill(child, 0)` kept
        # succeeding — the task looked alive after a confirmed kill.
        self._kill_task_group(rec)
        reap_deadline = time.time() + 2.0
        while time.time() < reap_deadline:
            if self._read_result(rec["result"]) is not None or \
               not self._executor_alive(rec):
                return
            time.sleep(0.02)
        try:
            os.kill(rec["pid"], signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def signal_task(self, task_id: str, sig: str) -> None:
        """Signal the task's process group directly (the executor's child,
        from the pidfile) — ref executor Signal RPC."""
        with self._lock:
            rec = self._tasks.get(task_id)
        if rec is None:
            raise ValueError("unknown task")
        signum = getattr(signal, sig, None)
        if signum is None:
            raise ValueError(f"invalid signal {sig!r}")
        child = self._child_pid(rec)
        if child <= 0:
            raise ValueError("task not running")
        os.killpg(os.getpgid(child), signum)

    def task_stats(self, task_id: str) -> dict:
        from .driver import read_proc_stats
        with self._lock:
            rec = self._tasks.get(task_id)
        if rec is None:
            return super().task_stats(task_id)
        child = self._child_pid(rec)
        if child <= 0:
            return super().task_stats(task_id)
        return read_proc_stats(child)

    def _child_pid(self, rec: dict) -> int:
        try:
            with open(rec.get("pidfile", "")) as f:
                parts = f.read().split()
            return int(parts[1]) if len(parts) > 1 else 0
        except (OSError, ValueError, IndexError):
            return 0

    def _kill_task_group(self, rec: dict) -> None:
        child = self._child_pid(rec)
        if child > 0:
            try:
                os.killpg(child, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    def destroy_task(self, task_id: str) -> None:
        self.stop_task(task_id, kill_timeout=0.2)
        with self._lock:
            self._tasks.pop(task_id, None)

    def inspect_task(self, task_id: str) -> Optional[TaskHandle]:
        with self._lock:
            rec = self._tasks.get(task_id)
        if rec is None:
            return None
        return TaskHandle(task_id=task_id, driver=self.name, pid=rec["pid"],
                          config={"result": rec["result"]})

    def recover_task(self, handle: TaskHandle) -> bool:
        """Reattach: the executor (or at least its result file) carries the
        task's fate across client restarts."""
        result_path = handle.config.get("result", "")
        rec = {"pid": handle.pid, "proc": None, "result": result_path,
               "pidfile": handle.config.get("pidfile", "")}
        if self._read_result(result_path) is not None or \
           self._executor_alive(rec):
            with self._lock:
                self._tasks[handle.task_id] = rec
            return True
        return False
