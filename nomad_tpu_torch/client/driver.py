"""Task driver interface + built-in drivers (ref plugins/drivers/driver.go:47
DriverPlugin and drivers/mock, drivers/rawexec).

The DriverPlugin contract: fingerprint / start_task / wait_task / stop_task /
destroy_task / inspect_task / recover_task. In-process here; the executor
subprocess boundary (ref drivers/shared/executor) arrives with the C++
runtime sidecar.
"""
from __future__ import annotations

import dataclasses
import os
import shlex
import signal
import subprocess
import threading
import time
from typing import Optional

from ..structs import DriverInfo


@dataclasses.dataclass
class TaskHandle:
    """Recoverable handle to a running task (ref drivers TaskHandle +
    reattach config)."""
    task_id: str = ""
    driver: str = ""
    pid: int = 0
    config: dict = dataclasses.field(default_factory=dict)
    started_at: float = 0.0


@dataclasses.dataclass
class ExitResult:
    exit_code: int = 0
    signal: int = 0
    oom_killed: bool = False
    err: str = ""

    def successful(self) -> bool:
        return self.exit_code == 0 and self.signal == 0 and not self.err


class ExecSession:
    """One interactive exec-into-task stream (ref
    plugins/drivers/driver.go:69 ExecTaskStreaming,
    drivers/shared/executor ExecStreaming): a subprocess sharing the
    task's dir/env, optionally under a PTY, with non-blocking output
    drains feeding a bounded buffer."""

    def __init__(self, argv: list[str], cwd: str, env: dict[str, str],
                 tty: bool = False):
        import subprocess as sp
        self.tty = tty
        self._lock = threading.Lock()
        self._stdout = bytearray()
        self._stderr = bytearray()
        self._data = threading.Condition(self._lock)
        self.exit_code: Optional[int] = None
        full_env = dict(os.environ)
        full_env.update(env)
        self._drainers: list[threading.Thread] = []
        if tty:
            import pty
            self._master, slave = pty.openpty()
            self.proc = sp.Popen(argv, cwd=cwd, env=full_env,
                                 stdin=slave, stdout=slave, stderr=slave,
                                 start_new_session=True, close_fds=True)
            os.close(slave)
            t = threading.Thread(target=self._drain_pty, daemon=True)
            t.start()
            self._drainers.append(t)
        else:
            self._master = None
            self.proc = sp.Popen(argv, cwd=cwd, env=full_env,
                                 stdin=sp.PIPE, stdout=sp.PIPE,
                                 stderr=sp.PIPE, start_new_session=True)
            for pipe, buf in ((self.proc.stdout, self._stdout),
                              (self.proc.stderr, self._stderr)):
                t = threading.Thread(target=self._drain, daemon=True,
                                     args=(pipe, buf))
                t.start()
                self._drainers.append(t)
        threading.Thread(target=self._reap, daemon=True).start()

    def _drain(self, pipe, buf: bytearray) -> None:
        while True:
            chunk = pipe.read1(65536) if hasattr(pipe, "read1") else \
                pipe.read(65536)
            if not chunk:
                break
            with self._data:
                buf.extend(chunk)
                self._data.notify_all()

    def _drain_pty(self) -> None:
        while True:
            try:
                chunk = os.read(self._master, 65536)
            except OSError:
                break
            if not chunk:
                break
            with self._data:
                self._stdout.extend(chunk)
                self._data.notify_all()

    def _reap(self) -> None:
        code = self.proc.wait()
        # exit_code is only published AFTER the drain threads hit EOF, so
        # "exited with no pending output" really means all output was
        # delivered (a fixed sleep would race large final bursts)
        for t in self._drainers:
            t.join(timeout=5.0)
        with self._data:
            self.exit_code = code if code >= 0 else 128 - code
            self._data.notify_all()

    def write_stdin(self, data: bytes) -> None:
        if self.tty:
            os.write(self._master, data)
        elif self.proc.stdin:
            try:
                self.proc.stdin.write(data)
                self.proc.stdin.flush()
            except (BrokenPipeError, ValueError):
                pass

    def close_stdin(self) -> None:
        if self.tty:
            # a PTY has no half-close: deliver EOF as the line
            # discipline's VEOF character (^D)
            try:
                os.write(self._master, b"\x04")
            except OSError:
                pass
        elif self.proc.stdin:
            try:
                self.proc.stdin.close()
            except OSError:
                pass

    def resize(self, rows: int, cols: int) -> None:
        """ref drivers/driver.go TaskResizeCh"""
        if self._master is None:
            return
        import fcntl
        import struct
        import termios
        fcntl.ioctl(self._master, termios.TIOCSWINSZ,
                    struct.pack("HHHH", rows, cols, 0, 0))

    def read_output(self, wait: float = 0.0) -> dict:
        """Drain buffered output. Blocks up to `wait` seconds for new
        data or exit. -> {stdout, stderr, exited, exit_code}"""
        deadline = time.monotonic() + wait
        with self._data:
            while not self._stdout and not self._stderr and \
                    self.exit_code is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._data.wait(left)
            out = bytes(self._stdout)
            err = bytes(self._stderr)
            self._stdout.clear()
            self._stderr.clear()
            return {"stdout": out, "stderr": err,
                    "exited": self.exit_code is not None,
                    "exit_code": self.exit_code}

    def terminate(self) -> None:
        if self.proc.poll() is None:
            try:
                os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        if self._master is not None:
            try:
                os.close(self._master)
            except OSError:
                pass


def validate_config(config: dict, schema: dict) -> str:
    """Validate a task's driver config against the driver's declared
    schema (the hclspec analog, ref plugins/shared/hclspec + each
    driver's TaskConfig spec). Returns "" or an error string.

    schema: {key: {"type": "string"|"number"|"bool"|"list"|"map",
                   "required": bool, "default": any}}; unknown keys are
    rejected — the reference's hcl decoding errors the same way."""
    TYPES = {"string": str, "number": (int, float), "bool": bool,
             "list": (list, tuple), "map": dict,
             # args-style fields: a list OR a shell string the driver
             # shlex-splits
             "list_or_string": (list, tuple, str)}
    for key in config:
        if key not in schema:
            return (f"unknown driver config key {key!r} "
                    f"(known: {', '.join(sorted(schema)) or 'none'})")
    for key, spec in schema.items():
        if key not in config:
            if spec.get("required"):
                return f"missing required driver config key {key!r}"
            continue
        want = TYPES.get(spec.get("type", ""), object)
        val = config[key]
        # bools are ints in python; keep number/bool distinct like hcl
        if spec.get("type") == "number" and isinstance(val, bool):
            return f"driver config {key!r}: expected number, got bool"
        if not isinstance(val, want):
            return (f"driver config {key!r}: expected "
                    f"{spec.get('type')}, got {type(val).__name__}")
    return ""


class Driver:
    name = "driver"

    def fingerprint(self) -> DriverInfo:
        return DriverInfo(detected=True, healthy=True)

    def config_schema(self) -> Optional[dict]:
        """Declared task-config schema (hclspec analog); None skips
        validation (plugin drivers may validate internally)."""
        return None

    def bind_client(self, client) -> None:
        """Drivers needing cluster access (catalog resolution etc.) get
        the owning client after construction; default no-op."""

    def start_task(self, task_id: str, task, task_dir: str,
                   env: dict[str, str]) -> TaskHandle:
        raise NotImplementedError

    def wait_task(self, task_id: str, timeout: Optional[float] = None
                  ) -> Optional[ExitResult]:
        raise NotImplementedError

    def stop_task(self, task_id: str, kill_timeout: float = 5.0,
                  sig: str = "") -> None:
        raise NotImplementedError

    def destroy_task(self, task_id: str) -> None:
        pass

    def signal_task(self, task_id: str, sig: str) -> None:
        """Send a signal to a running task (ref DriverPlugin.SignalTask,
        plugins/drivers/driver.go:47)."""
        raise NotImplementedError(
            f"driver {self.name!r} does not support signaling")

    def task_stats(self, task_id: str) -> dict:
        """Point-in-time resource usage (ref DriverPlugin.TaskStats):
        {"cpu_percent": float, "memory_rss_bytes": int}."""
        return {"cpu_percent": 0.0, "memory_rss_bytes": 0}

    def exec_task(self, task_id: str, command: list[str], tty: bool = False,
                  cwd: str = "", env: Optional[dict] = None) -> ExecSession:
        """Interactive exec inside the task's context (ref
        plugins/drivers/driver.go:577 ExecTaskStreamingRaw). The base
        implementation spawns a host process in the task dir with the
        task env — correct for every host-process driver (raw_exec, mock,
        exec-without-namespaces); containerized drivers override to enter
        the task's isolation context."""
        if not command:
            raise ValueError("exec requires a command")
        return ExecSession(list(command), cwd=cwd or os.getcwd(),
                           env=env or {}, tty=tty)

    def inspect_task(self, task_id: str) -> Optional[TaskHandle]:
        return None

    def recover_task(self, handle: TaskHandle) -> bool:
        """Reattach after client restart; True if the task is still live."""
        return False


def read_proc_stats(pid: int) -> dict:
    """Read one process's usage from /proc (ref client/stats and the
    executor's TaskStats: total_ticks + RSS)."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            rss_pages = int(f.read().split()[1])
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(") ", 1)[1].split()
        utime, stime = int(fields[11]), int(fields[12])
        hz = os.sysconf("SC_CLK_TCK")
        return {
            "cpu_percent": 0.0,   # needs two samples; ticks are the basis
            "cpu_total_ticks": (utime + stime) / hz,
            "memory_rss_bytes": rss_pages * os.sysconf("SC_PAGE_SIZE"),
        }
    except (OSError, IndexError, ValueError):
        return {"cpu_percent": 0.0, "memory_rss_bytes": 0}


def _seconds(v) -> float:
    """Accept bare seconds or duration strings ('10s', '1m') — the reference
    mock driver's config takes Go duration strings (drivers/mock)."""
    if isinstance(v, (int, float)):
        return float(v)
    from ..jobspec import duration
    return duration(str(v))


class MockDriver(Driver):
    """Configurable fake driver for tests (ref drivers/mock): config keys
    run_for (sec or duration string), exit_code, start_error, kill_after."""

    name = "mock_driver"

    def config_schema(self):
        # run_for/kill_after accept seconds OR duration strings -> no
        # type constraint (hclspec would model this as a union)
        return {"run_for": {}, "kill_after": {},
                "exit_code": {"type": "number"},
                "start_error": {"type": "string"},
                "signal_error": {"type": "string"}}

    def __init__(self):
        self._lock = threading.Lock()
        self._tasks: dict[str, dict] = {}

    def start_task(self, task_id, task, task_dir, env):
        cfg = task.config
        if cfg.get("start_error"):
            raise RuntimeError(cfg["start_error"])
        now = time.time()
        rec = {
            "ends_at": now + _seconds(cfg.get("run_for", 0.0)),
            "exit_code": int(cfg.get("exit_code", 0)),
            "stopped": threading.Event(),
            "started_at": now,
            "signals": [],
        }
        with self._lock:
            self._tasks[task_id] = rec
        return TaskHandle(task_id=task_id, driver=self.name, started_at=now)

    def wait_task(self, task_id, timeout=None):
        with self._lock:
            rec = self._tasks.get(task_id)
        if rec is None:
            return ExitResult(err="unknown task")
        deadline = time.time() + timeout if timeout is not None else None
        while True:
            remaining = rec["ends_at"] - time.time()
            if rec["stopped"].is_set():
                return ExitResult(exit_code=0, signal=9)
            if remaining <= 0:
                return ExitResult(exit_code=rec["exit_code"])
            if deadline is not None and time.time() >= deadline:
                return None
            rec["stopped"].wait(min(0.05, max(0.01, remaining)))

    def stop_task(self, task_id, kill_timeout=5.0, sig=""):
        with self._lock:
            rec = self._tasks.get(task_id)
        if rec:
            rec["stopped"].set()

    def destroy_task(self, task_id):
        with self._lock:
            self._tasks.pop(task_id, None)

    def signal_task(self, task_id, sig):
        with self._lock:
            rec = self._tasks.get(task_id)
        if rec is None:
            raise ValueError("unknown task")
        rec["signals"].append(sig)

    def received_signals(self, task_id) -> list[str]:
        with self._lock:
            rec = self._tasks.get(task_id)
        return list(rec["signals"]) if rec else []

    def recover_task(self, handle):
        with self._lock:
            return handle.task_id in self._tasks


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# native out-of-process log collector (ref client/logmon: a subprocess
# per task stream so the agent never holds task IO); built by
# `make -C native`, absent -> drivers append directly and the Python
# LogRotator handles rotation
LOGMON_BIN = os.path.join(_REPO_ROOT, "native", "nomad-logmon")


def logmon_available() -> bool:
    return os.access(LOGMON_BIN, os.X_OK)


def _open_log_sinks(task_dir: str, task):
    """(stdout_sink, stderr_sink, logmon_procs): pipes into per-stream
    nomad-logmon subprocesses when the native binary is built, plain
    O_APPEND files otherwise. Callers close the returned sinks after
    handing them to the task process."""
    lc = getattr(task, "log_config", None)
    max_bytes = (getattr(lc, "max_file_size_mb", 10) or 10) * 1024 * 1024
    max_files = getattr(lc, "max_files", 10) or 10
    if logmon_available():
        procs = []
        sinks = []
        try:
            for stream in ("stdout", "stderr"):
                base = os.path.join(task_dir, f"{task.name}.{stream}.log")
                p = subprocess.Popen(
                    [LOGMON_BIN, base, str(max_bytes), str(max_files)],
                    stdin=subprocess.PIPE, start_new_session=True)
                procs.append(p)
                sinks.append(p.stdin)
        except BaseException:
            # second spawn failed: close the first sidecar's pipe so it
            # sees EOF and exits rather than leaking on read()
            for f in sinks:
                try:
                    f.close()
                except OSError:
                    pass
            for p in procs:
                try:
                    p.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    p.kill()
            raise
        return sinks[0], sinks[1], procs
    # task stdout/stderr streams: loss-tolerant by contract (the
    # reference loses in-flight log bytes on power loss too); not
    # control-plane state
    # nomadlint: disable=DUR001 — loss-tolerant log stream
    stdout = open(os.path.join(task_dir, f"{task.name}.stdout.log"), "ab")
    # nomadlint: disable=DUR001 — task log stream, see above
    stderr = open(os.path.join(task_dir, f"{task.name}.stderr.log"), "ab")
    return stdout, stderr, []


class ConnectProxyDriver(Driver):
    """The sidecar data plane for connect_admission-injected proxy tasks
    (ref envoy in the reference; here an in-process threaded TCP proxy —
    see integrations/connect.py for the mesh wiring). Ingress listener:
    allocated dynamic port -> 127.0.0.1:<local service port>. Upstream
    listeners: 127.0.0.1:<local_bind_port> -> a healthy catalog instance
    of the destination, resolved PER CONNECTION through the client's RPC
    (instances move; the mesh follows)."""

    name = "connect_proxy"

    def __init__(self):
        self._lock = threading.Lock()
        self._tasks: dict[str, dict] = {}
        self._client = None

    def bind_client(self, client) -> None:
        self._client = client

    _AUTHZ_TTL = 2.0

    def _resolver(self, namespace: str, source: str, destination: str):
        authz_cache = [0.0, True]       # (expiry, allowed)

        def resolve():
            client = self._client
            if client is None:
                return None
            try:
                # mesh authorization: the proxy enforces intentions (the
                # envoy-RBAC analog; ref Consul intentions — which pushes
                # cached intentions to proxies). A short-TTL cache keeps
                # the data plane at ~one authz RPC per TTL instead of one
                # per connection; default allow with no matching rule.
                now = time.monotonic()
                if now >= authz_cache[0]:
                    authz_cache[1] = client.rpc.intention_allowed(
                        namespace, source, destination)
                    authz_cache[0] = now + self._AUTHZ_TTL
                if not authz_cache[1]:
                    client.logger(
                        f"connect-proxy: intention denies "
                        f"{source} -> {destination}")
                    return None
                instances = client.rpc.service_instances(namespace,
                                                         destination)
            except Exception:           # noqa: BLE001 — servers away
                return None
            healthy = [i for i in instances
                       if getattr(i, "status", "passing") == "passing"]
            if not healthy:
                return None
            inst = healthy[int(time.time() * 1000) % len(healthy)]
            return (inst.address, inst.port)
        return resolve

    def start_task(self, task_id, task, task_dir, env):
        from ..integrations.connect import _Forwarder
        cfg = task.config
        logger = (self._client.logger if self._client is not None
                  else (lambda m: None))
        from .taskenv import _env_key
        forwarders: list = []
        ingress_label = _env_key(cfg.get("ingress_port_label", ""))
        ingress_port = int(env.get(f"NOMAD_PORT_{ingress_label}", 0) or 0)
        svc_label = _env_key(cfg.get("local_service_port_label", ""))
        svc_port = int(env.get(f"NOMAD_PORT_{svc_label}", 0) or 0)
        if ingress_port and svc_port:
            forwarders.append(_Forwarder(
                ("0.0.0.0", ingress_port),
                lambda: ("127.0.0.1", svc_port), logger,
                name=f"connect-ingress-{task_id[:8]}"))
        ns = cfg.get("namespace", "default")
        for up in cfg.get("upstreams", []):
            forwarders.append(_Forwarder(
                ("127.0.0.1", int(up["local_bind_port"])),
                self._resolver(ns, cfg.get("service", ""),
                               up["destination"]), logger,
                name=f"connect-up-{up['destination']}-{task_id[:8]}"))
        # expose-path listeners (ref job_endpoint_hook_expose_check.go +
        # envoy expose paths): health-check paths served on their own
        # ports through the sidecar, everything else 403'd
        from ..integrations.connect import ExposeForwarder
        for ex in cfg.get("expose", []) or []:
            ex_label = _env_key(ex.get("listener_port_label", ""))
            ex_port = int(env.get(f"NOMAD_PORT_{ex_label}", 0) or 0)
            # the reference allows a check's local path port to differ
            # from the service port (expose.path local_path_port); honor
            # the entry's own label and fall back to the service port
            lp_label = _env_key(ex.get("local_path_port_label", ""))
            lp_port = int(env.get(f"NOMAD_PORT_{lp_label}", 0) or 0) \
                or svc_port
            if ex_port and lp_port:
                forwarders.append(ExposeForwarder(
                    ("0.0.0.0", ex_port),
                    lambda lp=lp_port: ("127.0.0.1", lp), logger,
                    name=f"connect-expose-{task_id[:8]}",
                    path=ex.get("path", "/")))
        for f in forwarders:
            f.start()
        rec = {"forwarders": forwarders, "stopped": threading.Event(),
               "started_at": time.time()}
        with self._lock:
            self._tasks[task_id] = rec
        return TaskHandle(task_id=task_id, driver=self.name,
                          started_at=rec["started_at"])

    def wait_task(self, task_id, timeout=None):
        with self._lock:
            rec = self._tasks.get(task_id)
        if rec is None:
            return ExitResult(err="unknown task")
        if rec["stopped"].wait(timeout):
            return ExitResult(exit_code=0)
        return None

    def stop_task(self, task_id, kill_timeout=5.0, sig=""):
        with self._lock:
            rec = self._tasks.get(task_id)
        if rec is None:
            return
        for f in rec["forwarders"]:
            f.stop()
        rec["stopped"].set()

    def destroy_task(self, task_id):
        self.stop_task(task_id)
        with self._lock:
            self._tasks.pop(task_id, None)

    def inspect_task(self, task_id):
        with self._lock:
            rec = self._tasks.get(task_id)
        if rec is None:
            raise KeyError(task_id)
        return {"connections": sum(f.connections
                                   for f in rec["forwarders"])}


class RawExecDriver(Driver):
    """Fork/exec without isolation (ref drivers/rawexec): config keys
    command, args."""

    name = "raw_exec"

    def config_schema(self):
        return {"command": {"type": "string", "required": True},
                "args": {"type": "list_or_string"}}

    def __init__(self):
        self._lock = threading.Lock()
        self._procs: dict[str, subprocess.Popen] = {}
        self._logmons: dict[str, list] = {}

    def uses_logmon(self) -> bool:
        """True when this driver routes task output through the native
        nomad-logmon sidecar (which then owns rotation)."""
        return logmon_available()

    def start_task(self, task_id, task, task_dir, env):
        cfg = task.config
        command = cfg.get("command", "")
        if not command:
            raise ValueError("raw_exec requires config.command")
        args = cfg.get("args", [])
        if isinstance(args, str):
            args = shlex.split(args)
        full_env = dict(os.environ)
        full_env.update(env)
        stdout, stderr, logmons = _open_log_sinks(task_dir, task)

        def _close_sinks():
            # the parent's copies of the pipe write-ends must close so
            # each logmon sees EOF when the TASK exits
            for f in (stdout, stderr):
                try:
                    f.close()
                except OSError:
                    pass

        try:
            proc = subprocess.Popen(
                [command] + list(args), cwd=task_dir, env=full_env,
                stdout=stdout, stderr=stderr,
                start_new_session=True)  # own process group for clean kill
        except BaseException:
            # Popen raised (bad command): close the write-ends so the
            # sidecars see EOF and exit instead of leaking on read()
            _close_sinks()
            for p in logmons:
                try:
                    p.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    p.kill()
            raise
        _close_sinks()
        with self._lock:
            self._procs[task_id] = proc
            if logmons:
                self._logmons[task_id] = logmons
        return TaskHandle(task_id=task_id, driver=self.name, pid=proc.pid,
                          started_at=time.time())

    def _drain_logmons(self, task_id) -> None:
        """After task exit, wait briefly for the logmon sidecars to see
        EOF and flush, so callers reading the log files observe all
        output (the reference's logmon shutdown barrier)."""
        with self._lock:
            logmons = self._logmons.pop(task_id, [])
        for p in logmons:
            try:
                p.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                p.kill()

    def wait_task(self, task_id, timeout=None):
        with self._lock:
            proc = self._procs.get(task_id)
        if proc is None:
            return ExitResult(err="unknown task")
        try:
            code = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None
        if code is None:
            return None
        self._drain_logmons(task_id)
        if code < 0:
            return ExitResult(exit_code=0, signal=-code)
        return ExitResult(exit_code=code)

    def stop_task(self, task_id, kill_timeout=5.0, sig=""):
        with self._lock:
            proc = self._procs.get(task_id)
        if proc is None or proc.poll() is not None:
            return
        signum = getattr(signal, sig, signal.SIGINT) if sig else signal.SIGINT
        try:
            os.killpg(os.getpgid(proc.pid), signum)
        except (ProcessLookupError, PermissionError):
            return
        deadline = time.time() + kill_timeout
        while time.time() < deadline:
            if proc.poll() is not None:
                return
            time.sleep(0.05)
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def destroy_task(self, task_id):
        self.stop_task(task_id, kill_timeout=0.1)
        self._drain_logmons(task_id)
        with self._lock:
            self._procs.pop(task_id, None)

    def signal_task(self, task_id, sig):
        with self._lock:
            proc = self._procs.get(task_id)
        if proc is None or proc.poll() is not None:
            raise ValueError("task not running")
        signum = getattr(signal, sig, None)
        if signum is None:
            raise ValueError(f"invalid signal {sig!r}")
        os.killpg(os.getpgid(proc.pid), signum)

    def task_stats(self, task_id):
        with self._lock:
            proc = self._procs.get(task_id)
        if proc is None or proc.poll() is not None:
            return super().task_stats(task_id)
        return read_proc_stats(proc.pid)

    def recover_task(self, handle):
        if handle.pid <= 0:
            return False
        try:
            os.kill(handle.pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            pass
        # re-wrap the pid so wait/stop work post-restart
        proc = _ReattachedProcess(handle.pid)
        with self._lock:
            self._procs[handle.task_id] = proc   # type: ignore[assignment]
        return True


class _ReattachedProcess:
    """Minimal Popen-alike over a bare pid for post-restart reattach."""

    def __init__(self, pid: int):
        self.pid = pid
        self._code: Optional[int] = None

    def poll(self):
        if self._code is not None:
            return self._code
        try:
            os.kill(self.pid, 0)
            return None
        except ProcessLookupError:
            self._code = 0
            return self._code

    def wait(self, timeout=None):
        deadline = time.time() + timeout if timeout is not None else None
        while True:
            code = self.poll()
            if code is not None:
                return code
            if deadline is not None and time.time() >= deadline:
                raise subprocess.TimeoutExpired(cmd=f"pid:{self.pid}",
                                                timeout=timeout)
            time.sleep(0.05)


def _exec_driver():
    from .exec_driver import ExecDriver
    return ExecDriver()


def _java_driver():
    from .ext_drivers import JavaDriver
    return JavaDriver()


def _qemu_driver():
    from .ext_drivers import QemuDriver
    return QemuDriver()


def _docker_driver():
    from .ext_drivers import DockerDriver
    return DockerDriver()


BUILTIN_DRIVERS = {
    "mock_driver": MockDriver,
    "raw_exec": RawExecDriver,
    "connect_proxy": ConnectProxyDriver,   # the sidecar data plane
    "exec": _exec_driver,       # native C++ executor supervisor
    "java": _java_driver,
    "qemu": _qemu_driver,       # gated: fingerprints only with qemu present
    "docker": _docker_driver,   # gated: fingerprints only with a live daemon
}
