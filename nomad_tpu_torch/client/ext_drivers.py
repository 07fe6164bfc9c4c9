"""Extended task drivers: java, qemu, docker (ref drivers/java/driver.go,
drivers/qemu/driver.go, drivers/docker/driver.go).

Each follows the reference's shape: fingerprint gates on the host runtime
being present (java binary, qemu binary, docker socket+CLI), start builds
the runtime-specific command line, and lifecycle is managed through the
same process supervision the raw_exec driver uses (the reference routes
java/qemu through its shared executor the same way; docker drives the
engine, here via the docker CLI instead of the HTTP API client library).
"""
from __future__ import annotations

import os
import shlex
import shutil
import subprocess
import time
from typing import Optional

from ..structs import DriverInfo
from .driver import ExitResult, RawExecDriver, TaskHandle


def _binary_version(cmd: list[str]) -> Optional[str]:
    try:
        out = subprocess.run(cmd, capture_output=True, timeout=5)
        text = (out.stdout or out.stderr).decode(errors="replace")
        return text.splitlines()[0].strip() if text else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return None


class JavaDriver(RawExecDriver):
    """ref drivers/java: config keys jar_path | class, args, jvm_options."""

    name = "java"

    def config_schema(self):
        # overrides the inherited raw_exec schema, which would reject
        # every legitimate java config key
        return {"jar_path": {"type": "string"},
                "class": {"type": "string"},
                "class_path": {"type": "string"},
                "jvm_options": {"type": "list"},
                "args": {"type": "list_or_string"}}

    def fingerprint(self) -> DriverInfo:
        if shutil.which("java") is None:
            return DriverInfo(detected=False, healthy=False,
                              health_description="java binary not found")
        version = _binary_version(["java", "-version"]) or ""
        return DriverInfo(detected=True, healthy=True,
                          attributes={"driver.java.version": version})

    def start_task(self, task_id, task, task_dir, env):
        cfg = task.config
        argv = ["java"]
        jvm_options = cfg.get("jvm_options", [])
        if isinstance(jvm_options, str):
            jvm_options = shlex.split(jvm_options)
        argv += list(jvm_options)
        if task.resources.memory_mb:
            argv.append(f"-Xmx{task.resources.memory_mb}m")
        if cfg.get("jar_path"):
            argv += ["-jar", cfg["jar_path"]]
        elif cfg.get("class"):
            if cfg.get("class_path"):
                argv += ["-cp", cfg["class_path"]]
            argv.append(cfg["class"])
        else:
            raise ValueError("java driver requires jar_path or class")
        args = cfg.get("args", [])
        if isinstance(args, str):
            args = shlex.split(args)
        argv += list(args)
        # delegate supervision to the raw_exec machinery
        wrapped = task.copy()
        wrapped.config = {"command": argv[0], "args": argv[1:]}
        return super().start_task(task_id, wrapped, task_dir, env)


class QemuDriver(RawExecDriver):
    """ref drivers/qemu: config keys image_path, accelerator, graceful
    shutdown via monitor is simplified to SIGTERM; port_map -> hostfwd."""

    name = "qemu"
    binary = "qemu-system-x86_64"

    def config_schema(self):
        return {"image_path": {"type": "string", "required": True},
                "accelerator": {"type": "string"},
                "port_map": {"type": "list"},
                "args": {"type": "list_or_string"}}

    def fingerprint(self) -> DriverInfo:
        if shutil.which(self.binary) is None:
            return DriverInfo(detected=False, healthy=False,
                              health_description="qemu binary not found")
        version = _binary_version([self.binary, "--version"]) or ""
        return DriverInfo(detected=True, healthy=True,
                          attributes={"driver.qemu.version": version})

    def start_task(self, task_id, task, task_dir, env):
        cfg = task.config
        image = cfg.get("image_path", "")
        if not image:
            raise ValueError("qemu driver requires image_path")
        if not os.path.isabs(image):
            image = os.path.join(task_dir, image)
        argv = [self.binary,
                "-machine", f"type=pc,accel={cfg.get('accelerator', 'tcg')}",
                "-name", task.name,
                "-m", f"{task.resources.memory_mb or 512}M",
                "-drive", f"file={image}",
                "-nographic"]
        for fwd in cfg.get("port_map", []):
            host, guest = fwd.get("host", 0), fwd.get("guest", 0)
            argv += ["-netdev",
                     f"user,id=n{host},hostfwd=tcp::{host}-:{guest}",
                     "-device", f"virtio-net,netdev=n{host}"]
        extra = cfg.get("args", [])
        if isinstance(extra, str):
            extra = shlex.split(extra)
        argv += list(extra)
        wrapped = task.copy()
        wrapped.config = {"command": argv[0], "args": argv[1:]}
        return super().start_task(task_id, wrapped, task_dir, env)


class ImageCoordinator:
    """Refcounted image pulls (ref drivers/docker/coordinator.go
    dockerCoordinator): concurrent tasks asking for the same image share
    ONE pull (per-image lock, others wait on it); each task holds a
    reference, and when the last reference drops the image is removed —
    if cleanup is enabled — after a delay that lets rapid reschedules
    reuse the warm image."""

    def __init__(self, pull_fn, remove_fn, cleanup: bool = False,
                 remove_delay: float = 0.0):
        import threading
        self._pull = pull_fn
        self._remove = remove_fn
        self.cleanup = cleanup
        self.remove_delay = remove_delay
        self._lock = threading.Lock()
        self._pulls: dict[str, threading.Event] = {}    # in-flight
        self._pull_err: dict[str, str] = {}
        self._refs: dict[str, set] = {}                 # image -> task ids
        self._remove_timers: dict[str, object] = {}     # delayed removes
        self.stats = {"pulls": 0, "pull_waits": 0, "removes": 0}

    def pull(self, image: str, task_id: str) -> None:
        import threading
        while True:
            with self._lock:
                # a re-reference cancels any pending delayed remove (ref
                # coordinator.go: IncrementImageReference stops the
                # removal timer) — otherwise the timer fires into the
                # new user's warm-reuse window
                timer = self._remove_timers.pop(image, None)
                if timer is not None:
                    timer.cancel()
                inflight = self._pulls.get(image)
                if inflight is None:
                    if image in self._refs:              # already present
                        self._refs[image].add(task_id)
                        return
                    ev = self._pulls[image] = threading.Event()
                    self.stats["pulls"] += 1
                    leader = True
                else:
                    ev = inflight
                    leader = False
                    self.stats["pull_waits"] += 1
            if leader:
                try:
                    self._pull(image)
                    with self._lock:
                        self._refs[image] = {task_id}
                        self._pull_err.pop(image, None)
                except Exception as e:  # noqa: BLE001
                    with self._lock:
                        self._pull_err[image] = str(e)
                finally:
                    with self._lock:
                        self._pulls.pop(image, None)
                    ev.set()
                err = self._pull_err.get(image)
                if err:
                    raise RuntimeError(f"image pull failed: {err}")
                return
            ev.wait(timeout=600.0)
            with self._lock:
                err = self._pull_err.get(image)
                if err is None and image in self._refs:
                    self._refs[image].add(task_id)
                    return
            if err:
                raise RuntimeError(f"image pull failed: {err}")
            # leader failed or raced a remove: retry as a fresh leader

    def release(self, image: str, task_id: str) -> None:
        """ref coordinator.go RemoveImage: drop the task's reference;
        remove the image when the last reference goes (cleanup on)."""
        import threading
        with self._lock:
            refs = self._refs.get(image)
            if refs is None:
                return
            refs.discard(task_id)
            if refs or not self.cleanup:
                return
            self._refs.pop(image, None)

        def _do_remove():
            with self._lock:
                self._remove_timers.pop(image, None)
                # re-referenced since scheduling, or a fresh pull is
                # in flight (leader sets _refs only after the pull
                # returns) — either way the image is wanted again
                if image in self._refs or image in self._pulls:
                    return
            try:
                self._remove(image)
                self.stats["removes"] += 1
            # in-use images legitimately refuse removal; the next GC
            # pass retries once the refcount drops
            except Exception:  # nomadlint: disable=EXC001 — GC retries
                pass
        if self.remove_delay > 0:
            t = threading.Timer(self.remove_delay, _do_remove)
            with self._lock:
                self._remove_timers[image] = t
            t.start()
        else:
            _do_remove()


class DockerDriver:
    """ref drivers/docker: engine lifecycle via the docker CLI — run with
    labels/resource limits, refcount-coordinated image pulls, port maps
    from the scheduler's allocated host ports, stop with configurable
    timeout, `docker exec` sessions, logs captured through `docker logs`
    into the task log files."""

    name = "docker"

    def __init__(self, docker_bin: str = "docker",
                 image_cleanup: bool = False,
                 image_remove_delay: float = 0.0):
        self.docker_bin = docker_bin
        self._containers: dict[str, dict] = {}
        self.coordinator = ImageCoordinator(
            self._pull_image, self._remove_image,
            cleanup=image_cleanup, remove_delay=image_remove_delay)

    def _pull_image(self, image: str) -> None:
        out = self._docker("pull", image, timeout=600.0)
        if out.returncode != 0:
            raise RuntimeError(out.stderr.decode(errors="replace"))

    def _remove_image(self, image: str) -> None:
        self._docker("rmi", image)

    # ------------------------------------------------------------ plumbing

    def _docker(self, *args, timeout: float = 30.0) -> subprocess.CompletedProcess:
        return subprocess.run([self.docker_bin, *args],
                              capture_output=True, timeout=timeout)

    def available(self) -> bool:
        if shutil.which(self.docker_bin) is None:
            return False
        try:
            return self._docker("version", "--format", "{{.Server.Version}}",
                                timeout=5).returncode == 0
        except (OSError, subprocess.TimeoutExpired):
            return False

    def fingerprint(self) -> DriverInfo:
        if not self.available():
            return DriverInfo(detected=False, healthy=False,
                              health_description="docker daemon unavailable")
        version = self._docker("version", "--format",
                               "{{.Server.Version}}").stdout.decode().strip()
        return DriverInfo(detected=True, healthy=True,
                          attributes={"driver.docker.version": version})

    # ----------------------------------------------------------- lifecycle

    def start_task(self, task_id, task, task_dir, env):
        cfg = task.config
        image = cfg.get("image", "")
        if not image:
            raise ValueError("docker driver requires config.image")
        # coordinated pull: N tasks of one job pulling the same image on
        # one node share a single `docker pull` (ref coordinator.go)
        if not cfg.get("skip_pull"):
            self.coordinator.pull(image, task_id)
        cname = "nomad-" + task_id.replace("/", "-")
        argv = ["run", "-d", "--name", cname,
                "--label", f"nomad_task_id={task_id}"]
        if task.resources.memory_mb:
            argv += ["--memory", f"{task.resources.memory_mb}m"]
        if task.resources.cpu:
            argv += ["--cpu-shares", str(task.resources.cpu)]
        if cfg.get("network_mode"):
            argv += ["--network", cfg["network_mode"]]
        for dns in cfg.get("dns_servers", []):
            argv += ["--dns", dns]
        if cfg.get("work_dir"):
            argv += ["-w", cfg["work_dir"]]
        if cfg.get("entrypoint"):
            argv += ["--entrypoint", cfg["entrypoint"]]
        for k, v in env.items():
            argv += ["-e", f"{k}={v}"]
        for vol in cfg.get("volumes", []):
            argv += ["-v", vol]
        for port in cfg.get("ports", []):
            argv += ["-p", str(port)]
        # port_map {label: container_port}: bind the scheduler-allocated
        # host port (from the task env) to the container port (ref
        # drivers/docker port mapping off AllocatedPorts)
        for label, cport in (cfg.get("port_map", {}) or {}).items():
            hp = env.get(f"NOMAD_HOST_PORT_{label}") or \
                env.get(f"NOMAD_PORT_{label}")
            if hp:
                argv += ["-p", f"{hp}:{cport}"]
        argv.append(image)
        command = cfg.get("command", "")
        if command:
            argv.append(command)
            args = cfg.get("args", [])
            if isinstance(args, str):
                args = shlex.split(args)
            argv += list(args)
        try:
            out = self._docker(*argv, timeout=120.0)
        except Exception:
            # a hung daemon (TimeoutExpired/OSError) must still drop the
            # image reference or the refcount never reaches zero
            self.coordinator.release(image, task_id)
            raise
        if out.returncode != 0:
            self.coordinator.release(image, task_id)
            raise RuntimeError(
                f"docker run failed: {out.stderr.decode(errors='replace')}")
        container_id = out.stdout.decode().strip()
        self._containers[task_id] = {
            "id": container_id, "name": cname, "task_dir": task_dir,
            "task_name": task.name, "image": image,
        }
        return TaskHandle(task_id=task_id, driver=self.name,
                          config={"container_id": container_id,
                                  "name": cname, "image": image},
                          started_at=time.time())

    def wait_task(self, task_id, timeout=None):
        rec = self._containers.get(task_id)
        if rec is None:
            return ExitResult(err="unknown task")
        try:
            out = self._docker("wait", rec["id"],
                               timeout=timeout if timeout else 86400.0)
        except subprocess.TimeoutExpired:
            return None
        if out.returncode != 0:
            return ExitResult(err=out.stderr.decode(errors="replace"))
        self._collect_logs(rec)
        try:
            return ExitResult(exit_code=int(out.stdout.decode().strip()))
        except ValueError:
            return ExitResult(err="unparseable docker wait output")

    def _collect_logs(self, rec: dict) -> None:
        out = self._docker("logs", rec["id"])
        try:
            base = os.path.join(rec["task_dir"], rec["task_name"])
            # docker log capture: loss-tolerant stream data,
            # re-fetchable from the daemon
            # nomadlint: disable=DUR001 — loss-tolerant log stream
            with open(f"{base}.stdout.log", "ab") as f:
                f.write(out.stdout)
            # nomadlint: disable=DUR001 — docker log capture, see above
            with open(f"{base}.stderr.log", "ab") as f:
                f.write(out.stderr)
        except OSError:
            pass

    def stop_task(self, task_id, kill_timeout=5.0, sig=""):
        rec = self._containers.get(task_id)
        if rec is None:
            return
        self._docker("stop", "-t", str(int(kill_timeout)), rec["id"],
                     timeout=kill_timeout + 30.0)

    def destroy_task(self, task_id):
        rec = self._containers.pop(task_id, None)
        if rec is not None:
            self._docker("rm", "-f", rec["id"])
            if rec.get("image"):
                self.coordinator.release(rec["image"], task_id)

    def exec_task(self, task_id, command, tty: bool = False, cwd: str = "",
                  env=None):
        """`docker exec` session (ref drivers/docker ExecTaskStreaming)."""
        from .driver import ExecSession
        rec = self._containers.get(task_id)
        if rec is None:
            raise ValueError("unknown task")
        argv = [self.docker_bin, "exec", "-i"]
        if tty:
            argv.append("-t")
        if cwd:
            argv += ["-w", cwd]
        for k, v in (env or {}).items():
            argv += ["-e", f"{k}={v}"]
        argv.append(rec["id"])
        argv += list(command or [])
        return ExecSession(argv, cwd=os.getcwd(), env=dict(os.environ),
                           tty=tty)

    def signal_task(self, task_id, sig):
        rec = self._containers.get(task_id)
        if rec is None:
            raise ValueError("unknown task")
        out = self._docker("kill", "--signal", sig, rec["id"])
        if out.returncode != 0:
            raise ValueError(out.stderr.decode(errors="replace"))

    def task_stats(self, task_id):
        rec = self._containers.get(task_id)
        if rec is None:
            return {"cpu_percent": 0.0, "memory_rss_bytes": 0}
        out = self._docker("stats", "--no-stream", "--format",
                           "{{.CPUPerc}} {{.MemUsage}}", rec["id"])
        try:
            cpu, mem = out.stdout.decode().split()[:2]
            return {"cpu_percent": float(cpu.rstrip("%")),
                    "memory_rss_bytes": _parse_size(mem)}
        except (ValueError, IndexError):
            return {"cpu_percent": 0.0, "memory_rss_bytes": 0}

    def inspect_task(self, task_id):
        rec = self._containers.get(task_id)
        if rec is None:
            return None
        return TaskHandle(task_id=task_id, driver=self.name,
                          config={"container_id": rec["id"]})

    def recover_task(self, handle):
        cid = handle.config.get("container_id", "")
        if not cid:
            return False
        out = self._docker("inspect", "--format", "{{.State.Running}}", cid)
        if out.returncode != 0 or b"true" not in out.stdout:
            return False
        self._containers[handle.task_id] = {
            "id": cid, "name": handle.config.get("name", ""),
            "task_dir": "", "task_name": "",
            "image": handle.config.get("image", "")}
        return True


def _parse_size(s: str) -> int:
    """'12.5MiB' -> bytes"""
    units = {"B": 1, "KiB": 1 << 10, "MiB": 1 << 20, "GiB": 1 << 30,
             "kB": 1000, "MB": 1000**2, "GB": 1000**3}
    for unit, mult in sorted(units.items(), key=lambda kv: -len(kv[0])):
        if s.endswith(unit):
            try:
                return int(float(s[:-len(unit)]) * mult)
            except ValueError:
                return 0
    return 0
