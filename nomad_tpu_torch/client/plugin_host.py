"""Out-of-process driver plugin fabric (ref plugins/base/proto/base.proto,
hashicorp/go-plugin): third-party task drivers run as SEPARATE PROCESSES
speaking a socket RPC, so a crashing or misbehaving driver cannot take the
client agent down, and drivers can be written/shipped independently.

Protocol (the go-plugin handshake, re-designed for a zero-dependency
stack):
  1. The host launches the plugin executable with NOMAD_TPU_PLUGIN_MAGIC
     in its environment (plugins refuse to run standalone without it, ref
     go-plugin's magic cookie).
  2. The plugin binds a unix socket and prints ONE handshake line on
     stdout: ``NOMAD_TPU_PLUGIN|<proto-versions>|<socket-path>`` where
     proto-versions is a comma list of protocol versions it speaks.
  3. The host picks the highest common version (negotiation, ref
     base.proto NegotiatedVersion) and connects.
  4. RPC: length-prefixed JSON frames {"id", "method", "params"} ->
     {"id", "result"} | {"id", "error"}. Driver structs cross the wire in
     API shape (api_codec), exactly like the reference's protobuf DTOs.
  5. PluginInfo / Fingerprint / the DriverPlugin method family dispatch
     to the plugin author's Driver subclass (plugin_runtime.serve_driver).

The host wraps each plugin in ExternalDriver, which implements the same
in-process Driver interface the schedulers already use — callers cannot
tell a subprocess driver from a built-in.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import subprocess
import threading
import time
from typing import Optional

from ..structs import DriverInfo
from .driver import Driver, ExitResult, TaskHandle

MAGIC_ENV = "NOMAD_TPU_PLUGIN_MAGIC"
MAGIC_VALUE = "nomad-tpu-driver-plugin-v1"
HANDSHAKE_PREFIX = "NOMAD_TPU_PLUGIN|"
SUPPORTED_PROTOCOLS = (1,)


class PluginError(Exception):
    pass


def _send_frame(sock: socket.socket, obj: dict) -> None:
    raw = json.dumps(obj, separators=(",", ":")).encode()
    sock.sendall(struct.pack(">I", len(raw)) + raw)


def _recv_frame(sock: socket.socket) -> Optional[dict]:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = struct.unpack(">I", hdr)
    if n > 64 * 1024 * 1024:
        raise PluginError(f"oversized plugin frame ({n} bytes)")
    raw = b""
    while len(raw) < n:
        chunk = sock.recv(n - len(raw))
        if not chunk:
            return None
        raw += chunk
    return json.loads(raw.decode())


class PluginProcess:
    """One plugin subprocess + its socket transport: launch, handshake,
    version negotiation, framed RPC. Typed wrappers (ExternalDriver,
    ExternalCSIPlugin) overlay the in-process interface on `_call`.
    `plugin_type` pins the expected PluginInfo type; None accepts any
    (generic discovery probes, which adopt() into a typed wrapper)."""

    plugin_type: Optional[str] = None

    def __init__(self, command: list[str], logger=None,
                 start_timeout: float = 10.0):
        self.command = list(command)
        self.logger = logger or (lambda msg: None)
        self.start_timeout = start_timeout
        self._lock = threading.Lock()
        self._relaunch_lock = threading.Lock()
        self._seq = 0
        self.proc: Optional[subprocess.Popen] = None
        self._sock: Optional[socket.socket] = None
        self.protocol_version = 0
        self.info: dict = {}
        self.name = os.path.basename(command[0])
        self._launch()

    @classmethod
    def adopt(cls, probe: "PluginProcess") -> "PluginProcess":
        """Rebind a generically-probed live process under a typed
        wrapper (the wrappers add no launch-time state of their own)."""
        if cls.plugin_type and probe.info.get("type") != cls.plugin_type:
            raise PluginError(
                f"plugin {probe.name!r} is {probe.info.get('type')!r}, "
                f"not {cls.plugin_type!r}")
        obj = object.__new__(cls)
        obj.__dict__.update(probe.__dict__)
        return obj

    # ----------------------------------------------------------- lifecycle

    def _launch(self) -> None:
        env = dict(os.environ)
        env[MAGIC_ENV] = MAGIC_VALUE
        self.proc = subprocess.Popen(
            self.command, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, start_new_session=True)
        # ANY failure below must reap the subprocess — discover_plugins
        # logs and continues, and an orphaned plugin would outlive the
        # agent otherwise
        try:
            line = self._read_handshake()
            if not line.startswith(HANDSHAKE_PREFIX):
                raise PluginError(f"bad plugin handshake: {line!r}")
            try:
                _, versions, sock_path = line.split("|", 2)
                offered = {int(v) for v in versions.split(",") if v}
            except ValueError as e:
                raise PluginError(f"malformed handshake {line!r}") from e
            common = offered & set(SUPPORTED_PROTOCOLS)
            if not common:
                raise PluginError(
                    f"no common protocol version (plugin offers "
                    f"{sorted(offered)}, host speaks "
                    f"{list(SUPPORTED_PROTOCOLS)})")
            self.protocol_version = max(common)
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(30.0)
            self._sock.connect(sock_path)
            self.sock_path = sock_path
            # PluginInfo exchange (ref base.proto PluginInfo)
            self.info = self._call("PluginInfo")
            if self.plugin_type and \
                    self.info.get("type") != self.plugin_type:
                raise PluginError(
                    f"not a {self.plugin_type} plugin: {self.info}")
            self.name = self.info.get("name", self.name)
        except BaseException:
            self.shutdown()
            raise

    def _read_handshake(self) -> str:
        """One stdout line within start_timeout: select-bounded so a
        silent-but-alive executable can't hang the agent, and process
        death (EOF) fails fast instead of spinning."""
        import select
        fd = self.proc.stdout
        buf = b""
        deadline = time.monotonic() + self.start_timeout
        while time.monotonic() < deadline:
            ready, _, _ = select.select([fd], [], [],
                                        max(0.05, deadline -
                                            time.monotonic()))
            if not ready:
                continue
            chunk = os.read(fd.fileno(), 4096)
            if not chunk:
                raise PluginError("plugin exited before handshake")
            buf += chunk
            if b"\n" in buf:
                return buf.split(b"\n", 1)[0].decode(errors="replace").strip()
        raise PluginError(
            f"no handshake within {self.start_timeout}s")

    def shutdown(self) -> None:
        if self._sock is not None:
            try:
                self._call("Shutdown")
            # polite-shutdown RPC to a possibly-dead plugin; terminate()
            # below is the enforcement path either way
            except Exception:  # nomadlint: disable=EXC001 — best-effort RPC
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=3)
            except subprocess.TimeoutExpired:
                self.proc.kill()

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    # ----------------------------------------------------------- transport

    def _call(self, method: str, **params):
        with self._lock:
            if self._sock is None:
                raise PluginError(f"plugin {self.name!r} not connected")
            self._seq += 1
            seq = self._seq
            try:
                _send_frame(self._sock, {"id": seq, "method": method,
                                         "params": params})
                # drain until OUR reply: a stale frame (from an earlier
                # timed-out call) must not be mis-delivered
                while True:
                    resp = _recv_frame(self._sock)
                    if resp is None or resp.get("id") == seq:
                        break
            except (socket.timeout, TimeoutError) as e:
                # the stream is now desynchronized (our reply may arrive
                # later): drop the connection rather than misattribute it
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                raise PluginError(
                    f"plugin {self.name!r} rpc {method} timed out") from e
        if resp is None:
            raise PluginError(f"plugin {self.name!r} closed the connection")
        if resp.get("error"):
            kind = resp.get("kind", "")
            if kind == "ValueError":
                raise ValueError(resp["error"])
            raise PluginError(resp["error"])
        return resp.get("result")


class ExternalDriver(PluginProcess, Driver):
    """Host-side proxy for one DRIVER plugin process: the in-process
    Driver interface implemented by socket RPC to the subprocess."""

    plugin_type = "driver"

    # ------------------------------------------------------ Driver surface

    def fingerprint(self) -> DriverInfo:
        try:
            out = self._call("Fingerprint")
            return DriverInfo(detected=bool(out.get("detected")),
                              healthy=bool(out.get("healthy")),
                              attributes=dict(out.get("attributes", {})))
        except Exception:               # noqa: BLE001 - dead plugin
            return DriverInfo(detected=False, healthy=False)

    def start_task(self, task_id, task, task_dir, env) -> TaskHandle:
        from ..api_codec import to_api
        out = self._call("StartTask", task_id=task_id, task=to_api(task),
                         task_dir=task_dir, env=dict(env))
        return TaskHandle(
            task_id=task_id, driver=self.name,
            pid=int(out.get("pid", 0)),
            started_at=float(out.get("started_at", time.time())))

    def wait_task(self, task_id, timeout=None) -> Optional[ExitResult]:
        out = self._call("WaitTask", task_id=task_id, timeout=timeout)
        if out is None:
            return None
        return ExitResult(exit_code=int(out.get("exit_code", 0)),
                          signal=int(out.get("signal", 0)),
                          err=out.get("err", ""))

    def stop_task(self, task_id, kill_timeout=5.0, sig="") -> None:
        self._call("StopTask", task_id=task_id, kill_timeout=kill_timeout,
                   sig=sig)

    def destroy_task(self, task_id) -> None:
        try:
            self._call("DestroyTask", task_id=task_id)
        except PluginError:
            pass

    def signal_task(self, task_id, sig) -> None:
        self._call("SignalTask", task_id=task_id, sig=sig)

    def task_stats(self, task_id) -> dict:
        return self._call("TaskStats", task_id=task_id) or {}

    def inspect_task(self, task_id) -> Optional[TaskHandle]:
        out = self._call("InspectTask", task_id=task_id)
        if out is None:
            return None
        return TaskHandle(task_id=task_id, driver=self.name,
                          pid=int(out.get("pid", 0)))

    def recover_task(self, handle: TaskHandle) -> bool:
        try:
            return bool(self._call("RecoverTask", task_id=handle.task_id,
                                   pid=handle.pid))
        except PluginError:
            return False

    def exec_task(self, task_id, command, tty: bool = False, cwd: str = "",
                  env=None):
        """Streaming exec proxied over the plugin socket (ref
        plugins/drivers/driver.go:577 ExecTaskStreamingRaw): ExecOpen
        mints a session in the plugin process; stdin/output/resize ride
        ExecIO/ExecResize round-trips."""
        out = self._call("ExecOpen", task_id=task_id,
                         command=list(command or []), tty=bool(tty),
                         cwd=cwd, env=dict(env or {}))
        return _RemoteExecSession(self, out["session"])


class _RemoteExecSession:
    """Host-side view of a plugin exec session, shaped like
    driver.ExecSession so the client HTTP exec endpoints can't tell a
    plugin task from a built-in one."""

    def __init__(self, drv: ExternalDriver, session_id: str):
        self._drv = drv
        self._sid = session_id
        self._out = bytearray()
        self._err = bytearray()
        self.exit_code: Optional[int] = None

    def _io(self, wait: float = 0.0, stdin: bytes = b"",
            close_stdin: bool = False) -> None:
        import base64
        r = self._drv._call(
            "ExecIO", session=self._sid, wait=wait,
            stdin=base64.b64encode(stdin).decode() if stdin else "",
            close_stdin=close_stdin) or {}
        self._out += base64.b64decode(r.get("stdout") or "")
        self._err += base64.b64decode(r.get("stderr") or "")
        if r.get("exited"):
            self.exit_code = r.get("exit_code")

    def write_stdin(self, data: bytes) -> None:
        self._io(stdin=data)

    def close_stdin(self) -> None:
        self._io(close_stdin=True)

    def resize(self, rows: int, cols: int) -> None:
        self._drv._call("ExecResize", session=self._sid, rows=rows,
                        cols=cols)

    def read_output(self, wait: float = 0.0) -> dict:
        # locally buffered chunks (from stdin round-trips) serve first;
        # otherwise poll the plugin, letting IT do the blocking wait
        if not self._out and not self._err and self.exit_code is None:
            self._io(wait=wait)
        out = {"stdout": bytes(self._out), "stderr": bytes(self._err),
               "exited": self.exit_code is not None,
               "exit_code": self.exit_code}
        self._out.clear()
        self._err.clear()
        return out

    def terminate(self) -> None:
        try:
            self._drv._call("ExecClose", session=self._sid)
        except PluginError:
            pass


class ExternalCSIPlugin(PluginProcess):
    """Host-side proxy for one CSI plugin process (ref
    plugins/csi/client.go, where CSI drivers are external gRPC
    processes — the entire point of CSI: third-party storage drivers
    ship independently of the orchestrator).

    Implements the CSIPluginClient contract (csimanager.py) over the
    plugin socket. A crashed plugin is RELAUNCHED on the next call: the
    claim state machine is pull-based and idempotent, so a detach that
    died mid-flight is simply retried against the fresh process."""

    plugin_type = "csi"

    @property
    def requires_controller(self) -> bool:
        return bool(self.info.get("requires_controller"))

    def _call_live(self, method: str, **params):
        """_call with crash recovery: relaunch a dead plugin process
        first (claims held by this node must survive plugin crashes —
        VERDICT r4 #2's recoverability requirement). A dedicated
        relaunch mutex (NOT self._lock — _launch itself RPCs through
        it) serializes concurrent recoverers, and the dead-check repeats
        inside it so the loser of the race adopts the winner's fresh
        process instead of spawning an orphaned second one."""
        with self._relaunch_lock:
            with self._lock:
                dead = self.proc is None or self.proc.poll() is not None \
                    or self._sock is None
            if dead:
                self.logger(f"csi: plugin {self.name!r} down; relaunching")
                try:
                    self.shutdown()
                # tearing down a process already observed dead; _launch
                # below raises loudly if the relaunch fails
                except Exception:  # nomadlint: disable=EXC001 — already dead
                    pass
                self._launch()
        return self._call(method, **params)

    # ------------------------------------------- CSIPluginClient surface

    def fingerprint(self) -> dict:
        try:
            return self._call_live("Fingerprint")
        except Exception:               # noqa: BLE001 — dead plugin
            return {"healthy": False, "provider": self.name,
                    "requires_controller": self.requires_controller}

    def node_stage_volume(self, volume_id: str, context: dict) -> None:
        self._call_live("NodeStageVolume", volume_id=volume_id,
                        context=dict(context or {}))

    def node_publish_volume(self, volume_id: str, target_path: str,
                            readonly: bool, context: dict) -> None:
        self._call_live("NodePublishVolume", volume_id=volume_id,
                        target_path=target_path, readonly=bool(readonly),
                        context=dict(context or {}))

    def node_unpublish_volume(self, volume_id: str,
                              target_path: str) -> None:
        self._call_live("NodeUnpublishVolume", volume_id=volume_id,
                        target_path=target_path)

    def controller_unpublish_volume(self, volume_id: str,
                                    node_id: str) -> None:
        self._call_live("ControllerUnpublishVolume", volume_id=volume_id,
                        node_id=node_id)


def discover_all(plugin_dir: str, logger=None) -> dict[str, dict]:
    """Launch every executable in plugin_dir and sort it by announced
    plugin type (ref client config plugin_dir + go-plugin Discover).
    Returns {"driver": {name: ExternalDriver},
             "csi": {name: ExternalCSIPlugin}}.
    Failures are logged and skipped — one bad plugin must not stop the
    client."""
    log = logger or (lambda msg: None)
    wrappers = {"driver": ExternalDriver, "csi": ExternalCSIPlugin}
    out: dict[str, dict] = {k: {} for k in wrappers}
    if not plugin_dir or not os.path.isdir(plugin_dir):
        return out
    for entry in sorted(os.listdir(plugin_dir)):
        path = os.path.join(plugin_dir, entry)
        if not os.path.isfile(path) or not os.access(path, os.X_OK):
            continue
        try:
            probe = PluginProcess([path], logger=log)
            ptype = probe.info.get("type", "")
            wrapper = wrappers.get(ptype)
            if wrapper is None:
                log(f"client: plugin {entry!r} announced unknown type "
                    f"{ptype!r}; skipping")
                probe.shutdown()
                continue
            plug = wrapper.adopt(probe)
            family = out[ptype]
            if plug.name in family:
                log(f"client: plugin {entry!r} duplicates {ptype} name "
                    f"{plug.name!r}; keeping the first")
                plug.shutdown()
                continue
            family[plug.name] = plug
            log(f"client: loaded external {ptype} plugin {plug.name!r} "
                f"(protocol v{plug.protocol_version})")
        except Exception as e:          # noqa: BLE001
            log(f"client: plugin {entry!r} failed to load: {e}")
    return out


def discover_plugins(plugin_dir: str, logger=None) -> dict[str, ExternalDriver]:
    """Driver-only view of discover_all (the original fabric surface)."""
    found = discover_all(plugin_dir, logger)
    for plug in found["csi"].values():      # not ours to keep here
        plug.shutdown()
    return found["driver"]
