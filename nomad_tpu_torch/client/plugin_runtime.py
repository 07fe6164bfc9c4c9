"""Plugin SDK: host a Driver or CSI plugin implementation as an external
plugin process (ref plugins/base/plugin.go Serve + plugins/drivers and
plugins/csi gRPC servers).

A third-party driver is a Python script:

    from nomad_tpu.client.driver import Driver
    from nomad_tpu.client.plugin_runtime import serve_driver

    class MyDriver(Driver):
        name = "my-driver"
        ...

    if __name__ == "__main__":
        serve_driver(MyDriver())

A CSI plugin is the same shape around serve_csi(MyCSIPlugin()). The host
(client agent) launches the executable, reads the handshake line, and
proxies the in-process interface over the unix socket (see
plugin_host.py for the frame protocol)."""
from __future__ import annotations

import os
import socket
import sys
import tempfile
import threading

from .plugin_host import (
    HANDSHAKE_PREFIX, MAGIC_ENV, MAGIC_VALUE, SUPPORTED_PROTOCOLS,
    _recv_frame, _send_frame,
)


def _serve(info: dict, dispatch) -> None:
    """Common plugin server: magic-cookie gate, socket bind, handshake
    announce, then framed RPC until the host sends Shutdown.
    `dispatch(method, params)` returns the result or raises."""
    if os.environ.get(MAGIC_ENV) != MAGIC_VALUE:
        print("This binary is a nomad_tpu plugin and must be launched "
              "by the client agent, not run directly.", file=sys.stderr)
        sys.exit(1)

    sock_path = os.path.join(
        tempfile.mkdtemp(prefix="nomad-plugin-"), "plugin.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(4)
    versions = ",".join(str(v) for v in SUPPORTED_PROTOCOLS)
    print(f"{HANDSHAKE_PREFIX}{versions}|{sock_path}", flush=True)

    stop = threading.Event()

    def handle(conn: socket.socket) -> None:
        while not stop.is_set():
            try:
                req = _recv_frame(conn)
            except (OSError, ValueError):
                return
            if req is None:
                return
            rid = req.get("id")
            method = req.get("method", "")
            params = req.get("params", {}) or {}
            try:
                if method == "PluginInfo":
                    result = dict(info,
                                  protocols=list(SUPPORTED_PROTOCOLS))
                elif method == "Shutdown":
                    result = {}
                    stop.set()
                else:
                    result = dispatch(method, params)
                _send_frame(conn, {"id": rid, "result": result})
            except Exception as e:      # noqa: BLE001 - report, keep serving
                _send_frame(conn, {"id": rid, "error": str(e),
                                   "kind": type(e).__name__})
        try:
            conn.close()
        except OSError:
            pass

    while not stop.is_set():
        try:
            srv.settimeout(0.5)
            conn, _ = srv.accept()
        except socket.timeout:
            continue
        except OSError:
            break
        threading.Thread(target=handle, args=(conn,), daemon=True).start()
    srv.close()


def serve_driver(driver, version: str = "0.1.0") -> None:
    """Blocking: announce the handshake and serve driver RPCs until the
    host disconnects or sends Shutdown."""
    # exec sessions are process-global: the host may open a session on
    # one connection and poll it from another (ref the reference's
    # per-stream gRPC exec living beside unary task RPCs)
    sessions: dict[str, object] = {}
    sessions_lock = threading.Lock()

    def dispatch(method: str, params: dict):
        from ..api_codec import from_api
        from ..structs.job import Task
        if method == "Fingerprint":
            fp = driver.fingerprint()
            return {"detected": fp.detected, "healthy": fp.healthy,
                    "attributes": dict(fp.attributes)}
        if method == "StartTask":
            task = from_api(Task, params["task"])
            h = driver.start_task(params["task_id"], task,
                                  params["task_dir"],
                                  params.get("env", {}))
            return {"pid": h.pid, "started_at": h.started_at}
        if method == "WaitTask":
            r = driver.wait_task(params["task_id"], params.get("timeout"))
            return None if r is None else {
                "exit_code": r.exit_code, "signal": r.signal,
                "err": r.err}
        if method == "StopTask":
            driver.stop_task(params["task_id"],
                             params.get("kill_timeout", 5.0),
                             params.get("sig", ""))
            return {}
        if method == "DestroyTask":
            driver.destroy_task(params["task_id"])
            return {}
        if method == "SignalTask":
            driver.signal_task(params["task_id"], params["sig"])
            return {}
        if method == "TaskStats":
            return driver.task_stats(params["task_id"])
        if method == "InspectTask":
            h = driver.inspect_task(params["task_id"])
            return None if h is None else {"pid": h.pid}
        if method == "RecoverTask":
            from .driver import TaskHandle
            return driver.recover_task(TaskHandle(
                task_id=params["task_id"], driver=driver.name,
                pid=int(params.get("pid", 0))))
        if method == "ExecOpen":
            # streaming exec across the plugin boundary (ref
            # plugins/drivers/driver.go:577 ExecTaskStreamingRaw)
            import uuid
            sess = driver.exec_task(
                params["task_id"], params.get("command") or [],
                tty=bool(params.get("tty")),
                cwd=params.get("cwd", ""),
                env=params.get("env") or {})
            sid = uuid.uuid4().hex
            with sessions_lock:
                sessions[sid] = sess
            return {"session": sid}
        if method in ("ExecIO", "ExecResize", "ExecClose"):
            import base64
            with sessions_lock:
                sess = sessions.get(params["session"])
            if sess is None:
                raise ValueError("unknown exec session")
            if method == "ExecResize":
                sess.resize(int(params.get("rows", 24)),
                            int(params.get("cols", 80)))
                return {}
            if method == "ExecClose":
                with sessions_lock:
                    sessions.pop(params["session"], None)
                sess.terminate()
                return {}
            if params.get("stdin"):
                sess.write_stdin(base64.b64decode(params["stdin"]))
            if params.get("close_stdin"):
                sess.close_stdin()
            out = sess.read_output(float(params.get("wait", 0.0)))
            return {"stdout": base64.b64encode(out["stdout"]).decode(),
                    "stderr": base64.b64encode(out["stderr"]).decode(),
                    "exited": out["exited"],
                    "exit_code": out["exit_code"]}
        raise ValueError(f"unknown plugin method {method!r}")

    _serve({"type": "driver", "name": driver.name, "version": version},
           dispatch)


def serve_csi(plugin, version: str = "0.1.0") -> None:
    """Blocking: serve a CSIPluginClient implementation as an external
    CSI plugin process (ref plugins/csi/client.go — the reference's CSI
    drivers are separate gRPC processes; this is that boundary)."""

    def dispatch(method: str, params: dict):
        if method == "Fingerprint":
            return plugin.fingerprint()
        if method == "NodeStageVolume":
            plugin.node_stage_volume(params["volume_id"],
                                     params.get("context") or {})
            return {}
        if method == "NodePublishVolume":
            plugin.node_publish_volume(
                params["volume_id"], params["target_path"],
                bool(params.get("readonly")),
                params.get("context") or {})
            return {}
        if method == "NodeUnpublishVolume":
            plugin.node_unpublish_volume(params["volume_id"],
                                         params["target_path"])
            return {}
        if method == "ControllerUnpublishVolume":
            plugin.controller_unpublish_volume(params["volume_id"],
                                               params["node_id"])
            return {}
        raise ValueError(f"unknown plugin method {method!r}")

    _serve({"type": "csi", "name": plugin.name, "version": version,
            "requires_controller": bool(
                getattr(plugin, "requires_controller", False))},
           dispatch)
