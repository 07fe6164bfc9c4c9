"""Service-mesh analog: Connect sidecar injection + the proxy itself
(ref nomad/job_endpoint_hooks.go jobConnectHook — admission-time sidecar
task/port injection — and client/allocrunner/taskrunner/
envoy_bootstrap_hook.go; the envoy data plane is replaced by an in-process
TCP proxy driver, the framework-native equivalent).

Mesh wiring:
  * every `connect.sidecar_service` service gets a dynamic ingress port
    and a `connect-proxy-<service>` prestart-sidecar task; the service is
    REGISTERED at the proxy's ingress port, so mesh traffic always enters
    through the sidecar (ingress -> 127.0.0.1:<service port>);
  * each declared upstream gets a local listener in the downstream's
    sidecar (127.0.0.1:<local_bind_port> -> a healthy catalog instance of
    the destination, which is itself that instance's sidecar ingress);
    tasks find it via NOMAD_UPSTREAM_ADDR_<dest> env, like the reference.
"""
from __future__ import annotations

import socket
import threading
import time

from ..structs import (
    NetworkResource, Port, Resources, Task, TaskLifecycle,
)

PROXY_PREFIX = "connect-proxy-"


def _sanitize(name: str) -> str:
    return name.replace("-", "_").upper()


def _expose_admission(svc, net) -> list[dict]:
    """Expose-check mutator (ref nomad/job_endpoint_hook_expose_check.go:21
    jobExposeCheckHook): an http/grpc check with ``expose = true`` on a
    connect service gets its own dynamic listener port on the sidecar —
    the proxy serves ONLY that check's path there — and the check is
    rewritten to probe through the proxy listener instead of the (mesh-
    private) service port. Returns the proxy task's expose listener
    config. Idempotent: an already-rewritten check is left alone."""
    out: list[dict] = []
    local_label = svc.port_label        # the service's REAL port, pre-
    for i, chk in enumerate(svc.checks):    # ingress rewrite
        if not (chk.get("expose") or chk.get("Expose")):
            continue
        ctype = (chk.get("type") or chk.get("Type") or "").lower()
        if ctype not in ("http", "grpc"):
            continue                    # ref: only http/grpc are exposable
        existing_label = chk.get("port_label") or chk.get("PortLabel") \
            or ""
        if existing_label.startswith("svc_expose_check_"):
            label = existing_label      # re-registration of expanded job
        else:
            label = f"svc_expose_check_{svc.name}_{i}"
            # both shapes: HCL-parsed checks are PascalCase, API/test
            # dicts snake_case
            chk["port_label"] = chk["PortLabel"] = label
        if not any(p.label == label for p in net.dynamic_ports):
            net.dynamic_ports.append(Port(label=label))
        out.append({"path": chk.get("path") or chk.get("Path") or "/",
                    "listener_port_label": label,
                    "local_path_port_label": local_label})
    return out


def connect_admission(job) -> None:
    """Admission mutator (ref job_endpoint_hooks.go:1): expand
    sidecar_service stanzas into proxy tasks + ports + upstream env.
    Idempotent — re-registering an already-expanded job injects nothing."""
    for tg in job.task_groups:
        sidecars = [s for s in tg.services
                    if s.connect and s.connect.get("SidecarService")
                    is not None]
        if not sidecars:
            continue
        existing = {t.name for t in tg.tasks}
        if tg.networks:
            net = tg.networks[0]
        else:
            net = NetworkResource()
            tg.networks.append(net)
        upstream_env: dict[str, str] = {}
        for svc in sidecars:
            proxy_task = PROXY_PREFIX + svc.name
            port_label = proxy_task
            sc = svc.connect["SidecarService"]
            upstreams = (sc.get("Proxy") or {}).get("Upstreams") or []
            for up in upstreams:
                upstream_env[
                    f"NOMAD_UPSTREAM_ADDR_{_sanitize(up['DestinationName'])}"
                ] = f"127.0.0.1:{up['LocalBindPort']}"
            if proxy_task in existing:
                continue            # already expanded (job re-register)
            expose = _expose_admission(svc, net)
            if not any(p.label == port_label for p in net.dynamic_ports):
                net.dynamic_ports.append(Port(label=port_label))
            tg.tasks.append(Task(
                name=proxy_task,
                driver="connect_proxy",
                lifecycle=TaskLifecycle(hook="prestart", sidecar=True),
                config={
                    "service": svc.name,
                    "namespace": job.namespace,
                    "ingress_port_label": port_label,
                    "local_service_port_label": svc.port_label,
                    "upstreams": [
                        {"destination": up["DestinationName"],
                         "local_bind_port": int(up["LocalBindPort"])}
                        for up in upstreams],
                    "expose": expose,
                },
                resources=Resources(cpu=50, memory_mb=32),
            ))
            # the mesh entry point IS the proxy: register the service at
            # the ingress port (ref job_endpoint_hooks: sidecar service
            # port rewrite)
            svc.port_label = port_label
        if upstream_env:
            for task in tg.tasks:
                if task.name.startswith(PROXY_PREFIX):
                    continue
                for k, v in upstream_env.items():
                    task.env.setdefault(k, v)


class _Forwarder(threading.Thread):
    """One listener: accept -> resolve target -> bidirectional splice."""

    def __init__(self, bind: tuple, resolve, logger, name: str):
        super().__init__(daemon=True, name=name)
        self.bind = bind
        self.resolve = resolve              # () -> (host, port) or None
        self.logger = logger
        self._stop = threading.Event()
        self.sock: socket.socket | None = None
        self.connections = 0

    def run(self) -> None:
        # bind with retry: a dying alloc's proxy (or any process on a
        # recycled dynamic port) may hold the address for a moment at
        # start — giving up permanently would leave the sidecar deaf for
        # the alloc's whole life
        srv = None
        warned = False
        while not self._stop.is_set():
            try:
                srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                srv.bind(self.bind)
                srv.listen(16)
                srv.settimeout(0.5)
                self.sock = srv
                break
            except OSError as e:
                if srv is not None:     # socket() itself may have raised
                    try:
                        srv.close()
                    except OSError:
                        pass
                srv = None
                if not warned:
                    self.logger(f"connect-proxy: bind {self.bind} failed "
                                f"({e!r}); retrying")
                    warned = True
                if self._stop.wait(1.0):
                    return
        if srv is None:
            return
        while not self._stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            target = self.resolve()
            if target is None:
                conn.close()
                continue
            self.connections += 1
            threading.Thread(target=self._splice, args=(conn, target),
                             daemon=True).start()
        try:
            srv.close()
        except OSError:
            pass

    def _splice(self, conn: socket.socket, target: tuple,
                preamble: bytes = b"") -> None:
        try:
            out = socket.create_connection(target, timeout=5.0)
            # the connect timeout must not become a 5s idle-read timeout
            # on the spliced stream
            out.settimeout(None)
            if preamble:
                out.sendall(preamble)   # bytes a screening subclass read
        except OSError as e:
            self.logger(f"connect-proxy: dial {target} failed: {e!r}")
            conn.close()
            return

        def pump(a, b):
            try:
                while True:
                    data = a.recv(65536)
                    if not data:
                        break
                    b.sendall(data)
            except OSError:
                pass
            finally:
                # asymmetric half-close: EOF from `a` ends only OUR write
                # direction on `b` — the reverse pump may still be
                # streaming a response (nc -q0 style half-close clients)
                try:
                    b.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
        t = threading.Thread(target=pump, args=(out, conn), daemon=True)
        t.start()
        pump(conn, out)
        # close only after BOTH directions finished: the reverse pump may
        # stream a long response after the client's half-close, and each
        # pump terminates on EOF/error by itself (no read timeouts)
        t.join()
        for s in (conn, out):
            try:
                s.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()


class ExposeForwarder(_Forwarder):
    """Expose-path listener (ref envoy's exposed path listeners, driven
    by job_endpoint_hook_expose_check.go): serves ONLY the configured
    HTTP path (exact, subpath, or query) and answers 403 to anything
    else — external health checkers get the check endpoint through the
    sidecar without the rest of the service leaking around the mesh."""

    def __init__(self, bind: tuple, resolve, logger, name: str,
                 path: str):
        super().__init__(bind, resolve, logger, name)
        self.path = path or "/"

    def _path_allowed(self, req_path: str) -> bool:
        base = self.path.rstrip("/") or "/"
        return (req_path == self.path or req_path == base
                or req_path.startswith(base + "/")
                or req_path.startswith(base + "?"))

    def _splice(self, conn: socket.socket, target: tuple,
                preamble: bytes = b"") -> None:
        # One screened request per connection: the FULL first request
        # (headers + declared body) is read, stamped `connection: close`,
        # and forwarded alone; the client half is never spliced raw, so
        # keep-alive or pipelined follow-ups can never ride a screened
        # connection past the path filter.
        try:
            conn.settimeout(3.0)
            buf = b""
            while b"\r\n\r\n" not in buf and len(buf) < 65536:
                chunk = conn.recv(8192)
                if not chunk:
                    break
                buf += chunk
            head, _, rest = buf.partition(b"\r\n\r\n")
            line = head.split(b"\r\n", 1)[0].decode("latin-1", "replace")
            parts = line.split()
            req_path = parts[1] if len(parts) >= 2 else ""
            if not self._path_allowed(req_path):
                conn.sendall(b"HTTP/1.1 403 Forbidden\r\n"
                             b"content-length: 0\r\n"
                             b"connection: close\r\n\r\n")
                conn.close()
                return
            clen = 0
            keep: list[bytes] = []
            for h in head.split(b"\r\n")[1:]:
                name = h.split(b":", 1)[0].strip().lower()
                if name == b"content-length":
                    try:
                        clen = int(h.split(b":", 1)[1])
                    except ValueError:
                        clen = 0
                if name != b"connection":
                    keep.append(h)
            body = rest[:clen]
            while len(body) < clen:
                chunk = conn.recv(min(65536, clen - len(body)))
                if not chunk:
                    break
                body += chunk
            request = (head.split(b"\r\n", 1)[0] + b"\r\n"
                       + b"\r\n".join(keep)
                       + (b"\r\n" if keep else b"")
                       + b"connection: close\r\n\r\n" + body)
        except OSError:
            try:
                conn.close()
            except OSError:
                pass
            return
        try:
            out = socket.create_connection(target, timeout=5.0)
            out.settimeout(None)
            out.sendall(request)
            out.shutdown(socket.SHUT_WR)
        except OSError as e:
            self.logger(f"connect-expose: dial {target} failed: {e!r}")
            conn.close()
            return
        try:
            while True:                 # response only: backend -> client
                data = out.recv(65536)
                if not data:
                    break
                conn.sendall(data)
        except OSError:
            pass
        for s in (conn, out):
            try:
                s.close()
            except OSError:
                pass
