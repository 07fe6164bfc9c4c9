"""Native service catalog + health checking: the Consul integration
redesigned as a built-in subsystem (ref nomad/consul.go +
command/agent/consul/service_client.go registration lifecycle and check
watching; the catalog itself is state-store-backed like the native service
discovery the reference line later added).

Registrations are raft-replicated rows keyed (namespace, service, alloc);
clients register/deregister through Service RPCs and run their checks
locally, pushing status transitions the same way Consul agents do.
"""
from __future__ import annotations

import dataclasses
import http.client
import socket
import threading
import urllib.parse
from typing import Callable, Optional

CHECK_PASSING = "passing"
CHECK_CRITICAL = "critical"

INTENTION_ALLOW = "allow"
INTENTION_DENY = "deny"


@dataclasses.dataclass
class ServiceIntention:
    """Mesh authorization rule (ref Consul intentions, consumed by the
    connect admission in the reference): may `source` open connections to
    `destination` through the sidecar data plane? "*" wildcards match any
    service; exact entries outrank wildcards (Consul's precedence)."""
    source: str = "*"
    destination: str = "*"
    action: str = INTENTION_ALLOW        # allow | deny
    namespace: str = "default"
    description: str = ""
    create_index: int = 0
    modify_index: int = 0

    def key(self) -> tuple[str, str, str]:
        return (self.namespace, self.source, self.destination)

    def copy(self) -> "ServiceIntention":
        return dataclasses.replace(self)


def intention_allowed(intentions, namespace: str, source: str,
                      destination: str) -> bool:
    """Most-specific-match decision (Consul precedence: exact/exact >
    exact/* > */exact > */*), default ALLOW with no matching rule."""
    best = None
    best_rank = -1
    for it in intentions:
        if it.namespace != namespace:
            continue
        if it.source not in ("*", source) or \
                it.destination not in ("*", destination):
            continue
        rank = (2 if it.source != "*" else 0) + \
               (1 if it.destination != "*" else 0)
        if rank > best_rank:
            best, best_rank = it, rank
    return best is None or best.action == INTENTION_ALLOW


@dataclasses.dataclass
class ServiceInstance:
    """One registered service instance (ref structs ServiceRegistration)."""
    service_name: str = ""
    namespace: str = "default"
    job_id: str = ""
    alloc_id: str = ""
    node_id: str = ""
    task: str = ""
    address: str = "127.0.0.1"
    port: int = 0
    tags: tuple = ()
    status: str = CHECK_PASSING
    create_index: int = 0
    modify_index: int = 0

    def key(self) -> tuple[str, str, str, str]:
        # task in the key: one alloc may expose the same service name from
        # several tasks (different ports) without rows clobbering each other
        return (self.namespace, self.service_name, self.alloc_id, self.task)

    def copy(self) -> "ServiceInstance":
        return dataclasses.replace(self)


def _ck(check: dict, key: str, default=""):
    """Check dicts arrive in snake_case (API/tests) or PascalCase (the
    HCL parser emits the reference's wire shape); read both."""
    v = check.get(key)
    if v is None:
        v = check.get(key[:1].upper() + key[1:])
    return default if v in (None, "") else v


def check_service(check: dict, address: str, port: int,
                  timeout: float = 3.0) -> bool:
    """Execute one health check definition (ref command/agent/consul
    check types: http/tcp). A check carrying its own resolved ``port``
    (expose listeners) probes that instead of the instance port."""
    port = int(_ck(check, "port", 0) or port)
    ctype = str(_ck(check, "type", "tcp")).lower()
    if ctype == "tcp":
        try:
            with socket.create_connection((address, port), timeout=timeout):
                return True
        except OSError:
            return False
    if ctype == "http":
        path = _ck(check, "path", "/")
        try:
            conn = http.client.HTTPConnection(address, port, timeout=timeout)
            conn.request(_ck(check, "method", "GET"), path)
            resp = conn.getresponse()
            resp.read()
            conn.close()
            return 200 <= resp.status < 400
        except (OSError, http.client.HTTPException):
            return False
    if ctype == "script":
        import shlex
        import subprocess
        try:
            return subprocess.run(
                shlex.split(_ck(check, "command", "/bin/true")),
                timeout=timeout, capture_output=True).returncode == 0
        except (OSError, ValueError, subprocess.TimeoutExpired):
            return False
    return True  # unknown check types pass (like a TTL check never set)


class CheckRunner:
    """Periodic check execution for one service instance; pushes status
    transitions through the provided callback (ref consul check_watcher)."""

    def __init__(self, instance: ServiceInstance, checks: list[dict],
                 on_status: Callable[[ServiceInstance, str], None],
                 interval: float = 5.0):
        self.instance = instance
        self.checks = checks
        self.on_status = on_status
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.status = CHECK_PASSING

    def start(self) -> None:
        if not self.checks:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"check-{self.instance.service_name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def run_once(self) -> str:
        ok = all(check_service(c, self.instance.address,
                               self.instance.port) for c in self.checks)
        status = CHECK_PASSING if ok else CHECK_CRITICAL
        if status != self.status:
            self.status = status
            self.on_status(self.instance, status)
        return status

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.run_once()
            except Exception:   # noqa: BLE001 — checks must never die
                pass
