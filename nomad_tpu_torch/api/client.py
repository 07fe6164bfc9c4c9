"""api.Client equivalent (ref api/api.go): one HTTP client + per-resource
typed handles. Addresses come from the argument or $NOMAD_ADDR; tokens from
the argument or $NOMAD_TOKEN (ref api/api.go DefaultConfig)."""
from __future__ import annotations

import dataclasses
import json
import os
import random
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Iterator, Optional


class APIError(Exception):
    def __init__(self, status: int, message: str,
                 retry_after_s: float = 0.0):
        super().__init__(f"{status}: {message}")
        self.status = status
        self.message = message
        # 429 responses carry the server's Retry-After hint (ISSUE 8);
        # 0.0 on every other status
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class QueryOptions:
    """ref api/api.go QueryOptions (+ AllowStale semantics, ISSUE 16)"""
    namespace: str = ""
    prefix: str = ""
    wait_index: int = 0
    wait_time_sec: float = 0.0
    # stale=False demands leader consistency (a follower redirects the
    # read to the leader); stale=True accepts whichever server answers,
    # served from its local replicated store. None keeps the server's
    # default (agent-local reads, stale on a follower by construction).
    stale: Optional[bool] = None
    # bound the staleness: serve only from a store that has applied at
    # least this index (block briefly / redirect to the leader otherwise)
    max_stale_index: int = 0
    # server-side stub-field projection for list endpoints (API field
    # names, e.g. ["ID", "Status"]); None returns full stubs
    fields: Optional[list[str]] = None
    # request the columnar struct-of-arrays list encoding; the client
    # decodes it back to rows transparently (wire-size win only)
    columnar: bool = False
    params: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class WriteOptions:
    namespace: str = ""


@dataclasses.dataclass
class QueryMeta:
    """ref api/api.go QueryMeta"""
    last_index: int = 0
    # False while an election is in flight: last_index may lag an
    # unreachable majority (X-Nomad-KnownLeader)
    known_leader: bool = True
    # True when a follower's local store served the read (X-Nomad-Stale)
    stale: bool = False


class Client:
    """ref api/api.go NewClient"""

    def __init__(self, address: str = "", token: str = "",
                 namespace: str = "", timeout: float = 65.0,
                 retry_429: int = 3, retry_budget_s: float = 15.0):
        self.address = (address or os.environ.get("NOMAD_ADDR")
                        or "http://127.0.0.1:4646").rstrip("/")
        self.token = token or os.environ.get("NOMAD_TOKEN", "")
        self.namespace = namespace or os.environ.get("NOMAD_NAMESPACE", "")
        self.timeout = timeout
        # 429 handling (ISSUE 8 satellite): honor Retry-After with
        # jittered backoff, at most `retry_429` retries and never more
        # than `retry_budget_s` total sleep per call — both knobs exist
        # so tests (and latency-sensitive callers) stay bounded;
        # retry_429=0 restores raise-immediately.
        self.retry_429 = max(0, int(retry_429))
        self.retry_budget_s = max(0.0, float(retry_budget_s))

        self.jobs = Jobs(self)
        self.allocations = Allocations(self)
        self.nodes = Nodes(self)
        self.evaluations = Evaluations(self)
        self.deployments = Deployments(self)
        self.namespaces = Namespaces(self)
        self.acl = ACL(self)
        self.operator = Operator(self)
        self.search = Search(self)
        self.scaling = Scaling(self)
        self.csi_volumes = CSIVolumes(self)
        self.csi_plugins = CSIPlugins(self)
        self.services = Services(self)
        self.system = System(self)
        self.agent = AgentAPI(self)
        self.client_api = ClientAPI(self)

    # ------------------------------------------------------------ transport

    def _url(self, path: str, q: Optional[QueryOptions] = None,
             extra: Optional[dict] = None) -> str:
        params = {}
        ns = (q.namespace if q and q.namespace else self.namespace)
        if ns:
            params["namespace"] = ns
        if q is not None:
            if q.prefix:
                params["prefix"] = q.prefix
            if q.wait_index:
                params["index"] = str(q.wait_index)
            if q.wait_time_sec:
                params["wait"] = f"{q.wait_time_sec}s"
            if q.stale is not None:
                params["stale"] = "true" if q.stale else "false"
            if q.max_stale_index:
                params["max_stale_index"] = str(q.max_stale_index)
            if q.fields:
                params["fields"] = ",".join(q.fields)
            if q.columnar:
                params["format"] = "columnar"
            params.update(q.params)
        params.update(extra or {})
        qs = urllib.parse.urlencode(params)
        return f"{self.address}{path}" + (f"?{qs}" if qs else "")

    def _do(self, method: str, url: str, body: Any = None,
            raw: bool = False) -> tuple[Any, QueryMeta]:
        data = None
        headers = {"Content-Type": "application/json"}
        if body is not None:
            data = body if isinstance(body, bytes) else \
                json.dumps(body).encode()
        if self.token:
            headers["X-Nomad-Token"] = self.token
        slept = 0.0
        for attempt in range(self.retry_429 + 1):
            req = urllib.request.Request(url, data=data, method=method,
                                         headers=headers)
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as resp:
                    payload = resp.read()
                    meta = QueryMeta(
                        last_index=int(
                            resp.headers.get("X-Nomad-Index", 0) or 0),
                        known_leader=(resp.headers.get(
                            "X-Nomad-KnownLeader", "true") != "false"),
                        stale=(resp.headers.get(
                            "X-Nomad-Stale", "false") == "true"))
                    if raw:
                        return payload, meta
                    decoded = json.loads(payload) if payload else None
                    from ..api_codec import from_columnar, is_columnar
                    if is_columnar(decoded):
                        # columnar is a wire encoding, not an API shape:
                        # callers always see row dicts
                        decoded = from_columnar(decoded)
                    return decoded, meta
            except urllib.error.HTTPError as e:
                try:
                    msg = json.loads(e.read() or b"{}").get("error", str(e))
                except (json.JSONDecodeError, OSError):
                    msg = str(e)
                retry_after = 0.0
                if e.code == 429:
                    try:
                        retry_after = float(
                            e.headers.get("Retry-After", 1.0) or 1.0)
                    except (TypeError, ValueError):
                        retry_after = 1.0
                if e.code != 429 or attempt >= self.retry_429:
                    raise APIError(e.code, msg, retry_after_s=retry_after)
                # jittered backoff (ISSUE 8): the hint plus up to 50%
                # random spread so a herd of rejected clients does not
                # re-synchronize on the same refill instant; the budget
                # bounds total sleep per call regardless of the hint
                delay = retry_after * (1.0 + 0.5 * random.random())
                if slept + delay > self.retry_budget_s:
                    raise APIError(e.code, msg, retry_after_s=retry_after)
                time.sleep(delay)
                slept += delay
        raise AssertionError("unreachable: 429 retry loop fell through")

    def get(self, endpoint: str, q: Optional[QueryOptions] = None,
            raw: bool = False, **params) -> tuple[Any, QueryMeta]:
        return self._do("GET", self._url(endpoint, q, params), raw=raw)

    def put(self, endpoint: str, body: Any = None,
            q: Optional[QueryOptions] = None, **params):
        return self._do("PUT", self._url(endpoint, q, params), body)

    def delete(self, endpoint: str, q: Optional[QueryOptions] = None,
               **params):
        return self._do("DELETE", self._url(endpoint, q, params))


class _Handle:
    def __init__(self, client: Client):
        self.c = client


class Jobs(_Handle):
    """ref api/jobs.go"""

    def list(self, q: Optional[QueryOptions] = None):
        return self.c.get("/v1/jobs", q)

    def register(self, job: dict, q: Optional[QueryOptions] = None):
        out, _ = self.c.put("/v1/jobs", {"Job": job}, q)
        return out

    def info(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.c.get(f"/v1/job/{urllib.parse.quote(job_id)}", q)

    def deregister(self, job_id: str, purge: bool = False):
        out, _ = self.c.delete(f"/v1/job/{urllib.parse.quote(job_id)}",
                               purge="true" if purge else "false")
        return out

    def plan(self, job_id: str, job: dict, diff: bool = True):
        out, _ = self.c.put(f"/v1/job/{urllib.parse.quote(job_id)}/plan",
                            {"Job": job, "Diff": diff})
        return out

    def allocations(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.c.get(
            f"/v1/job/{urllib.parse.quote(job_id)}/allocations", q)

    def evaluations(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.c.get(
            f"/v1/job/{urllib.parse.quote(job_id)}/evaluations", q)

    def deployments(self, job_id: str, q: Optional[QueryOptions] = None):
        return self.c.get(
            f"/v1/job/{urllib.parse.quote(job_id)}/deployments", q)

    def latest_deployment(self, job_id: str):
        return self.c.get(
            f"/v1/job/{urllib.parse.quote(job_id)}/deployment")

    def summary(self, job_id: str):
        return self.c.get(f"/v1/job/{urllib.parse.quote(job_id)}/summary")

    def versions(self, job_id: str):
        return self.c.get(f"/v1/job/{urllib.parse.quote(job_id)}/versions")

    def dispatch(self, job_id: str, meta: Optional[dict] = None,
                 payload: bytes = b""):
        import base64
        body = {"Meta": meta or {}}
        if payload:
            body["Payload"] = base64.b64encode(payload).decode()
        out, _ = self.c.put(
            f"/v1/job/{urllib.parse.quote(job_id)}/dispatch", body)
        return out

    def scale(self, job_id: str, group: str, count: Optional[int],
              message: str = "", policy_override: bool = False):
        out, _ = self.c.put(f"/v1/job/{urllib.parse.quote(job_id)}/scale", {
            "Target": {"Group": group}, "Count": count, "Message": message,
            "PolicyOverride": policy_override})
        return out

    def scale_status(self, job_id: str):
        return self.c.get(f"/v1/job/{urllib.parse.quote(job_id)}/scale")

    def revert(self, job_id: str, version: int,
               enforce_prior_version: Optional[int] = None):
        out, _ = self.c.put(f"/v1/job/{urllib.parse.quote(job_id)}/revert", {
            "JobVersion": version,
            "EnforcePriorVersion": enforce_prior_version})
        return out

    def stable(self, job_id: str, version: int, stable: bool):
        out, _ = self.c.put(f"/v1/job/{urllib.parse.quote(job_id)}/stable",
                            {"JobVersion": version, "Stable": stable})
        return out

    def periodic_force(self, job_id: str):
        out, _ = self.c.put(
            f"/v1/job/{urllib.parse.quote(job_id)}/periodic/force")
        return out

    def evaluate(self, job_id: str, force_reschedule: bool = False):
        """ref api/jobs.go EvaluateWithOpts"""
        out, _ = self.c.put(
            f"/v1/job/{urllib.parse.quote(job_id)}/evaluate",
            {"EvalOptions": {"ForceReschedule": force_reschedule}})
        return out

    def parse(self, hcl: str, canonicalize: bool = True):
        out, _ = self.c.put("/v1/jobs/parse",
                            {"JobHCL": hcl, "Canonicalize": canonicalize})
        return out

    def validate(self, job: dict):
        out, _ = self.c.put("/v1/validate/job", {"Job": job})
        return out


class Allocations(_Handle):
    """ref api/allocations.go"""

    def list(self, q: Optional[QueryOptions] = None):
        return self.c.get("/v1/allocations", q)

    def info(self, alloc_id: str):
        return self.c.get(f"/v1/allocation/{alloc_id}")

    def stop(self, alloc_id: str):
        out, _ = self.c.put(f"/v1/allocation/{alloc_id}/stop")
        return out

    def signal(self, alloc_id: str, signal: str, task: str = ""):
        out, _ = self.c.put(f"/v1/client/allocation/{alloc_id}/signal",
                            {"Signal": signal, "Task": task})
        return out

    def restart(self, alloc_id: str, task: str = ""):
        out, _ = self.c.put(f"/v1/client/allocation/{alloc_id}/restart",
                            {"TaskName": task})
        return out

    def stats(self, alloc_id: str):
        return self.c.get(f"/v1/client/allocation/{alloc_id}/stats")

    def gc(self, alloc_id: str):
        out, _ = self.c.put(f"/v1/client/allocation/{alloc_id}/gc")
        return out

    # fs family (ref api/fs.go)
    def fs_list(self, alloc_id: str, path: str = "/"):
        return self.c.get(f"/v1/client/fs/ls/{alloc_id}", path=path)

    def fs_stat(self, alloc_id: str, path: str):
        return self.c.get(f"/v1/client/fs/stat/{alloc_id}", path=path)

    def fs_cat(self, alloc_id: str, path: str) -> bytes:
        data, _ = self.c.get(f"/v1/client/fs/cat/{alloc_id}", raw=True,
                             path=path)
        return data

    def fs_read_at(self, alloc_id: str, path: str, offset: int,
                   limit: int) -> bytes:
        data, _ = self.c.get(f"/v1/client/fs/readat/{alloc_id}", raw=True,
                             path=path, offset=str(offset),
                             limit=str(limit))
        return data

    def logs(self, alloc_id: str, task: str, log_type: str = "stdout",
             origin: str = "start", offset: int = 0) -> bytes:
        data, _ = self.c.get(f"/v1/client/fs/logs/{alloc_id}", raw=True,
                             task=task, type=log_type, origin=origin,
                             offset=str(offset))
        return data

    def logs_follow(self, alloc_id: str, task: str,
                    log_type: str = "stdout", offset: int = 0,
                    wait: float = 10.0):
        """Generator over long-polled log chunks (ref api/fs.go Logs with
        follow=true). Yields bytes; the caller breaks when done."""
        import base64
        while True:
            out, _ = self.c.get(f"/v1/client/fs/logs/{alloc_id}",
                                task=task, type=log_type, follow="true",
                                offset=str(offset), wait=str(wait))
            data = base64.b64decode(out.get("Data", ""))
            offset = int(out.get("Offset", offset))
            yield data

    # exec family (ref api/allocations_exec.go; session API over HTTP)
    def exec_start(self, alloc_id: str, task: str, command: list,
                   tty: bool = False) -> str:
        out, _ = self.c.put(f"/v1/client/allocation/{alloc_id}/exec",
                             {"Task": task, "Cmd": list(command),
                              "Tty": tty})
        return out["SessionID"]

    def exec_stdin(self, session_id: str, data: bytes) -> None:
        import base64
        self.c.put(f"/v1/client/exec-session/{session_id}",
                    {"Stdin": base64.b64encode(data).decode()})

    def exec_stdin_close(self, session_id: str) -> None:
        """EOF the remote stdin (lets `cat`-like commands finish)."""
        self.c.put(f"/v1/client/exec-session/{session_id}",
                   {"StdinEOF": True})

    def exec_output(self, session_id: str, wait: float = 1.0) -> dict:
        import base64
        out, _ = self.c.get(f"/v1/client/exec-session/{session_id}",
                            wait=str(wait))
        return {"stdout": base64.b64decode(out.get("Stdout", "")),
                "stderr": base64.b64decode(out.get("Stderr", "")),
                "exited": out.get("Exited", False),
                "exit_code": out.get("ExitCode")}

    def exec_close(self, session_id: str) -> None:
        self.c.delete(f"/v1/client/exec-session/{session_id}")

    def exec_run(self, alloc_id: str, task: str, command: list,
                 stdin: bytes = b"", timeout: float = 30.0) -> dict:
        """Convenience round-trip: run command, feed stdin, collect all
        output until exit. -> {stdout, stderr, exit_code}"""
        import time as _time
        sid = self.exec_start(alloc_id, task, command)
        try:
            if stdin:
                self.exec_stdin(sid, stdin)
            self.exec_stdin_close(sid)   # one-shot: no more input coming
            out = b""
            err = b""
            deadline = _time.monotonic() + timeout
            while _time.monotonic() < deadline:
                chunk = self.exec_output(sid, wait=1.0)
                out += chunk["stdout"]
                err += chunk["stderr"]
                if chunk["exited"] and not chunk["stdout"] and \
                        not chunk["stderr"]:
                    return {"stdout": out, "stderr": err,
                            "exit_code": chunk["exit_code"]}
            raise TimeoutError(f"exec did not exit within {timeout}s")
        finally:
            self.exec_close(sid)


class Nodes(_Handle):
    """ref api/nodes.go"""

    def list(self, q: Optional[QueryOptions] = None):
        return self.c.get("/v1/nodes", q)

    def info(self, node_id: str):
        return self.c.get(f"/v1/node/{node_id}")

    def allocations(self, node_id: str):
        return self.c.get(f"/v1/node/{node_id}/allocations")

    def drain(self, node_id: str, enable: bool,
              deadline_sec: float = 3600.0, ignore_system: bool = False):
        spec = {"Deadline": int(deadline_sec * 1e9),
                "IgnoreSystemJobs": ignore_system} if enable else None
        out, _ = self.c.put(f"/v1/node/{node_id}/drain",
                            {"DrainSpec": spec})
        return out

    def eligibility(self, node_id: str, eligible: bool):
        out, _ = self.c.put(f"/v1/node/{node_id}/eligibility", {
            "Eligibility": "eligible" if eligible else "ineligible"})
        return out


class Evaluations(_Handle):
    """ref api/evaluations.go"""

    def list(self, q: Optional[QueryOptions] = None):
        return self.c.get("/v1/evaluations", q)

    def info(self, eval_id: str):
        return self.c.get(f"/v1/evaluation/{eval_id}")

    def allocations(self, eval_id: str):
        return self.c.get(f"/v1/evaluation/{eval_id}/allocations")


class Deployments(_Handle):
    """ref api/deployments.go"""

    def list(self, q: Optional[QueryOptions] = None):
        return self.c.get("/v1/deployments", q)

    def info(self, deployment_id: str):
        return self.c.get(f"/v1/deployment/{deployment_id}")

    def allocations(self, deployment_id: str):
        return self.c.get(f"/v1/deployment/allocations/{deployment_id}")

    def promote(self, deployment_id: str, all_groups: bool = True,
                groups: Optional[list] = None):
        out, _ = self.c.put(f"/v1/deployment/promote/{deployment_id}", {
            "All": all_groups, "Groups": groups or []})
        return out

    def fail(self, deployment_id: str):
        out, _ = self.c.put(f"/v1/deployment/fail/{deployment_id}")
        return out

    def pause(self, deployment_id: str, pause: bool):
        out, _ = self.c.put(f"/v1/deployment/pause/{deployment_id}",
                            {"Pause": pause})
        return out


class Namespaces(_Handle):
    def list(self):
        return self.c.get("/v1/namespaces")

    def register(self, name: str, description: str = ""):
        out, _ = self.c.put("/v1/namespace",
                            {"Name": name, "Description": description})
        return out

    def delete(self, name: str):
        out, _ = self.c.delete(f"/v1/namespace/{name}")
        return out


class ACL(_Handle):
    """ref api/acl.go"""

    def bootstrap(self):
        out, _ = self.c.put("/v1/acl/bootstrap")
        return out

    def policies(self):
        return self.c.get("/v1/acl/policies")

    def policy_info(self, name: str):
        return self.c.get(f"/v1/acl/policy/{name}")

    def policy_upsert(self, name: str, rules: str, description: str = ""):
        out, _ = self.c.put(f"/v1/acl/policy/{name}",
                            {"Rules": rules, "Description": description})
        return out

    def policy_delete(self, name: str):
        out, _ = self.c.delete(f"/v1/acl/policy/{name}")
        return out

    def tokens(self):
        return self.c.get("/v1/acl/tokens")

    def token_create(self, name: str = "", type_: str = "client",
                     policies: Optional[list] = None,
                     global_: bool = False):
        out, _ = self.c.put("/v1/acl/token", {
            "Name": name, "Type": type_, "Policies": policies or [],
            "Global": global_})
        return out

    def token_self(self):
        return self.c.get("/v1/acl/token/self")

    def token_delete(self, accessor_id: str):
        out, _ = self.c.delete(f"/v1/acl/token/{accessor_id}")
        return out


class Operator(_Handle):
    """ref api/operator.go"""

    def scheduler_get_configuration(self):
        return self.c.get("/v1/operator/scheduler/configuration")

    def scheduler_set_configuration(self, config: dict):
        out, _ = self.c.put("/v1/operator/scheduler/configuration", config)
        return out

    def raft_get_configuration(self):
        return self.c.get("/v1/operator/raft/configuration")

    def raft_remove_peer(self, peer_id: str = "", address: str = ""):
        params = {}
        if peer_id:
            params["id"] = peer_id
        if address:
            params["address"] = address
        out, _ = self.c.delete("/v1/operator/raft/peer", **params)
        return out

    def autopilot_get_configuration(self):
        return self.c.get("/v1/operator/autopilot/configuration")

    def autopilot_set_configuration(self, config: dict):
        out, _ = self.c.put("/v1/operator/autopilot/configuration", config)
        return out

    def autopilot_health(self):
        return self.c.get("/v1/operator/autopilot/health")

    def snapshot_save(self) -> bytes:
        data, _ = self.c.get("/v1/operator/snapshot", raw=True)
        return data

    def snapshot_restore(self, data: bytes):
        out, _ = self.c.put("/v1/operator/snapshot", data)
        return out


class Search(_Handle):
    """ref api/search.go"""

    def prefix(self, prefix: str, context: str = "all",
               q: Optional[QueryOptions] = None):
        out, _ = self.c._do("POST", self.c._url("/v1/search", q),
                            {"Prefix": prefix, "Context": context})
        return out

    def fuzzy(self, text: str, context: str = "all",
              q: Optional[QueryOptions] = None):
        out, _ = self.c._do("POST", self.c._url("/v1/search/fuzzy", q),
                            {"Text": text, "Context": context})
        return out


class Scaling(_Handle):
    """ref api/scaling.go"""

    def policies(self, job: str = ""):
        params = {"job": job} if job else {}
        return self.c.get("/v1/scaling/policies", **params)

    def policy_info(self, policy_id: str):
        return self.c.get(f"/v1/scaling/policy/{policy_id}")


class CSIVolumes(_Handle):
    """ref api/csi.go"""

    def list(self, plugin_id: str = ""):
        params = {"plugin_id": plugin_id} if plugin_id else {}
        return self.c.get("/v1/volumes", **params)

    def info(self, volume_id: str):
        return self.c.get(f"/v1/volume/csi/{urllib.parse.quote(volume_id)}")

    def register(self, volume: dict):
        out, _ = self.c.put(
            f"/v1/volume/csi/{urllib.parse.quote(volume.get('ID', ''))}",
            {"Volume": volume})
        return out

    def deregister(self, volume_id: str, force: bool = False):
        out, _ = self.c.delete(
            f"/v1/volume/csi/{urllib.parse.quote(volume_id)}",
            force="true" if force else "false")
        return out


class CSIPlugins(_Handle):
    def list(self):
        return self.c.get("/v1/plugins")

    def info(self, plugin_id: str):
        return self.c.get(f"/v1/plugin/csi/{plugin_id}")


class Services(_Handle):
    """ref api/services.go (native service discovery)"""

    def list(self, q: Optional[QueryOptions] = None):
        return self.c.get("/v1/services", q)

    def instances(self, name: str, q: Optional[QueryOptions] = None):
        return self.c.get(f"/v1/service/{urllib.parse.quote(name)}", q)


class System(_Handle):
    def gc(self):
        out, _ = self.c.put("/v1/system/gc")
        return out

    def reconcile_summaries(self):
        """ref api/system.go ReconcileSummaries"""
        out, _ = self.c.put("/v1/system/reconcile/summaries")
        return out


class AgentAPI(_Handle):
    """ref api/agent.go"""

    def self(self):
        return self.c.get("/v1/agent/self")

    def health(self):
        return self.c.get("/v1/agent/health")

    def members(self):
        return self.c.get("/v1/agent/members")

    def join(self, address: str, name: str = ""):
        out, _ = self.c.put("/v1/agent/join", address=address,
                            name=name or address)
        return out

    def force_leave(self, node: str):
        out, _ = self.c.put("/v1/agent/force-leave", node=node)
        return out

    def metrics(self):
        return self.c.get("/v1/metrics")

    def regions(self):
        return self.c.get("/v1/regions")

    def monitor(self, log_level: str = "info") -> Iterator[str]:
        """Stream agent log lines (ref api/agent.go Monitor)."""
        url = self.c._url("/v1/agent/monitor",
                          extra={"log_level": log_level})
        headers = {}
        if self.c.token:
            headers["X-Nomad-Token"] = self.c.token
        req = urllib.request.Request(url, headers=headers)
        with urllib.request.urlopen(req, timeout=self.c.timeout) as resp:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                try:
                    data = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if data.get("Data"):
                    yield data["Data"]


class ClientAPI(_Handle):
    def stats(self):
        return self.c.get("/v1/client/stats")

    def gc(self):
        out, _ = self.c.put("/v1/client/gc")
        return out


def event_stream(client: Client, topics: Optional[dict] = None,
                 index: int = 0, namespace: str = "") -> Iterator[dict]:
    """Generator over /v1/event/stream (ref api/event_stream.go): yields
    {"Index": N, "Events": [...]} frames as they arrive."""
    params = []
    for topic, keys in (topics or {"*": ["*"]}).items():
        for key in keys:
            params.append(("topic", f"{topic}:{key}"))
    if index:
        params.append(("index", str(index)))
    if namespace or client.namespace:
        params.append(("namespace", namespace or client.namespace))
    qs = urllib.parse.urlencode(params)
    url = f"{client.address}/v1/event/stream?{qs}"
    headers = {}
    if client.token:
        headers["X-Nomad-Token"] = client.token
    req = urllib.request.Request(url, headers=headers)
    with urllib.request.urlopen(req, timeout=client.timeout) as resp:
        for line in resp:
            line = line.strip()
            if not line:
                continue
            try:
                frame = json.loads(line)
            except json.JSONDecodeError:
                continue
            if frame:
                yield frame
