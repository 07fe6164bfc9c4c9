"""HTTP API (ref command/agent/http.go:274-420 registerHandlers): the /v1/*
REST surface over the server RPC methods, with blocking-query support
(?index=N&wait=Ss) and namespace scoping (?namespace=)."""
from __future__ import annotations

import json
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..api_codec import from_api, to_api
from ..rpc.codec import LeadershipLostError, NotLeaderError
from ..structs import (
    DrainStrategy, Job, SchedulerConfiguration,
)


class HTTPError(Exception):
    def __init__(self, code: int, message: str, retry_after: float = 0.0):
        super().__init__(message)
        self.code = code
        self.message = message
        # 429 responses carry the admission bucket's earliest-retry hint
        # as a Retry-After header (ISSUE 8; api/client.py honors it)
        self.retry_after = retry_after


def require(ok: bool) -> None:
    """403 unless the ACL check passed (shared by all route families)."""
    if not ok:
        raise HTTPError(403, "Permission denied")


class RawResponse:
    """Non-JSON payload (file contents, logs) passed through verbatim."""

    def __init__(self, data: bytes, content_type: str = "text/plain"):
        self.data = data
        self.content_type = content_type


class HTTPAPI:
    """Route table + handlers; transport-agnostic (used by the HTTP server
    and directly by tests)."""

    def __init__(self, agent):
        self.agent = agent
        self.server = agent.server

    def resolve_acl(self, token: str):
        """Token -> ACL object via the server, 403 on unknown tokens (the
        single resolution path for all route families)."""
        from ..server.acl_endpoint import TokenNotFoundError
        try:
            return self.server.acl.resolve_token(token)
        except TokenNotFoundError:
            raise HTTPError(403, "ACL token not found")

    # ------------------------------------------------------------ dispatch

    def handle(self, method: str, path: str, query: dict,
               body: Optional[dict], token: str = ""):
        s = self.server
        parts = [p for p in path.split("/") if p]
        if not parts or parts[0] != "v1":
            raise HTTPError(404, "not found")
        parts = parts[1:]
        if parts and parts[0] == "client":
            # node-local routes served by the client half of the agent
            # (ref command/agent/fs_endpoint.go, agent_endpoint.go)
            return self._handle_client(method, parts[1:], query, body, token)
        if parts == ["agent", "health"]:
            # reachable on client-only agents too: monitoring probes client
            # nodes through this (ref agent_endpoint.go HealthRequest)
            out = {}
            if self.server is not None:
                out["server"] = {"ok": True, "message": "ok"}
            if self.agent.client is not None:
                out["client"] = {"ok": self.agent.client.node.ready(),
                                 "message": "ok"}
            return out, None
        if s is None:
            # client-only agents serve no server-backed routes yet (the
            # reference proxies these RPCs to its servers; our CLI/SDK talk
            # to a server agent's HTTP address directly)
            raise HTTPError(501, "agent is not running a server")
        ns = query.get("namespace", "default")
        body = body or {}   # body-less PUT/POST is an empty request

        # ---- ingress admission (ISSUE 8): per-endpoint-class token
        # buckets BEFORE ACL resolution or any state read — an over-rate
        # caller costs one bucket probe. /v1/status and /v1/metrics stay
        # admissible under overload: they are how operators SEE the
        # overload (and how monitoring tells saturated from down).
        if parts and parts[0] not in ("status", "metrics"):
            from ..server.overload import RateLimitExceeded
            ctrl = getattr(s, "overload", None)
            if ctrl is not None:
                try:
                    ctrl.admit(ctrl.classify_http(method, query))
                except RateLimitExceeded as e:
                    raise HTTPError(429, str(e),
                                    retry_after=e.retry_after_s)

        # ---- ACL resolution (ref command/agent/http.go parseToken +
        # per-endpoint aclObj checks)
        from ..acl import (
            NS_DISPATCH_JOB, NS_LIST_JOBS, NS_READ_JOB, NS_SUBMIT_JOB,
        )
        acl = self.resolve_acl(token)

        # ---- ACL management endpoints
        if parts and parts[0] == "acl":
            return self._handle_acl(method, parts[1:], body, token, acl)
        if parts == ["namespaces"]:
            # filtered to namespaces the token can access (ref
            # nomad/namespace_endpoint — no blanket 403)
            return [self._ns_api(n) for n in s.state.iter_namespaces()
                    if acl.allow_namespace(n.get("name", ""))], \
                s.state.table_index("namespaces")
        if parts and parts[0] == "namespace":
            if method == "GET" and len(parts) == 2:
                n = s.state.namespace_by_name(parts[1])
                if n is None:
                    raise HTTPError(404, "namespace not found")
                require(acl.allow_namespace(parts[1]))
                return self._ns_api(n), s.state.table_index("namespaces")
            require(acl.is_management())
            if method in ("PUT", "POST"):
                name = body.get("Name") or (parts[1] if len(parts) > 1
                                            else "")
                if not name:
                    raise HTTPError(400, "namespace name required")
                s.namespace_upsert([{
                    "name": name,
                    "description": body.get("Description", "")}])
                return {}, None
            if method == "DELETE" and len(parts) == 2:
                try:
                    s.namespace_delete([parts[1]])
                except ValueError as e:
                    raise HTTPError(400, str(e))
                return {}, None

        # ---- read staleness (ISSUE 16): agent-local reads are stale by
        # construction on a follower (served from its replicated store).
        # `?stale=false` demands leader consistency — a follower redirects
        # via NotLeaderError (the handler proxies one hop to the leader);
        # `?max_stale_index=N` bounds the staleness — serve only once the
        # local store has applied index N, else redirect/504. Responses
        # stamp X-Nomad-KnownLeader / X-Nomad-Stale so it is provable.
        if method == "GET":
            if s.raft_node is not None:
                s._raft_leadership()   # refresh the cached leader addr
            stale_q = query.get("stale")
            if stale_q is not None and \
                    str(stale_q).lower() in ("false", "0", "no") and \
                    s.raft_node is not None and not s.is_leader:
                raise NotLeaderError(s.leader_rpc_addr)
            max_stale = int(query.get("max_stale_index", 0) or 0)
            if max_stale:
                cap_s = s.overload.blocking_cap_s() \
                    if getattr(s, "overload", None) is not None else 5.0
                try:
                    s.state.snapshot_min_index(max_stale,
                                               timeout=min(cap_s, 5.0))
                except TimeoutError:
                    if s.raft_node is not None and not s.is_leader and \
                            s.leader_rpc_addr:
                        raise NotLeaderError(s.leader_rpc_addr)
                    raise HTTPError(
                        504, f"index {max_stale} not reached locally")

        def blocking(index_fn, payload_fn, topics=None):
            min_index = int(query.get("index", 0) or 0)
            # the hold ceiling shrinks under pressure (brownout, ISSUE 8):
            # parked long-polls are the cheapest capacity to reclaim, and
            # a shorter hold degrades watchers to polling instead of 500s
            cap_s = s.overload.blocking_cap_s() \
                if getattr(s, "overload", None) is not None else 30.0
            wait = min(float(query.get("wait", "0").rstrip("s") or 0),
                       cap_s)
            if min_index and wait:
                deadline = time.time() + wait
                # park on the event broker, not the store condvar: only
                # writes on this route's topic wake the watcher (ISSUE
                # 16), instead of every store write waking every parked
                # blocking query. `seen` chases the topic index so churn
                # on OTHER keys of the topic re-checks once, then parks
                # again; the deadline re-check covers the rare writes
                # that emit no event (bounded delay, never wrong).
                broker = s.event_broker
                seen = min_index
                while index_fn() <= min_index and time.time() < deadline:
                    seen = max(seen, broker.wait_for_index(
                        topics, seen,
                        timeout=max(0.05, deadline - time.time())))
            return payload_fn(), index_fn()

        def list_reply(rows):
            # stub-field projection + columnar struct-of-arrays mode for
            # the list hot paths (ISSUE 16); ?fields=A,B&format=columnar
            from ..api_codec import project_fields, to_columnar
            fields = [f for f in (query.get("fields") or "").split(",")
                      if f]
            rows = project_fields(rows, fields or None)
            if query.get("format") == "columnar":
                return to_columnar(rows)
            return rows

        # ---- jobs
        if parts == ["jobs"]:
            if method == "GET":
                # wildcard namespace lists across namespaces with
                # per-job ACL filtering, like the other list routes
                # (ref nomad/job_endpoint.go List + allowedNSes). The
                # e2e rejoin test caught the old behavior: iter_jobs("*")
                # matched the literal namespace "*" and returned nothing.
                require(ns == "*" or
                        acl.allow_namespace_operation(ns, NS_LIST_JOBS))
                prefix = query.get("prefix", "")
                payload, index = blocking(
                    lambda: s.state.table_index("jobs"),
                    lambda: [self._job_stub(j) for j in s.state.iter_jobs(
                        None if ns == "*" else ns)
                        if j.id.startswith(prefix)
                        and (ns != "*" or acl.allow_namespace_operation(
                            j.namespace, NS_LIST_JOBS))],
                    topics=("Job",))
                return list_reply(payload), index
            if method in ("PUT", "POST"):
                job = from_api(Job, body.get("Job", body))
                if not job.namespace:
                    job.namespace = ns
                require(acl.allow_namespace_operation(job.namespace,
                                                      NS_SUBMIT_JOB))
                try:
                    return s.job_register(job), None
                except ValueError as e:
                    raise HTTPError(400, str(e))
        if parts and parts[0] == "job":
            if len(parts) < 2:
                raise HTTPError(404, "missing job id")
            job_id = urllib.parse.unquote(parts[1])
            rest = parts[2:]
            from ..acl import (
                NS_READ_JOB_SCALING, NS_SCALE_JOB,
            )
            if rest == ["scale"]:
                if method == "GET":
                    require(acl.allow_namespace_operation(
                        ns, NS_READ_JOB_SCALING)
                        or acl.allow_namespace_operation(ns, NS_READ_JOB))
                else:
                    require(acl.allow_namespace_operation(ns, NS_SCALE_JOB)
                            or acl.allow_namespace_operation(
                                ns, NS_SUBMIT_JOB))
            elif method == "GET":
                require(acl.allow_namespace_operation(ns, NS_READ_JOB))
            elif rest == ["dispatch"]:
                require(acl.allow_namespace_operation(ns, NS_DISPATCH_JOB))
            else:
                require(acl.allow_namespace_operation(ns, NS_SUBMIT_JOB))
            if not rest:
                if method == "GET":
                    job = s.state.job_by_id(ns, job_id)
                    if job is None:
                        raise HTTPError(404, f"job {job_id!r} not found")
                    return to_api(job), s.state.table_index("jobs")
                if method in ("PUT", "POST"):
                    job = from_api(Job, body.get("Job", body))
                    job.id = job_id
                    if not job.namespace:
                        job.namespace = ns
                    # the body's namespace is authoritative — re-check it
                    require(acl.allow_namespace_operation(job.namespace,
                                                          NS_SUBMIT_JOB))
                    try:
                        return s.job_register(job), None
                    except ValueError as e:
                        raise HTTPError(400, str(e))
                if method == "DELETE":
                    purge = query.get("purge", "") in ("1", "true")
                    return s.job_deregister(ns, job_id, purge), None
            elif rest == ["evaluations"]:
                return [to_api(e) for e in s.state.evals_by_job(ns, job_id)], \
                    s.state.table_index("evals")
            elif rest == ["allocations"]:
                return [self._alloc_stub(a)
                        for a in s.state.allocs_by_job(ns, job_id)], \
                    s.state.table_index("allocs")
            elif rest == ["deployments"]:
                return [to_api(d)
                        for d in s.state.deployments_by_job(ns, job_id)], \
                    s.state.table_index("deployment")
            elif rest == ["deployment"]:
                d = s.state.latest_deployment_by_job(ns, job_id)
                return (to_api(d) if d else None), \
                    s.state.table_index("deployment")
            elif rest == ["summary"]:
                summ = s.state.job_summary(ns, job_id)
                if summ is None:
                    raise HTTPError(404, f"job {job_id!r} not found")
                # blocking index must move on every path that rewrites
                # summaries: job registration ("jobs"), per-alloc status
                # maintenance (rides "allocs"), and the
                # reconcile-summaries repair path ("job_summary")
                return to_api(summ), max(
                    s.state.table_index("jobs"),
                    s.state.table_index("allocs"),
                    s.state.table_index("job_summary"))
            elif rest == ["versions"]:
                return [to_api(j)
                        for j in s.state.job_versions_by_id(ns, job_id)], \
                    s.state.table_index("jobs")
            elif rest == ["plan"] and method in ("PUT", "POST"):
                job = from_api(Job, body.get("Job", body))
                if job.id and job.id != job_id:
                    raise HTTPError(400, f"job ID {job.id!r} does not match "
                                    f"URL job id {job_id!r}")
                job.id = job_id
                if not job.name:
                    job.name = job_id
                if not job.namespace:
                    job.namespace = ns
                require(acl.allow_namespace_operation(job.namespace,
                                                      NS_SUBMIT_JOB))
                try:
                    return s.job_plan(job, diff=bool(body.get("Diff", True))), \
                        None
                except ValueError as e:
                    raise HTTPError(400, str(e))
            elif rest == ["dispatch"] and method in ("PUT", "POST"):
                import base64
                payload = base64.b64decode(body.get("Payload", "") or "")
                meta = body.get("Meta", {}) or {}
                try:
                    return s.job_dispatch(ns, job_id, payload, meta), None
                except ValueError as e:
                    raise HTTPError(400, str(e))
            elif rest == ["evaluate"] and method in ("PUT", "POST"):
                # ref job_endpoint.go Evaluate / PUT /v1/job/<id>/evaluate
                # (an empty request body means default EvalOptions)
                opts = (body or {}).get("EvalOptions", {}) or {}
                try:
                    out = s.job_evaluate(
                        ns, job_id,
                        force_reschedule=bool(opts.get("ForceReschedule")))
                except ValueError as e:
                    raise HTTPError(400, str(e))
                return {"EvalID": out["eval_id"],
                        "EvalCreateIndex": out["eval_create_index"],
                        "JobModifyIndex": out["job_modify_index"],
                        "Index": out["index"]}, None
            elif rest == ["periodic", "force"] and method in ("PUT", "POST"):
                job = s.state.job_by_id(ns, job_id)
                if job is None or not job.is_periodic():
                    raise HTTPError(400, f"job {job_id!r} is not periodic")
                child = s.periodic.force_launch(job)
                return {"dispatched_job_id": child.id}, None
            elif rest == ["scale"]:
                if method == "GET":
                    try:
                        return to_api(s.job_scale_status(ns, job_id)), \
                            s.state.table_index("scaling_event")
                    except ValueError as e:
                        raise HTTPError(404, str(e))
                if method not in ("PUT", "POST"):
                    raise HTTPError(405, "method not allowed")
                target = body.get("Target", {}) or {}
                count = body.get("Count")
                if count is not None:
                    try:
                        count = int(count)
                    except (TypeError, ValueError):
                        raise HTTPError(400, "Count must be an integer")
                try:
                    return s.job_scale(
                        ns, job_id, target.get("Group", ""),
                        count=count,
                        message=body.get("Message", ""),
                        error=bool(body.get("Error", False)),
                        meta=body.get("Meta"),
                        policy_override=bool(
                            body.get("PolicyOverride", False))), None
                except ValueError as e:
                    raise HTTPError(400, str(e))
            elif rest == ["revert"] and method in ("PUT", "POST"):
                try:
                    return s.job_revert(
                        ns, job_id, int(body.get("JobVersion", 0)),
                        body.get("EnforcePriorVersion")), None
                except ValueError as e:
                    raise HTTPError(400, str(e))
            elif rest == ["stable"] and method in ("PUT", "POST"):
                try:
                    return s.job_stable(
                        ns, job_id, int(body.get("JobVersion", 0)),
                        bool(body.get("Stable", False))), None
                except ValueError as e:
                    raise HTTPError(400, str(e))

        # ---- evaluations
        if parts == ["evaluations"]:
            if ns != "*":
                require(acl.allow_namespace_operation(ns, NS_READ_JOB))
            payload, index = blocking(
                lambda: s.state.table_index("evals"),
                lambda: [to_api(e) for e in s.state.iter_evals()
                         if (e.namespace == ns if ns != "*" else
                             acl.allow_namespace_operation(e.namespace,
                                                           NS_READ_JOB))],
                topics=("Evaluation",))
            return list_reply(payload), index
        if parts and parts[0] == "evaluation" and len(parts) >= 2:
            ev = s.state.eval_by_id(parts[1])
            if ev is None:
                raise HTTPError(404, "eval not found")
            # authorize against the resource's own namespace
            require(acl.allow_namespace_operation(ev.namespace, NS_READ_JOB))
            if parts[2:] == ["allocations"]:
                return [self._alloc_stub(a)
                        for a in s.state.allocs_by_eval(parts[1])], None
            return to_api(ev), s.state.table_index("evals")

        # ---- allocations
        if parts == ["allocations"]:
            if ns != "*":
                require(acl.allow_namespace_operation(ns, NS_READ_JOB))
            payload, index = blocking(
                lambda: s.state.table_index("allocs"),
                lambda: [self._alloc_stub(a) for a in s.state.iter_allocs()
                         if (a.namespace == ns if ns != "*" else
                             acl.allow_namespace_operation(a.namespace,
                                                           NS_READ_JOB))],
                topics=("Allocation",))
            return list_reply(payload), index
        if parts and parts[0] == "allocation" and len(parts) >= 2:
            alloc = s.state.alloc_by_id(parts[1])
            if alloc is None:
                raise HTTPError(404, "alloc not found")
            # authorize against the alloc's own namespace
            require(acl.allow_namespace_operation(alloc.namespace,
                                                  NS_READ_JOB))
            if parts[2:] == ["stop"] and method in ("PUT", "POST"):
                # stopping a workload is a lifecycle write
                from ..acl import NS_ALLOC_LIFECYCLE
                require(acl.allow_namespace_operation(alloc.namespace,
                                                      NS_ALLOC_LIFECYCLE))
                return s.alloc_stop(parts[1]), None
            return to_api(alloc), s.state.table_index("allocs")

        # ---- nodes
        if parts == ["nodes"]:
            require(acl.allow_node_read())
            payload, index = blocking(
                lambda: s.state.table_index("nodes"),
                lambda: [self._node_stub(n) for n in s.state.iter_nodes()],
                topics=("Node",))
            return list_reply(payload), index
        if parts and parts[0] == "node" and len(parts) >= 2:
            require(acl.allow_node_write() if method != "GET"
                    else acl.allow_node_read())
            node_id = parts[1]
            node = s.state.node_by_id(node_id)
            if node is None:
                raise HTTPError(404, "node not found")
            rest = parts[2:]
            if not rest:
                return to_api(node), s.state.table_index("nodes")
            if rest == ["allocations"]:
                return [self._alloc_stub(a)
                        for a in s.state.allocs_by_node(node_id)], None
            if rest == ["drain"] and method in ("PUT", "POST"):
                spec = body.get("DrainSpec") if body else None
                drain = None
                if spec is not None:
                    drain = DrainStrategy(
                        deadline_sec=float(spec.get("Deadline", 0)) / 1e9
                        if spec.get("Deadline", 0) > 1e6
                        else float(spec.get("Deadline", 0)),
                        ignore_system_jobs=spec.get("IgnoreSystemJobs", False))
                mark = bool(body.get("MarkEligible")) if body else False
                return s.node_update_drain(node_id, drain, mark), None
            if rest == ["eligibility"] and method in ("PUT", "POST"):
                elig = body.get("Eligibility", "eligible")
                return s.node_update_eligibility(node_id, elig), None

        # ---- deployments
        if parts == ["deployments"]:
            # wildcard lists filter per item like evaluations/allocations
            # (a namespaced read token may browse its own deployments)
            if ns != "*":
                require(acl.allow_namespace_operation(ns, NS_READ_JOB))
            deps = [d for d in s.deployment_list(ns)
                    if ns != "*" or acl.allow_namespace_operation(
                        d.namespace, NS_READ_JOB)]
            return [to_api(d) for d in deps], \
                s.state.table_index("deployment")
        if parts and parts[0] == "deployment" and len(parts) >= 2:
            # authorize against the deployment's OWN namespace, not the
            # caller-supplied query namespace (ref nomad/deployment_endpoint.go
            # resolves the deployment first, then checks its .Namespace)
            dep_id = parts[2] if parts[1] in ("promote", "fail", "pause") \
                and len(parts) > 2 else \
                (body.get("DeploymentID") if parts[1] == "promote"
                 else parts[1])
            dep = s.state.deployment_by_id(dep_id) if dep_id else None
            if dep is None:
                raise HTTPError(404, "deployment not found")
            require(acl.allow_namespace_operation(
                dep.namespace,
                NS_READ_JOB if method == "GET" else NS_SUBMIT_JOB))
            if parts[1] == "promote" and method in ("PUT", "POST"):
                try:
                    return s.deployment_promote(
                        parts[2] if len(parts) > 2 else body.get("DeploymentID"),
                        body.get("Groups")), None
                except (KeyError, ValueError) as e:
                    raise HTTPError(400, str(e))
            if parts[1] == "fail" and len(parts) > 2 and \
               method in ("PUT", "POST"):
                return s.deployment_fail(parts[2]), None
            if parts[1] == "pause" and len(parts) > 2 and \
               method in ("PUT", "POST"):
                return s.deployment_pause(
                    parts[2], bool(body.get("Pause", True))), None
            # dep (resolved for the auth check above) is the target here
            if parts[2:] == ["allocations"]:
                allocs = [a for a in s.state.iter_allocs()
                          if a.deployment_id == parts[1]]
                return [self._alloc_stub(a) for a in allocs], None
            return to_api(dep), s.state.table_index("deployment")

        # ---- operator
        if parts == ["operator", "scheduler", "configuration"]:
            if method == "GET":
                require(acl.allow_operator_read())
                return {"SchedulerConfig":
                        to_api(s.get_scheduler_configuration())}, None
            if method in ("PUT", "POST"):
                require(acl.allow_operator_write())
                cfg = from_api(SchedulerConfiguration, body)
                try:
                    return s.set_scheduler_configuration(cfg), None
                except ValueError as e:
                    raise HTTPError(400, str(e))
        if parts == ["operator", "raft", "configuration"]:
            require(acl.allow_operator_read())
            return s.operator_raft_configuration(), None
        if parts == ["operator", "raft", "peer"] and method == "DELETE":
            require(acl.allow_operator_write())
            addr = query.get("address", "")
            if isinstance(addr, list):     # "address" stays a list for join
                addr = addr[0] if addr else ""
            try:
                return s.operator_raft_remove_peer(
                    peer_id=query.get("id", ""),
                    address=addr), None
            except ValueError as e:
                raise HTTPError(400, str(e))
        if parts[:2] == ["operator", "broker"]:
            # the broker only exists on the leader: answering from a
            # follower would report an empty dead-letter queue while the
            # sick evals keep retrying — raise so the HTTP layer's
            # transparent follower->leader forwarding engages
            if s.raft_node is not None and not s.is_leader:
                raise NotLeaderError(s.leader_rpc_addr)
        if parts == ["operator", "broker", "failed"] and method == "GET":
            # dead-letter visibility (ISSUE 3 failed-eval lifecycle)
            require(acl.allow_operator_read())
            evs = s.eval_broker.failed_evals()
            return {"Evals": [to_api(e) for e in evs],
                    "Count": len(evs),
                    "Stats": dict(s.eval_broker.stats)}, None
        if parts == ["operator", "broker", "drain-failed"] and \
                method in ("PUT", "POST"):
            # operator drain: terminate dead-lettered evals (and cancel
            # their waiting follow-ups) WITHOUT retry — takes an
            # unrecoverable eval out of the loop (ref the
            # `nomad eval delete` escape hatch)
            require(acl.allow_operator_write())
            out = s.eval_drain_failed()
            return {"DrainedEvals": out["drained"],
                    "CancelledFollowUps": out["cancelled_follow_ups"],
                    "Count": out["count"]}, None
        if parts == ["operator", "autopilot", "configuration"]:
            if method == "GET":
                require(acl.allow_operator_read())
                return s.operator_autopilot_get_config(), \
                    s.state.table_index("autopilot")
            require(acl.allow_operator_write())
            return s.operator_autopilot_set_config(body), None
        if parts == ["operator", "autopilot", "health"]:
            require(acl.allow_operator_read())
            return s.operator_server_health(), None
        if parts == ["operator", "debug"] and method == "GET":
            # one-shot debug bundle (ISSUE 11): metrics + traces +
            # pressure/broker/state-cache/breaker internals + recent
            # placement-explain records + device-runtime telemetry.
            # Served LOCALLY by any server (each server's internals are
            # its own) — `operator debug` captures it into the archive.
            require(acl.allow_operator_read())
            return s.operator_debug_bundle(), None
        if parts == ["operator", "snapshot"]:
            # management-only BOTH ways: the snapshot embeds every ACL token
            # secret, and restore deserializes arbitrary bytes
            # (ref nomad/operator_endpoint.go SnapshotSave/Restore: management)
            if method == "GET":
                require(acl.is_management())
                return RawResponse(s.snapshot_save(),
                                   "application/octet-stream"), None
            if method in ("PUT", "POST"):
                require(acl.is_management())
                import base64
                raw = body.get("_raw") if isinstance(body, dict) else None
                if raw is None and isinstance(body, dict) \
                        and body.get("Snapshot"):
                    raw = base64.b64decode(body["Snapshot"])
                if not raw:
                    raise HTTPError(400, "missing snapshot body")
                try:
                    s.snapshot_restore(raw)
                except Exception as e:  # noqa: BLE001
                    raise HTTPError(400, f"restore failed: {e}")
                return {}, None

        # ---- misc
        # ---- scaling policies (ref command/agent/scaling_endpoint.go)
        if parts == ["scaling", "policies"]:
            from ..acl import NS_LIST_SCALING_POLICIES
            pols = [p for p in s.scaling_policies_list(
                        None if ns == "*" else ns,
                        query.get("job") or None,
                        query.get("type") or None)
                    if acl.allow_namespace_operation(
                        p.target_key()[0], NS_LIST_SCALING_POLICIES)]
            return [{"ID": p.id, "Enabled": p.enabled, "Type": p.type,
                     "Target": dict(p.target),
                     "CreateIndex": p.create_index,
                     "ModifyIndex": p.modify_index} for p in pols], \
                s.state.table_index("scaling_policy")
        if parts[:2] == ["scaling", "policy"] and len(parts) == 3:
            from ..acl import NS_READ_SCALING_POLICY
            p = s.scaling_policy_get(parts[2])
            if p is None:
                raise HTTPError(404, "scaling policy not found")
            require(acl.allow_namespace_operation(p.target_key()[0],
                                                  NS_READ_SCALING_POLICY))
            return to_api(p), s.state.table_index("scaling_policy")

        # ---- mesh intentions (the consul intentions API face)
        if parts == ["intentions"]:
            from ..integrations.services import ServiceIntention
            if method == "GET":
                require(ns == "*" or
                        acl.allow_namespace_operation(ns, NS_READ_JOB))
                out = []
                for i in s.intention_list(None if ns == "*" else ns):
                    # wildcard listing filters per item, like /v1/services
                    if ns == "*" and not acl.allow_namespace_operation(
                            i.namespace, NS_READ_JOB):
                        continue
                    out.append(to_api(i))
                return out, s.state.table_index("intentions")
            if method in ("PUT", "POST"):
                it = from_api(ServiceIntention, body)
                if "Namespace" not in body and "namespace" not in body:
                    # like the CSI endpoints: the ?namespace= query param
                    # scopes objects whose body omits it
                    if ns == "*":
                        # a literal "*" namespace would never match any
                        # authz check (namespaces don't wildcard) —
                        # reject instead of storing an inert rule
                        raise HTTPError(
                            400, "wildcard namespace invalid for writes")
                    it.namespace = ns
                require(acl.allow_namespace_operation(
                    it.namespace or "default", NS_SUBMIT_JOB))
                try:
                    return s.intention_upsert(it), None
                except ValueError as e:
                    raise HTTPError(400, str(e))
        if parts and parts[0] == "intention" and len(parts) == 3 and \
                method == "DELETE":
            require(acl.allow_namespace_operation(ns, NS_SUBMIT_JOB))
            from urllib.parse import unquote
            return s.intention_delete(ns, unquote(parts[1]),
                                      unquote(parts[2])), None

        # ---- native service catalog (the consul integration's API face)
        if parts == ["services"]:
            require(ns == "*" or acl.allow_namespace_operation(ns,
                                                               NS_READ_JOB))
            by_key: dict[tuple[str, str], list] = {}
            for inst in s.service_list(None if ns == "*" else ns):
                if ns == "*" and not acl.allow_namespace_operation(
                        inst.namespace, NS_READ_JOB):
                    continue
                by_key.setdefault((inst.namespace, inst.service_name),
                                  []).append(inst)
            return [{"Namespace": key[0], "ServiceName": key[1],
                     "Tags": sorted({t for i in insts for t in i.tags})}
                    for key, insts in sorted(by_key.items())], \
                s.state.table_index("services")
        if parts and parts[0] == "service" and len(parts) >= 2:
            require(acl.allow_namespace_operation(ns, NS_READ_JOB))
            name = urllib.parse.unquote(parts[1])
            insts = s.service_instances(ns, name)
            return [to_api(i) for i in insts], \
                s.state.table_index("services")

        # ---- CSI volumes + plugins (ref command/agent/csi_endpoint.go)
        if parts == ["volumes"]:
            from ..acl import NS_CSI_LIST_VOLUME, NS_CSI_WRITE_VOLUME
            from ..structs import CSIVolume, volume_stub
            if method == "GET":
                vols = [v for v in s.csi_volume_list(
                            None if ns == "*" else ns,
                            query.get("plugin_id") or None)
                        if acl.allow_namespace_operation(
                            v.namespace, NS_CSI_LIST_VOLUME)]
                return [volume_stub(v) for v in vols], \
                    s.state.table_index("csi_volumes")
            if method in ("PUT", "POST"):
                vols = [from_api(CSIVolume, v)
                        for v in body.get("Volumes", [])]
                for v in vols:
                    if not v.namespace:
                        v.namespace = ns
                    require(acl.allow_namespace_operation(
                        v.namespace, NS_CSI_WRITE_VOLUME))
                try:
                    return s.csi_volume_register(vols), None
                except ValueError as e:
                    raise HTTPError(400, str(e))
        if parts[:2] == ["volume", "csi"] and len(parts) >= 3:
            from ..acl import NS_CSI_READ_VOLUME, NS_CSI_WRITE_VOLUME
            from ..structs import CSIVolume
            vol_id = urllib.parse.unquote(parts[2])
            if method == "GET":
                require(acl.allow_namespace_operation(ns, NS_CSI_READ_VOLUME))
                vol = s.csi_volume_get(ns, vol_id)
                if vol is None:
                    raise HTTPError(404, f"volume {vol_id!r} not found")
                out = to_api(vol)
                # never serve mount secrets back out of the API
                # (ref csi_endpoint.go: Secrets redacted from reads)
                out.pop("Secrets", None)
                return out, s.state.table_index("csi_volumes")
            require(acl.allow_namespace_operation(ns, NS_CSI_WRITE_VOLUME))
            if parts[3:] == ["detach"] and method in ("PUT", "POST", "DELETE"):
                # ref csi_endpoint.go CSIVolume.Unpublish / DELETE
                # /v1/volume/csi/<id>/detach?node=<node_id>: release every
                # claim the volume holds for allocs on that node
                node_id = query.get("node", "")
                if not node_id:
                    raise HTTPError(400, "missing node")
                vol = s.csi_volume_get(ns, vol_id)
                if vol is None:
                    raise HTTPError(404, f"volume {vol_id!r} not found")
                from ..structs.csi import (CLAIM_STATE_READY_TO_FREE,
                                           CSIVolumeClaim)
                released = 0
                # each claim records the node it was taken for — compare
                # THAT, not a live-alloc lookup: GC'd allocs' claims must
                # only release when their own node matches
                all_claims = dict(vol.read_claims)
                all_claims.update(vol.write_claims)
                for aid, claim in all_claims.items():
                    if claim.node_id != node_id:
                        continue
                    s.csi_volume_claim(ns, vol_id, CSIVolumeClaim(
                        alloc_id=aid, node_id=node_id,
                        state=CLAIM_STATE_READY_TO_FREE))
                    released += 1
                return {"NumReleased": released}, None
            if method in ("PUT", "POST") and parts[3:] == []:
                vol = from_api(CSIVolume, body.get("Volume", body))
                vol.id = vol.id or vol_id
                if not vol.namespace:
                    vol.namespace = ns
                try:
                    return s.csi_volume_register([vol]), None
                except ValueError as e:
                    raise HTTPError(400, str(e))
            if method == "DELETE":
                force = query.get("force", "") in ("1", "true")
                try:
                    return s.csi_volume_deregister(ns, vol_id, force), None
                except ValueError as e:
                    raise HTTPError(400, str(e))
        if parts == ["plugins"]:
            require(acl.allow_plugin_list())
            from ..structs import plugin_stub
            return [plugin_stub(p) for p in s.csi_plugin_list()], \
                s.state.table_index("csi_plugins")
        if parts[:2] == ["plugin", "csi"] and len(parts) == 3:
            require(acl.allow_plugin_read())
            p = s.csi_plugin_get(parts[2])
            if p is None:
                raise HTTPError(404, "plugin not found")
            return to_api(p), s.state.table_index("csi_plugins")

        # ---- search (ref command/agent/search_endpoint.go)
        if parts == ["search"] and method in ("PUT", "POST"):
            return s.search_prefix(
                body.get("Prefix", ""), body.get("Context", "all") or "all",
                ns, acl), s.state.latest_index()
        if parts == ["search", "fuzzy"] and method in ("PUT", "POST"):
            return s.search_fuzzy(
                body.get("Text", ""), body.get("Context", "all") or "all",
                ns, acl), s.state.latest_index()

        # ---- jobspec utilities
        if parts == ["jobs", "parse"] and method in ("PUT", "POST"):
            from ..acl import NS_PARSE_JOB
            require(acl.allow_namespace_operation(ns, NS_PARSE_JOB))
            from ..jobspec import ParseError, parse as parse_jobspec
            from ..jobspec.hcl import HCLError
            try:
                job = parse_jobspec(body.get("JobHCL", ""),
                                    variables=body.get("Variables"))
            except (ParseError, HCLError) as e:
                raise HTTPError(400, str(e))
            return to_api(job), None
        if parts == ["validate", "job"] and method in ("PUT", "POST"):
            job = from_api(Job, body.get("Job", body))
            require(acl.allow_namespace_operation(
                job.namespace or ns, NS_SUBMIT_JOB))
            err = s._validate_job(job)
            return {"DriverConfigValidated": True,
                    "ValidationErrors": [err] if err else [],
                    "Error": err, "Warnings": ""}, None

        if parts == ["regions"]:
            # federated regions discovered via gossip when enabled
            if getattr(s, "gossip", None) is not None:
                return s.regions(), None
            return [self.agent.config.region], None
        if parts == ["status"]:
            # liveness + the overload/pressure block (docs/OVERLOAD.md) —
            # exempt from admission control above so operators can still
            # see a saturated server saturating
            return s.status_summary(), None
        if parts == ["status", "peers"]:
            peers = getattr(s.raft, "peers", None)
            if peers:
                return sorted(peers.values()), None
            return [s.rpc_addr if s.rpc_server is not None
                    else "127.0.0.1:4647"], None
        if parts == ["status", "leader"]:
            return "127.0.0.1:4647" if s.is_leader else "", None
        if parts == ["agent", "self"]:
            require(acl.allow_agent_read())
            return {"config": {"Server": {"Enabled": True},
                               "Client": {"Enabled": self.agent.client is not None},
                               "Version": self._version()},
                    "stats": self.agent.stats()}, None
        if parts == ["agent", "members"]:
            if getattr(s, "gossip", None) is not None:
                return {"Members": [{
                    "Name": m["name"], "Addr": m["host"],
                    "Port": m["port"], "Status": m["status"],
                    "Tags": m["tags"],
                } for m in s.members()]}, None
            cfg = s.operator_raft_configuration()
            return {"Members": [{
                "Name": sv["ID"], "Addr": sv["Address"].rsplit(":", 1)[0],
                "Port": int(sv["Address"].rsplit(":", 1)[1])
                if ":" in sv["Address"] else 0,
                "Status": "alive",
                "Tags": {"role": "nomad", "raft_vsn": sv["RaftProtocol"]},
                "Leader": sv["Leader"],
            } for sv in cfg["Servers"]]}, None
        if parts == ["agent", "join"] and method in ("PUT", "POST"):
            require(acl.allow_agent_write())
            addresses = query.get("address", [])
            if isinstance(addresses, str):     # direct callers pass one
                addresses = [addresses] if addresses else []
            if not addresses:
                raise HTTPError(400, "missing address")
            joined = 0
            errs = []
            # `name` applies only to a single-address join; with several
            # addresses every peer must get a distinct raft id or later
            # adds overwrite earlier ones
            name_q = query.get("name", "")
            for address in addresses:
                name = name_q if name_q and len(addresses) == 1 else address
                try:
                    s.operator_raft_add_peer(name, address)
                    joined += 1
                except ValueError as e:
                    errs.append(str(e))
            return {"num_joined": joined, "error": "; ".join(errs)}, None
        if parts == ["agent", "force-leave"] and method in ("PUT", "POST"):
            require(acl.allow_agent_write())
            node = query.get("node", "")
            if not node:
                raise HTTPError(400, "missing node")
            try:
                s.operator_raft_remove_peer(peer_id=node)
            except ValueError as e:
                raise HTTPError(400, str(e))
            return {}, None
        if parts[:2] == ["agent", "pprof"]:
            # ref command/agent/pprof/pprof.go — Python-runtime analogs
            require(acl.allow_agent_write())
            from .monitor import sample_stacks, thread_dump
            which = parts[2] if len(parts) > 2 else ""
            if which == "cmdline":
                import sys as _sys
                return RawResponse(" ".join(_sys.argv).encode()), None
            if which in ("goroutine", "threadcreate"):
                return RawResponse(thread_dump().encode()), None
            if which in ("profile", "trace"):
                secs = float(query.get("seconds", 1) or 1)
                return RawResponse(sample_stacks(secs).encode()), None
            raise HTTPError(404, f"unknown profile {which!r}")
        if parts == ["system", "reconcile", "summaries"] and \
                method in ("PUT", "POST"):
            require(acl.is_management())
            return s.reconcile_summaries(), None
        if parts == ["system", "gc"] and method in ("PUT", "POST"):
            require(acl.is_management())
            s.run_gc()
            return {}, None
        if parts and parts[0] == "traces":
            # eval-trace store (ISSUE 7): list + fetch-by-eval-id. Traces
            # live in THIS server's memory (the leader runs the evals);
            # reads are served locally, like /v1/metrics.
            require(acl.allow_agent_read())
            from ..obs import chrome_trace
            from ..obs import trace as obs_trace
            if len(parts) == 1 and method == "GET":
                try:
                    limit = int(query.get("limit", 200) or 200)
                except ValueError:
                    raise HTTPError(400, "invalid limit")
                return {"Traces": obs_trace.traces(limit),
                        "Stats": obs_trace.stats()}, None
            if len(parts) == 2 and method == "GET":
                ref = urllib.parse.unquote(parts[1])
                tr = obs_trace.get(ref)
                if tr is None:
                    raise HTTPError(404, f"no trace for {ref!r}")
                if query.get("format") == "chrome":
                    return RawResponse(
                        json.dumps(chrome_trace([tr])).encode(),
                        "application/json"), None
                return tr, None
        if parts == ["metrics"]:
            require(acl.allow_agent_read())
            if query.get("format") == "prometheus":
                # ref command/agent/http.go MetricsRequest: prometheus
                # exposition is opt-in via telemetry.prometheus_metrics
                if not self.agent.config.telemetry_prometheus:
                    raise HTTPError(
                        415, "prometheus format disabled "
                        "(telemetry.prometheus_metrics = false)")
                from ..metrics import metrics as reg
                stats = self.agent.stats()
                extra = {f"nomad_{k}": v for k, v in stats.items()
                         if isinstance(v, (int, float))}
                return RawResponse(
                    reg.prometheus(extra_gauges=extra).encode(),
                    "text/plain; version=0.0.4"), None
            return self.agent.stats(), None

        raise HTTPError(404, f"no handler for {method} {path}")

    def _version(self) -> str:
        from .. import __version__
        return __version__

    # ----------------------------------------------------------- client API

    def _handle_client(self, method: str, parts: list[str], query: dict,
                       body: Optional[dict], token: str):
        """/v1/client/* — node-local: fs, logs, stats, gc, alloc lifecycle
        (ref command/agent/fs_endpoint.go + alloc_endpoint.go; these hit the
        local client or are proxied server->client in the reference)."""
        c = self.agent.client
        if c is None:
            raise HTTPError(501, "agent is not running a client")
        body = body or {}

        # ACL: resolve through the server when present (client-only agents
        # resolve via server RPC in the reference; dev agents are combined)
        from ..acl import (
            NS_ALLOC_EXEC, NS_ALLOC_LIFECYCLE, NS_READ_FS, NS_READ_JOB,
            NS_READ_LOGS,
        )
        if self.server is not None:
            acl = self.resolve_acl(token)
        elif self.agent.config.acl_enabled:
            # fail closed: a client-only agent cannot resolve tokens until
            # server-RPC token resolution lands (the reference resolves via
            # its servers, client/acl.go)
            raise HTTPError(501, "ACL token resolution requires a server")
        else:
            acl = None

        def ns_require(alloc_id: str, cap: str) -> None:
            if acl is None:
                return
            try:
                ns = c.alloc_namespace(alloc_id)
            except KeyError:
                raise HTTPError(404, f"unknown allocation {alloc_id!r}")
            require(acl.allow_namespace_operation(ns, cap))

        try:
            if parts == ["stats"]:
                if acl is not None:
                    require(acl.allow_node_read())
                return c.host_stats(), None
            if parts == ["gc"] and method in ("PUT", "POST"):
                if acl is not None:
                    require(acl.allow_node_write())
                return {"Collected": c.gc_all()}, None

            if len(parts) >= 2 and parts[0] == "allocation":
                alloc_id, rest = parts[1], parts[2:]
                if rest == ["stats"]:
                    ns_require(alloc_id, NS_READ_JOB)
                    return c.alloc_stats(alloc_id), None
                if rest == ["signal"] and method in ("PUT", "POST"):
                    ns_require(alloc_id, NS_ALLOC_LIFECYCLE)
                    c.alloc_signal(alloc_id, body.get("Task", ""),
                                   body.get("Signal", "SIGUSR1"))
                    return {}, None
                if rest == ["restart"] and method in ("PUT", "POST"):
                    ns_require(alloc_id, NS_ALLOC_LIFECYCLE)
                    c.alloc_restart(alloc_id, body.get("TaskName",
                                                       body.get("Task", "")))
                    return {}, None
                if rest == ["gc"] and method in ("PUT", "POST"):
                    ns_require(alloc_id, NS_ALLOC_LIFECYCLE)
                    c.gc_alloc(alloc_id)
                    return {}, None
                if rest == ["exec"] and method in ("PUT", "POST"):
                    # interactive exec (ref api/allocations_exec.go; the
                    # reference streams over websocket — here a session
                    # API: open, then stdin/output round-trips)
                    ns_require(alloc_id, NS_ALLOC_EXEC)
                    sid = c.alloc_exec_start(
                        alloc_id, body.get("Task", ""),
                        body.get("Cmd", []) or body.get("Command", []),
                        tty=bool(body.get("Tty", False)))
                    return {"SessionID": sid}, None

            if len(parts) >= 2 and parts[0] == "exec-session":
                import base64
                sid = parts[1]
                # session ids are unguessable capabilities minted by an
                # exec-capability-checked open; stream ops ride on that
                if method == "DELETE":
                    c.alloc_exec_close(sid)
                    return {}, None
                if method in ("PUT", "POST"):
                    if "Stdin" in body:
                        c.alloc_exec_stdin(
                            sid, base64.b64decode(body["Stdin"]))
                    if body.get("StdinEOF"):
                        c.alloc_exec_stdin_close(sid)
                    if "TTYSize" in body:
                        sz = body["TTYSize"]
                        c.alloc_exec_resize(sid, int(sz.get("Rows", 24)),
                                            int(sz.get("Cols", 80)))
                    return {}, None
                out = c.alloc_exec_output(
                    sid, wait=float(query.get("wait", 1.0) or 1.0))
                return {"Stdout": base64.b64encode(
                            out["stdout"]).decode(),
                        "Stderr": base64.b64encode(
                            out["stderr"]).decode(),
                        "Exited": out["exited"],
                        "ExitCode": out["exit_code"]}, None

            if len(parts) >= 2 and parts[0] == "fs":
                op, alloc_id = parts[1], parts[2] if len(parts) > 2 else ""
                if not alloc_id:
                    raise HTTPError(400, "missing allocation id")
                path_q = query.get("path", "/")
                offset = int(query.get("offset", 0) or 0)
                limit = int(query.get("limit", -1) or -1)
                if op == "ls":
                    ns_require(alloc_id, NS_READ_FS)
                    return c.fs_list(alloc_id, path_q), None
                if op == "stat":
                    ns_require(alloc_id, NS_READ_FS)
                    return c.fs_stat(alloc_id, path_q), None
                if op in ("cat", "readat"):
                    ns_require(alloc_id, NS_READ_FS)
                    data = c.fs_read(alloc_id, path_q, offset, limit)
                    return RawResponse(data), None
                if op == "logs":
                    ns_require(alloc_id, NS_READ_LOGS)
                    if str(query.get("follow", "")).lower() == "true":
                        data, nxt = c.fs_logs_follow(
                            alloc_id, query.get("task", ""),
                            query.get("type", "stdout"), offset,
                            wait=float(query.get("wait", 10.0) or 10.0))
                        return {"Data": __import__("base64").b64encode(
                                    data).decode(),
                                "Offset": nxt}, None
                    data = c.fs_logs(
                        alloc_id, query.get("task", ""),
                        query.get("type", "stdout"), offset,
                        query.get("origin", "start"), limit)
                    return RawResponse(data), None
        except KeyError as e:
            raise HTTPError(404, str(e))
        except (ValueError, OSError) as e:
            raise HTTPError(400, str(e))
        raise HTTPError(404, f"no client handler for {'/'.join(parts)}")

    # ------------------------------------------------------------------ ACL

    def _handle_acl(self, method: str, parts: list[str],
                    body: dict, token: str, acl):
        """/v1/acl/* routes (ref command/agent/acl_endpoint.go)."""
        from ..server.acl_endpoint import (
            ACLDisabledError, PermissionDeniedError,
        )
        from ..structs import ACLPolicy, ACLToken
        s = self.server

        try:
            if parts == ["bootstrap"] and method in ("PUT", "POST"):
                return self._token_api(s.acl.bootstrap(),
                                       secret=True), None
            if parts == ["policies"] and method == "GET":
                require(acl.is_management())
                return [{"Name": p.name, "Description": p.description,
                         "CreateIndex": p.create_index,
                         "ModifyIndex": p.modify_index}
                        for p in s.state.iter_acl_policies()], \
                    s.state.table_index("acl_policy")
            if parts and parts[0] == "policy" and len(parts) == 2:
                name = parts[1]
                require(acl.is_management())
                if method == "GET":
                    pol = s.state.acl_policy_by_name(name)
                    if pol is None:
                        raise HTTPError(404, "policy not found")
                    return {"Name": pol.name,
                            "Description": pol.description,
                            "Rules": pol.rules,
                            "CreateIndex": pol.create_index,
                            "ModifyIndex": pol.modify_index}, None
                if method in ("PUT", "POST"):
                    pol = ACLPolicy(name=name,
                                    description=body.get("Description", ""),
                                    rules=body.get("Rules", ""))
                    try:
                        s.acl.upsert_policies([pol])
                    except ValueError as e:
                        raise HTTPError(400, str(e))
                    return {}, None
                if method == "DELETE":
                    s.acl.delete_policies([name])
                    return {}, None
            if parts == ["tokens"] and method == "GET":
                require(acl.is_management())
                return [self._token_api(t)
                        for t in s.state.iter_acl_tokens()], \
                    s.state.table_index("acl_token")
            if parts == ["token"] and method in ("PUT", "POST"):
                require(acl.is_management())
                tok = ACLToken(
                    name=body.get("Name", ""),
                    type=body.get("Type", "client"),
                    policies=body.get("Policies", []) or [],
                    global_=bool(body.get("Global", False)))
                try:
                    created = s.acl.upsert_tokens([tok])
                except ValueError as e:
                    raise HTTPError(400, str(e))
                return self._token_api(created[0], secret=True), None
            if parts and parts[0] == "token" and len(parts) == 2:
                if parts[1] == "self":
                    tok = s.state.acl_token_by_secret(token)
                    if tok is None:
                        raise HTTPError(403, "ACL token not found")
                    return self._token_api(tok, secret=True), None
                require(acl.is_management())
                tok = s.state.acl_token_by_accessor(parts[1])
                if method == "GET":
                    if tok is None:
                        raise HTTPError(404, "token not found")
                    return self._token_api(tok, secret=True), None
                if method in ("PUT", "POST"):
                    upd = ACLToken(
                        accessor_id=parts[1],
                        name=body.get("Name", ""),
                        type=body.get("Type", "client"),
                        policies=body.get("Policies", []) or [],
                        global_=bool(body.get("Global", False)))
                    try:
                        out = s.acl.upsert_tokens([upd])
                    except ValueError as e:
                        raise HTTPError(400, str(e))
                    return self._token_api(out[0], secret=True), None
                if method == "DELETE":
                    if tok is None:
                        raise HTTPError(404, "token not found")
                    s.acl.delete_tokens([parts[1]])
                    return {}, None
        except ACLDisabledError as e:
            raise HTTPError(400, str(e))
        except PermissionDeniedError as e:
            raise HTTPError(403, str(e))
        raise HTTPError(404, "no such ACL endpoint")

    def _token_api(self, tok, secret: bool = False) -> dict:
        out = {
            "AccessorID": tok.accessor_id, "Name": tok.name,
            "Type": tok.type, "Policies": list(tok.policies),
            "Global": tok.global_, "CreateTime": tok.create_time_unix,
            "CreateIndex": tok.create_index, "ModifyIndex": tok.modify_index,
        }
        if secret:
            out["SecretID"] = tok.secret_id
        return out

    def _ns_api(self, n: dict) -> dict:
        return {"Name": n.get("name", ""),
                "Description": n.get("description", "")}

    # ------------------------------------------------------------- stubs

    # builders live in api_codec so the Read.List RPC serves the exact
    # same shapes (the follower-read differential is bit-exact by
    # construction, ISSUE 16)

    def _job_stub(self, j) -> dict:
        from ..api_codec import job_stub
        return job_stub(j, self.server.state.job_summary(j.namespace, j.id))

    def _alloc_stub(self, a) -> dict:
        from ..api_codec import alloc_stub
        return alloc_stub(a)

    def _node_stub(self, n) -> dict:
        from ..api_codec import node_stub
        return node_stub(n)


def make_http_server(api: HTTPAPI, host: str = "127.0.0.1",
                     port: int = 4646) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        # chunked transfer (event stream) requires HTTP/1.1 framing
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # quiet
            pass

        def _do(self, method: str) -> None:
            parsed = urllib.parse.urlparse(self.path)
            if method == "GET" and (parsed.path in ("/", "/ui")
                                    or parsed.path.startswith("/ui/")):
                self._serve_ui(parsed.path)
                return
            if parsed.path == "/v1/event/stream" and method == "GET":
                self._event_stream(parsed)
                return
            if parsed.path == "/v1/agent/monitor" and method == "GET":
                self._monitor_stream(parsed)
                return
            # single-value collapse, except repeatable params (the
            # reference accepts ?address=...&address=... on agent/join)
            query = {k: (v if k == "address" else v[0]) for k, v in
                     urllib.parse.parse_qs(parsed.query).items()}
            body = None
            raw = b""
            length = int(self.headers.get("Content-Length", 0) or 0)
            if length:
                raw = self.rfile.read(length)
                if parsed.path == "/v1/operator/snapshot":
                    body = {"_raw": raw}   # binary passthrough
                else:
                    try:
                        body = json.loads(raw) if raw else None
                    except json.JSONDecodeError:
                        self._respond(400, {"error": "invalid JSON body"})
                        return
            token = self.headers.get("X-Nomad-Token", "") or \
                query.get("token", "")
            try:
                payload, index = api.handle(method, parsed.path, query, body,
                                            token=token)
            except HTTPError as e:
                headers = {}
                if e.retry_after:
                    # admission rejection: tell the caller WHEN a retry
                    # can succeed (fractional seconds are legal per RFC
                    # 9110 delta-seconds rounding up; the Python client
                    # parses either form)
                    headers["Retry-After"] = f"{max(0.001, e.retry_after):.3f}"
                self._respond(e.code, {"error": e.message}, headers)
                return
            except (KeyError,) as e:
                self._respond(404, {"error": str(e)})
                return
            except LeadershipLostError as e:
                # appended but uncommitted when leadership moved: the
                # write MAY still land — forwarding would risk applying
                # it twice (ref hashicorp/raft ErrLeadershipLost)
                self._respond(500, {"error": str(e)})
                return
            except NotLeaderError as e:
                # transparent follower->leader forwarding (ref
                # nomad/rpc.go forward — theirs rides RPC, ours proxies
                # the HTTP request to the leader's advertised HTTP addr
                # from gossip tags). One hop only: a forwarded request
                # that STILL lands on a non-leader (election in flight)
                # surfaces the error to the caller, who retries.
                if self.headers.get("X-Nomad-Forwarded"):
                    self._respond(500, {"error": str(e)})
                    return
                target = ""
                srv = api.server
                if srv is not None:
                    target = srv.leader_http_addr()
                if not target:
                    self._respond(500, {"error": str(e)})
                    return
                try:
                    self._proxy_to_leader(target, method, parsed, raw,
                                          token)
                except Exception as pe:     # noqa: BLE001
                    self._respond(
                        500, {"error": f"leader forward failed: {pe}"})
                return
            except Exception as e:      # noqa: BLE001
                self._respond(500, {"error": repr(e)})
                return
            headers = {}
            if index is not None:
                headers["X-Nomad-Index"] = str(index)
            srv = api.server
            if method == "GET" and srv is not None:
                # staleness stamping (ISSUE 16): provable QueryMeta on
                # every read — KnownLeader=False flags an election in
                # flight (LastIndex may lag an unreachable majority);
                # Stale=true means a follower's local store served this
                known = srv.is_leader or bool(srv.leader_rpc_addr)
                headers["X-Nomad-KnownLeader"] = \
                    "true" if known else "false"
                headers["X-Nomad-Stale"] = \
                    "false" if srv.is_leader else "true"
            self._respond(200, payload, headers)

        def _serve_ui(self, path: str) -> None:
            """Single-page web UI (ref ui/ — Ember SPA; here a static
            vanilla-JS app over the same REST API)."""
            if path == "/":
                self.send_response(307)
                self.send_header("Location", "/ui")
                self.end_headers()
                return
            import importlib.resources as res
            try:
                html = (res.files("nomad_tpu_torch.ui") / "index.html").read_bytes()
            except (OSError, ModuleNotFoundError):
                self._respond(404, {"error": "UI assets unavailable"})
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(html)))
            self.end_headers()
            self.wfile.write(html)

        def _monitor_stream(self, parsed) -> None:
            """Live log streaming (ref command/agent/monitor: the
            /v1/agent/monitor chunked response of hclog lines)."""
            import queue as _queue
            q = urllib.parse.parse_qs(parsed.query)
            level = q.get("log_level", ["info"])[0]
            token = self.headers.get("X-Nomad-Token", "") or \
                q.get("token", [""])[0]
            if api.server is not None:
                try:
                    acl = api.resolve_acl(token)
                except HTTPError as e:
                    self._respond(e.code, {"error": e.message})
                    return
                if not acl.allow_agent_read():
                    self._respond(403, {"error": "Permission denied"})
                    return
            elif api.agent.config.acl_enabled:
                # fail closed like _handle_client: a client-only agent cannot
                # resolve tokens, so monitor must not leak live logs (the
                # reference requires agent:read for /v1/agent/monitor)
                self._respond(
                    501, {"error": "ACL token resolution requires a server"})
                return
            sub = api.agent.monitor.subscribe(level=level)
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write_chunk(data: bytes) -> None:
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()
            try:
                while True:
                    try:
                        line = sub.get(timeout=10.0)
                        payload = json.dumps({"Data": line}).encode() + b"\n"
                    except _queue.Empty:
                        payload = b"{}\n"   # heartbeat keeps conn alive
                    write_chunk(payload)
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass
            finally:
                api.agent.monitor.unsubscribe(sub)

        def _event_stream(self, parsed) -> None:
            """Long-lived ndjson stream of state events
            (ref command/agent/event_endpoint.go EventStream)."""
            from ..server.event_broker import SubscriptionClosedError
            q = urllib.parse.parse_qs(parsed.query)
            topics: dict[str, list[str]] = {}
            for spec in q.get("topic", []):
                topic, _, key = spec.partition(":")
                topics.setdefault(topic, []).append(key or "*")
            try:
                index = int(q.get("index", ["0"])[0] or 0)
            except ValueError:
                self._respond(400, {"error": "invalid index"})
                return
            # default namespace matches the rest of the API; "*" = all
            namespace = q.get("namespace", ["default"])[0]
            if namespace == "*":
                namespace = ""
            token = self.headers.get("X-Nomad-Token", "") or \
                q.get("token", [""])[0]
            from ..acl import NS_READ_JOB
            try:
                acl = api.resolve_acl(token)
            except HTTPError as e:
                self._respond(e.code, {"error": e.message})
                return
            if not (acl.is_management()
                    or (namespace and acl.allow_namespace_operation(
                        namespace, NS_READ_JOB))):
                self._respond(403, {"error": "Permission denied"})
                return
            # Node events are namespace-less; without node:read they must
            # not leak onto a namespace-scoped stream
            if not acl.allow_node_read():
                if "Node" in topics:
                    self._respond(403, {"error": "Permission denied"})
                    return
                if "*" in topics:
                    keys = topics.pop("*")
                    for t in ("Job", "Evaluation", "Allocation",
                              "Deployment"):
                        topics.setdefault(t, list(keys))
            broker = api.server.event_broker
            sub = broker.subscribe(topics=topics, index=index,
                                   namespace=namespace)
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write_chunk(data: bytes) -> None:
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

            try:
                idle = 0.0
                while True:
                    got = sub.next_events(timeout=1.0)
                    if got is None:
                        idle += 1.0
                        if idle >= 10.0:      # heartbeat (ref: newline ping)
                            write_chunk(b"{}\n")
                            idle = 0.0
                        continue
                    idle = 0.0
                    bidx, events = got
                    line = json.dumps({
                        "Index": bidx,
                        "Events": [e.to_api() for e in events]})
                    write_chunk(line.encode() + b"\n")
            except SubscriptionClosedError:
                try:
                    write_chunk(json.dumps(
                        {"Error": "subscription closed by server"}).encode()
                        + b"\n")
                    write_chunk(b"")
                except OSError:
                    pass
            except OSError:
                pass       # client went away
            finally:
                sub.close()

        def _proxy_to_leader(self, target: str, method: str, parsed,
                             raw: bytes, token: str) -> None:
            """Replay this request against the leader's HTTP surface and
            stream its response back verbatim (status, index, body)."""
            import urllib.error
            import urllib.request
            url = f"http://{target}{parsed.path}"
            if parsed.query:
                url += f"?{parsed.query}"
            req = urllib.request.Request(
                url, data=raw if raw else None, method=method)
            req.add_header("X-Nomad-Forwarded", "1")
            if token:
                req.add_header("X-Nomad-Token", token)
            ctype = self.headers.get("Content-Type")
            if ctype:
                req.add_header("Content-Type", ctype)
            try:
                # must out-wait the leader's raft apply timeout (30s,
                # raft.py apply) — a proxy timeout at exactly 30s would
                # report a slow-but-committing write as failed and
                # invite a duplicating retry
                resp = urllib.request.urlopen(req, timeout=45)
            except urllib.error.HTTPError as e:
                resp = e                 # pass error statuses through too
            with resp:
                data = resp.read()       # fully read BEFORE any response
            try:
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.headers.get(
                    "Content-Type", "application/json"))
                self.send_header("Content-Length", str(len(data)))
                idx = resp.headers.get("X-Nomad-Index")
                if idx:
                    self.send_header("X-Nomad-Index", idx)
                self.end_headers()
                self.wfile.write(data)
            except OSError:
                # client went away mid-write: the response has started,
                # so the caller's except must NOT send a second one
                pass

        def _respond(self, code: int, payload, headers=None) -> None:
            if isinstance(payload, RawResponse):
                data = payload.data
                ctype = payload.content_type
            else:
                data = json.dumps(payload).encode()
                ctype = "application/json"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._do("GET")

        def do_PUT(self):
            self._do("PUT")

        def do_POST(self):
            self._do("POST")

        def do_DELETE(self):
            self._do("DELETE")

    return ThreadingHTTPServer((host, port), Handler)
