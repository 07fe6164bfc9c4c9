"""Dataclass <-> API JSON codec (ref api/ SDK types + command/agent JSON
encoding): snake_case Python fields map to the reference API's PascalCase
names (ID, TaskGroups, MemoryMB, ...) so clients of the reference find the
shapes they expect.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Optional, get_args, get_origin, get_type_hints

_ACRONYMS = {
    "id": "ID", "cpu": "CPU", "mb": "MB", "ttl": "TTL", "dc": "DC",
    "dcs": "DCs", "ip": "IP", "dns": "DNS", "url": "URL", "acl": "ACL",
    "csi": "CSI", "cidr": "CIDR", "tg": "TG", "gc": "GC", "os": "OS",
    "http": "HTTP", "api": "API",
}


def pascal(name: str) -> str:
    parts = name.split("_")
    out = []
    for p in parts:
        out.append(_ACRONYMS.get(p, p.capitalize()))
    return "".join(out)


def to_api(obj: Any) -> Any:
    """Recursively encode dataclasses to API-shaped dicts."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            if f.name.startswith("_"):      # internal caches, not API shape
                continue
            val = getattr(obj, f.name)
            out[pascal(f.name)] = to_api(val)
        return out
    if isinstance(obj, dict):
        return {k: to_api(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_api(v) for v in obj]
    if isinstance(obj, bytes):
        import base64
        return base64.b64encode(obj).decode()
    return obj


def _strip_optional(tp):
    if get_origin(tp) is typing.Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def from_api(cls, data: Any) -> Any:
    """Recursively decode API-shaped dicts into dataclass `cls`.

    Accepts both PascalCase and snake_case keys; unknown keys are ignored
    (forward compatibility, like the reference's codec)."""
    cls = _strip_optional(cls)
    if data is None:
        return None
    origin = get_origin(cls)
    if origin in (list, tuple):
        (item_t,) = get_args(cls)[:1] or (Any,)
        seq = [from_api(item_t, v) for v in data]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        args = get_args(cls)
        val_t = args[1] if len(args) == 2 else Any
        return {k: from_api(val_t, v) for k, v in data.items()}
    if dataclasses.is_dataclass(cls):
        if not isinstance(data, dict):
            return data
        hints = get_type_hints(cls)
        lookup = {}
        for f in dataclasses.fields(cls):
            if f.name.startswith("_") or not f.init:
                continue
            lookup[pascal(f.name)] = f
            lookup[f.name] = f
        kwargs = {}
        for key, val in data.items():
            f = lookup.get(key)
            if f is None:
                continue
            kwargs[f.name] = from_api(hints.get(f.name, Any), val)
        return cls(**kwargs)
    if cls is bytes and isinstance(data, str):
        import base64
        return base64.b64decode(data)
    if cls in (int, float) and isinstance(data, (int, float)):
        return cls(data)
    return data


# --------------------------------------------------------------- list stubs
#
# Shared stub builders for the list hot paths (ref api/jobs.go JobListStub,
# api/allocations.go AllocationListStub, api/nodes.go NodeListStub). Both
# the agent HTTP layer and the Read.List RPC serve these, so the follower
# stale-read differential (leader vs follower payload at the same index)
# is bit-exact by construction.

def job_stub(j, summary=None) -> dict:
    return {
        "ID": j.id, "Name": j.name, "Namespace": j.namespace,
        "Type": j.type, "Priority": j.priority, "Status": j.status,
        "StatusDescription": j.status_description, "Stop": j.stop,
        "JobSummary": to_api(summary) if summary else None,
        "Version": j.version, "SubmitTime": j.submit_time,
        "CreateIndex": j.create_index, "ModifyIndex": j.modify_index,
    }


def alloc_stub(a) -> dict:
    # AllocatedCPU/AllocatedMemoryMB: rollups the reference's stub
    # carries via AllocatedResources on the full alloc; the topology
    # view needs per-node utilization without N full-alloc fetches
    cpu = mem = 0
    if a.allocated_resources is not None:
        for tr in a.allocated_resources.tasks.values():
            cpu += tr.cpu_shares
            mem += tr.memory_mb
    return {
        "ID": a.id, "Name": a.name, "Namespace": a.namespace,
        "EvalID": a.eval_id, "NodeID": a.node_id, "NodeName": a.node_name,
        "JobID": a.job_id, "JobVersion": a.job.version if a.job else 0,
        "TaskGroup": a.task_group,
        "DesiredStatus": a.desired_status,
        "DesiredDescription": a.desired_description,
        "ClientStatus": a.client_status,
        "DeploymentID": a.deployment_id,
        "FollowupEvalID": a.follow_up_eval_id,
        "TaskStates": to_api(a.task_states),
        "AllocatedCPU": cpu, "AllocatedMemoryMB": mem,
        "CreateIndex": a.create_index, "ModifyIndex": a.modify_index,
        "CreateTime": a.create_time_unix, "ModifyTime": a.modify_time_unix,
    }


def node_stub(n) -> dict:
    return {
        "ID": n.id, "Name": n.name, "Datacenter": n.datacenter,
        "NodeClass": n.node_class, "Status": n.status,
        "SchedulingEligibility": n.scheduling_eligibility,
        "Drain": n.drain, "Drivers": to_api(n.drivers),
        "Address": n.http_addr,
        "CreateIndex": n.create_index, "ModifyIndex": n.modify_index,
    }


# ------------------------------------------------------------ columnar mode
#
# Struct-of-arrays list encoding for fleet-dashboard list storms (ISSUE 16):
# one field manifest + one column per field instead of repeating every key
# in every row. JSON-only — the container has no msgpack — but the shape is
# codec-agnostic (a msgpack writer would serialize the same envelope).

COLUMNAR_VERSION = "v1"
COLUMNAR_MARKER = "_Columnar"


def project_fields(rows: list[dict], fields) -> list[dict]:
    """Server-side stub-field projection: keep only `fields` (iterable of
    API field names) in each row. Unknown names are ignored; None/empty
    means no projection."""
    if not fields:
        return rows
    keep = set(fields)
    return [{k: v for k, v in row.items() if k in keep} for row in rows]


def to_columnar(rows: list[dict]) -> dict:
    """Encode a list of API-shaped dicts as struct-of-arrays. The field
    manifest is the sorted union of row keys; rows missing a field get
    None (decode round-trips it as an absent-ish null, matching what the
    projection path produces)."""
    manifest: list[str] = sorted({k for row in rows for k in row})
    columns = [[row.get(f) for row in rows] for f in manifest]
    return {COLUMNAR_MARKER: COLUMNAR_VERSION, "Count": len(rows),
            "Fields": manifest, "Columns": columns}


def is_columnar(doc: Any) -> bool:
    return isinstance(doc, dict) and doc.get(COLUMNAR_MARKER) is not None


def from_columnar(doc: dict) -> list[dict]:
    """Decode a columnar envelope back to row dicts (inverse of
    to_columnar up to key order)."""
    if doc.get(COLUMNAR_MARKER) != COLUMNAR_VERSION:
        raise ValueError(
            f"unknown columnar version: {doc.get(COLUMNAR_MARKER)!r}")
    fields, columns = doc.get("Fields", []), doc.get("Columns", [])
    if len(fields) != len(columns):
        raise ValueError("columnar manifest/column count mismatch")
    count = doc.get("Count", 0)
    if any(len(col) != count for col in columns):
        raise ValueError("columnar column length mismatch")
    return [{f: columns[ci][ri] for ci, f in enumerate(fields)}
            for ri in range(count)]
