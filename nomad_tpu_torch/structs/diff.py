"""Job diff for `job plan` (behavioral ref nomad/structs/diff.go — a field-
level diff of two job versions with Added/Deleted/Edited annotations,
grouped by task group and task).

Implemented as a generic recursive diff over the API (PascalCase dict)
representation rather than hand-written per-struct methods: the dataclass
model is uniform enough that one walker covers the whole tree.
"""
from __future__ import annotations

from typing import Any, Optional

from ..api_codec import to_api

DIFF_NONE = "None"
DIFF_ADDED = "Added"
DIFF_DELETED = "Deleted"
DIFF_EDITED = "Edited"

# fields excluded from diffs (server-maintained bookkeeping)
_IGNORED = {
    "Id", "ID", "Status", "StatusDescription", "Version", "SubmitTime",
    "CreateIndex", "ModifyIndex", "JobModifyIndex", "Stable", "Stop",
    "Dispatched", "ParentId", "ParentID", "NomadTokenId", "NomadTokenID",
    "VaultToken", "ConsulToken", "Payload",
}


def _scalar(v) -> bool:
    return not isinstance(v, (dict, list))


def _fmt(v) -> str:
    from ..jobspec.hcl import _to_string
    return _to_string(v)


def _field_diff(name: str, old, new, contextual: bool = False
                ) -> Optional[dict]:
    if old == new or (old in (None, "", 0, False, [], {})
                      and new in (None, "", 0, False, [], {})):
        if not contextual:
            return None
        # contextual mode (ref diff.go fieldDiff w/ contextual=true):
        # unchanged fields appear with Type None so `plan -verbose` can
        # show the full object, not just the delta.
        return {"Type": DIFF_NONE, "Name": name,
                "Old": _fmt(old), "New": _fmt(new)}
    typ = DIFF_EDITED
    if old in (None, "", [], {}):
        typ = DIFF_ADDED
    elif new in (None, "", [], {}):
        typ = DIFF_DELETED
    return {"Type": typ, "Name": name, "Old": _fmt(old), "New": _fmt(new)}


def _object_diff(name: str, old: Optional[dict], new: Optional[dict],
                 contextual: bool = False) -> Optional[dict]:
    """Diff two API dicts into {Type, Name, Fields, Objects}."""
    old = old or {}
    new = new or {}
    fields, objects = [], []
    changed = False
    for key in sorted(set(old) | set(new)):
        if key in _IGNORED:
            continue
        ov, nv = old.get(key), new.get(key)
        if _scalar(ov) and _scalar(nv):
            fd = _field_diff(key, ov, nv, contextual)
            if fd:
                fields.append(fd)
                changed = changed or fd["Type"] != DIFF_NONE
        elif isinstance(ov, dict) or isinstance(nv, dict):
            od = _object_diff(key, ov if isinstance(ov, dict) else None,
                              nv if isinstance(nv, dict) else None,
                              contextual)
            if od:
                objects.append(od)
                changed = changed or od["Type"] != DIFF_NONE
        else:   # lists
            ods = _list_diff(key, ov or [], nv or [], contextual)
            if ods:
                objects.extend(ods)
                changed = changed or any(
                    o["Type"] != DIFF_NONE for o in ods)
    if not changed:
        if not (contextual and (fields or objects)):
            return None
        return {"Type": DIFF_NONE, "Name": name, "Fields": fields,
                "Objects": objects}
    typ = DIFF_EDITED
    if not old:
        typ = DIFF_ADDED
    elif not new:
        typ = DIFF_DELETED
    return {"Type": typ, "Name": name, "Fields": fields, "Objects": objects}


_IDENTITY_KEYS = ("Name", "Label", "Value", "LTarget", "Attribute",
                  "GetterSource", "DestPath", "Volume")


def _list_key(item) -> str:
    if isinstance(item, dict):
        for k in _IDENTITY_KEYS:
            if item.get(k):
                return str(item[k])
        return str(sorted(item.items()))
    return str(item)


def _has_identity(item) -> bool:
    return isinstance(item, dict) and any(
        item.get(k) for k in _IDENTITY_KEYS)


def _list_diff(name: str, old: list, new: list,
               contextual: bool = False) -> list[dict]:
    """Diff element lists keyed by a natural identity field."""
    out = []
    if all(_scalar(x) for x in old + new):
        olds, news = set(map(str, old)), set(map(str, new))
        for v in sorted(olds - news):
            out.append({"Type": DIFF_DELETED, "Name": name,
                        "Fields": [{"Type": DIFF_DELETED, "Name": name,
                                    "Old": v, "New": ""}], "Objects": []})
        for v in sorted(news - olds):
            out.append({"Type": DIFF_ADDED, "Name": name,
                        "Fields": [{"Type": DIFF_ADDED, "Name": name,
                                    "Old": "", "New": v}], "Objects": []})
        if contextual:
            for v in sorted(olds & news):
                out.append({"Type": DIFF_NONE, "Name": name,
                            "Fields": [{"Type": DIFF_NONE, "Name": name,
                                        "Old": v, "New": v}],
                            "Objects": []})
        return out
    om = {_list_key(x): x for x in old}
    nm = {_list_key(x): x for x in new}
    both = set(om) & set(nm)
    for key in sorted(both):
        od = _object_diff(name, om[key], nm[key], contextual)
        if od:
            out.append(od)
    # identity-LESS items (networks, unnamed checks) fall back to
    # content keys, where ANY edit changes the key: pair the leftover
    # old/new items by field similarity so an edit renders as ONE
    # Edited object with field-level deltas — the nested granularity
    # `nomad plan` shows. Items that DO carry a natural identity
    # (Name/Label/...) are never similarity-paired: a renamed service
    # is a destroy+create in the reference's keyed diffs (diff.go),
    # and rendering it as an in-place edit would hide that.
    left_old = [om[k] for k in sorted(set(om) - both)]
    left_new = [nm[k] for k in sorted(set(nm) - both)]
    used_new: set[int] = set()
    pairs: list[tuple] = []
    for o in left_old:
        best, best_sim = -1, 0.0
        if not _has_identity(o):
            for j, n in enumerate(left_new):
                if j in used_new or _has_identity(n):
                    continue
                sim = _similarity(o, n)
                if sim > best_sim:
                    best_sim, best = sim, j
        if best >= 0 and best_sim >= 0.5:
            used_new.add(best)
            pairs.append((o, left_new[best]))
        else:
            pairs.append((o, None))
    pairs += [(None, n) for j, n in enumerate(left_new)
              if j not in used_new]
    for o, n in pairs:
        od = _object_diff(name, o, n, contextual)
        if od:
            out.append(od)
    return out


def _similarity(a, b) -> float:
    """Fraction of (deep-)equal fields across the union of keys."""
    if not isinstance(a, dict) or not isinstance(b, dict):
        return 1.0 if a == b else 0.0
    keys = (set(a) | set(b)) - _IGNORED
    if not keys:
        return 1.0
    return sum(1 for k in keys if a.get(k) == b.get(k)) / len(keys)


def task_diff(old: Optional[dict], new: Optional[dict],
              contextual: bool = False) -> Optional[dict]:
    name = (new or old or {}).get("Name", "")
    d = _object_diff("Task", old, new, contextual)
    if d is None:
        return None
    d["Name"] = name
    d["Annotations"] = []
    return d


def task_group_diff(old: Optional[dict], new: Optional[dict],
                    contextual: bool = False) -> Optional[dict]:
    name = (new or old or {}).get("Name", "")
    old, new = dict(old or {}), dict(new or {})
    old_tasks = {t.get("Name"): t for t in old.pop("Tasks", None) or []}
    new_tasks = {t.get("Name"): t for t in new.pop("Tasks", None) or []}
    d = _object_diff("Group", old or None, new or None, contextual) or \
        {"Type": DIFF_NONE, "Name": "Group", "Fields": [], "Objects": []}
    tasks = []
    for tname in sorted(set(old_tasks) | set(new_tasks)):
        td = task_diff(old_tasks.get(tname), new_tasks.get(tname),
                       contextual)
        if td:
            tasks.append(td)
    if d["Type"] == DIFF_NONE and not contextual and \
            not any(t["Type"] != DIFF_NONE for t in tasks):
        return None
    typ = d["Type"]
    if not old and new:
        typ = DIFF_ADDED
    elif old and not new:
        typ = DIFF_DELETED
    elif typ == DIFF_NONE and any(t["Type"] != DIFF_NONE for t in tasks):
        typ = DIFF_EDITED
    return {"Type": typ, "Name": name, "Fields": d["Fields"],
            "Objects": d["Objects"], "Tasks": tasks, "Updates": {}}


def job_diff(old, new, contextual: bool = False) -> dict:
    """Diff two Job dataclasses (either may be None) into the JobDiff API
    shape consumed by `job plan` (ref structs/diff.go JobDiff).

    With contextual=True (the plan endpoint's mode, ref
    job_endpoint.go Plan → job.Diff(args.Job, true)), unchanged fields
    and objects are included with Type "None" so the CLI can render the
    full context under -verbose."""
    oapi = to_api(old) if old is not None else {}
    napi = to_api(new) if new is not None else {}
    job_id = (napi or oapi).get("Id") or (napi or oapi).get("ID", "")
    old_tgs = {g.get("Name"): g for g in oapi.pop("TaskGroups", None) or []}
    new_tgs = {g.get("Name"): g for g in napi.pop("TaskGroups", None) or []}
    top = _object_diff("Job", oapi or None, napi or None, contextual) or \
        {"Type": DIFF_NONE, "Fields": [], "Objects": []}
    tgs = []
    for name in sorted(set(old_tgs) | set(new_tgs)):
        tgd = task_group_diff(old_tgs.get(name), new_tgs.get(name),
                              contextual)
        if tgd:
            tgs.append(tgd)
    typ = top["Type"]
    if not oapi:
        typ = DIFF_ADDED
    elif not napi:
        typ = DIFF_DELETED
    elif typ == DIFF_NONE and any(t["Type"] != DIFF_NONE for t in tgs):
        typ = DIFF_EDITED
    return {"Type": typ, "ID": job_id, "Fields": top["Fields"],
            "Objects": top["Objects"], "TaskGroups": tgs}
