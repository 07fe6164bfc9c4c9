"""CLI (ref command/ — the `nomad <cmd>` surface over the HTTP API).

Usage:
  python -m nomad_tpu.cli agent -dev [-port N]
  python -m nomad_tpu.cli job run <spec.json>
  python -m nomad_tpu.cli job status [job_id]
  python -m nomad_tpu.cli job stop [-purge] <job_id>
  python -m nomad_tpu.cli job dispatch <job_id> [-meta k=v ...]
  python -m nomad_tpu.cli node status [node_id]
  python -m nomad_tpu.cli node drain -enable <node_id>
  python -m nomad_tpu.cli node eligibility -enable|-disable <node_id>
  python -m nomad_tpu.cli alloc status <alloc_id>
  python -m nomad_tpu.cli eval status <eval_id>
  python -m nomad_tpu.cli deployment list|status|promote <...>
  python -m nomad_tpu.cli trace [eval_id] [-chrome out.json]
  python -m nomad_tpu.cli operator scheduler get-config
  python -m nomad_tpu.cli operator scheduler set-config -scheduler-algorithm <alg>
  python -m nomad_tpu.cli system gc
  python -m nomad_tpu.cli server members
  python -m nomad_tpu.cli status
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import time
import urllib.error
import urllib.parse
import urllib.request


def _addr() -> str:
    return os.environ.get("NOMAD_ADDR", "http://127.0.0.1:4646")


def _die(msg: str) -> None:
    print(f"Error: {msg}", file=sys.stderr)
    sys.exit(1)


def api_raw(method: str, path: str) -> bytes:
    """Non-JSON endpoints (log/file contents)."""
    req = urllib.request.Request(_addr() + path, method=method)
    token = os.environ.get("NOMAD_TOKEN", "")
    if token:
        req.add_header("X-Nomad-Token", token)
    with urllib.request.urlopen(req, timeout=35) as resp:
        return resp.read()


def api(method: str, path: str, body=None):
    url = _addr() + path
    data = json.dumps(body).encode() if body is not None else None
    headers = {"Content-Type": "application/json"}
    token = os.environ.get("NOMAD_TOKEN", "")
    if token:
        headers["X-Nomad-Token"] = token
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=35) as resp:
            return json.loads(resp.read() or "null")
    except urllib.error.HTTPError as e:
        try:
            err = json.loads(e.read()).get("error", str(e))
        except Exception:   # noqa: BLE001
            err = str(e)
        print(f"Error: {err}", file=sys.stderr)
        sys.exit(1)
    except urllib.error.URLError as e:
        print(f"Error connecting to {url}: {e.reason}", file=sys.stderr)
        sys.exit(1)


def _table(rows: list[list], headers: list[str]) -> None:
    widths = [max(len(str(r[i])) for r in [headers] + rows)
              for i in range(len(headers))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    print(fmt.format(*headers))
    for r in rows:
        print(fmt.format(*[str(c) for c in r]))


# ------------------------------------------------------------------ agent

def cmd_agent(args) -> None:
    from .agent import Agent, AgentConfig
    cfg = AgentConfig(dev_mode=args.dev)
    # config files load first (ref agent.go: files merge in order)...
    config_paths = list(getattr(args, "config", []) or [])
    if config_paths:
        from .agent.config_file import (
            ConfigError, apply_to_agent_config, load_config,
        )
        try:
            apply_to_agent_config(cfg, load_config(config_paths))
        except (ConfigError, OSError) as e:
            _die(str(e))
    # ...then explicitly passed CLI flags override file values. Agent
    # flags default to None (sentinel), so ANY value the operator typed
    # wins — including typing a flag's documented default back — and
    # AgentConfig's own defaults apply when neither source sets a field.
    fields = {"port": "http_port", "data_dir": "data_dir",
              "workers": "num_workers", "acl_enabled": "acl_enabled",
              "region": "region",
              "authoritative_region": "authoritative_region",
              "rpc_port": "rpc_port", "gossip_port": "gossip_port",
              "bootstrap_expect": "bootstrap_expect",
              "replication_token": "replication_token",
              "plugin_dir": "plugin_dir"}
    for arg_name, cfg_field in fields.items():
        val = getattr(args, arg_name, None)
        if val is not None:
            setattr(cfg, cfg_field, val)
    if getattr(args, "join", None):
        cfg.join = tuple(args.join)
    agent = Agent(cfg, logger=lambda m: print(f"    {m}", flush=True))
    agent.start()
    mode = []
    if agent.server:
        mode.append("server")
    if agent.client:
        mode.append("client")
    print("==> nomad_tpu agent started! Log data will stream below:")
    print(f"    Mode: {' + '.join(mode)}{' (dev)' if args.dev else ''}")
    print(f"    HTTP: {agent.http_addr}")
    if agent.client:
        print(f"    Node: {agent.client.node.name} ({agent.client.node.id[:8]})")
    stop = False

    def on_sig(*_):
        nonlocal stop
        stop = True

    signal.signal(signal.SIGINT, on_sig)
    signal.signal(signal.SIGTERM, on_sig)
    while not stop:
        time.sleep(0.2)
    print("==> caught signal, shutting down")
    agent.shutdown()


# ------------------------------------------------------------------- jobs

def _load_spec(path: str, var_flags=None) -> dict:
    """Load a jobspec file — HCL (.nomad/.hcl) or JSON — into the API job
    payload (ref command/job_run.go: HCL parse then api.Job submit)."""
    if path.endswith(".json"):
        with open(path) as f:
            spec = json.load(f)
        return spec if "Job" in spec else {"Job": spec}
    from .jobspec import parse_file
    from .api_codec import to_api
    variables = {}
    for kv in var_flags or []:
        k, _, v = kv.partition("=")
        variables[k] = v
    job = parse_file(path, variables)
    return {"Job": to_api(job)}


def cmd_job_run(args) -> None:
    spec = _load_spec(args.spec, getattr(args, "var", None))
    resp = api("PUT", "/v1/jobs", spec)
    print(f"==> Evaluation {resp.get('eval_id', '')[:8]} created")
    if args.detach:
        return
    eval_id = resp.get("eval_id")
    if not eval_id:
        return
    for _ in range(100):
        ev = api("GET", f"/v1/evaluation/{eval_id}")
        if ev["Status"] in ("complete", "failed", "canceled"):
            print(f"==> Evaluation status: {ev['Status']}")
            if ev.get("FailedTGAllocs"):
                for tg, m in ev["FailedTGAllocs"].items():
                    print(f"    group {tg!r}: placement failed "
                          f"(filtered {m.get('NodesFiltered', 0)}, "
                          f"exhausted {m.get('NodesExhausted', 0)})")
            blocked = ev.get("BlockedEval")
            if blocked:
                print(f"    blocked eval {blocked[:8]} waiting for capacity")
            return
        time.sleep(0.2)


def cmd_job_status(args) -> None:
    if not args.job_id:
        jobs = api("GET", "/v1/jobs")
        if not jobs:
            print("No running jobs")
            return
        _table([[j["ID"], j["Type"], j["Priority"], j["Status"]]
                for j in jobs], ["ID", "Type", "Priority", "Status"])
        return
    job = api("GET", f"/v1/job/{args.job_id}")
    print(f"ID            = {job['ID']}")
    print(f"Name          = {job['Name']}")
    print(f"Type          = {job['Type']}")
    print(f"Priority      = {job['Priority']}")
    print(f"Status        = {job['Status']}")
    print(f"Version       = {job['Version']}")
    allocs = api("GET", f"/v1/job/{args.job_id}/allocations")
    if allocs:
        print("\nAllocations")
        _table([[a["ID"][:8], a["NodeName"] or a["NodeID"][:8], a["TaskGroup"],
                 a["JobVersion"], a["DesiredStatus"], a["ClientStatus"]]
                for a in allocs],
               ["ID", "Node", "Group", "Version", "Desired", "Status"])


def cmd_job_stop(args) -> None:
    path = f"/v1/job/{args.job_id}"
    if args.purge:
        path += "?purge=true"
    resp = api("DELETE", path)
    print(f"==> Evaluation {resp.get('eval_id', '')[:8]} created")


def _ann_suffix(d: dict) -> str:
    """Scheduling-consequence suffix (ref command/job_plan.go: the
    "(forces create)" renderings of scheduler/annotate.go output)."""
    ann = d.get("Annotations") or []
    return f" ({', '.join(ann)})" if ann else ""


def _render_field_diffs(fields: list, indent: str,
                        verbose: bool = False) -> None:
    marks = {"Added": "+", "Deleted": "-", "Edited": "+/-", "None": " "}
    for f in fields or []:
        m = marks.get(f["Type"], " ")
        sfx = _ann_suffix(f)
        if f["Type"] == "Edited":
            print(f"{indent}{m} {f['Name']}: "
                  f"{f['Old']!r} => {f['New']!r}{sfx}")
        elif f["Type"] == "Added":
            print(f"{indent}{m} {f['Name']}: {f['New']!r}{sfx}")
        elif f["Type"] == "Deleted":
            print(f"{indent}{m} {f['Name']}: {f['Old']!r}{sfx}")
        elif verbose:   # Type None: context, shown only under -verbose
            print(f"{indent}{m} {f['Name']}: {f['New']!r}{sfx}")


def _render_object_diffs(objs: list, indent: str,
                         verbose: bool = False) -> None:
    for o in objs or []:
        if o["Type"] == "None" and not verbose:
            continue
        print(f"{indent}{o['Type']} {o['Name']} {{")
        _render_field_diffs(o.get("Fields"), indent + "  ", verbose)
        _render_object_diffs(o.get("Objects"), indent + "  ", verbose)
        print(f"{indent}}}")


def cmd_job_plan(args) -> None:
    spec = _load_spec(args.spec, getattr(args, "var", None))
    spec["Diff"] = True
    verbose = bool(getattr(args, "verbose", False))
    resp = api("PUT", f"/v1/job/{spec['Job'].get('Id') or spec['Job'].get('ID')}/plan",
               spec)
    diff = resp.get("Diff") or {}
    if diff.get("Type", "None") != "None":
        print(f"{diff['Type']} job {diff.get('ID', '')!r}")
        _render_field_diffs(diff.get("Fields"), "  ", verbose)
        _render_object_diffs(diff.get("Objects"), "  ", verbose)
        for tg in diff.get("TaskGroups", []):
            if tg["Type"] == "None" and not verbose:
                continue
            print(f"  {tg['Type']} group {tg['Name']!r}")
            _render_field_diffs(tg.get("Fields"), "    ", verbose)
            _render_object_diffs(tg.get("Objects"), "    ", verbose)
            for t in tg.get("Tasks", []):
                if t["Type"] == "None" and not verbose:
                    continue
                print(f"    {t['Type']} task {t['Name']!r}"
                      f"{_ann_suffix(t)}")
                _render_field_diffs(t.get("Fields"), "      ", verbose)
                _render_object_diffs(t.get("Objects"), "      ", verbose)
    else:
        print("No changes")
    ann = resp.get("Annotations") or {}
    for tg, upd in (ann.get("DesiredTgUpdates") or {}).items():
        parts = [f"{k.lower()} {v}" for k, v in sorted(upd.items()) if v]
        if parts:
            print(f"==> group {tg!r}: " + ", ".join(parts))
    failed = resp.get("FailedTGAllocs")
    if failed:
        for tg, m in failed.items():
            print(f"!!  group {tg!r} would fail to place "
                  f"(filtered {m.get('NodesFiltered', 0)}, "
                  f"exhausted {m.get('NodesExhausted', 0)})")
    print(f"Job Modify Index: {resp.get('JobModifyIndex', 0)}")


def cmd_job_validate(args) -> None:
    try:
        _load_spec(args.spec, getattr(args, "var", None))
    except Exception as e:   # noqa: BLE001
        print(f"Job validation errors:\n  {e}")
        raise SystemExit(1)
    print("Job validation successful")


def cmd_job_inspect(args) -> None:
    job = api("GET", f"/v1/job/{args.job_id}")
    print(json.dumps({"Job": job}, indent=2, default=str))


def cmd_job_dispatch(args) -> None:
    meta = dict(kv.split("=", 1) for kv in (args.meta or []))
    resp = api("PUT", f"/v1/job/{args.job_id}/dispatch", {"Meta": meta})
    print(f"==> Dispatched job {resp['dispatched_job_id']}")


def cmd_job_scale(args) -> None:
    """ref command/job_scale.go"""
    resp = api("PUT", f"/v1/job/{args.job_id}/scale", {
        "Target": {"Group": args.group}, "Count": int(args.count),
        "Message": "scaled via CLI"})
    print(f"==> Evaluation {resp.get('eval_id', '')[:8]} created")


def cmd_job_revert(args) -> None:
    """ref command/job_revert.go"""
    resp = api("PUT", f"/v1/job/{args.job_id}/revert",
               {"JobVersion": int(args.version)})
    print(f"==> Evaluation {resp.get('eval_id', '')[:8]} created")


def cmd_job_history(args) -> None:
    """ref command/job_history.go"""
    versions = api("GET", f"/v1/job/{args.job_id}/versions")
    _table([[str(v["Version"]), "true" if v.get("Stable") else "false",
             v["Status"]] for v in versions],
           ["Version", "Stable", "Status"])


def cmd_job_eval(args) -> None:
    """ref command/job_eval.go: force a fresh evaluation of the job."""
    resp = api("PUT", f"/v1/job/{args.job_id}/evaluate",
               {"EvalOptions":
                {"ForceReschedule": bool(args.force_reschedule)}})
    print(f"==> Evaluation {resp.get('EvalID', '')[:8]} created")


def cmd_job_periodic_force(args) -> None:
    """ref command/job_periodic_force.go"""
    resp = api("PUT", f"/v1/job/{args.job_id}/periodic/force", {})
    print(f"==> Dispatched periodic child {resp['dispatched_job_id']}")


def cmd_job_deployments(args) -> None:
    """ref command/job_deployments.go"""
    ds = api("GET", f"/v1/job/{args.job_id}/deployments")
    _table([[d["ID"][:8], d["JobVersion"], d["Status"],
             d["StatusDescription"]] for d in ds],
           ["ID", "Version", "Status", "Description"])


# ---------------------------------------------------------------- volumes

def cmd_volume_status(args) -> None:
    """ref command/volume_status.go"""
    if not args.volume_id:
        vols = api("GET", "/v1/volumes")
        _table([[v["ID"], v["Name"], v["PluginID"],
                 "true" if v["Schedulable"] else "false",
                 v["AccessMode"]] for v in vols],
               ["ID", "Name", "Plugin", "Schedulable", "Access"])
        return
    v = api("GET", f"/v1/volume/csi/{args.volume_id}")
    print(f"ID          = {v['ID']}")
    print(f"Name        = {v['Name']}")
    print(f"Plugin      = {v['PluginID']}")
    print(f"Schedulable = {v['Schedulable']}")
    print(f"Access Mode = {v['AccessMode']}")
    print(f"Readers     = {len(v.get('ReadClaims') or {})}")
    print(f"Writers     = {len(v.get('WriteClaims') or {})}")


def cmd_volume_register(args) -> None:
    with open(args.spec) as f:
        spec = json.load(f)
    vol = spec.get("Volume", spec)
    api("PUT", f"/v1/volume/csi/{vol.get('ID', '')}", {"Volume": vol})
    print(f"==> Registered volume {vol.get('ID')}")


def cmd_volume_deregister(args) -> None:
    force = "?force=true" if args.force else ""
    api("DELETE", f"/v1/volume/csi/{args.volume_id}{force}")
    print(f"==> Deregistered volume {args.volume_id}")


def cmd_volume_detach(args) -> None:
    """ref command/volume_detach.go"""
    out = api("DELETE",
              f"/v1/volume/csi/{args.volume_id}/detach?node={args.node_id}")
    print(f"==> Released {out.get('NumReleased', 0)} claim(s) on "
          f"{args.volume_id}")


def cmd_plugin_status(args) -> None:
    """ref command/plugin_status.go"""
    if not args.plugin_id:
        plugins = api("GET", "/v1/plugins")
        _table([[p["ID"], p["Provider"],
                 f"{p['ControllersHealthy']}/{p['ControllersExpected']}",
                 f"{p['NodesHealthy']}/{p['NodesExpected']}"]
                for p in plugins],
               ["ID", "Provider", "Controllers", "Nodes"])
        return
    p = api("GET", f"/v1/plugin/csi/{args.plugin_id}")
    print(f"ID       = {p['ID']}")
    print(f"Provider = {p['Provider']}")
    print(f"Version  = {p['Version']}")


# ------------------------------------------------------------------ nodes

def cmd_node_status(args) -> None:
    if not args.node_id:
        nodes = api("GET", "/v1/nodes")
        _table([[n["ID"][:8], n["Name"], n["Datacenter"], n["Status"],
                 n["SchedulingEligibility"], "true" if n["Drain"] else "false"]
                for n in nodes],
               ["ID", "Name", "DC", "Status", "Eligibility", "Drain"])
        return
    node = api("GET", f"/v1/node/{args.node_id}")
    print(f"ID          = {node['ID']}")
    print(f"Name        = {node['Name']}")
    print(f"Status      = {node['Status']}")
    print(f"Eligibility = {node['SchedulingEligibility']}")
    allocs = api("GET", f"/v1/node/{args.node_id}/allocations")
    if allocs:
        print("\nAllocations")
        _table([[a["ID"][:8], a["JobID"], a["TaskGroup"], a["DesiredStatus"],
                 a["ClientStatus"]] for a in allocs],
               ["ID", "Job", "Group", "Desired", "Status"])


def cmd_node_drain(args) -> None:
    body = {}
    if args.enable:
        body["DrainSpec"] = {"Deadline": args.deadline,
                             "IgnoreSystemJobs": args.ignore_system}
    else:
        body["DrainSpec"] = None
        body["MarkEligible"] = True
    api("PUT", f"/v1/node/{args.node_id}/drain", body)
    print(f"==> Node {args.node_id[:8]} drain "
          f"{'enabled' if args.enable else 'disabled'}")
    if args.enable and getattr(args, "monitor", False):
        # ref command/node_drain.go -monitor: poll until every non-system
        # alloc on the node reaches a terminal or replaced state
        seen = set()
        while True:
            node = api("GET", f"/v1/node/{args.node_id}")
            allocs = api("GET", f"/v1/node/{args.node_id}/allocations")
            remaining = [a for a in allocs
                         if a["DesiredStatus"] == "run"
                         and a["ClientStatus"] in ("pending", "running")]
            for a in allocs:
                key = (a["ID"], a["DesiredStatus"], a["ClientStatus"])
                if key not in seen and a["DesiredStatus"] != "run":
                    seen.add(key)
                    print(f"    alloc {a['ID'][:8]} ({a['JobID']}) -> "
                          f"{a['DesiredStatus']}/{a['ClientStatus']}")
            if not node.get("DrainStrategy"):
                # drain strategy removed: done — system-job allocs may
                # legitimately keep running (-ignore-system), so don't
                # wait on `remaining` once the drainer has finished
                # (ref node_drain.go monitor exits on drain completion)
                print("==> Drain complete" if not remaining else
                      f"==> Drain complete ({len(remaining)} alloc(s) "
                      "left running)")
                return
            if not remaining:
                print("==> All allocations drained "
                      "(node still marked draining)")
                return
            time.sleep(1.0)


def cmd_node_eligibility(args) -> None:
    elig = "eligible" if args.enable else "ineligible"
    api("PUT", f"/v1/node/{args.node_id}/eligibility", {"Eligibility": elig})
    print(f"==> Node {args.node_id[:8]} marked {elig}")


# ------------------------------------------------------------------ other

def cmd_alloc_signal(args) -> None:
    """ref command/alloc_signal.go"""
    alloc_id, task = _alloc_task(args.alloc_id, args.task)
    api("POST", f"/v1/client/allocation/{alloc_id}/signal",
        {"Task": task, "Signal": args.signal})
    print(f"Signalled {args.signal} to task {task!r} of {alloc_id[:8]}")


def cmd_alloc_restart(args) -> None:
    """ref command/alloc_restart.go"""
    alloc_id, task = _alloc_task(args.alloc_id, args.task)
    api("POST", f"/v1/client/allocation/{alloc_id}/restart",
        {"Task": task})
    print(f"Restarted task {task!r} of {alloc_id[:8]}")


def cmd_alloc_stop(args) -> None:
    """ref command/alloc_stop.go"""
    alloc_id, _ = _alloc_task(args.alloc_id, "-")
    out = api("POST", f"/v1/allocation/{alloc_id}/stop", {})
    ev = out.get("eval_id") or out.get("EvalID") or ""
    print(f"Stopped {alloc_id[:8]} (eval {ev[:8]})")


def cmd_alloc_fs(args) -> None:
    """ref command/alloc_fs.go: ls/stat/cat inside the alloc dir"""
    alloc_id, _ = _alloc_task(args.alloc_id, "-")
    path = urllib.parse.quote(args.path or "/")
    st = api("GET", f"/v1/client/fs/stat/{alloc_id}?path={path}")
    if args.stat:
        print(json.dumps(st, indent=2))
        return
    if st.get("IsDir"):
        listing = api("GET", f"/v1/client/fs/ls/{alloc_id}?path={path}")
        _table([[e["Name"], "dir" if e["IsDir"] else e["Size"],
                 e["FileMode"]] for e in listing],
               ["Name", "Size", "Mode"])
    else:
        sys.stdout.buffer.write(api_raw(
            "GET", f"/v1/client/fs/cat/{alloc_id}?path={path}"))


def cmd_eval_list(args) -> None:
    """ref command/eval_list.go"""
    evs = api("GET", "/v1/evaluations")
    _table([[e["ID"][:8], e["JobID"], e["Type"], e["TriggeredBy"],
             e["Status"]] for e in evs[:args.limit]],
           ["ID", "Job", "Type", "Triggered By", "Status"])


def cmd_server_force_leave(args) -> None:
    """ref command/server_force_leave.go"""
    api("POST", "/v1/agent/force-leave?node="
        + urllib.parse.quote(args.name))
    print(f"Force-left {args.name}")


def cmd_alloc_status(args) -> None:
    a = api("GET", f"/v1/allocation/{args.alloc_id}")
    print(f"ID            = {a['ID']}")
    print(f"Name          = {a['Name']}")
    print(f"Node          = {a['NodeName'] or a['NodeID'][:8]}")
    print(f"Job           = {a['JobID']}")
    print(f"Desired       = {a['DesiredStatus']}")
    print(f"Status        = {a['ClientStatus']}")
    for task, st in (a.get("TaskStates") or {}).items():
        print(f"\nTask {task!r} is {st['State']}"
              f"{' (failed)' if st['Failed'] else ''}")
        for ev in st.get("Events", [])[-5:]:
            print(f"  {ev['Type']}: {ev['Message']}")


def _alloc_task(alloc_id: str, task: str) -> tuple[str, str]:
    """Resolve (full alloc id, task name) from a possibly-short id."""
    if len(alloc_id) == 36:
        a = api("GET", f"/v1/allocation/{alloc_id}")
    else:
        matches = [x for x in (api("GET", "/v1/allocations") or [])
                   if x["ID"].startswith(alloc_id)]
        if len(matches) != 1:
            _die(f"allocation {alloc_id!r} matched "
                 f"{len(matches)} allocations")
        a = api("GET", f"/v1/allocation/{matches[0]['ID']}")
    if not task:
        states = a.get("TaskStates") or {}
        if len(states) == 1:
            task = next(iter(states))
        else:
            _die(f"-task required (tasks: {', '.join(states) or '?'})")
    return a["ID"], task


def cmd_alloc_exec(args) -> None:
    """Interactive exec into a running task (ref command/alloc_exec.go):
    round-trips stdin/stdout through the session API until exit."""
    import base64
    import select
    # argparse REMAINDER swallows flags placed after the alloc id
    # (`alloc exec ID -task t -- cmd`); strip them out here
    rest = list(args.command)
    while rest and rest[0].startswith("-") and rest[0] != "--":
        flag = rest.pop(0)
        if flag == "-task" and rest:
            args.task = rest.pop(0)
        elif flag == "-tty":
            args.tty = True
    if rest and rest[0] == "--":        # only the SEPARATOR is stripped:
        rest = rest[1:]                 # later '--' belong to the command
    command = rest
    if not command:
        _die("command required, e.g.: alloc exec <id> -task web -- /bin/sh")
    alloc_id, task = _alloc_task(args.alloc_id, args.task)
    out = api("POST", f"/v1/client/allocation/{alloc_id}/exec",
              {"Task": task, "Cmd": command, "Tty": args.tty})
    sid = out["SessionID"]
    stdin_open = True
    try:
        while True:
            # pump any ready local stdin to the remote session
            if stdin_open and select.select([sys.stdin], [], [], 0)[0]:
                line = sys.stdin.buffer.readline()
                if line:
                    api("POST", f"/v1/client/exec-session/{sid}",
                        {"Stdin": base64.b64encode(line).decode()})
                else:                    # local EOF -> remote EOF, once
                    api("POST", f"/v1/client/exec-session/{sid}",
                        {"StdinEOF": True})
                    stdin_open = False
            chunk = api("GET", f"/v1/client/exec-session/{sid}?wait=0.5")
            data = base64.b64decode(chunk.get("Stdout", ""))
            err = base64.b64decode(chunk.get("Stderr", ""))
            if data:
                sys.stdout.buffer.write(data)
                sys.stdout.flush()
            if err:
                sys.stderr.buffer.write(err)
                sys.stderr.flush()
            if chunk.get("Exited") and not data and not err:
                code = chunk.get("ExitCode") or 0
                sys.exit(code)
    finally:
        try:
            api("DELETE", f"/v1/client/exec-session/{sid}")
        except Exception:               # noqa: BLE001
            pass


def cmd_alloc_logs(args) -> None:
    """ref command/alloc_logs.go (-f follows)"""
    import base64
    alloc_id, task = _alloc_task(args.alloc_id, args.task)
    log_type = "stderr" if args.stderr else "stdout"
    if not args.follow:
        data = api_raw("GET", f"/v1/client/fs/logs/{alloc_id}?task={task}"
                       f"&type={log_type}")
        sys.stdout.buffer.write(data)
        return
    offset = 0
    try:
        while True:
            out = api("GET", f"/v1/client/fs/logs/{alloc_id}?task={task}"
                      f"&type={log_type}&follow=true&offset={offset}&wait=5")
            data = base64.b64decode(out.get("Data", ""))
            offset = int(out.get("Offset", offset))
            if data:
                sys.stdout.buffer.write(data)
                sys.stdout.flush()
    except (BrokenPipeError, KeyboardInterrupt):
        sys.exit(0)                     # downstream pipe closed / ^C


def cmd_eval_status(args) -> None:
    """ref command/eval_status.go: summary + per-group placement
    failure metrics + related allocations."""
    ev = api("GET", f"/v1/evaluation/{args.eval_id}")
    for k in ("ID", "Type", "TriggeredBy", "JobID", "Priority", "Status",
              "StatusDescription"):
        print(f"{k:<18}= {ev.get(k)}")
    if ev.get("WaitUntilUnix"):
        print(f"{'WaitUntil':<18}= {ev['WaitUntilUnix']}")
    if ev.get("BlockedEval"):
        # full id: eval lookups are exact-match, a truncated id can't be
        # fed back into `eval status`
        print(f"{'BlockedEval':<18}= {ev['BlockedEval']}")
    failed = ev.get("FailedTGAllocs") or {}
    for tg, m in failed.items():
        print(f"\nTask Group {tg!r} (failed to place):")
        print(f"  * Nodes evaluated: {m.get('NodesEvaluated', 0)}, "
              f"filtered: {m.get('NodesFiltered', 0)}, "
              f"exhausted: {m.get('NodesExhausted', 0)}")
        for reason, n in (m.get("ConstraintFiltered") or {}).items():
            print(f"  * Constraint {reason!r} filtered {n} node(s)")
        for dim, n in (m.get("DimensionExhausted") or {}).items():
            print(f"  * Resources exhausted on {n} node(s): {dim}")
        for klass, n in (m.get("ClassExhausted") or {}).items():
            print(f"  * Class {klass!r} exhausted on {n} node(s)")
        # tensor-path explain (ISSUE 11): winning-row score metadata the
        # device solve attached — who DID win, next to why others lost
        for sm in (m.get("ScoreMeta") or [])[:5]:
            nid = (sm.get("node_id") or sm.get("NodeID") or "")[:8]
            score = sm.get("normalized_score",
                           sm.get("NormalizedScore", 0.0))
            print(f"  * Scored node {nid}: {score:.4f}")
    allocs = api("GET", f"/v1/evaluation/{args.eval_id}/allocations")
    if allocs:
        print("\nAllocations")
        _table([[a["ID"][:8], a["TaskGroup"],
                 a["NodeName"] or a["NodeID"][:8],
                 a["DesiredStatus"], a["ClientStatus"]] for a in allocs],
               ["ID", "Group", "Node", "Desired", "Status"])


def cmd_trace(args) -> None:
    """Eval-trace browsing (ISSUE 7): `trace` lists retained traces,
    `trace <eval-id>` renders a text waterfall of the span tree plus the
    shared fan-in spans (micro-batch dispatch, coalesced commit) the
    eval rode; `-chrome FILE` saves Chrome trace-event JSON for
    chrome://tracing / Perfetto."""
    if not args.ref:
        out = api("GET", f"/v1/traces?limit={args.limit}")
        trs = out.get("Traces", [])
        if not trs:
            print("No traces retained (telemetry_trace_enabled off, "
                  "sampled out, or nothing ran yet)")
            return
        _table([[t["trace_id"][:12], (t["eval_id"] or "-")[:8],
                 t["name"], t["status"],
                 f"{t['duration_s'] * 1000:.1f}ms", t["spans"]]
                for t in trs],
               ["Trace", "Eval", "Name", "Status", "Duration", "Spans"])
        st = out.get("Stats", {})
        print(f"\n{st.get('retained', 0)} retained / "
              f"{st.get('started', 0)} started, "
              f"sample_rate={st.get('sample_rate')}")
        return
    ref = urllib.parse.quote(args.ref)
    if args.chrome:
        raw = api_raw("GET", f"/v1/traces/{ref}?format=chrome")
        with open(args.chrome, "wb") as f:
            f.write(raw)
        print(f"Wrote Chrome trace-event JSON to {args.chrome} "
              f"(open in chrome://tracing or ui.perfetto.dev)")
        return
    tr = api("GET", f"/v1/traces/{ref}")
    dur = max(tr.get("duration_s") or 0.0, 1e-9)
    print(f"Trace   {tr['trace_id']}  ({tr['name']}, "
          f"status={tr['status']})")
    if tr.get("eval_id"):
        print(f"Eval    {tr['eval_id']}")
    print(f"Wall    {dur * 1000:.2f}ms\n")
    spans = list(tr.get("spans", ()))
    by_parent: dict[str, list] = {}
    for sp in spans:
        by_parent.setdefault(sp["parent"], []).append(sp)
    for kids in by_parent.values():
        kids.sort(key=lambda s: s["ts"])
    width = 36
    t0 = tr["start_unix"]

    def bar(sp) -> str:
        off = max(0.0, sp["ts"] - t0) / dur
        frac = min(1.0, sp["dur"] / dur)
        lead = min(width - 1, int(off * width))
        fill = max(1, int(frac * width))
        fill = min(fill, width - lead)
        return " " * lead + "█" * fill + " " * (width - lead - fill)

    def attrs_str(sp) -> str:
        keep = {k: v for k, v in (sp.get("attrs") or {}).items()
                if k in ("tier", "kernel", "cache", "lanes", "plans",
                         "demotions", "raft_index", "error", "noop",
                         "index")}
        mark = "" if sp["status"] == "ok" else f" !{sp['status']}"
        link = " ~fanin" if sp.get("links") else ""
        return mark + link + (f"  {keep}" if keep else "")

    def walk(sp, depth: int) -> None:
        name = ("  " * depth + sp["name"])[:30]
        print(f"{name:<30} |{bar(sp)}| {sp['dur'] * 1000:9.3f}ms"
              f"{attrs_str(sp)}")
        for kid in by_parent.get(sp["id"], ()):
            walk(kid, depth + 1)

    roots = by_parent.get("", [])
    orphans = [sp for sp in spans
               if sp["parent"] and not any(
                   p["id"] == sp["parent"] for p in spans)]
    for sp in roots + sorted(orphans, key=lambda s: s["ts"]):
        walk(sp, 0)
    linked = tr.get("linked_spans", ())
    if linked:
        print("\nShared fan-in spans this eval rode:")
        for sp in sorted(linked, key=lambda s: s["ts"]):
            print(f"~ {sp['name']:<28} |{bar(sp)}| "
                  f"{sp['dur'] * 1000:9.3f}ms{attrs_str(sp)}")


def cmd_deployment(args) -> None:
    if args.action == "list":
        ds = api("GET", "/v1/deployments")
        _table([[d["ID"][:8], d["JobID"], d["JobVersion"], d["Status"],
                 d["StatusDescription"]] for d in ds],
               ["ID", "Job", "Version", "Status", "Description"])
    elif args.action == "status":
        d = api("GET", f"/v1/deployment/{args.id}")
        print(json.dumps(d, indent=2))
    elif args.action == "promote":
        api("PUT", f"/v1/deployment/promote/{args.id}", {})
        print("==> Deployment promoted")
    elif args.action == "fail":
        api("PUT", f"/v1/deployment/fail/{args.id}", {})
        print("==> Deployment marked failed")
    elif args.action == "pause":
        api("PUT", f"/v1/deployment/pause/{args.id}", {"Pause": True})
        print("==> Deployment paused")
    elif args.action == "resume":
        api("PUT", f"/v1/deployment/pause/{args.id}", {"Pause": False})
        print("==> Deployment resumed")


def cmd_operator_scheduler(args) -> None:
    if args.action == "get-config":
        cfg = api("GET", "/v1/operator/scheduler/configuration")
        print(json.dumps(cfg, indent=2))
    else:
        cfg = api("GET", "/v1/operator/scheduler/configuration")[
            "SchedulerConfig"]
        if args.scheduler_algorithm:
            cfg["SchedulerAlgorithm"] = args.scheduler_algorithm
        if args.memory_oversubscription is not None:
            cfg["MemoryOversubscriptionEnabled"] = \
                args.memory_oversubscription == "true"
        api("PUT", "/v1/operator/scheduler/configuration", cfg)
        print("==> Scheduler configuration updated")


def cmd_operator_raft(args) -> None:
    """ref command/operator_raft_list.go / operator_raft_remove.go"""
    if args.action == "list-peers":
        cfg = api("GET", "/v1/operator/raft/configuration")
        _table([[sv["ID"], sv["Address"],
                 "leader" if sv["Leader"] else "follower",
                 "true" if sv["Voter"] else "false"]
                for sv in cfg["Servers"]],
               ["ID", "Address", "State", "Voter"])
    else:
        q = []
        if args.peer_id:
            q.append(f"id={args.peer_id}")
        if args.peer_address:
            q.append(f"address={args.peer_address}")
        api("DELETE", "/v1/operator/raft/peer?" + "&".join(q))
        print("==> Peer removed")


def cmd_operator_snapshot(args) -> None:
    """ref command/operator_snapshot_save.go / _restore.go"""
    if args.action == "inspect":
        return cmd_operator_snapshot_inspect(args)
    from .api import Client
    sdk = Client(timeout=60)
    if args.action == "save":
        data = sdk.operator.snapshot_save()
        with open(args.file, "wb") as f:
            f.write(data)
        print(f"==> Snapshot saved to {args.file} ({len(data)} bytes)")
    else:
        with open(args.file, "rb") as f:
            data = f.read()
        sdk.operator.snapshot_restore(data)
        print("==> Snapshot restored")


def cmd_operator_snapshot_inspect(args) -> None:
    """Offline snapshot summary — no server needed (ref
    helper/raftutil + command/operator_snapshot_inspect.go). Decodes
    through the restricted unpickler: snapshots are often handed around
    in support bundles, and a crafted pickle must not execute code."""
    from .rpc.codec import FrameError, decode
    with open(args.file, "rb") as f:
        try:
            blob = decode(f.read())
        except FrameError as e:
            _die(f"not a nomad-tpu snapshot: {e}")
    rows = []
    for table in ("nodes", "jobs", "job_versions", "job_summaries",
                  "evals", "allocs", "deployments", "periodic_launches",
                  "namespaces", "acl_policies", "acl_tokens",
                  "csi_volumes", "csi_plugins", "scaling_policies",
                  "services"):
        v = blob.get(table)
        if v is not None:
            rows.append([table, len(v)])
    print(f"Index         = {blob.get('index', 0)}")
    sc = blob.get("scheduler_config")
    if sc is not None:
        print(f"SchedulerAlg  = "
              f"{getattr(sc, 'scheduler_algorithm', '')}")
    print()
    _table(rows, ["Table", "Count"])


def cmd_operator_autopilot(args) -> None:
    if args.action == "get-config":
        print(json.dumps(api("GET", "/v1/operator/autopilot/configuration"),
                         indent=2))
    elif args.action == "health":
        print(json.dumps(api("GET", "/v1/operator/autopilot/health"),
                         indent=2))
    else:
        cfg = {}
        if args.cleanup_dead_servers is not None:
            cfg["CleanupDeadServers"] = args.cleanup_dead_servers == "true"
        api("PUT", "/v1/operator/autopilot/configuration", cfg)
        print("==> Autopilot configuration updated")


def cmd_operator_debug(args) -> None:
    """Capture a debug bundle (ref command/operator_debug.go): cluster
    state + agent internals + metrics sampled over a duration, written as
    nomad-debug-<ts>.tar.gz for support handoff."""
    import tarfile
    import tempfile
    import time as _time

    duration = float(args.duration)
    interval = max(float(args.interval), 0.25)
    captures = {
        "agent-self.json": ("GET", "/v1/agent/self"),
        "members.json": ("GET", "/v1/agent/members"),
        "nodes.json": ("GET", "/v1/nodes"),
        "jobs.json": ("GET", "/v1/jobs"),
        "allocations.json": ("GET", "/v1/allocations"),
        "evaluations.json": ("GET", "/v1/evaluations"),
        "deployments.json": ("GET", "/v1/deployments"),
        "scheduler-configuration.json":
            ("GET", "/v1/operator/scheduler/configuration"),
        # the server-side one-shot bundle (ISSUE 11): metrics + recent
        # traces + pressure/broker/state-cache/breaker stats + recent
        # placement-explain records + device-runtime telemetry
        "operator-debug.json": ("GET", "/v1/operator/debug"),
        "autopilot-health.json": ("GET", "/v1/operator/autopilot/health"),
        "raft-configuration.json":
            ("GET", "/v1/operator/raft/configuration"),
        "regions.json": ("GET", "/v1/regions"),
        "status-leader.json": ("GET", "/v1/status/leader"),
        "status-peers.json": ("GET", "/v1/status/peers"),
    }
    raw_captures = {
        "pprof-goroutine.txt": "/v1/agent/pprof/goroutine",
        "metrics.prom": "/v1/metrics?format=prometheus",
    }
    tmp = tempfile.mkdtemp(prefix="nomad-debug-")
    manifest = {"CapturedAt": _time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                             _time.gmtime()),
                "Duration": duration, "Interval": interval,
                "Files": [], "Errors": {}}

    def _save(name: str, payload) -> None:
        path = os.path.join(tmp, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            if isinstance(payload, str):
                f.write(payload)
            else:
                json.dump(payload, f, indent=2, default=str)
        manifest["Files"].append(name)

    # api_raw() (not api()): the JSON helper sys.exit(1)s on HTTP errors,
    # which would abort the whole bundle — a debug capture must record
    # the failure in the manifest and keep going
    for name, (method, path) in captures.items():
        try:
            _save(name, json.loads(api_raw(method, path) or b"null"))
        except Exception as e:  # noqa: BLE001 — capture what we can
            manifest["Errors"][name] = str(e)
    for name, path in raw_captures.items():
        try:
            _save(name, api_raw("GET", path).decode(errors="replace"))
        except Exception as e:  # noqa: BLE001
            manifest["Errors"][name] = str(e)
    # sampled captures: metrics at each interval tick over the duration
    # (ref operator_debug.go collectPeriodic)
    deadline = _time.time() + duration
    tick = 0
    while True:
        try:
            _save(f"metrics/metrics-{tick:03d}.json",
                  json.loads(api_raw("GET", "/v1/metrics") or b"null"))
        except Exception as e:  # noqa: BLE001
            manifest["Errors"][f"metrics-{tick}"] = str(e)
        tick += 1
        if _time.time() + interval > deadline:
            break
        _time.sleep(interval)
    _save("index.json", manifest)

    stamp = _time.strftime("%Y%m%d-%H%M%S")
    out = args.output or f"nomad-debug-{stamp}.tar.gz"
    with tarfile.open(out, "w:gz") as tar:
        tar.add(tmp, arcname=f"nomad-debug-{stamp}")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"==> Debug capture complete: {out} "
          f"({len(manifest['Files'])} files, "
          f"{len(manifest['Errors'])} errors)")


def cmd_monitor(args) -> None:
    """Stream agent logs (ref command/monitor.go)."""
    from .api import Client
    sdk = Client(timeout=3600)
    for line in sdk.agent.monitor(log_level=args.log_level):
        print(line)


def cmd_system_gc(args) -> None:
    api("PUT", "/v1/system/gc", {})
    print("==> GC triggered")


def cmd_system_reconcile_summaries(args) -> None:
    """ref command/system_reconcile_summaries.go"""
    api("PUT", "/v1/system/reconcile/summaries", {})
    print("==> Job summaries reconciled")


def cmd_acl_bootstrap(args) -> None:
    tok = api("POST", "/v1/acl/bootstrap")
    print(f"Accessor ID  = {tok['AccessorID']}")
    print(f"Secret ID    = {tok['SecretID']}")
    print(f"Name         = {tok['Name']}")
    print(f"Type         = {tok['Type']}")


def cmd_acl_policy_apply(args) -> None:
    with open(args.rules_file) as f:
        rules = f.read()
    api("PUT", f"/v1/acl/policy/{args.name}",
        {"Description": args.description or "", "Rules": rules})
    print(f"Successfully wrote ACL policy {args.name!r}")


def cmd_acl_policy_list(args) -> None:
    pols = api("GET", "/v1/acl/policies")
    if not pols:
        print("No policies")
        return
    _table([[p["Name"], p["Description"]] for p in pols],
           ["Name", "Description"])


def cmd_acl_policy_delete(args) -> None:
    api("DELETE", f"/v1/acl/policy/{args.name}")
    print(f"Successfully deleted ACL policy {args.name!r}")


def cmd_acl_token_create(args) -> None:
    tok = api("PUT", "/v1/acl/token", {
        "Name": args.name or "",
        "Type": args.type,
        "Policies": args.policy or [],
        "Global": bool(args.global_)})
    print(f"Accessor ID  = {tok['AccessorID']}")
    print(f"Secret ID    = {tok['SecretID']}")
    print(f"Type         = {tok['Type']}")
    print(f"Policies     = {tok['Policies']}")


def cmd_acl_token_list(args) -> None:
    toks = api("GET", "/v1/acl/tokens")
    _table([[t["AccessorID"][:8], t["Name"], t["Type"],
             ",".join(t["Policies"])] for t in toks],
           ["Accessor", "Name", "Type", "Policies"])


def cmd_acl_token_delete(args) -> None:
    api("DELETE", f"/v1/acl/token/{args.accessor_id}")
    print("Token deleted")


def cmd_acl_token_self(args) -> None:
    tok = api("GET", "/v1/acl/token/self")
    print(f"Accessor ID  = {tok['AccessorID']}")
    print(f"Name         = {tok['Name']}")
    print(f"Type         = {tok['Type']}")
    print(f"Policies     = {tok['Policies']}")


def cmd_namespace_apply(args) -> None:
    api("PUT", f"/v1/namespace/{args.name}",
        {"Name": args.name, "Description": args.description or ""})
    print(f"Successfully applied namespace {args.name!r}")


def cmd_namespace_list(args) -> None:
    nss = api("GET", "/v1/namespaces")
    _table([[n["Name"], n["Description"]] for n in nss],
           ["Name", "Description"])


def cmd_namespace_delete(args) -> None:
    api("DELETE", f"/v1/namespace/{args.name}")
    print(f"Successfully deleted namespace {args.name!r}")


def cmd_server_members(args) -> None:
    m = api("GET", "/v1/agent/members")
    _table([[x["Name"], x["Status"]] for x in m["Members"]],
           ["Name", "Status"])


def cmd_server_join(args) -> None:
    """ref command/server_join.go: gossip-join this agent to peers."""
    q = "&".join(f"address={urllib.parse.quote(a)}" for a in args.address)
    resp = api("PUT", f"/v1/agent/join?{q}")
    print(f"==> Joined {resp.get('num_joined', 0)} server(s)")


def cmd_scaling_policy(args) -> None:
    """ref command/scaling_policy_list.go / _info.go"""
    if args.policy_id:
        p = api("GET", f"/v1/scaling/policy/{args.policy_id}")
        print(json.dumps(p, indent=2))
    else:
        pols = api("GET", "/v1/scaling/policies")
        _table([[p["ID"][:8], (p.get("Target") or {}).get("Job", ""),
                 (p.get("Target") or {}).get("Group", ""),
                 "true" if p.get("Enabled") else "false"]
                for p in pols],
               ["ID", "Job", "Group", "Enabled"])


def cmd_version(args) -> None:
    from . import __version__
    print(f"nomad-tpu v{__version__}")


def cmd_status(args) -> None:
    me = api("GET", "/v1/agent/self")
    print(json.dumps(me.get("stats", {}), indent=2))


# ------------------------------------------------------------------ main

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nomad_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    ag = sub.add_parser("agent")
    # value flags default to None (sentinel): cmd_agent applies only
    # explicitly passed flags over config files over AgentConfig defaults
    ag.add_argument("-dev", action="store_true")
    ag.add_argument("-port", type=int, default=None,
                    help="HTTP port (default 4646)")
    ag.add_argument("-data-dir", dest="data_dir", default=None)
    ag.add_argument("-workers", type=int, default=None,
                    help="scheduler workers (default 2)")
    ag.add_argument("-acl-enabled", dest="acl_enabled",
                    action="store_const", const=True, default=None)
    ag.add_argument("-region", default=None)
    ag.add_argument("-authoritative-region", dest="authoritative_region",
                    default=None)
    ag.add_argument("-rpc-port", dest="rpc_port", type=int, default=None)
    ag.add_argument("-gossip-port", dest="gossip_port", type=int,
                    default=None)
    ag.add_argument("-join", action="append", default=[],
                    help="gossip seed host:port (repeatable)")
    ag.add_argument("-bootstrap-expect", dest="bootstrap_expect", type=int,
                    default=None, help="N>1: wait for N servers then "
                    "bootstrap together; 1: bootstrap now; 0: wait to be "
                    "adopted by an existing leader")
    ag.add_argument("-replication-token", dest="replication_token",
                    default=None, help="management token of the "
                    "authoritative region (ACL replication)")
    ag.add_argument("-plugin-dir", dest="plugin_dir", default=None,
                    help="directory of external driver plugin executables")
    ag.add_argument("-config", action="append", default=[],
                    help="HCL/JSON agent config file or directory "
                    "(repeatable; merged in order, flags override)")
    ag.set_defaults(fn=cmd_agent)

    job = sub.add_parser("job")
    jsub = job.add_subparsers(dest="job_cmd", required=True)
    jr = jsub.add_parser("run")
    jr.add_argument("spec")
    jr.add_argument("-detach", action="store_true")
    jr.add_argument("-var", action="append")
    jr.set_defaults(fn=cmd_job_run)
    jp = jsub.add_parser("plan")
    jp.add_argument("spec")
    jp.add_argument("-var", action="append")
    jp.add_argument("-verbose", action="store_true", dest="verbose",
                    help="show unchanged context fields in the diff")
    jp.set_defaults(fn=cmd_job_plan)
    jv = jsub.add_parser("validate")
    jv.add_argument("spec")
    jv.add_argument("-var", action="append")
    jv.set_defaults(fn=cmd_job_validate)
    ji = jsub.add_parser("inspect")
    ji.add_argument("job_id")
    ji.set_defaults(fn=cmd_job_inspect)
    js = jsub.add_parser("status")
    js.add_argument("job_id", nargs="?", default="")
    js.set_defaults(fn=cmd_job_status)
    jst = jsub.add_parser("stop")
    jst.add_argument("job_id")
    jst.add_argument("-purge", action="store_true")
    jst.set_defaults(fn=cmd_job_stop)
    jd = jsub.add_parser("dispatch")
    jd.add_argument("job_id")
    jd.add_argument("-meta", action="append")
    jd.set_defaults(fn=cmd_job_dispatch)
    jsc = jsub.add_parser("scale")
    jsc.add_argument("job_id")
    jsc.add_argument("group")
    jsc.add_argument("count")
    jsc.set_defaults(fn=cmd_job_scale)
    jrv = jsub.add_parser("revert")
    jrv.add_argument("job_id")
    jrv.add_argument("version")
    jrv.set_defaults(fn=cmd_job_revert)
    jh = jsub.add_parser("history")
    jh.add_argument("job_id")
    jh.set_defaults(fn=cmd_job_history)
    je = jsub.add_parser("eval")
    je.add_argument("job_id")
    je.add_argument("-force-reschedule", dest="force_reschedule",
                    action="store_true")
    je.set_defaults(fn=cmd_job_eval)
    jpf = jsub.add_parser("periodic")
    jpfsub = jpf.add_subparsers(dest="periodic_cmd", required=True)
    jpff = jpfsub.add_parser("force")
    jpff.add_argument("job_id")
    jpff.set_defaults(fn=cmd_job_periodic_force)
    jdps = jsub.add_parser("deployments")
    jdps.add_argument("job_id")
    jdps.set_defaults(fn=cmd_job_deployments)

    node = sub.add_parser("node")
    nsub = node.add_subparsers(dest="node_cmd", required=True)
    ns = nsub.add_parser("status")
    ns.add_argument("node_id", nargs="?", default="")
    ns.set_defaults(fn=cmd_node_status)
    nd = nsub.add_parser("drain")
    nd.add_argument("node_id")
    nd.add_argument("-enable", action="store_true")
    nd.add_argument("-disable", dest="enable", action="store_false")
    nd.add_argument("-deadline", type=float, default=3600.0)
    nd.add_argument("-ignore-system", dest="ignore_system",
                    action="store_true")
    nd.add_argument("-monitor", action="store_true",
                    help="block and stream drain progress until done")
    nd.set_defaults(fn=cmd_node_drain)
    ne = nsub.add_parser("eligibility")
    ne.add_argument("node_id")
    ne.add_argument("-enable", action="store_true")
    ne.add_argument("-disable", dest="enable", action="store_false")
    ne.set_defaults(fn=cmd_node_eligibility)

    alloc = sub.add_parser("alloc")
    asub = alloc.add_subparsers(dest="alloc_cmd", required=True)
    ast = asub.add_parser("status")
    ast.add_argument("alloc_id")
    ast.set_defaults(fn=cmd_alloc_status)
    aex = asub.add_parser("exec")
    aex.add_argument("alloc_id")
    aex.add_argument("-task", default="")
    aex.add_argument("-tty", action="store_true")
    aex.add_argument("command", nargs=argparse.REMAINDER)
    aex.set_defaults(fn=cmd_alloc_exec)
    asg = asub.add_parser("signal")
    asg.add_argument("alloc_id")
    asg.add_argument("-task", default="")
    asg.add_argument("-s", dest="signal", default="SIGUSR1")
    asg.set_defaults(fn=cmd_alloc_signal)
    ars = asub.add_parser("restart")
    ars.add_argument("alloc_id")
    ars.add_argument("-task", default="")
    ars.set_defaults(fn=cmd_alloc_restart)
    asp = asub.add_parser("stop")
    asp.add_argument("alloc_id")
    asp.set_defaults(fn=cmd_alloc_stop)
    afs = asub.add_parser("fs")
    afs.add_argument("alloc_id")
    afs.add_argument("path", nargs="?", default="/")
    afs.add_argument("-stat", action="store_true")
    afs.set_defaults(fn=cmd_alloc_fs)
    alg = asub.add_parser("logs")
    alg.add_argument("alloc_id")
    alg.add_argument("-task", default="")
    alg.add_argument("-stderr", action="store_true")
    alg.add_argument("-f", dest="follow", action="store_true")
    alg.set_defaults(fn=cmd_alloc_logs)

    ev = sub.add_parser("eval")
    esub = ev.add_subparsers(dest="eval_cmd", required=True)
    est = esub.add_parser("status")
    est.add_argument("eval_id")
    est.set_defaults(fn=cmd_eval_status)
    eli = esub.add_parser("list")
    eli.add_argument("-limit", type=int, default=50)
    eli.set_defaults(fn=cmd_eval_list)

    dep = sub.add_parser("deployment")
    dep.add_argument("action",
                     choices=["list", "status", "promote", "fail",
                              "pause", "resume"])
    dep.add_argument("id", nargs="?", default="")
    dep.set_defaults(fn=cmd_deployment)

    aclp = sub.add_parser("acl")
    aclsub = aclp.add_subparsers(dest="acl_cmd", required=True)
    ab = aclsub.add_parser("bootstrap")
    ab.set_defaults(fn=cmd_acl_bootstrap)
    apol = aclsub.add_parser("policy")
    apolsub = apol.add_subparsers(dest="policy_cmd", required=True)
    apa = apolsub.add_parser("apply")
    apa.add_argument("name")
    apa.add_argument("rules_file")
    apa.add_argument("-description", default="")
    apa.set_defaults(fn=cmd_acl_policy_apply)
    apl = apolsub.add_parser("list")
    apl.set_defaults(fn=cmd_acl_policy_list)
    apd = apolsub.add_parser("delete")
    apd.add_argument("name")
    apd.set_defaults(fn=cmd_acl_policy_delete)
    atok = aclsub.add_parser("token")
    atoksub = atok.add_subparsers(dest="token_cmd", required=True)
    atc = atoksub.add_parser("create")
    atc.add_argument("-name", default="")
    atc.add_argument("-type", default="client")
    atc.add_argument("-policy", action="append")
    atc.add_argument("-global", dest="global_", action="store_true")
    atc.set_defaults(fn=cmd_acl_token_create)
    atl = atoksub.add_parser("list")
    atl.set_defaults(fn=cmd_acl_token_list)
    ats = atoksub.add_parser("self")
    ats.set_defaults(fn=cmd_acl_token_self)
    atd = atoksub.add_parser("delete")
    atd.add_argument("accessor_id")
    atd.set_defaults(fn=cmd_acl_token_delete)

    nsp = sub.add_parser("namespace")
    nssub = nsp.add_subparsers(dest="ns_cmd", required=True)
    nsa = nssub.add_parser("apply")
    nsa.add_argument("name")
    nsa.add_argument("-description", default="")
    nsa.set_defaults(fn=cmd_namespace_apply)
    nsl = nssub.add_parser("list")
    nsl.set_defaults(fn=cmd_namespace_list)
    nsd = nssub.add_parser("delete")
    nsd.add_argument("name")
    nsd.set_defaults(fn=cmd_namespace_delete)

    op = sub.add_parser("operator")
    osub = op.add_subparsers(dest="op_cmd", required=True)
    osch = osub.add_parser("scheduler")
    osch.add_argument("action", choices=["get-config", "set-config"])
    osch.add_argument("-scheduler-algorithm", dest="scheduler_algorithm",
                      default="")
    osch.add_argument("-memory-oversubscription",
                      dest="memory_oversubscription",
                      choices=["true", "false"], default=None)
    osch.set_defaults(fn=cmd_operator_scheduler)
    oraft = osub.add_parser("raft")
    oraft.add_argument("action", choices=["list-peers", "remove-peer"])
    oraft.add_argument("-peer-id", dest="peer_id", default="")
    oraft.add_argument("-peer-address", dest="peer_address", default="")
    oraft.set_defaults(fn=cmd_operator_raft)
    osnap = osub.add_parser("snapshot")
    osnap.add_argument("action", choices=["save", "restore", "inspect"])
    osnap.add_argument("file")
    osnap.set_defaults(fn=cmd_operator_snapshot)
    oap = osub.add_parser("autopilot")
    oap.add_argument("action", choices=["get-config", "set-config", "health"])
    oap.add_argument("-cleanup-dead-servers", dest="cleanup_dead_servers",
                     choices=["true", "false"], default=None)
    oap.set_defaults(fn=cmd_operator_autopilot)
    odbg = osub.add_parser("debug")
    odbg.add_argument("-duration", default="2",
                      help="seconds of periodic capture (default 2)")
    odbg.add_argument("-interval", default="1",
                      help="seconds between metric samples (default 1)")
    odbg.add_argument("-output", default="",
                      help="bundle path (default nomad-debug-<ts>.tar.gz)")
    odbg.set_defaults(fn=cmd_operator_debug)

    system = sub.add_parser("system")
    ssub = system.add_subparsers(dest="sys_cmd", required=True)
    sgc = ssub.add_parser("gc")
    sgc.set_defaults(fn=cmd_system_gc)
    srs = ssub.add_parser("reconcile")
    srssub = srs.add_subparsers(dest="reconcile_cmd", required=True)
    srss = srssub.add_parser("summaries")
    srss.set_defaults(fn=cmd_system_reconcile_summaries)

    srv = sub.add_parser("server")
    srvsub = srv.add_subparsers(dest="srv_cmd", required=True)
    sm = srvsub.add_parser("members")
    sm.set_defaults(fn=cmd_server_members)
    sfl = srvsub.add_parser("force-leave")
    sfl.add_argument("name")
    sfl.set_defaults(fn=cmd_server_force_leave)
    sj = srvsub.add_parser("join")
    sj.add_argument("address", nargs="+")
    sj.set_defaults(fn=cmd_server_join)

    scal = sub.add_parser("scaling")
    scalsub = scal.add_subparsers(dest="scaling_cmd", required=True)
    scp = scalsub.add_parser("policy")
    scp.add_argument("policy_id", nargs="?", default="")
    scp.set_defaults(fn=cmd_scaling_policy)

    ver = sub.add_parser("version")
    ver.set_defaults(fn=cmd_version)

    st = sub.add_parser("status")
    st.set_defaults(fn=cmd_status)

    mon = sub.add_parser("monitor")
    mon.add_argument("-log-level", dest="log_level", default="info")
    mon.set_defaults(fn=cmd_monitor)

    vol = sub.add_parser("volume")
    vsub = vol.add_subparsers(dest="volume_cmd", required=True)
    vs = vsub.add_parser("status")
    vs.add_argument("volume_id", nargs="?", default="")
    vs.set_defaults(fn=cmd_volume_status)
    vr = vsub.add_parser("register")
    vr.add_argument("spec")
    vr.set_defaults(fn=cmd_volume_register)
    vd = vsub.add_parser("deregister")
    vd.add_argument("volume_id")
    vd.add_argument("-force", action="store_true")
    vd.set_defaults(fn=cmd_volume_deregister)
    vdt = vsub.add_parser("detach")
    vdt.add_argument("volume_id")
    vdt.add_argument("node_id")
    vdt.set_defaults(fn=cmd_volume_detach)

    plug = sub.add_parser("plugin")
    psub = plug.add_subparsers(dest="plugin_cmd", required=True)
    ps = psub.add_parser("status")
    ps.add_argument("plugin_id", nargs="?", default="")
    ps.set_defaults(fn=cmd_plugin_status)

    tr = sub.add_parser("trace")
    tr.add_argument("ref", nargs="?", default="",
                    help="eval id, trace id, or unique prefix; "
                         "omit to list")
    tr.add_argument("-limit", type=int, default=50)
    tr.add_argument("-chrome", default="",
                    help="write Chrome trace-event JSON to this file")
    tr.set_defaults(fn=cmd_trace)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
