"""Jobspec parser: HCL source → `Job` dataclass.

Behavioral reference: `jobspec2/parse.go:19` (hcl/v2 pipeline with variables
and custom functions) and the per-section HCL1 decoders in `jobspec/parse.go`
— re-implemented fresh against our dataclass model. Sections follow the
public jobspec language: job > group > task, with constraint/affinity/
spread/update/migrate/restart/reschedule/periodic/parameterized/network/
service/volume/scaling/resources/logs/artifact/template/lifecycle blocks.

Durations are strings ("30s", "10m", "1h30m") converted to seconds, the
dataclasses' native unit.
"""
from __future__ import annotations

import re
from typing import Any, Optional

from ..structs import (
    Affinity, Constraint, DispatchPayloadConfig, DNSConfig, EphemeralDisk,
    Job, LogConfig, MigrateStrategy, Multiregion, NetworkResource,
    ParameterizedJobConfig, PeriodicConfig, Port, RequestedDevice,
    ReschedulePolicy, Resources, RestartPolicy, ScalingPolicy, Service,
    Spread, SpreadTarget, Task, TaskArtifact, TaskGroup, TaskLifecycle,
    Template, VolumeMount, VolumeRequest, UpdateStrategy,
    OP_DISTINCT_HOSTS, OP_DISTINCT_PROPERTY, OP_EQ, OP_REGEX, OP_SEMVER,
    OP_SET_CONTAINS, OP_SET_CONTAINS_ALL, OP_SET_CONTAINS_ANY, OP_VERSION,
    OP_IS_SET, OP_IS_NOT_SET,
)
from .hcl import (
    Attribute, Block, Body, EvalContext, HCLError, Unknown, parse as
    hcl_parse,
)


class ParseError(Exception):
    pass


_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h|d)")
_DUR_UNIT = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
             "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def duration(v: Any) -> float:
    """'1h30m' → 5400.0 seconds; bare numbers are taken as seconds."""
    if isinstance(v, (int, float)):
        return float(v)
    if not isinstance(v, str) or not v:
        raise ParseError(f"invalid duration {v!r}")
    pos, total = 0, 0.0
    for m in _DUR_RE.finditer(v):
        if m.start() != pos:
            raise ParseError(f"invalid duration {v!r}")
        total += float(m.group(1)) * _DUR_UNIT[m.group(2)]
        pos = m.end()
    if pos != len(v):
        raise ParseError(f"invalid duration {v!r}")
    return total


class _Section:
    """Evaluated view of a block body: attributes as a dict + child blocks."""

    def __init__(self, body: Body, ctx: EvalContext, where: str):
        self.body = body
        self.ctx = ctx
        self.where = where
        self.attrs: dict[str, Any] = {}
        for name, attr in body.attributes().items():
            try:
                self.attrs[name] = ctx.evaluate(attr.expr)
            except Unknown as e:
                raise ParseError(
                    f"{where}: unknown variable {e.root!r} in {name!r} "
                    f"(line {attr.line})")
            except HCLError as e:
                raise ParseError(f"{where}: {e}")
        self.unused = set(self.attrs)

    def get(self, name: str, default=None):
        self.unused.discard(name)
        return self.attrs.get(name, default)

    def dur(self, name: str, default: float) -> float:
        v = self.get(name)
        return default if v is None else duration(v)

    def blocks(self, type: str) -> list[Block]:
        return self.body.blocks(type)

    def block(self, type: str) -> Optional[Block]:
        bs = self.blocks(type)
        if len(bs) > 1:
            raise ParseError(f"{self.where}: duplicate {type!r} block")
        return bs[0] if bs else None

    def sub(self, block: Block, label: str = "") -> "_Section":
        where = f"{self.where} > {block.type}" + (f" {label!r}" if label
                                                  else "")
        return _Section(block.body, self.ctx, where)


# -------------------------------------------------------------- variables

_TYPE_DEFAULTS = {"string": "", "number": 0, "bool": False,
                  "list": [], "map": {}, "any": None}


def _declare_variables(top: Body, ctx: EvalContext,
                       overrides: dict[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for blk in top.blocks("variable"):
        if len(blk.labels) != 1:
            raise ParseError("variable block needs exactly one label")
        name = blk.labels[0]
        attrs = blk.body.attributes()
        default = None
        if "default" in attrs:
            default = ctx.evaluate(attrs["default"].expr)
        if name in overrides:
            val = overrides[name]
            # coerce strings from -var flags toward the declared type
            if "type" in attrs and isinstance(val, str):
                tname = _type_name(attrs["type"].expr)
                if tname == "number":
                    val = float(val) if "." in val else int(val)
                elif tname == "bool":
                    val = val in ("true", "1")
            out[name] = val
        elif default is not None:
            out[name] = default
        else:
            raise ParseError(f"missing required variable {name!r}")
    extra = set(overrides) - set(out)
    if extra:
        raise ParseError(f"undeclared variables: {sorted(extra)}")
    return out


def _type_name(expr) -> str:
    # `type = string` parses as ("var", "string"); list(string) as a call
    if expr[0] == "var":
        return expr[1]
    if expr[0] == "call":
        return expr[1]
    return "any"


# -------------------------------------------------------------- sections

def _parse_constraints(sec: _Section) -> list[Constraint]:
    from .hcl import _to_string
    out = []
    for blk in sec.blocks("constraint"):
        c = sec.sub(blk)
        operand = c.get("operator", OP_EQ)
        l, r = c.get("attribute", ""), _to_string(c.get("value", ""))
        skip = False
        # sugar forms (ref jobspec/parse.go parseConstraints):
        #   distinct_hosts = true          -> operand only
        #   distinct_property = "${meta.rack}" [value = "2"]
        #                                  -> ltarget = property, rtarget = n
        #   regexp/version/... = "expr"    -> rtarget = expr
        for sugar in (OP_REGEX, OP_VERSION, OP_SEMVER, OP_SET_CONTAINS,
                      OP_SET_CONTAINS_ALL, OP_SET_CONTAINS_ANY):
            if c.get(sugar) is not None:
                operand = sugar
                r = _to_string(c.attrs[sugar])
        if c.get(OP_DISTINCT_HOSTS) is not None:
            if c.attrs[OP_DISTINCT_HOSTS] in (False, "false"):
                skip = True
            operand = OP_DISTINCT_HOSTS
        if c.get(OP_DISTINCT_PROPERTY) is not None:
            operand = OP_DISTINCT_PROPERTY
            l = _to_string(c.attrs[OP_DISTINCT_PROPERTY])
        if operand in (OP_IS_SET, OP_IS_NOT_SET):
            r = ""
        if not skip:
            out.append(Constraint(ltarget=l, rtarget=r, operand=operand))
    return out


def _parse_affinities(sec: _Section) -> list[Affinity]:
    out = []
    from .hcl import _to_string
    for blk in sec.blocks("affinity"):
        a = sec.sub(blk)
        out.append(Affinity(
            ltarget=a.get("attribute", ""),
            rtarget=_to_string(a.get("value", "")),
            operand=a.get("operator", OP_EQ),
            weight=int(a.get("weight", 50))))
    return out


def _parse_spreads(sec: _Section) -> list[Spread]:
    out = []
    for blk in sec.blocks("spread"):
        s = sec.sub(blk)
        targets = []
        for tblk in s.blocks("target"):
            t = s.sub(tblk)
            targets.append(SpreadTarget(
                value=tblk.labels[0] if tblk.labels else t.get("value", ""),
                percent=int(t.get("percent", 0))))
        out.append(Spread(attribute=s.get("attribute", ""),
                          weight=int(s.get("weight", 50)),
                          spread_target=targets))
    return out


def _parse_network(sec: _Section, blk: Block) -> NetworkResource:
    n = sec.sub(blk)
    net = NetworkResource(mode=n.get("mode", "host"),
                          mbits=int(n.get("mbits", 0)))
    for pblk in blk.body.blocks("port"):
        p = sec.sub(pblk, pblk.labels[0] if pblk.labels else "")
        label = pblk.labels[0] if pblk.labels else ""
        port = Port(label=label,
                    value=int(p.get("static", 0)),
                    to=int(p.get("to", 0)),
                    host_network=p.get("host_network", "default"))
        (net.reserved_ports if port.value else net.dynamic_ports).append(port)
    dblk = n.block("dns")
    if dblk:
        d = sec.sub(dblk)
        net.dns = DNSConfig(servers=d.get("servers", []) or [],
                            searches=d.get("searches", []) or [],
                            options=d.get("options", []) or [])
    return net


def _parse_service(sec: _Section, blk: Block) -> Service:
    s = sec.sub(blk)
    checks = []
    for cblk in blk.body.blocks("check"):
        c = sec.sub(cblk)
        checks.append({
            "Name": c.get("name", ""), "Type": c.get("type", ""),
            "Path": c.get("path", ""), "Command": c.get("command", ""),
            "Args": c.get("args", []) or [],
            "Interval": c.dur("interval", 10.0),
            "Timeout": c.dur("timeout", 2.0),
            "PortLabel": c.get("port", ""),
            "Protocol": c.get("protocol", ""),
            "Method": c.get("method", ""),
            "InitialStatus": c.get("initial_status", ""),
            "AddressMode": c.get("address_mode", ""),
            # ref job_endpoint_hook_expose_check.go: route this check
            # through a dedicated sidecar expose listener
            "Expose": bool(c.get("expose", False)),
        })
    connect = None
    cblk = s.block("connect")
    if cblk:
        c = sec.sub(cblk)
        connect = {"Native": bool(c.get("native", False))}
        sp = c.block("sidecar_service")
        if sp is not None:
            sps = sec.sub(sp)
            sc: dict = {"Port": sps.get("port", "")}
            pblk = sp.body.blocks("proxy") if hasattr(sp, "body") else []
            for pb in pblk:
                ups = []
                for ub in pb.body.blocks("upstreams"):
                    u = sec.sub(ub)
                    ups.append({
                        "DestinationName": u.get("destination_name", ""),
                        "LocalBindPort": int(u.get("local_bind_port", 0)),
                    })
                sc["Proxy"] = {"Upstreams": ups}
            connect["SidecarService"] = sc
    return Service(name=s.get("name", ""),
                   port_label=str(s.get("port", "")),
                   tags=[str(t) for t in (s.get("tags", []) or [])],
                   checks=checks, connect=connect,
                   provider=s.get("provider", "builtin"))


def _parse_resources(sec: _Section, blk: Block) -> Resources:
    r = sec.sub(blk)
    res = Resources(
        cpu=int(r.get("cpu", 100)),
        cores=int(r.get("cores", 0)),
        memory_mb=int(r.get("memory", 300)),
        memory_max_mb=int(r.get("memory_max", 0)),
        disk_mb=int(r.get("disk", 0)))
    for nblk in blk.body.blocks("network"):
        res.networks.append(_parse_network(r, nblk))
    for dblk in blk.body.blocks("device"):
        d = r.sub(dblk)
        res.devices.append(RequestedDevice(
            name=dblk.labels[0] if dblk.labels else "",
            count=int(d.get("count", 1)),
            constraints=_parse_constraints(d),
            affinities=_parse_affinities(d)))
    return res


def _parse_task(sec: _Section, blk: Block) -> Task:
    t = sec.sub(blk, blk.labels[0] if blk.labels else "")
    task = Task(
        name=blk.labels[0] if blk.labels else "",
        driver=t.get("driver", ""),
        user=t.get("user", ""),
        config=t.get("config", {}) or {},
        env=_str_map(t.get("env", {})),
        meta=_str_map(t.get("meta", {})),
        kill_timeout_sec=t.dur("kill_timeout", 5.0),
        shutdown_delay_sec=t.dur("shutdown_delay", 0.0),
        kill_signal=t.get("kill_signal", ""),
        leader=bool(t.get("leader", False)),
        constraints=_parse_constraints(t),
        affinities=_parse_affinities(t))
    cfg = t.block("config")
    if cfg:
        task.config = dict(task.config)
        task.config.update(_config_dict(sec.sub(cfg)))
    envb = t.block("env")
    if envb:
        task.env = dict(task.env)
        task.env.update(_str_map(_config_dict(sec.sub(envb))))
    metab = t.block("meta")
    if metab:
        task.meta = dict(task.meta)
        task.meta.update(_str_map(_config_dict(sec.sub(metab))))
    rblk = t.block("resources")
    if rblk:
        task.resources = _parse_resources(t, rblk)
    lblk = t.block("logs")
    if lblk:
        l = t.sub(lblk)
        task.log_config = LogConfig(
            max_files=int(l.get("max_files", 10)),
            max_file_size_mb=int(l.get("max_file_size", 10)))
    for ablk in blk.body.blocks("artifact"):
        a = t.sub(ablk)
        task.artifacts.append(TaskArtifact(
            getter_source=a.get("source", ""),
            getter_options=_str_map(a.get("options", {})),
            relative_dest=a.get("destination", "local/")))
    for tblk in blk.body.blocks("template"):
        tm = t.sub(tblk)
        task.templates.append(Template(
            source_path=tm.get("source", ""),
            dest_path=tm.get("destination", ""),
            embedded_tmpl=tm.get("data", ""),
            change_mode=tm.get("change_mode", "restart"),
            change_signal=tm.get("change_signal", ""),
            perms=tm.get("perms", "0644")))
    lcblk = t.block("lifecycle")
    if lcblk:
        lc = t.sub(lcblk)
        task.lifecycle = TaskLifecycle(hook=lc.get("hook", ""),
                                       sidecar=bool(lc.get("sidecar", False)))
    dpblk = t.block("dispatch_payload")
    if dpblk:
        dp = t.sub(dpblk)
        task.dispatch_payload = DispatchPayloadConfig(file=dp.get("file", ""))
    for vmblk in blk.body.blocks("volume_mount"):
        vm = t.sub(vmblk)
        task.volume_mounts.append(VolumeMount(
            volume=vm.get("volume", ""),
            destination=vm.get("destination", ""),
            read_only=bool(vm.get("read_only", False))))
    for sblk in blk.body.blocks("service"):
        task.services.append(_parse_service(t, sblk))
    return task


def _config_dict(sec: _Section) -> dict:
    """A config-style block: free-form attributes + nested blocks as dicts."""
    out = dict(sec.attrs)
    for blk in sec.body.items:
        if isinstance(blk, Block):
            sub = _config_dict(sec.sub(blk))
            if blk.labels:
                out.setdefault(blk.type, {})
                d = out[blk.type]
                for lbl in blk.labels[:-1]:
                    d = d.setdefault(lbl, {})
                d[blk.labels[-1]] = sub
            else:
                out[blk.type] = sub
    return out


def _str_map(m) -> dict[str, str]:
    if not m:
        return {}
    from .hcl import _to_string
    return {str(k): _to_string(v) for k, v in m.items()}


def _parse_group(sec: _Section, blk: Block, job: Job) -> TaskGroup:
    g = sec.sub(blk, blk.labels[0] if blk.labels else "")
    tg = TaskGroup(
        name=blk.labels[0] if blk.labels else "",
        count=int(g.get("count", 1)),
        constraints=_parse_constraints(g),
        affinities=_parse_affinities(g),
        spreads=_parse_spreads(g),
        shutdown_delay_sec=g.dur("shutdown_delay", 0.0),
        meta=_str_map(g.get("meta", {})))
    metab = g.block("meta")
    if metab:
        tg.meta = dict(tg.meta)
        tg.meta.update(_str_map(_config_dict(sec.sub(metab))))
    if g.get("stop_after_client_disconnect") is not None:
        tg.stop_after_client_disconnect_sec = duration(
            g.attrs["stop_after_client_disconnect"])
    if g.get("max_client_disconnect") is not None:
        tg.max_client_disconnect_sec = duration(
            g.attrs["max_client_disconnect"])
    rblk = g.block("restart")
    if rblk:
        r = g.sub(rblk)
        tg.restart_policy = RestartPolicy(
            attempts=int(r.get("attempts", 2)),
            interval_sec=r.dur("interval", 1800.0),
            delay_sec=r.dur("delay", 15.0),
            mode=r.get("mode", "fail"))
    rsblk = g.block("reschedule")
    if rsblk:
        rs = g.sub(rsblk)
        tg.reschedule_policy = ReschedulePolicy(
            attempts=int(rs.get("attempts", 0)),
            interval_sec=rs.dur("interval", 0.0),
            delay_sec=rs.dur("delay", 30.0),
            delay_function=rs.get("delay_function", "exponential"),
            max_delay_sec=rs.dur("max_delay", 3600.0),
            unlimited=bool(rs.get("unlimited",
                                  "attempts" not in rs.attrs)))
    ublk = g.block("update")
    if ublk:
        tg.update = _parse_update(g, ublk)
    mblk = g.block("migrate")
    if mblk:
        m = g.sub(mblk)
        tg.migrate = MigrateStrategy(
            max_parallel=int(m.get("max_parallel", 1)),
            health_check=m.get("health_check", "checks"),
            min_healthy_time_sec=m.dur("min_healthy_time", 10.0),
            healthy_deadline_sec=m.dur("healthy_deadline", 300.0))
    eblk = g.block("ephemeral_disk")
    if eblk:
        e = g.sub(eblk)
        tg.ephemeral_disk = EphemeralDisk(
            sticky=bool(e.get("sticky", False)),
            size_mb=int(e.get("size", 300)),
            migrate=bool(e.get("migrate", False)))
    for nblk in blk.body.blocks("network"):
        tg.networks.append(_parse_network(g, nblk))
    for vblk in blk.body.blocks("volume"):
        v = g.sub(vblk)
        name = vblk.labels[0] if vblk.labels else ""
        tg.volumes[name] = VolumeRequest(
            name=name, type=v.get("type", "host"),
            source=v.get("source", ""),
            read_only=bool(v.get("read_only", False)),
            access_mode=v.get("access_mode", ""),
            attachment_mode=v.get("attachment_mode", ""),
            per_alloc=bool(v.get("per_alloc", False)))
    scblk = g.block("scaling")
    if scblk:
        sc = g.sub(scblk)
        pol = sc.block("policy")
        tg.scaling = ScalingPolicy(
            min=int(sc.get("min", tg.count)),
            max=int(sc.get("max", tg.count)),
            enabled=bool(sc.get("enabled", True)),
            policy=_config_dict(g.sub(pol)) if pol else {})
    for sblk in blk.body.blocks("service"):
        tg.services.append(_parse_service(g, sblk))
    for tblk in blk.body.blocks("task"):
        tg.tasks.append(_parse_task(g, tblk))
    return tg


def _parse_update(sec: _Section, blk: Block) -> UpdateStrategy:
    u = sec.sub(blk)
    return UpdateStrategy(
        stagger_sec=u.dur("stagger", 30.0),
        max_parallel=int(u.get("max_parallel", 1)),
        health_check=u.get("health_check", "checks"),
        min_healthy_time_sec=u.dur("min_healthy_time", 10.0),
        healthy_deadline_sec=u.dur("healthy_deadline", 300.0),
        progress_deadline_sec=u.dur("progress_deadline", 600.0),
        auto_revert=bool(u.get("auto_revert", False)),
        auto_promote=bool(u.get("auto_promote", False)),
        canary=int(u.get("canary", 0)))


# ------------------------------------------------------------------- entry

def parse(src: str, variables: Optional[dict[str, Any]] = None,
          name: str = "<jobspec>") -> Job:
    """Parse HCL jobspec source into a Job."""
    try:
        top = hcl_parse(src)
    except HCLError as e:
        raise ParseError(f"{name}: {e}")

    base = EvalContext()
    var_vals = _declare_variables(top, base, variables or {})
    ctx = base.child(var=var_vals)
    # locals may reference var (single pass, then a fixpoint pass for
    # local-to-local references)
    local_vals: dict[str, Any] = {}
    for lblk in top.blocks("locals"):
        for n, attr in lblk.body.attributes().items():
            try:
                local_vals[n] = ctx.child(local=local_vals).evaluate(attr.expr)
            except Unknown as e:
                raise ParseError(f"locals: unknown variable {e.root!r}")
    ctx = ctx.child(local=local_vals)

    jobs = top.blocks("job")
    if len(jobs) != 1:
        raise ParseError(f"{name}: expected exactly one job block, "
                         f"got {len(jobs)}")
    jblk = jobs[0]
    if len(jblk.labels) != 1:
        raise ParseError("job block needs exactly one label")
    sec = _Section(jblk.body, ctx, f"job {jblk.labels[0]!r}")

    job = Job(
        id=sec.get("id", jblk.labels[0]),
        name=sec.get("name", jblk.labels[0]),
        namespace=sec.get("namespace", "default"),
        region=sec.get("region", "global"),
        type=sec.get("type", "service"),
        priority=int(sec.get("priority", 50)),
        all_at_once=bool(sec.get("all_at_once", False)),
        datacenters=[str(d) for d in sec.get("datacenters", ["dc1"])],
        meta=_str_map(sec.get("meta", {})),
        consul_token=sec.get("consul_token", ""),
        vault_token=sec.get("vault_token", ""),
        constraints=_parse_constraints(sec),
        affinities=_parse_affinities(sec),
        spreads=_parse_spreads(sec))
    metab = sec.block("meta")
    if metab:
        job.meta = dict(job.meta)
        job.meta.update(_str_map(_config_dict(sec.sub(metab))))
    ublk = sec.block("update")
    if ublk:
        job.update = _parse_update(sec, ublk)
    pblk = sec.block("periodic")
    if pblk:
        p = sec.sub(pblk)
        job.periodic = PeriodicConfig(
            enabled=bool(p.get("enabled", True)),
            spec=p.get("cron", p.get("spec", "")),
            prohibit_overlap=bool(p.get("prohibit_overlap", False)),
            timezone=p.get("time_zone", "UTC"))
    prmblk = sec.block("parameterized")
    if prmblk:
        pr = sec.sub(prmblk)
        job.parameterized = ParameterizedJobConfig(
            payload=pr.get("payload", "optional"),
            meta_required=pr.get("meta_required", []) or [],
            meta_optional=pr.get("meta_optional", []) or [])
    mrblk = sec.block("multiregion")
    if mrblk:
        mr = sec.sub(mrblk)
        strat = mr.block("strategy")
        regions = []
        for rblk in mrblk.body.blocks("region"):
            r = mr.sub(rblk)
            regions.append({"Name": rblk.labels[0] if rblk.labels else "",
                            "Count": int(r.get("count", 0)),
                            "Datacenters": r.get("datacenters", []) or []})
        job.multiregion = Multiregion(
            strategy=_config_dict(mr.sub(strat)) if strat else {},
            regions=regions)
    vblk = sec.block("vault")
    if vblk:
        sec.sub(vblk)   # accepted; token policies handled by vault stub
    for gblk in jblk.body.blocks("group"):
        job.task_groups.append(_parse_group(sec, gblk, job))
    # single-task sugar: task at job level becomes its own group
    for tblk in jblk.body.blocks("task"):
        task = _parse_task(sec, tblk)
        job.task_groups.append(TaskGroup(name=task.name, count=1,
                                         tasks=[task]))
    return job


def parse_file(path: str, variables: Optional[dict[str, Any]] = None) -> Job:
    with open(path) as f:
        src = f.read()
    if path.endswith(".json"):
        import json
        from ..api_codec import from_api
        data = json.loads(src)
        return from_api(Job, data.get("Job", data))
    return parse(src, variables, name=path)
