"""Feasibility checking (ref scheduler/feasible.go).

Source iterators + a chain of per-node checkers. The FeasibilityWrapper caches
verdicts per computed node class (ref context.go:190) — the same escape-hatch
the TPU solver keeps for irregular constraints (SURVEY.md hard part 2).
"""
from __future__ import annotations

import random
from typing import Iterable, Optional

from ..structs import (
    Node, TaskGroup, Job, Constraint,
    OP_DISTINCT_HOSTS, OP_DISTINCT_PROPERTY, OP_EQ, OP_GT, OP_GTE, OP_IS_NOT_SET,
    OP_IS_SET, OP_LT, OP_LTE, OP_NEQ, OP_REGEX, OP_SEMVER, OP_SET_CONTAINS,
    OP_SET_CONTAINS_ALL, OP_SET_CONTAINS_ANY, OP_VERSION,
)
from .context import (
    EvalContext, EVAL_COMPUTED_CLASS_ELIGIBLE, EVAL_COMPUTED_CLASS_ESCAPED,
    EVAL_COMPUTED_CLASS_IGNORE, EVAL_COMPUTED_CLASS_INELIGIBLE,
    EVAL_COMPUTED_CLASS_UNKNOWN,
)

# ---------------------------------------------------------------- versions


class Version:
    """Minimal go-version-compatible version: dotted numeric segments with an
    optional -prerelease suffix (release > prerelease)."""

    __slots__ = ("segments", "prerelease")

    def __init__(self, s: str):
        s = s.strip().lstrip("v")
        if "+" in s:               # build metadata ignored
            s = s.split("+", 1)[0]
        if "-" in s:
            core, self.prerelease = s.split("-", 1)
        else:
            core, self.prerelease = s, ""
        segs = []
        for part in core.split("."):
            segs.append(int(part))
        if not segs:
            raise ValueError(f"bad version {s!r}")
        while len(segs) < 3:
            segs.append(0)
        self.segments = tuple(segs)

    def _key(self):
        # A prerelease sorts before its release
        return (self.segments, 0 if self.prerelease == "" else -1,
                self.prerelease)

    def __lt__(self, o): return self._key() < o._key()
    def __le__(self, o): return self._key() <= o._key()
    def __gt__(self, o): return self._key() > o._key()
    def __ge__(self, o): return self._key() >= o._key()
    def __eq__(self, o): return self._key() == o._key()


def parse_version_constraint(spec: str) -> Optional[list[tuple[str, Version]]]:
    """Parse "> 1.2, <= 2.0" / "~> 1.2" into [(op, version)] or None."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        op = "="
        for candidate in ("~>", ">=", "<=", "!=", ">", "<", "="):
            if part.startswith(candidate):
                op = candidate
                part = part[len(candidate):].strip()
                break
        try:
            out.append((op, Version(part)))
        except (ValueError, TypeError):
            return None
    return out or None


def check_version_constraint(version: Version,
                             constraints: list[tuple[str, Version]]) -> bool:
    for op, cv in constraints:
        if op == "=" and not version == cv:
            return False
        if op == "!=" and not version != cv:
            return False
        if op == ">" and not version > cv:
            return False
        if op == ">=" and not version >= cv:
            return False
        if op == "<" and not version < cv:
            return False
        if op == "<=" and not version <= cv:
            return False
        if op == "~>":
            # pessimistic: >= cv and < next significant segment
            if not version >= cv:
                return False
            segs = list(cv.segments)
            # bump the second-to-last specified segment
            upper = segs[:-1]
            if len(upper) == 0:
                upper = [segs[0] + 1]
            else:
                upper[-1] += 1
            upper_v = Version(".".join(str(x) for x in upper))
            if not version < upper_v:
                return False
    return True


# ------------------------------------------------------------- resolution

def resolve_target(target: str, node: Node) -> tuple[Optional[str], bool]:
    """Resolve a constraint target against a node (ref feasible.go:748)."""
    if not target.startswith("${"):
        return target, True
    if target == "${node.unique.id}":
        return node.id, True
    if target == "${node.datacenter}":
        return node.datacenter, True
    if target == "${node.unique.name}":
        return node.name, True
    if target == "${node.class}":
        return node.node_class, True
    if target.startswith("${attr."):
        key = target[len("${attr."):-1]
        val = node.attributes.get(key)
        return val, val is not None
    if target.startswith("${meta."):
        key = target[len("${meta."):-1]
        val = node.meta.get(key)
        return val, val is not None
    return None, False


def check_constraint(ctx: EvalContext, operand: str, lval, rval,
                     lfound: bool, rfound: bool) -> bool:
    """ref feasible.go:785 checkConstraint"""
    if operand in (OP_DISTINCT_HOSTS, OP_DISTINCT_PROPERTY):
        return True  # handled by dedicated iterators
    if operand in (OP_EQ, "==", "is"):
        return lfound and rfound and lval == rval
    if operand in (OP_NEQ, "not"):
        return lval != rval
    if operand in (OP_LT, OP_LTE, OP_GT, OP_GTE):
        if not (lfound and rfound and isinstance(lval, str)
                and isinstance(rval, str)):
            return False
        return {OP_LT: lval < rval, OP_LTE: lval <= rval,
                OP_GT: lval > rval, OP_GTE: lval >= rval}[operand]
    if operand == OP_IS_SET:
        return lfound
    if operand == OP_IS_NOT_SET:
        return not lfound
    if operand in (OP_VERSION, OP_SEMVER):
        if not (lfound and rfound):
            return False
        try:
            v = Version(str(lval))
        except (ValueError, TypeError):
            return False
        cache = (ctx.cache.version_constraint if operand == OP_VERSION
                 else ctx.cache.semver_constraint)
        cons = cache.get(rval)
        if cons is None:
            cons = parse_version_constraint(str(rval))
            if cons is None:
                return False
            cache[rval] = cons
        return check_version_constraint(v, cons)
    if operand == OP_REGEX:
        if not (lfound and rfound and isinstance(lval, str)):
            return False
        r = ctx.regexp(str(rval))
        return r is not None and r.search(lval) is not None
    if operand in (OP_SET_CONTAINS, OP_SET_CONTAINS_ALL):
        if not (lfound and rfound):
            return False
        have = {p.strip() for p in str(lval).split(",")}
        return all(w.strip() in have for w in str(rval).split(","))
    if operand == OP_SET_CONTAINS_ANY:
        if not (lfound and rfound):
            return False
        have = {p.strip() for p in str(lval).split(",")}
        return any(w.strip() in have for w in str(rval).split(","))
    return False


# -------------------------------------------------------------- iterators


class FeasibleIterator:
    """Pull-iterator over feasible nodes; mirrors the reference's lazy
    iterator chain so limit/select semantics match."""

    def next(self) -> Optional[Node]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class StaticIterator(FeasibleIterator):
    """Fixed node order (ref feasible.go:74)."""

    def __init__(self, ctx: EvalContext, nodes: list[Node]):
        self.ctx = ctx
        self.nodes = list(nodes)
        self.offset = 0
        self.seen = 0

    def next(self) -> Optional[Node]:
        if self.offset == len(self.nodes):
            return None
        node = self.nodes[self.offset]
        self.offset += 1
        self.seen += 1
        self.ctx.metrics.nodes_evaluated += 1   # ref feasible.go:86
        return node

    def reset(self) -> None:
        self.offset = 0
        self.seen = 0

    def set_nodes(self, nodes: list[Node]) -> None:
        self.nodes = list(nodes)
        self.reset()


def new_random_iterator(ctx: EvalContext, nodes: list[Node],
                        rng: Optional[random.Random] = None) -> StaticIterator:
    """Shuffled static iterator (ref feasible.go:122 NewRandomIterator)."""
    nodes = list(nodes)
    (rng or random).shuffle(nodes)
    return StaticIterator(ctx, nodes)


class ChecksFeasibility:
    def feasible(self, node: Node) -> bool:
        raise NotImplementedError


class DriverChecker(ChecksFeasibility):
    """Node runs healthy drivers for all tasks (ref feasible.go:433)."""

    def __init__(self, ctx: EvalContext, drivers: Optional[set[str]] = None):
        self.ctx = ctx
        self.drivers = drivers or set()

    def set_drivers(self, drivers: set[str]) -> None:
        self.drivers = drivers

    def feasible(self, node: Node) -> bool:
        for driver in self.drivers:
            info = node.drivers.get(driver)
            if info is not None:
                if not (info.detected and info.healthy):
                    self.ctx.metrics.filter_node(node, f"missing drivers")
                    return False
                continue
            # legacy attribute form: driver.<name> = "1"
            raw = node.attributes.get(f"driver.{driver}")
            if raw not in ("1", "true", "True"):
                self.ctx.metrics.filter_node(node, "missing drivers")
                return False
        return True


class ConstraintChecker(ChecksFeasibility):
    """ref feasible.go:709"""

    def __init__(self, ctx: EvalContext, constraints: list[Constraint]):
        self.ctx = ctx
        self.constraints = constraints

    def set_constraints(self, constraints: list[Constraint]) -> None:
        self.constraints = constraints

    def feasible(self, node: Node) -> bool:
        for c in self.constraints:
            if not self._meets(c, node):
                self.ctx.metrics.filter_node(node, str(c))
                return False
        return True

    def _meets(self, c: Constraint, node: Node) -> bool:
        lval, lok = resolve_target(c.ltarget, node)
        rval, rok = resolve_target(c.rtarget, node)
        return check_constraint(self.ctx, c.operand, lval, rval, lok, rok)


class HostVolumeChecker(ChecksFeasibility):
    """Node exposes all requested host volumes (ref feasible.go:132)."""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx
        self.volumes: list = []

    def set_volumes(self, alloc_name: str, volumes: dict) -> None:
        self.volumes = []
        for req in volumes.values():
            if req.type != "host":
                continue
            source = req.source
            if req.per_alloc:
                from ..structs import alloc_name_index
                source = f"{source}[{alloc_name_index(alloc_name)}]"
            self.volumes.append((source, req.read_only))

    def feasible(self, node: Node) -> bool:
        for source, read_only in self.volumes:
            vol = node.host_volumes.get(source)
            if vol is None:
                self.ctx.metrics.filter_node(node, "missing compatible host volumes")
                return False
            if vol.read_only and not read_only:
                self.ctx.metrics.filter_node(node, "missing compatible host volumes")
                return False
        return True


class NetworkChecker(ChecksFeasibility):
    """Coarse network feasibility: host networks exist for requested port
    host_networks and required mode supported (ref feasible.go:341)."""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx
        self.network = None

    def set_network(self, network) -> None:
        self.network = network

    def feasible(self, node: Node) -> bool:
        if self.network is None:
            return True
        if self.network.mode in ("bridge", "cni") or \
           self.network.mode.startswith("cni/"):
            ok = node.attributes.get("plugins.cni.version.bridge") or \
                node.attributes.get("network.bridge", "1")
            if not ok:
                self.ctx.metrics.filter_node(node, "missing network")
                return False
        # host networks for ports
        want = set()
        for p in list(self.network.reserved_ports) + list(self.network.dynamic_ports):
            if p.host_network and p.host_network != "default":
                want.add(p.host_network)
        if want:
            have = {nn.mode for nn in node.node_resources.node_networks}
            names = set()
            for nn in node.node_resources.node_networks:
                for addr in nn.addresses:
                    names.add(addr.get("alias", ""))
            if not want <= names:
                self.ctx.metrics.filter_node(node, "missing host network")
                return False
        return True


class DeviceChecker(ChecksFeasibility):
    """Node has device instances matching every device ask, including
    count and device constraints (ref scheduler/device.go + feasible device
    checker)."""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx
        self.required: list = []

    def set_task_group(self, tg: TaskGroup) -> None:
        self.required = []
        for task in tg.tasks:
            for dev in task.resources.devices:
                self.required.append(dev)

    def feasible(self, node: Node) -> bool:
        if not self.required:
            return True
        for ask in self.required:
            if not self._has(node, ask):
                self.ctx.metrics.filter_node(node, "missing devices")
                return False
        return True

    def _has(self, node: Node, ask) -> bool:
        total = 0
        for dev in node.node_resources.devices:
            if not dev.matches(ask):
                continue
            if not self._device_meets_constraints(dev, ask):
                continue
            total += sum(1 for inst in dev.instances if inst.healthy)
        return total >= ask.count

    def _device_meets_constraints(self, dev, ask) -> bool:
        for c in ask.constraints:
            lval, lok = _resolve_device_target(c.ltarget, dev)
            rval, rok = _resolve_device_target(c.rtarget, dev)
            if not check_constraint(self.ctx, c.operand, lval, rval, lok, rok):
                return False
        return True


def _resolve_device_target(target: str, dev) -> tuple[Optional[str], bool]:
    if not target.startswith("${"):
        return target, True
    if target.startswith("${device.attr."):
        key = target[len("${device.attr."):-1]
        val = dev.attributes.get(key)
        return (str(val), True) if val is not None else (None, False)
    if target == "${device.model}":
        return dev.name, True
    if target == "${device.vendor}":
        return dev.vendor, True
    if target == "${device.type}":
        return dev.type, True
    return None, False


class CSIVolumeChecker(ChecksFeasibility):
    """Node runs healthy CSI node plugins for requested CSI volumes, and the
    volume itself is schedulable with free claims for the requested mode
    (ref feasible.go:209 CSIVolumeChecker, csi.go WriteFreeClaims)."""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx
        self.plugins: set[str] = set()
        # (volume-or-None, source, read_only) per requested CSI volume —
        # claim capacity is volume-wide, checked once per feasibility pass
        self.volumes: list[tuple] = []
        self.namespace = "default"
        self.job_id = ""

    def set_volumes(self, volumes: dict, namespace: str = "default",
                    csi_volume_lookup=None, job_id: str = "") -> None:
        self.plugins = set()
        self.volumes = []
        self.namespace = namespace
        self.job_id = job_id
        if csi_volume_lookup is None:
            by_id = getattr(self.ctx.state, "csi_volume_by_id", None)
            if by_id is not None:
                csi_volume_lookup = lambda src: by_id(namespace, src)  # noqa: E731
        for req in volumes.values():
            if req.type == "csi":
                vol = None
                plugin = None
                if csi_volume_lookup is not None:
                    vol = csi_volume_lookup(req.source)
                    plugin = getattr(vol, "plugin_id", None) if vol else None
                self.plugins.add(plugin or req.source)
                self.volumes.append(
                    (vol, req.source, getattr(req, "read_only", False)))

    def feasible(self, node: Node) -> bool:
        if not self.plugins:
            return True
        for vol, source, read_only in self.volumes:
            if vol is not None:
                if not getattr(vol, "schedulable", True):
                    self.ctx.metrics.filter_node(
                        node, f"CSI volume {source} unschedulable")
                    return False
                mode = "read" if read_only else "write"
                if not vol.claim_ok(mode) and \
                        not self._claims_held_by_this_job(vol):
                    self.ctx.metrics.filter_node(
                        node, f"CSI volume {source} has no free claims")
                    return False
        for plugin in self.plugins:
            info = node.csi_node_plugins.get(plugin)
            if info is None or not info.get("healthy", False):
                self.ctx.metrics.filter_node(node, "missing CSI plugins")
                return False
        return True

    def _claims_held_by_this_job(self, vol) -> bool:
        """Claims held by allocs of the job being scheduled don't block it:
        a rolling update / reschedule of the claim-holding job must be able
        to place its replacement (ref feasible.go: blocking write claims
        only filter when they belong to a different job)."""
        if not self.job_id:
            return False
        alloc_by_id = getattr(self.ctx.state, "alloc_by_id", None)
        if alloc_by_id is None:
            return False
        for claim in vol.write_claims.values():
            alloc = alloc_by_id(claim.alloc_id)
            if alloc is None or alloc.namespace != self.namespace or \
                    alloc.job_id != self.job_id:
                return False
        return True


class FeasibilityWrapper(FeasibleIterator):
    """Wraps a source iterator with job-level and task-group-level checks,
    caching verdicts per computed node class (ref feasible.go
    FeasibilityWrapper + context.go EvalEligibility)."""

    def __init__(self, ctx: EvalContext, source: FeasibleIterator,
                 job_checks: list[ChecksFeasibility],
                 tg_checks: list[ChecksFeasibility],
                 tg_available: Optional[list[ChecksFeasibility]] = None):
        self.ctx = ctx
        self.source = source
        self.job_checks = job_checks
        self.tg_checks = tg_checks
        # "available" checks depend on state outside the computed node class
        # (CSI plugin health) so they can never be class-cached
        # (ref feasible.go FeasibilityWrapper tgAvailable)
        self.tg_available = tg_available or []
        self.tg_name = ""

    def set_task_group(self, tg: str) -> None:
        self.tg_name = tg

    def reset(self) -> None:
        self.source.reset()

    def next(self) -> Optional[Node]:
        elig = self.ctx.eligibility
        while True:
            node = self.source.next()
            if node is None:
                return None
            klass = node.computed_class

            # job-level
            job_status = elig.job_status(klass)
            if job_status == EVAL_COMPUTED_CLASS_INELIGIBLE:
                # fast path still counts (ref feasible.go FeasibilityWrapper:
                # FilterNode "computed class ineligible")
                self.ctx.metrics.filter_node(node, "computed class ineligible")
                continue
            if job_status in (EVAL_COMPUTED_CLASS_UNKNOWN,
                              EVAL_COMPUTED_CLASS_ESCAPED,
                              EVAL_COMPUTED_CLASS_IGNORE):
                ok = all(c.feasible(node) for c in self.job_checks)
                if job_status == EVAL_COMPUTED_CLASS_UNKNOWN:
                    elig.set_job_eligibility(ok, klass)
                if not ok:
                    continue

            # task-group-level
            if self.tg_name:
                tg_status = elig.task_group_status(self.tg_name, klass)
                if tg_status == EVAL_COMPUTED_CLASS_INELIGIBLE:
                    self.ctx.metrics.filter_node(node,
                                                 "computed class ineligible")
                    continue
                if tg_status in (EVAL_COMPUTED_CLASS_UNKNOWN,
                                 EVAL_COMPUTED_CLASS_ESCAPED,
                                 EVAL_COMPUTED_CLASS_IGNORE):
                    ok = all(c.feasible(node) for c in self.tg_checks)
                    if tg_status == EVAL_COMPUTED_CLASS_UNKNOWN:
                        elig.set_task_group_eligibility(ok, self.tg_name, klass)
                    if not ok:
                        continue
                if not all(c.feasible(node) for c in self.tg_available):
                    continue
            return node


class DistinctHostsIterator(FeasibleIterator):
    """distinct_hosts: no two allocs of the same job/tg on one node
    (ref feasible.go:505)."""

    def __init__(self, ctx: EvalContext, source: FeasibleIterator):
        self.ctx = ctx
        self.source = source
        self.tg = None
        self.job = None

    def set_task_group(self, tg): self.tg = tg
    def set_job(self, job): self.job = job

    def reset(self) -> None:
        self.source.reset()

    def _enabled(self) -> bool:
        if self.job and any(c.operand == OP_DISTINCT_HOSTS
                            for c in self.job.constraints):
            return True
        return bool(self.tg and any(c.operand == OP_DISTINCT_HOSTS
                                    for c in self.tg.constraints))

    def next(self) -> Optional[Node]:
        enabled = self._enabled()
        while True:
            node = self.source.next()
            if node is None or not enabled:
                return node
            if self._satisfies(node):
                return node
            self.ctx.metrics.filter_node(node, OP_DISTINCT_HOSTS)

    def _satisfies(self, node: Node) -> bool:
        proposed = self.ctx.proposed_allocs(node.id)
        job_level = any(c.operand == OP_DISTINCT_HOSTS
                        for c in self.job.constraints) if self.job else False
        for alloc in proposed:
            if job_level:
                if self.job and alloc.job_id == self.job.id and \
                   alloc.namespace == self.job.namespace:
                    return False
            elif self.tg and alloc.task_group == self.tg.name and \
                    self.job and alloc.job_id == self.job.id:
                return False
        return True


class DistinctPropertyIterator(FeasibleIterator):
    """distinct_property: bound number of allocs per property value
    (ref feasible.go:604), backed by PropertySet."""

    def __init__(self, ctx: EvalContext, source: FeasibleIterator):
        self.ctx = ctx
        self.source = source
        self.job = None
        self.tg = None
        self.job_property_sets: list = []
        self.tg_property_sets: list = []

    def set_job(self, job) -> None:
        from .propertyset import PropertySet
        self.job = job
        self.job_property_sets = []
        for c in job.constraints:
            if c.operand == OP_DISTINCT_PROPERTY:
                ps = PropertySet(self.ctx, job)
                ps.set_job_constraint(c)
                self.job_property_sets.append(ps)

    def set_task_group(self, tg) -> None:
        from .propertyset import PropertySet
        self.tg = tg
        self.tg_property_sets = []
        for c in tg.constraints:
            if c.operand == OP_DISTINCT_PROPERTY:
                ps = PropertySet(self.ctx, self.job)
                ps.set_tg_constraint(c, tg.name)
                self.tg_property_sets.append(ps)

    def reset(self) -> None:
        self.source.reset()

    def next(self) -> Optional[Node]:
        while True:
            node = self.source.next()
            if node is None:
                return None
            ok = True
            for ps in self.job_property_sets + self.tg_property_sets:
                satisfied, reason = ps.satisfies_distinct_properties(node)
                if not satisfied:
                    self.ctx.metrics.filter_node(node, reason)
                    ok = False
                    break
            if ok:
                return node
