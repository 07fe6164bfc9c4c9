"""ACL policy language (ref acl/policy.go:70 Parse + capability tables).

Policies are HCL documents:

    namespace "prod-*" {
      policy       = "read"
      capabilities = ["submit-job"]
    }
    node     { policy = "write" }
    agent    { policy = "read" }
    operator { policy = "write" }
    quota    { policy = "read" }
    plugin   { policy = "list" }
    host_volume "ssd-*" { policy = "write" }

Shorthand `policy =` dispositions expand to capability sets exactly as the
reference's expandNamespacePolicy does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

POLICY_DENY = "deny"
POLICY_READ = "read"
POLICY_WRITE = "write"
POLICY_SCALE = "scale"
POLICY_LIST = "list"

# namespace capabilities (ref acl/policy.go NamespaceCapability*)
NS_DENY = "deny"
NS_LIST_JOBS = "list-jobs"
NS_PARSE_JOB = "parse-job"
NS_READ_JOB = "read-job"
NS_SUBMIT_JOB = "submit-job"
NS_DISPATCH_JOB = "dispatch-job"
NS_READ_LOGS = "read-logs"
NS_READ_FS = "read-fs"
NS_ALLOC_EXEC = "alloc-exec"
NS_ALLOC_NODE_EXEC = "alloc-node-exec"
NS_ALLOC_LIFECYCLE = "alloc-lifecycle"
NS_SENTINEL_OVERRIDE = "sentinel-override"
NS_CSI_REGISTER_PLUGIN = "csi-register-plugin"
NS_CSI_WRITE_VOLUME = "csi-write-volume"
NS_CSI_READ_VOLUME = "csi-read-volume"
NS_CSI_LIST_VOLUME = "csi-list-volume"
NS_CSI_MOUNT_VOLUME = "csi-mount-volume"
NS_LIST_SCALING_POLICIES = "list-scaling-policies"
NS_READ_SCALING_POLICY = "read-scaling-policy"
NS_READ_JOB_SCALING = "read-job-scaling"
NS_SCALE_JOB = "scale-job"

_NS_READ_CAPS = [
    NS_LIST_JOBS, NS_PARSE_JOB, NS_READ_JOB, NS_CSI_LIST_VOLUME,
    NS_CSI_READ_VOLUME, NS_READ_JOB_SCALING, NS_LIST_SCALING_POLICIES,
    NS_READ_SCALING_POLICY,
]
_NS_WRITE_CAPS = _NS_READ_CAPS + [
    NS_SCALE_JOB, NS_SUBMIT_JOB, NS_DISPATCH_JOB, NS_READ_LOGS, NS_READ_FS,
    NS_ALLOC_EXEC, NS_ALLOC_LIFECYCLE, NS_CSI_WRITE_VOLUME,
    NS_CSI_MOUNT_VOLUME,
]
_NS_SCALE_CAPS = [NS_READ_JOB_SCALING, NS_LIST_SCALING_POLICIES,
                  NS_READ_SCALING_POLICY, NS_SCALE_JOB]

_ALL_NS_CAPS = set(_NS_WRITE_CAPS) | {NS_DENY, NS_SENTINEL_OVERRIDE,
                                      NS_CSI_REGISTER_PLUGIN,
                                      NS_ALLOC_NODE_EXEC}

HOST_VOLUME_MOUNT_READONLY = "mount-readonly"
HOST_VOLUME_MOUNT_READWRITE = "mount-readwrite"
HOST_VOLUME_DENY = "deny"


class PolicyParseError(Exception):
    pass


@dataclass
class NamespacePolicy:
    name: str = "default"
    policy: str = ""
    capabilities: list[str] = field(default_factory=list)


@dataclass
class HostVolumePolicy:
    name: str = ""
    policy: str = ""
    capabilities: list[str] = field(default_factory=list)


@dataclass
class Policy:
    namespaces: list[NamespacePolicy] = field(default_factory=list)
    host_volumes: list[HostVolumePolicy] = field(default_factory=list)
    agent: str = ""
    node: str = ""
    operator: str = ""
    quota: str = ""
    plugin: str = ""
    raw: str = ""


def expand_namespace_policy(policy: str) -> list[str]:
    """ref acl/policy.go expandNamespacePolicy"""
    if policy == POLICY_DENY:
        return [NS_DENY]
    if policy == POLICY_READ:
        return list(_NS_READ_CAPS)
    if policy == POLICY_WRITE:
        return list(_NS_WRITE_CAPS)
    if policy == POLICY_SCALE:
        return list(_NS_SCALE_CAPS)
    raise PolicyParseError(f"invalid namespace policy {policy!r}")


def expand_host_volume_policy(policy: str) -> list[str]:
    if policy == POLICY_DENY:
        return [HOST_VOLUME_DENY]
    if policy == POLICY_READ:
        return [HOST_VOLUME_MOUNT_READONLY]
    if policy == POLICY_WRITE:
        return [HOST_VOLUME_MOUNT_READONLY, HOST_VOLUME_MOUNT_READWRITE]
    raise PolicyParseError(f"invalid host_volume policy {policy!r}")


_COARSE = {POLICY_DENY, POLICY_READ, POLICY_WRITE}


def parse_policy(src: str) -> Policy:
    """Parse an HCL policy document (ref acl/policy.go:253 Parse)."""
    from ..jobspec.hcl import EvalContext, HCLError, Unknown, parse
    try:
        body = parse(src)
    except HCLError as e:
        raise PolicyParseError(str(e))
    ctx = EvalContext()
    pol = Policy(raw=src)

    def attrs_of(blk) -> dict:
        out = {}
        for name, attr in blk.body.attributes().items():
            try:
                out[name] = ctx.evaluate(attr.expr)
            except Unknown as e:
                raise PolicyParseError(f"unknown variable {e.root!r}")
        return out

    for blk in body.items:
        if not hasattr(blk, "type"):
            raise PolicyParseError("top-level attributes not allowed")
        a = attrs_of(blk)
        if blk.type == "namespace":
            name = blk.labels[0] if blk.labels else "default"
            np = NamespacePolicy(
                name=name, policy=a.get("policy", ""),
                capabilities=list(a.get("capabilities", []) or []))
            if np.policy:
                if np.policy not in (_COARSE | {POLICY_SCALE}):
                    raise PolicyParseError(
                        f"invalid namespace policy {np.policy!r}")
                np.capabilities = list(dict.fromkeys(
                    expand_namespace_policy(np.policy) + np.capabilities))
            bad = set(np.capabilities) - _ALL_NS_CAPS
            if bad:
                raise PolicyParseError(
                    f"invalid namespace capabilities {sorted(bad)}")
            pol.namespaces.append(np)
        elif blk.type == "host_volume":
            name = blk.labels[0] if blk.labels else ""
            hv = HostVolumePolicy(
                name=name, policy=a.get("policy", ""),
                capabilities=list(a.get("capabilities", []) or []))
            if hv.policy:
                if hv.policy not in _COARSE:
                    raise PolicyParseError(
                        f"invalid host_volume policy {hv.policy!r}")
                hv.capabilities = list(dict.fromkeys(
                    expand_host_volume_policy(hv.policy) + hv.capabilities))
            bad = set(hv.capabilities) - {HOST_VOLUME_MOUNT_READONLY,
                                          HOST_VOLUME_MOUNT_READWRITE,
                                          HOST_VOLUME_DENY}
            if bad:
                raise PolicyParseError(
                    f"invalid host_volume capabilities {sorted(bad)}")
            pol.host_volumes.append(hv)
        elif blk.type in ("agent", "node", "operator", "quota", "plugin"):
            disp = a.get("policy", "")
            allowed = _COARSE | ({POLICY_LIST} if blk.type == "plugin"
                                 else set())
            if disp not in allowed:
                raise PolicyParseError(
                    f"invalid {blk.type} policy {disp!r}")
            setattr(pol, blk.type, disp)
        else:
            raise PolicyParseError(f"unknown policy block {blk.type!r}")
    return pol
