"""ACL system: policy language, capability sets, token resolution
(ref acl/acl.go, acl/policy.go)."""
from .acl import ACL, MANAGEMENT_ACL, parse_acl
from .policy import (
    HostVolumePolicy, NamespacePolicy, Policy, PolicyParseError,
    expand_namespace_policy, parse_policy,
    NS_ALLOC_EXEC, NS_ALLOC_LIFECYCLE, NS_CSI_LIST_VOLUME,
    NS_CSI_MOUNT_VOLUME, NS_CSI_READ_VOLUME, NS_CSI_REGISTER_PLUGIN,
    NS_CSI_WRITE_VOLUME, NS_DENY, NS_DISPATCH_JOB,
    NS_LIST_JOBS, NS_LIST_SCALING_POLICIES, NS_PARSE_JOB, NS_READ_FS,
    NS_READ_JOB, NS_READ_JOB_SCALING, NS_READ_LOGS, NS_READ_SCALING_POLICY,
    NS_SCALE_JOB, NS_SUBMIT_JOB,
)

__all__ = [
    "ACL", "MANAGEMENT_ACL", "parse_acl", "parse_policy", "Policy",
    "NamespacePolicy", "HostVolumePolicy", "PolicyParseError",
    "expand_namespace_policy",
    "NS_ALLOC_EXEC", "NS_ALLOC_LIFECYCLE", "NS_CSI_LIST_VOLUME",
    "NS_CSI_MOUNT_VOLUME", "NS_CSI_READ_VOLUME", "NS_CSI_REGISTER_PLUGIN",
    "NS_CSI_WRITE_VOLUME", "NS_DENY", "NS_DISPATCH_JOB",
    "NS_LIST_JOBS", "NS_LIST_SCALING_POLICIES", "NS_PARSE_JOB", "NS_READ_FS",
    "NS_READ_JOB", "NS_READ_JOB_SCALING", "NS_READ_LOGS",
    "NS_READ_SCALING_POLICY", "NS_SCALE_JOB", "NS_SUBMIT_JOB",
]
