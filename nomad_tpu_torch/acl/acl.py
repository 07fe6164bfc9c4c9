"""ACL capability checking (ref acl/acl.go:43 ACL, NewACL).

An ACL merges one or more parsed policies into effective capability sets.
Namespace and host-volume rules support glob patterns; on overlap the most
specific matching pattern wins (ref acl.go findClosestMatchingGlob — highest
literal-prefix length, ties broken by fewer wildcards).
"""
from __future__ import annotations

import fnmatch
from typing import Iterable, Optional

from .policy import (
    HOST_VOLUME_DENY, NS_DENY, POLICY_DENY, POLICY_LIST, POLICY_READ,
    POLICY_WRITE, Policy,
)

_LEVEL = {"": 0, POLICY_LIST: 1, POLICY_READ: 2, POLICY_WRITE: 3,
          POLICY_DENY: -1}


def _merge_coarse(a: str, b: str) -> str:
    """deny wins; otherwise the broader grant wins."""
    if POLICY_DENY in (a, b):
        return POLICY_DENY
    return a if _LEVEL.get(a, 0) >= _LEVEL.get(b, 0) else b


def _glob_specificity(pattern: str) -> tuple[int, int]:
    literal = len(pattern.split("*", 1)[0].split("?", 1)[0])
    wildcards = pattern.count("*") + pattern.count("?")
    return (literal, -wildcards)


class ACL:
    def __init__(self, management: bool = False,
                 policies: Iterable[Policy] = ()):
        self.management = management
        self._ns: dict[str, set[str]] = {}
        self._hv: dict[str, set[str]] = {}
        self.agent = ""
        self.node = ""
        self.operator = ""
        self.quota = ""
        self.plugin = ""
        for pol in policies:
            self._merge(pol)

    def _merge(self, pol: Policy) -> None:
        for np in pol.namespaces:
            caps = self._ns.setdefault(np.name, set())
            if NS_DENY in np.capabilities:
                caps.clear()
                caps.add(NS_DENY)
            elif NS_DENY not in caps:
                caps.update(np.capabilities)
        for hv in pol.host_volumes:
            caps = self._hv.setdefault(hv.name, set())
            if HOST_VOLUME_DENY in hv.capabilities:
                caps.clear()
                caps.add(HOST_VOLUME_DENY)
            elif HOST_VOLUME_DENY not in caps:
                caps.update(hv.capabilities)
        self.agent = _merge_coarse(self.agent, pol.agent)
        self.node = _merge_coarse(self.node, pol.node)
        self.operator = _merge_coarse(self.operator, pol.operator)
        self.quota = _merge_coarse(self.quota, pol.quota)
        self.plugin = _merge_coarse(self.plugin, pol.plugin)

    # -------------------------------------------------------------- lookup

    def _match(self, table: dict[str, set[str]], name: str
               ) -> Optional[set[str]]:
        if name in table:
            return table[name]
        best, best_spec = None, None
        for pattern, caps in table.items():
            if ("*" in pattern or "?" in pattern) and \
                    fnmatch.fnmatchcase(name, pattern):
                spec = _glob_specificity(pattern)
                if best_spec is None or spec > best_spec:
                    best, best_spec = caps, spec
        return best

    # -------------------------------------------------------------- checks

    def allow_namespace_operation(self, namespace: str, cap: str) -> bool:
        """ref acl.go AllowNamespaceOperation"""
        if self.management:
            return True
        caps = self._match(self._ns, namespace or "default")
        return bool(caps) and NS_DENY not in caps and cap in caps

    def allow_namespace(self, namespace: str) -> bool:
        """Any capability at all (ref acl.go AllowNamespace)."""
        if self.management:
            return True
        caps = self._match(self._ns, namespace or "default")
        return bool(caps) and NS_DENY not in caps

    def allow_host_volume_operation(self, volume: str, cap: str) -> bool:
        if self.management:
            return True
        caps = self._match(self._hv, volume)
        return bool(caps) and HOST_VOLUME_DENY not in caps and cap in caps

    def _coarse_allows(self, disp: str, write: bool) -> bool:
        if self.management:
            return True
        if disp == POLICY_DENY:
            return False
        if write:
            return disp == POLICY_WRITE
        return disp in (POLICY_READ, POLICY_WRITE)

    def allow_node_read(self) -> bool:
        return self._coarse_allows(self.node, write=False)

    def allow_node_write(self) -> bool:
        return self._coarse_allows(self.node, write=True)

    def allow_agent_read(self) -> bool:
        return self._coarse_allows(self.agent, write=False)

    def allow_agent_write(self) -> bool:
        return self._coarse_allows(self.agent, write=True)

    def allow_operator_read(self) -> bool:
        return self._coarse_allows(self.operator, write=False)

    def allow_operator_write(self) -> bool:
        return self._coarse_allows(self.operator, write=True)

    def allow_quota_read(self) -> bool:
        return self._coarse_allows(self.quota, write=False)

    def allow_quota_write(self) -> bool:
        return self._coarse_allows(self.quota, write=True)

    def allow_plugin_read(self) -> bool:
        return self._coarse_allows(self.plugin, write=False)

    def allow_plugin_list(self) -> bool:
        # list is a plugin-only disposition weaker than read
        # (ref acl/acl.go AllowPluginList)
        if self.management:
            return True
        return self.plugin == POLICY_LIST or \
            self._coarse_allows(self.plugin, write=False)

    def is_management(self) -> bool:
        return self.management


MANAGEMENT_ACL = ACL(management=True)


def parse_acl(policy_sources: Iterable[str]) -> ACL:
    from .policy import parse_policy
    return ACL(policies=[parse_policy(src) for src in policy_sources])
