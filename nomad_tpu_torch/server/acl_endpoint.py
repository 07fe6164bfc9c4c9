"""ACL endpoints + token resolution (ref nomad/acl.go ResolveToken,
nomad/acl_endpoint.go ACL.* RPCs, bootstrap in acl_endpoint.go:53).

`ACLResolver` caches parsed policy objects and merged ACLs keyed by the
token's policy set — the reference's lru caches on the server
(nomad/server.go aclCache)."""
from __future__ import annotations

import threading
from typing import Optional

from ..acl import ACL, MANAGEMENT_ACL, PolicyParseError, parse_policy
from ..structs import (
    ACLPolicy, ACLToken, TOKEN_TYPE_CLIENT, TOKEN_TYPE_MANAGEMENT,
    anonymous_token,
)
from .fsm import (
    ACL_POLICY_DELETE, ACL_POLICY_UPSERT, ACL_TOKEN_BOOTSTRAP,
    ACL_TOKEN_DELETE, ACL_TOKEN_UPSERT,
)


class ACLDisabledError(Exception):
    pass


class PermissionDeniedError(Exception):
    pass


class TokenNotFoundError(Exception):
    pass


ANONYMOUS_POLICY_NAME = "anonymous"


class ACLEndpoint:
    """Mixed into / owned by the Server: self.server is the Server."""

    def __init__(self, server, enabled: bool = False):
        self.server = server
        self.enabled = enabled
        self._lock = threading.Lock()
        self._bootstrap_lock = threading.Lock()
        self._policy_cache: dict[tuple[str, int], object] = {}
        self._acl_cache: dict[tuple, ACL] = {}

    # ---------------------------------------------------------- resolution

    def resolve_token(self, secret_id: str) -> ACL:
        """ref nomad/acl.go ResolveToken. Empty secret = anonymous."""
        if not self.enabled:
            return MANAGEMENT_ACL
        state = self.server.state
        if not secret_id:
            # ref structs AnonymousACLToken: client token carrying only the
            # operator-defined "anonymous" policy; deny-all if unset
            token = anonymous_token()
            policies = [p for p in (state.acl_policy_by_name(n)
                                    for n in token.policies) if p]
            return self._acl_for_policies(policies)
        token: Optional[ACLToken] = state.acl_token_by_secret(secret_id)
        if token is None:
            raise TokenNotFoundError("ACL token not found")
        if token.is_management():
            return MANAGEMENT_ACL
        policies = []
        for name in token.policies:
            pol = state.acl_policy_by_name(name)
            if pol is not None:
                policies.append(pol)
        return self._acl_for_policies(policies)

    def _acl_for_policies(self, policies: list[ACLPolicy]) -> ACL:
        key = tuple(sorted((p.name, p.modify_index) for p in policies))
        with self._lock:
            cached = self._acl_cache.get(key)
            if cached is not None:
                return cached
        parsed = [self._parse_cached(p) for p in policies]
        acl = ACL(policies=parsed)
        with self._lock:
            if len(self._acl_cache) > 512:
                self._acl_cache.clear()
            self._acl_cache[key] = acl
        return acl

    def _parse_cached(self, pol: ACLPolicy):
        key = (pol.name, pol.modify_index)
        with self._lock:
            cached = self._policy_cache.get(key)
            if cached is not None:
                return cached
        parsed = parse_policy(pol.rules)
        with self._lock:
            if len(self._policy_cache) > 512:
                self._policy_cache.clear()
            self._policy_cache[key] = parsed
        return parsed

    # ------------------------------------------------------------ bootstrap

    def bootstrap(self) -> ACLToken:
        """One-shot management token creation (ref acl_endpoint.go:53
        Bootstrap — fails once any token exists)."""
        if not self.enabled:
            raise ACLDisabledError("ACL support disabled")
        with self._bootstrap_lock:     # serialize check-then-mint
            if self.server.state.iter_acl_tokens():
                raise PermissionDeniedError(
                    "ACL bootstrap already done")
            token = ACLToken.new(name="Bootstrap Token",
                                 type=TOKEN_TYPE_MANAGEMENT, global_=True)
            # one-shot cold path; the lock exists to serialize exactly
            # this apply against racers — nomadlint: disable=LOCK003
            self.server.raft.apply(ACL_TOKEN_BOOTSTRAP, {"tokens": [token]})
        return token

    def _require_enabled(self) -> None:
        """All ACL CRUD is rejected while ACLs are off (ref
        nomad/acl_endpoint.go: every method starts with aclDisabled check)
        — otherwise anonymous callers could persist tokens that later
        poison bootstrap."""
        if not self.enabled:
            raise ACLDisabledError("ACL support disabled")

    # -------------------------------------------------------------- policy

    def upsert_policies(self, policies: list[ACLPolicy]) -> int:
        self._require_enabled()
        for pol in policies:
            if not pol.name:
                raise ValueError("policy name required")
            try:
                parse_policy(pol.rules)
            except PolicyParseError as e:
                raise ValueError(f"invalid policy rules: {e}")
        return self.server.raft.apply(ACL_POLICY_UPSERT,
                                      {"policies": policies})

    def delete_policies(self, names: list[str]) -> int:
        self._require_enabled()
        return self.server.raft.apply(ACL_POLICY_DELETE, {"names": names})

    # -------------------------------------------------------------- tokens

    def upsert_tokens(self, tokens: list[ACLToken]) -> list[ACLToken]:
        self._require_enabled()
        out = []
        for tok in tokens:
            if tok.type not in (TOKEN_TYPE_CLIENT, TOKEN_TYPE_MANAGEMENT):
                raise ValueError(f"invalid token type {tok.type!r}")
            if tok.type == TOKEN_TYPE_CLIENT and not tok.policies:
                raise ValueError("client token requires policies")
            if tok.type == TOKEN_TYPE_MANAGEMENT and tok.policies:
                raise ValueError("management token cannot have policies")
            if not tok.accessor_id:
                fresh = ACLToken.new(name=tok.name, type=tok.type,
                                     policies=tok.policies,
                                     global_=tok.global_)
                out.append(fresh)
            else:
                existing = self.server.state.acl_token_by_accessor(
                    tok.accessor_id)
                if existing is None:
                    raise ValueError(
                        f"token {tok.accessor_id!r} does not exist")
                upd = existing.copy()
                upd.name = tok.name or existing.name
                upd.policies = tok.policies
                upd.type = tok.type
                out.append(upd)
        self.server.raft.apply(ACL_TOKEN_UPSERT, {"tokens": out})
        return out

    def delete_tokens(self, accessor_ids: list[str]) -> int:
        self._require_enabled()
        return self.server.raft.apply(ACL_TOKEN_DELETE,
                                      {"accessor_ids": accessor_ids})
