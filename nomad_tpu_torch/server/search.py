"""Search: prefix and fuzzy matching across state objects (ref
nomad/search_endpoint.go Search.PrefixSearch / Search.FuzzySearch).

Contexts mirror the reference (structs/search.go Context values); results
are truncated at TRUNCATE_LIMIT per context with a truncation flag so the
CLI/UI can show "and more...".
"""
from __future__ import annotations

from typing import Optional

# ref nomad/search_endpoint.go truncateLimit
TRUNCATE_LIMIT = 20

CTX_ALL = "all"
CTX_JOBS = "jobs"
CTX_EVALS = "evals"
CTX_ALLOCS = "allocs"
CTX_NODES = "nodes"
CTX_DEPLOYMENTS = "deployment"
CTX_NAMESPACES = "namespaces"
CTX_SCALING_POLICIES = "scaling_policy"
CTX_PLUGINS = "plugins"
CTX_VOLUMES = "volumes"

# contexts scoped to a namespace (ACL-checked per namespace); nodes and
# plugins are cluster-scoped
NS_CONTEXTS = (CTX_JOBS, CTX_EVALS, CTX_ALLOCS, CTX_DEPLOYMENTS,
               CTX_SCALING_POLICIES, CTX_VOLUMES)


def _collect(state, context: str, ns: Optional[str]) -> list[tuple[str, str]]:
    """Yield (id, namespace) pairs for one context. ns=None means all."""
    if context == CTX_JOBS:
        return [(j.id, j.namespace) for j in state.iter_jobs(ns)]
    if context == CTX_EVALS:
        return [(e.id, e.namespace) for e in state.iter_evals()
                if ns is None or e.namespace == ns]
    if context == CTX_ALLOCS:
        return [(a.id, a.namespace) for a in state.iter_allocs()
                if ns is None or a.namespace == ns]
    if context == CTX_NODES:
        return [(n.id, "") for n in state.iter_nodes()]
    if context == CTX_DEPLOYMENTS:
        return [(d.id, d.namespace) for d in state.iter_deployments()
                if ns is None or d.namespace == ns]
    if context == CTX_NAMESPACES:
        return [(n["name"], "") for n in state.iter_namespaces()]
    if context == CTX_SCALING_POLICIES:
        return [(p.id, p.target_key()[0])
                for p in state.iter_scaling_policies(ns)]
    if context == CTX_PLUGINS:
        iter_plugins = getattr(state, "iter_csi_plugins", None)
        return [(p.id, "") for p in iter_plugins()] if iter_plugins else []
    if context == CTX_VOLUMES:
        iter_vols = getattr(state, "iter_csi_volumes", None)
        if iter_vols is None:
            return []
        return [(v.id, v.namespace) for v in iter_vols()
                if ns is None or v.namespace == ns]
    return []


def _fuzzy_score(text: str, pattern: str) -> Optional[int]:
    """Subsequence match; lower score = tighter match (ref fuzzy search's
    substring semantics — we accept substrings first, subsequences after)."""
    t, p = text.lower(), pattern.lower()
    pos = t.find(p)
    if pos >= 0:
        return pos  # substring: rank by how early it starts
    # subsequence fallback, scored by span length
    start = ti = 0
    for i, ch in enumerate(p):
        ti = t.find(ch, ti)
        if ti < 0:
            return None
        if i == 0:
            start = ti
        ti += 1
    return 100 + (ti - start)


def _ctx_allowed(ctx: str, acl) -> bool:
    """Cluster-scoped contexts mirror their direct endpoints' ACLs (ref
    search_endpoint.go sufficientSearchPerms): nodes need node:read,
    plugins need plugin:read; namespace contexts filter per object."""
    if acl is None:
        return True
    if ctx == CTX_NODES:
        return acl.allow_node_read()
    if ctx == CTX_PLUGINS:
        return acl.allow_plugin_read()
    return True


def prefix_search(state, prefix: str, context: str = CTX_ALL,
                  namespace: Optional[str] = "default",
                  acl=None) -> dict:
    """ref Search.PrefixSearch: exact-prefix id matching per context."""
    contexts = ([CTX_JOBS, CTX_EVALS, CTX_ALLOCS, CTX_NODES, CTX_DEPLOYMENTS,
                 CTX_NAMESPACES, CTX_SCALING_POLICIES, CTX_PLUGINS,
                 CTX_VOLUMES]
                if context in (CTX_ALL, "") else [context])
    ns = None if namespace in ("*", None) else namespace
    matches: dict[str, list[str]] = {}
    truncations: dict[str, bool] = {}
    for ctx in contexts:
        if not _ctx_allowed(ctx, acl):
            continue
        ids = []
        for oid, ons in _collect(state, ctx, ns):
            if not oid.startswith(prefix):
                continue
            if acl is not None and ctx in NS_CONTEXTS \
                    and not acl.allow_namespace(ons):
                continue
            if acl is not None and ctx == CTX_NAMESPACES \
                    and not acl.allow_namespace(oid):
                continue
            ids.append(oid)
        ids.sort()
        truncations[ctx] = len(ids) > TRUNCATE_LIMIT
        matches[ctx] = ids[:TRUNCATE_LIMIT]
    return {"Matches": matches, "Truncations": truncations,
            "Index": state.latest_index()}


def fuzzy_search(state, text: str, context: str = CTX_ALL,
                 namespace: Optional[str] = "default",
                 acl=None) -> dict:
    """ref Search.FuzzySearch: name-based fuzzy matching. Jobs additionally
    expose scoped matches (task groups, tasks) like the reference."""
    ns = None if namespace in ("*", None) else namespace
    matches: dict[str, list[dict]] = {}
    truncations: dict[str, bool] = {}

    def add(ctx, entries):
        entries.sort(key=lambda e: e[0])
        truncations[ctx] = len(entries) > TRUNCATE_LIMIT
        if entries:
            matches[ctx] = [e[1] for e in entries[:TRUNCATE_LIMIT]]

    contexts = ([CTX_JOBS, CTX_NODES, CTX_ALLOCS, CTX_NAMESPACES,
                 CTX_PLUGINS]
                if context in (CTX_ALL, "") else [context])
    for ctx in contexts:
        if not _ctx_allowed(ctx, acl):
            continue
        entries = []
        if ctx == CTX_JOBS:
            groups, tasks = [], []
            for j in state.iter_jobs(ns):
                if acl is not None and not acl.allow_namespace(j.namespace):
                    continue
                sc = _fuzzy_score(j.name or j.id, text)
                if sc is not None:
                    entries.append(
                        (sc, {"ID": j.id, "Scope": [j.namespace, j.id]}))
                for tg in j.task_groups:
                    sc = _fuzzy_score(tg.name, text)
                    if sc is not None:
                        groups.append((sc, {
                            "ID": tg.name,
                            "Scope": [j.namespace, j.id]}))
                    for t in tg.tasks:
                        sc = _fuzzy_score(t.name, text)
                        if sc is not None:
                            tasks.append((sc, {
                                "ID": t.name,
                                "Scope": [j.namespace, j.id, tg.name]}))
            add(CTX_JOBS, entries)
            add("groups", groups)
            add("tasks", tasks)
            continue
        if ctx == CTX_NODES:
            for n in state.iter_nodes():
                sc = _fuzzy_score(n.name, text)
                if sc is not None:
                    entries.append((sc, {"ID": n.name, "Scope": [n.id]}))
        elif ctx == CTX_ALLOCS:
            for a in state.iter_allocs():
                if ns is not None and a.namespace != ns:
                    continue
                if acl is not None and not acl.allow_namespace(a.namespace):
                    continue
                sc = _fuzzy_score(a.name, text)
                if sc is not None:
                    entries.append((sc, {"ID": a.name,
                                         "Scope": [a.namespace, a.id]}))
        elif ctx == CTX_NAMESPACES:
            for n in state.iter_namespaces():
                if acl is not None and not acl.allow_namespace(n["name"]):
                    continue
                sc = _fuzzy_score(n["name"], text)
                if sc is not None:
                    entries.append((sc, {"ID": n["name"], "Scope": []}))
        elif ctx == CTX_PLUGINS:
            for pid, _ in _collect(state, CTX_PLUGINS, None):
                sc = _fuzzy_score(pid, text)
                if sc is not None:
                    entries.append((sc, {"ID": pid, "Scope": []}))
        add(ctx, entries)
    return {"Matches": matches, "Truncations": truncations,
            "Index": state.latest_index()}
