"""LOCK002/LOCK003 — interprocedural lock discipline (ProjectRules).

LOCK002: the held-lock -> acquired-lock relation, collected across the
approximate call graph (depth-2 resolution), must be acyclic. A cycle
means two call paths can take the same pair of locks in opposite orders
— the classic static deadlock candidate, and exactly the
cache-lock/mesh-rebuild re-entrancy shape PR 14 had to untangle by hand.
Re-entrant self-acquisition is flagged only for plain `threading.Lock`
(RLock and Condition re-entry is legal by construction).

LOCK003: a blocking call — `time.sleep`, device sync (`device_get`,
`block_until_ready`), raft apply, disk I/O (`open`/`fsync`), socket ops
— reachable within two resolved calls while a server/solver hot-path
lock is held stalls every thread queued on that lock. Audited sites
(e.g. the sharding launch lock serializing device dispatch by design)
carry an inline `# nomadlint: disable=LOCK003 — why` at the call site,
which is the supported seam; whole-file exemptions don't exist on
purpose.
"""
from __future__ import annotations

from .core import Finding, ProjectRule, register

_SOCKET_OPS = {"accept", "connect", "recv", "recvfrom", "sendall",
               "makefile", "getaddrinfo"}


def blocking_desc(dotted) -> str:
    """Human name of the blocking operation `dotted` performs, or ""
    when the call isn't in the blocking vocabulary."""
    if not dotted:
        return ""
    parts = dotted.split(".")
    last = parts[-1]
    if dotted == "time.sleep":
        return "time.sleep"
    if last in ("device_get", "block_until_ready"):
        return f"device sync ({last})"
    if dotted in ("os.fsync", "os.fdatasync"):
        return dotted
    if dotted == "open":
        return "file open()"
    if len(parts) >= 2 and last == "apply" and \
            parts[-2] in ("raft", "raft_node", "_raft"):
        return "raft apply (consensus round trip)"
    if len(parts) >= 2 and last in _SOCKET_OPS:
        return f"socket/pipe {last}()"
    return ""


def _in_scope(mod) -> bool:
    p = "/" + mod.match_path.lstrip("/")
    return "/server/" in p or "/solver/" in p


def _lock_label(key: str) -> str:
    """Shorten `nomad_tpu_torch.server.eval_broker.EvalBroker._lock` to
    `eval_broker.EvalBroker._lock` for messages."""
    parts = key.split(".")
    return ".".join(parts[-3:]) if len(parts) > 3 else key


def _sccs(nodes, adj):
    """Tarjan strongly-connected components, iterative (the lock graph
    is tiny, but recursion limits are not ours to spend)."""
    index = {}
    low = {}
    on_stack = set()
    stack = []
    out = []
    counter = [0]
    for root in sorted(nodes):
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(adj.get(nxt, ())))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    top = stack.pop()
                    on_stack.discard(top)
                    comp.append(top)
                    if top == node:
                        break
                out.append(sorted(comp))
    return out


@register
class LockOrderCycle(ProjectRule):
    id = "LOCK002"
    severity = "error"
    short = ("cross-class lock-order cycle across the call graph — "
             "static deadlock candidate")

    def check_project(self, index) -> list:
        edges = index.lock_edges(depth=2)
        adj: dict = {}
        for (a, b), _ in edges.items():
            if a != b:
                adj.setdefault(a, set()).add(b)
        nodes = set(adj)
        for targets in adj.values():
            nodes |= targets
        out = []
        for comp in _sccs(nodes, adj):
            if len(comp) < 2:
                continue
            comp_set = set(comp)
            cyc_edges = sorted((a, b) for (a, b) in edges
                               if a in comp_set and b in comp_set and a != b)
            legs = []
            for a, b in cyc_edges:
                fi, node, via = edges[(a, b)]
                where = f"{fi.mod.path}:{getattr(node, 'lineno', 0)}"
                suffix = f" {via}" if via else ""
                legs.append(f"{_lock_label(a)} -> {_lock_label(b)} "
                            f"at {where}{suffix}")
            fi, node, _ = edges[cyc_edges[0]]
            out.append(fi.mod.finding(
                self, node,
                "lock-order cycle among {" +
                ", ".join(_lock_label(k) for k in comp) + "}: " +
                "; ".join(legs) +
                " — pick one global acquisition order or collapse to a "
                "single lock"))
        # re-entrant self-acquisition of a non-reentrant Lock
        for (a, b) in sorted(edges):
            if a != b or index.lock_kinds.get(a) != "Lock":
                continue
            fi, node, via = edges[(a, b)]
            suffix = f" {via}" if via else ""
            out.append(fi.mod.finding(
                self, node,
                f"re-acquisition of non-reentrant {_lock_label(a)} while "
                f"already held{suffix} — self-deadlock; use an RLock or "
                f"split out a *_locked helper"))
        return out


@register
class BlockingUnderLock(ProjectRule):
    id = "LOCK003"
    severity = "error"
    short = ("blocking call (sleep / device sync / raft apply / disk / "
             "socket) reachable while a server/solver lock is held")

    def check_project(self, index) -> list:
        out = []
        for qual in sorted(index.functions):
            fi = index.functions[qual]
            if not _in_scope(fi.mod):
                continue
            seen = set()        # (lock, op): first witness per function
            for node, held, dotted in fi.calls:
                if not held:
                    continue
                lock = _lock_label(held[-1])
                desc = blocking_desc(dotted)
                if desc:
                    if (lock, desc) in seen:
                        continue
                    seen.add((lock, desc))
                    out.append(fi.mod.finding(
                        self, node,
                        f"{fi.cls + '.' if fi.cls else ''}{fi.name} calls "
                        f"{desc} while holding {lock} — move it outside "
                        f"the lock or take a snapshot first"))
                    continue
                callee = index.resolve_call(fi, dotted)
                if not callee:
                    continue
                chain = index.blocking_chain(callee, depth=1,
                                             is_blocking=blocking_desc)
                if chain:
                    if (lock, callee) in seen:
                        continue
                    seen.add((lock, callee))
                    cname = index.functions[callee].name
                    out.append(fi.mod.finding(
                        self, node,
                        f"{fi.cls + '.' if fi.cls else ''}{fi.name} holds "
                        f"{lock} while calling {cname}(), which reaches "
                        f"{chain} — blocking under a hot-path lock"))
        return out
