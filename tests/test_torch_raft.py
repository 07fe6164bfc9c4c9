"""The port's three-server Raft cluster against the reference's, on the CPU.

`server/raft.py`, `server/durable.py`, `server/gossip.py`,
`rpc/virtual.py` and `tlsutil.py` are byte copies of the reference's.
Both packages build a cluster the way tests/test_raft.py's
`make_cluster` does (one `VirtualNetwork(seed)`, election jitter seeded
per node id) and run one scenario from one seeded os.urandom stream, so
they mint the same eval and alloc ids:

  * a batch job (the depth solve), a spread service job (the chunked
    scan) and a job under the "convex" algorithm: the alloc maps (alloc
    name -> node name) are equal between the two leaders, and every
    follower's store equals its leader's at the leader's index;
  * the leader is crashed the moment its applier commits its second
    plan (tests/test_failover.py's `_run_failover_scenario` shape, with
    `net.crash`); the new leader re-drives every pending eval, the maps
    are still equal, no plan is lost or duplicated, and the surviving
    follower's store equals the new leader's;
  * the leader loop's autopilot steps tick (`nomad.autopilot.promote_tick`)
    and no ModuleNotFoundError reaches the log;
  * the operator Raft peer list has the reference's shape;
  * gossip membership converges and a mutual-TLS RPC round trip works
    with the port's own `tlsutil`.

Every wait is bounded and every server is shut down in a `finally`.
"""
import time
import types

import jax  # noqa: F401  (the reference runs on the CPU backend)
import numpy as np
import pytest
import torch

from nomad_tpu_torch.solver import backend, microbatch, state_cache
from nomad_tpu_torch.solver.device import use_device
from nomad_tpu_torch.testing import park_follower_workers, seeded_urandom

# wider than tests/test_raft.py's FAST profile: the scenario compares
# placements, and an election mid-eval would re-drive it
TIMING = dict(election_timeout=(2.0, 4.0), heartbeat_interval=0.1)
DEADLINE_S = 30.0
N_NODES = 24


def _modules(pkg: str):
    if pkg == "ref":
        from nomad_tpu import mock, structs
        from nomad_tpu.metrics import metrics
        from nomad_tpu.rpc.virtual import VirtualNetwork
        from nomad_tpu.server import Server
        from nomad_tpu.solver import backend as be
    else:
        from nomad_tpu_torch import mock, structs
        from nomad_tpu_torch.metrics import metrics
        from nomad_tpu_torch.rpc.virtual import VirtualNetwork
        from nomad_tpu_torch.server import Server
        be = backend
    return types.SimpleNamespace(mock=mock, structs=structs, metrics=metrics,
                                 VirtualNetwork=VirtualNetwork, Server=Server,
                                 backend=be)


def _wait(fn, what, timeout: float = DEADLINE_S) -> None:
    """Poll fn until it holds; `what` names the wait (or is a callable
    that describes the state when the wait fails)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(
        f"timed out waiting for {what() if callable(what) else what}")


def stable_leader(servers, timeout: float = DEADLINE_S):
    """The one established leader every live server agrees on."""
    found = {}

    def one():
        led = [s for s in servers if s.raft_node.is_leader()]
        if len(led) == 1 and led[0].is_leader and all(
                s.raft_node.leadership()[1] == led[0].rpc_addr
                for s in servers):
            found["s"] = led[0]
            return True
        return False
    _wait(one, "a stable leader", timeout)
    return found["s"]


def make_cluster(m, n=3, seed=0, logger=None, tmp_path=None, workers=1):
    """tests/test_raft.py's make_cluster over package `m`, each server's
    idle workers waiting while their broker is off
    (testing.park_follower_workers)."""
    net = m.VirtualNetwork(seed=seed)
    servers = []
    for i in range(n):
        s = m.Server(num_workers=workers, gc_interval=9999, logger=logger)
        # no client heartbeats here: keep the registered nodes up
        s.heartbeats.min_ttl = 3600.0
        s.rpc_listen_virtual(net, f"s{i}")
        servers.append(s)
    peers = {f"s{i}": s.rpc_addr for i, s in enumerate(servers)}
    for i, s in enumerate(servers):
        s.enable_raft(f"s{i}", peers,
                      data_dir=str(tmp_path / f"raft{i}") if tmp_path
                      else None, seed=seed * 1000 + i, **TIMING)
        s.start()
        # the followers' workers would spin on their disabled brokers
        park_follower_workers(s)
    return net, servers


def _quiet(srv) -> bool:
    st = srv.eval_broker.stats
    return (st["total_ready"] == 0 and st["total_unacked"] == 0
            and st.get("total_pending", 0) == 0
            and srv.planner.queue.depth() == 0
            and all(e.status != "pending" for e in srv.state.iter_evals()))


def settle(srv) -> None:
    def settled():
        if not _quiet(srv):
            return False
        time.sleep(0.15)
        return _quiet(srv)
    _wait(settled, lambda: (
        f"the leader to go quiet: {srv.eval_broker.stats}, plan queue "
        f"{srv.planner.queue.depth()}, pending "
        f"{[(e.job_id, e.triggered_by) for e in srv.state.iter_evals() if e.status == 'pending']}"))


def store_digest(srv) -> dict:
    """What a replicated store must agree on: allocations, evals, jobs,
    nodes, the usage sums and the applied index."""
    s = srv.state
    view = s.usage.view()
    return {
        "allocs": sorted((a.id, a.name, a.node_id, a.desired_status,
                          a.client_status) for a in s.iter_allocs()),
        "evals": sorted((e.id, e.status) for e in s.iter_evals()),
        "jobs": sorted((j.namespace, j.id, j.version)
                       for j in s.iter_jobs()),
        "nodes": sorted(n.id for n in s.iter_nodes()),
        "used": np.asarray(view.used, np.float64).sum(axis=0).tolist(),
        "index": s.latest_index(),
    }


def caught_up(leader, followers):
    """Wait for every follower to apply the leader's commit index; then
    each store must equal the leader's."""
    want = leader.raft_node.commit_index
    _wait(lambda: all(f.raft_node.last_applied >= want for f in followers),
          "the followers to apply the leader's index")
    _wait(lambda: all(store_digest(f) == store_digest(leader)
                      for f in followers), "the followers' stores")


def alloc_map(srv, job_ids) -> dict:
    s = srv.state
    return {a.name: s.node_by_id(a.node_id).name
            for j in job_ids for a in s.allocs_by_job("default", j)
            if not a.terminal_status()}


def _node(mock, i, rng):
    n = mock.node()
    n.id = f"raft-node-{i:06d}"
    n.name = f"raft-{i}"
    n.datacenter = f"dc{i % 3 + 1}"
    n.node_resources.cpu.cpu_shares = int(rng.choice([4_000, 8_000]))
    n.node_resources.memory.memory_mb = int(rng.choice([8_192, 16_384]))
    return n


def _job(m, job_id, kind, count, cpu=250, mem=128, spread=False):
    job = m.mock.batch_job() if kind == "batch" else m.mock.job()
    job.id = job.name = job_id
    job.datacenters = ["dc1", "dc2", "dc3"]
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    tg.tasks[0].resources.cpu = cpu
    tg.tasks[0].resources.memory_mb = mem
    tg.tasks[0].resources.networks = []
    if spread:
        job.spreads = [m.structs.Spread(attribute="${node.datacenter}",
                                        weight=100)]
    return job


def _set_algorithm(m, leader, name):
    leader.set_scheduler_configuration(
        m.structs.SchedulerConfiguration(scheduler_algorithm=name))


STEADY = (("batch-a", "batch", 40, "tpu-batch", False),
          ("web", "service", 12, "tpu-batch", True),
          ("convex-c", "batch", 9, "convex", False))
FAILOVER = (("fo-0", "batch", 6, False), ("fo-1", "service", 4, True),
            ("fo-2", "batch", 5, False), ("fo-3", "batch", 7, False))


def run_cluster(pkg: str, seed: int = 3) -> dict:
    """The steady scenario, then the leader crash; what the tests read."""
    m = _modules(pkg)
    logs = []
    ticks0 = m.metrics.counter("nomad.autopilot.promote_tick")
    convex0 = m.metrics.counter("nomad.solver.dispatch.convex")
    out = {"steps": []}
    net, servers = make_cluster(m, seed=seed, logger=logs.append)
    try:
        leader = stable_leader(servers)
        term0 = leader.raft_node.current_term
        rng = np.random.default_rng(seed)
        for i in range(N_NODES):
            leader.node_register(_node(m.mock, i, rng))
        settle(leader)
        for job_id, kind, count, algo, spread in STEADY:
            _set_algorithm(m, leader, algo)
            leader.job_register(_job(m, job_id, kind, count, spread=spread))
            settle(leader)
            followers = [s for s in servers if s is not leader]
            caught_up(leader, followers)
            out["steps"].append((job_id, alloc_map(leader, [job_id]),
                                 len(leader.state.allocs_by_job(
                                     "default", job_id))))
        out["convex_dispatches"] = \
            m.metrics.counter("nomad.solver.dispatch.convex") - convex0
        out["steady_term_moved"] = leader.raft_node.current_term != term0
        cfg = leader.operator_raft_configuration()
        out["raft_config"] = cfg
        _set_algorithm(m, leader, "tpu-batch")
        settle(leader)

        # park the leader's worker; register while it is healthy
        for w in leader.workers:
            w.stop()
            w.join(2.0)
        for job_id, kind, count, spread in FAILOVER:
            leader.job_register(_job(m, job_id, kind, count, spread=spread))
        _wait(lambda: all(s.state.job_by_id("default", FAILOVER[-1][0])
                          is not None for s in servers), "the registers")
        lid = leader.raft_node.node_id
        orig_apply = leader.raft_node.apply
        commits = []

        def tripwire(msg_type, payload, timeout=30.0, fence=None):
            if msg_type.startswith("ApplyPlanResults"):
                commits.append(msg_type)
                if len(commits) == 2:
                    net.crash(lid)
            return orig_apply(msg_type, payload, timeout=timeout,
                              fence=fence)
        leader.raft_node.apply = tripwire
        for w in leader.workers:
            w.start()
        rest = [s for s in servers if s is not leader]
        new = stable_leader(rest)
        assert len(commits) >= 2, "the plan-commit tripwire never fired"
        ids = [j for j, *_ in FAILOVER]

        def placed():
            return all(len([a for a in new.state.allocs_by_job("default", j)
                            if not a.terminal_status()]) == c
                       for j, _, c, _ in FAILOVER)
        _wait(placed, "the re-driven evals")
        settle(new)
        caught_up(new, [s for s in rest if s is not new])
        out["failover_map"] = alloc_map(new, ids)
        out["failover_ids"] = [
            sorted(a.id for j in ids for a in s.state.allocs_by_job(
                "default", j) if not a.terminal_status()) for s in rest]
        out["failover_counts"] = {
            j: len([a for a in new.state.allocs_by_job("default", j)
                    if not a.terminal_status()]) for j in ids}
        out["ticks"] = m.metrics.counter("nomad.autopilot.promote_tick") - \
            ticks0
    finally:
        for s in servers:
            s.shutdown()
    out["logs"] = list(logs)
    return out


@pytest.fixture(scope="module")
def runs():
    prev, threads = use_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    ref_be = _modules("ref").backend
    for mod in (backend, microbatch, ref_be):
        mod.reset()
    state_cache.reset()
    try:
        out = {}
        for pkg in ("ref", "port"):
            with seeded_urandom(17):
                out[pkg] = run_cluster(pkg)
        yield out
    finally:
        for mod in (backend, microbatch, ref_be):
            mod.reset()
        state_cache.reset()
        torch.set_num_threads(threads)
        use_device(prev)


@pytest.mark.parametrize("step", [s[0] for s in STEADY])
def test_leaders_place_each_job_as_the_reference(runs, step):
    want = dict((s, (mp, n)) for s, mp, n in runs["ref"]["steps"])[step]
    got = dict((s, (mp, n)) for s, mp, n in runs["port"]["steps"])[step]
    assert got == want
    count = next(c for s, _, c, _, _ in STEADY if s == step)
    assert len(got[0]) == count


def test_the_convex_job_ran_the_convex_solve(runs):
    assert runs["port"]["convex_dispatches"] >= 1
    assert runs["ref"]["convex_dispatches"] >= 1


def test_no_election_during_the_steady_scenario(runs):
    assert not runs["port"]["steady_term_moved"]
    assert not runs["ref"]["steady_term_moved"]


def test_failover_redrives_every_eval_as_the_reference(runs):
    assert runs["port"]["failover_map"] == runs["ref"]["failover_map"]
    assert runs["port"]["failover_counts"] == {
        j: c for j, _, c, _ in FAILOVER}


def test_failover_loses_and_duplicates_no_plan(runs):
    for pkg in ("ref", "port"):
        a, b = runs[pkg]["failover_ids"]
        assert a == b, pkg
        assert len(set(a)) == len(a) == sum(c for _, _, c, _ in FAILOVER)


def test_autopilot_ticks_and_no_module_is_missing(runs):
    assert runs["port"]["ticks"] > 0
    bad = [line for line in runs["port"]["logs"]
           if "ModuleNotFoundError" in line or "ImportError" in line]
    assert not bad, bad[:5]


def _shape(cfg):
    return [(s["ID"], s["Node"], s["Address"], s["Voter"], s["RaftProtocol"],
             sorted(s)) for s in cfg["Servers"]]


def test_operator_raft_configuration_has_the_references_shape(runs):
    got, want = runs["port"]["raft_config"], runs["ref"]["raft_config"]
    assert _shape(got) == _shape(want)
    assert [s["ID"] for s in got["Servers"]] == ["s0", "s1", "s2"]
    assert sum(s["Leader"] for s in got["Servers"]) == 1
    assert sorted(got) == sorted(want)


def test_gossip_membership_converges():
    from nomad_tpu_torch.server.gossip import Gossip
    nodes = [Gossip(f"tg{i}", interval=0.05, suspect_timeout=0.6,
                    probe_timeout=0.2) for i in range(3)]
    try:
        for g in nodes:
            g.start()
        seed = nodes[0].addr
        assert nodes[1].join([seed]) == 1
        assert nodes[2].join([seed]) == 1
        _wait(lambda: all(len(g.alive_members()) == 3 for g in nodes),
              "gossip membership", timeout=10)
    finally:
        for g in nodes:
            g.shutdown()


def test_server_gossip_listen_tags_its_rpc_address():
    from nomad_tpu_torch.rpc.virtual import VirtualNetwork
    from nomad_tpu_torch.server import Server
    s = Server(num_workers=0, gc_interval=9999, name="gossip-0")
    try:
        s.rpc_listen_virtual(VirtualNetwork(seed=1), "gossip-0")
        s.gossip_listen()
        me = [mb for mb in s.gossip.alive_members()]
        assert len(me) == 1
        assert me[0].tags["rpc_addr"] == s.rpc_addr
        assert me[0].tags["role"] == "nomad-server"
    finally:
        if s.gossip:
            s.gossip.shutdown()
        s.shutdown()


def test_tls_rpc_round_trip_with_the_ports_tlsutil(tmp_path):
    pytest.importorskip("cryptography")
    from nomad_tpu_torch.rpc.client import RpcClient
    from nomad_tpu_torch.rpc.server import RpcServer
    from nomad_tpu_torch.tlsutil import TLSConfig, generate_ca, generate_cert
    d = str(tmp_path)
    ca, cakey = generate_ca(d)
    cert, key = generate_cert(d, ca, cakey, "server.global.nomad")
    tls = TLSConfig(enable_rpc=True, ca_file=ca, cert_file=cert,
                    key_file=key, region="global")
    srv = RpcServer(port=0, tls=tls)
    srv.register("Echo.Echo", lambda x: {"got": x})
    srv.start()
    try:
        with RpcClient([srv.addr], tls=tls) as cli:
            assert cli.call("Echo.Echo", 41) == {"got": 41}
    finally:
        srv.shutdown()
