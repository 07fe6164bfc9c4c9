"""The port's durable Raft storage against the reference's, on the CPU.

`server/durable.py` (the CRC-framed WAL, the manifest, the fsync
discipline) and `server/raft.py` are byte copies of the reference's.
These tests hold the port's cluster to what tests/test_crash_recovery.py
holds the reference's to:

  * a three-server port cluster with a `data_dir` each, shut down and
    built again over the same dirs, comes back with every store equal
    to the one it had, field for field;
  * torn appends (the crash-point sweep's `disk.append` torn cases) lose
    no acknowledged entry at fsync=always, and recover the same prefix
    on the port as on the reference from the same script and fault;
  * mid-file damage in a follower's WAL quarantines the log and the
    follower recovers from its own snapshot and the leader's catch-up;
  * the port's WAL, snapshot and meta files name only `nomad_tpu_torch`
    and standard-library modules in their pickles (a data dir written
    by one package is not read by the other);
  * the standby twin: a follower's replicated plan results advance the
    state cache, and the promotion's reseed is warm with twins equal,
    bit for bit, to a fresh reseed's (tests/test_failover.py's
    `test_follower_standby_twin_feeds_and_promotes_warm`).
"""
import os
import pickle
import pickletools
import time
import types

import jax  # noqa: F401  (the reference runs on the CPU backend)
import numpy as np
import pytest
import torch

from nomad_tpu_torch import faults as port_faults
from nomad_tpu_torch.metrics import metrics
from nomad_tpu_torch.solver import backend, state_cache
from nomad_tpu_torch.solver.device import use_device
from nomad_tpu_torch.testing import park_follower_workers, seeded_urandom

FAST = dict(election_timeout=(0.5, 1.0), heartbeat_interval=0.08)
DISK = dict(election_timeout=(1.2, 2.4), heartbeat_interval=0.15)


def _modules(pkg: str):
    if pkg == "ref":
        from nomad_tpu import faults, mock
        from nomad_tpu.rpc.virtual import VirtualNetwork
        from nomad_tpu.server import Server, durable
        from nomad_tpu.server.fsm import JOB_REGISTER, NODE_REGISTER
    else:
        from nomad_tpu_torch import faults, mock
        from nomad_tpu_torch.rpc.virtual import VirtualNetwork
        from nomad_tpu_torch.server import Server, durable
        from nomad_tpu_torch.server.fsm import JOB_REGISTER, NODE_REGISTER
    return types.SimpleNamespace(
        faults=faults, mock=mock, VirtualNetwork=VirtualNetwork,
        Server=Server, durable=durable, JOB_REGISTER=JOB_REGISTER,
        NODE_REGISTER=NODE_REGISTER)


@pytest.fixture(autouse=True)
def _clean():
    prev, threads = use_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    backend.reset()
    state_cache.reset()
    ref_faults = _modules("ref").faults
    port_faults.clear()
    ref_faults.clear()
    yield
    port_faults.clear()
    ref_faults.clear()
    backend.reset()
    state_cache.reset()
    torch.set_num_threads(threads)
    use_device(prev)


def wait_until(fn, timeout=20.0, step=0.01) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(step)
    return False


def _copy(obj):
    return pickle.loads(pickle.dumps(obj))


def _mk_server(m, net, name, data_dir, peers=None, seed=1, workers=1,
               timing=FAST, snapshot_threshold=8192):
    s = m.Server(num_workers=workers, gc_interval=9999)
    s.heartbeats.min_ttl = 3600.0
    s.rpc_listen_virtual(net, name)
    s.enable_raft(name, peers or {name: s.rpc_addr},
                  data_dir=str(data_dir) if data_dir else None,
                  snapshot_threshold=snapshot_threshold, seed=seed, **timing)
    s.start()
    park_follower_workers(s)
    return s


def _mk_cluster(m, net, root, snapshot_threshold=8192):
    servers = []
    for i in range(3):
        s = m.Server(num_workers=1, gc_interval=9999)
        s.heartbeats.min_ttl = 3600.0
        s.rpc_listen_virtual(net, f"s{i}")
        servers.append(s)
    peers = {f"s{i}": s.rpc_addr for i, s in enumerate(servers)}
    for i, s in enumerate(servers):
        s.enable_raft(f"s{i}", peers, data_dir=str(root / f"raft{i}"),
                      snapshot_threshold=snapshot_threshold,
                      seed=1000 + i, **DISK)
        s.start()
        park_follower_workers(s)
    return servers


def _stable_leader(servers, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        led = [s for s in servers if s.raft_node.is_leader()]
        if len(led) == 1 and led[0].is_leader:
            return led[0]
        time.sleep(0.01)
    raise AssertionError("no stable leader")


def _tables(srv) -> dict:
    """The replicated store, field for field (the applied index aside:
    a restarted leader appends its own establishment entries)."""
    s = srv.state
    view = s.usage.view()
    return {
        "allocs": sorted((a.id, a.name, a.node_id, a.job_id,
                          a.desired_status, a.client_status,
                          a.create_index, a.modify_index)
                         for a in s.iter_allocs()),
        "evals": sorted((e.id, e.status, e.job_id) for e in s.iter_evals()),
        "jobs": sorted((j.id, j.version, j.modify_index)
                       for j in s.iter_jobs()),
        "nodes": sorted((n.id, n.status, n.modify_index)
                        for n in s.iter_nodes()),
        "used": np.asarray(view.used, np.float64).sum(axis=0).tolist(),
    }


def _batch_job(m, job_id, count):
    job = m.mock.batch_job()
    job.id = job.name = job_id
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    tg.tasks[0].resources.networks = []
    return job


def _placed(srv, job_id, count) -> bool:
    return len([a for a in srv.state.allocs_by_job("default", job_id)
                if not a.terminal_status()]) == count


# ------------------------------------------------ restart from disk

def test_cluster_restarts_from_disk_with_its_store(tmp_path):
    m = _modules("port")
    servers = _mk_cluster(m, m.VirtualNetwork(seed=41), tmp_path)
    try:
        leader = _stable_leader(servers)
        for _ in range(12):
            leader.node_register(m.mock.node())
        leader.job_register(_batch_job(m, "durable-a", 16))
        assert wait_until(lambda: _placed(leader, "durable-a", 16))
        want_index = leader.raft_node.commit_index
        assert wait_until(lambda: all(
            s.raft_node.last_applied >= want_index for s in servers))
        assert wait_until(lambda: all(
            _tables(s) == _tables(leader) for s in servers))
        before = _tables(leader)
    finally:
        for s in servers:
            s.shutdown()
    assert len(before["allocs"]) == 16

    again = _mk_cluster(m, m.VirtualNetwork(seed=42), tmp_path)
    try:
        leader = _stable_leader(again)
        assert wait_until(lambda: all(
            s.raft_node.last_applied >= leader.raft_node.commit_index
            for s in again))
        for s in again:
            assert _tables(s) == before, s.raft_node.node_id
    finally:
        for s in again:
            s.shutdown()


# ------------------------------------------------------- torn appends

def _script(m):
    """tests/test_crash_recovery.py's 12 data ops (no scheduler effects)."""
    return [(m.NODE_REGISTER, {"node": m.mock.node()}) if i % 2 == 0
            else (m.JOB_REGISTER, {"job": m.mock.job()}) for i in range(12)]


def _present(m, srv, ops) -> list:
    return [srv.state.node_by_id(p["node"].id) is not None
            if t == m.NODE_REGISTER else
            srv.state.job_by_id("default", p["job"].id) is not None
            for t, p in ops]


def _torn_run(pkg, root, n, seed) -> tuple:
    """Crash-point sweep, torn append #n (power loss mid-write: the
    script stops at the first error); -> (acked, present after restart)."""
    m = _modules(pkg)
    with seeded_urandom(31):
        ops = _script(m)
    net = m.VirtualNetwork(seed=3)
    a = _mk_server(m, net, "s0", root, seed=1)
    acked = []
    try:
        assert wait_until(lambda: a.raft_node.is_leader(), timeout=8)
        node = a.raft_node
        assert wait_until(lambda: node.commit_index >= 1
                          and node.last_applied == node.commit_index)
        m.faults.install({"disk.append": {"mode": "torn", "n": n,
                                          "times": 1, "seed": seed}})
        for i, (t, p) in enumerate(ops):
            try:
                a.raft.apply(t, _copy(p), timeout=10.0)
            except Exception:   # noqa: BLE001 — the injected crash
                break
            acked.append(i)
    finally:
        a.shutdown()
        m.faults.clear()
    b = _mk_server(m, net, "s0", root, seed=1)
    try:
        assert wait_until(lambda: b.raft_node.is_leader(), timeout=8)
        return acked, _present(m, b, ops)
    finally:
        b.shutdown()


@pytest.mark.parametrize("n", [2, 5, 8])
def test_torn_append_loses_no_acked_entry_as_the_reference(tmp_path, n):
    got = _torn_run("port", tmp_path / "port", n, 13 + n)
    want = _torn_run("ref", tmp_path / "ref", n, 13 + n)
    acked, present = got
    assert len(acked) < 12, "the torn append never fired"
    assert not [i for i in acked if not present[i]]
    k = present.index(False) if False in present else len(present)
    assert not any(present[k:]), present
    assert got == want


# ---------------------------------------------------- mid-file damage

def test_midfile_corruption_quarantines_and_recovers(tmp_path):
    """tests/test_crash_recovery.py's
    test_midfile_corruption_quarantines_and_recovers_via_snapshot, on
    the port: an early frame of a follower's WAL damaged while later
    frames stay valid; the log is quarantined and the follower converges
    through the leader's InstallSnapshot."""
    m = _modules("port")
    net = m.VirtualNetwork(seed=37)
    servers = _mk_cluster(m, net, tmp_path, snapshot_threshold=500)
    try:
        leader = _stable_leader(servers)
        jobs = [m.mock.job() for _ in range(8)]
        for j in jobs:
            leader.job_register(j)
        victim = next(s for s in servers if s is not leader)
        vid = victim.raft_node.node_id
        idx = int(vid[1:])
        assert wait_until(lambda: victim.state.job_by_id(
            "default", jobs[-1].id) is not None)
        net.crash(vid)
        victim.shutdown()
        more = [m.mock.job() for _ in range(12)]
        leader.raft_node.snapshot_threshold = 1
        for j in more:
            leader.job_register(j)
        assert wait_until(lambda: leader.raft_node.base_index > 0)

        root = tmp_path / f"raft{idx}"
        man = m.durable._read_envelope(str(root / m.durable.MANIFEST))
        log_path = str(root / man["log"])
        raw = bytearray(open(log_path, "rb").read())
        assert len(raw) > 64
        raw[24] ^= 0x08
        with open(log_path, "wb") as f:
            f.write(bytes(raw))

        net.restart(vid)
        s2 = m.Server(num_workers=1, gc_interval=9999)
        s2.rpc_listen_virtual(net, vid)
        s2.enable_raft(vid, {f"s{i}": s.rpc_addr
                             for i, s in enumerate(servers)},
                       data_dir=str(root), seed=1000 + idx, **DISK)
        s2.start()
        park_follower_workers(s2)
        try:
            assert s2.raft_node.log_quarantined
            assert os.path.exists(log_path + ".quarantined")
            assert wait_until(lambda: all(
                s2.state.job_by_id("default", j.id) is not None
                for j in jobs + more), timeout=30)
            assert s2.raft_node.base_index > 0
        finally:
            s2.shutdown()
    finally:
        for s in servers:
            s.shutdown()


# ----------------------------------------------- the WAL names modules

def _pickle_modules(blob: bytes) -> set:
    """Module names a pickle imports (GLOBAL and STACK_GLOBAL opcodes;
    STACK_GLOBAL's module is the string pushed or fetched just before
    its name)."""
    mods, strings, memo = set(), [], {}
    for op, arg, _ in pickletools.genops(blob):
        if op.name == "GLOBAL":
            mods.add(arg.split(" ")[0])
        elif op.name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE",
                         "BINUNICODE8"):
            strings.append(arg)
        elif op.name == "MEMOIZE":
            memo[len(memo)] = strings[-1] if strings else None
        elif op.name in ("BINGET", "LONG_BINGET", "GET"):
            strings.append(memo.get(arg))
        elif op.name == "STACK_GLOBAL":
            mods.add(strings[-2])
        if op.name not in ("MEMOIZE", "SHORT_BINUNICODE", "BINUNICODE",
                           "UNICODE", "BINUNICODE8", "BINGET",
                           "LONG_BINGET", "GET", "STACK_GLOBAL"):
            strings.append(None)
    return mods


def _wal_blobs(durable, root) -> list:
    """The pickles of every WAL frame, snapshot and meta envelope."""
    out = []
    for name in sorted(os.listdir(root)):
        raw = open(os.path.join(root, name), "rb").read()
        if name.endswith(".wal"):
            off = 0
            while off + durable._FRAME_HDR.size <= len(raw):
                _, ln, _, _ = durable._FRAME_HDR.unpack_from(raw, off)
                start = off + durable._FRAME_HDR.size
                out.append(raw[start:start + ln])
                off = start + ln
        elif len(raw) >= durable._ENV_HDR.size:
            _, ln = durable._ENV_HDR.unpack_from(raw, 0)
            out.append(raw[durable._ENV_HDR.size:durable._ENV_HDR.size + ln])
    return out


def test_wal_pickles_name_only_the_port_and_the_standard_library(tmp_path):
    m = _modules("port")
    root = tmp_path / "raft"
    s = _mk_server(m, m.VirtualNetwork(seed=9), "s0", root, seed=1,
                   snapshot_threshold=40)
    try:
        assert wait_until(lambda: s.is_leader, timeout=8)
        for _ in range(6):
            s.node_register(m.mock.node())
        s.job_register(_batch_job(m, "wal-a", 12))
        assert wait_until(lambda: _placed(s, "wal-a", 12))
        for _ in range(40):
            s.job_register(m.mock.job())
        assert wait_until(lambda: s.raft_node.base_index > 0)
    finally:
        s.shutdown()
    assert any(n.startswith("snapshot-") for n in os.listdir(root))
    blobs = _wal_blobs(m.durable, str(root))
    assert len(blobs) >= 3
    mods = set()
    for blob in blobs:
        mods |= _pickle_modules(blob)
    assert any(x.startswith("nomad_tpu_torch.structs") for x in mods), mods
    foreign = sorted(x for x in mods if x is not None
                     and x.split(".")[0] != "nomad_tpu_torch"
                     and x.split(".")[0] not in STDLIB)
    assert not foreign, foreign
    # the scan sees a module of the other package where one is pickled
    ref_node = _modules("ref").mock.node()
    assert any(x.startswith("nomad_tpu.structs") for x in _pickle_modules(
        pickle.dumps(ref_node, protocol=pickle.HIGHEST_PROTOCOL)))


STDLIB = {"builtins", "collections", "copyreg", "datetime", "enum",
          "_codecs", "decimal", "fractions", "uuid", "re", "functools",
          "operator", "types"}


# -------------------------------------------------- the standby twin

def test_follower_standby_twin_promotes_warm_with_reseed_twins(monkeypatch):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import Server
    from nomad_tpu_torch.server.fsm import (
        APPLY_PLAN_RESULTS, PlanApplyRequest)

    monkeypatch.setenv("NOMAD_STANDBY_TWIN", "1")
    s = Server(num_workers=0, gc_interval=9999)
    s.raft_node = object()      # pose as a raft follower (not leader)
    try:
        nodes = [mock.node() for _ in range(3)]
        for node in nodes:
            s.state.upsert_node(s.state.latest_index() + 1, node)
        for k in range(4):
            alloc = mock.alloc_for(mock.batch_job(), nodes[k % 3])
            s.fsm.apply(s.state.latest_index() + 1, APPLY_PLAN_RESULTS, {
                "result": PlanApplyRequest(alloc_placements=[alloc])})
        cache = state_cache.cache()
        st = cache.stats()
        assert st["uid"] == s.state.usage.uid
        assert st["rows"] == 3
        assert st["version"] == s.state.usage.version
        warm0 = metrics.counter("nomad.solver.state_cache.promote_warm")
        out = state_cache.reseed(s.state)
        assert out["warm"] is True
        assert metrics.counter(
            "nomad.solver.state_cache.promote_warm") == warm0 + 1
        cap_w, used_w = (t.clone() for t in cache.twins())
        host_w = (cache.cap.copy(), cache.used.copy())

        cache.reset()
        out = state_cache.reseed(s.state)
        assert out["warm"] is False
        cap_f, used_f = cache.twins()
        assert torch.equal(cap_w, cap_f) and torch.equal(used_w, used_f)
        assert np.array_equal(host_w[0], cache.cap)
        assert np.array_equal(host_w[1], cache.used)
        view = s.state.usage.view()
        assert np.array_equal(cache.used, view.used)
    finally:
        s.raft_node = None
        s.shutdown()
