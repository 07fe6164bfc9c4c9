"""The port's agents as a cluster of real OS processes, on the CPU: three
server agents (TCP RPC, gossip `retry_join`, bootstrap_expect 3, Raft on
the agent's defaults with its WAL under each data dir) and one client
agent, each `python -m nomad_tpu_torch.cli agent -config <file>` with
NOMAD_SOLVER_DEVICE=cpu, in one module-scoped cluster whose tests run in
file order (later tests inherit the earlier ones' cluster, as
tests/e2e/test_cluster.py's do):

  * a count-2 raw_exec job runs as two real processes under the client
    agent's data dir;
  * kill -9 of the leader's process: a new leader is elected from the two
    survivors, the job stays running (the same task processes), and a new
    job places and runs;
  * the killed server restarts over its data dir (its WAL) and rejoins:
    it serves the new leader's allocations from its own replicated store.

Every wait is bounded (WAIT_S) and every process is stopped, and every
task process reaped, in the fixture's `finally`.
"""
import os
import tempfile

import pytest

from nomad_tpu_torch.testing import (
    child_env, client_agent, free_ports, reap_tasks, server_agent,
    task_pids, wait_until)

pytestmark = pytest.mark.e2e

KEY = "test-agent-cluster-key"
WAIT_S = 45.0


def _sleep_job(job_id, count, seconds):
    return {"ID": job_id, "Name": job_id, "Type": "service",
            "Datacenters": ["dc1"],
            "TaskGroups": [{"Name": "g", "Count": count, "Tasks": [{
                "Name": "t", "Driver": "raw_exec",
                "Config": {"command": "/bin/sleep", "args": [str(seconds)]},
                "Resources": {"CPU": 50, "MemoryMB": 32}}]}]}


class _Cluster:
    def __init__(self, base):
        self.base = base
        env = child_env(NOMAD_SOLVER_DEVICE="cpu")
        p = free_ports(10)
        ports = [{"http": p[i], "rpc": p[3 + i], "serf": p[6 + i]}
                 for i in range(3)]
        rpcs = [f"127.0.0.1:{q['rpc']}" for q in ports]
        self.servers = [server_agent(
            f"server{i}", base, ports[i], 3,
            [f"127.0.0.1:{ports[j]['serf']}" for j in range(3) if j != i],
            KEY, env) for i in range(3)]
        self.client = client_agent("client0", base, p[9], rpcs, KEY, "dc1",
                                   env)

    def leader(self):
        led = [s for s in self.servers if s.alive() and s.is_leader()]
        return led[0] if len(led) == 1 else None

    def write(self, path, body):
        """PUT through the leader, retried across elections."""
        def put():
            s = self.leader()
            return s.put(path, body) if s is not None else None
        out = wait_until(put, WAIT_S, 0.2)
        assert out is not None, self.diagnose()
        return out

    def running(self, job_id):
        s = self.leader()
        return [a for a in s.get(f"/v1/job/{job_id}/allocations")
                if a["ClientStatus"] == "running"] if s else []

    def diagnose(self):
        return "\n".join(f"--- {a.name} ---\n{a.tail(1500)}"
                         for a in self.servers + [self.client])


@pytest.fixture(scope="module")
def cluster():
    base = tempfile.mkdtemp(prefix="port-agent-cluster-")
    c = _Cluster(base)
    try:
        for s in c.servers:
            s.start()
        for s in c.servers:
            assert s.wait_http(WAIT_S), c.diagnose()
        assert wait_until(c.leader, WAIT_S, 0.1), c.diagnose()
        c.write("/v1/operator/scheduler/configuration",
                {"SchedulerAlgorithm": "tpu-batch"})
        c.client.start()
        assert c.client.wait_http(WAIT_S), c.diagnose()
        assert wait_until(lambda: c.leader() and any(
            n["Status"] == "ready" for n in c.leader().get("/v1/nodes")),
            WAIT_S, 0.1), c.diagnose()
        yield c
    finally:
        for a in c.servers + [c.client]:
            a.stop()
        reap_tasks(base)


def test_job_runs_as_real_processes(cluster):
    cluster.write("/v1/jobs", {"Job": _sleep_job("cl-base", 2, 400)})
    assert wait_until(lambda: len(cluster.running("cl-base")) == 2,
                      WAIT_S, 0.1), cluster.diagnose()
    assert wait_until(lambda: len(task_pids(cluster.client.dir,
                                            "sleep 400")) == 2, WAIT_S, 0.1)
    counters = cluster.leader().get("/v1/metrics")["telemetry"]["counters"]
    # solves on the CPU's plain tier, classic or fused
    assert counters.get("nomad.solver.dispatch.torch", 0) + counters.get(
        "nomad.solver.dispatch.fused.torch", 0) >= 1
    assert not counters.get("nomad.solver.dispatch_errors")


def test_leader_kill9_elects_a_new_leader_and_keeps_the_job(cluster):
    old = cluster.leader()
    pids = task_pids(cluster.client.dir, "sleep 400")
    old.kill9()
    new = wait_until(lambda: (lambda s: s if s is not None and s is not old
                              else None)(cluster.leader()), WAIT_S, 0.05)
    assert new is not None, cluster.diagnose()
    assert len(cluster.running("cl-base")) == 2
    assert task_pids(cluster.client.dir, "sleep 400") == pids
    cluster.write("/v1/jobs", {"Job": _sleep_job("cl-after", 1, 401)})
    assert wait_until(lambda: len(cluster.running("cl-after")) == 1,
                      WAIT_S, 0.1), cluster.diagnose()


def test_killed_server_restarts_from_its_data_dir_and_rejoins(cluster):
    dead = [s for s in cluster.servers if not s.alive()]
    assert len(dead) == 1
    old = dead[0]
    assert os.path.isdir(os.path.join(old.dir, "raft"))
    old.start()
    assert old.wait_http(WAIT_S), cluster.diagnose()
    lead = cluster.leader()
    want = sorted(a["ID"] for a in lead.get("/v1/job/cl-after/allocations"))
    assert wait_until(lambda: sorted(
        a["ID"] for a in old.get("/v1/job/cl-after/allocations")) == want,
        WAIT_S, 0.1), cluster.diagnose()
    peers = lead.get("/v1/operator/raft/configuration")["Servers"]
    assert len(peers) == 3
