"""The port's client (nomad_tpu_torch/client/, byte copies of the
reference's) against the reference's, on the same inputs, on the CPU.

  * `fingerprint_node`: the attributes and resources of this host, with
    the cloud metadata probes answered "absent" by a stub and no consul
    or vault listening; masked: the free-disk figures, which move between
    the two calls;
  * `taskenv.build_task_env` and `interpolate` on one alloc, task and
    node (ids minted from one seeded stream): equal dicts and strings;
  * a raw_exec task through `TaskRunner` (exit code, event types, final
    state) and, through an in-process server and client of each package,
    through `AllocRunner`: the alloc's client status, its task's exit
    code and event types;
  * `StateDB` across a client restart: the restarted client of each
    package keeps its node id and reattaches to its live task, which then
    completes;
  * the plugin host: an external driver whose shim imports
    `nomad_tpu_torch.client` (and, for the reference, `nomad_tpu.client`)
    runs a task to the same exit code and log.

Nothing is compared by tolerance: every compared value is equal. The
port's server solves nothing here (the default binpack algorithm); it
still runs on the CPU by request (`use_device("cpu")`).
"""
import os
import stat
import sys
import textwrap

import jax  # noqa: F401  (the reference runs on the CPU backend)
import pytest

import nomad_tpu.mock as ref_mock
from nomad_tpu.api_codec import to_api as ref_to_api
from nomad_tpu.client import Client as RefClient
from nomad_tpu.client import driver as ref_driver
from nomad_tpu.client import fingerprint as ref_fp
from nomad_tpu.client import taskenv as ref_taskenv
from nomad_tpu.client.plugin_host import discover_plugins as ref_discover
from nomad_tpu.client.task_runner import TaskRunner as RefTaskRunner
from nomad_tpu.server import Server as RefServer

import nomad_tpu_torch.mock as port_mock
from nomad_tpu_torch.api_codec import to_api as port_to_api
from nomad_tpu_torch.client import Client as PortClient
from nomad_tpu_torch.client import driver as port_driver
from nomad_tpu_torch.client import fingerprint as port_fp
from nomad_tpu_torch.client import taskenv as port_taskenv
from nomad_tpu_torch.client.plugin_host import \
    discover_plugins as port_discover
from nomad_tpu_torch.client.task_runner import TaskRunner as PortTaskRunner
from nomad_tpu_torch.server import Server as PortServer
from nomad_tpu_torch.solver.device import use_device
from nomad_tpu_torch.testing import seeded_urandom, wait_until

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {side: dict(zip(("mock", "to_api", "Client", "Server", "driver",
                          "fp", "taskenv", "TaskRunner", "discover"), mods))
         for side, mods in (
             ("ref", (ref_mock, ref_to_api, RefClient, RefServer,
                      ref_driver, ref_fp, ref_taskenv, RefTaskRunner,
                      ref_discover)),
             ("port", (port_mock, port_to_api, PortClient, PortServer,
                       port_driver, port_fp, port_taskenv, PortTaskRunner,
                       port_discover)))}


@pytest.fixture(autouse=True)
def _cpu():
    prev = use_device("cpu")
    try:
        yield
    finally:
        use_device(prev)


def _absent(url, headers, timeout):
    raise OSError("no metadata service")


def test_fingerprint_node_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("CONSUL_HTTP_ADDR", "http://127.0.0.1:1")
    monkeypatch.delenv("VAULT_ADDR", raising=False)
    cfg = {"metadata_get": _absent}
    out = {}
    for side in ("ref", "port"):
        m = SIDES[side]
        node = m["fp"].fingerprint_node(
            str(tmp_path), "dc7", "gpu", "fp-node",
            "0000aaaa-0000-0000-0000-000000000001", cfg=dict(cfg))
        api = m["to_api"](node)
        api["Attributes"].pop("unique.storage.bytesfree", None)
        api["NodeResources"]["Disk"].pop("DiskMB", None)
        out[side] = api
    assert out["port"]["Attributes"] == out["ref"]["Attributes"]
    assert out["port"]["NodeResources"] == out["ref"]["NodeResources"]
    assert out["port"] == out["ref"]
    assert out["port"]["Attributes"]["cpu.numcores"]


def _env_case(side, tmp_path):
    """One alloc of a job with a port, meta and env, on a node; ids from
    one seeded stream."""
    mock = SIDES[side]["mock"]
    with seeded_urandom(31):
        node = mock.node()
        job = mock.job()
        node.name = "env-node"
        node.meta = {"rack": "r7"}
        alloc = mock.alloc_for(job, node, 2)
    task = alloc.job.task_groups[0].tasks[0]
    task.env = {"GREETING": "hi-${NOMAD_ALLOC_INDEX}"}
    dirs = [str(tmp_path / d) for d in ("task", "alloc", "secrets")]
    return alloc, task, node, dirs


@pytest.mark.parametrize("value", [
    "${NOMAD_ALLOC_ID}", "${NOMAD_TASK_DIR}/local/x.conf",
    "${node.unique.id}-${node.datacenter}", "${attr.kernel.name}",
    "${meta.rack}", "${node.unique.name}:${NOMAD_ALLOC_INDEX}",
    "${NOMAD_JOB_NAME}.${NOMAD_GROUP_NAME}", "plain", "${unknown.key}"])
def test_taskenv_matches_reference(tmp_path, value):
    out = {}
    for side in ("ref", "port"):
        taskenv = SIDES[side]["taskenv"]
        alloc, task, node, dirs = _env_case(side, tmp_path)
        env = taskenv.build_task_env(alloc, task, node, *dirs)
        out[side] = (env, taskenv.interpolate(value, env, node))
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1]


def _raw_task(mock, script):
    job = mock.batch_job()
    task = job.task_groups[0].tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": "/bin/sh", "args": ["-c", script]}
    return job, task


def _task_run(side, tmp_path, script):
    m = SIDES[side]
    mock, driver_mod, runner_cls = m["mock"], m["driver"], m["TaskRunner"]
    with seeded_urandom(5):
        job, task = _raw_task(mock, script)
        job.task_groups[0].restart_policy.attempts = 0
        job.task_groups[0].restart_policy.mode = "fail"
        node = mock.node()
        alloc = mock.alloc_for(job, node, 0)
    task_dir = tmp_path / side
    task_dir.mkdir()
    states = []
    runner = runner_cls(alloc, task, driver_mod.RawExecDriver(),
                        str(task_dir), {"FOO": "bar"},
                        lambda name, st: states.append(st.state))
    runner.start()
    assert wait_until(lambda: runner.state.state == "dead", 30.0)
    runner._thread.join(10.0)
    st = runner.state
    return {"state": st.state, "failed": st.failed,
            "exit": [e.message for e in st.events
                     if e.type == "Terminated"],
            "events": [e.type for e in st.events],
            "log": (task_dir / f"{task.name}.stdout.log").read_text()}


def test_task_runner_matches_reference(tmp_path):
    script = "echo out-$FOO; exit 3"
    ref = _task_run("ref", tmp_path, script)
    port = _task_run("port", tmp_path, script)
    assert port == ref
    assert port["exit"] == ["exit code: 3"] and port["log"] == "out-bar\n"


def _cluster(side, tmp_path):
    server_cls, client_cls = SIDES[side]["Server"], SIDES[side]["Client"]
    server = server_cls(num_workers=1, gc_interval=9999)
    server.start()
    client = client_cls(server, data_dir=str(tmp_path / f"{side}-client"))
    return server, client


def _alloc_run(side, tmp_path, script, count=1):
    mock = SIDES[side]["mock"]
    server, client = _cluster(side, tmp_path)
    try:
        client.start()
        assert wait_until(lambda: (lambda n: n is not None and n.ready())(
            server.state.node_by_id(client.node.id)), 30.0)
        with seeded_urandom(9):
            job, task = _raw_task(mock, script)
            job.task_groups[0].count = count
            job.task_groups[0].restart_policy.attempts = 0
            job.task_groups[0].restart_policy.mode = "fail"
            job.task_groups[0].reschedule_policy = None
            task.resources.networks = []
            task.resources.cpu = 100
            task.resources.memory_mb = 32
            server.job_register(job)

        def done():
            allocs = server.state.allocs_by_job("default", job.id)
            return len(allocs) == count and all(
                a.client_status in ("complete", "failed") for a in allocs)
        assert wait_until(done, 60.0)
        out = []
        for a in sorted(server.state.allocs_by_job("default", job.id),
                        key=lambda a: a.name):
            ts = a.task_states[task.name]
            out.append({"name": a.name, "client_status": a.client_status,
                        "state": ts.state, "failed": ts.failed,
                        "exit": [e.message for e in ts.events
                                 if e.type == "Terminated"],
                        "events": [e.type for e in ts.events]})
        return out
    finally:
        client.shutdown()
        server.shutdown()


@pytest.mark.parametrize("script,status", [("exit 0", "complete"),
                                           ("exit 7", "failed")])
def test_alloc_runner_matches_reference(tmp_path, script, status):
    ref = _alloc_run("ref", tmp_path, script, count=2)
    port = _alloc_run("port", tmp_path, script, count=2)
    assert port == ref
    assert [a["client_status"] for a in port] == [status, status]


def _restart(side, tmp_path):
    """A client over its data dir restarted while its raw_exec task
    runs: the new client (StateDB restore) keeps the node id and
    reattaches, and the task completes."""
    mock = SIDES[side]["mock"]
    server, client = _cluster(side, tmp_path)
    client2 = None
    marker = tmp_path / f"{side}-done.txt"
    try:
        client.start()
        assert wait_until(lambda: server.state.node_by_id(client.node.id)
                          is not None, 30.0)
        job, task = _raw_task(mock, f"sleep 2 && echo ok > {marker}")
        job.task_groups[0].count = 1
        task.resources.networks = []
        task.resources.cpu = 100
        task.resources.memory_mb = 32
        server.job_register(job)
        assert wait_until(lambda: any(
            a.client_status == "running"
            for a in server.state.allocs_by_job("default", job.id)), 30.0)
        client._shutdown.set()
        old = client.node.id
        client2 = SIDES[side]["Client"](server, data_dir=str(
            tmp_path / f"{side}-client"))
        same_node = client2.node.id == old
        restored = sorted(a.job_id for a in
                          client2.state_db.get_all_allocations())
        client2.start()
        assert wait_until(marker.exists, 30.0)
        assert wait_until(lambda: any(
            a.client_status == "complete"
            for a in server.state.allocs_by_job("default", job.id)), 30.0)
        return {"same_node": same_node, "restored": len(restored),
                "marker": marker.read_text()}
    finally:
        for c in (client2, client):
            if c is not None:
                c.shutdown()
        server.shutdown()


def test_state_db_restore_after_client_restart_matches_reference(tmp_path):
    ref = _restart("ref", tmp_path)
    port = _restart("port", tmp_path)
    assert port == ref
    assert port == {"same_node": True, "restored": 1, "marker": "ok\n"}


PLUGIN_SRC = """\
    #!{python}
    import sys
    sys.path.insert(0, {repo!r})
    from {pkg}.client.driver import RawExecDriver
    from {pkg}.client.plugin_runtime import serve_driver

    class PluginRawExec(RawExecDriver):
        name = "plugin_raw"

    if __name__ == "__main__":
        serve_driver(PluginRawExec())
"""


def _plugin_run(side, tmp_path):
    pkg = "nomad_tpu" if side == "ref" else "nomad_tpu_torch"
    d = tmp_path / f"{side}-plugins"
    d.mkdir()
    p = d / "plugin_raw"
    p.write_text(textwrap.dedent(PLUGIN_SRC).format(
        python=sys.executable, repo=REPO, pkg=pkg))
    p.chmod(p.stat().st_mode | stat.S_IXUSR)
    drivers = SIDES[side]["discover"](str(d))
    drv = drivers["plugin_raw"]
    try:
        job, task = _raw_task(SIDES[side]["mock"], "echo out-here; exit 4")
        task.driver = "plugin_raw"
        task_dir = tmp_path / f"{side}-t1"
        task_dir.mkdir()
        h = drv.start_task("t1", task, str(task_dir), {"FOO": "bar"})
        res = drv.wait_task("t1", timeout=30)
        log = task_dir / f"{task.name}.stdout.log"
        assert wait_until(lambda: log.exists() and b"out-here" in
                          log.read_bytes(), 10.0)
        drv.destroy_task("t1")
        return {"info": (drv.info["type"], drv.info["name"],
                         drv.protocol_version),
                "pid": h.pid > 0, "exit": res.exit_code,
                "log": log.read_text()}
    finally:
        drv.shutdown()


def test_plugin_host_runs_a_port_shim_like_the_reference(tmp_path):
    ref = _plugin_run("ref", tmp_path)
    port = _plugin_run("port", tmp_path)
    assert port == ref
    assert port["exit"] == 4 and port["info"] == ("driver", "plugin_raw", 1)
