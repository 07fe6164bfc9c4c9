"""The port's agent and HTTP API (nomad_tpu_torch/agent/, api/) against
the reference's, on the CPU.

A dev `Agent` of each package in this process (HTTP on port 0; server
only, so that nothing but the test writes to its log; one worker; no
heartbeat deadlines), the port solving on the CPU by request
(`use_device("cpu")`). Each is fed the same nodes and jobs through its
own package's `api.Client`, every id minted from one seeded os.urandom
stream per step (`testing.seeded_urandom`), so both mint the same ids
and their schedulers shuffle alike. Compared field for field, with only
times masked (every key ending in Time, TimeNs or Unix):

  * `/v1/jobs`, `/v1/job/<id>/allocations`, `/v1/evaluation/<id>`, the
    job summaries and `/v1/allocation/<id>`'s placement metrics (the
    explain attribution) after: a batch job under tpu-batch, a job too
    large to place whole (its failed placement's attribution and its
    blocked eval), a `job plan` with its diff, and a job placed under
    `scheduler_algorithm = "convex"` set through
    `/v1/operator/scheduler/configuration`;
  * the ACL endpoints with ACLs on: bootstrap, a policy upserted and
    read, a client token made with it, the token's self view and the
    lists, with the minted secrets compared like ids;
  * `/ui`, served by a port agent in a process that never imports
    `nomad_tpu`.
"""
import contextlib
import re
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax  # noqa: F401  (the reference runs on the CPU backend)
import pytest

import nomad_tpu.mock as ref_mock
from nomad_tpu.agent import Agent as RefAgent
from nomad_tpu.agent import AgentConfig as RefAgentConfig
from nomad_tpu.api.client import Client as RefApi
from nomad_tpu.api_codec import to_api as ref_to_api

import nomad_tpu_torch.mock as port_mock
from nomad_tpu_torch.agent import Agent as PortAgent
from nomad_tpu_torch.agent import AgentConfig as PortAgentConfig
from nomad_tpu_torch.api.client import Client as PortApi
from nomad_tpu_torch.api_codec import to_api as port_to_api
from nomad_tpu_torch.solver import backend
from nomad_tpu_torch.solver.device import use_device
from nomad_tpu_torch.testing import seeded_urandom, wait_until

ROOT = Path(__file__).resolve().parents[1]
SIDES = {"ref": (RefAgent, RefAgentConfig, RefApi, ref_mock, ref_to_api),
         "port": (PortAgent, PortAgentConfig, PortApi, port_mock,
                  port_to_api)}
TIME_KEY = re.compile(r".*(Time|TimeNs|Unix)$")


def _mask(obj):
    """`obj` with every time masked."""
    if isinstance(obj, dict):
        return {k: ("<time>" if TIME_KEY.match(k) else _mask(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _body(r):
    """An api.Client read: the payload without its QueryMeta."""
    return r[0] if isinstance(r, tuple) else r


@contextlib.contextmanager
def _agent(side, acl=False):
    agent_cls, cfg_cls, api_cls, _, _ = SIDES[side]
    agent = agent_cls(cfg_cls(dev_mode=True, client_enabled=False,
                              http_port=0, num_workers=1, acl_enabled=acl))
    agent.server.heartbeats.min_ttl = 3600.0
    agent.start()
    try:
        yield agent, api_cls(agent.http_addr)
    finally:
        agent.shutdown()


@pytest.fixture(autouse=True)
def _cpu():
    prev = use_device("cpu")
    backend.reset()
    try:
        yield
    finally:
        use_device(prev)
        backend.reset()


def _job(side, job_id, count, cpu=500, mem=256):
    mock, to_api = SIDES[side][3], SIDES[side][4]
    job = mock.batch_job()
    job.id = job.name = job_id
    tg = job.task_groups[0]
    tg.count = count
    tg.networks = []
    task = tg.tasks[0]
    task.resources.cpu = cpu
    task.resources.memory_mb = mem
    task.resources.networks = []
    return to_api(job)


def _wait_eval(agent, eval_id):
    assert wait_until(lambda: (lambda e: e is not None and e.status in (
        "complete", "failed"))(agent.server.state.eval_by_id(eval_id)), 60.0)


def _run(side):
    """Drive one agent through the scenarios; -> what the API shows."""
    out = {}
    with _agent(side) as (agent, api):
        mock = SIDES[side][3]
        api.operator.scheduler_set_configuration(
            {"SchedulerAlgorithm": "tpu-batch"})
        with seeded_urandom(1):
            for i in range(8):
                node = mock.node()
                node.name = f"agent-node-{i}"
                agent.server.node_register(node)
        evals = {}
        for seed, (job_id, count, cpu) in enumerate(
                (("small", 6, 500), ("huge", 40, 3_000)), start=2):
            with seeded_urandom(seed):
                evals[job_id] = api.jobs.register(
                    _job(side, job_id, count, cpu))["eval_id"]
                _wait_eval(agent, evals[job_id])
        with seeded_urandom(4):
            out["plan"] = api.jobs.plan("small", _job(side, "small", 9),
                                        diff=True)
        api.operator.scheduler_set_configuration(
            {"SchedulerAlgorithm": "convex"})
        with seeded_urandom(5):
            evals["convex"] = api.jobs.register(
                _job(side, "convex", 5, 300))["eval_id"]
            _wait_eval(agent, evals["convex"])
        out["config"] = _body(api.operator.scheduler_get_configuration())
        out["jobs"] = _body(api.jobs.list())
        for job_id, eval_id in evals.items():
            allocs = _body(api.jobs.allocations(job_id))
            out[job_id] = {
                "allocs": sorted(allocs, key=lambda a: a["Name"]),
                "eval": _body(api.evaluations.info(eval_id)),
                "summary": _body(api.jobs.summary(job_id)),
                "metrics": [_body(api.allocations.info(a["ID"]))["Metrics"]
                            for a in sorted(allocs,
                                            key=lambda a: a["Name"])[:2]]}
    return _mask(out)


@pytest.fixture(scope="module")
def runs():
    prev = use_device("cpu")
    try:
        return {side: _run(side) for side in ("ref", "port")}
    finally:
        use_device(prev)
        backend.reset()


@pytest.mark.parametrize("job_id", ["small", "huge", "convex"])
@pytest.mark.parametrize("what", ["allocs", "eval", "summary", "metrics"])
def test_job_views_match_reference(runs, job_id, what):
    assert runs["port"][job_id][what] == runs["ref"][job_id][what]


def test_job_list_plan_and_config_match_reference(runs):
    for what in ("jobs", "plan", "config"):
        assert runs["port"][what] == runs["ref"][what], what


def test_scenarios_did_what_they_claim(runs):
    port = runs["port"]
    assert len(port["small"]["allocs"]) == 6
    huge = port["huge"]
    assert 0 < len(huge["allocs"]) < 40
    failed = huge["eval"]["FailedTGAllocs"]
    assert failed and all(m["NodesExhausted"] > 0 for m in failed.values())
    assert huge["eval"]["BlockedEval"]
    assert len(port["convex"]["allocs"]) == 5
    assert port["config"]["SchedulerConfig"]["SchedulerAlgorithm"] == \
        "convex"
    assert port["plan"]["Diff"]["Type"] == "Edited"
    assert all(m["ScoreMeta"] for m in port["small"]["metrics"])


def _acl_run(side):
    """The ACL endpoints with ACLs on; ids and secrets from one seeded
    stream."""
    out = {}
    with _agent(side, acl=True) as (agent, api):
        with seeded_urandom(11):
            boot = api.acl.bootstrap()
        api.token = boot["SecretID"]
        rules = 'namespace "default" { policy = "read" }'
        with seeded_urandom(12):
            api.acl.policy_upsert("readonly", rules, "read default")
            tok = api.acl.token_create("ro", "client", ["readonly"])
        out["bootstrap"] = boot
        out["policy"] = _body(api.acl.policy_info("readonly"))
        out["policies"] = _body(api.acl.policies())
        out["token"] = tok
        out["tokens"] = sorted(_body(api.acl.tokens()),
                               key=lambda t: t["Name"])
        api.token = tok["SecretID"]
        out["self"] = _body(api.acl.token_self())
        api.token = ""
        try:
            api.jobs.list()
            out["anonymous"] = "allowed"
        except Exception as e:      # noqa: BLE001 — the refusal is compared
            out["anonymous"] = getattr(e, "status", type(e).__name__)
    return _mask(out)


def test_acl_endpoints_match_reference():
    ref = _acl_run("ref")
    port = _acl_run("port")
    assert port == ref
    assert port["anonymous"] == 403
    assert port["self"]["Policies"] == ["readonly"]


_UI = textwrap.dedent("""
    import sys, urllib.request
    sys.path.insert(0, {root!r})
    from nomad_tpu_torch.agent import Agent, AgentConfig
    a = Agent(AgentConfig(dev_mode=True, client_enabled=False, http_port=0))
    a.start()
    try:
        with urllib.request.urlopen(a.http_addr + "/ui", timeout=30) as r:
            print("STATUS", r.status, b"<html" in r.read(4096).lower())
    finally:
        a.shutdown()
    print("LOADED", sorted(m for m in sys.modules
                           if m == "nomad_tpu" or m.startswith("nomad_tpu.")))
""")


def test_ui_is_served_from_the_port_package():
    out = subprocess.run([sys.executable, "-c", _UI.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "STATUS 200 True" in out.stdout, out.stdout
    assert "LOADED []" in out.stdout, out.stdout


def test_ui_resource_is_the_port_copy():
    import importlib.resources as res
    assert (res.files("nomad_tpu_torch.ui") / "index.html").read_bytes() == \
        (ROOT / "nomad_tpu" / "ui" / "index.html").read_bytes()
    assert str(res.files("nomad_tpu_torch.ui")).startswith(
        str(ROOT / "nomad_tpu_torch"))


def test_agent_shutdown_is_bounded():
    t0 = time.monotonic()
    with _agent("port") as (agent, api):
        assert _body(api.agent.health()) is not None
    assert time.monotonic() - t0 < 30.0
