"""The port's CLI (nomad_tpu_torch/cli.py, a byte copy of the
reference's) against the reference's, each as a subprocess against its
own `-dev` agent subprocess on the CPU: the reference's agent under
JAX_PLATFORMS=cpu, the port's started with NOMAD_SOLVER_DEVICE=cpu (the
spawned process's request for the CPU).

Both agents get the same commands in the same order: `operator
scheduler set-config` (tpu-batch) and `get-config`, `job run` of an HCL
spec (two raw_exec sleeps) and of a JSON spec (one), `job status`,
`node status`, `alloc status`, `eval status` and `job stop -purge`. Each
command must exit 0 on both sides and print the same text once ids
(UUIDs, their 8-character prefixes) and the host's node name are
masked; nothing else is masked.

Also: `agent -config` file parsing (HCL and JSON, merged in order) is
held to the reference's `config_file.load_config` and
`apply_to_agent_config` on the same files, field for field.
"""
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from nomad_tpu.agent import AgentConfig as RefAgentConfig
from nomad_tpu.agent import config_file as ref_config_file

from nomad_tpu_torch.agent import AgentConfig as PortAgentConfig
from nomad_tpu_torch.agent import config_file as port_config_file
from nomad_tpu_torch.testing import free_ports, reap_tasks, wait_until

ROOT = Path(__file__).resolve().parents[1]
PKG = {"ref": "nomad_tpu", "port": "nomad_tpu_torch"}
ENV = {"ref": {"JAX_PLATFORMS": "cpu"},
       "port": {"NOMAD_SOLVER_DEVICE": "cpu"}}
ID = re.compile(r"[0-9a-f]{8}(-[0-9a-f]{4}){3}-[0-9a-f]{12}|\b[0-9a-f]{8}\b")

HCL_JOB = """job "cli-hcl" {
  datacenters = ["dc1"]
  type = "service"
  group "g" {
    count = 2
    task "t" {
      driver = "raw_exec"
      config {
        command = "/bin/sleep"
        args    = ["300"]
      }
      resources {
        cpu    = 50
        memory = 32
      }
    }
  }
}
"""
JSON_JOB = {"Job": {
    "ID": "cli-json", "Name": "cli-json", "Type": "service",
    "Datacenters": ["dc1"],
    "TaskGroups": [{"Name": "g", "Count": 1, "Tasks": [{
        "Name": "t", "Driver": "raw_exec",
        "Config": {"command": "/bin/sleep", "args": ["301"]},
        "Resources": {"CPU": 50, "MemoryMB": 32}}]}]}}


def _env(side, port):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               NOMAD_ADDR=f"http://127.0.0.1:{port}", **ENV[side])
    env.pop("NOMAD_TOKEN", None)
    if side == "ref":
        env.pop("NOMAD_SOLVER_DEVICE", None)
    return env


class _Side:
    def __init__(self, side, base):
        self.side = side
        self.port = free_ports(1)[0]
        self.dir = base / side
        self.dir.mkdir()
        self.env = _env(side, self.port)
        self.log = open(self.dir / "agent.log", "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"{PKG[side]}.cli", "agent", "-dev",
             "-port", str(self.port), "-data-dir", str(self.dir / "data")],
            cwd=str(self.dir), env=self.env, stdout=self.log,
            stderr=subprocess.STDOUT, start_new_session=True)
        self.node = ""

    def cli(self, *args):
        r = subprocess.run([sys.executable, "-m", f"{PKG[self.side]}.cli",
                            *args], cwd=str(self.dir), env=self.env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, (self.side, args, r.stderr[-2000:])
        return r.stdout

    def get(self, path):
        import urllib.request
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}{path}", timeout=30) as r:
            return json.loads(r.read())

    def masked(self, text):
        text = ID.sub("<id>", text)
        return text.replace(self.node, "<node>") if self.node else text

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        self.log.close()
        reap_tasks(str(self.dir))


@pytest.fixture(scope="module")
def agents(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    sides = {}
    try:
        for side in ("ref", "port"):
            sides[side] = _Side(side, base)
        for s in sides.values():
            assert wait_until(lambda: (lambda n: n and n[0]["Status"] ==
                                       "ready")(s.get("/v1/nodes")),
                              90.0, 0.2), (s.dir / "agent.log").read_text()
            s.node = s.get("/v1/nodes")[0]["Name"]
        (base / "job.nomad").write_text(HCL_JOB)
        (base / "job.json").write_text(json.dumps(JSON_JOB))
        yield sides, base
    finally:
        for s in sides.values():
            s.stop()


def _both(agents, *args):
    sides, _ = agents
    return {k: s.masked(s.cli(*args)) for k, s in sides.items()}


def _running(s, job_id, count):
    return wait_until(lambda: sum(a["ClientStatus"] == "running" for a in
                                  s.get(f"/v1/job/{job_id}/allocations"))
                      == count, 60.0, 0.1)


def test_cli_commands_match_reference(agents):
    sides, base = agents
    steps = [("operator", "scheduler", "set-config",
              "-scheduler-algorithm", "tpu-batch"),
             ("operator", "scheduler", "get-config"),
             ("job", "run", str(base / "job.nomad")),
             ("job", "run", str(base / "job.json"))]
    outs = [_both(agents, *step) for step in steps]
    for s in sides.values():
        assert _running(s, "cli-hcl", 2) and _running(s, "cli-json", 1)
    for step in [("job", "status"), ("job", "status", "cli-hcl"),
                 ("node", "status")]:
        outs.append(_both(agents, *step))
    per = {}
    for k, s in sides.items():
        alloc = sorted(s.get("/v1/job/cli-hcl/allocations"),
                       key=lambda a: a["Name"])[0]["ID"]
        ev = s.get("/v1/job/cli-json/evaluations")[0]["ID"]
        per[k] = (s.masked(s.cli("alloc", "status", alloc)),
                  s.masked(s.cli("eval", "status", ev)))
    outs.append({k: v[0] for k, v in per.items()})
    outs.append({k: v[1] for k, v in per.items()})
    for job in ("cli-hcl", "cli-json"):
        outs.append(_both(agents, "job", "stop", "-purge", job))
    for s in sides.values():
        assert wait_until(lambda: not s.get("/v1/jobs"), 60.0, 0.1)
    outs.append(_both(agents, "job", "status"))
    for out in outs:
        assert out["port"] == out["ref"]
    text = "\n".join(o["port"] for o in outs)
    assert '"SchedulerAlgorithm": "tpu-batch"' in text
    assert "Evaluation status: complete" in text
    assert "No running jobs" in outs[-1]["port"]


def test_port_agent_solved_on_the_cpu_by_request(agents):
    sides, _ = agents
    counters = sides["port"].get("/v1/metrics")["telemetry"]["counters"]
    # solves on the CPU's plain tier, classic or fused, and none on a card
    assert counters.get("nomad.solver.dispatch.torch", 0) + counters.get(
        "nomad.solver.dispatch.fused.torch", 0) >= 2
    assert not counters.get("nomad.solver.dispatch.cuda")
    assert not counters.get("nomad.solver.dispatch.fused.cuda")
    assert not counters.get("nomad.solver.dispatch_errors")


CONFIG_FILES = {
    "base.hcl": textwrap.dedent("""\
        region     = "east"
        datacenter = "dc9"
        name       = "cli-node"
        ports { http = 5646  rpc = 5647  serf = 5648 }
        server {
          enabled          = true
          bootstrap_expect = 3
          num_schedulers   = 4
          encrypt          = "k3y"
          retry_join       = ["10.0.0.2:5648", "10.0.0.3:5648"]
        }
        client {
          enabled    = true
          servers    = ["10.0.0.1:5647"]
          node_class = "compute"
        }
        acl { enabled = true }
        telemetry { collection_interval = "1m30s" }
        """),
    "over.json": json.dumps({"datacenter": "dc10",
                             "server": {"bootstrap_expect": 1},
                             "telemetry": {"prometheus_metrics": False}}),
}


@pytest.mark.parametrize("files", [["base.hcl"], ["over.json"],
                                   ["base.hcl", "over.json"], ["."]])
def test_agent_config_files_parse_like_reference(tmp_path, files):
    for name, text in CONFIG_FILES.items():
        (tmp_path / name).write_text(text)
    paths = [str(tmp_path / f) if f != "." else str(tmp_path)
             for f in files]
    ref = ref_config_file.load_config(paths)
    port = port_config_file.load_config(paths)
    assert port == ref
    ref_cfg = ref_config_file.apply_to_agent_config(RefAgentConfig(), ref)
    port_cfg = port_config_file.apply_to_agent_config(PortAgentConfig(),
                                                      port)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)


def test_bad_config_value_raises_like_reference(tmp_path):
    (tmp_path / "bad.json").write_text(json.dumps({"ports": {"http": "x"}}))
    errs = []
    for mod, cfg in ((ref_config_file, RefAgentConfig()),
                     (port_config_file, PortAgentConfig())):
        with pytest.raises(mod.ConfigError) as e:
            mod.apply_to_agent_config(
                cfg, mod.load_config([str(tmp_path / "bad.json")]))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_cli_usage_is_the_references(tmp_path):
    outs = []
    for side in ("ref", "port"):
        r = subprocess.run([sys.executable, "-m", f"{PKG[side]}.cli",
                            "--help"], env=_env(side, 1), cwd=str(tmp_path),
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == 0
        outs.append(r.stdout)
    assert outs[0] == outs[1]

