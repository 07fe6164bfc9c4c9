"""The port's jobspec package against the reference's, on the CPU.

`nomad_tpu_torch/jobspec/` is a byte copy of the reference's. Without it
the port's `acl.parse_policy` and `structs.diff._fmt` (reached by
`job_diff`, so by every `job_plan(diff=True)`) raised
ModuleNotFoundError. These tests hold each caller to the reference:

  * policies: `parse_policy` on every string of tests/test_acl.py and
    tests/test_connect.py that reads as a policy document; the parsed
    Policy is equal field for field, and a document the reference
    rejects the port rejects with the same message;
  * HCL job specs: `jobspec.parse` on every job spec of
    tests/test_jobspec.py (and test_connect.py's), with every variable
    set those tests pass; `api_codec.to_api` of the parsed job is equal,
    or both raise the same ParseError;
  * job plan diffs: `Server.job_plan(job, diff=True)` for a changed job
    through an in-process server of each package, from one seeded id
    stream; the diff and the annotations are equal;
  * ACL end to end: a policy upserted through the port server's
    `acl_endpoint`, read back and resolved into an ACL.
"""
import ast
import dataclasses
import time
from pathlib import Path

import jax  # noqa: F401  (the reference runs on the CPU backend)
import numpy as np
import pytest
import torch

import nomad_tpu.mock as ref_mock
from nomad_tpu import acl as ref_acl
from nomad_tpu import api_codec as ref_codec
from nomad_tpu import jobspec as ref_jobspec
from nomad_tpu import structs as ref_structs
from nomad_tpu.server import Server as RefServer
from nomad_tpu.solver import backend as ref_backend

import nomad_tpu_torch.mock as port_mock
from nomad_tpu_torch import acl as port_acl
from nomad_tpu_torch import api_codec as port_codec
from nomad_tpu_torch import jobspec as port_jobspec
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.server import Server as PortServer
from nomad_tpu_torch.solver import backend, state_cache
from nomad_tpu_torch.solver.device import use_device
from nomad_tpu_torch.structs.acl_structs import ACLPolicy
from nomad_tpu_torch.structs.diff import job_diff
from nomad_tpu_torch.testing import seeded_urandom

TESTS = Path(__file__).resolve().parent


def _strings(*names: str) -> list:
    """Every string constant of the named test modules, in file order."""
    out = []
    for name in names:
        tree = ast.parse((TESTS / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and node.value not in out:
                out.append(node.value)
    return out


def _parse_var_sets(name: str) -> list:
    """The variable dicts that `name`'s tests pass to jobspec.parse."""
    sets = [None]
    for node in ast.walk(ast.parse((TESTS / name).read_text())):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "id", "") == "parse" and \
                len(node.args) > 1 and isinstance(node.args[1], ast.Dict):
            d = ast.literal_eval(node.args[1])
            if d not in sets:
                sets.append(d)
    return sets


def _outcome(fn, *args):
    """("ok", value) or (exception class name, message)."""
    try:
        return "ok", fn(*args)
    except Exception as e:   # noqa: BLE001 — the outcome is compared
        return type(e).__name__, str(e)


# ------------------------------------------------------------- policies

POLICY_DOCS = [s for s in _strings("test_acl.py", "test_connect.py")
               if "{" in s and "}" in s and "job " not in s]


def test_policy_fixtures_were_found():
    assert len(POLICY_DOCS) >= 8, POLICY_DOCS


@pytest.mark.parametrize("src", POLICY_DOCS,
                         ids=[f"doc{i}" for i in range(len(POLICY_DOCS))])
def test_parse_policy_equals_the_references(src):
    want = _outcome(ref_acl.parse_policy, src)
    got = _outcome(port_acl.parse_policy, src)
    assert got[0] == want[0], (got, want)
    if want[0] == "ok":
        assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    else:
        assert got[1] == want[1]


def test_parse_policy_read_document():
    pol = port_acl.parse_policy('namespace "default" { policy = "read" }')
    assert pol.namespaces[0].name == "default"
    assert port_acl.NS_READ_JOB in pol.namespaces[0].capabilities
    assert port_acl.NS_SUBMIT_JOB not in pol.namespaces[0].capabilities


# --------------------------------------------------------- HCL job specs

JOB_SPECS = [s for s in _strings("test_jobspec.py", "test_connect.py")
             if "job " in s and "{" in s]
VAR_SETS = _parse_var_sets("test_jobspec.py")


def test_job_spec_fixtures_were_found():
    assert len(JOB_SPECS) >= 15, len(JOB_SPECS)
    assert len(VAR_SETS) >= 3, VAR_SETS


@pytest.mark.parametrize("src", JOB_SPECS,
                         ids=[f"spec{i}" for i in range(len(JOB_SPECS))])
def test_jobspec_parse_equals_the_references(src):
    for variables in VAR_SETS:
        args = (src,) if variables is None else (src, variables)
        want = _outcome(ref_jobspec.parse, *args)
        got = _outcome(port_jobspec.parse, *args)
        assert got[0] == want[0], (variables, got, want)
        if want[0] == "ok":
            assert port_codec.to_api(got[1]) == ref_codec.to_api(want[1]), \
                variables
        else:
            assert got[1] == want[1], variables


# ------------------------------------------------------- job plan diffs

@pytest.fixture
def _cpu():
    prev, threads = use_device("cpu"), torch.get_num_threads()
    torch.set_num_threads(1)
    backend.reset()
    ref_backend.reset()
    state_cache.reset()
    yield
    backend.reset()
    ref_backend.reset()
    state_cache.reset()
    torch.set_num_threads(threads)
    use_device(prev)


def _plan_diffs(Server, mock, structs) -> list:
    """job_plan(diff=True) of a count change with a destructive task
    change, then of a scale-down, over a registered and placed job."""
    srv = Server(num_workers=1, gc_interval=9999)
    srv.heartbeats.min_ttl = 3600.0
    srv.start()
    try:
        srv.set_scheduler_configuration(structs.SchedulerConfiguration(
            scheduler_algorithm="tpu-batch"))
        rng = np.random.default_rng(5)
        for i in range(8):
            n = mock.node()
            n.id, n.name = f"plan-node-{i:04d}", f"plan-{i}"
            n.node_resources.cpu.cpu_shares = int(rng.choice([4_000, 8_000]))
            srv.node_register(n)
        job = mock.job()
        job.id = job.name = "planned"
        job.task_groups[0].count = 2
        job.task_groups[0].tasks[0].resources.networks = []
        eval_id = srv.job_register(job)["eval_id"]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                srv.state.eval_by_id(eval_id).status != "complete":
            time.sleep(0.02)
        assert len(srv.state.allocs_by_job("default", job.id)) == 2
        upd = job.copy()
        upd.task_groups[0].count = 5
        upd.task_groups[0].tasks[0].config = {"command": "/bin/other"}
        down = job.copy()
        down.task_groups[0].count = 1
        out = []
        for cand in (upd, down):
            plan = srv.job_plan(cand, diff=True)
            out.append((plan["Diff"], plan["Annotations"],
                        plan["FailedTGAllocs"], plan["JobModifyIndex"]))
        return out
    finally:
        srv.shutdown()


def test_job_plan_diff_equals_the_references(_cpu):
    with seeded_urandom(23):
        want = _plan_diffs(RefServer, ref_mock, ref_structs)
    with seeded_urandom(23):
        got = _plan_diffs(PortServer, port_mock, port_structs)
    assert got == want
    count = next(f for f in got[0][0]["TaskGroups"][0]["Fields"]
                 if f["Name"] == "Count")
    assert (count["Old"], count["New"]) == ("2", "5")
    assert "forces create" in count.get("Annotations", [])


def test_job_diff_formats_scalars_as_the_reference():
    from nomad_tpu.structs.diff import _fmt as ref_fmt
    from nomad_tpu_torch.structs.diff import _fmt
    for v in (3, 2.5, True, "x", None, [1, 2]):
        assert _fmt(v) == ref_fmt(v), v
    a, b = port_mock.job(), port_mock.job()
    b.task_groups[0].count = a.task_groups[0].count + 3
    assert job_diff(a, b)["Type"] == "Edited"


# ----------------------------------------------------- ACL end to end

def test_acl_policy_upsert_and_read_back_through_the_port_server():
    srv = PortServer(num_workers=0, gc_interval=9999, acl_enabled=True)
    srv.start()
    try:
        rules = 'namespace "default" { policy = "read" }\n' \
                'node { policy = "write" }'
        index = srv.acl.upsert_policies(
            [ACLPolicy(name="readers", description="d", rules=rules)])
        assert index > 0
        stored = srv.state.acl_policy_by_name("readers")
        assert stored is not None and stored.rules == rules
        acl = port_acl.ACL(policies=[srv.acl._parse_cached(stored)])
        assert acl.allow_namespace_operation("default", port_acl.NS_READ_JOB)
        assert not acl.allow_namespace_operation("default",
                                                 port_acl.NS_SUBMIT_JOB)
        assert acl.allow_node_write()
        with pytest.raises(ValueError, match="invalid policy rules"):
            srv.acl.upsert_policies([ACLPolicy(
                name="bad", rules='namespace "x" { policy = "banana" }')])
    finally:
        srv.shutdown()
