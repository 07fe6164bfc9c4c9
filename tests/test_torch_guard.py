"""Guards on the port package nomad_tpu_torch:

  * it runs evals (the depth solve, the chunked scan and the convex
    solve, then a job through a two-worker in-process server, then one
    through a three-server Raft cluster with durable WALs) with neither
    jax nor any nomad_tpu module loaded;
  * no module of it, and not chip_smoke.py, imports jax or nomad_tpu;
  * each module it copies verbatim from nomad_tpu is byte-equal to its
    original (the reference is frozen, so drift is a port fault), and
    the two adapted copies differ only where they name the port's
    package (rpc/codec.py's allow-list, server/server.py:57);
  * with no card and no use_device("cpu"), the first solve raises.
"""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "nomad_tpu_torch"
REF = ROOT / "nomad_tpu"

# modules the port carries over byte for byte (paths under each package)
VERBATIM = (
    ["metrics.py", "chrono.py", "mock.py", "api_codec.py",
     "obs/__init__.py", "obs/trace.py", "state/__init__.py",
     "state/store.py", "state/usage_index.py", "rpc/__init__.py",
     "rpc/dedup.py", "rpc/server.py", "rpc/client.py", "rpc/retry.py",
     "server/__init__.py", "server/fsm.py", "server/plan_apply.py",
     "server/lifecycle.py", "server/blocked_evals.py",
     "server/eval_broker.py", "server/worker.py", "server/periodic.py",
     "server/heartbeat.py", "server/core_sched.py",
     "server/deployment_watcher.py", "server/drainer.py",
     "server/volume_watcher.py", "server/event_broker.py",
     "server/overload.py", "server/search.py", "server/acl_endpoint.py",
     "integrations/__init__.py", "integrations/connect.py",
     "integrations/services.py", "integrations/secrets.py",
     "integrations/template.py", "solver/roundtrip.py", "tlsutil.py",
     "rpc/virtual.py", "server/durable.py", "server/raft.py",
     "server/gossip.py"]
    + sorted(f"jobspec/{p.name}" for p in (REF / "jobspec").glob("*.py"))
    + sorted(f"acl/{p.name}" for p in (REF / "acl").glob("*.py"))
    + sorted(f"structs/{p.name}" for p in (REF / "structs").glob("*.py"))
    + sorted(f"scheduler/{p.name}" for p in (REF / "scheduler").glob("*.py"))
)

_EVAL = textwrap.dedent("""
    import sys
    sys.path.insert(0, {root!r})
    import nomad_tpu_torch
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.metrics import metrics
    from nomad_tpu_torch.scheduler import Harness, new_scheduler
    from nomad_tpu_torch.solver.device import use_device
    from nomad_tpu_torch.structs import Evaluation, SchedulerConfiguration
    use_device("cpu")
    h = Harness()
    h.state.set_scheduler_config(
        h.get_next_index(),
        SchedulerConfiguration(scheduler_algorithm="tpu-batch"))
    for _ in range(16):
        h.state.upsert_node(h.get_next_index(), mock.node())
    job = mock.job()
    job.task_groups[0].count = 6
    job.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.get_next_index(), job)
    ev = Evaluation(job_id=job.id, type=job.type)
    h.process(lambda s, p: new_scheduler(job.type, s, p), ev)
    assert len(h.state.allocs_by_job("default", job.id)) == 6
    assert metrics.counter("nomad.solver.kernel.depth.torch") == 1
    # a spread job: the chunked scan
    from nomad_tpu_torch.structs import Spread
    job = mock.job()
    job.task_groups[0].count = 4
    job.task_groups[0].tasks[0].resources.networks = []
    job.spreads = [Spread(attribute="${{node.datacenter}}", weight=50)]
    h.state.upsert_job(h.get_next_index(), job)
    ev = Evaluation(job_id=job.id, type=job.type)
    h.process(lambda s, p: new_scheduler(job.type, s, p), ev)
    assert len(h.state.allocs_by_job("default", job.id)) == 4
    assert metrics.counter("nomad.solver.kernel.chunked.torch") == 1
    # the "convex" algorithm: the projected-gradient solve (convex.py)
    h.state.set_scheduler_config(
        h.get_next_index(),
        SchedulerConfiguration(scheduler_algorithm="convex"))
    job = mock.batch_job()
    job.task_groups[0].count = 7
    job.task_groups[0].networks = []
    job.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.get_next_index(), job)
    ev = Evaluation(job_id=job.id, type=job.type)
    h.process(lambda s, p: new_scheduler(job.type, s, p), ev)
    assert len(h.state.allocs_by_job("default", job.id)) == 7
    assert metrics.counter("nomad.solver.dispatch.convex.torch") == 1
    assert "nomad_tpu_torch.solver.convex" in sys.modules
    # the in-process server: two workers, a job through the broker
    import time
    from nomad_tpu_torch.server import Server
    srv = Server(num_workers=2, gc_interval=9999)
    srv.heartbeats.min_ttl = 3600.0
    srv.start()
    try:
        srv.set_scheduler_configuration(
            SchedulerConfiguration(scheduler_algorithm="tpu-batch"))
        for _ in range(8):
            srv.node_register(mock.node())
        job = mock.batch_job()
        job.task_groups[0].count = 5
        job.task_groups[0].networks = []
        job.task_groups[0].tasks[0].resources.networks = []
        eval_id = srv.job_register(job)["eval_id"]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            ev = srv.state.eval_by_id(eval_id)
            if ev is not None and ev.status == "complete":
                break
            time.sleep(0.02)
        assert srv.state.eval_by_id(eval_id).status == "complete"
        assert len(srv.state.allocs_by_job("default", job.id)) == 5
    finally:
        srv.shutdown()
    # three Raft servers on the in-memory transport, one durable WAL
    # each: a job committed through the elected leader
    import tempfile
    from nomad_tpu_torch.rpc.virtual import VirtualNetwork
    from nomad_tpu_torch.testing import park_follower_workers
    net = VirtualNetwork(seed=2)
    servers = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for i in range(3):
                s = Server(num_workers=1, gc_interval=9999)
                s.heartbeats.min_ttl = 3600.0
                s.rpc_listen_virtual(net, f"s{{i}}")
                servers.append(s)
            peers = {{f"s{{i}}": s.rpc_addr for i, s in enumerate(servers)}}
            for i, s in enumerate(servers):
                s.enable_raft(f"s{{i}}", peers, data_dir=f"{{tmp}}/raft{{i}}",
                              seed=2000 + i, election_timeout=(1.0, 2.0),
                              heartbeat_interval=0.1)
                s.start()
                park_follower_workers(s)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                led = [s for s in servers if s.raft_node.is_leader()
                       and s.is_leader]
                if len(led) == 1:
                    break
                time.sleep(0.02)
            leader = led[0]
            leader.set_scheduler_configuration(
                SchedulerConfiguration(scheduler_algorithm="tpu-batch"))
            for _ in range(6):
                leader.node_register(mock.node())
            job = mock.batch_job()
            job.task_groups[0].count = 4
            job.task_groups[0].networks = []
            job.task_groups[0].tasks[0].resources.networks = []
            eval_id = leader.job_register(job)["eval_id"]
            while time.monotonic() < deadline:
                if all(len(s.state.allocs_by_job("default", job.id)) == 4
                       for s in servers):
                    break
                time.sleep(0.02)
            assert leader.state.eval_by_id(eval_id).status == "complete"
            assert all(len(s.state.allocs_by_job("default", job.id)) == 4
                       for s in servers)
        finally:
            for s in servers:
                s.shutdown()
    assert "nomad_tpu_torch.server.durable" in sys.modules
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "jaxlib",
                                                   "nomad_tpu.")))
    print("LOADED", loaded)
""")


def test_port_runs_an_eval_without_jax_or_the_reference():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", _EVAL.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "LOADED []" in out.stdout, out.stdout


def _sources():
    yield ROOT / "chip_smoke.py"
    yield from sorted(PORT.rglob("*.py"))


def _imported_modules(path: Path):
    """Absolute module names imported by `path` (relative imports are
    resolved against the file's package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    rel = path.relative_to(ROOT).with_suffix("").parts
    pkg = list(rel[:-1])
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - (node.level - 1)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            yield mod
            for alias in node.names:
                yield f"{mod}.{alias.name}"
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__"):
            yield node.args[0].value


def test_no_port_source_imports_jax_or_the_reference():
    assert (ROOT / "chip_smoke.py").exists()
    bad = []
    for path in _sources():
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "nomad_tpu"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


@pytest.mark.parametrize("rel", ["solver/convex.py", "solver/kernels.py",
                                 "solver/cuda_kernels.py"])
def test_convex_route_imports_neither_jax_nor_the_reference(rel):
    """The convex tier's modules are among the guarded sources and import
    only torch, numpy and the port."""
    path = PORT / rel
    assert path in set(_sources())
    tops = {m.split(".")[0] for m in _imported_modules(path) if m}
    assert tops <= {"__future__", "numpy", "torch", "nomad_tpu_torch",
                    "ctypes", "functools", "hashlib", "os", "shutil",
                    "subprocess", "threading", "time", "pathlib", "math",
                    "typing"}, sorted(tops)


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_is_byte_equal(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes(), rel


def test_rpc_codec_differs_only_in_its_package_allow_list():
    ref = (REF / "rpc/codec.py").read_text().splitlines()
    port = (PORT / "rpc/codec.py").read_text().splitlines()
    diff = [(a, b) for a, b in zip(ref, port) if a != b]
    assert len(ref) == len(port)
    assert diff == [('_ALLOWED_PREFIXES = ("nomad_tpu.",)',
                     '_ALLOWED_PREFIXES = ("nomad_tpu_torch.",)')]


def test_server_differs_only_in_its_backend_module_name():
    ref = (REF / "server/server.py").read_text().splitlines()
    port = (PORT / "server/server.py").read_text().splitlines()
    diff = [(i + 1, a, b) for i, (a, b) in enumerate(zip(ref, port))
            if a != b]
    assert len(ref) == len(port)
    assert diff == [(57, '    backend = sys.modules.get("nomad_tpu.solver.backend")',
                     '    backend = sys.modules.get('
                     '"nomad_tpu_torch.solver.backend")')]


def test_first_solve_raises_without_a_card_or_a_cpu_request(monkeypatch):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler import Harness, new_scheduler
    from nomad_tpu_torch.solver import backend
    from nomad_tpu_torch.solver.device import use_device
    from nomad_tpu_torch.structs import Evaluation, SchedulerConfiguration

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = use_device("cuda:0")
    backend.reset()
    try:
        h = Harness()
        h.state.set_scheduler_config(
            h.get_next_index(),
            SchedulerConfiguration(scheduler_algorithm="tpu-batch"))
        for _ in range(4):
            h.state.upsert_node(h.get_next_index(), mock.node())
        job = mock.job()
        job.task_groups[0].count = 2
        job.task_groups[0].tasks[0].resources.networks = []
        h.state.upsert_job(h.get_next_index(), job)
        ev = Evaluation(job_id=job.id, type=job.type)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            h.process(lambda s, p: new_scheduler(job.type, s, p), ev)
        assert not h.state.allocs_by_job("default", job.id)
    finally:
        use_device(prev)
        backend.reset()


# the reference's solver exports that wait for the multi-device port
MESH_EXPORTS = {"make_mesh", "sharded_fill_greedy"}


def _exports(path: Path) -> set:
    """Names a package __init__ imports for export."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


def test_port_solver_exports_the_references_names_less_the_mesh():
    want = _exports(REF / "solver" / "__init__.py") - MESH_EXPORTS
    got = _exports(PORT / "solver" / "__init__.py")
    assert want <= got, sorted(want - got)
    import nomad_tpu_torch.solver as solver
    for name in sorted(want):
        assert callable(getattr(solver, name)) or \
            isinstance(getattr(solver, name), int), name
