"""The port's static analyzer (nomad_tpu_torch.analysis) on the CPU:

  * the copied rules report what the reference's analyzer reports on
    every fixture tests/test_lint.py writes for them (its module-level
    sources, and the sources inline in its tests of those rules), at the
    same paths: the same (rule, line, col) lists and the same messages
    once the package names are swapped;
  * the torch rules SYNC001, JIT001, JIT002, CVX001 and SHARD001 fire on
    their bad fixtures, stay quiet on the good ones and honour inline
    markers, and SYNC001 fires once a seam marker is taken out of a copy
    of the port's placer; MESH001 (copied) fires on the port's own
    sharded wrappers' names too;
  * the gate: `python -m nomad_tpu_torch.analysis nomad_tpu_torch`
    exits 0 within 30 s; --list-rules names every reference rule id;
  * REG002 reads the port's rule table: a copy of RULES.md with a row
    taken out makes it fire; every baseline entry carries a reason.
"""
import ast
import io
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time

import pytest

import test_lint as ref_lint
from nomad_tpu.analysis import analyze_source as ref_analyze
from nomad_tpu_torch.analysis import Baseline, all_rules, analyze_source
from nomad_tpu_torch.analysis.__main__ import main as lint_main

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO_ROOT, "nomad_tpu_torch")

# the rules the port copies from the reference (the framework-neutral
# ones); SYNC001, JIT001, JIT002, CVX001 and SHARD001 are the port's own
COPIED = ("LOCK001", "LOCK002", "LOCK003", "DET001", "DET002", "EXC001",
          "LEAD001", "PERF001", "QUEUE001", "OBS001", "OBS002", "DUR001",
          "DUR002", "READ001", "RPC001", "LINT000", "REG001", "REG002",
          "MESH001")
TORCH = ("SYNC001", "JIT001", "JIT002", "CVX001", "SHARD001")

# tests/test_lint.py's module-level fixtures of the copied rules
REF_CONSTANTS = ("LOCK001_BAD", "DET001_BAD", "DET002_BAD", "EXC001_BAD",
                 "LEAD001_BAD", "PERF001_BAD", "OBS002_BAD", "QUEUE001_BAD",
                 "DUR001_APPEND_BAD", "DUR001_REPLACE_BAD",
                 "DUR002_APPEND_IN_LOOP_BAD", "DUR002_FSYNC_IN_LOOP_BAD",
                 "READ001_BAD", "RPC001_HOT", "RPC001_SLEEP",
                 "LOCK002_CYCLE", "LOCK003_BAD", "MESH001_SHAPE_KEY_BAD",
                 "MESH001_EXCEPT_BAD")

# every directory and file scope a copied rule patrols
DIFF_PATHS = ("x.py", "pkg/scheduler/x.py", "pkg/solver/x.py",
              "pkg/server/x.py", "pkg/client/x.py", "pkg/state/x.py",
              "pkg/agent/x.py", "pkg/rpc/x.py", "pkg/solver/placer.py",
              "pkg/scheduler/generic_sched.py", "pkg/server/plan_apply.py",
              "pkg/server/heartbeat.py", "pkg/client/client.py",
              "pkg/server/durable.py", "pkg/server/event_broker.py",
              "pkg/solver/state_cache.py", "pkg/state/usage_index.py")


def findings(src: str, path: str = "x.py"):
    return analyze_source(textwrap.dedent(src), path=path)


def rule_ids(src: str, path: str = "x.py"):
    return [f.rule for f in findings(src, path)]


def _inline_fixtures() -> list:
    """(test name, sources, paths) of each test in tests/test_lint.py of
    a copied rule: the string constants in its body that parse as
    Python (its fixtures) and those that name a .py path (where it
    analyzes them)."""
    with open(os.path.join(REPO_ROOT, "tests", "test_lint.py"),
              encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    want = re.compile(r"test_(%s)_" % "|".join(r.lower() for r in COPIED))
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or not want.match(fn.name):
            continue
        doc = ast.get_docstring(fn, clean=False)
        sources, paths = [], []
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Constant) and
                    isinstance(node.value, str)) or node.value == doc:
                continue
            text = node.value
            if text.endswith(".py") and "\n" not in text:
                paths.append(text)
                continue
            try:
                body = ast.parse(textwrap.dedent(text)).body
            except SyntaxError:
                continue
            if body and not all(isinstance(b, ast.Expr) for b in body):
                sources.append(text)
        if sources:
            out.append((fn.name, sources, paths))
    return out


INLINE = _inline_fixtures()


def _same_findings(src: str, paths) -> None:
    text = textwrap.dedent(src)
    for path in sorted(set(DIFF_PATHS) | set(paths)):
        want = [f for f in ref_analyze(text, path=path) if f.rule in COPIED]
        got = [f for f in analyze_source(text, path=path)
               if f.rule in COPIED]
        assert [(f.rule, f.line, f.col) for f in got] == \
            [(f.rule, f.line, f.col) for f in want], path
        assert [f.message.replace("nomad_tpu_torch", "nomad_tpu")
                for f in got] == [f.message for f in want], path


@pytest.mark.parametrize("name", REF_CONSTANTS)
def test_copied_rules_match_the_reference_on_its_fixtures(name):
    src = getattr(ref_lint, name)
    assert any(f.rule in COPIED for p in DIFF_PATHS
               for f in ref_analyze(textwrap.dedent(src), path=p)), name
    _same_findings(src, ())


@pytest.mark.parametrize("name,sources,paths", INLINE,
                         ids=[t[0] for t in INLINE])
def test_copied_rules_match_the_reference_inline(name, sources, paths):
    for src in sources:
        _same_findings(src, paths)


def test_inline_fixtures_cover_every_copied_file_rule():
    """The inline gathering found the tests of every copied per-file rule
    (REG001/REG002 and LOCK002's trees are tmp-dir tests, not sources)."""
    names = " ".join(t[0] for t in INLINE)
    for rule in COPIED:
        if rule in ("REG001", "LOCK002"):
            continue
        assert f"test_{rule.lower()}_" in names, rule


# ------------------------------------------------------------------ SYNC001

SYNC001_BAD = """
    import numpy as np
    import torch

    def _solve_group(self, placed: torch.Tensor, fut, ev):
        total = torch.cumsum(placed, 0)
        peek = total.cpu()
        n = total[-1].item()
        rows = placed.tolist()
        host = fut.numpy()
        back = placed.to("cpu")
        torch.cuda.synchronize()
        ev.synchronize()
        arr = np.asarray(total)
        k = int(total.sum())
        return peek, n, rows, host, back, arr, k
"""


def test_sync001_fires_on_hot_path_syncs():
    out = findings(SYNC001_BAD, path="solver/placer.py")
    assert [f.rule for f in out] == ["SYNC001"] * 9
    assert "single-sync seam" in out[0].message
    descs = " ".join(f.message.split(" inside ")[0] for f in out)
    for d in (".cpu()", ".item()", ".tolist()", ".numpy()", '.to("cpu")',
              ".synchronize()", "asarray(<tensor>)", "int(<tensor>)"):
        assert d in descs, d
    # microbatch is the other patrolled module
    assert rule_ids(SYNC001_BAD, path="solver/microbatch.py") == \
        ["SYNC001"] * 9


def test_sync001_scope_and_exemptions():
    # scope: the two hot-path modules (and the kernel wrappers', below)
    assert rule_ids(SYNC001_BAD, path="solver/backend.py") == []
    assert rule_ids(SYNC001_BAD, path="server/plan_apply.py") == []
    good = """
        import numpy as np
        import torch

        def _prep(self, gt, placed: np.ndarray, count, host, dev):
            sel = np.flatnonzero(placed > 0)
            pairs = list(zip(sel.tolist(), placed[sel].tolist()))
            k = int(count)                         # a host scalar
            best = host[0].item()                  # a host binding
            ask = np.asarray(gt.ask, np.float32)   # host data
            t = torch.as_tensor(ask).to(dev)       # host -> card
            return pairs, k, best, t
    """
    assert rule_ids(good, path="solver/placer.py") == []
    # module scope is not a per-eval path
    assert rule_ids("import torch\nX = torch.zeros(3).cpu()\n",
                    path="solver/placer.py") == []


def test_sync001_inline_suppression_at_the_seam():
    src = SYNC001_BAD.replace(
        "peek = total.cpu()",
        "peek = total.cpu()  # nomadlint: disable=SYNC001 — the seam")
    src = src.replace(
        "        n = total[-1].item()",
        "        # nomadlint: disable=SYNC001 — the seam's scalar\n"
        "        n = total[-1].item()")
    assert rule_ids(src, path="solver/placer.py") == ["SYNC001"] * 7


def test_sync001_patrols_the_kernel_wrappers_waits(tmp_path):
    """solver/cuda_kernels.py is in scope: the sharded convex solve's one
    wait a block of rounds is a marked seam, and a copy of the module with
    that marker taken out fires at the wait."""
    assert rule_ids(SYNC001_BAD, path="solver/cuda_kernels.py") == \
        ["SYNC001"] * 9
    with open(os.path.join(PORT, "solver", "cuda_kernels.py"),
              encoding="utf-8") as fh:
        lines = fh.read().splitlines(keepends=True)
    assert rule_ids("".join(lines), path="solver/cuda_kernels.py") == []
    at = [i for i, ln in enumerate(lines) if ln.strip() == "ev.synchronize()"]
    assert len(at) == 1 and "disable=SYNC001" in lines[at[0] - 1]
    del lines[at[0] - 1]
    out = findings("".join(lines), path="solver/cuda_kernels.py")
    assert [(f.rule, f.line) for f in out] == [("SYNC001", at[0])]
    assert "convex_solve_sharded" in out[0].message


def _seam_copy(tmp_path, drop=None):
    """A copy of the port's placer.py under tmp_path/solver/, less its
    line at index `drop`."""
    with open(os.path.join(PORT, "solver", "placer.py"),
              encoding="utf-8") as fh:
        lines = fh.read().splitlines(keepends=True)
    if drop is not None:
        del lines[drop]
    path = tmp_path / "solver" / "placer.py"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(lines))
    return path


@pytest.mark.parametrize("seam,flagged", [
    ("return fn(*args).numpy()", ".numpy()"),
    ("placed_pad = chunk.numpy()", ".numpy()"),
    ("return placed.cpu().numpy()", ".cpu()"),
])
def test_sync001_fires_once_a_seam_marker_is_removed(tmp_path, seam,
                                                     flagged):
    assert rule_ids(_seam_copy(tmp_path).read_text(),
                    path="solver/placer.py") == []
    text = _seam_copy(tmp_path).read_text().splitlines()
    at = [i for i, ln in enumerate(text) if ln.strip() == seam]
    assert len(at) == 1 and "disable=SYNC001" in text[at[0] - 1]
    path = _seam_copy(tmp_path, drop=at[0] - 1)
    out = findings(path.read_text(), path="solver/placer.py")
    assert [f.rule for f in out] == ["SYNC001"] * len(out) and out
    assert {f.line for f in out} == {at[0]}            # the seam, 1-based
    assert any(flagged in f.message for f in out)


# ------------------------------------------------------------------ JIT001

JIT001_BAD = """
    import numpy as np
    import torch
    from nomad_tpu_torch.solver.device import device_program

    @device_program
    def program(cap: torch.Tensor, used, ask, count, max_per_node):
        room = torch.clamp(cap - used, min=0)
        k = int(max_per_node)                   # a host scalar: quiet
        n = int(room.sum())
        worst = room.max().item()
        host = np.asarray(room)
        return torch.minimum(room, torch.full_like(room, k)), n, worst, host
"""


def test_jit001_fires_on_host_syncs_in_a_device_program():
    out = findings(JIT001_BAD)
    assert [f.rule for f in out] == ["JIT001"] * 3
    assert "device program `program`" in out[0].message
    assert [f.line for f in out] == [10, 11, 12]


def test_jit001_quiet_outside_device_programs_and_on_host_values():
    plain = JIT001_BAD.replace("    @device_program\n", "")
    assert rule_ids(plain) == []
    good = """
        import torch
        from nomad_tpu_torch.solver import device

        @device.device_program
        def program(cap, used, counts, jitter):
            js = [float(x) for x in jitter]     # host scalars
            dev = cap.device
            n = cap.shape[0]
            cs = torch.tensor([int(c) for c in counts], device=dev)
            return torch.cumsum(cap - used, 0)[:n] * cs, js
    """
    assert rule_ids(good) == []


def test_jit001_inline_suppression():
    src = JIT001_BAD.replace(
        "        n = int(room.sum())",
        "        n = int(room.sum())  # nomadlint: disable=JIT001 — probe")
    assert rule_ids(src) == ["JIT001"] * 2


# ------------------------------------------------------------------ JIT002

JIT002_BAD = """
    import ctypes
    import subprocess
    from torch.utils import cpp_extension

    def launch(path, x):
        lib = ctypes.CDLL(path)
        return lib.kernel_launch(x)

    def compile_it(src, out):
        nvcc = "/usr/local/cuda/bin/nvcc"
        cmd = [nvcc, "-O3", "-o", out, src]
        subprocess.run(cmd, check=True)

    def ext(name, sources):
        mod = cpp_extension.load(name, sources)
        return mod.run()
"""


def test_jit002_fires_on_per_call_kernel_loads():
    out = findings(JIT002_BAD)
    assert [f.rule for f in out] == ["JIT002"] * 3
    msgs = "\n".join(f.message for f in out)
    assert "ctypes.CDLL" in msgs and "nvcc" in msgs and \
        "cpp_extension.load" in msgs


def test_jit002_allows_memoized_loaders():
    good = """
        import ctypes
        import subprocess
        import threading

        LIB = ctypes.CDLL("libk.so")            # module scope: once
        _fns = {}
        _lock = threading.Lock()
        _lib = None

        def factory(path):
            return ctypes.CDLL(path)

        def cached(path):
            _fns[path] = ctypes.CDLL(path)
            return _fns[path]

        def memo(path):
            global _lib
            _lib = ctypes.CDLL(path)
            return _lib

        def loader(name, symbol):
            fn = _fns.get((name, symbol))
            if fn is None:
                with _lock:
                    fn = getattr(ctypes.CDLL(name), symbol)
                    _fns[(name, symbol)] = fn
            return fn

        def make(target):
            subprocess.run(["make", target], check=True)   # not nvcc
    """
    assert rule_ids(good) == []


def test_jit002_inline_suppression():
    src = JIT002_BAD.replace(
        "        lib = ctypes.CDLL(path)",
        "        # the build step of a memoized loader — "
        "nomadlint: disable=JIT002\n"
        "        lib = ctypes.CDLL(path)")
    assert rule_ids(src) == ["JIT002"] * 2


# ------------------------------------------------------------------ CVX001

CVX001_BAD = """
    import torch
    from .kernels import fused_fit_verdict

    def solve(x: torch.Tensor, u, budget, max_iters, cap, used, ask):
        for _ in range(int(max_iters)):
            x = torch.clamp(x - 0.1, min=0.0)
        it = 0
        while it < 50:
            x = x * 0.5
            it += 1
        verdicts = []
        for k in range(3):
            verdicts.append(fused_fit_verdict(cap, used, ask, x))
        return x, verdicts
"""


def test_cvx001_fires_on_python_loops_around_tensor_work():
    out = findings(CVX001_BAD, path="solver/convex.py")
    assert [f.rule for f in out] == ["CVX001"] * 3
    assert "one-launch contract" in out[0].message
    assert [f.line for f in out] == [6, 9, 13]


def test_cvx001_scope_and_exemptions():
    # scope: only the convex module is patrolled
    assert rule_ids(CVX001_BAD, path="solver/kernels.py") == []
    assert rule_ids(CVX001_BAD, path="solver/placer.py") == []
    good = """
        import torch

        def solve(x, u, budget, names):
            # host-side bookkeeping loops with no tensor work are fine
            out = []
            for k in range(3):
                out.append(str(k))
            for n in names:
                out.append(n.upper())
            return torch.clamp(x, max=u), out
    """
    assert rule_ids(good, path="solver/convex.py") == []


def test_cvx001_inline_suppression():
    src = CVX001_BAD.replace(
        "        while it < 50:",
        "        while it < 50:"
        "  # nomadlint: disable=CVX001 — the plain version's loop")
    assert rule_ids(src, path="solver/convex.py") == ["CVX001"] * 2


def test_convex_module_keeps_its_loops_marked():
    """convex.py's loops are the plain versions' (solo and sharded) and
    the reduction trees (the solo kernel's and the shard partials'), each
    marked; the card's solve stays launches of the kernels."""
    with open(os.path.join(PORT, "solver", "convex.py"),
              encoding="utf-8") as fh:
        text = fh.read()
    assert rule_ids(text, path="solver/convex.py") == []
    bare = text.replace("nomadlint: disable=CVX001", "cvx001 audited")
    assert rule_ids(bare, path="solver/convex.py").count("CVX001") == 7


# ------------------------------------------------------- the gate, REG002

# ----------------------------------------------------------------- SHARD001

SHARD001_MOVE_BAD = """
import torch
from . import sharding

def solve_on_mesh(cap, used_dev, ask, dev):
    m = sharding.mesh()
    whole = cap.to(dev)
    rows = used_dev.cuda()
    asked = torch.as_tensor(cap, device=dev)
    up = _upload(used_dev, dev)
    return m, whole, rows, asked, up, ask.to(dev)
"""


def test_shard001_fires_on_whole_matrix_moves_in_mesh_code():
    out = findings(SHARD001_MOVE_BAD, path="solver/placer.py")
    assert [f.rule for f in out] == ["SHARD001"] * 4
    assert {f.line for f in out} == {7, 8, 9, 10}
    assert "put_node_sharded" in out[0].message


def test_shard001_quiet_off_the_mesh_with_lead_and_in_owner_files():
    # a function that never handles the mesh moves matrices freely (the
    # solo tiers' upload)
    solo = SHARD001_MOVE_BAD.replace("    m = sharding.mesh()\n", "") \
        .replace("return m, ", "return ")
    assert rule_ids(solo, path="solver/backend.py") == []
    # the visible meeting on the first shard is the blessed form
    lead = """
    from . import sharding

    def convex_on_mesh(cap_res, used_res):
        if sharding.is_node_sharded(cap_res):
            cap_res, used_res = cap_res.lead(), used_res.lead()
        return cap_res, used_res
    """
    assert rule_ids(lead, path="solver/placer.py") == []
    # sharding.py and state_cache.py own placement decisions
    assert rule_ids(SHARD001_MOVE_BAD, path="solver/sharding.py") == []
    assert rule_ids(SHARD001_MOVE_BAD,
                    path="nomad_tpu_torch/solver/state_cache.py") == []


SHARD001_LAYOUT_BAD = """
from .sharding import NODE, REP, LEAD, sharded_program

def build(m):
    @sharded_program(m, ins=(NODE, NODE, REP), out=LEAD)
    def two(cap, used):
        return cap

    @sharded_program(m, ins=(NODE,), out=(LEAD, LEAD))
    def one(score):
        return score, score, score

    @sharded_program(m, out=LEAD)
    def bare(cap):
        return cap

    @sharded_program(m, ins=(NODE, REP), out=(LEAD, LEAD))
    def good(cap, ask):
        return cap, ask
    return two, one, bare, good
"""


def test_shard001_layout_arity_fires_everywhere():
    for path in ("solver/sharding.py", "solver/placer.py", "x.py"):
        out = findings(SHARD001_LAYOUT_BAD, path=path)
        assert [(f.rule, f.line) for f in out] == [
            ("SHARD001", 5), ("SHARD001", 9), ("SHARD001", 13)], path
    msgs = [f.message for f in findings(SHARD001_LAYOUT_BAD)]
    assert "ins has 3 layouts but `two` takes 2" in msgs[0]
    assert "out has 2 layouts but `one` returns a 3-tuple" in msgs[1]
    assert "declares no `ins`" in msgs[2]


def test_shard001_inline_suppression():
    src = SHARD001_MOVE_BAD.replace(
        "    whole = cap.to(dev)\n",
        "    # nomadlint: disable=SHARD001 — a one-shard debug copy\n"
        "    whole = cap.to(dev)\n")
    assert rule_ids(src, path="solver/placer.py") == ["SHARD001"] * 3


def test_shard001_holds_the_ports_sharded_programs():
    """Every sharded program of the port declares its layouts, and a copy
    of sharding.py with one layout taken out fires."""
    path = os.path.join(PORT, "solver", "sharding.py")
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    assert text.count("@sharded_program(") == 10
    assert rule_ids(text, path="solver/sharding.py") == []
    broken = text.replace("ins=(NODE, NODE, REP, REP, NODE, REP), out=LEAD",
                          "ins=(NODE, NODE, REP, REP, NODE), out=LEAD", 1)
    assert broken != text
    assert rule_ids(broken, path="solver/sharding.py") == ["SHARD001"]


@pytest.mark.parametrize("layout,broken", [
    # the sharded scan: 17 inputs, the reference's 4 outputs
    ("REP, NODE, REP),\n                     out=(NODE, NODE, REP, REP))",
     "REP, NODE),\n                     out=(NODE, NODE, REP, REP))"),
    ("out=(NODE, NODE, REP, REP))", "out=(NODE, NODE, REP))"),
    # the sharded convex: placed and fit on the node layout, 3 scalars
    ("out=(NODE, NODE, REP, REP, REP))", "out=(NODE, NODE, REP, REP))"),
    # the eval-batched greedy's 2-D layouts
    ("EVALS_NODE), out=LEAD)", "), out=LEAD)"),
])
def test_shard001_holds_the_meshs_new_programs(layout, broken):
    """The sharded scan's, the sharded convex's and the eval-batched
    greedy's declared layouts: a copy of sharding.py with one of them
    made to disagree with its program fires at that program."""
    path = os.path.join(PORT, "solver", "sharding.py")
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    assert text.count(layout) == 1, layout
    out = findings(text.replace(layout, broken), path="solver/sharding.py")
    assert [f.rule for f in out] == ["SHARD001"]


# ------------------------------------------------------------------ MESH001

MESH001_PORT_EXCEPT_BAD = """
from . import backend, sharding

def solve(args):
    try:
        return sharding.sharded_fill_depth(sharding.mesh())(*args)
    except Exception:
        return None

def solve_classified(args):
    try:
        return sharding.sharded_fill_greedy(sharding.mesh())(*args)
    except Exception as e:
        backend.note_dispatch_failure("sharded", e)
        raise
"""


def test_mesh001_fires_on_the_ports_sharded_wrappers():
    """The copied MESH001 reads the port's names: a broad except around
    the port's sharded solve that never classifies fires; one that feeds
    note_dispatch_failure does not; outside solver/ nothing fires."""
    out = findings(MESH001_PORT_EXCEPT_BAD, path="solver/backend.py")
    assert [(f.rule, f.line) for f in out] == [("MESH001", 7)]
    assert rule_ids(MESH001_PORT_EXCEPT_BAD, path="server/x.py") == []


def test_obs001_polices_the_timing_helper():
    """obs/timing.py's calls feed the registry and the tracer: OBS001
    holds their sample names to bounded dimensions and their context
    managers to a `with`, as it holds metrics.* and trace.*."""
    bad = textwrap.dedent("""
        from ..obs import timing
        def f(ev, t0, ctx):
            with timing.timed(f"nomad.x.{ev.id}", "x"):
                pass
            timing.waited(f"nomad.y.{ev.id}", "y", t0, ctx)
            timing.timed("nomad.z", "z")
    """)
    assert rule_ids(bad).count("OBS001") == 3
    good = textwrap.dedent("""
        from ..obs import timing
        def f(ev, t0, ctx):
            with timing.timed(f"nomad.x.{ev.type}", "x", id=ev.id):
                pass
            timing.waited("nomad.y", "y", t0, ctx, eval=ev.id)
    """)
    assert "OBS001" not in rule_ids(good)


def test_nomadlint_gate_whole_port():
    """The acceptance gate: `python -m nomad_tpu_torch.analysis
    nomad_tpu_torch` exits 0 on the shipped tree within 30 s."""
    t0 = time.monotonic()
    res = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.analysis",
         "nomad_tpu_torch"], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120)
    dt = time.monotonic() - t0
    assert res.returncode == 0, f"nomadlint regressions:\n{res.stdout}"
    assert dt < 30.0, f"full-port scan took {dt:.1f}s (budget 30s)"


def test_list_rules_names_every_reference_rule_but_the_mesh_ones():
    """Every reference rule id, the mesh's SHARD001 and MESH001 included
    since the port has a mesh (the name is kept from before it did)."""
    from nomad_tpu.analysis import all_rules as ref_rules
    buf = io.StringIO()
    assert lint_main(["--list-rules"], out=buf) == 0
    listed = {ln.split()[0] for ln in buf.getvalue().splitlines()}
    want = {r.id for r in ref_rules()}
    assert {"SHARD001", "MESH001"} <= listed
    assert listed == want == {r.id for r in all_rules()}
    assert set(COPIED) | set(TORCH) == want


def test_port_baseline_entries_carry_reasons_and_name_the_port():
    base = Baseline.load(os.path.join(PORT, ".nomadlint-baseline.json"))
    assert base.entries
    for e in base.entries:
        assert e.get("reason"), e
        assert e["path"].startswith("nomad_tpu_torch/"), e
        assert os.path.exists(os.path.join(REPO_ROOT, e["path"])), e


def _rules_tree(tmp_path, drop: str = ""):
    """A copy of the port's analyzer, RULES.md and this test file under
    tmp_path, RULES.md less the row of rule `drop`."""
    pkg = tmp_path / "nomad_tpu_torch" / "analysis"
    shutil.copytree(os.path.join(PORT, "analysis"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    rules = (pkg / "RULES.md").read_text().splitlines(keepends=True)
    if drop:
        rules = [ln for ln in rules
                 if not ln.startswith(f"| **{drop}** |")]
    (pkg / "RULES.md").write_text("".join(rules))
    tests = tmp_path / "tests"
    tests.mkdir(exist_ok=True)
    shutil.copy(os.path.abspath(__file__),
                tests / "test_torch_analysis.py")
    return pkg


@pytest.mark.parametrize("drop", ["SYNC001", "REG001"])
def test_reg002_reads_the_ports_rule_table(tmp_path, drop):
    pkg = _rules_tree(tmp_path)
    rc = lint_main(["--no-baseline", str(pkg)], out=(buf := io.StringIO()))
    assert rc == 0, buf.getvalue()
    shutil.rmtree(tmp_path / "nomad_tpu_torch")
    pkg = _rules_tree(tmp_path, drop=drop)
    rc = lint_main(["--json", "--no-baseline", str(pkg)],
                   out=(buf := io.StringIO()))
    rows = json.loads(buf.getvalue())
    assert rc == 1
    assert [(r["rule"], r["message"]) for r in rows] == [(
        "REG002", f"rule {drop} is registered but has no row in the "
        f"{os.path.relpath(pkg / 'RULES.md')} rules table")]


def test_reg002_reads_the_ports_fixture_file(tmp_path):
    pkg = _rules_tree(tmp_path)
    (tmp_path / "tests" / "test_torch_analysis.py").write_text(
        "COVERS = 'every rule but one: " +
        " ".join(r.id for r in all_rules() if r.id != "JIT002") + "'\n")
    rc = lint_main(["--json", "--no-baseline", str(pkg)],
                   out=(buf := io.StringIO()))
    rows = json.loads(buf.getvalue())
    assert rc == 1
    assert [r["rule"] for r in rows] == ["REG002"]
    assert "rule JIT002 has no fixture coverage in" in rows[0]["message"]
    assert rows[0]["message"].endswith(
        "test_torch_analysis.py (the id never appears)")


def test_reg001_reads_the_fault_catalog_for_the_port(tmp_path):
    """REG001 reads docs/FAULT_INJECTION.md as the reference's does
    (tests/test_lint.py's fixture tree, run through the port)."""
    ref_lint._write(tmp_path / "docs" / "FAULT_INJECTION.md", """
        ## Site catalog

        | site | where |
        | --- | --- |
        | `nomad.plan.apply` | the applier |
        | `nomad.node.ghost` | nowhere anymore |
    """)
    ref_lint._write(tmp_path / "pkg" / "applier.py", """
        def kick(faults, plan):
            faults.fire("nomad.plan.apply")
            faults.fire("nomad.plan.undocumented")
    """)
    rc = lint_main(["--json", "--no-baseline", str(tmp_path / "pkg")],
                   out=(buf := io.StringIO()))
    rows = json.loads(buf.getvalue())
    assert rc == 1
    assert [r["rule"] for r in rows] == ["REG001", "REG001"]
    msgs = "\n".join(r["message"] for r in rows)
    assert "`nomad.plan.undocumented` is fired here but has no row" in msgs
    assert "`nomad.node.ghost` is fired nowhere" in msgs


def test_the_port_tree_reads_real_registry_tables():
    """The whole-port scan's registry rules run against real tables: the
    fault catalog, RULES.md's rows for every registered rule, and this
    file's text (a discovery that found nothing would make them quiet)."""
    from nomad_tpu_torch.analysis.project import DocsInfo
    docs = DocsInfo.discover([PORT])
    assert docs.root == REPO_ROOT
    assert docs.fault_rows and docs.fault_doc_path.endswith(
        os.path.join("docs", "FAULT_INJECTION.md"))
    assert {r for r, _, _ in docs.rule_rows} == {r.id for r in all_rules()}
    assert docs.rules_doc_path.endswith(
        os.path.join("nomad_tpu_torch", "analysis", "RULES.md"))
    assert docs.test_lint_text is not None and \
        docs.test_lint_path.endswith("test_torch_analysis.py")
