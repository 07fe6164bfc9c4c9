"""The import check compares whole top-level names, and a run of the
harness on the CPU loads neither JAX nor the JAX package."""
import subprocess
import sys

from portbench.lib import guard, spec


def test_whole_top_level_names():
    mods = ["nomad_tpu_torch", "nomad_tpu_torch.server", "jax", "jax.numpy",
            "jaxlib", "flax.linen", "nomad_tpu", "nomad_tpu.solver",
            "jaxtyping", "nomad_tpu_extra", "numpy"]
    assert guard.forbidden_loaded(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib", "flax.linen", "nomad_tpu",
         "nomad_tpu.solver"])


def test_a_cpu_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.lib import driver, guard, spec\n"
        "run = driver.Run(spec.load_benchmark(), 'c2m-batch-10k.stream',"
        " 3, 1.0, False, device='cpu', nodes=100, count_scale=0.05)\n"
        "run.setup(); run.window(); out = run.finish()\n"
        "print('LOADED', guard.forbidden_loaded())\n" % str(spec.ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout
