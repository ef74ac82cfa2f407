"""The PyTorch port stands without JAX: importing every module of the port
(and `chip_smoke.py`) in a fresh interpreter loads neither `jax` nor the
JAX package, and `chip_smoke.py` without a CUDA device exits non-zero
without printing a result.  The native runtime's loader and C++ sources
are the port's own: nothing under the port names the JAX package's
`native/`."""

import os
import pkgutil
import subprocess
import sys

import pytest

import trajectory_optimization_matrix_lie_groups_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "trajectory_optimization_matrix_lie_groups_tpu"


def _port_modules():
    return [port.__name__] + [m.name for m in pkgutil.walk_packages(
        port.__path__, prefix=port.__name__ + ".")]


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for m in ("ops.so3", "ops.se3", "ops.group", "ops.lane_lie", "ops.linearize",
              "models.dynamics", "models.costs", "utils.trajectories",
              "tasks.al_bench", "solvers.pipeline", "solvers.df_pipeline",
              "solvers.df_mixed", "solvers.pipeline_so3", "tasks.so3_bench",
              "kernel_check", "convert", "_build", "models.base", "ops.riccati",
              "ops.rollout", "solvers.batched", "models.constraints",
              "solvers.al_pipeline", "solvers.al_fast", "solvers.mpc",
              "solvers.riccati", "solvers.lie_ilqr", "solvers.al_ilqr",
              "solvers.anchored", "solvers.polish", "models.autodiff",
              "solvers.ilqr", "tasks.cartpole", "models.errorstate",
              "solvers.errorstate_ilqr", "parallel", "parallel.batch", "parallel.sweep",
              "tasks.errstate_bench", "tasks.parity", "tasks.run", "utils.rotations",
              "utils.metrics", "utils.checkpoint", "utils.profiling", "utils.records",
              "baselines", "baselines.embedded", "viz", "viz.plots", "viz.cost_landscape",
              "native", "solvers.graph", "parallel.multihost", "parallel.riccati_sharded",
              "parallel.pipeline_sharded", "viz.replay", "viz.interactive",
              "baselines.numpy_serial", "tasks.toy"):
        assert f"{port.__name__}.{m}" in mods, m


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        f" or m == {JAX_PKG!r} or m.startswith({JAX_PKG + '.'!r}))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("where", ["repo", "bare_directory"])
def test_chip_smoke_without_cuda_fails_without_a_result(where, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the no-CUDA path")
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "bare_directory":
        (tmp_path / "chip_smoke.py").write_bytes(open(script, "rb").read())
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    else:
        cwd = ROOT
    r = subprocess.run([sys.executable, script], capture_output=True, text=True,
                       timeout=120, cwd=cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_native_runtime_is_the_port_own_copy():
    root = os.path.join(ROOT, "trajectory_optimization_matrix_lie_groups_tpu_torch", "native")
    assert sorted(os.listdir(os.path.join(root, "src"))) == ["ilqr.cpp", "lie.hpp"]
    loader = open(os.path.join(root, "__init__.py")).read()
    assert JAX_PKG + "." not in loader and JAX_PKG + "/" not in loader
