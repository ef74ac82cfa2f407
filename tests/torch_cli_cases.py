"""Shared by the test_torch_cli_*.py files: each task of the task CLI run
through the port's `tasks/run.main([task, "--cpu", "--x64"])` and through
the JAX package's `tasks/run.main([task])` (x64 on, `conftest.py`) on the
same inputs, and their JSON lines compared.

The same inputs: both packages' `parity.RESULTS_DIR` point at the stand-in
pickles (`tasks/golden/standin/`), and the port's `run.draw_normal` is
replaced by the JAX CLI's `jax.random` draws.  The JAX line comes from a
live run, or, for the tasks whose JAX run takes over ~30 s on the CPU
(`JAX_GOLDEN`), from its committed line (`tasks/golden/standin/jax_cli/`,
`scripts/gen_torch_port_standin_pickles.py`).

The lines must have the same keys, equal ints, bools and strings, and
floats within rel 1e-6 (f64 tasks) or rel 1e-3 (the f32 tasks, the
`tests/test_pipeline.py:48` tolerances), with an absolute floor for
values at roundoff level (1e-9 for f64, 5e-4 for f32: a gradient norm of
1e-13 or an orthogonality violation of 1e-16 is noise in both packages).
Times and rates are left out, and so are `engine` (the name of the
solver each package ran) and `pickle` (a temporary path).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.tasks import parity as jparity
from trajectory_optimization_matrix_lie_groups_tpu.tasks import run as jrun
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import parity
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import run

JAX_GOLDEN = ("mpc_batch_constrained", "benchmark_compare", "benchmark_compare_so3")
F32_TASKS = ("mpc_batch", "mpc_batch_constrained")
SKIP_KEYS = ("wall_s", "solves_per_s", "mpc_solves_per_s", "ms_per_solve", "engine",
             "pickle")
TOL = {"f64": (1e-6, 1e-9), "f32": (1e-3, 5e-4)}


def jax_draw_normal(seed, shape, dtype, device):
    """The JAX CLI's draws: jax.random.normal(PRNGKey(seed), shape) in the
    matching dtype."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=jdt))
    return torch.as_tensor(x).to(device)


@pytest.fixture
def standins(monkeypatch):
    """Both packages on the stand-in pickles, the port on the JAX draws, one
    torch thread (the port's CPU path runs thousands of tiny ops)."""
    monkeypatch.setattr(parity, "RESULTS_DIR", parity.STANDIN_DIR)
    monkeypatch.setattr(jparity, "RESULTS_DIR", parity.STANDIN_DIR)
    monkeypatch.setattr(run, "draw_normal", jax_draw_normal)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _last_line(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def port_line(task, *extra):
    return _last_line(run.main, [task, "--cpu", "--x64", *extra])


def jax_line(task, *extra):
    if task in JAX_GOLDEN and not extra:
        path = os.path.join(parity.STANDIN_DIR, "jax_cli", f"{task}.json")
        with open(path) as f:
            return json.load(f)["line"]
    return _last_line(jrun.main, [task, *extra])


def assert_lines_match(port, ref, task, path="line"):
    """Recursive comparison of two JSON values (module docstring)."""
    rtol, atol = TOL["f32" if task in F32_TASKS else "f64"]
    if isinstance(ref, dict):
        assert isinstance(port, dict), path
        keys = set(ref) - set(SKIP_KEYS)
        assert set(port) - set(SKIP_KEYS) == keys, (path, sorted(port), sorted(ref))
        for k in sorted(keys):
            assert_lines_match(port[k], ref[k], task, f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_lines_match(a, b, task, f"{path}[{i}]")
    elif isinstance(ref, (bool, str)) or ref is None:
        assert port == ref, (path, port, ref)
    elif isinstance(ref, int) and not isinstance(port, float):
        assert port == ref, (path, port, ref)
    else:
        assert isinstance(port, (int, float)), path
        assert abs(port - ref) <= max(rtol * abs(ref), atol), (path, port, ref)


def check_task(task):
    """Run ``task`` through both CLIs and compare; returns (port, jax) lines."""
    ref = jax_line(task)
    port = port_line(task)
    assert_lines_match(port, ref, task)
    return port, ref
