"""The port's `viz/` against the JAX package's: the plots write PNGs (from
CPU tensors and lists alike), `export_quatpos` writes the JAX package's
array, and `pose_error_grid` (one batched evaluation) equals the JAX
vmapped grid to 1e-12 in f64, left and right error."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups_tpu.ops import se3 as jse3
from trajectory_optimization_matrix_lie_groups_tpu.viz import cost_landscape as jcl
from trajectory_optimization_matrix_lie_groups_tpu.viz import plots as jplots
from trajectory_optimization_matrix_lie_groups_tpu_torch.viz import cost_landscape, plots

RNG = np.random.default_rng(3)


def _traj(n):
    xi = 0.3 * RNG.standard_normal((n, 6))
    return np.asarray(jse3.exp(jnp.asarray(xi)))


def test_plots_write_pngs(tmp_path):
    J = torch.tensor([5.0, 3.0, 2.0, 1.5])
    g = [1.0, 0.1, 0.01, 1e-3]
    qs, q_ref = torch.as_tensor(_traj(12)), _traj(12)
    paths = [
        plots.convergence(J, g, str(tmp_path / "conv.png")),
        plots.convergence(J, g, str(tmp_path / "conv3.png"), defect_hist=[1e-2, 1e-4, 1e-8, 1e-12]),
        plots.trajectory_3d(qs, q_ref, str(tmp_path / "traj.png")),
        plots.trajectory_3d(qs[:, :3, :3], torch.as_tensor(q_ref[:, :3, :3]),
                            str(tmp_path / "att.png")),
        plots.controls(torch.randn(10, 4, dtype=torch.float64), str(tmp_path / "u.png"),
                       us_ref=np.zeros((10, 4))),
    ]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", p


def test_export_quatpos_matches_jax(tmp_path):
    qs = _traj(9)
    a = plots.export_quatpos(torch.as_tensor(qs), str(tmp_path / "a.npy"))
    b = jplots.export_quatpos(qs, str(tmp_path / "b.npy"))
    np.testing.assert_allclose(np.load(a), np.load(b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("left", [True, False], ids=["left", "right"])
def test_pose_error_grid_matches_jax(left, tmp_path):
    q0 = _traj(1)[0]
    Q1 = np.diag([10.0, 10.0, 10.0, 1.0, 1.0, 1.0])
    th_z, th_y = np.linspace(-180.0, 180.0, 13), np.linspace(-90.0, 90.0, 7)
    Z, TZ, TY = cost_landscape.pose_error_grid(torch.as_tensor(np.array(q0)), th_z, th_y,
                                               torch.as_tensor(Q1), left=left)
    jZ, jTZ, jTY = jcl.pose_error_grid(jnp.asarray(q0), th_z, th_y, Q1, left=left)
    assert Z.shape == (13, 7) and isinstance(Z, np.ndarray)
    np.testing.assert_allclose(Z, jZ, rtol=0, atol=1e-12)
    np.testing.assert_allclose(TZ, jTZ, rtol=0, atol=1e-15)
    np.testing.assert_allclose(TY, jTY, rtol=0, atol=1e-15)
    p = cost_landscape.plot_landscape(Z, th_z, th_y, str(tmp_path / "z.png"))
    with open(p, "rb") as f:
        assert f.read(4) == b"\x89PNG"
