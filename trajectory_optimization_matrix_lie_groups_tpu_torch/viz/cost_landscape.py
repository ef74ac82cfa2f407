"""SE(3) cost-landscape grids (counterpart of the JAX `viz/cost_landscape.py`,
the reference's `visual_cost_*` scripts).

`visualization/visual_cost_{2d,3d_fixed,3d_slider,3d_anime}.py` sweep the
initial attitude over a (theta_z, theta_y) grid and plot the tracking-cost
landscape.  Here the whole grid is one batched cost evaluation on the
caller's device (every grid point a row of the batch; the JAX module
vmaps); the plot runs on the host.
"""

import math

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3, so3


def pose_error_grid(q_ref0, th_z_deg, th_y_deg, Q1, left=True):
    """Cost landscape ||Log(X Xref^-1)||^2_Q1 over an attitude grid.

    Args:
      q_ref0: (4, 4) reference pose tensor the grid perturbs around; the
        grid is computed on its device, in its dtype.
      th_z_deg, th_y_deg: 1-D arrays of angles (degrees).
      Q1: (6, 6) pose-error weight.
      left: left-error Log(X Xref^-1) (reference default) vs right-error.

    Returns (Z, TH_Z, TH_Y) as numpy arrays with Z[i, j] the cost at
    (th_z[i], th_y[j]).
    """
    q0 = torch.as_tensor(q_ref0)
    t = lambda x: (x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x, np.float64))).to(device=q0.device, dtype=q0.dtype)
    tz = t(th_z_deg) * (math.pi / 180.0)
    ty = t(th_y_deg) * (math.pi / 180.0)
    TZ, TY = torch.meshgrid(tz, ty, indexing="ij")
    z = torch.zeros_like(TZ)
    # rotate about y then z
    R = so3.exp(torch.stack([z, z, TZ], dim=-1).reshape(-1, 3)) @ so3.exp(
        torch.stack([z, TY, z], dim=-1).reshape(-1, 3))
    n = R.shape[0]
    X = se3.from_rotation_translation(R @ se3.rotation(q0),
                                      se3.translation(q0).expand(n, 3))
    if left:
        e = se3.log(X @ se3.inverse(q0))
    else:
        e = se3.log(se3.inverse(q0) @ X)
    J = torch.einsum("ni,ij,nj->n", e, t(Q1), e)
    return (J.reshape(len(th_z_deg), len(th_y_deg)).cpu().numpy(),
            TZ.cpu().numpy(), TY.cpu().numpy())


def plot_landscape(Z, th_z_deg, th_y_deg, path, title="SE(3) cost landscape"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5.5, 4.4))
    im = ax.pcolormesh(th_y_deg, th_z_deg, Z, shading="auto")
    fig.colorbar(im, ax=ax, label="cost")
    ax.set_xlabel("theta_y [deg]")
    ax.set_ylabel("theta_z [deg]")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
