"""Convergence and trajectory plots (counterpart of the JAX `viz/plots.py`,
the reference's matplotlib layer).

Covers the plotting the reference does inline in its `main_*`/`benchmark_*`
scripts (cost/gradient/defect histories, 3-D trajectory vs reference,
control sequences).  Headless: figures are written to files via the Agg
backend.  Tensors (from any device) go to the host only here, at plot
time; `export_quatpos` writes a trajectory in the reference's `.npy`
quat-pos format for any external viewer.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import torch


def _host(x):
    """A tensor (any device), array or list as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def convergence(J_hist, grad_hist, path, defect_hist=None):
    """Cost / gradient / defect history panels (benchmark_SE3_tracking-style)."""
    n = 3 if defect_hist else 2
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3.2))
    axes[0].plot(_host(J_hist), marker="o", ms=3)
    axes[0].set_title("cost")
    axes[0].set_yscale("log")
    axes[1].plot(_host(grad_hist), marker="o", ms=3)
    axes[1].set_title("gradient norm")
    axes[1].set_yscale("log")
    if defect_hist:
        axes[2].plot(_host(defect_hist), marker="o", ms=3)
        axes[2].set_title("defect norm")
        axes[2].set_yscale("log")
    for ax in axes:
        ax.set_xlabel("iteration")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def trajectory_3d(qs, q_ref, path):
    """Solution vs reference positions in 3-D (SE(3)); for SO(3) (3x3
    matrices, no translation) plots the attitude-error angle instead."""
    qs = _host(qs)
    q_ref = _host(q_ref)
    if qs.shape[-1] == 3:
        err = np.einsum("nji,njk->nik", q_ref[: len(qs), :3, :3], qs[:, :3, :3])
        ang = np.degrees(np.arccos(np.clip(
            (np.trace(err, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)))
        fig, ax = plt.subplots(figsize=(6, 3.2))
        ax.plot(ang, lw=1.2)
        ax.set_xlabel("stage")
        ax.set_ylabel("attitude error [deg]")
        ax.grid(alpha=0.3)
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(projection="3d")
    p = qs[:, :3, 3]
    pr = q_ref[:, :3, 3]
    ax.plot(*pr.T, "k--", lw=1, label="reference")
    ax.plot(*p.T, "-", lw=1.5, label="solution")
    ax.scatter(*p[0], c="g", s=30, label="start")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def controls(us, path, us_ref=None):
    """Per-channel control sequences."""
    us = _host(us)
    nu = us.shape[1]
    fig, axes = plt.subplots(nu, 1, figsize=(7, 1.6 * nu), sharex=True)
    for j, ax in enumerate(np.atleast_1d(axes)):
        ax.plot(us[:, j], lw=1)
        if us_ref is not None:
            ax.plot(_host(us_ref)[:, j], "k--", lw=0.8)
        ax.set_ylabel(f"u[{j}]")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def export_quatpos(qs, path):
    """Export an SE(3) trajectory in the reference's quat-pos .npy format
    (`SE32quatpos`, traopt_utilis.py:299) for external 3-D viewers."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3

    np.save(path, _host(se3.quatpos_from_matrix(torch.as_tensor(qs))))
    return path
