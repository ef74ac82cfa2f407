"""Interactive sweep viewers: slider and animation over sweep results
(counterpart of the JAX `viz/interactive.py`).

Equivalents of the reference's interactive result browsers
(`visualization/perturb_all_slider.py`, `perturb_all_anime.py`,
`rollout_all_slider.py`): a 3-D trajectory view with a
`matplotlib.widgets.Slider` scrubbing through one sweep parameter's values,
and a frame-per-value animation writer.  Figures build headless under Agg
(call `plt.show()` to browse them interactively).  matplotlib is imported
inside each function, so that importing this module needs none (the card's
machine has none).

Works on both result families of `parallel/sweep.py`: `RolloutSweepResult`
(pose trajectories) in `rollout_slider`/`rollout_animation`, `SweepResult`
(solved controls and costs) in `sweep_slider`.
"""

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _traj_ax(fig):
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    return ax


def rollout_slider(result, q_ref=None):
    """3-D trajectory viewer with a slider over one sweep parameter.

    Args:
      result: a `RolloutSweepResult` (qs: (n_values, N+1, 4, 4)).
      q_ref: optional (N+1, 4, 4) reference path drawn underneath.

    Returns:
      (fig, slider, update): `update(i)` redraws value index i (for
      headless tests and programmatic scrubbing).
    """
    plt = _pyplot()
    from matplotlib.widgets import Slider

    qs = np.asarray(result.qs)
    values = np.asarray(result.values)
    fig = plt.figure(figsize=(9, 8))
    ax = _traj_ax(fig)
    if q_ref is not None:
        q_ref = np.asarray(q_ref)
        ax.plot(q_ref[:, 0, 3], q_ref[:, 1, 3], q_ref[:, 2, 3],
                color="gray", lw=1, alpha=0.6, label="reference")
    (line,) = ax.plot(qs[0, :, 0, 3], qs[0, :, 1, 3], qs[0, :, 2, 3],
                      color="C0", label=f"{result.param}={values[0]:.3g}")
    ax.legend(loc="upper right")
    fig.subplots_adjust(bottom=0.15)
    s_ax = fig.add_axes([0.2, 0.05, 0.6, 0.03])
    slider = Slider(s_ax, result.param, 0, len(values) - 1, valinit=0, valstep=1)

    def update(i):
        i = int(i)
        line.set_data(qs[i, :, 0, 3], qs[i, :, 1, 3])
        line.set_3d_properties(qs[i, :, 2, 3])
        line.set_label(f"{result.param}={values[i]:.3g}")
        ax.legend(loc="upper right")
        fig.canvas.draw_idle()

    slider.on_changed(update)
    return fig, slider, update


def sweep_slider(result):
    """Solved-sweep viewer: control norms and optimal cost against the
    slider's value (`SweepResult` stores us/J_opt/grad_norm per value)."""
    plt = _pyplot()
    from matplotlib.widgets import Slider

    us = np.asarray(result.us)
    values = np.asarray(result.values)
    J = np.asarray(result.J_opt)
    fig, (ax_u, ax_J) = plt.subplots(1, 2, figsize=(10, 4))
    (line,) = ax_u.plot(np.linalg.norm(us[0], axis=-1), color="C0")
    ax_u.set_xlabel("stage")
    ax_u.set_ylabel("|u|")
    ax_u.set_title(f"{result.param}={values[0]:.3g}")
    ax_J.plot(values, J, color="C1")
    marker = ax_J.axvline(values[0], color="C0", ls="--")
    ax_J.set_xlabel(result.param)
    ax_J.set_ylabel("J*")
    ax_J.set_yscale("log")
    fig.subplots_adjust(bottom=0.22)
    s_ax = fig.add_axes([0.2, 0.06, 0.6, 0.03])
    slider = Slider(s_ax, result.param, 0, len(values) - 1, valinit=0, valstep=1)

    def update(i):
        i = int(i)
        line.set_ydata(np.linalg.norm(us[i], axis=-1))
        ax_u.relim()
        ax_u.autoscale_view()
        ax_u.set_title(f"{result.param}={values[i]:.3g}")
        marker.set_xdata([values[i], values[i]])
        fig.canvas.draw_idle()

    slider.on_changed(update)
    return fig, slider, update


def rollout_animation(result, path, q_ref=None, fps=10):
    """Write a frame-per-value animation (`perturb_all_anime.py` analog)
    with the pillow writer (gif)."""
    plt = _pyplot()
    from matplotlib.animation import FuncAnimation, PillowWriter

    fig, _, update = rollout_slider(result, q_ref=q_ref)
    anim = FuncAnimation(fig, update, frames=len(result.values))
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path
