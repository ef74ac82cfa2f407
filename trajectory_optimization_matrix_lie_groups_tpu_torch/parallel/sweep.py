"""Initial-condition perturbation sweeps (counterpart of the JAX
`parallel/sweep.py`).

Replaces `visualization/perturb_all_compute.py`: the reference fans out one
OS process per (parameter, value) pair with `joblib.Parallel`
(`perturb_all_compute.py:245`), each running a full serial SE(3) iLQR solve.
Here each parameter's sweep is one batched solve (`BatchSolver`, the
batch-native `LieILQR`), and each rollout sweep one loop over steps of the
model's batched step.

Parameter semantics mirror the reference (`perturb_all_compute.py:44-110`):
each sweep point perturbs exactly one component of the initial state:
Euler angles of the initial attitude (th_z/th_y/th_x, degrees), angular
velocity (w_*), position (p_*), or linear velocity (v_*).  On a device mesh
(`batch.make_batch_mesh`) each rank takes its rows of every range and the
results are gathered to every rank.
"""

from typing import Dict, NamedTuple

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3, so3
from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel import multihost
from trajectory_optimization_matrix_lie_groups_tpu_torch.parallel.batch import BatchSolver

PARAM_NAMES = ("th_z", "th_y", "th_x", "w_x", "w_y", "w_z",
               "p_x", "p_y", "p_z", "v_x", "v_y", "v_z")


class SweepResult(NamedTuple):
    param: str
    values: np.ndarray
    J_opt: np.ndarray       # (n_values,)
    grad_norm: np.ndarray
    converged: np.ndarray
    us: np.ndarray          # (n_values, N, nu)


def _euler_zyx_matrix(th_z, th_y, th_x):
    """Intrinsic z-y-x Euler rotation (degrees), batched."""
    rz, ry, rx = torch.deg2rad(th_z), torch.deg2rad(th_y), torch.deg2rad(th_x)
    z = torch.zeros_like(rz)
    Rz = so3.exp(torch.stack([z, z, rz], dim=-1))
    Ry = so3.exp(torch.stack([z, ry, z], dim=-1))
    Rx = so3.exp(torch.stack([rx, z, z], dim=-1))
    return Rz @ Ry @ Rx


def build_x0_batch(param: str, values, base_q0, base_xi0):
    """Batch of initial states perturbing one parameter (others at base):
    (q0s (B, 4, 4), xi0s (B, 6)) in ``base_q0``'s dtype and on its device
    when it is a tensor, else in float64 on the card."""
    if isinstance(base_q0, torch.Tensor):
        kw = dict(dtype=base_q0.dtype, device=base_q0.device)
    else:
        kw = dict(dtype=torch.float64, device=torch.device("cuda"))
    values = torch.as_tensor(values).to(**kw)
    B = values.shape[0]
    q0 = torch.as_tensor(base_q0).to(**kw).expand(B, 4, 4)
    xi0 = torch.as_tensor(base_xi0).to(**kw).expand(B, 6).clone()
    if param.startswith("th_"):
        zeros = torch.zeros_like(values)
        ang = {a: zeros for a in ("th_z", "th_y", "th_x")}
        ang[param] = values
        R = _euler_zyx_matrix(ang["th_z"], ang["th_y"], ang["th_x"])
        q0 = se3.from_rotation_translation(R, se3.translation(q0))
    else:
        idx = {"w_x": 0, "w_y": 1, "w_z": 2, "v_x": 3, "v_y": 4, "v_z": 5}
        if param in idx:
            xi0[:, idx[param]] = values
        elif param in ("p_x", "p_y", "p_z"):
            p = se3.translation(q0).clone()
            p[:, {"p_x": 0, "p_y": 1, "p_z": 2}[param]] = values
            q0 = se3.from_rotation_translation(se3.rotation(q0), p)
        else:
            raise ValueError(param)
    return q0.contiguous(), xi0


def run_sweep(batch_solver: BatchSolver, params, parameter_ranges: Dict,
              base_q0, base_xi0, nu=6):
    """Run all parameter sweeps; each range is one batched solve (split
    over the solver's mesh, where it has one)."""
    N = batch_solver.solver.cfg.N
    out = {}
    for name, values in parameter_ranges.items():
        q0s, xi0s = build_x0_batch(name, values, base_q0, base_xi0)
        us0 = torch.zeros((q0s.shape[0], N, nu), dtype=xi0s.dtype, device=xi0s.device)
        st = batch_solver.solve_batch(params, q0s, xi0s, us0)
        J_opt, grad_norm, converged, us = multihost.gather_to_all(
            (st.J_opt, st.grad_norm, st.converged, st.us))
        out[name] = SweepResult(param=name, values=np.asarray(values), J_opt=J_opt,
                                grad_norm=grad_norm, converged=converged, us=us)
    return out


class RolloutSweepResult(NamedTuple):
    param: str
    values: np.ndarray
    qs: np.ndarray   # (n_values, N+1, 4, 4) open-loop poses
    xis: np.ndarray  # (n_values, N+1, 6)


def run_rollout_sweep(dyn, dp, parameter_ranges: Dict, base_q0, base_xi0,
                      N: int, nu: int = 6, mesh=None):
    """Open-loop rollout sweeps (ref `visualization/rollout_all_compute.py`):
    each sweep point rolls the dynamics N steps with zero controls from its
    perturbed initial state.  The reference forks one joblib process per
    point (`rollout_all_compute.py:224`, serial Python time loops inside);
    here each parameter's whole batch is one loop over steps of the model's
    batched step (the JAX package's `lax.scan` with a batched carry).  On a
    ``mesh`` (axis "batch"), each rank rolls out its rows of each range
    (whose size must divide by the mesh size) and every rank gets all."""
    out = {}
    for name, values in parameter_ranges.items():
        q, xi = build_x0_batch(name, values, base_q0, base_xi0)
        if mesh is not None:
            q, xi = (multihost.shard_rows(x, mesh) for x in (q, xi))
        zeros_u = torch.zeros((q.shape[0], nu), dtype=xi.dtype, device=xi.device)
        qs, xis = [q], [xi]
        for i in range(N):
            q, xi = dyn.step(dp, q, xi, zeros_u, i)
            qs.append(q)
            xis.append(xi)
        qs, xis = torch.stack(qs, dim=1), torch.stack(xis, dim=1)
        if mesh is not None:
            qs, xis = multihost.sharded(qs, mesh), multihost.sharded(xis, mesh)
        qs, xis = multihost.gather_to_all((qs, xis))
        out[name] = RolloutSweepResult(param=name, values=np.asarray(values), qs=qs, xis=xis)
    return out
