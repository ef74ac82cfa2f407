"""Reference-trajectory and benchmark-artifact IO, and reference
trajectories by twist integration (counterpart of the JAX
`utils/trajectories.py`).

Keeps the reference's on-disk formats, so that this module and the JAX
package read each other's files:

- `.npy` triples ``(q_ref, xi_ref, dt)`` written back-to-back into one file
  (format defined by `visualization/convert_path_to_reference.ipynb`, read
  as in `benchmark_SE3_tracking.py:164-168`);
- benchmark result pickles with a `prob` dict carrying the full problem spec
  (J, dt, q_ref, xi_ref, x0, Q, P, R) plus per-solver solutions/histories
  (writer: `benchmark_SE3_tracking.py:272-345`).

Files hold numpy arrays: tensors are written as numpy (from any device),
and the loaders return numpy, as the JAX loaders do.
"""

import pickle

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3, so3


def _np(v):
    """A tensor or array-like as a numpy array (tensors from any device)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def load_reference_triple(path):
    """Load (q_ref, xi_ref, dt) from a reference .npy file (numpy arrays and
    a float)."""
    with open(path, "rb") as f:
        q_ref = np.load(f)
        xi_ref = np.load(f)
        dt = np.load(f)
    return q_ref, xi_ref, float(dt)


def save_reference_triple(path, q_ref, xi_ref, dt):
    with open(path, "wb") as f:
        np.save(f, _np(q_ref))
        np.save(f, _np(xi_ref))
        np.save(f, _np(dt))


def load_benchmark_pickle(path):
    """Load a reference benchmark results pickle (problem spec + solutions)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_benchmark_pickle(path, prob, solvers):
    """Write a benchmark results pickle in the REFERENCE's schema
    (`benchmark_SE3_tracking.py:272-345`): a dict with a 'prob' entry
    (problem spec: J, dt, q_ref, xi_ref, x0, Q, P, R) and one entry per
    solver holding (xs, us, J_hist, grad_hist[, defect_hist]).

    ``prob``: mapping with the spec keys (tensors and arrays converted to
    numpy).  ``solvers``: {name: {xs|qs/xis, us, J_hist, grad_hist,
    defect_hist?}}.  The Lie solvers' state is stored as {'qs': (N+1,m,m),
    'xis': (N+1,d)} under 'xs', as the JAX writer stores it.
    """
    def conv(v):
        if hasattr(v, "shape"):
            return _np(v)
        if isinstance(v, (list, tuple)):
            return type(v)(conv(e) for e in v)
        if isinstance(v, dict):
            return {k: conv(e) for k, e in v.items()}
        return v

    data = {"prob": {k: conv(v) for k, v in prob.items()}}
    for name, rec in solvers.items():
        data[name] = {k: conv(v) for k, v in rec.items()}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def generate_reference(q0, xi_of_i, N, dt):
    """q_{i+1} = normalize(q_i Exp(xi_i dt)).

    Args:
      q0: (4, 4) or (3, 3) initial pose tensor.
      xi_of_i: callable i -> twist tensor, or a constant twist tensor.
      N: number of steps (returns N+1 poses).
      dt: step.

    Returns (q_ref (N+1, m, m), xi_ref (N+1, d)) in ``q0``'s dtype and device.
    """
    group = se3 if q0.shape[-1] == 4 else so3
    xis = [torch.as_tensor(xi_of_i(i) if callable(xi_of_i) else xi_of_i,
                           dtype=q0.dtype, device=q0.device)
           for i in range(N + 1)]
    qs = [q0]
    for i in range(N):
        qs.append(group.normalize(qs[-1] @ group.exp(xis[i] * dt)))
    return torch.stack(qs), torch.stack(xis)
