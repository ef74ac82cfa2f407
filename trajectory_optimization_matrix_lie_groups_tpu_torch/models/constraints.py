"""Inequality constraints g(x, u) <= 0 (counterpart of the JAX
`models/constraints.py`).

A `ConstraintDef` is a namespace of pure functions; the input box
lb <= u <= ub is the one concrete family the reference ships.
"""

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch


class ConstraintDef(NamedTuple):
    constr_size: int
    g: Callable    # (params, q, xi, u, i, terminal) -> (..., c)
    g_x: Callable  # (params, q, xi, u, i, terminal) -> (..., c, nx)
    g_u: Callable  # (params, q, xi, u, i, terminal) -> (..., c, nu)


@dataclasses.dataclass
class InputBoxParams:
    lb: torch.Tensor  # (nu,)
    ub: torch.Tensor  # (nu,)


def _dtype_of(x):
    if isinstance(x, torch.Tensor):
        return x.dtype
    if isinstance(x, (np.ndarray, np.generic)) and np.issubdtype(x.dtype, np.floating):
        return torch.from_numpy(np.zeros(0, x.dtype)).dtype
    return None


def input_box_params(lb, ub, nu, device=None):
    """Bounds broadcast to (nu,).  Tensor and numpy inputs keep their float
    dtype (an f32 program must not pick up f64 bounds); python scalars take
    float64, as the JAX package's default float under x64.  ``device``:
    where the bounds live (default: ``lb``'s if it is a tensor, else the
    CPU)."""
    dts = [d for d in (_dtype_of(lb), _dtype_of(ub)) if d is not None]
    dt = torch.float64 if not dts else (
        dts[0] if len(dts) == 1 else torch.promote_types(*dts))
    if device is None:
        device = lb.device if isinstance(lb, torch.Tensor) else None
    box = lambda b: torch.as_tensor(b, dtype=dt, device=device).broadcast_to((nu,))
    return InputBoxParams(lb=box(lb), ub=box(ub))


def input_box(nx: int, nu: int) -> ConstraintDef:
    """g = [lb - u; u - ub] <= 0; terminal g = 0 (ref traopt_constraints.py:127-133)."""
    c = 2 * nu

    def g(p: InputBoxParams, q, xi, u, i, terminal=False):
        val = torch.cat([p.lb - u, u - p.ub], dim=-1)
        if isinstance(terminal, bool):
            return torch.zeros_like(val) if terminal else val
        return torch.where(terminal, torch.zeros_like(val), val)

    def g_x(p, q, xi, u, i, terminal=False):
        return torch.zeros((*u.shape[:-1], c, nx), dtype=u.dtype, device=u.device)

    def g_u(p, q, xi, u, i, terminal=False):
        eye = torch.eye(nu, dtype=u.dtype, device=u.device)
        J = torch.cat([-eye, eye], dim=0).expand((*u.shape[:-1], c, nu))
        if isinstance(terminal, bool) and terminal:
            return torch.zeros_like(J)
        return J

    return ConstraintDef(constr_size=c, g=g, g_x=g_x, g_u=g_u)
