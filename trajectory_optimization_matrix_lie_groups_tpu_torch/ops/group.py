"""Uniform group interface, so problem setup is generic over SO(3)/SE(3)
(counterpart of the JAX `ops/group.py`)."""

import dataclasses
from typing import Callable

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3 as _se3
from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import so3 as _so3


@dataclasses.dataclass(frozen=True)
class Group:
    """Namespace of batched group functions."""

    name: str
    dim: int          # tangent dimension (3 / 6)
    mat: int          # matrix size (3 / 4)
    exp: Callable
    log: Callable
    inverse: Callable
    compose: Callable
    Ad: Callable
    ad: Callable
    Jl: Callable
    Jr: Callable
    Jl_inv: Callable
    Jr_inv: Callable
    rplus: Callable
    rminus: Callable
    lminus: Callable
    normalize: Callable


SO3 = Group(
    name="SO3", dim=3, mat=3,
    exp=_so3.exp, log=_so3.log, inverse=_so3.inverse, compose=_so3.compose,
    Ad=_so3.Ad, ad=_so3.ad,
    Jl=_so3.left_jacobian, Jr=_so3.right_jacobian,
    Jl_inv=_so3.left_jacobian_inv, Jr_inv=_so3.right_jacobian_inv,
    rplus=_so3.rplus, rminus=_so3.rminus, lminus=_so3.lminus,
    normalize=_so3.normalize,
)

SE3 = Group(
    name="SE3", dim=6, mat=4,
    exp=_se3.exp, log=_se3.log, inverse=_se3.inverse, compose=_se3.compose,
    Ad=_se3.Ad, ad=_se3.ad,
    Jl=_se3.left_jacobian, Jr=_se3.right_jacobian,
    Jl_inv=_se3.left_jacobian_inv, Jr_inv=_se3.right_jacobian_inv,
    rplus=_se3.rplus, rminus=_se3.rminus, lminus=_se3.lminus,
    normalize=_se3.normalize,
)
