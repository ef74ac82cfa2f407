"""Parameter conversion from the JAX package's containers to the port's.

The JAX package's parameter NamedTuples travel as dicts of numpy arrays,
``{k: np.asarray(v) for k, v in p._asdict().items()}``, so that this module
needs no JAX; the port's containers come back on the given device and dtype.
The tests use this to feed both packages the same problem.
"""

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models.costs import (
    TrackingCostParams,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.dynamics import (
    RigidBodyParams,
    SE3Params,
)

_FLAGS = ("ref_coad_swap", "exact_gravity_jacobian")


def dyn_from_numpy(fields, device=None, dtype=torch.float64):
    """`SE3Params` or, where the fields carry ``g`` and ``Pu``,
    `RigidBodyParams`."""
    kw = {k: (bool(np.asarray(v)) if k in _FLAGS else
              torch.as_tensor(np.array(v), dtype=dtype, device=device))
          for k, v in fields.items()}
    cls = RigidBodyParams if "Pu" in kw else SE3Params
    return cls(**kw)


def cost_from_numpy(fields, device=None, dtype=torch.float64):
    """`TrackingCostParams` from the JAX `TrackingCostParams` fields."""
    return TrackingCostParams(**{
        k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
        for k, v in fields.items()})
