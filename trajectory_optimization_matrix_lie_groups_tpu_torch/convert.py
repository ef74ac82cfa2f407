"""Parameter conversion from the JAX package's containers to the port's.

The JAX package's parameter NamedTuples travel as dicts of numpy arrays,
``{k: np.asarray(v) for k, v in p._asdict().items()}``, so that this module
needs no JAX; the port's containers come back on the given device and dtype.
The tests use this to feed both packages the same problem, and to carry
the augmented-Lagrangian state (`ALParams`, the multipliers of an
`ALPipelineResult` or an `ALResult`), a `LieILQR` solver state, an
anchored problem or an SE(3) tracking problem (the toy problem of
`tasks/toy.py` among them) across, so that the two engines start from the
same state.
"""

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.models.constraints import (
    InputBoxParams,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.costs import (
    ALParams,
    TrackingCostParams,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.models.dynamics import (
    Pendulum3dParams,
    RigidBodyParams,
    SE3Params,
    SO3Params,
)

_FLAGS = ("ref_coad_swap", "exact_gravity_jacobian")


def dyn_from_numpy(fields, device=None, dtype=torch.float64):
    """The port's container of the JAX dynamics params whose fields these
    are: `RigidBodyParams` (fields with ``Pu``), `SE3Params` (``Ib``),
    `Pendulum3dParams` (``l``) or `SO3Params` (J, Jinv, dt)."""
    kw = {k: (bool(np.asarray(v)) if k in _FLAGS else
              torch.as_tensor(np.array(v), dtype=dtype, device=device))
          for k, v in fields.items()}
    cls = (RigidBodyParams if "Pu" in kw else SE3Params if "Ib" in kw
           else Pendulum3dParams if "l" in kw else SO3Params)
    return cls(**kw)


def cost_from_numpy(fields, device=None, dtype=torch.float64):
    """`TrackingCostParams` from the JAX `TrackingCostParams` fields."""
    return TrackingCostParams(**{
        k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
        for k, v in fields.items()})


def lane_state_from_numpy(qR, qp, xi, us, device=None):
    """A lane-layout trajectory qR (N+1, 3, 3, B), qp (N+1, 3, B),
    xi (N+1, 6, B), us (N, nu, B) given as numpy arrays (the f32 handoff
    that the JAX `DFPipelineSolver._f32_jit` returns) as tensors on
    ``device``, dtype kept: `MixedDFPipelineSolver.polish` takes them."""
    return tuple(torch.as_tensor(np.array(x), device=device)
                 for x in (qR, qp, xi, us))


def _tensor(x, device, dtype=None):
    """``x`` as a tensor on ``device``; numpy's dtype kept unless ``dtype``."""
    return torch.as_tensor(np.array(x), device=device).to(
        **({} if dtype is None else {"dtype": dtype}))


def input_box_from_numpy(fields, device=None, dtype=None):
    """`InputBoxParams` from the JAX `InputBoxParams` fields (lb, ub); the
    bounds' dtype kept unless ``dtype`` is given."""
    return InputBoxParams(lb=_tensor(fields["lb"], device, dtype),
                          ub=_tensor(fields["ub"], device, dtype))


def al_params_from_numpy(fields, device=None, dtype=None):
    """`ALParams` from the fields of a JAX `ALParams`: ``cost`` and
    ``constr`` as dicts of their fields, ``lmbd``, ``Imu`` and ``mu`` as
    arrays.  Each array keeps its dtype unless ``dtype`` is given."""
    cost_dt = dtype if dtype is not None else torch.as_tensor(
        np.array(fields["cost"]["Q1"])).dtype
    return ALParams(
        cost=cost_from_numpy(fields["cost"], device=device, dtype=cost_dt),
        constr=input_box_from_numpy(fields["constr"], device, dtype),
        lmbd=_tensor(fields["lmbd"], device, dtype),
        Imu=_tensor(fields["Imu"], device, dtype),
        mu=_tensor(fields["mu"], device, dtype))


def al_pipeline_result_from_numpy(fields, device=None):
    """The port's `ALPipelineResult` from the fields of a JAX one
    (``res._asdict()``, arrays as numpy), every array's dtype kept: the
    state the polishes (`al_polish`, `al_polish_device`) start from."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_pipeline import (
        ALPipelineResult,
    )

    arrays = ("qs", "xis", "us", "J_opt", "lmbd", "max_violation", "imu")
    return ALPipelineResult(**{
        k: (_tensor(v, device) if k in arrays and v is not None else v)
        for k, v in fields.items()})


def _batched(x, device, dims):
    """``x`` as a tensor with a leading problem axis: added when ``x`` has
    ``dims`` dimensions (a single problem's leaf)."""
    t = _tensor(x, device)
    return t[None] if t.dim() == dims else t


def lie_state_from_numpy(fields, device=None):
    """The port's `LieILQR` `SolverState` from the fields of a JAX one
    (``state._asdict()``, arrays as numpy), a single problem's (given a
    leading axis of 1) or a vmapped batch's; every dtype kept."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.lie_ilqr import (
        SolverState,
    )

    dims = dict(qs=3, xis=2, us=2, k=2, K=3)
    return SolverState(**{k: _batched(v, device, dims.get(k, 0))
                          for k, v in fields.items()})


def anchored_from_numpy(fields, device=None):
    """The port's `AnchoredProblem` from the fields of a JAX one
    (``prob._asdict()`` with ``dyn`` as the dict of its `SE3Params`
    fields), every dtype kept."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.anchored import (
        AnchoredProblem,
    )

    dt = torch.as_tensor(np.array(fields["T"])).dtype
    return AnchoredProblem(
        dyn=dyn_from_numpy(fields["dyn"], device=device, dtype=dt),
        **{k: _tensor(v, device) for k, v in fields.items() if k != "dyn"})


def al_result_from_numpy(fields, device=None):
    """The port's `ALResult` from the fields of a JAX one (``res._asdict()``,
    ``al_params`` as the dict `al_params_from_numpy` takes), a single
    problem's arrays given a leading axis of 1."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.al_ilqr import (
        ALResult,
    )

    dims = dict(qs=3, xis=2, us=2, constr_eval=2)
    return ALResult(**{
        k: (al_params_from_numpy(v, device) if k == "al_params" else
            _batched(v, device, dims[k]) if k in dims else v)
        for k, v in fields.items()})


def cartpole_from_numpy(N, dt, x_goal=None, hessians=False, device=None,
                        dtype=torch.float64):
    """The port's cartpole `ILQR` (`tasks/cartpole.build`) with the JAX
    task's parameters: horizon N, step dt and the goal state ``x_goal``
    (numpy, default the reference's [10, 0, pi, 0]), on ``device``."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import cartpole

    goal = None if x_goal is None else torch.as_tensor(np.array(x_goal))
    return cartpole.build(N=N, dt=dt, x_goal=goal, hessians=hessians, dtype=dtype,
                          device=torch.device("cpu") if device is None else device)


def errorstate_params_from_numpy(fields, device=None):
    """The port's `ErrorStateParams` from the fields of a JAX one
    (``p._asdict()``, arrays as numpy), every dtype kept."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.errorstate import (
        ErrorStateParams,
    )

    return ErrorStateParams(**{k: _tensor(v, device) for k, v in fields.items()})


def es_tracking_cost_from_numpy(fields, device=None):
    """The port's `ErrorStateTrackingCostParams` from the fields of a JAX
    one, every dtype kept."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.errorstate import (
        ErrorStateTrackingCostParams,
    )

    return ErrorStateTrackingCostParams(**{k: _tensor(v, device) for k, v in fields.items()})


def es_goal_cost_from_numpy(fields, device=None):
    """The port's `ErrorStateGoalCostParams` from the fields of a JAX one,
    every dtype kept."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.errorstate import (
        ErrorStateGoalCostParams,
    )

    return ErrorStateGoalCostParams(**{k: _tensor(v, device) for k, v in fields.items()})


def es_state_from_numpy(fields, device=None):
    """The port's `ESState` from the fields of a JAX one (``state._asdict()``
    with ``params`` as the dict of its `ErrorStateParams` fields, arrays as
    numpy), every dtype kept: the state `ErrorStateILQR._iteration` steps."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.errorstate_ilqr import (
        ESState,
    )

    return ESState(**{
        k: (errorstate_params_from_numpy(v, device) if k == "params" else _tensor(v, device))
        for k, v in fields.items()})


def se3_tracking_from_numpy(dyn_fields, cost_fields, device=None, dtype=torch.float64):
    """The port's SE(3) free-body tracking ``(model, params)`` (`make_model`
    of `se3_dynamics` and `tracking_cost(SE3, 6)`) from the fields of the
    JAX problem's `SE3Params` and `TrackingCostParams` (q_ref and xi_ref
    among them)."""
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models import costs, dynamics
    from trajectory_optimization_matrix_lie_groups_tpu_torch.models.base import make_model
    from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import SE3

    return make_model(dynamics.se3_dynamics(), costs.tracking_cost(SE3, 6),
                      dyn_from_numpy(dyn_fields, device, dtype),
                      cost_from_numpy(cost_fields, device, dtype))


def toy_from_numpy(dyn_fields, cost_fields, q0, xi0, device=None, dtype=torch.float64):
    """The tuple of `tasks/toy.toy_problem` (model, params, q0, xi0, q_ref,
    xi_path, N) from the JAX package's build of the toy problem: its params'
    fields and its start."""
    model, params = se3_tracking_from_numpy(dyn_fields, cost_fields, device, dtype)
    cp = params["cost"]
    t = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)
    return model, params, t(q0), t(xi0), cp.q_ref, cp.xi_ref, cp.q_ref.shape[0] - 1
