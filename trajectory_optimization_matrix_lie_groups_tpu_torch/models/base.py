"""Model container wiring dynamics + cost into one namespace (counterpart of
the JAX `models/base.py`).

The roles of the reference's `dynamics`/`cost` objects are pure functions
over an explicit ``params`` dict, so a solver takes new references or
weights without rebuilding the model.

State convention for Lie models: ``(q, xi)`` with ``q`` a group matrix
(3x3 for SO(3), 4x4 for SE(3)) and ``xi`` the body twist ``[omega, v]``.
All callables broadcast over leading batch dimensions.
"""

from typing import Any, Callable, NamedTuple

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops.group import Group


class LieModel(NamedTuple):
    """Static bundle of model callables (params explicit).

    Callable signatures (``p`` is the params dict, ``i`` the stage index):
      step:       (p, q, xi, u, i) -> (q_next, xi_next)
      jac:        (p, q, xi, u, i) -> (Fx [nx,nx], Fu [nx,nu])
      stage_quad: (p, q, xi, u, i) -> (l, lx, lu, lxx, lux, luu)
      term_quad:  (p, q, xi, i)    -> (l, lx, lxx)
      stage_cost: (p, q, xi, u, i) -> l
      term_cost:  (p, q, xi, i)    -> l
    """

    group: Group
    nx: int
    nu: int
    step: Callable
    jac: Callable
    stage_cost: Callable
    term_cost: Callable
    stage_quad: Callable
    term_quad: Callable


class DynamicsDef(NamedTuple):
    """A dynamics family: pure step + analytic tangent-space Jacobians."""

    group: Group
    nx: int
    nu: int
    step: Callable  # (dyn_params, q, xi, u, i) -> (q_next, xi_next)
    jac: Callable   # (dyn_params, q, xi, u, i) -> (Fx, Fu)


class CostDef(NamedTuple):
    """A cost family: scalar evaluation + Gauss-Newton quadratization."""

    nx: int
    nu: int
    stage_cost: Callable  # (cost_params, q, xi, u, i) -> l
    term_cost: Callable   # (cost_params, q, xi, i) -> l
    stage_quad: Callable  # (cost_params, q, xi, u, i) -> (l, lx, lu, lxx, lux, luu)
    term_quad: Callable   # (cost_params, q, xi, i) -> (l, lx, lxx)


def make_model(dyn: DynamicsDef, cost: CostDef, dyn_params: Any, cost_params: Any):
    """Assemble a LieModel and its combined params dict."""
    if dyn.nu != cost.nu or dyn.nx != cost.nx:
        raise ValueError(
            f"dynamics ({dyn.nx},{dyn.nu}) and cost ({cost.nx},{cost.nu}) disagree"
        )

    model = LieModel(
        group=dyn.group,
        nx=dyn.nx,
        nu=dyn.nu,
        step=lambda p, q, xi, u, i: dyn.step(p["dyn"], q, xi, u, i),
        jac=lambda p, q, xi, u, i: dyn.jac(p["dyn"], q, xi, u, i),
        stage_cost=lambda p, q, xi, u, i: cost.stage_cost(p["cost"], q, xi, u, i),
        term_cost=lambda p, q, xi, i: cost.term_cost(p["cost"], q, xi, i),
        stage_quad=lambda p, q, xi, u, i: cost.stage_quad(p["cost"], q, xi, u, i),
        term_quad=lambda p, q, xi, i: cost.term_quad(p["cost"], q, xi, i),
    )
    params = {"dyn": dyn_params, "cost": cost_params}
    return model, params
