"""Autodiff-derived dynamics and costs for Euclidean-state problems
(counterpart of the JAX `models/autodiff.py`).

Replaces the reference's `AutoDiffDynamics` (traopt_dynamics.py:133-273)
and `AutoDiffCost` (traopt_cost.py:113-274): the user supplies a discrete
step ``f(x, u, i)`` and scalar costs ``l(x, u, i)`` / ``l_terminal(x, i)``
as per-sample torch functions; their Jacobians and Hessians come from
`torch.func` (`jacfwd`, `grad`, `hessian`), and the solver (`solvers/
ilqr.py`) maps them over stages and problems with `torch.func.vmap`.
"""

from typing import Callable, NamedTuple

from torch.func import grad, hessian, jacfwd


class EuclideanModel(NamedTuple):
    """Vector-state model bundle for the Euclidean iLQR/DDP solver.

    All callables take one sample (the solver vmaps them):
      step:       (x, u, i) -> x_next
      jac:        (x, u, i) -> (fx, fu)
      hess:       (x, u, i) -> (fxx, fux, fuu)
      stage_quad: (x, u, i) -> (l, lx, lu, lxx, lux, luu)
      term_quad:  (x, i)    -> (l, lx, lxx)
    """

    nx: int
    nu: int
    step: Callable
    jac: Callable
    hess: Callable
    stage_cost: Callable
    term_cost: Callable
    stage_quad: Callable
    term_quad: Callable
    has_hessians: bool


def autodiff_model(f, l, l_terminal, state_size, action_size, hessians=False):
    """An `EuclideanModel` from the user's f, l and l_terminal (torch
    functions of one sample)."""

    def jac(x, u, i):
        return jacfwd(f, argnums=0)(x, u, i), jacfwd(f, argnums=1)(x, u, i)

    def hess(x, u, i):
        fxx = jacfwd(jacfwd(f, argnums=0), argnums=0)(x, u, i)
        fux = jacfwd(jacfwd(f, argnums=1), argnums=0)(x, u, i)
        fuu = jacfwd(jacfwd(f, argnums=1), argnums=1)(x, u, i)
        return fxx, fux, fuu

    def stage_quad(x, u, i):
        return (l(x, u, i), grad(l, argnums=0)(x, u, i), grad(l, argnums=1)(x, u, i),
                hessian(l, argnums=0)(x, u, i),
                jacfwd(grad(l, argnums=1), argnums=0)(x, u, i),
                hessian(l, argnums=1)(x, u, i))

    def term_quad(x, i):
        return (l_terminal(x, i), grad(l_terminal, argnums=0)(x, i),
                hessian(l_terminal, argnums=0)(x, i))

    return EuclideanModel(
        nx=state_size, nu=action_size, step=f, jac=jac, hess=hess,
        stage_cost=l, term_cost=l_terminal, stage_quad=stage_quad,
        term_quad=term_quad, has_hessians=hessians)


def rk4(fc, dt):
    """RK4 discretization of a continuous f(x, u) (ref main_ddp.py:58-66)."""

    def step(x, u, i):
        del i
        s1 = fc(x, u)
        s2 = fc(x + dt / 2 * s1, u)
        s3 = fc(x + dt / 2 * s2, u)
        s4 = fc(x + dt * s3, u)
        return x + dt / 6 * (s1 + 2 * s2 + 2 * s3 + s4)

    return step
