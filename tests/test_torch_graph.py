"""`solvers/graph.py`'s argument signatures, on the CPU: the structure of a
call's arguments (dicts, tuples, NamedTuples, dataclasses, constants) walks
to its tensors and back unchanged, and the solvers that replay their loops
from CUDA graphs on the card run them as they are on CPU tensors (the
replay itself is held against the eager loops on the card,
`tests/test_torch_cuda.py`)."""

import dataclasses
from typing import NamedTuple

import torch

import numpy as np
import pytest

from trajectory_optimization_matrix_lie_groups_tpu_torch.solvers.graph import (
    GraphCache,
    _flatten,
    _unflatten,
    closure_tensors,
)
from trajectory_optimization_matrix_lie_groups_tpu_torch.tasks import cartpole


class _NT(NamedTuple):
    a: torch.Tensor
    b: float


@dataclasses.dataclass
class _DC:
    x: torch.Tensor
    flag: bool


def test_signature_roundtrip():
    t = [torch.randn(2, 3), torch.randn(4), torch.randn(1)]
    args = ({"dyn": _DC(t[0], True), "cost": None}, _NT(t[1], 2.5), [t[2], "s"], 3)
    leaves = []
    spec = _flatten(args, leaves)
    assert len(leaves) == 3 and all(a is b for a, b in zip(leaves, t))
    back = _unflatten(spec, [x.clone() for x in leaves])
    assert isinstance(back[0]["dyn"], _DC) and back[0]["dyn"].flag is True
    assert back[0]["cost"] is None and isinstance(back[1], _NT) and back[1].b == 2.5
    assert back[2][1] == "s" and back[3] == 3
    torch.testing.assert_close(back[1].a, t[1], rtol=0, atol=0)
    # a constant is part of the signature
    other = []
    assert repr(_flatten(({"dyn": _DC(t[0], False), "cost": None},) + args[1:], other)) \
        != repr(spec)


def test_solvers_run_their_loops_eagerly_on_the_cpu():
    solver = cartpole.build(N=12, device="cpu")
    x0 = torch.tensor([[9.0, 0.0, 0.0, 0.0]], dtype=torch.float64)
    xs, us, J, g, st = solver.fit(x0, torch.zeros((1, 12, 1), dtype=torch.float64),
                                  n_iterations=3)
    assert 1 <= len(J) <= 3 and isinstance(solver._graphs, GraphCache)
    assert not solver._graphs._entries


class _Holder:
    def __init__(self):
        self.w = torch.ones(3)

    def f(self, x):
        return x * self.w


def test_signature_keys_closure_tensors_by_identity():
    """A tensor the function reads from its closure is part of the
    signature: changed in place the key stays (the graph reads its memory),
    replaced by another tensor the key changes (a new capture)."""
    h, x = _Holder(), torch.zeros(3)
    key = GraphCache.signature("f", h.f, (x,))[0]
    h.w.mul_(2.0)
    assert GraphCache.signature("f", h.f, (x,))[0] == key
    h.w = torch.ones(3)
    assert GraphCache.signature("f", h.f, (x,))[0] != key


def test_signature_refuses_values_it_cannot_key():
    """Only tensors, containers of them and scalars may be arguments: a
    numpy array's repr is shortened, so two arrays could share a key."""
    with pytest.raises(TypeError, match="ndarray"):
        GraphCache.signature("f", lambda a: a, (np.zeros(2000),))


def test_solver_closures_hold_the_model_constants():
    """The cartpole's goal and weights reach `ILQR` only through its model's
    closures: the walk finds them from the bound loop."""
    solver = cartpole.build(N=12, device="cpu")
    shapes = sorted(tuple(t.shape) for t in closure_tensors(solver._backward_loop))
    assert shapes == [(4,), (4, 4)]
