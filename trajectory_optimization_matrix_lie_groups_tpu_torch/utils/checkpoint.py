"""Solver-state checkpoint/resume (counterpart of the JAX
`utils/checkpoint.py`, which is orbax-backed).

The reference persists only *results* (benchmark pickles, sweep pickles,
`.npy` trajectories — SURVEY §5.4).  Solver states here (`ESState`,
`FastBatchState`, `PipelineState`, AL params, warm-start controls) are
nested containers of tensors, so checkpointing is generic: ``save`` writes
them with `torch.save` as plain nested dicts/lists of CPU tensors, and
``restore`` loads them with ``torch.load(weights_only=True)`` (no pickled
code is run).

    from trajectory_optimization_matrix_lie_groups_tpu_torch.utils import checkpoint
    checkpoint.save(path, {"us": us, "al": al_params, "step": k})
    state = checkpoint.restore(path, template)   # template = like-structured state

Without a template a NamedTuple or dataclass comes back as a dict of its
fields (the JAX restore without ``item`` returns raw nested dicts); with
one, the template's structure is rebuilt around the stored leaves.
"""

import dataclasses
import os

import numpy as np
import torch


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _to_plain(x):
    """Containers as dicts and lists, leaves as CPU tensors or Python
    scalars: what `torch.load(weights_only=True)` reads back."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, np.ndarray) or isinstance(x, np.generic):
        return torch.as_tensor(np.asarray(x))
    if _is_namedtuple(x):
        return {k: _to_plain(v) for k, v in x._asdict().items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _to_plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _to_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_plain(v) for v in x]
    return x


def _like(template, stored):
    """``stored`` (plain containers) rebuilt in ``template``'s structure;
    each tensor leaf is put on the template leaf's device and dtype."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(stored).to(device=template.device, dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return np.asarray(stored.numpy() if isinstance(stored, torch.Tensor) else stored,
                          dtype=template.dtype)
    if _is_namedtuple(template):
        return type(template)(**{k: _like(v, stored[k])
                                 for k, v in template._asdict().items()})
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _like(getattr(template, f.name), stored[f.name])
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _like(v, stored[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(t, s) for t, s in zip(template, stored, strict=True))
    return stored


def save(path: str, state) -> str:
    """Write a checkpoint of ``state`` at ``path`` (written to a temporary
    file beside it, then renamed into place).  Tensors are fetched to the
    host first.  Returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_plain(state), tmp)
    os.replace(tmp, path)
    return path


def restore(path: str, template=None):
    """Load a checkpoint; ``template`` (a like-structured state) restores
    NamedTuple/dataclass structure, devices and dtypes instead of raw
    nested dicts of CPU tensors."""
    stored = torch.load(os.path.abspath(path), weights_only=True)
    return stored if template is None else _like(template, stored)
