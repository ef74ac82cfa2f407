"""The multi-process runtime (counterpart of the JAX `parallel/multihost.py`).

JAX runs one program over many devices: `jax.distributed` joins the hosts,
a `Mesh` lists the devices and a `NamedSharding(P(axis))` global array
keeps one block of rows on each.  PyTorch's idiom is one process per
device.  Here:

  - a `torch.distributed` process group joins the processes: NCCL on the
    card (each process on its own card), gloo on the CPU;
  - `torch.distributed.device_mesh.DeviceMesh` over the group's ranks takes
    the place of the `Mesh`;
  - a `DTensor` sharded `Shard(0)` takes the place of the global array:
    each rank holds its contiguous rows.

A mesh constructor called in a process that belongs to no group joins a
one-process group on the caller's device (the card unless the caller names
the CPU): the counterpart of JAX's one-device mesh, so that a plain
``python -m ...tasks.run sweep`` builds its batch mesh as the JAX CLI does.
Under ``torchrun --nproc-per-node=K`` (or after `initialize_multihost` in
each process) the mesh spans every rank.

Usage (the same program in every process):

    from trajectory_optimization_matrix_lie_groups_tpu_torch import parallel
    parallel.initialize_multihost("10.0.0.1:29500", num_processes, process_id)
    mesh = parallel.global_batch_mesh()
    q0s = parallel.distribute_batch(local_q0s, mesh)       # this rank's rows
    solver = parallel.make_sharded_pipeline(..., mesh=mesh)
    out = solver.solve(dyn, cost, q0s, xi0s, us0)          # sharded results
    us = parallel.gather_to_all(out.us)                    # the global batch

Problems are independent, so the only traffic is the results' gather.
"""

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the mesh device's backend
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(device):
    """'cuda' or 'cpu' for a device (the card when None)."""
    kind = torch.device("cuda" if device is None else device).type
    if kind not in _BACKENDS:
        raise ValueError(f"a mesh runs on 'cuda' or 'cpu', not {kind!r}")
    return kind


def initialize_multihost(coordinator_address: str, num_processes: int, process_id: int,
                         local_device_ids: Optional[Sequence[int]] = None, device=None):
    """Join the process group of ``num_processes`` processes that meet at
    ``coordinator_address`` ("host:port", rank 0's host), as rank
    ``process_id`` (idempotent per process).

    On the card (``device`` None or 'cuda'), this process takes card
    ``local_device_ids[0]`` (one card a process; default: ``process_id``
    modulo the cards of this host) before any NCCL call, and the group runs
    NCCL; with ``device='cpu'`` it runs gloo."""
    kind = _device_type(device)
    if dist.is_initialized():
        return
    if kind == "cuda":
        if local_device_ids is not None and len(local_device_ids) != 1:
            raise ValueError("one card a process: pass one local device id, "
                             f"not {list(local_device_ids)}")
        idx = (local_device_ids[0] if local_device_ids is not None
               else process_id % torch.cuda.device_count())
        torch.cuda.set_device(idx)
    dist.init_process_group(_BACKENDS[kind], init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _join_group(device=None):
    """The device type ('cuda' or 'cpu') of this process's group.  A process
    in no group first joins one: under ``torchrun`` (``WORLD_SIZE`` set) the
    job's group over ``env://``, on card ``LOCAL_RANK`` unless ``device`` is
    the CPU; else a one-process group on ``device`` (the card unless 'cpu'),
    kept in memory: no address, no port.  Raises `ValueError` when the group
    runs on another device type than ``device`` names."""
    if not dist.is_initialized():
        kind = _device_type(device)
        if "WORLD_SIZE" in os.environ:
            if kind == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(_BACKENDS[kind], init_method="env://")
        else:
            if kind == "cuda" and device is not None and torch.device(device).index is not None:
                torch.cuda.set_device(torch.device(device))
            dist.init_process_group(_BACKENDS[kind], store=dist.HashStore(), rank=0,
                                    world_size=1)
    kind = "cuda" if "nccl" in dist.get_backend() else "cpu"
    if device is not None and _device_type(device) != kind:
        raise ValueError(f"this process's group runs on {kind!r} "
                         f"({dist.get_backend()}), not on {_device_type(device)!r}")
    return kind


def world_mesh(axis: str, n_devices: Optional[int] = None, device=None):
    """A 1-d `DeviceMesh` named ``axis`` over every rank of the group (joined
    first, `_join_group`).  One process drives one device, so ``n_devices``,
    where given, must be the group's size."""
    from torch.distributed.device_mesh import DeviceMesh

    kind = _join_group(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} processes (one a "
                         f"device, e.g. torchrun --nproc-per-node={n_devices}); this group "
                         f"has {world}")
    return DeviceMesh(kind, list(range(world)), mesh_dim_names=(axis,))


def global_batch_mesh(axis: str = "batch", device=None):
    """1-d mesh over every process of the job (all hosts), in rank order:
    each host's processes are contiguous (torchrun numbers them so), so a
    batch sharded over it keeps each problem's rows on one host."""
    return world_mesh(axis, device=device)


def mesh_device(mesh):
    """The device this rank computes on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def check_device(mesh, x):
    """Raise `ValueError` unless tensor ``x`` lies on ``mesh``'s device type."""
    if mesh.device_type != x.device.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the tensor on "
                         f"{x.device.type!r}")


def mesh_rank(mesh, axis: str):
    """(this rank's index on ``axis``, the axis's size, its process group)."""
    group = mesh.get_group(axis)
    return dist.get_rank(group), dist.get_world_size(group), group


def all_gather_rows(x, group):
    """Every rank's ``x`` (the same shape on each) concatenated along dim 0,
    in rank order, on every rank: one collective on ``group``."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def distribute_batch(local_batch, mesh, axis: str = "batch"):
    """The global batch from each process's local rows: every process passes
    its own (B_local, ...) block; the result is a (num_processes * B_local,
    ...) `DTensor` sharded `Shard(0)` over ``axis``, no rows copied between
    processes."""
    from torch.distributed.tensor import DTensor, Shard

    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
    return DTensor.from_local(torch.as_tensor(local_batch).to(mesh_device(mesh)), mesh,
                              [Shard(0)])


def gather_to_all(x):
    """A (possibly sharded) tensor, or a tuple, NamedTuple or dict of them,
    all-gathered to every process as numpy: result collection only, the one
    collective of the workflow."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, dict):
        return {k: gather_to_all(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(gather_to_all(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(gather_to_all(v) for v in x)
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def shard_rows(x, mesh, axis: str = "batch"):
    """This rank's rows of a batch: a `DTensor` sharded `Shard(0)` on
    ``mesh`` gives its local block; a whole batch (a tensor or array, the
    same on every rank) its contiguous block of B / n rows.  On the rank's
    device.  Raises `ValueError` when B does not divide by the axis size or
    a tensor lies on another device type than the mesh."""
    from torch.distributed.tensor import DTensor, Shard

    r, n, _ = mesh_rank(mesh, axis)
    if isinstance(x, DTensor):
        if x.device_mesh != mesh or tuple(x.placements) != (Shard(0),):
            raise ValueError("a sharded input must be Shard(0) on the solver's mesh")
        return x.to_local()
    if isinstance(x, torch.Tensor):
        check_device(mesh, x)
    x = torch.as_tensor(x)
    B = x.shape[0]
    if B % n:
        raise ValueError(f"batch {B} not divisible by mesh size {n}")
    b = B // n
    return x[r * b:(r + 1) * b].to(mesh_device(mesh))


def sharded(local, mesh):
    """This rank's rows as its block of a global batch (`DTensor`,
    `Shard(0)`), or each tensor field of a tuple/NamedTuple so."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(local, tuple) and hasattr(local, "_fields"):
        return type(local)(*(sharded(v, mesh) for v in local))
    return DTensor.from_local(local.contiguous(), mesh, [Shard(0)])
