"""Process groups, device meshes and data-parallel helpers (port of
vicasplat_tpu/parallel/mesh.py).

JAX lays a 1-D ("data",) mesh over the chips and shards the batch over it;
here one process drives one device, started by `torchrun`, and a
`DeviceMesh` names the process groups. Data parallelism is DDP
(training/step.py), and `shard_params_fsdp` is FSDP2 (`fully_shard`) with
JAX's rule for which leaves shard.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn


def init_distributed(device: str = "cuda", timeout_s: float = 600.0):
    """Join the process group `torchrun` describes in the environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT): NCCL on the card, each process
    on device LOCAL_RANK, or gloo when `device="cpu"`. The counterpart of
    JAX's `initialize_multihost`. Returns (rank, world_size)."""
    if not dist.is_initialized():
        backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def mesh_device_type() -> str:
    """"cuda" under NCCL, "cpu" under gloo."""
    return "cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu"


def make_device_mesh(shape: tuple, names: tuple):
    """A DeviceMesh over the whole world, laid out row-major as `shape`."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} processes, the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(mesh_device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data"):
    """A 1-D (axis_name,) mesh over n_devices processes (default: all)."""
    return make_device_mesh((n_devices or dist.get_world_size(),), (axis_name,))


def mesh_coord(mesh, axis_name):
    """(this rank's index along axis_name, the axis' size); for a tuple of
    axis names, the row-major index over them and their sizes' product."""
    if isinstance(axis_name, tuple):
        i, n = 0, 1
        for a in axis_name:
            ia, na = mesh_coord(mesh, a)
            i, n = i * na + ia, n * na
        return i, n
    return mesh.get_local_rank(axis_name), mesh.size(mesh.mesh_dim_names.index(axis_name))


def mesh_group(mesh):
    """The process group of every rank of a mesh laid over the whole world
    (make_device_mesh's)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} of "
                         f"{dist.get_world_size()} ranks")
    return dist.group.WORLD


@dataclasses.dataclass(frozen=True, eq=False)
class GradSplit:
    """How training/step.make_train_step reduces the gradient of a parameter
    of which each rank keeps a slice (parallel/tp.py, ep.py), set as the
    parameter's `_grad_split`: summed over `reduce` and divided by
    `divisor`; its squares summed over `norm` for the clip's norm. The
    model's other leaves are averaged over `mesh` (the group of the whole
    mesh, `mesh_size` ranks), and a MoE call routes the tokens of
    `tokens` together (None: each rank's own)."""
    reduce: object
    divisor: int
    norm: object
    mesh: object
    mesh_size: int
    tokens: object = None


def mark_split(params, split: GradSplit) -> None:
    for p in params:
        p._grad_split = split


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh, batch, axis_name="data"):
    """Every tensor leaf of a batch tree -> this rank's contiguous slice of
    its leading axis, as JAX's single-host `shard_batch` places it; over
    several axes for a tuple of names (row-major)."""
    i, n = mesh_coord(mesh, axis_name)

    def take(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by {n}")
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]

    return _map(take, batch)


@torch.no_grad()
def replicate(mesh, tree, axis_name: Optional[str] = None):
    """Broadcast a module's parameters and buffers, or every tensor of a
    tree, in place from the first rank of the mesh (of `axis_name`, for a
    mesh of several dimensions). Returns `tree`."""
    group = mesh.get_group(axis_name) if axis_name else mesh.get_group()
    src = dist.get_global_rank(group, 0)
    if isinstance(tree, nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    else:
        tensors = []
        _map(lambda x: tensors.append(x) if isinstance(x, torch.Tensor) else None,
             tree)
    for t in tensors:
        dist.broadcast(t.data, src=src, group=group)
    return tree


def fsdp_placement(shape: tuple, n: int, min_size: int = 2**16) -> Optional[int]:
    """JAX's FSDP rule (`mesh.py:36-57`): the dimension a leaf shards along
    over n ranks, its largest one that n divides, or None (replicated) for a
    leaf under min_size elements or with no such dimension."""
    size = 1
    for s in shape:
        size *= s
    if len(shape) == 0 or size < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % n == 0:
            return d
    return None


def shard_params_fsdp(mesh, model: nn.Module, axis_name: str = "data",
                      min_size: int = 2**16) -> nn.Module:
    """FSDP2 over the mesh's axis: `fully_shard` on the whole model, each
    large leaf a DTensor sharded along the dimension `fsdp_placement`
    picks; small and indivisible leaves stay whole, outside FSDP, and are
    listed in `model.fsdp_replicated` for the train step to average their
    gradients. The model must be entered through its `forward` (as the
    train step does), where FSDP2 gathers the shards."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    sub = mesh[axis_name] if len(mesh.mesh_dim_names) > 1 else mesh
    n = sub.size()
    dims = {p: fsdp_placement(tuple(p.shape), n, min_size)
            for p in model.parameters()}
    ignored = {p for p, d in dims.items() if d is None}
    fully_shard(model, mesh=sub, ignored_params=ignored,
                shard_placement_fn=lambda p: Shard(dims[p]))
    # fully_shard swaps the sharded leaves for new Parameters: list the
    # replicated ones by identity after the swap
    model.fsdp_replicated = [p for p in model.parameters()
                             if not hasattr(p, "device_mesh")]
    model.fsdp_group = sub.get_group()
    return model
