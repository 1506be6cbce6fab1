"""Expert parallelism for the MoE decoder MLPs (port of
vicasplat_tpu/parallel/ep.py).

On a ("data", "expert") mesh each rank holds E / n_expert of every MoE
layer's experts (rank r of the "expert" axis: experts [r E/n, (r+1) E/n)),
the router whole. `models/moe.moe_mlp` then sends each expert's slot rows
to its owner by all_to_all and brings the outputs back by the reverse
all_to_all; capacity and seat order are computed over every rank's tokens,
as JAX computes them over the whole call. Each rank passes its own slice of
the batch over every rank (`shard_batch(mesh, batch, ("data", "expert"))`).

Training (training/step.make_train_step on a model after shard_params_ep):
an expert's gradient comes back to its owner through the all_to_alls'
backward, summed over the ranks whose tokens it served; the step sums it
over "data" and divides by the world size, averages every replicated leaf
(the router included) over the world, and counts each expert once in the
clip's norm.
"""
from __future__ import annotations

import torch
from torch import nn

from .comm import group_of
from .mesh import GradSplit, make_device_mesh, mark_split, mesh_coord, mesh_group


def make_mesh_ep(n_data: int, n_expert: int):
    """A ("data", "expert") mesh: batch over "data", experts over
    "expert"."""
    return make_device_mesh((n_data, n_expert), ("data", "expert"))


def shard_params_ep(mesh, model: nn.Module) -> nn.Module:
    """Keep this rank's experts of every MoE layer (along the expert axis,
    the leading one of the port's (E, d_in, d_out) and (E, d_out) leaves)
    and set the layer's `ep_group`. A layer whose E the axis does not divide
    stays whole, as JAX replicates it. Marks the experts' parameters kept
    for training/step.make_train_step (a mesh.GradSplit)."""
    from ..models.moe import MoeMlp

    group = group_of(mesh, "expert")
    r, n = mesh_coord(mesh, "expert")
    sharded = []
    for mod in model.modules():
        if not isinstance(mod, MoeMlp) or mod.n_experts % n:
            continue
        m = mod.n_experts // n
        with torch.no_grad():
            for lin in (mod.experts.fc1, mod.experts.fc2):
                lin.w = nn.Parameter(lin.w[r * m:(r + 1) * m].contiguous())
                lin.b = nn.Parameter(lin.b[r * m:(r + 1) * m].contiguous())
                sharded += [lin.w, lin.b]
        mod.ep_group = group
    world = mesh_group(mesh)  # capacity over every rank's tokens
    mark_split(sharded, GradSplit(reduce=group_of(mesh, "data"), divisor=mesh.size(),
                                  norm=group, mesh=world, mesh_size=mesh.size(),
                                  tokens=world))
    return model
