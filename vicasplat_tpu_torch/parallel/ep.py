"""Expert parallelism for the MoE decoder MLPs (port of
vicasplat_tpu/parallel/ep.py).

On a ("data", "expert") mesh each rank holds E / n_expert of every MoE
layer's experts (rank r of the "expert" axis: experts [r E/n, (r+1) E/n)),
the router whole. `models/moe.moe_mlp` then sends each expert's slot rows
to its owner by all_to_all and brings the outputs back by the reverse
all_to_all; capacity and seat order are computed over every rank's tokens,
as JAX computes them over the whole call.
"""
from __future__ import annotations

import torch
from torch import nn

from .comm import group_of
from .mesh import make_device_mesh, mesh_coord


def make_mesh_ep(n_data: int, n_expert: int):
    """A ("data", "expert") mesh: batch over "data", experts over
    "expert"."""
    return make_device_mesh((n_data, n_expert), ("data", "expert"))


def shard_params_ep(mesh, model: nn.Module) -> nn.Module:
    """Keep this rank's experts of every MoE layer (along the expert axis,
    the leading one of the port's (E, d_in, d_out) and (E, d_out) leaves)
    and set the layer's `ep_group`. A layer whose E the axis does not divide
    stays whole, as JAX replicates it."""
    from ..models.moe import MoeMlp

    group = group_of(mesh, "expert")
    r, n = mesh_coord(mesh, "expert")
    for mod in model.modules():
        if not isinstance(mod, MoeMlp) or mod.n_experts % n:
            continue
        m = mod.n_experts // n
        with torch.no_grad():
            for lin in (mod.experts.fc1, mod.experts.fc2):
                lin.w = nn.Parameter(lin.w[r * m:(r + 1) * m].contiguous())
                lin.b = nn.Parameter(lin.b[r * m:(r + 1) * m].contiguous())
        mod.ep_group = group
    return model
