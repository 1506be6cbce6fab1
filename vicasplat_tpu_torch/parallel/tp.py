"""Tensor parallelism for the VicaNet transformer stacks (port of
vicasplat_tpu/parallel/tp.py).

A ("data", "model") mesh splits the batch over "data" and each block's
heads and MLP hidden units over "model", Megatron-style, following JAX's
`_TP_RULES`: qkv, the cross-attention q/k/v and fc1 (of `mlp` and
`mlp_cam`) are column-parallel, the attention projections and fc2
row-parallel, everything else (norms, embeddings, modulations, heads, an
MoE `mlp`) replicated. JAX annotates the shardings and lets GSPMD insert
the all-reduces; here `shard_params_tp` keeps each rank's slice of the
weights and the blocks' forwards (models/vicanet.py) all-reduce after each
row-parallel product (`parallel/comm.py`, with gradients).

DTensor's `parallelize_module` does not fit these blocks: they apply their
linears through `layers.linear`, which casts the weights to the compute
dtype at each call, not through `nn.Module.__call__`, so the
ParallelStyles' input and output hooks would never run, and their DTensor
weights would meet plain activations (aten.addmm refuses the mix).

The fused `qkv` linear (3*dim outputs, split by `chunk(3)` and then into
heads) is cut per head: rank r keeps the q, k and v rows of its own heads,
so the block runs on n_heads / n_model local heads and K1 sees them with
head dim 64 as before. (JAX's `use_flash_attention=False` under TP came
from GSPMD and does not apply here.)
"""
from __future__ import annotations

import torch
from torch import nn

from .comm import group_of
from .mesh import GradSplit, make_device_mesh, mark_split, mesh_coord, mesh_group

# (module path suffix, "col" | "row"), as JAX's _TP_RULES name the leaves
TP_RULES = (
    (("attn", "qkv"), "qkv"),
    (("attn", "proj"), "row"),
    (("cross_attn", "projq"), "col"),
    (("cross_attn", "projk"), "col"),
    (("cross_attn", "projv"), "col"),
    (("cross_attn", "proj"), "row"),
    (("mlp", "fc1"), "col"),
    (("mlp", "fc2"), "row"),
    (("mlp_cam", "fc1"), "col"),
    (("mlp_cam", "fc2"), "row"),
)


def make_mesh_2d(n_data: int, n_model: int):
    return make_device_mesh((n_data, n_model), ("data", "model"))


def tp_rule(path: tuple):
    for suffix, kind in TP_RULES:
        if path[-len(suffix):] == suffix:
            return kind
    return None


@torch.no_grad()
def _cut(lin: nn.Linear, kind: str, r: int, n: int) -> list:
    """Keep rank r's slice of lin; returns the parameters that were cut."""
    w, b = lin.weight, lin.bias
    if kind == "col":
        m = w.shape[0] // n
        w, b = w[r * m:(r + 1) * m], None if b is None else b[r * m:(r + 1) * m]
    elif kind == "qkv":  # rows [q | k | v]: this rank's heads of each
        d = w.shape[0] // 3
        m = d // n
        rows = torch.cat([torch.arange(j * d + r * m, j * d + (r + 1) * m)
                          for j in range(3)]).to(w.device)
        w, b = w[rows], None if b is None else b[rows]
    else:  # row: input features; the bias is added once, after the reduce
        m = w.shape[1] // n
        w = w[:, r * m:(r + 1) * m]
    lin.weight = nn.Parameter(w.contiguous())
    if kind == "row" or b is None:
        return [lin.weight]
    lin.bias = nn.Parameter(b.contiguous())
    return [lin.weight, lin.bias]


def shard_params_tp(mesh, model: nn.Module) -> nn.Module:
    """Keep this rank's "model" slice of every linear that TP_RULES names in
    the encoder and decoder blocks, and give each block the group. The head
    counts and MLP widths must divide by the "model" size.

    Marks each parameter cut for training/step.make_train_step (a
    mesh.GradSplit). The gradients follow Megatron's one-copy convention
    (parallel/comm.py): every "model" rank holds the whole gradient of each
    replicated leaf and of its own slices, so a slice is averaged over
    "data", every other leaf over the mesh, and the clip's norm sums the
    slices' squares over "model"."""
    from ..models.moe import MoeMlp
    from ..models.vicanet import DecBlock, EncBlock

    group = group_of(mesh, "model")
    r, n = mesh_coord(mesh, "model")
    sharded = []
    for bname, blk in model.named_modules():
        if not isinstance(blk, (EncBlock, DecBlock)):
            continue
        heads = blk.n_heads
        if heads % n:
            raise ValueError(f"{heads} heads in {bname} do not split over {n}")
        for name, lin in blk.named_modules():
            path = tuple(name.split("."))
            kind = tp_rule(path) if isinstance(lin, nn.Linear) else None
            if kind is None or (path[0] == "mlp" and isinstance(blk.mlp, MoeMlp)):
                continue
            width = lin.weight.shape[1 if kind == "row" else 0]
            if width % (3 * n if kind == "qkv" else n):
                raise ValueError(f"{bname}.{name} ({width}) does not split over {n}")
            sharded += _cut(lin, kind, r, n)
        blk.tp_group = group
    mark_split(sharded, GradSplit(
        reduce=group_of(mesh, "data"), divisor=mesh_coord(mesh, "data")[1], norm=group,
        mesh=mesh_group(mesh), mesh_size=mesh.size()))
    return model
