"""Collectives with gradients, for the sharded forwards (tp.py, sp.py).

- `copy_to_group`: identity forward, all-reduce (sum) backward: the input of
  a column-parallel linear, whose ranks each use all of it.
- `reduce_from_group`: all-reduce (sum) forward, identity backward: the
  output of a row-parallel linear.
- `gather_along`: all-gather along a dimension forward; its backward is the
  reduce-scatter, each rank keeping the summed gradient of its own chunk.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_of(mesh, dim: str):
    """The process group of one dimension of a DeviceMesh (or a group
    passed as is)."""
    if mesh is None or isinstance(mesh, dist.ProcessGroup):
        return mesh
    return mesh.get_group(dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.group, ctx.dim
        n = dist.get_world_size(group)
        chunks = [c.contiguous() for c in g.chunk(n, dim=dim)]
        if dist.get_backend(group) == dist.Backend.NCCL:
            out = torch.empty_like(chunks[0])
            dist.reduce_scatter(out, chunks, group=group)
            return out, None, None
        g = g.contiguous().clone()  # gloo has no reduce-scatter: reduce, slice
        dist.all_reduce(g, group=group)
        return g.chunk(n, dim=dim)[dist.get_rank(group)].contiguous(), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherAlong.apply(x, dim % x.ndim, group)
