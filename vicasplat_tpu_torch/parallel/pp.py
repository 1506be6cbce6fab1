"""Pipeline parallelism, the GPipe schedule over a stack of blocks (port of
vicasplat_tpu/parallel/pp.py).

Stage s of S holds blocks [s L/S, (s+1) L/S) of a stack (`shard_params_pp`
moves the others to the meta device). The batch splits into M micro-batches;
stage 0 takes each from the input, every other stage receives it from stage
s-1 by point-to-point `recv`, runs its blocks and sends the result on, so
stage s works on micro-batch m while stage s+1 works on m-1. The carry may be
a tuple of tensors (the decoder's (img, cam)); with `collect_outputs` every
block's output comes back in serial block order (the DPT hooks).

`pipeline_scan` returns the final carry on every rank, broadcast from the
last stage, so the code after it runs whole on each rank as it does after
JAX's shard_map. It is differentiable: one autograd Function whose backward
runs the mirror pipeline. The last stage starts from the gradient of the
carry, each stage back-propagates its micro-batches through its own blocks
(accumulating its blocks' parameter gradients in `.grad`) and sends the
input's gradient to stage s-1; stage 0's input gradient is broadcast back,
so every rank's replicated upstream sees the whole gradient. Train with
`loss.backward()` (training/step.py does under a pipeline group).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from .comm import group_of
from .mesh import make_device_mesh


def make_mesh_pipe(n_stages: Optional[int] = None, axis_name: str = "pipe"):
    return make_device_mesh((n_stages or dist.get_world_size(),), (axis_name,))


def make_mesh_pipe_data(n_stages: int, n_data: int,
                        axis_names: tuple = ("pipe", "data")):
    """A (pipe, data) mesh: each stage's blocks replicate over "data", each
    data row runs its own pipeline on its slice of the batch."""
    return make_device_mesh((n_stages, n_data), axis_names)


def stage_range(L: int, group) -> range:
    S = dist.get_world_size(group)
    if L % S:
        raise ValueError(f"block axis {L} not divisible by {S} pipeline stages")
    s, Ls = dist.get_rank(group), L // S
    return range(s * Ls, (s + 1) * Ls)


def shard_params_pp(mesh, blocks: nn.ModuleList, axis_name: str = "pipe"):
    """Keep this stage's L/S consecutive blocks of the stack; the others go
    to the meta device (no memory). Returns the stack."""
    keep = stage_range(len(blocks), group_of(mesh, axis_name))
    for i, blk in enumerate(blocks):
        if i not in keep:
            blk.to("meta")
    return blocks


def _split(t: torch.Tensor, M: int):
    return list(t.chunk(M, dim=0))


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, anchor, *xs):
        group, S, s, M = plan["group"], plan["S"], plan["s"], plan["M"]
        run, collect = plan["run"], plan["collect"]
        last = dist.get_global_rank(group, S - 1)
        first = dist.get_global_rank(group, 0)
        micro = [_split(x, M) for x in xs]
        train = plan["grad"]
        saved, outs, ys_local = [], [], []
        for m in range(M):
            if s == 0:
                h = [x[m].detach().contiguous() for x in micro]
            else:
                h = [torch.empty_like(x[m]) for x in micro]
                for t in h:
                    dist.recv(t, src=dist.get_global_rank(group, s - 1), group=group)
            h_in = [t.requires_grad_(train) for t in h]
            with torch.set_grad_enabled(train):
                h_out, ys = run(tuple(h_in))
            if s < S - 1:
                for t in h_out:
                    dist.send(t.detach().contiguous(),
                              dst=dist.get_global_rank(group, s + 1), group=group)
            saved.append((h_in, h_out, ys))
            outs.append([t.detach() for t in h_out])
            ys_local.append([y.detach() for y in ys])
        # the final carry lives on the last stage; every rank gets a copy
        carry = []
        for j, x in enumerate(xs):
            c = (torch.cat([o[j] for o in outs]) if s == S - 1
                 else torch.empty_like(x))
            dist.broadcast(c, src=last, group=group)
            carry.append(c)
        ys_all = None
        if collect:
            Ls = plan["Ls"]
            # (Ls, B, ...) of each stage, broadcast by its owner in turn
            mine = torch.stack([torch.cat([ys_local[m][i] for m in range(M)])
                                for i in range(Ls)])
            parts = []
            for st in range(S):
                p = mine if st == s else torch.empty_like(mine)
                dist.broadcast(p, src=dist.get_global_rank(group, st), group=group)
                parts.append(p)
            ys_all = torch.cat(parts)
        ctx.plan, ctx.saved = plan, saved
        ctx.first = first
        return tuple(carry) + ((ys_all,) if collect else ())

    @staticmethod
    def backward(ctx, *grads):
        plan, saved = ctx.plan, ctx.saved
        group, S, s, M = plan["group"], plan["S"], plan["s"], plan["M"]
        n_carry = len(saved[0][0])
        g_carry = grads[:n_carry]
        g_ys = grads[n_carry] if plan["collect"] else None
        g_in_all = [[None] * M for _ in range(n_carry)]
        for m in reversed(range(M)):
            h_in, h_out, ys = saved[m]
            if s == S - 1:
                g_out = [torch.zeros_like(o) if g is None else _split(g, M)[m]
                         for o, g in zip(h_out, g_carry)]
            else:
                g_out = [torch.empty_like(o) for o in h_out]
                for t in g_out:
                    dist.recv(t, src=dist.get_global_rank(group, s + 1), group=group)
            tensors, gts = list(h_out), list(g_out)
            if g_ys is not None:
                lo = s * plan["Ls"]
                for i, y in enumerate(ys):
                    tensors.append(y)
                    gts.append(_split(g_ys[lo + i], M)[m])
            pairs = [(t, g) for t, g in zip(tensors, gts) if t.requires_grad]
            if pairs:
                torch.autograd.backward([p[0] for p in pairs], [p[1] for p in pairs])
            g_in = [torch.zeros_like(h) if h.grad is None else h.grad for h in h_in]
            if s > 0:
                for t in g_in:
                    dist.send(t.contiguous(), dst=dist.get_global_rank(group, s - 1),
                              group=group)
            for j in range(n_carry):
                g_in_all[j][m] = g_in[j]
        ctx.saved = None
        out = []
        for j in range(n_carry):
            g = (torch.cat(g_in_all[j]) if s == 0
                 else torch.empty_like(torch.cat(g_in_all[j])))
            dist.broadcast(g, src=ctx.first, group=group)
            out.append(g)
        return (None, None) + tuple(out)


def pipeline_scan(block_fn: Callable, blocks: nn.ModuleList, x, group, *,
                  n_micro: Optional[int] = None, data_size: int = 1,
                  collect_outputs: bool = False):
    """Run x through every block of `blocks`, pipelined over `group`.

    block_fn(carry, blk) -> carry, or (carry, y) with collect_outputs; the
    carry is a tensor or a tuple of tensors, each leading with the batch
    dim B, and a block keeps its shapes. n_micro is M (default: the stage
    count); B must divide by M. data_size: the size of a data axis that
    splits the global batch beside the pipeline (this rank's x is its
    slice); the micro-batch of the global batch must divide by it, as JAX
    asserts. Returns the final carry, or (carry, ys) with ys (L, B, ...)."""
    group = group_of(group, "pipe")
    S = dist.get_world_size(group)
    L = len(blocks)
    local = stage_range(L, group)
    M = int(n_micro) if n_micro is not None else S
    single = isinstance(x, torch.Tensor)
    xs = (x,) if single else tuple(x)
    B = xs[0].shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    if (B * data_size // M) % data_size:
        raise ValueError(f"microbatch {B * data_size // M} not divisible by "
                         f"data axis {data_size}")

    for i in local:  # their gradients live on this stage alone
        for p in blocks[i].parameters():
            p._pipeline_block = S > 1

    def run(h):
        carry = h[0] if single else h
        ys = []
        for i in local:
            r = block_fn(carry, blocks[i])
            if collect_outputs:
                carry, y = r
                ys.append(y)
            else:
                carry = r
        return ((carry,) if single else tuple(carry)), ys

    plan = dict(group=group, S=S, s=dist.get_rank(group), M=M, run=run,
                collect=collect_outputs, Ls=L // S,
                grad=torch.is_grad_enabled())
    # a leaf that needs a gradient, so that the backward runs (and fills
    # the blocks' parameter gradients) even when no input needs one
    anchor = torch.zeros((), device=xs[0].device, requires_grad=plan["grad"])
    res = _Pipeline.apply(plan, anchor, *xs)
    carry = res[0] if single else tuple(res[:len(xs)])
    return (carry, res[-1]) if collect_outputs else carry


def decoder_micro(B: int, n_req: int) -> int:
    """The decoder's micro-batch count: only the example axis B splits
    (its attention is joint over the frames), so gcd(B, n_req), at least 1."""
    return max(1, math.gcd(B, n_req))
