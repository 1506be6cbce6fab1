"""Sequence parallelism over the patch-token axis of the VicaNet stacks
(port of vicasplat_tpu/parallel/sp.py).

On a ("data", "seq") mesh the batch splits over "data" and each frame's N
tokens over "seq": a rank holds ceil(N / n_seq) of them. JAX states the
layout as sharding constraints and lets GSPMD insert the collectives; here
they are explicit (`models/vicanet.py` with `sp_mesh`):
- layer norms, linears, MLPs and RoPE run on the local tokens, with the
  RoPE tables sliced at the tokens' global positions;
- around each attention the keys and values are all-gathered (its backward
  is a reduce-scatter) and the queries stay local, so K1 runs with
  Sq != Sk;
- camera tokens (B, T, C) stay whole on every rank;
- N need not divide by n_seq (the intrinsic token makes N = 257 at 256²):
  the tokens are padded to a multiple and the gathered keys cut back to N,
  so pad tokens are never attended to; the outputs are gathered and cut.

Training (training/step.make_train_step(sp_mesh=...)): each rank passes its
"data" slice of the batch (`shard_batch(mesh, batch)`) and, after the final
gather, renders that slice whole and computes the same loss as the other
"seq" ranks. Every collective's backward is its exact adjoint (an
all-gather's is a reduce-scatter), so the "seq" ranks' gradients sum to
n_seq times the gradient of their loss, the replicated camera path
included; the step averages them over the whole mesh. This is the adjoint
convention, unlike tensor parallelism's one-copy (Megatron) convention in
comm.py's copy_to_group / reduce_from_group.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .comm import gather_along, group_of
from .mesh import make_device_mesh, mesh_coord


def make_mesh_sp(n_data: int, n_seq: int):
    """A ("data", "seq") mesh: batch over "data", patch tokens over "seq"."""
    return make_device_mesh((n_data, n_seq), ("data", "seq"))


class SeqShard:
    """This rank's window of a token axis of n_tokens entries over the
    mesh's "seq" dimension."""

    def __init__(self, mesh, n_tokens: int):
        self.group = group_of(mesh, "seq")
        rank, self.n = mesh_coord(mesh, "seq")
        self.n_tokens = n_tokens
        self.local = -(-n_tokens // self.n)
        self.lo = rank * self.local

    def shard(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """The local window of axis (padded with zeros past n_tokens)."""
        axis %= x.ndim
        pad = self.local * self.n - x.shape[axis]
        if pad:
            widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
            x = F.pad(x, widths)
        return x.narrow(axis, self.lo, self.local)

    def gather(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Every rank's window concatenated, cut back to n_tokens."""
        return gather_along(x, axis, self.group).narrow(axis % x.ndim, 0,
                                                        self.n_tokens)


def sp_shard_tokens(x: torch.Tensor, mesh, token_axis: int = -2) -> torch.Tensor:
    """This rank's "seq" window of x's token axis (the counterpart of JAX's
    constraint; no-op without a mesh)."""
    if mesh is None:
        return x
    return SeqShard(mesh, x.shape[token_axis]).shard(x, token_axis)


def sp_shard_batch_only(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's "data" slice of x's leading axis, whole over "seq" (no-op
    without a mesh)."""
    if mesh is None:
        return x
    i, n = mesh_coord(mesh, "data")
    m = x.shape[0] // n
    return x[i * m:(i + 1) * m]
