"""Novel-view rendering with the view axis split over ranks (port of
vicasplat_tpu/parallel/view_parallel.py).

The Gaussians of one scene and every camera stay whole on each rank; rank i
of n renders views clip(i m + arange(m), 0, V - 1) with m = ceil(V / n), and
the views are all-gathered along V (a ragged tail re-renders the last view
and is cut). No other communication: each view's project, bin and
composite run on their rank as in `decoder_forward`.

`make_scale_invariant` is applied here, before the split, from the global
first view's near plane (decoder_forward would take each rank's own first
view): the means and camera translations scale by 1 / near[:, 0] and the
covariances by its square, which agrees with the serial path to float32
rounding.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .comm import group_of


def decoder_forward_view_sharded(
    cfg,                        # DecoderSplattingConfig
    gaussians,                  # models.adapter.Gaussians
    extrinsics: torch.Tensor,   # (B, V, 4, 4) c2w
    intrinsics: torch.Tensor,   # (B, V, 3, 3) normalized
    near: torch.Tensor,         # (B, V)
    far: torch.Tensor,          # (B, V)
    image_shape: tuple,
    mesh,
    axis_name: str = "data",
    sh_degree: Optional[int] = None,
):
    """`decoder_forward` of every view, the views split over the mesh's
    axis (a DeviceMesh, or a process group). Returns a DecoderOutput of
    (B, V, ...) on every rank."""
    # the decoder imports the models, which import parallel/comm.py
    from ..decoder.splatting import DecoderOutput, decoder_forward, flatten_gaussians

    group = group_of(mesh, axis_name)
    if gaussians.means.ndim > 3:
        gaussians = flatten_gaussians(gaussians)
    if cfg.make_scale_invariant:
        scale = 1.0 / near[:, 0]  # (B,)
        top = torch.cat([extrinsics[..., :3, :3],
                         extrinsics[..., :3, 3:] * scale[:, None, None, None]], -1)
        extrinsics = torch.cat([top, extrinsics[..., 3:, :]], dim=-2)
        s3 = scale[:, None, None]
        gaussians = gaussians._replace(
            means=gaussians.means * s3,
            scales=None if gaussians.scales is None else gaussians.scales * s3,
            covariances=(None if gaussians.covariances is None
                         else gaussians.covariances * scale[:, None, None, None] ** 2))
        near, far = near * scale[:, None], far * scale[:, None]
        cfg = dataclasses.replace(cfg, make_scale_invariant=False)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    B, V = extrinsics.shape[:2]
    m = -(-V // n)
    idx = (i * m + torch.arange(m, device=extrinsics.device)).clamp(max=V - 1)
    out = decoder_forward(cfg, gaussians, extrinsics[:, idx], intrinsics[:, idx],
                          near[:, idx], far[:, idx], image_shape,
                          sh_degree=sh_degree)
    fields = []
    for x in out:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        fields.append(torch.cat(parts, dim=1)[:, :V])
    return DecoderOutput(*fields)
