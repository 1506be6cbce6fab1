"""Rendering decoder (port of vicasplat_tpu/decoder/splatting.py):
pixel-aligned Gaussians + target cameras -> images, depths, alphas."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..models.adapter import Gaussians
from ..ops.rasterize import RasterizeConfig, render
from ..ops.rasterize.projection import cov6_from_matrix, cov6_from_scale_rot


@dataclasses.dataclass(frozen=True)
class DecoderSplattingConfig:
    background_color: tuple = (0.0, 0.0, 0.0)
    # divide the scene and the cameras by each example's first near plane
    make_scale_invariant: bool = False
    rasterize: RasterizeConfig = RasterizeConfig()
    # drop this fraction of the lowest-opacity Gaussians before rendering
    prune_fraction: float = 0.0


class DecoderOutput(NamedTuple):
    color: torch.Tensor  # (B, V, H, W, 3)
    depth: torch.Tensor  # (B, V, H, W)
    alpha: torch.Tensor  # (B, V, H, W)


def flatten_gaussians(g: Gaussians) -> Gaussians:
    """(B, T, H, W, ...) pixel-aligned Gaussians -> (B, N, ...)."""
    b = g.means.shape[0]

    def flat(x, extra):
        return None if x is None else x.reshape(b, -1, *x.shape[x.ndim - extra:])

    return Gaussians(
        means=flat(g.means, 1),
        covariances=flat(g.covariances, 2),
        harmonics=flat(g.harmonics, 2),
        opacities=g.opacities.reshape(b, -1),
        scales=flat(g.scales, 1),
        rotations=flat(g.rotations, 1),
    )


def prune_gaussians(g: Gaussians, fraction: float) -> Gaussians:
    """Keep the top (1 - fraction) of each example's splats by opacity: a
    sort by descending opacity, then one row gather of all fields packed
    side by side. The kept count is rounded down to a multiple of 128 when
    N >= 256, as in JAX; survivor order does not matter downstream."""
    b, N = g.opacities.shape
    keep = max(1, int(round(N * (1.0 - fraction))))
    if N >= 256:
        keep = max(128, (keep // 128) * 128)
    idx = torch.argsort(-g.opacities, dim=1)[:, :keep]
    fields = {"means": g.means, "covariances": g.covariances,
              "harmonics": g.harmonics, "opacities": g.opacities[..., None],
              "scales": g.scales, "rotations": g.rotations}
    parts, spans, col = [], {}, 0
    for name, x in fields.items():
        if x is None:
            continue
        flat = x.reshape(b, N, -1)
        spans[name] = (col, col + flat.shape[-1], x.shape[2:])
        col += flat.shape[-1]
        parts.append(flat)
    packed = torch.cat(parts, dim=-1)
    kept = torch.gather(packed, 1, idx[..., None].expand(b, keep, col))

    def unpack(name):
        if name not in spans:
            return None
        lo, hi, shape = spans[name]
        return kept[..., lo:hi].reshape(b, keep, *shape)

    return Gaussians(means=unpack("means"), covariances=unpack("covariances"),
                     harmonics=unpack("harmonics"),
                     opacities=unpack("opacities")[..., 0],
                     scales=unpack("scales"), rotations=unpack("rotations"))


def decoder_forward(
    cfg: DecoderSplattingConfig,
    gaussians: Gaussians,
    extrinsics: torch.Tensor,   # (B, V, 4, 4) c2w
    intrinsics: torch.Tensor,   # (B, V, 3, 3) normalized
    near: torch.Tensor,         # (B, V)
    far: torch.Tensor,          # (B, V)
    image_shape: tuple,
    cam_rot_delta: Optional[torch.Tensor] = None,    # (B, V, 3)
    cam_trans_delta: Optional[torch.Tensor] = None,  # (B, V, 3)
    sh_degree: Optional[int] = None,
) -> DecoderOutput:
    """Render every target view of every example. As in JAX, `near` and
    `far` only set the scale of `make_scale_invariant`; the rasterizer culls
    at its own near plane of 0.2."""
    if gaussians.means.ndim > 3:
        gaussians = flatten_gaussians(gaussians)
    if cfg.prune_fraction > 0.0:
        gaussians = prune_gaussians(gaussians, cfg.prune_fraction)
    if sh_degree is None:
        sh_degree = int(round(gaussians.harmonics.shape[-1] ** 0.5)) - 1
    dev = gaussians.means.device
    bg = torch.tensor(cfg.background_color, dtype=torch.float32, device=dev)
    if cfg.make_scale_invariant:
        scale = 1.0 / near[:, 0]  # (B,)
        top = torch.cat([extrinsics[..., :3, :3],
                         extrinsics[..., :3, 3:] * scale[:, None, None, None]], -1)
        extrinsics = torch.cat([top, extrinsics[..., 3:, :]], dim=-2)
        gaussians = gaussians._replace(means=gaussians.means * scale[:, None, None])
    # scales/rotations are the source of truth where the adapter filled them
    if gaussians.scales is None or gaussians.rotations is None:
        cov6 = cov6_from_matrix(gaussians.covariances)
    else:
        cov6 = torch.stack([cov6_from_scale_rot(s, r) for s, r in
                            zip(gaussians.scales, gaussians.rotations)])
    if cfg.make_scale_invariant:
        cov6 = cov6 * scale[:, None, None] ** 2
    outs = []
    for b in range(extrinsics.shape[0]):
        outs.append(render(
            gaussians.means[b], cov6[b], gaussians.harmonics[b],
            gaussians.opacities[b], extrinsics[b], intrinsics[b], image_shape,
            bg, sh_degree,
            cam_rot_delta=None if cam_rot_delta is None else cam_rot_delta[b],
            cam_trans_delta=None if cam_trans_delta is None else cam_trans_delta[b],
            cfg=cfg.rasterize,
        ))
    return DecoderOutput(*(torch.stack(x) for x in zip(*outs)))
