"""Rendering decoder (port of vicasplat_tpu/decoder/splatting.py):
pixel-aligned Gaussians + target cameras -> images, depths, alphas."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..models.adapter import Gaussians
from ..geometry.se3 import rigid_inverse
from ..ops.rasterize import RasterizeConfig, render
from ..ops.rasterize.render import coverage_stats
from ..ops.rasterize.projection import cov6_from_matrix, cov6_from_scale_rot
from ..utils.device_cache import device_constant


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


@device_constant
def _background(color: tuple, device) -> torch.Tensor:
    return torch.tensor(color, dtype=torch.float32, device=device)


def _cov6(g: Gaussians) -> torch.Tensor:
    """(B, N, 6) packed covariances; scales and rotations are the source of
    truth where the adapter filled them."""
    if g.scales is None or g.rotations is None:
        return cov6_from_matrix(g.covariances)
    return torch.stack([cov6_from_scale_rot(s, r)
                        for s, r in zip(g.scales, g.rotations)])


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
    bg = _background(tuple(cfg.background_color), gaussians.means.device)
    if cfg.make_scale_invariant:
        scale = 1.0 / near[:, 0]  # (B,)
        top = torch.cat([extrinsics[..., :3, :3],
                         extrinsics[..., :3, 3:] * scale[:, None, None, None]], -1)
        extrinsics = torch.cat([top, extrinsics[..., 3:, :]], dim=-2)
        gaussians = gaussians._replace(means=gaussians.means * scale[:, None, None])
    cov6 = _cov6(gaussians)
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


# coverage shares above which the static-shape caps (dup_hw tiles a splat,
# max_per_tile entries a tile) visibly distort a scene
COVERAGE_TRUNCATED_WARN = 0.05
COVERAGE_OVERFLOW_WARN = 0.05


@torch.no_grad()
def coverage_report(cfg: DecoderSplattingConfig, gaussians: Gaussians,
                    extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                    image_shape: tuple, tag: str = "") -> dict:
    """`coverage_stats` of the first view of the first example, as floats
    (JAX `decoder/splatting.py:200-251`), with a warning where
    `truncated_frac` or `tile_overflow_frac` passes its threshold."""
    if gaussians.means.ndim > 3:
        gaussians = flatten_gaussians(gaussians)
    sh_degree = int(round(gaussians.harmonics.shape[-1] ** 0.5)) - 1
    cov6 = _cov6(gaussians)
    stats = coverage_stats(
        gaussians.means[0], cov6[0], gaussians.harmonics[0], gaussians.opacities[0],
        rigid_inverse(extrinsics[0, 0]), intrinsics[0, 0], tuple(image_shape),
        sh_degree, cfg=cfg.rasterize)
    stats = {k: float(v) for k, v in stats.items()}
    r = cfg.rasterize
    label = f" [{tag}]" if tag else ""
    if stats["truncated_frac"] > COVERAGE_TRUNCATED_WARN:
        print(f"WARNING{label}: {stats['truncated_frac']:.1%} of live splats span "
              f"more than the dup_hw={r.dup_hw} tile window and are truncated; "
              "raise rasterize.dup_hw")
    if stats["tile_overflow_frac"] > COVERAGE_OVERFLOW_WARN:
        print(f"WARNING{label}: {stats['tile_overflow_frac']:.1%} of tiles hit the "
              f"max_per_tile={r.max_per_tile} capacity; far splats are dropped; "
              "raise rasterize.max_per_tile")
    return stats
