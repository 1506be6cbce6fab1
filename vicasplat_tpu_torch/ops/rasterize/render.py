"""Rendering API (port of vicasplat_tpu/ops/rasterize/render.py): batched
views, RGB + expected depth + alpha, with optional SE(3) pose deltas.

`RasterizeConfig` keeps the JAX package's field names and values, so a JAX
config converts with `dataclasses.asdict`. In this package `"pallas"` names
the hand-written CUDA kernel: `backend="pallas"` composites through K2
(`pallas_composite.py`), `binning="origin"` merges through the bitonic
top-K K4 (`kernels/bitonic_topk.py`); each takes its plain version on CPU
tensors, and `"auto"` means the kernel for CUDA tensors and the matmul
compositing for CPU tensors, as it means the Pallas kernel on an
accelerator and XLA on the CPU in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...geometry.se3 import rigid_inverse, se3_exp
from .pallas_composite import composite_tiles_kernel
from .projection import project_gaussians
from .tiles import bin_splats, bin_splats_origin, composite_tiles

BACKENDS = ("xla", "pallas", "auto")
BINNINGS = ("dup_sort", "origin")


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    tile_px: int = 16
    dup_hw: tuple = (2, 2)     # max tiles a splat may cover (centred window)
    max_per_tile: int = 512    # front-most splats kept per tile
    chunk: int = 256           # matmul compositing chunk (matmul G dim)
    tile_group: int = 64       # tiles composited together
    # 32-byte payload rows in the binning gather, alpha and colour in bf16
    # (tiles.packed_row_gather); JAX measured no end-to-end gain from it
    packed_gather: bool = False
    # "xla": matmul compositing; "pallas": the K2 kernel (forward; the
    # backward recomputes through the matmul path); "auto": by device
    backend: str = "xla"
    pallas_chunk: int = 128    # payload rows K2 stages at a time
    # "dup_sort": one sort of N*KH*KW duplicated keys; "origin": one sort
    # of N keys by window origin, then K4 merges each tile's neighbours
    binning: str = "dup_sort"
    unroll_views: bool = False  # views always run as a Python loop here

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend={self.backend!r} is not one of {BACKENDS}")
        if self.binning not in BINNINGS:
            raise ValueError(f"binning={self.binning!r} is not one of {BINNINGS}")


def render_view(means, cov6, harmonics, opacities, viewmat, intrinsics,
                image_shape: tuple, background: torch.Tensor, sh_degree: int,
                near: float = 0.2, cfg: RasterizeConfig = RasterizeConfig()):
    """One view -> (color (H, W, 3), depth (H, W), alpha (H, W))."""
    splats = project_gaussians(means, cov6, harmonics, opacities, viewmat,
                               intrinsics, image_shape, sh_degree, near=near)
    bin_fn = bin_splats_origin if cfg.binning == "origin" else bin_splats
    payload = bin_fn(splats, image_shape, cfg.tile_px, cfg.dup_hw,
                     cfg.max_per_tile, packed_gather=cfg.packed_gather)
    backend = cfg.backend
    if backend == "auto":
        backend = "pallas" if payload.device.type == "cuda" else "xla"
    if backend == "pallas":
        return composite_tiles_kernel(payload, image_shape, cfg.tile_px,
                                      background,
                                      min(cfg.pallas_chunk, cfg.max_per_tile))
    return composite_tiles(payload, image_shape, cfg.tile_px, background,
                           chunk=cfg.chunk, tile_group=cfg.tile_group)


def coverage_stats(means, cov6, harmonics, opacities, viewmat, intrinsics,
                   image_shape: tuple, sh_degree: int,
                   cfg: RasterizeConfig = RasterizeConfig()) -> dict:
    """The static-shape caps' effect on one view (JAX `render.py:111-151`):
    the share of live splats whose 3-sigma rect spans more tiles than the
    `dup_hw` window (`truncated_frac`: raise dup_hw), and the share of
    tiles whose list fills `max_per_tile` (`tile_overflow_frac`: raise
    max_per_tile), with `live_frac` and `tile_occupancy_mean`."""
    splats = project_gaussians(means, cov6, harmonics, opacities, viewmat,
                               intrinsics, image_shape, sh_degree)
    KH, KW = cfg.dup_hw
    live = splats.radius > 0
    tiles_w = 2.0 * splats.radius / cfg.tile_px + 1.0  # most tiles spanned
    truncated = live & ((tiles_w > KW) | (tiles_w > KH))
    payload = bin_splats(splats, image_shape, cfg.tile_px, cfg.dup_hw,
                         cfg.max_per_tile)
    occupancy = (payload[..., 5] > 0).sum(dim=1)
    n_live = live.sum().clamp(min=1)
    return {
        "live_frac": live.float().mean(),
        "truncated_frac": truncated.sum() / n_live,
        "tile_occupancy_mean": occupancy.float().mean(),
        "tile_overflow_frac": (occupancy >= cfg.max_per_tile).float().mean(),
    }


def render(
    means: torch.Tensor,        # (N, 3)
    cov6: torch.Tensor,         # (N, 6) packed world covariance
    harmonics: torch.Tensor,    # (N, 3, d_sh)
    opacities: torch.Tensor,    # (N,)
    extrinsics: torch.Tensor,   # (V, 4, 4) c2w
    intrinsics: torch.Tensor,   # (V, 3, 3) normalized
    image_shape: tuple,
    background: torch.Tensor,   # (3,)
    sh_degree: int,
    near: float = 0.2,
    cam_rot_delta: Optional[torch.Tensor] = None,    # (V, 3)
    cam_trans_delta: Optional[torch.Tensor] = None,  # (V, 3)
    cfg: RasterizeConfig = RasterizeConfig(),
):
    """V views of one scene -> (color (V, H, W, 3), depth, alpha (V, H, W)).
    Views run one after another to bound the binning memory."""
    viewmats = rigid_inverse(extrinsics)
    if cam_rot_delta is not None or cam_trans_delta is not None:
        zeros = torch.zeros_like(viewmats[:, :3, 3])
        tau = torch.cat([zeros if cam_trans_delta is None else cam_trans_delta,
                         zeros if cam_rot_delta is None else cam_rot_delta], -1)
        viewmats = se3_exp(tau) @ viewmats  # left retraction on w2c
    outs = [render_view(means, cov6, harmonics, opacities, viewmats[v],
                        intrinsics[v], image_shape, background, sh_degree,
                        near=near, cfg=cfg)
            for v in range(viewmats.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


@torch.no_grad()
def select_raster_config(
    means: torch.Tensor,
    cov6: torch.Tensor,
    harmonics: torch.Tensor,
    opacities: torch.Tensor,
    viewmat: torch.Tensor,
    intrinsics: torch.Tensor,
    image_shape: tuple,
    sh_degree: int,
    base: RasterizeConfig = RasterizeConfig(),
    dup_choices: tuple = (2, 3, 4, 6),
    k_choices: tuple = (256, 512, 1024, 2048),
    coverage_q: float = 0.99,
    headroom: float = 1.1,
) -> RasterizeConfig:
    """Scene-adaptive static caps (dup_hw, max_per_tile), JAX `render.py:
    154-221`: probe one view (projection and one binning pass at the largest
    candidate caps), then take the smallest `dup_hw` whose window covers the
    `coverage_q` quantile of the live splats' tile spans and the smallest
    `max_per_tile` above the `coverage_q` occupancy quantile times
    `headroom`. Each cap rises only where the base one truncates. The probe
    runs eagerly and reads two numbers back to the host: call it outside
    any captured program, once per scene."""
    dup_max, k_max = max(dup_choices), max(k_choices)
    splats = project_gaussians(means, cov6, harmonics, opacities, viewmat,
                               intrinsics, image_shape, sh_degree)
    live = splats.radius > 0
    tiles_w = 2.0 * splats.radius / base.tile_px + 1.0
    # the quantile over live splats only: dead ones (radius 0) span 1 tile
    # and would dilute the tail the window must cover
    span_sorted = torch.sort(torch.where(live, tiles_w, 0.0)).values
    n_live = live.sum().clamp(min=1)
    n = span_sorted.shape[0]
    q_idx = (n - n_live + (coverage_q * (n_live - 1).float()).to(torch.int32)
             ).clamp(0, n - 1)
    span_q = float(span_sorted[q_idx])
    payload = bin_splats(splats, image_shape, base.tile_px, (dup_max, dup_max), k_max)
    occ = (payload[..., 5] > 0).sum(dim=1)
    occ_q = float(torch.quantile(occ.float(), coverage_q))
    dup = max(base.dup_hw)
    if span_q > dup:  # escalate only when the base window truncates
        dup = next((d for d in sorted(dup_choices) if d >= span_q), dup_max)
    k = base.max_per_tile
    k_need = occ_q * headroom
    if k_need > k:  # escalate only when the base K overflows
        k = next((c for c in sorted(k_choices) if c >= k_need), k_max)
    return dataclasses.replace(base, dup_hw=(dup, dup), max_per_tile=k)
