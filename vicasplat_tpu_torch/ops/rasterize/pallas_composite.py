"""Per-tile compositing through K2 (port of
vicasplat_tpu/ops/rasterize/pallas_composite.py).

`"pallas"` names the hand-written CUDA kernel in this package, as in
`RasterizeConfig.backend`. `composite_tiles_kernel` launches K2
(`kernels/composite.py`) for a CUDA payload and takes its plain version,
`composite_reference`, for a CPU one. As in the JAX package, alpha is
1 - T_final, and the backward recomputes through the plain matmul
compositing (`tiles.composite_tiles`), whose gradients are the exact ones,
to the payload and to the background.
"""
from __future__ import annotations

import numpy as np
import torch

from ...kernels.composite import PAYLOAD_COLS, composite_launch
from .tiles import _composite_group, _tile_pixel_centers, composite_tiles, stitch_tiles


def composite_reference(payload: torch.Tensor, image_shape: tuple, tile_px: int,
                        background: torch.Tensor, chunk: int):
    """K2's function without its early exit: the plain matmul compositing
    of every tile -> (rgb (H, W, 3), depth (H, W), alpha = 1 - T_final)."""
    pix = _tile_pixel_centers(image_shape, tile_px, payload.device)
    rgb, dep, _, t_final = _composite_group(payload, pix, chunk)
    rgb = rgb + t_final[..., None] * background.to(rgb.dtype)
    return tuple(stitch_tiles(x, image_shape, tile_px)
                 for x in (rgb, dep, 1.0 - t_final))


def dense_payload(tiles: int, K: int, tile_px: int, tiles_x: int, seed: int = 0,
                  device="cpu") -> torch.Tensor:
    """A synthetic (tiles, K, 16) payload whose pixels saturate: splats
    inside their own tile, wide (conic 0.01-0.05) and opaque (0.05-0.99),
    depth-sorted. It drives K2's early exit, which a sparse scene never
    reaches. Made with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    t = np.arange(tiles)
    p = np.zeros((tiles, K, PAYLOAD_COLS), np.float32)
    p[:, :, 0] = ((t % tiles_x) * tile_px)[:, None] + rng.uniform(0, tile_px, (tiles, K))
    p[:, :, 1] = ((t // tiles_x) * tile_px)[:, None] + rng.uniform(0, tile_px, (tiles, K))
    p[:, :, 2] = rng.uniform(0.01, 0.05, (tiles, K))
    p[:, :, 3] = rng.uniform(-0.005, 0.005, (tiles, K))
    p[:, :, 4] = rng.uniform(0.01, 0.05, (tiles, K))
    p[:, :, 5] = rng.uniform(0.05, 0.99, (tiles, K))
    p[:, :, 6:9] = rng.uniform(0, 1, (tiles, K, 3))
    p[:, :, 9] = np.sort(rng.uniform(1, 5, (tiles, K)), axis=1)
    return torch.from_numpy(p).to(device)


def _check(payload, image_shape, background, tile_px, chunk):
    H, W = image_shape
    th, tw = -(-H // tile_px), -(-W // tile_px)
    if payload.ndim != 3 or payload.shape[0] != th * tw \
            or payload.shape[2] != PAYLOAD_COLS:
        raise ValueError(f"payload {tuple(payload.shape)} is not ({th * tw}, K, "
                         f"{PAYLOAD_COLS}) for {image_shape} in tiles of {tile_px}")
    if payload.shape[1] % chunk:
        raise ValueError(f"max_per_tile {payload.shape[1]} is not a multiple "
                         f"of chunk {chunk}")
    if background.shape != (3,):
        raise ValueError(f"background {tuple(background.shape)} is not (3,)")


class _Composite(torch.autograd.Function):
    """Forward: K2 (CUDA) or its plain version (CPU). Backward: a recompute
    through the plain matmul compositing, as the JAX package's custom_vjp
    does, to the payload and the background."""

    @staticmethod
    def forward(ctx, payload, background, image_shape, tile_px, chunk):
        ctx.save_for_backward(payload, background)
        ctx.cfg = (image_shape, tile_px, chunk)
        if payload.device.type == "cpu":
            return composite_reference(payload, image_shape, tile_px, background,
                                       chunk)
        return composite_launch(payload, image_shape, tile_px, background, chunk)

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_alpha):
        payload, background = ctx.saved_tensors
        image_shape, tile_px, chunk = ctx.cfg
        with torch.enable_grad():
            p = payload.detach().requires_grad_(ctx.needs_input_grad[0])
            bg = background.detach().requires_grad_(ctx.needs_input_grad[1])
            outs = composite_tiles(p, image_shape, tile_px, bg.to(p.device),
                                   chunk=chunk, tile_group=min(64, p.shape[0]))
            wrt = [x for x in (p, bg) if x.requires_grad]
            # depth and alpha do not depend on the background alone
            pairs = [(o, g) for o, g in zip(outs, (g_rgb, g_depth, g_alpha))
                     if o.requires_grad]
            outs, g_outs = zip(*pairs)
            grads = iter(torch.autograd.grad(outs, wrt, g_outs))
        return (next(grads) if p.requires_grad else None,
                next(grads) if bg.requires_grad else None, None, None, None)


def composite_tiles_kernel(payload: torch.Tensor, image_shape: tuple,
                           tile_px: int, background: torch.Tensor,
                           chunk: int = 128):
    """payload (tiles, K, 16) -> (rgb (H, W, 3), depth (H, W), alpha (H, W)),
    alpha = 1 - T_final; differentiable in the payload and the background.

    A CUDA payload launches K2 (float32, contiguous, tile_px^2 <= 1024); a
    CPU payload takes `composite_reference`.
    """
    image_shape = tuple(image_shape)
    _check(payload, image_shape, background, tile_px, chunk)
    return _Composite.apply(payload, background, image_shape, tile_px, chunk)
