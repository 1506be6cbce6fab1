"""Brute-force per-pixel renderer, the oracle of the tiled render (port of
vicasplat_tpu/ops/rasterize/reference.py).

Every Gaussian is evaluated at every pixel in exact global depth order, with
no tiles, windows or per-tile caps: O(pixels x N). The tiled path
(tiles.py, and K2 behind it) must agree with it up to those caps' effects.
`render_view_bruteforce` builds the (pixels, N) arrays at once, for tiny
scenes; `render_view_bruteforce_chunked` runs the same arithmetic over
chunks of `px_chunk` pixels, so a 524,288-splat view fits on a card.

`support_tile_px` (the port's own option; None is JAX's oracle) gives each
splat the support that the tiled render and the CUDA rasterizer it follows
give it: the pixels of the tiles its 3-sigma rect overlaps. A splat of
opacity above 0.36 still passes alpha 1/255 a little beyond 3 sigma, so
without it a dense scene's oracle has contributions that no tiled render
makes, whatever its caps.
"""
from __future__ import annotations

import torch

from .projection import project_gaussians


def _sorted_splats(means, cov6, harmonics, opacities, viewmat, intrinsics,
                   image_shape, sh_degree, near, support_tile_px):
    s = project_gaussians(means, cov6, harmonics, opacities, viewmat, intrinsics,
                          image_shape, sh_degree, near=near)
    order = torch.argsort(s.depth)
    alpha = torch.where(s.radius[order] > 0, s.alpha[order],
                        torch.zeros_like(s.alpha[order]))
    rect = None
    if support_tile_px is not None:  # (4, N): first and last tile x, y
        m, r = s.mean2d[order], s.radius[order]
        rect = torch.floor(torch.stack([m[:, 0] - r, m[:, 0] + r, m[:, 1] - r,
                                        m[:, 1] + r]) / support_tile_px)
    return (s.mean2d[order], s.conic[order], s.color[order], alpha,
            s.depth[order], rect)


def _pixels(image_shape, device) -> torch.Tensor:
    """(H * W, 2) pixel centres (x, y), row-major."""
    H, W = image_shape
    ys, xs = torch.meshgrid(torch.arange(H, device=device) + 0.5,
                            torch.arange(W, device=device) + 0.5, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()


def _composite(pix, mean2d, conic, color, alpha, depth, rect, background,
               support_tile_px):
    """pix (P, 2) -> rgb (P, 3), depth (P,), alpha (P,), front to back."""
    dx = pix[:, :1] - mean2d[None, :, 0]
    dy = pix[:, 1:2] - mean2d[None, :, 1]
    power = (-0.5 * (conic[None, :, 0] * dx * dx + conic[None, :, 2] * dy * dy)
             - conic[None, :, 1] * dx * dy)
    a = torch.clamp(alpha[None, :] * torch.exp(power.clamp(max=0.0)), max=0.99)
    a = torch.where((power > 0.0) | (a < 1.0 / 255.0), torch.zeros_like(a), a)
    if rect is not None:
        tx = torch.floor(pix[:, :1] / support_tile_px)
        ty = torch.floor(pix[:, 1:2] / support_tile_px)
        inside = ((tx >= rect[None, 0]) & (tx <= rect[None, 1])
                  & (ty >= rect[None, 2]) & (ty <= rect[None, 3]))
        a = torch.where(inside, a, torch.zeros_like(a))
    logom = torch.log1p(-a)
    # exclusive prefix over the splats, front to back
    prefix = torch.cat([torch.zeros_like(logom[:, :1]),
                        torch.cumsum(logom, dim=1)[:, :-1]], dim=1)
    w = torch.exp(prefix) * a
    rgb = w @ color + torch.exp(logom.sum(1))[:, None] * background
    return rgb, (w * depth[None, :]).sum(-1), w.sum(-1)


def render_view_bruteforce(means, cov6, harmonics, opacities, viewmat,
                           intrinsics, image_shape, background, sh_degree,
                           near=0.2, support_tile_px=None):
    """One view -> (color (H, W, 3), depth (H, W), alpha (H, W))."""
    H, W = image_shape
    sp = _sorted_splats(means, cov6, harmonics, opacities, viewmat, intrinsics,
                        image_shape, sh_degree, near, support_tile_px)
    rgb, dep, asum = _composite(_pixels(image_shape, means.device), *sp,
                                background, support_tile_px)
    return rgb.reshape(H, W, 3), dep.reshape(H, W), asum.reshape(H, W)


def render_view_bruteforce_chunked(means, cov6, harmonics, opacities, viewmat,
                                   intrinsics, image_shape, background,
                                   sh_degree, near=0.2, px_chunk=512,
                                   support_tile_px=None):
    """`render_view_bruteforce` over chunks of px_chunk pixels: the (P, N)
    arrays never exceed (px_chunk, N)."""
    H, W = image_shape
    sp = _sorted_splats(means, cov6, harmonics, opacities, viewmat, intrinsics,
                        image_shape, sh_degree, near, support_tile_px)
    pix = _pixels(image_shape, means.device)
    parts = [_composite(pix[i:i + px_chunk], *sp, background, support_tile_px)
             for i in range(0, pix.shape[0], px_chunk)]
    rgb, dep, asum = (torch.cat(x) for x in zip(*parts))
    return rgb.reshape(H, W, 3), dep.reshape(H, W), asum.reshape(H, W)
