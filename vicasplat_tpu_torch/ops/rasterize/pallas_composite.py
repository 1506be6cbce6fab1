"""Per-tile compositing through K2 (port of
vicasplat_tpu/ops/rasterize/pallas_composite.py).

`"pallas"` names the hand-written CUDA kernel in this package, as in
`RasterizeConfig.backend`. `composite_tiles_kernel` calls K2's operator
(`torch.ops.vicasplat.composite`, `kernels/composite.py`), which launches
the kernel for a CUDA payload and takes its plain version,
`composite_reference`, for a CPU one. As in the JAX package, alpha is
1 - T_final, and the backward recomputes through the plain matmul
compositing (`tiles.composite_tiles`), whose gradients are the exact ones,
to the payload and to the background.

`composite_cull` gives the kernel's cull bits (which rows each warp's
rectangle of pixels may skip) by the kernel's own rule, and `composite_walk`
composites in the kernel's order (chunks, each warp's surviving rows, each
pixel's exit), so that both can be tested where no card exists.
"""
from __future__ import annotations

import numpy as np
import torch

from ...kernels.composite import PAYLOAD_COLS
from .tiles import _composite_group, _tile_pixel_centers, composite_tiles, stitch_tiles


# The cull's constants, as in csrc/composite.cu. A row is dead at a pixel
# unless alpha = min(0.99, opacity exp(power)) >= 1/255 with power <= 0,
# i.e. unless d^T M d <= 2 ln(opacity / MIN_ALPHA) for the offset d and the
# conic M = [[a, b], [b, c]] (power = -d^T M d / 2). The kernel computes that
# in float32, so the rule is widened to cover its roundings:
# - expf is within 2 ulp and opacity * exp rounds once, so an opacity
#   under MIN_ALPHA / OPACITY_SLACK is dead everywhere, and alpha >= 1/255
#   needs power >= -ln(opacity / MIN_ALPHA) - POWER_SLACK (4x the 2^-21
#   these roundings can move it);
# - the float32 form d^T M d, with its offsets rounded, is within about
#   14 ulp (8.3e-7) of its value times S = a dx^2 + c dy^2 + 2 |b dx dy|,
#   and S <= 2 skew d^T M d, skew = (a + c)^2 / det >= the condition number
#   of M; QUAD_SLACK = 2^-17 covers it 9 times over. Rows whose skew
#   reaches MAX_SKEW (so that the slack would pass 1/2) are kept, as are
#   rows that are not positive definite or hold a NaN or an infinity.
# The live set then lies in d^T M d <= q, whose bounding box has
# half-extents sqrt(q c / det) in x and sqrt(q a / det) in y, computed in
# float64, rounded outward to float32 and tested against each warp's
# rectangle of pixel centres.
MIN_ALPHA = float(np.float32(1.0 / 255.0))
OPACITY_SLACK = 1.0 + 2.0 ** -20
POWER_SLACK = 2.0 ** -19
QUAD_SLACK = 2.0 ** -17
MAX_SKEW = 2.0 ** 16


def warp_rects(tile_px: int) -> torch.Tensor:
    """(warps, 4) float64: each warp's rectangle of pixel centres within a
    tile, (x0, x1, y0, y1). Warp w holds pixels 32 w .. 32 w + 31 in row-
    major order: the rows of its first and last pixel, and the whole tile's
    width unless they share a row."""
    P = tile_px * tile_px
    first = torch.arange(0, P, 32)
    last = torch.clamp(first + 32, max=P) - 1
    r0, r1 = first // tile_px, last // tile_px
    same = r0 == r1
    c0 = torch.where(same, first % tile_px, 0)
    c1 = torch.where(same, last % tile_px, tile_px - 1)
    return torch.stack([c0, c1, r0, r1], -1).double() + 0.5


def _round_out(lo: torch.Tensor, hi: torch.Tensor):
    """float64 bounds -> float32 bounds rounded outward (toward -inf and
    +inf), as __double2float_rd and __double2float_ru give them."""
    lo_f, hi_f = lo.float(), hi.float()
    lo_f = torch.where(lo_f.double() > lo, torch.nextafter(lo_f, torch.full_like(lo_f, -np.inf)), lo_f)
    hi_f = torch.where(hi_f.double() < hi, torch.nextafter(hi_f, torch.full_like(hi_f, np.inf)), hi_f)
    return lo_f, hi_f


def composite_cull(payload: torch.Tensor, tile_px: int, tiles_x: int) -> torch.Tensor:
    """(tiles, K, 16) payload -> (tiles, K) int64 cull bits, K2's rule: bit w
    of row j is set unless no pixel centre of warp w's rectangle can meet
    row j with alpha >= 1/255 (see the constants above)."""
    p = payload.detach().double()
    mx, my, a, b, c, op = (p[..., i] for i in range(6))
    rect = warp_rects(tile_px).to(p.device)
    nw = rect.shape[0]
    every = (1 << nw) - 1
    finite = torch.isfinite(p[..., :6]).all(-1)
    dead = op * OPACITY_SLACK < MIN_ALPHA
    det = a * c - b * b
    inv = 1.0 / det
    skew = (a + c) ** 2 * inv
    box_ok = (a > 0) & (c > 0) & (det > 0) & (skew < MAX_SKEW)
    q = torch.clamp(2.0 * (torch.log(op / MIN_ALPHA) + POWER_SLACK), min=0.0) \
        / (1.0 - QUAD_SLACK * skew)
    hx = torch.sqrt(q * c * inv) * (1.0 + 1e-9) + 1e-6
    hy = torch.sqrt(q * a * inv) * (1.0 + 1e-9) + 1e-6
    # the box rounded outward to float32, tested against the float32
    # pixel-centre rectangles
    x0, x1 = _round_out(mx - hx, mx + hx)
    y0, y1 = _round_out(my - hy, my + hy)
    t = torch.arange(p.shape[0], device=p.device)
    origin = torch.stack([(t % tiles_x) * tile_px, (t // tiles_x) * tile_px], -1)
    r = (rect[None] + origin[:, None, [0, 0, 1, 1]].double()).float()  # (tiles, warps, 4)
    r = r[:, None]  # against (tiles, K, 1)
    x0, x1, y0, y1 = (v[..., None] for v in (x0, x1, y0, y1))
    live = ~((x1 < r[..., 0]) | (x0 > r[..., 1]) | (y1 < r[..., 2]) | (y0 > r[..., 3]))
    bits = (live.long() << torch.arange(nw, device=p.device)).sum(-1)
    bits = torch.where(box_ok, bits, every)
    bits = torch.where(dead, 0, bits)
    return torch.where(finite, bits, every)


def composite_walk(payload: torch.Tensor, image_shape: tuple, tile_px: int,
                   background: torch.Tensor, chunk: int):
    """K2 in the kernel's order, in plain float32 PyTorch: each tile takes
    its rows chunk by chunk while any of its pixels is live; each warp walks
    the rows whose cull bit it holds (`composite_cull`), in order; each
    pixel blends with T *= 1 - alpha and stops once T < 1e-4. -> (rgb
    (H, W, 3), depth (H, W), alpha = 1 - T_final (H, W))."""
    H, W = image_shape
    tiles, K, _ = payload.shape
    pix = _tile_pixel_centers(image_shape, tile_px, payload.device)
    px, py = pix[..., 0], pix[..., 1]  # (tiles, P)
    warp = torch.arange(tile_px * tile_px, device=payload.device) // 32
    bits = composite_cull(payload, tile_px, -(-W // tile_px))
    trans = torch.ones_like(px)
    rgbd = payload.new_zeros(*px.shape, 4)
    done = (px > W) | (py > H)  # pixels of ragged edge tiles
    for c0 in range(0, K, chunk):
        tile_live = ~done.all(1, keepdim=True)
        for j in range(c0, c0 + chunk):
            row = payload[:, j, None]  # (tiles, 1, 16)
            listed = ((bits[:, j, None] >> warp) & 1).bool()
            dx, dy = px - row[..., 0], py - row[..., 1]
            power = -0.5 * (row[..., 2] * dx * dx + row[..., 4] * dy * dy) \
                - row[..., 3] * dx * dy
            a = torch.clamp(row[..., 5] * torch.exp(torch.clamp(power, max=0.0)),
                            max=0.99)
            use = tile_live & listed & ~done & ~(power > 0) & ~(a < 1.0 / 255.0)
            w = torch.where(use, trans * a, 0.0)
            rgbd = rgbd + w[..., None] * row[..., 6:10]
            trans = torch.where(use, trans * (1.0 - a), trans)
            done = done | (use & (trans < 1e-4))
    rgb = rgbd[..., :3] + trans[..., None] * background.to(rgbd.dtype)
    return tuple(stitch_tiles(x, image_shape, tile_px)
                 for x in (rgb, rgbd[..., 3], 1.0 - trans))


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


def _forward(payload, background, image_shape, tile_px, chunk):
    """K2's operator: the kernel on a CUDA payload, `composite_reference` on
    a CPU one."""
    H, W = image_shape
    return torch.ops.vicasplat.composite(payload, background, H, W, tile_px, chunk)


class _Composite(torch.autograd.Function):
    """Forward: K2 (CUDA) or its plain version (CPU). Backward: a recompute
    through the plain matmul compositing, as the JAX package's custom_vjp
    does, to the payload and the background."""

    @staticmethod
    def forward(ctx, payload, background, image_shape, tile_px, chunk):
        ctx.save_for_backward(payload, background)
        ctx.cfg = (image_shape, tile_px, chunk)
        return _forward(payload, background, image_shape, tile_px, chunk)

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
    if torch.is_grad_enabled() and (payload.requires_grad or background.requires_grad):
        return _Composite.apply(payload, background, image_shape, tile_px, chunk)
    # no gradient: the same forward without the autograd function's host cost
    return _forward(payload, background, image_shape, tile_px, chunk)
