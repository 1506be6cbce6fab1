"""Tile binning and alpha compositing (port of
vicasplat_tpu/ops/rasterize/tiles.py).

1. Binning: each projected splat emits up to KH*KW (key, id) entries for the
   tiles its 3-sigma rect overlaps (a window centred on the rect when the
   rect is larger). A key packs tile << depth_shift | depth bits; the JAX
   package sorts uint32 keys, which torch cannot sort, so the same bit
   layout sits in int64. One sort orders every tile front to back; each
   tile keeps its front-most K entries as rows of a packed (N, 16) payload.
   Origin binning (`bin_splats_origin`) sorts each splat once, by the tile
   at its window's origin, and merges each tile's KH*KW neighbour segments
   with the bitonic top-K (kernel K4).
2. Compositing: per chunk of G splats over a tile's P pixels, the
   transmittance prefix is an exclusive cumulative sum of log(1 - alpha),
   taken as a matmul with a strictly-upper-triangular matrix; weights
   T * alpha accumulate colour and depth by a second matmul.
"""
from __future__ import annotations

import torch

from ...kernels.bitonic_topk import bitonic_topk, from_u32_bits, to_u32_bits
from .projection import Splats

# packed payload columns (16 f32 per splat):
#  0: mean2d.x  1: mean2d.y  2: conic.a  3: conic.b  4: conic.c
#  5: alpha     6: color.r   7: color.g  8: color.b  9: depth  10-15: pad
PAYLOAD_COLS = 16


def pack_payload(splats: Splats) -> torch.Tensor:
    n = splats.mean2d.shape[0]
    cols = torch.stack(
        [splats.mean2d[:, 0], splats.mean2d[:, 1], splats.conic[:, 0],
         splats.conic[:, 1], splats.conic[:, 2], splats.alpha,
         splats.color[:, 0], splats.color[:, 1], splats.color[:, 2],
         splats.depth],
        dim=-1,
    )
    pad = cols.new_zeros(n, PAYLOAD_COLS - cols.shape[1])
    return torch.cat([cols, pad], dim=-1)


# The packed row gather (JAX `tiles.py:63-145`): each splat's row packs
# into eight f32 words, mean, conic and depth exact and (alpha, r), (g, b)
# as bf16 pairs in one word each, so a gathered row is 32 bytes instead of
# 64. Only alpha and colour round to bf16. The backward is the plain
# gather's adjoint (a row scatter-add), so gradients are those of the
# unpacked path at the rounded forward.

def _pack2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two f32 -> one f32 word holding (bf16(a) << 16) | bf16(b)."""
    ha = a.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    hb = b.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    return ((ha << 16) | hb).view(torch.float32)


def _unpack2(w: torch.Tensor):
    u = w.contiguous().view(torch.int32)

    def half(bits):
        return bits.to(torch.int16).view(torch.bfloat16).float()

    return half((u >> 16) & 0xFFFF), half(u & 0xFFFF)


def _pack_words(payload: torch.Tensor) -> torch.Tensor:
    """(N, 16) f32 payload -> (N, 8) f32 words."""
    p = payload
    return torch.stack([p[:, 0], p[:, 1], p[:, 2], p[:, 3], p[:, 4], p[:, 9],
                        _pack2(p[:, 5], p[:, 6]), _pack2(p[:, 7], p[:, 8])], -1)


def _unpack_words(rows: torch.Tensor) -> torch.Tensor:
    """(..., 8) f32 words -> (..., 16) payload rows."""
    alpha, r = _unpack2(rows[..., 6])
    g, b = _unpack2(rows[..., 7])
    pad = torch.zeros_like(rows[..., 0])
    return torch.stack([rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3],
                        rows[..., 4], alpha, r, g, b, rows[..., 5]] + [pad] * 6, -1)


class _PackedRowGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, payload, ids):
        ctx.save_for_backward(ids)
        ctx.n = payload.shape[0]
        return _unpack_words(_pack_words(payload)[ids])

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        c = g.shape[-1]
        gp = g.new_zeros(ctx.n, c).index_add_(0, ids.reshape(-1), g.reshape(-1, c))
        return gp, None


def packed_row_gather(payload: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """payload (N, 16) f32, ids (T, K) -> (T, K, 16) rows, alpha and colour
    rounded to bf16."""
    return _PackedRowGather.apply(payload, ids)


def _gather_rows(splats: Splats, ids: torch.Tensor, packed: bool) -> torch.Tensor:
    table = pack_payload(splats)
    return packed_row_gather(table, ids) if packed else table[ids]


# Both binnings sort int64 keys: the tile above 32 bits of depth order (the
# depth's bits, or its rank). JAX packs them into u32 keys, which leave
# 32 - tile_bits bits of the depth.
DEPTH_SHIFT = 32


def _tile_grid(image_shape: tuple, tile_px: int):
    """-> (tiles_y, tiles_x)."""
    H, W = image_shape
    return -(-H // tile_px), -(-W // tile_px)


def _windows(splats: Splats, th: int, tw: int, tile_px: int, dup_hw: tuple):
    """Each splat's window of at most KH x KW tiles, centred on its 3-sigma
    rect -> (wy0, wx0, ty1, tx1, live)."""
    KH, KW = dup_hw
    mx, my = splats.mean2d[:, 0], splats.mean2d[:, 1]
    r = splats.radius
    inv_t = 1.0 / tile_px

    def tile_of(x, hi):
        return torch.floor(x * inv_t).clamp(0, hi).long()

    tx0, tx1 = tile_of(mx - r, tw - 1), tile_of(mx + r, tw - 1)
    ty0, ty1 = tile_of(my - r, th - 1), tile_of(my + r, th - 1)
    ctx, cty = tile_of(mx, tw - 1), tile_of(my, th - 1)
    wx0 = torch.minimum(torch.maximum(ctx - (KW - 1) // 2, tx0),
                        torch.maximum(tx1 - KW + 1, tx0))
    wy0 = torch.minimum(torch.maximum(cty - (KH - 1) // 2, ty0),
                        torch.maximum(ty1 - KH + 1, ty0))
    return wy0, wx0, ty1, tx1, r > 0


def _depth_bits(splats: Splats) -> torch.Tensor:
    # positive float32 bits order like the floats
    depth = splats.depth.float().clamp(min=1e-6)
    return depth.view(torch.int32).long()


def _segments(sorted_key, num_tiles, length):
    """[starts, ends) of each tile's run of sorted keys, and the clamped
    start of a `length`-wide window over it."""
    tile_keys = torch.arange(num_tiles, device=sorted_key.device,
                             dtype=torch.long) << DEPTH_SHIFT
    starts = torch.searchsorted(sorted_key, tile_keys, side="left")
    ends = torch.searchsorted(sorted_key, tile_keys + (1 << DEPTH_SHIFT),
                              side="left")
    return starts, ends, starts.clamp(max=length)


def bin_splats(splats: Splats, image_shape: tuple, tile_px: int,
               dup_hw: tuple, max_per_tile: int,
               packed_gather: bool = False) -> torch.Tensor:
    """-> payload (num_tiles, K, 16); alpha is 0 on empty slots.
    packed_gather gathers 32-byte packed rows (`packed_row_gather`)."""
    th, tw = _tile_grid(image_shape, tile_px)
    num_tiles = th * tw
    n = splats.mean2d.shape[0]
    KH, KW = dup_hw
    dev = splats.mean2d.device
    wy0, wx0, ty1, tx1, live = _windows(splats, th, tw, tile_px, dup_hw)
    # the keys hold all 32 bits of the depth, so entries sort in exact depth
    # order, as the CUDA rasterizer's 64-bit keys do; in JAX's u32 keys
    # depths within 2^-17 of each other tie and composite in any order
    depth_bits = _depth_bits(splats)
    sentinel = num_tiles << DEPTH_SHIFT

    keys = []
    for dy in range(KH):
        for dx in range(KW):
            tyy, txx = wy0 + dy, wx0 + dx
            ok = (tyy <= ty1) & (txx <= tx1) & live
            key = ((tyy * tw + txx) << DEPTH_SHIFT) | depth_bits
            keys.append(torch.where(ok, key, torch.full_like(key, sentinel)))
    key = torch.cat(keys)  # (KH * KW * N,), slot-major as in JAX
    sorted_key, order = torch.sort(key)
    sorted_idx = order % n  # splat id of each sorted entry

    # each tile's front-K ids are a contiguous run of sorted_idx; a run that
    # would pass the end shifts back and masks the positions before `starts`
    L = n * KH * KW
    if L < max_per_tile:  # fewer entries than one tile holds: pad dead ids
        sorted_idx = torch.cat([sorted_idx,
                                sorted_idx.new_zeros(max_per_tile - L)])
        L = max_per_tile
    starts, ends, starts_i = _segments(sorted_key, num_tiles, L - max_per_tile)
    pos = starts_i[:, None] + torch.arange(max_per_tile, device=dev)[None, :]
    slot_valid = (pos >= starts[:, None]) & (pos < ends[:, None])
    payload = _gather_rows(splats, sorted_idx[pos], packed_gather)  # (tiles, K, 16)
    payload[..., 5] *= slot_valid.to(payload.dtype)
    return payload


U32_FULL = 0xFFFFFFFF


def bin_splats_origin(splats: Splats, image_shape: tuple, tile_px: int,
                      dup_hw: tuple, max_per_tile: int,
                      packed_gather: bool = False) -> torch.Tensor:
    """Origin binning, with `bin_splats`'s payload contract.

    One sort of N (origin tile | depth rank) keys, whose index word carries a
    bitmap of the window slots inside the splat's rect above the splat id.
    Tile t's candidates are the front S = K entries of the KH*KW segments
    whose origin is t - (dy, dx) and whose bit (dy, dx) is set; each is a
    u32 word (rank | candidate slot), and the bitonic top-K (K4) keeps the
    K nearest. As in JAX, a segment is capped at K before the merge. The
    port orders by each splat's rank in the exact global depth order, not
    by its depth bits: the sort key holds the rank whole, and a merged word
    keeps its top 32 - log2(m) bits, all of it while the rank fits them
    (n <= 2^18 at dup (4, 4) and K 1024). JAX's words keep that many bits
    of the depth itself, so its splats within 2^-9 to 2^-12 of each
    other's depth tie and composite in an arbitrary order.
    """
    th, tw = _tile_grid(image_shape, tile_px)
    num_tiles = th * tw
    n = splats.mean2d.shape[0]
    KH, KW = dup_hw
    n_slots = KH * KW
    idx_bits = max(n - 1, 1).bit_length()
    if idx_bits + n_slots > 32:
        raise ValueError(f"{n} splats x {n_slots} window slots don't fit a "
                         "packed u32 index")
    dev = splats.mean2d.device
    wy0, wx0, ty1, tx1, live = _windows(splats, th, tw, tile_px, dup_hw)
    rank = torch.empty(n, dtype=torch.long, device=dev)
    rank[torch.argsort(splats.depth)] = torch.arange(n, device=dev)

    valid_bits = torch.zeros(n, dtype=torch.long, device=dev)
    for dy in range(KH):
        for dx in range(KW):
            ok = (wy0 + dy <= ty1) & (wx0 + dx <= tx1) & live
            valid_bits |= ok.long() << (dy * KW + dx)
    origin = wy0 * tw + wx0
    sentinel = num_tiles << DEPTH_SHIFT
    key = torch.where(valid_bits > 0, (origin << DEPTH_SHIFT) | rank,
                      torch.full_like(origin, sentinel))
    pidx = (valid_bits << idx_bits) | torch.arange(n, device=dev)
    sorted_key, order = torch.sort(key)
    sorted_pidx = pidx[order]

    S = max_per_tile
    L = n
    if L < S:  # tiny scene: pad with keys past every tile, dead ids
        sorted_key = torch.cat([sorted_key, sorted_key.new_full((S - L,), sentinel)])
        sorted_pidx = torch.cat([sorted_pidx, sorted_pidx.new_zeros(S - L)])
        L = S
    starts, ends, starts_i = _segments(sorted_key, num_tiles, L - S)
    pos = starts_i[:, None] + torch.arange(S, device=dev)[None, :]
    in_seg = (pos >= starts[:, None]) & (pos < ends[:, None])
    seg_key, seg_pidx = sorted_key[pos], sorted_pidx[pos]  # (num_tiles, S)

    # merged candidate width, padded to a power of two for the bitonic net
    m = 1 << (n_slots * S - 1).bit_length()
    slot_bits = m.bit_length() - 1
    dkeep = 32 - slot_bits  # rank bits kept in the merged word
    seg_depth = (seg_key & U32_FULL) >> max(idx_bits - dkeep, 0)
    idx_mask = (1 << idx_bits) - 1

    t_idx = torch.arange(num_tiles, device=dev)
    tyy, txx = t_idx // tw, t_idx % tw
    slot = torch.arange(S, device=dev)[None, :]
    words, ids = [], []
    for dy in range(KH):
        for dx in range(KW):
            oy, ox = tyy - dy, txx - dx
            in_grid = (oy >= 0) & (ox >= 0)
            o = oy.clamp(min=0) * tw + ox.clamp(min=0)
            p_o = seg_pidx[o]
            ok = (in_grid[:, None] & in_seg[o]
                  & (((p_o >> (idx_bits + dy * KW + dx)) & 1) > 0))
            word = (seg_depth[o] << slot_bits) | (len(words) * S + slot)
            words.append(torch.where(ok, word, torch.full_like(word, U32_FULL)))
            ids.append(p_o & idx_mask)
    cand = torch.cat(words, dim=1)  # (num_tiles, n_slots * S)
    cand_id = torch.cat(ids, dim=1)
    if cand.shape[1] < m:
        cand = torch.cat([cand, cand.new_full((num_tiles, m - cand.shape[1]),
                                              U32_FULL)], dim=1)

    # every word is within 32 bits by construction: K4 takes their patterns
    merged = from_u32_bits(bitonic_topk(to_u32_bits(cand), max_per_tile))
    slot_valid = merged != U32_FULL
    src = (merged & (m - 1)).clamp(max=cand_id.shape[1] - 1)
    payload = _gather_rows(splats, torch.gather(cand_id, 1, src), packed_gather)
    payload[..., 5] *= slot_valid.to(payload.dtype)
    return payload


def _tile_pixel_centers(image_shape, tile_px, device) -> torch.Tensor:
    """(num_tiles, P, 2) pixel-centre coordinates per tile."""
    H, W = image_shape
    th, tw = -(-H // tile_px), -(-W // tile_px)
    ty, tx = torch.meshgrid(torch.arange(th, device=device),
                            torch.arange(tw, device=device), indexing="ij")
    oy, ox = torch.meshgrid(torch.arange(tile_px, device=device),
                            torch.arange(tile_px, device=device), indexing="ij")
    px = tx.reshape(-1, 1) * tile_px + ox.reshape(1, -1) + 0.5
    py = ty.reshape(-1, 1) * tile_px + oy.reshape(1, -1) + 0.5
    return torch.stack([px, py], dim=-1).float()


def _composite_group(payload: torch.Tensor, pix: torch.Tensor, chunk: int):
    """One group of tiles: payload (T, K, 16), pix (T, P, 2) -> rgb (T, P, 3),
    depth (T, P), alpha sum (T, P), final transmittance (T, P)."""
    T_, K, _ = payload.shape
    P = pix.shape[1]
    if K % chunk:
        raise ValueError("max_per_tile must be a multiple of chunk")
    tri = torch.triu(torch.ones(chunk, chunk, device=payload.device), diagonal=1)
    log_t = payload.new_zeros(T_, P)
    rgbd = payload.new_zeros(T_, P, 4)
    asum = payload.new_zeros(T_, P)
    px, py = pix[:, :, None, 0], pix[:, :, None, 1]
    for c0 in range(0, K, chunk):
        pl = payload[:, c0:c0 + chunk]
        dx = px - pl[:, None, :, 0]  # (T, P, G)
        dy = py - pl[:, None, :, 1]
        power = (-0.5 * (pl[:, None, :, 2] * dx * dx + pl[:, None, :, 4] * dy * dy)
                 - pl[:, None, :, 3] * dx * dy)
        a = torch.clamp(pl[:, None, :, 5] * torch.exp(power.clamp(max=0.0)),
                        max=0.99)
        a = torch.where((power > 0.0) | (a < 1.0 / 255.0), torch.zeros_like(a), a)
        logom = torch.log1p(-a)
        w = torch.exp(log_t[:, :, None] + logom @ tri) * a  # blending weights
        rgbd = rgbd + w @ pl[:, :, 6:10]
        asum = asum + w.sum(-1)
        log_t = log_t + logom.sum(-1)
    return rgbd[..., :3], rgbd[..., 3], asum, torch.exp(log_t)


def composite_tiles(payload: torch.Tensor, image_shape: tuple, tile_px: int,
                    background: torch.Tensor, chunk: int = 128,
                    tile_group: int = 64):
    """Full image -> (rgb (H, W, 3), depth (H, W), alpha (H, W)). Tiles go
    in groups of `tile_group` to bound the (T, P, G) intermediates."""
    num_tiles = payload.shape[0]
    pix = _tile_pixel_centers(image_shape, tile_px, payload.device)
    chunk = min(chunk, payload.shape[1])
    tile_group = min(tile_group, num_tiles)
    while num_tiles % tile_group:
        tile_group -= 1
    parts = [_composite_group(payload[g:g + tile_group], pix[g:g + tile_group],
                              chunk)
             for g in range(0, num_tiles, tile_group)]
    rgb, dep, asum, t_final = (torch.cat(x) for x in zip(*parts))
    rgb = rgb + t_final[..., None] * background.to(rgb.dtype)
    return tuple(stitch_tiles(x, image_shape, tile_px) for x in (rgb, dep, asum))


def stitch_tiles(x: torch.Tensor, image_shape: tuple, tile_px: int) -> torch.Tensor:
    """(num_tiles, P, ...) per-tile pixels -> (H, W, ...) image, cropped."""
    H, W = image_shape
    th, tw = -(-H // tile_px), -(-W // tile_px)
    c = x.shape[2:]
    x = x.reshape(th, tw, tile_px, tile_px, *c).transpose(1, 2)
    return x.reshape(th * tile_px, tw * tile_px, *c)[:H, :W]
