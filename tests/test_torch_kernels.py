"""The port's kernels K2, K3 and K4 on CPU tensors (their plain versions,
and the autograd functions around them) against the JAX package's Pallas
kernels run interpreted, in float32. The kernels themselves run only on a
card: tests/test_torch_gpu.py holds them against these plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vicasplat_tpu.ops.dpt_tail import fused_dpt_tail as j_fused_dpt_tail
from vicasplat_tpu.ops.rasterize.pallas_bitonic import bitonic_topk_u32
from vicasplat_tpu.ops.rasterize.pallas_composite import composite_tiles_pallas
from vicasplat_tpu.ops.rasterize.tiles import TileBins
from vicasplat_tpu_torch.kernels import bitonic_topk, fused_dpt_tail
from vicasplat_tpu_torch.kernels.bitonic_topk import (
    bitonic_topk_pruned_walk,
    from_u32_bits,
    to_u32_bits,
)
from vicasplat_tpu_torch.ops.rasterize.pallas_composite import (
    MIN_ALPHA,
    composite_cull,
    composite_tiles_kernel,
    composite_walk,
    dense_payload,
    warp_rects,
)

torch.set_num_threads(1)

# float32 on both sides; the 3x3 conv sums 9 * C products per output in
# other orders (the JAX package's own test of its kernel uses 2e-4)
TAIL_TOL = 2e-4
# gradients through the recompute: the same convs' transposes, relative to
# the largest entry
TAIL_GRAD_TOL = 1e-4
# the JAX kernel stops a tile at a chunk boundary once all its pixels have
# T < 1e-4, the plain version never: at most 1e-4 of a feature (<= 5 here)
# is dropped, plus the log-space sums in other orders
EXIT_TOL = 1e-4 * 5 + 1e-5


@pytest.mark.parametrize("rows,m,keep", [(130, 256, 64), (4, 2048, 512)])
def test_topk_matches_jax_bitonic(rows, m, keep):
    """Exact, on full-range u32 words (ties and the top bit included)."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, (rows, m), dtype=np.uint64)
    words[:, : m // 4] = words[:, :1]  # repeated words
    words[0, :4] = [0, 2 ** 32 - 1, 2 ** 31, 2 ** 31 - 1]
    ref = jax.jit(lambda x: bitonic_topk_u32(x, keep, interpret=True))(
        jnp.asarray(words.astype(np.uint32)))
    got = bitonic_topk(to_u32_bits(torch.from_numpy(words.astype(np.int64))), keep)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(from_u32_bits(got).numpy(),
                                  np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("rows,m,keep", [(130, 256, 64), (4, 2048, 512),
                                         (6, 512, 512), (6, 512, 100), (6, 2, 1),
                                         (6, 2, 2)])
def test_topk_pruned_walk_matches_jax_bitonic(rows, m, keep):
    """K4's own network (runs of R sorted, then pruned) walked on the CPU,
    exactly equal to the JAX package's full network, interpreted; full-
    range words, repeated words and all-ones rows included."""
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2 ** 32, (rows, m), dtype=np.uint64)
    words[:, : m // 4] = words[:, :1]
    words[1] = 2 ** 32 - 1
    words[0, :2] = [2 ** 32 - 1, 2 ** 31]
    ref = jax.jit(lambda x: bitonic_topk_u32(x, keep, interpret=True))(
        jnp.asarray(words.astype(np.uint32)))
    got = bitonic_topk_pruned_walk(to_u32_bits(torch.from_numpy(words.astype(np.int64))),
                                   keep)
    assert got.dtype == torch.int32 and got.shape == (rows, keep)
    np.testing.assert_array_equal(from_u32_bits(got).numpy(),
                                  np.asarray(ref).astype(np.int64))


def test_u32_bits_round_trip():
    """The int32 carrier keeps all 32 bits, the top one included."""
    values = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
    bits = to_u32_bits(values)
    assert bits.dtype == torch.int32
    assert bits.tolist() == [0, 1, 2 ** 31 - 1, -2 ** 31, -1]
    assert torch.equal(from_u32_bits(bits), values)


@pytest.mark.parametrize("words,keep,exc", [
    (torch.zeros(2, 12, dtype=torch.int32), 4, ValueError),   # m not 2^k
    (torch.zeros(2, 16, dtype=torch.int64), 4, TypeError),    # not int32 bits
    (torch.zeros(2, 16, dtype=torch.int32), 17, ValueError),  # keep > m
    (torch.zeros(16, dtype=torch.int32), 4, ValueError),      # not 2-D
])
def test_topk_rejects_bad_input(words, keep, exc):
    with pytest.raises(exc):
        bitonic_topk(words, keep)


def _tail_inputs(N=2, H=32, W=32, C=128, Fd=128, O=128, seed=0):
    """The sizes of the JAX package's own kernel test (tests/test_dpt_tail.py)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    a, m = f(N, H, W, C), np.maximum(f(N, H, W, C), 0)
    w1 = f(3, 3, C, Fd) / np.sqrt(9 * C)  # JAX layout (dy, dx, C, F)
    w2 = f(Fd, O) / np.sqrt(Fd)
    return a, m, w1, f(Fd), w2, f(O)


def _jax_tail(a, m, w1, b1, w2, b2):
    """The JAX kernel, interpreted, with O padded to its 128 lanes."""
    O = w2.shape[1]
    o_pad = -(-O // 128) * 128
    w2p = np.zeros((w2.shape[0], o_pad), np.float32)
    w2p[:, :O] = w2
    b2p = np.zeros((1, o_pad), np.float32)
    b2p[0, :O] = b2
    out = j_fused_dpt_tail(jnp.asarray(a), None if m is None else jnp.asarray(m),
                           jnp.asarray(w1), jnp.asarray(b1[None]),
                           jnp.asarray(w2p), jnp.asarray(b2p), 8)
    return out[..., :O]


def _torch_args(a, m, w1, b1, w2, b2):
    t = torch.from_numpy
    return (t(a), None if m is None else t(m), t(np.ascontiguousarray(w1.transpose(3, 2, 0, 1))),
            t(b1), t(np.ascontiguousarray(w2.T)), t(b2))


@pytest.mark.parametrize("with_m,O", [(True, 128), (False, 128), (True, 83)])
def test_dpt_tail_matches_jax(with_m, O):
    a, m, w1, b1, w2, b2 = _tail_inputs(O=O)
    m = m if with_m else None
    ref = _jax_tail(a, m, w1, b1, w2, b2)
    got = fused_dpt_tail(*_torch_args(a, m, w1, b1, w2, b2))
    assert got.shape == (2, 32, 32, O)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TAIL_TOL,
                               rtol=TAIL_TOL)


@pytest.mark.parametrize("with_m", [True, False])
def test_dpt_tail_grads_match_jax(with_m):
    """Through the autograd function's recompute, against jax.grad through
    the JAX kernel's custom_vjp."""
    a, m, w1, b1, w2, b2 = _tail_inputs(N=1, H=16, W=16, seed=1)
    m = m if with_m else None
    g = np.random.default_rng(2).normal(size=(1, 16, 16, 128)).astype(np.float32)

    def jloss(a_, m_, w1_, b1_, w2_, b2_):
        out = j_fused_dpt_tail(a_, m_, w1_, b1_[None], w2_, b2_[None], 8)
        return (out * g).sum()

    jargs = [None if x is None else jnp.asarray(x) for x in (a, m, w1, b1, w2, b2)]
    argnums = (0, 1, 2, 3, 4, 5) if with_m else (0, 2, 3, 4, 5)
    gj = jax.grad(jloss, argnums=argnums)(*jargs)
    targs = [x.requires_grad_() if x is not None else None
             for x in _torch_args(a, m, w1, b1, w2, b2)]
    (fused_dpt_tail(*targs) * torch.from_numpy(g)).sum().backward()
    names = ("a", "m", "w1", "b1", "w2", "b2")
    layouts = {"w1": (3, 2, 0, 1), "w2": (1, 0)}  # JAX layout -> torch layout
    for i, j in zip(argnums, gj):
        j = np.asarray(j)
        if names[i] in layouts:
            j = j.transpose(layouts[names[i]])
        np.testing.assert_allclose(targs[i].grad.numpy(), j, rtol=0,
                                   atol=TAIL_GRAD_TOL * np.abs(j).max(),
                                   err_msg=names[i])


def test_composite_matches_jax_pallas_on_saturated_tiles():
    """K2's function with and without the early exit: the JAX kernel skips
    the last chunks of these tiles, the plain version composites them."""
    image_shape, tile_px, chunk = (16, 24), 8, 32
    payload = dense_payload(6, 128, tile_px, 3)
    bg = (0.1, 0.2, 0.3)
    ref = composite_tiles_pallas(TileBins(payload=jnp.asarray(payload.numpy())),
                                 image_shape, tile_px, bg, chunk)
    got = composite_tiles_kernel(payload, image_shape, tile_px, torch.tensor(bg),
                                 chunk)
    assert float(got[2].min()) > 1 - 1e-4  # every pixel saturates
    for name, a, b in zip(("color", "depth", "alpha"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=EXIT_TOL,
                                   rtol=0, err_msg=name)


def test_composite_rejects_bad_input():
    payload = torch.zeros(6, 128, 16)
    with pytest.raises(ValueError):  # K not a multiple of the chunk
        composite_tiles_kernel(payload, (16, 24), 8, torch.zeros(3), 48)
    with pytest.raises(ValueError):  # tile count of another image
        composite_tiles_kernel(payload, (16, 16), 8, torch.zeros(3), 32)


def _conic(l1, ratio, theta):
    """The conic of eigenvalues l1 and l1 * ratio, rotated by theta: (a, b, c)."""
    l2, co, si = l1 * ratio, np.cos(theta), np.sin(theta)
    return co * co * l1 + si * si * l2, co * si * (l1 - l2), si * si * l1 + co * co * l2


@st.composite
def _cull_case(draw):
    """A small payload of rows K2's cull may get wrong: thin rotated
    ellipses, opacity within an ulp of 1/255, conics that are not positive
    definite, NaN rows, and boxes that end just outside a warp's rectangle."""
    tile_px = draw(st.sampled_from([16, 8, 12]))
    rect = warp_rects(tile_px).numpy()
    ext = 2 * tile_px  # a 2 x 2 grid of tiles
    unit = st.floats(0, 1)
    rows = []
    for _ in range(draw(st.integers(1, 12))):
        kind = draw(st.sampled_from(["thin", "edge_opacity", "not_pd", "nan", "outside"]))
        mx, my = (draw(st.floats(-12, ext + 12)) for _ in range(2))
        a, b, c = _conic(10 ** draw(st.floats(-3, 1)), 10 ** draw(st.floats(-4, 0)),
                         np.pi * draw(unit))
        op = 10 ** draw(st.floats(-2.4, 0))
        if kind == "edge_opacity":
            op = draw(st.sampled_from([np.nextafter(np.float32(MIN_ALPHA), np.float32(0)),
                                       np.float32(MIN_ALPHA),
                                       np.nextafter(np.float32(MIN_ALPHA), np.float32(1))]))
            a, b, c = a * 1e-3, b * 1e-3, c * 1e-3  # wide: the opacity decides
        elif kind == "not_pd":
            b = np.sign(b or 1.0) * np.sqrt(a * c) * (1 + draw(st.floats(0, 1)))
            if draw(st.booleans()):
                a = -a
        elif kind == "nan":
            field = draw(st.integers(0, 5))
            mx, my, a, b, c, op = [np.nan if i == field else v
                                   for i, v in enumerate((mx, my, a, b, c, op))]
        elif kind == "outside":
            # the exact box of the live set, moved to end within 1e-3 px of
            # an edge of a warp's rectangle in tile 0
            q = 2 * np.log(np.float64(np.float32(op)) / MIN_ALPHA)
            det = a * c - b * b
            hx, hy = np.sqrt(q * c / det), np.sqrt(q * a / det)
            r = rect[draw(st.integers(0, len(rect) - 1))]
            side = draw(st.integers(0, 3))
            eps = draw(st.floats(-1e-3, 1e-3))
            if side == 0:
                mx = r[0] - hx - eps
            elif side == 1:
                mx = r[1] + hx + eps
            elif side == 2:
                my = r[2] - hy - eps
            else:
                my = r[3] + hy + eps
        row = np.zeros(16, np.float32)
        row[:6] = [mx, my, a, b, c, op]
        rows.append(row)
    return tile_px, np.stack(rows)


def _live(rows, px, py, dtype):
    """(rows, pixels) the plain per-pair test in `dtype`: power <= 0 and
    alpha = min(0.99, opacity exp(power)) >= 1/255."""
    r = torch.from_numpy(rows).to(dtype)[:, None]
    dx, dy = px.to(dtype)[None] - r[..., 0], py.to(dtype)[None] - r[..., 1]
    power = -0.5 * (r[..., 2] * dx * dx + r[..., 4] * dy * dy) - r[..., 3] * dx * dy
    a = torch.clamp(r[..., 5] * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
    return ~(power > 0) & ~(a < torch.tensor(1.0 / 255.0, dtype=torch.float32).to(dtype))


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(_cull_case())
def test_composite_cull_is_conservative(case):
    """No (row, warp rectangle) pair that K2's cull drops is live at any
    pixel centre of the rectangle, by the plain formula in float32 (as the
    kernel computes it) or in float64; the same rows are placed in each of
    the four tiles."""
    tile_px, rows = case
    payload = torch.from_numpy(np.stack([rows] * 4))
    bits = composite_cull(payload, tile_px, 2).numpy()
    rect = warp_rects(tile_px).numpy()
    for t in range(4):
        ox, oy = (t % 2) * tile_px, (t // 2) * tile_px
        for w, (x0, x1, y0, y1) in enumerate(rect):
            dropped = (bits[t] >> w) & 1 == 0
            if not dropped.any():
                continue
            gy, gx = torch.meshgrid(torch.arange(y0, y1 + 1) + oy,
                                    torch.arange(x0, x1 + 1) + ox, indexing="ij")
            for dtype in (torch.float32, torch.float64):
                live = _live(rows[dropped], gx.reshape(-1), gy.reshape(-1), dtype)
                assert not bool(live.any()), (t, w, rows[dropped][live.any(1).numpy()])


def _scene_payload(image_shape):
    """The origin-binned payload of test_torch_render's scene, one view, at
    its small sizes (tile_px 8, max_per_tile 64)."""
    from tests.test_torch_render import SMALL, cameras, scene
    from vicasplat_tpu_torch.geometry.se3 import rigid_inverse
    from vicasplat_tpu_torch.ops.rasterize import projection as tproj
    from vicasplat_tpu_torch.ops.rasterize.tiles import bin_splats_origin

    means, scales, quats, sh, opac = (torch.from_numpy(x) for x in scene())
    ext, K = cameras()
    splats = tproj.project_gaussians(
        means, tproj.cov6_from_scale_rot(scales, quats), sh, opac,
        rigid_inverse(torch.from_numpy(ext[1])), torch.from_numpy(K[1]), image_shape, 2)
    return bin_splats_origin(splats, image_shape, SMALL["tile_px"], SMALL["dup_hw"],
                             SMALL["max_per_tile"])


@pytest.mark.parametrize("which", ["dense", "scene square", "scene ragged"])
def test_composite_walk_matches_jax_pallas(which):
    """K2's order (chunks, each warp's surviving rows, each pixel's exit)
    walked on the CPU, against the JAX kernel interpreted: a dense payload
    whose tiles saturate, and test_torch_render's scene binned at its small
    sizes on a square and a ragged image."""
    from tests.test_torch_render import EXIT_TOL as RENDER_EXIT_TOL
    from tests.test_torch_render import SMALL

    if which == "dense":
        image_shape, tile_px, chunk = (16, 24), 8, 32
        payload = dense_payload(6, 128, tile_px, 3)
        tol = dict.fromkeys(("color", "depth", "alpha"), EXIT_TOL)
    else:
        image_shape = (32, 32) if which == "scene square" else (40, 56)
        tile_px, chunk = SMALL["tile_px"], SMALL["pallas_chunk"]
        payload = _scene_payload(image_shape)
        tol = RENDER_EXIT_TOL
    bg = (0.1, 0.2, 0.3)
    ref = composite_tiles_pallas(TileBins(payload=jnp.asarray(payload.numpy())),
                                 image_shape, tile_px, bg, chunk)
    got = composite_walk(payload, image_shape, tile_px, torch.tensor(bg), chunk)
    bits = composite_cull(payload, tile_px, -(-image_shape[1] // tile_px))
    assert float(got[2].max()) > 0.99
    if which != "dense":  # the cull drops rows here
        assert int((bits != (1 << len(warp_rects(tile_px))) - 1).sum()) > 0
    for name, a, b in zip(("color", "depth", "alpha"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol[name], rtol=0,
                                   err_msg=name)

