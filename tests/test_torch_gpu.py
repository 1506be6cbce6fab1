"""Kernel tests that need a CUDA card: each kernel against its plain version.

They skip where there is no card. On the card they run without the JAX
conftest: `python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py`.
"""
import copy
import math
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from vicasplat_tpu_torch.kernels import (
    attention_reference,
    bitonic_topk,
    composite_launch,
    dpt_tail_reference,
    flash_attention,
    fused_dpt_tail,
    topk_reference,
)
from vicasplat_tpu_torch.ops.rasterize.pallas_composite import (
    composite_reference,
    composite_tiles_kernel,
    dense_payload,
)
from vicasplat_tpu_torch.kernels.dpt_tail import shift_probe
from vicasplat_tpu_torch.kernels.flash_attn import (
    _forward,
    attention_backward_reference,
    attention_lse_reference,
    flash_attention_backward,
)
from vicasplat_tpu_torch.models import heads
from vicasplat_tpu_torch.ops.rasterize.tiles import composite_tiles

pytestmark = pytest.mark.gpu

# bf16 output: a half ulp is 2^-9 relative, and P enters the second product
# rounded to bf16, so |err| stays below ~1e-2 for outputs of order 1
FLASH_TOL = 2e-2
# K2 against its plain version: the kernel multiplies T by 1 - alpha where
# the plain version sums log1p in float32 matmuls, and stops a pixel at
# T < 1e-4; what it drops is at most 1e-4 of a feature (< 5 here)
COMPOSITE_TOL = 1e-4 * 5 + 1e-4
# K3 against its float32 plain version with the same roundings, relative
# to the largest output: the two float32 sums run in other orders, so an
# output (or an element of h) near a bf16 rounding midpoint may round one
# ulp apart, at most 2^-7 = 7.8e-3 of the largest output
TAIL_TOL = 1e-2
# gradients through K2's recompute against the plain compositing: the same
# function summed in other orders, relative to the largest entry
GRAD_TOL = 1e-3
# K1's backward against the float32 gradient of the plain attention, each
# of dQ, dK and dV relative to its largest entry: at most twice the error
# of SDPA's bf16 backward against the same reference, plus this floor (P
# and dS enter the products rounded to bf16, 2^-9 relative)
FLASH_BWD_FLOOR = 2e-3
# K1's row log-sum-exp against float32 logsumexp of the same bf16 inputs:
# both sum float32 products, in other orders
LSE_TOL = 1e-3
# K1's float32 route against the float32 plain versions, relative to each
# tensor's largest entry: the kernels take each float32 product as three
# TF32 products (within about 2^-22 of it) and sum in float32 in other
# orders over up to 333 keys and 128 dims, and their exp2 is within 2 ulp;
# 1e-4 leaves an order of magnitude over that, fails a single TF32 product
# (3e-4 to 1e-3, tests/test_torch_flash_f32_split.py) and a wrong mask,
# scale or layout, which move entries by their own size
F32_TOL = 1e-4
# the _tiny_smoke widths in float32 on the card against the CPU, relative
# to each output's largest entry: float32 on both sides summed in other
# orders through 6 blocks, the DPT heads and the exp map of the means (the
# port holds the JAX package to 2e-4 at these widths on the CPU)
TINY_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(shape_q, sk, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    b, sq, h, d = shape_q
    q = torch.randn(b, sq, h, d, generator=g, device=device).bfloat16()
    k = torch.randn(b, sk, h, d, generator=g, device=device).bfloat16()
    v = torch.randn(b, sk, h, d, generator=g, device=device).bfloat16()
    return q, k, v


@pytest.mark.parametrize(
    "shape_q,sk",
    [((1, 2056, 12, 64), 2064),   # decoder joint attention
     ((8, 257, 16, 64), 257),     # encoder attention
     ((2, 77, 12, 64), 130),      # ragged tiles on both axes
     ((1, 68, 6, 64), 72)],       # the synthetic_pose checkpoint's decoder
)
def test_flash_matches_plain(cuda, shape_q, sk):
    q, k, v = _qkv(shape_q, sk, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_reference(q, k, v)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    err = (out.float() - ref).abs().max().item()
    assert err < FLASH_TOL, err


def test_flash_rejects_what_it_cannot_run(cuda):
    """A head dim past 128, a non-contiguous tensor and a dtype neither
    route takes raise; nothing falls back. bf16 at a head dim other than 64
    runs the float32 route's kernels."""
    q, k, v = _qkv((1, 64, 2, 64), 64, cuda)
    q32, k32, v32 = _qkv((1, 64, 2, 32), 64, cuda)
    before = (flash_attention.launches, flash_attention.f32_launches)
    out = flash_attention(q32, k32, v32)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.f32_launches) == \
        (before[0], before[1] + 1)
    assert out.dtype == torch.bfloat16 and out.shape == q32.shape
    with pytest.raises(ValueError):
        flash_attention(*(torch.cat([x, x, x[..., :2]], -1) for x in (q, k, v)))
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(ValueError):
        flash_attention(*(x.float().transpose(1, 2) for x in (q, k, v)))
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    # a tensor that needs a gradient runs the backward kernels
    before = flash_attention_backward.launches
    flash_attention(q.requires_grad_(), k, v).float().sum().backward()
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == before + 1
    assert q.grad is not None and torch.isfinite(q.grad).all()


@pytest.mark.parametrize(
    "shape_q,sk",
    [((2, 2056, 12, 64), 2064),   # decoder joint attention at batch 2
     ((16, 257, 16, 64), 257),    # encoder attention
     ((2, 200, 12, 64), 137)],    # ragged tiles, Sq > Sk
)
def test_flash_backward_matches_plain(cuda, shape_q, sk):
    """dQ, dK, dV through the kernels against the float32 autograd gradient
    of the plain attention, within twice SDPA's bf16 error plus a floor;
    the forward's log-sum-exp against float32 logsumexp."""
    q, k, v = _qkv(shape_q, sk, cuda)
    g = torch.Generator(device=cuda).manual_seed(9)
    do = torch.randn(q.shape, generator=g, device=cuda).bfloat16()

    def grads(fn, *xs):
        xs = [x.detach().clone().requires_grad_() for x in xs]
        return torch.autograd.grad(fn(*xs), xs, do.to(fn(*xs).dtype))

    ref = grads(attention_reference, *(x.float() for x in (q, k, v)))
    before = flash_attention_backward.launches
    got = grads(flash_attention, q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == before + 1
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    lib = grads(lambda a, b, c: t(F.scaled_dot_product_attention(t(a), t(b), t(c))),
                q, k, v)
    for name, a, b, r in zip("qkv", got, lib, ref):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        scale = r.abs().max().item()
        err = (a.float() - r).abs().max().item() / scale
        err_lib = (b.float() - r).abs().max().item() / scale
        assert err <= 2 * err_lib + FLASH_BWD_FLOOR, (name, err, err_lib)
    lse = _forward(q, k, v, with_lse=True)[1]
    err = (lse - attention_lse_reference(q, k)).abs().max().item()
    assert err < LSE_TOL, err


def _rel(a, ref):
    return ((a - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize(
    "shape_q,sk,dtype",
    [((2, 12, 4, 12), 15, torch.float32),    # the _tiny_smoke decoder's joint attention
     ((2, 77, 4, 16), 130, torch.float32),   # heads of its encoder's width, ragged
     ((2, 200, 3, 12), 137, torch.float32),  # Sq > Sk, both ragged against 32-row tiles
     ((1, 300, 2, 64), 333, torch.float32),  # the flagship's head dim in float32
     ((1, 40, 2, 128), 70, torch.float32),   # the widest head the route takes
     # bf16 at head dims other than 64, upcast to the float32 route
     ((2, 77, 4, 32), 130, torch.bfloat16),
     ((1, 300, 2, 96), 333, torch.bfloat16)],
)
def test_flash_f32_matches_plain(cuda, shape_q, sk, dtype):
    """The float32 route (F3, 3xTF32 wgmma): forward, lse and backward
    against the float32 plain versions, within F32_TOL of each tensor's
    largest entry in float32; bf16 under the bf16 rules above (FLASH_TOL,
    LSE_TOL, twice SDPA's bf16 backward error plus FLASH_BWD_FLOOR)."""
    q, k, v = (x.to(dtype) for x in _qkv(shape_q, sk, cuda))
    g = torch.Generator(device=cuda).manual_seed(9)
    do = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    before = (flash_attention.f32_launches, flash_attention_backward.f32_launches)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*xs)
    got = torch.autograd.grad(out, xs, do)
    torch.cuda.synchronize()
    assert (flash_attention.f32_launches, flash_attention_backward.f32_launches) \
        == (before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and out.shape == q.shape
    ref = attention_reference(q, k, v)
    o, lse = _forward(q, k, v, with_lse=True)
    lse_err = (lse - attention_lse_reference(q, k)).abs().max().item()
    ref_grads = attention_backward_reference(q, k, v, ref,
                                             attention_lse_reference(q, k), do)
    if dtype == torch.float32:
        assert _rel(out, ref) < F32_TOL
        assert lse_err < F32_TOL
        for name, a, r in zip("qkv", got, ref_grads):
            assert a.dtype == torch.float32 and a.shape == r.shape
            assert _rel(a, r) < F32_TOL, name
        return
    assert (out.float() - ref).abs().max().item() < FLASH_TOL
    assert lse_err < LSE_TOL, lse_err
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    lib = torch.autograd.grad(t(F.scaled_dot_product_attention(*(t(y) for y in ys))),
                              ys, do)
    for name, a, b, r in zip("qkv", got, lib, ref_grads):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        scale = r.abs().max().item()
        err = (a.float() - r).abs().max().item() / scale
        err_lib = (b.float() - r).abs().max().item() / scale
        assert err <= 2 * err_lib + FLASH_BWD_FLOOR, (name, err, err_lib)


def test_tiny_smoke_float32_on_card(cuda):
    """F3 end to end: the widths of configs/experiment/_tiny_smoke.yaml in
    float32 (decoder heads of 12, through K1's float32 route) run a forward
    and one training step on the card; the forward agrees with the same
    weights on the CPU, where attention takes the plain version."""
    from vicasplat_tpu_torch.models import vicasplat_forward
    from vicasplat_tpu_torch.training import AdamW, make_train_step
    from vicasplat_tpu_torch.training.presets import (tiny_smoke_config,
                                                      tiny_smoke_model,
                                                      tiny_smoke_views)

    cfg = tiny_smoke_config()
    g = torch.Generator().manual_seed(0)
    model_cpu = tiny_smoke_model(cfg, g)
    model = copy.deepcopy(model_cpu).to(cuda)
    context, target = tiny_smoke_views(g, 3), tiny_smoke_views(g, 2)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # float32 convs in full float32
    try:
        with torch.no_grad():
            before = flash_attention.f32_launches
            out = vicasplat_forward(model, {k: x.to(cuda) for k, x in context.items()},
                                    dtype=torch.float32)
            torch.cuda.synchronize()
            assert flash_attention.f32_launches == before + 4  # one a decoder block
            ref = vicasplat_forward(model_cpu, context, dtype=torch.float32)
        for name, a, r in (("means", out["gaussians"].means, ref["gaussians"].means),
                           ("opacities", out["gaussians"].opacities,
                            ref["gaussians"].opacities),
                           ("poses", out["gaussian_camera_extrins"],
                            ref["gaussian_camera_extrins"])):
            assert torch.isfinite(a).all(), name
            assert _rel(a.cpu(), r) < TINY_TOL, (name, _rel(a.cpu(), r))

        step = make_train_step(cfg, model, AdamW(model, cfg.optimizer))
        batch = {"context": {k: x.to(cuda) for k, x in context.items()},
                 "target": {k: x.to(cuda) for k, x in target.items()}}
        before = (flash_attention.f32_launches, flash_attention_backward.f32_launches,
                  flash_attention.launches, flash_attention_backward.launches)
        logs = step(batch, 1)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    after = (flash_attention.f32_launches, flash_attention_backward.f32_launches,
             flash_attention.launches, flash_attention_backward.launches)
    assert [a - b for a, b in zip(after, before)] == [4, 4, 0, 0]
    assert all(math.isfinite(float(v)) for v in logs.values()), logs
    assert int(step.nonfinite) == 0


def test_topk_matches_plain(cuda):
    """Exact: the flagship's shape and a small one, full-range u32 words."""
    g = torch.Generator(device=cuda).manual_seed(3)
    for rows, m, keep in ((256, 2048, 512), (3, 64, 64)):
        words = torch.randint(-2 ** 31, 2 ** 31, (rows, m), generator=g,
                              device=cuda, dtype=torch.int32)
        words[:, : m // 4] = words[:, :1]
        before = bitonic_topk.launches
        out = bitonic_topk(words, keep)
        torch.cuda.synchronize()
        assert bitonic_topk.launches == before + 1
        assert torch.equal(out, topk_reference(words, keep))


@pytest.mark.parametrize("m", [2, 64, 2048, 32768])
@pytest.mark.parametrize("keep", ["1", "100", "m/4", "m"])
def test_topk_pruned_matches_sort(cuda, m, keep):
    """The pruned network in registers, shuffles and shared memory, exact
    against torch.sort: full-range words, repeated words and an all-ones
    row, at one warp (m <= 64), the flagship's m and the largest m."""
    keep = {"1": 1, "100": min(100, m), "m/4": max(1, m // 4), "m": m}[keep]
    g = torch.Generator(device=cuda).manual_seed(m + keep)
    rows = 3 if m == 32768 else 40
    words = torch.randint(-2 ** 31, 2 ** 31, (rows, m), generator=g, device=cuda,
                          dtype=torch.int32)
    words[1, : max(1, m // 2)] = words[1, :1]  # repeated words
    words[2] = -1  # 0xFFFFFFFF, the binning's empty slot
    before = bitonic_topk.launches
    out = bitonic_topk(words, keep)
    torch.cuda.synchronize()
    assert bitonic_topk.launches == before + 1
    assert torch.equal(out, topk_reference(words, keep))


def test_topk_rejects_what_it_cannot_run(cuda):
    words = torch.zeros(4, 64, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):  # values in int64, not their 32-bit patterns
        bitonic_topk(words.long(), 8)
    with pytest.raises(ValueError):
        bitonic_topk(torch.zeros(64, 4, dtype=torch.int32, device=cuda).t(), 8)
    with pytest.raises(ValueError):
        bitonic_topk(torch.zeros(2, 2 ** 16, dtype=torch.int32, device=cuda), 8)


@pytest.mark.parametrize("image_shape,tile_px,K,chunk",
                         [((256, 256), 16, 512, 128), ((40, 56), 8, 64, 32)])
def test_composite_matches_plain(cuda, image_shape, tile_px, K, chunk):
    """The flagship's tile grid, and a ragged image with cropped edge tiles."""
    th, tw = -(-image_shape[0] // tile_px), -(-image_shape[1] // tile_px)
    payload = dense_payload(th * tw, K, tile_px, tw, device=cuda)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    before = composite_launch.launches
    out = composite_tiles_kernel(payload, image_shape, tile_px, bg, chunk)
    torch.cuda.synchronize()
    assert composite_launch.launches == before + 1
    ref = composite_reference(payload, image_shape, tile_px, bg, chunk)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        err = (a - b).abs().max().item()
        assert err < COMPOSITE_TOL, err


def _covering_payload(device):
    """The origin-binned payload of frame 0 of the synthetic generator's
    scene 0 (64 x 64, 3,072 Gaussians) at the default tile sizes."""
    from vicasplat_tpu_torch.data import synthetic_scenes as scenes
    from vicasplat_tpu_torch.geometry.se3 import rigid_inverse
    from vicasplat_tpu_torch.ops.rasterize.projection import (
        cov6_from_scale_rot,
        project_gaussians,
    )
    from vicasplat_tpu_torch.ops.rasterize.tiles import bin_splats_origin

    cfg = scenes.SyntheticScenesConfig()
    rng = scenes.scene_rng(0, cfg)
    g = {k: torch.from_numpy(v).to(device) for k, v in
         scenes.scene_gaussians(rng, cfg).items()}
    ext = torch.from_numpy(scenes.scene_trajectory(rng, cfg)[0]).to(device)
    K = torch.from_numpy(scenes.intrinsics_for(cfg)).to(device)
    splats = project_gaussians(g["means"], cov6_from_scale_rot(g["scales"], g["rotations"]),
                               g["harmonics"], g["opacities"], rigid_inverse(ext), K,
                               cfg.input_image_shape, 0)
    return bin_splats_origin(splats, cfg.input_image_shape, 16, (2, 2), 512)


@pytest.mark.parametrize("which", ["sparse", "dense", "not positive definite",
                                   "ragged", "covering scene"])
def test_composite_cull_cases_match_plain(cuda, which):
    """K2 with its per-warp cull against the plain version: low opacities
    (most rows culled), a dense payload (none), rows whose conic is not
    positive definite (kept for every warp), a ragged image of 8-pixel
    tiles, and a small covering scene; two calls are bit-identical. The
    tolerance is COMPOSITE_TOL's rule for this payload's largest feature
    (the covering scene's depths reach 6)."""
    image_shape, tile_px, K, chunk = (64, 64), 16, 512, 128
    if which == "ragged":
        image_shape, tile_px, K, chunk = (40, 56), 8, 64, 32
    th, tw = -(-image_shape[0] // tile_px), -(-image_shape[1] // tile_px)
    if which == "covering scene":
        payload = _covering_payload(cuda)
    else:
        payload = dense_payload(th * tw, K, tile_px, tw, seed=2, device=cuda)
    if which == "sparse":
        payload[..., 5] *= 0.01
    elif which == "not positive definite":
        b = torch.sqrt(payload[::3, ::5, 2] * payload[::3, ::5, 4])
        payload[::3, ::5, 3] = b * 1.5  # indefinite: power > 0 along some lines
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    before = composite_launch.launches
    out = composite_tiles_kernel(payload, image_shape, tile_px, bg, chunk)
    again = composite_tiles_kernel(payload, image_shape, tile_px, bg, chunk)
    torch.cuda.synchronize()
    assert composite_launch.launches == before + 2
    ref = composite_reference(payload, image_shape, tile_px, bg, chunk)
    if which == "covering scene":
        assert float(out[2].mean()) > 0.8
    tol = 1e-4 * max(payload[..., 6:10].abs().max().item(), 1.0) + 1e-4
    for a, a2, b in zip(out, again, ref):
        assert a.shape == b.shape
        assert torch.equal(a, a2)
        err = (a - b).abs().max().item()
        assert err < tol, (err, tol)


def test_composite_grads_with_learnable_background(cuda):
    """A background that needs a gradient still goes through the kernel,
    and the payload's and the background's gradients match the plain
    compositing's."""
    image_shape, tile_px, K, chunk = (40, 56), 8, 64, 32
    th, tw = -(-image_shape[0] // tile_px), -(-image_shape[1] // tile_px)
    payload = dense_payload(th * tw, K, tile_px, tw, seed=1, device=cuda)
    payload[..., 5] *= 0.3  # translucent: the background shows through
    weights = [torch.rand(*s, device=cuda) for s in
               ((*image_shape, 3), image_shape, image_shape)]

    def grads(fn):
        p = payload.clone().requires_grad_()
        bg = torch.tensor([0.1, 0.2, 0.3], device=cuda, requires_grad=True)
        outs = fn(p, image_shape, tile_px, bg, chunk)
        sum((o * w).sum() for o, w in zip(outs, weights)).backward()
        return p.grad, bg.grad

    before = composite_launch.launches
    got = grads(composite_tiles_kernel)
    assert composite_launch.launches == before + 1
    ref = grads(lambda *a: composite_tiles(*a[:4], chunk=a[4]))
    assert composite_launch.launches == before + 1
    for name, a, b in zip(("payload", "background"), got, ref):
        assert b.abs().max() > 0, name
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err < GRAD_TOL, (name, err)


def test_composite_rejects_what_it_cannot_run(cuda):
    payload = torch.zeros(4, 64, 16, device=cuda)
    bg = torch.zeros(3, device=cuda)
    with pytest.raises(TypeError):
        composite_tiles_kernel(payload.double(), (16, 16), 8, bg, 32)
    with pytest.raises(ValueError):
        composite_tiles_kernel(torch.zeros(4, 16, 64, device=cuda).transpose(1, 2),
                               (16, 16), 8, bg, 32)
    with pytest.raises(ValueError):
        composite_tiles_kernel(torch.zeros(1, 64, 16, device=cuda), (64, 64), 64, bg, 32)


def _tail(device, N, H, W, C, Fd, O, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=device)  # noqa: E731
    bf = torch.bfloat16
    return (r(N, H, W, C).to(bf), r(N, H, W, C).relu().to(bf),
            (r(Fd, C, 3, 3) / (9 * C) ** 0.5).to(bf), r(Fd).to(bf),
            (r(O, Fd, 1, 1) / Fd ** 0.5).to(bf), r(O).to(bf))


@pytest.mark.parametrize("with_m", [True, False])
@pytest.mark.parametrize("N,H,W,C,Fd,O", [(2, 32, 256, 256, 256, 83),
                                          (1, 9, 200, 64, 128, 24),
                                          (3, 17, 300, 128, 256, 83)])
def test_dpt_tail_matches_plain(cuda, with_m, N, H, W, C, Fd, O):
    """The GS head's channels, a ragged row (W % 128 != 0, odd H) with
    F = 128, and 153 tiles: odd, so the last cluster's second block runs a
    tile it does not store, and not a multiple of the SMs, so the persistent
    blocks end unevenly (the multicast release at the schedule's tail)."""
    a, m, w1, b1, w2, b2 = _tail(cuda, N, H, W, C, Fd, O)
    m = m if with_m else None
    before = fused_dpt_tail.launches
    out = fused_dpt_tail(a, m, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fused_dpt_tail.launches == before + 1
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the reference in full float32
    try:
        ref = dpt_tail_reference(a, m, w1, b1, w2, b2).float()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert out.shape == (N, H, W, O) and out.dtype == torch.bfloat16
    err = (out.float() - ref).abs().max().item() / ref.abs().max().item()
    assert err < TAIL_TOL, err


def test_dpt_tail_rejects_what_it_cannot_run(cuda):
    a, m, w1, b1, w2, b2 = _tail(cuda, 1, 8, 16, 64, 128, 8)
    with pytest.raises(TypeError):
        fused_dpt_tail(a.float(), m.float(), w1, b1, w2, b2)
    with pytest.raises(ValueError):  # not channels-last contiguous
        fused_dpt_tail(a.transpose(1, 2), m.transpose(1, 2), w1, b1, w2, b2)
    # C = 48 is not a multiple of 64, one 128-byte TMA row of bf16 (the
    # kernel took multiples of 32 before its TMA design; the JAX gates send
    # multiples of 128)
    with pytest.raises(ValueError):
        fused_dpt_tail(a[..., :48].contiguous(), None, w1[:, :48], b1, w2, b2)
    with pytest.raises(ValueError):  # F = 64 has no kernel
        fused_dpt_tail(a, m, w1[:64], b1[:64], w2[:, :64], b2)
    # F = 384, a multiple of 128, is taken
    a, m, w1, b1, w2, b2 = _tail(cuda, 1, 8, 16, 128, 384, 8)
    assert fused_dpt_tail(a, m, w1, b1, w2, b2).shape == (1, 8, 16, 8)


@pytest.mark.parametrize("with_m", [True, False])
def test_dpt_tail_is_deterministic(cuda, with_m):
    """Two calls on the same inputs are bit-identical: each output is summed
    by one block in a fixed order, whatever block and SM run it."""
    a, m, w1, b1, w2, b2 = _tail(cuda, 3, 17, 300, 128, 256, 83, seed=3)
    m = m if with_m else None
    first = fused_dpt_tail(a, m, w1, b1, w2, b2)
    second = fused_dpt_tail(a, m, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_dpt_tail_shift_probe(cuda):
    """The dx shift: a wgmma A operand that starts 1-7 rows of 128 bytes
    past a 1024-byte boundary of a 128-byte-swizzled tile (the descriptor's
    base offset) gives x[r:r + 64] @ w.T. Products of bf16 are exact in
    float32; only the order of 64 sums differs."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(136, 64, generator=g, device=cuda).bfloat16()
    w = torch.randn(64, 64, generator=g, device=cuda).bfloat16()
    out = shift_probe(x, w)
    torch.cuda.synchronize()
    for r in range(8):
        ref = x[r:r + 64].float() @ w.float().T
        err = (out[r] - ref).abs().max().item() / ref.abs().max().item()
        assert err < 1e-5, (r, err)


def _tail_error(out, args):
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the reference in full float32
    try:
        ref = dpt_tail_reference(*args).float()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert out.shape == ref.shape
    return (out.float() - ref).abs().max().item() / ref.abs().max().item()


@pytest.mark.parametrize("N,H,W,C,Fd,O", [(1, 16, 64, 128, 128, 256),   # O = 256
                                          (1, 8, 136, 384, 384, 200)])  # F, O sliced
def test_dpt_tail_any_f_and_o(cuda, N, H, W, C, Fd, O):
    """F runs in slices of 128 and O above 128 in slices of 128, as the JAX
    gates send them: a regression tail with O = 256, and F = 384 with a
    ragged O = 200."""
    args = _tail(cuda, N, H, W, C, Fd, O)
    before = fused_dpt_tail.launches
    out = fused_dpt_tail(*args)
    torch.cuda.synchronize()
    assert fused_dpt_tail.launches == before + 1
    assert _tail_error(out, args) < TAIL_TOL


def test_dpt_gs_head_feature_dim_384(cuda):
    """dpt_gs_head with feature_dim = 384 and the fused tail: the JAX gate
    sends it to the kernel, which takes it, and it agrees with the same
    head through the plain tail."""
    cfg = heads.DPTConfig(hook_dims=(64, 64, 64, 64), layer_dims=(24, 48, 96, 192),
                          feature_dim=384, head_type="gs_params", num_channels=83,
                          use_input_merger=True, tail_backend="pallas")
    torch.manual_seed(0)
    mod = heads.DPT(cfg).to(cuda).bfloat16()
    g = torch.Generator(device=cuda).manual_seed(6)
    gh = 4
    hooks = [torch.randn(2, gh * gh, 64, generator=g, device=cuda).bfloat16()
             for _ in range(4)]
    imgs = torch.rand(2, 16 * gh, 16 * gh, 3, generator=g, device=cuda).bfloat16()
    with torch.no_grad():
        before = fused_dpt_tail.launches
        out = heads.dpt_gs_head(mod, hooks, (gh, gh), imgs, torch.bfloat16)
        torch.cuda.synchronize()
        assert fused_dpt_tail.launches == before + 1
        seen = []

        def plain(*args):
            seen.append(args)
            return dpt_tail_reference(*args)

        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False  # the plain tail in float32
        try:
            with mock.patch.object(heads, "fused_dpt_tail", plain):
                ref = heads.dpt_gs_head(mod, hooks, (gh, gh), imgs,
                                        torch.bfloat16)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    assert fused_dpt_tail.launches == before + 1 and len(seen) == 1
    assert out.shape == (2, 64, 64, 83)
    err = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    assert err < TAIL_TOL, err


_NPZ = "outputs/synthetic_pose/ckpt_committed/weights_latest.npz"
# the committed checkpoint in float32 on the card against the CPU, relative
# to each output's largest entry: float32 on both sides (convolutions
# without TF32), summed in other orders through 10 blocks and linear heads
TRAINED_TOL = 1e-3
# one scene through the accelerator render (K2, K4) against the default
# render, after 2 pose-alignment steps: chip_smoke.py's eval-accel limits
ACCEL_TOL = {"psnr": 0.05, "ssim": 0.002, "ate": 0.002}


def _pose_config(*extra):
    import pathlib

    from vicasplat_tpu_torch.utils.config import load_config

    root = pathlib.Path(__file__).resolve().parents[1]
    return load_config(root / "configs/main.yaml", "synthetic_pose", [
        "mode=test", "dataset.synthetic.n_scenes=4096",
        f"checkpointing.load={root / _NPZ}", *extra])


def test_committed_weights_on_card(cuda):
    """The committed float16 npz loaded onto the card: a float32 forward of
    4 frames of 64^2 through K1's float32 route agrees with the CPU."""
    from vicasplat_tpu_torch.main import build_model
    from vicasplat_tpu_torch.models import vicasplat_forward

    cfg = _pose_config()
    gpu, cpu = build_model(cfg, cuda), build_model(cfg, "cpu")
    assert all(p.device.type == "cuda" and p.dtype == torch.float32
               for p in gpu.parameters())
    g = torch.Generator().manual_seed(7)
    ctx = {"image": torch.rand(1, 4, 64, 64, 3, generator=g) * 2 - 1,
           "intrinsics": torch.tensor([[0.87, 0, 0.5], [0, 0.87, 0.5], [0, 0, 1]]
                                      ).expand(1, 4, 3, 3).contiguous()}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            before = flash_attention.f32_launches
            out = vicasplat_forward(gpu, {k: v.to(cuda) for k, v in ctx.items()},
                                    dtype=torch.float32)
            torch.cuda.synchronize()
            assert flash_attention.f32_launches == before + cfg.encoder.backbone.dec_depth
            ref = vicasplat_forward(cpu, ctx, dtype=torch.float32)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for name, a, r in (("means", out["gaussians"].means, ref["gaussians"].means),
                       ("opacities", out["gaussians"].opacities, ref["gaussians"].opacities),
                       ("poses", out["gaussian_camera_extrins"],
                        ref["gaussian_camera_extrins"])):
        assert _rel(a.cpu(), r) < TRAINED_TOL, (name, _rel(a.cpu(), r))


def test_one_scene_through_eval_accel(cuda, tmp_path):
    """main.test on synthetic_04100 with 2 alignment steps, in the default
    configuration and with K2 and K4 (decoder.rasterize.backend=pallas,
    binning=origin): K2 and K4 launch once a view in each of the 3 renders,
    K1 once a decoder block, and the scores agree."""
    from vicasplat_tpu_torch import main as tmain

    common = ("dataset.synthetic.n_test_scenes=1", "test.pose_align_steps=2")
    _, (ref,) = tmain.test(_pose_config(*common, f"test.output_path={tmp_path / 'd'}"),
                           device=cuda)
    cfg = _pose_config(*common, f"test.output_path={tmp_path / 'a'}",
                       "decoder.rasterize.backend=pallas", "decoder.rasterize.binning=origin")
    before = (composite_launch.launches, bitonic_topk.launches, flash_attention.launches)
    _, (got,) = tmain.test(cfg, device=cuda)
    torch.cuda.synchronize()
    after = (composite_launch.launches, bitonic_topk.launches, flash_attention.launches)
    assert [a - b for a, b in zip(after, before)] == [3 * 7, 3 * 7, 4]
    assert got["scene"] == ref["scene"] == "synthetic_04100"
    for k, tol in ACCEL_TOL.items():
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])
    assert (tmp_path / "a" / "synthetic_04100" / "compare.png").exists()


def test_train_loader_threads_on_card(cuda):
    """The train loader's producer thread renders its scenes on the card
    while this thread keeps the card busy: the batches equal the CPU
    loader's (scene ids and view indices exactly; frames within the
    rasterizer's card-to-CPU tolerance, 1e-4, but for rare pixels on the
    1/255 alpha cut, at most 2/255), land on the card, and close() leaves
    no thread behind."""
    import threading

    from vicasplat_tpu_torch.data.data_module import DataModule

    ds = {"synthetic": dict(name="synthetic", n_scenes=6, n_frames=8,
                            input_image_shape=[32, 32], n_gaussians=512,
                            view_sampler=dict(name="sequential", num_context_views=3,
                                              num_target_views=2,
                                              min_distance_between_context_views=1,
                                              max_distance_between_context_views=2))}
    loaders = {"train": {"batch_size": 2, "seed": 7, "prefetch": 2}}
    threads = set(threading.enumerate())
    gpu = DataModule(ds, loaders, device="cuda").train_dataloader()
    cpu = DataModule(ds, loaders, device="cpu").train_dataloader()
    x = torch.randn(2048, 2048, device="cuda")
    try:
        for _ in range(3):
            for _ in range(20):  # work queued on this thread's stream
                x = torch.tanh(x @ x / 2048)
            b, c = next(gpu), next(cpu)
            assert b["scene"] == c["scene"]
            for side in ("context", "target"):
                assert torch.equal(b[side]["index"].cpu(), c[side]["index"])
                img = b[side]["image"]
                assert img.device.type == "cuda"
                diff = (img.cpu() - c[side]["image"]).abs()
                assert diff.max() <= 2 / 255 and (diff > 1e-4).float().mean() <= 1e-3
    finally:
        gpu.close()
        cpu.close()
    assert torch.isfinite(x).all()
    assert not [t for t in set(threading.enumerate()) - threads if t.is_alive()]


# ---- the serving engine's captured programs ----

def _tiny_bf16_engine(accel: bool, device):
    """A tiny engine in bf16 at head dim 64 (K1's bf16 route), with the DPT
    heads' full widths (K3's gates) in the accelerator configuration."""
    import dataclasses

    from vicasplat_tpu_torch.decoder.splatting import DecoderSplattingConfig
    from vicasplat_tpu_torch.models import (
        GaussianAdapterConfig,
        VicaNetConfig,
        VicaSplatConfig,
    )
    from vicasplat_tpu_torch.ops.rasterize import RasterizeConfig
    from vicasplat_tpu_torch.serving import InferenceEngine

    cfg = VicaSplatConfig(
        backbone=VicaNetConfig(img_size=32, enc_embed_dim=128, enc_depth=2,
                               enc_num_heads=2, dec_embed_dim=128, dec_depth=4,
                               dec_num_heads=2),
        gaussian_adapter=GaussianAdapterConfig(sh_degree=2))
    dec = DecoderSplattingConfig()
    if accel:
        cfg = dataclasses.replace(cfg, head_tail_backend="pallas")
        dec = DecoderSplattingConfig(rasterize=RasterizeConfig(backend="pallas",
                                                               binning="origin"))
    return InferenceEngine(cfg, decoder=dec, device=device)


def _serving_inputs(device, B=1, T=3, V=3):
    g = torch.Generator().manual_seed(11)
    images = torch.rand(B, T, 32, 32, 3, generator=g)
    K = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]).expand(B, T, 3, 3)
    ext = torch.eye(4).repeat(B, V, 1, 1)
    ext[:, :, 2, 3] = torch.linspace(-6.0, -3.0, V)
    return (images.to(device), K.contiguous().to(device), ext.to(device),
            K[:, :1].expand(B, V, 3, 3).contiguous().to(device))


@pytest.mark.parametrize("accel", [False, True])
def test_engine_replay_equals_eager(cuda, accel):
    """The captured reconstruct and render replay the eager calls' results
    bit for bit, on a second input too, and count the kernels' launches at
    capture: K1 a decoder block, and in the accelerator configuration K3
    once and K2 and K4 once a view."""
    eng = _tiny_bf16_engine(accel, cuda)
    images, K, ext, tK = _serving_inputs(cuda)
    near, far = torch.full((1, 3), 0.05, device=cuda), torch.full((1, 3), 100.0, device=cuda)
    eager = eng._reconstruct_raw()
    render = eng._render_raw((32, 32))
    for step in range(2):
        x = images if step == 0 else images.flip(2)
        scene = eng.reconstruct(x, K)
        out = eng.render(scene, ext, tK, (32, 32))
        with torch.no_grad():
            g, poses, _ = eager(x, K)
            ref = render(g, ext, tK, near, far)
        assert torch.equal(scene.poses, poses)
        for a, b in zip(scene.gaussians, g):
            assert torch.equal(a, b)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    prog = eng._reconstruct_fn(images.shape, tuple(K.shape))
    rprog = next(iter(eng._render.items.values()))
    assert prog.calls == 2 and prog.graph is not None
    assert prog.launches == ({"flash_attn": 4, "dpt_tail": 1} if accel
                             else {"flash_attn": 4})
    assert rprog.launches == ({"composite": 3, "bitonic_topk": 3} if accel else {})
    # the SceneBatch of the first request survives the second
    s1 = eng.reconstruct(images, K)
    keep = s1.gaussians.means.clone()
    eng.reconstruct(images.flip(2), K)
    assert torch.equal(s1.gaussians.means, keep)


def test_engine_capture_failure_raises(cuda):
    """A forward that reads a value back to the host cannot be captured: the
    engine raises, and runs nothing eagerly in its place."""
    from vicasplat_tpu_torch import serving

    eng = _tiny_bf16_engine(False, cuda)
    images, K, _, _ = _serving_inputs(cuda)
    real = serving.vicasplat_forward

    def syncing(model, ctx, **kw):
        ctx["image"].sum().item()
        return real(model, ctx, **kw)

    with mock.patch.object(serving, "vicasplat_forward", syncing):
        with pytest.raises(RuntimeError):
            eng.reconstruct(images, K)
    assert eng._reconstruct_fn(images.shape, tuple(K.shape)).graph is None
    torch.cuda.synchronize()


@pytest.mark.parametrize("m,k,n", [(2056, 768, 2304), (8, 768, 4608)])
def test_int_mm_exact_at_flagship_linears(cuda, m, k, n):
    """torch._int_mm through quant._int8_matmul equals the exact int32
    product at the flagship decoder's qkv shape (2056 tokens) and at the
    camera tokens' modulation (8 rows, padded to 17)."""
    from vicasplat_tpu_torch.ops.quant import _int8_matmul

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    got = _int8_matmul(x, w)
    ref = (x.double() @ w.double().t()).to(torch.int32)  # exact below 2^53
    assert got.dtype == torch.int32 and torch.equal(got, ref)


def _op_cases(device):
    """Each kernel's operator with its inputs on the card: (name, call,
    tolerance of the CUDA result against the operator's CPU implementation
    on the same inputs relative to the largest entry, 0 meaning equal)."""
    g = torch.Generator(device=device).manual_seed(21)
    q, k, v = _qkv((1, 130, 2, 64), 97, device, seed=3)
    o, lse = torch.ops.vicasplat.flash_attn(q.cpu(), k.cpu(), v.cpu(), True)
    o, lse = o.to(device), lse.to(device)
    do = torch.randn(q.shape, generator=g, device=device).bfloat16()
    payload = dense_payload(16, 64, 8, 4, seed=2, device=device)
    bg = torch.tensor([0.1, 0.2, 0.3], device=device)
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (33, 256), generator=g, device=device,
                          dtype=torch.int32)
    tail = _tail(device, 1, 9, 200, 64, 128, 24)
    ops = torch.ops.vicasplat
    return [
        ("flash_attn", lambda *x: ops.flash_attn(*x, True), (q, k, v), FLASH_TOL),
        ("flash_attn_bwd", ops.flash_attn_bwd, (q, k, v, o, lse, do), FLASH_TOL),
        ("composite", lambda p, b: ops.composite(p, b, 32, 32, 8, 32), (payload, bg),
         COMPOSITE_TOL),
        ("dpt_tail", ops.dpt_tail, tail, TAIL_TOL),
        ("bitonic_topk", lambda w: ops.bitonic_topk(w, 16), (words,), 0.0),
    ]


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def test_custom_ops_match_plain_and_replay_under_capture(cuda):
    """Each kernel's custom operator on CUDA tensors against its plain
    version (the operator's CPU implementation on the same inputs); then
    captured in a CUDA graph, whose replay equals the eager call bit for bit
    and whose capture counted the kernel's launches once."""
    from vicasplat_tpu_torch.kernels import COUNTERS, launch_counts

    for name, call, args, tol in _op_cases(cuda):
        eager = _flat(call(*args))
        plain = _flat(call(*(a.cpu() for a in args)))
        for i, (a, b) in enumerate(zip(eager, plain)):
            assert a.device.type == "cuda" and a.shape == b.shape, (name, i)
            if tol == 0.0:
                assert torch.equal(a.cpu(), b), name
            else:
                err = ((a.float().cpu() - b.float()).abs().max()
                       / b.float().abs().max()).item()
                assert err < tol, (name, i, err)
        torch.cuda.synchronize()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = _flat(call(*args))
        after = launch_counts()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b), name
        moved = {k for k in COUNTERS if after[k] != before[k]}
        assert moved == {name} and after[name] == before[name] + 1, (name, moved)


def test_exported_tiny_program_launches_k1_f32(cuda, tmp_path):
    """A float32 artifact exported on the CPU and moved to the card
    (`load_exported(..., device="cuda")`) launches K1's float32 route once a
    decoder block, by torch.profiler's records and by the counter, and
    agrees with the CPU engine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vicasplat_tpu_torch import export
    from vicasplat_tpu_torch.models import GaussianAdapterConfig, VicaNetConfig, VicaSplatConfig
    from vicasplat_tpu_torch.serving import InferenceEngine

    cfg = VicaSplatConfig(
        backbone=VicaNetConfig(img_size=32, enc_embed_dim=64, enc_depth=2, enc_num_heads=4,
                               dec_embed_dim=48, dec_depth=4, dec_num_heads=4),
        gaussian_adapter=GaussianAdapterConfig(sh_degree=1))
    eng = InferenceEngine(cfg, dtype=torch.float32, device="cpu")
    export.save_exported(tmp_path / "t.pt2", export.export_reconstruct(
        eng, 1, 3, 32, 32, with_intrinsics=True))
    ep = export.load_exported(tmp_path / "t.pt2", device="cuda")
    images = torch.rand(1, 3, 32, 32, 3, generator=torch.Generator().manual_seed(4))
    K = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]).expand(1, 3, 3, 3)
    w = {k: v.to(cuda) for k, v in export.weights(eng).items()}
    prog = ep.module()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # float32 convs in full float32
    try:
        with torch.no_grad():
            prog(w, images.to(cuda), K.to(cuda))
            before = flash_attention.f32_launches
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = prog(w, images.to(cuda), K.to(cuda))
                torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert flash_attention.f32_launches == before + 4
    records = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and "f32_fwd_kernel" in e.key)
    assert records == 4
    ref = eng.reconstruct(images, K)
    for name in ("means", "opacities", "harmonics"):
        a, b = out["gaussians"][name].cpu(), getattr(ref.gaussians, name)
        assert ((a - b).abs().max() / b.abs().max()).item() < TINY_TOL, name
    assert (out["poses"].cpu() - ref.poses).abs().max().item() < TINY_TOL


# ---- the RE10K data path on the card's machine ----

# the port's JPEG round trip at quality 95 (4:2:0) of smooth frames, as a
# camera's are: at least this PSNR
JPEG_PSNR_MIN = 40.0


def test_codec_and_re10k_loader_on_card(cuda, tmp_path):
    """The port's host JPEG codec on the card's machine (built by g++ there,
    no PIL): an encode -> decode round trip of 360x640 frames at quality
    95 within JPEG_PSNR_MIN; then those files in a chunk through the re10k
    train loader, sharded over 2 workers, onto the card."""
    import json

    import numpy as np

    from vicasplat_tpu_torch.data.data_module import DataModule
    from vicasplat_tpu_torch.utils.host_image import decode_jpegs_u8, encode_jpegs

    n, h, w = 24, 360, 640
    y, x = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    t = np.arange(n)[:, None, None] / n
    frames = np.stack([128 + 100 * np.sin(6 * x + 3 * t), 128 + 90 * np.cos(5 * y - 2 * t),
                       128 + 80 * np.sin(4 * (x + y) + t)], -1)
    frames = np.clip(frames + np.random.default_rng(0).normal(0, 2, frames.shape), 0, 255)
    frames = frames.astype(np.uint8)
    files = encode_jpegs(frames, quality=95)
    back = decode_jpegs_u8(files)
    mse = np.mean((back.astype(np.float64) - frames) ** 2)
    assert 10 * np.log10(255 ** 2 / mse) >= JPEG_PSNR_MIN

    root = tmp_path / "re10k" / "train"
    root.mkdir(parents=True)
    c2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    c2w[:, 0, 3] = np.linspace(0, 1, n)
    cams = np.zeros((n, 18), np.float32)
    cams[:, :4] = (0.8, 1.4, 0.5, 0.5)
    cams[:, 6:] = np.linalg.inv(c2w)[:, :3].reshape(n, 12)
    torch.save([{"key": f"s{k}", "cameras": torch.from_numpy(cams),
                 "images": [torch.frombuffer(bytearray(f), dtype=torch.uint8) for f in files],
                 "url": "", "timestamps": torch.arange(n)} for k in range(2)],
               root / "000000.torch")
    (root / "index.json").write_text(json.dumps({"s0": "000000.torch", "s1": "000000.torch"}))
    ds = {"re10k": {"name": "re10k", "roots": [str(tmp_path / "re10k")],
                    "view_sampler": {"name": "sequential", "num_context_views": 3,
                                     "num_target_views": 2,
                                     "min_distance_between_context_views": 2,
                                     "max_distance_between_context_views": 4}}}
    loader = DataModule(ds, {"train": {"batch_size": 2, "num_workers": 2}},
                        device="cuda").train_dataloader()
    try:
        batch = next(loader)
    finally:
        loader.close()
    img = batch["context"]["image"]
    assert img.device.type == "cuda" and img.shape == (2, 3, 256, 256, 3)
    assert torch.isfinite(img).all() and sorted(batch["scene"]) == ["s0", "s1"]
