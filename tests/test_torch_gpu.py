"""Kernel tests that need a CUDA card: each kernel against its plain version.

They skip where there is no card. On the card they run without the JAX
conftest: `python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py`.
"""
import pytest
import torch

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
     ((2, 77, 12, 64), 130)],     # ragged tiles on both axes
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
    q, k, v = _qkv((1, 64, 2, 64), 64, cuda)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(NotImplementedError):
        flash_attention(q.requires_grad_(), k, v)


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
                                          (1, 9, 200, 64, 128, 24)])
def test_dpt_tail_matches_plain(cuda, with_m, N, H, W, C, Fd, O):
    """The GS head's channels, and a ragged row (W % 128 != 0, odd H) with
    F = 128."""
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
    with pytest.raises(ValueError):  # C = 48 is not a multiple of 32
        fused_dpt_tail(a[..., :48].contiguous(), None, w1[:, :48], b1, w2, b2)
    with pytest.raises(ValueError):  # F = 64 has no kernel
        fused_dpt_tail(a, m, w1[:64], b1[:64], w2[:, :64], b2)
