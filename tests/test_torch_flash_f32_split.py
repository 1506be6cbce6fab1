"""K1's float32 route on the CPU: `flash_f32_split_walk` repeats the
kernels' arithmetic (csrc/flash_attn_f32.cu: the tiles, TF32 rounding by
integer bit operations, three TF32 products per float32 product, the
online softmax in log2 and the transposed tiles' key order, forward and
backward) and is held here against the JAX package's sdpa and its
jax.vjp; the single-product walk is shown to miss, so the split is what
passes. Also the routing of a CUDA tensor by dtype and head dim."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicasplat_tpu.models.layers import sdpa as j_sdpa
from vicasplat_tpu_torch.kernels.flash_attn import (
    _walk_order,
    flash_f32_split_walk,
    route,
    tf32_rna,
)

torch.set_num_threads(1)

# relative to each tensor's largest entry. The 3xTF32 walk carries float32
# accuracy (each split product within about 2^-22 of the float32 product),
# and JAX computes in float32 at the highest matmul precision: both sum
# over up to 333 keys and 128 head dims in other orders, a few float32
# roundings (~1e-7 relative each) that stay well inside 1e-5. One TF32
# product per float32 product misses by 3e-4 to 6e-4 at these shapes, so
# 1e-5 tells the two apart by more than an order of magnitude
TOL = 1e-5
# the route's tolerance on the card (chip_smoke.py F32_TOL): a single TF32
# product must miss it, or the split would not be needed
F32_TOL = 1e-4

SHAPES = [((2, 12, 4, 12), 15),     # the _tiny_smoke decoder's joint attention
          ((2, 77, 4, 16), 130),    # its encoder's head width, ragged tiles
          ((1, 300, 2, 64), 333),   # the flagship's head dim, several tiles
          ((1, 40, 2, 128), 70)]    # the widest head the route takes


def _inputs(shape_q, sk, seed=0):
    rng = np.random.default_rng(seed)
    b, sq, h, d = shape_q
    q, do = (rng.normal(size=(b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, sk, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _jax(q, k, v, do):
    """(out, lse, dq, dk, dv) of the JAX sdpa, its VJP with cotangent do,
    and the row log-sum-exp of its scaled logits (B, H, Sq)."""
    out, vjp = jax.vjp(j_sdpa, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do))
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), jnp.asarray(k),
                   precision=jax.lax.Precision.HIGHEST) / np.sqrt(q.shape[-1])
    lse = jax.nn.logsumexp(s, axis=-1)
    return [np.asarray(x) for x in (out, lse, *grads)]


def _rel_errors(got, ref):
    return {name: float(np.abs(g.numpy() - r).max() / np.abs(r).max())
            for name, g, r in zip(("out", "lse", "dq", "dk", "dv"), got, ref)}


@pytest.mark.parametrize("shape_q,sk", SHAPES)
def test_split_walk_matches_jax(shape_q, sk):
    q, k, v, do = _inputs(shape_q, sk)
    got = flash_f32_split_walk(*(torch.from_numpy(x) for x in (q, k, v, do)))
    for g, x in zip(got, (q, None, q, k, v)):
        assert g.dtype == torch.float32
        if x is not None:
            assert g.shape == x.shape
    errs = _rel_errors(got, _jax(q, k, v, do))
    assert all(e < TOL for e in errs.values()), errs


def test_single_tf32_product_misses():
    """The same walk with one TF32 product per float32 product: at the
    flagship's head dim its largest error is above F32_TOL."""
    q, k, v, do = _inputs((1, 300, 2, 64), 333)
    got = flash_f32_split_walk(*(torch.from_numpy(x) for x in (q, k, v, do)),
                               products=1)
    errs = _rel_errors(got, _jax(q, k, v, do))
    assert max(errs.values()) > F32_TOL, errs


def test_tf32_rna_rounds_like_cvt_rna():
    """Ten mantissa bits, to nearest, ties away from zero; the split's two
    parts are TF32 and sum to x within 2^-22 of |x|."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0e-30, 0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 1.0, 3.0e-30, 0.0])
    got = tf32_rna(x)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    torch.testing.assert_close(got[:5], want[:5], rtol=0, atol=0)
    y = torch.from_numpy(np.random.default_rng(1).normal(size=4096).astype(np.float32))
    big = tf32_rna(y)
    small = tf32_rna(y - big)
    assert (small.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((big + small - y).abs() <= y.abs() * 2.0 ** -22).all()


def test_walk_key_order_pairs_fragments():
    """The transposed tiles' column c of each 8 holds key 2t for c = t and
    2t + 1 for c = t + 4 (t < 4): a thread's accumulators (keys 2t, 2t + 1)
    are the A fragment's columns t and t + 4."""
    order = _walk_order(32).tolist()
    assert sorted(order) == list(range(32))
    for i in range(4):
        for t in range(4):
            assert order[8 * i + t] == 8 * i + 2 * t
            assert order[8 * i + t + 4] == 8 * i + 2 * t + 1


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "bf16"),     # every bf16 configuration of the repo
    (torch.bfloat16, 32, "f32"),      # bf16 at another head dim: upcast
    (torch.bfloat16, 96, "f32"),
    (torch.bfloat16, 1, "f32"),
    (torch.bfloat16, 128, "f32"),
    (torch.float32, 64, "f32"),
    (torch.float32, 12, "f32"),       # the _tiny_smoke decoder
    (torch.float32, 128, "f32"),
    (torch.bfloat16, 130, ValueError),
    (torch.float32, 0, ValueError),
    (torch.float16, 64, TypeError),
    (torch.float64, 12, TypeError),
])
def test_route_by_dtype_and_head_dim(dtype, d, want):
    if isinstance(want, str):
        assert route(dtype, d) == want
    else:
        with pytest.raises(want):
            route(dtype, d)
