"""The port's kernels K2, K3 and K4 on CPU tensors (their plain versions,
and the autograd functions around them) against the JAX package's Pallas
kernels run interpreted, in float32. The kernels themselves run only on a
card: tests/test_torch_gpu.py holds them against these plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicasplat_tpu.ops.dpt_tail import fused_dpt_tail as j_fused_dpt_tail
from vicasplat_tpu.ops.rasterize.pallas_bitonic import bitonic_topk_u32
from vicasplat_tpu.ops.rasterize.pallas_composite import composite_tiles_pallas
from vicasplat_tpu.ops.rasterize.tiles import TileBins
from vicasplat_tpu_torch.kernels import bitonic_topk, fused_dpt_tail
from vicasplat_tpu_torch.kernels.bitonic_topk import from_u32_bits, to_u32_bits
from vicasplat_tpu_torch.ops.rasterize.pallas_composite import (
    composite_tiles_kernel,
    dense_payload,
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
