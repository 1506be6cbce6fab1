"""K3's layouts and walk on the CPU: the weights as `repack_weights` lays
them out for the kernel's TMA loads, and `dpt_tail_tiled`, which walks the
kernel's order over them (128-pixel tiles, 64-channel chunks, 9 taps from a
shifted window, zeros wherever a coordinate falls outside the image),
against the JAX package's XLA reference and its Pallas kernel run
interpreted. The kernel itself runs only on a card (tests/test_torch_gpu.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicasplat_tpu.ops.dpt_tail import _xla_tail
from vicasplat_tpu.ops.dpt_tail import fused_dpt_tail as j_fused_dpt_tail
from vicasplat_tpu_torch.kernels.dpt_tail import (
    TILE_PX,
    dpt_tail_tiled,
    out_slices,
    repack_weights,
)

torch.set_num_threads(1)

# float32 on both sides; the 3x3 conv sums 9 * C products per output in
# other orders (the JAX package's own test of its kernel uses 2e-4)
TAIL_TOL = 2e-4


def _inputs(N, H, W, C, Fd, O, seed=0):
    """JAX layouts: a, m (N, H, W, C); w1 (3, 3, C, F); w2 (F, O)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    a, m = f(N, H, W, C), np.maximum(f(N, H, W, C), 0)
    return a, m, f(3, 3, C, Fd) / np.sqrt(9 * C), f(Fd), f(Fd, O) / np.sqrt(Fd), f(O)


def _tiled(a, m, w1, b1, w2, b2):
    t = torch.from_numpy
    packed = repack_weights(t(np.ascontiguousarray(w1.transpose(3, 2, 0, 1))), t(b1),
                            t(np.ascontiguousarray(w2.T)), t(b2))
    return dpt_tail_tiled(t(a), None if m is None else t(m), packed, w2.shape[1]).numpy()


def test_repacked_layout():
    """w1 row tap * F + f holds w1[f, :, dy, dx] with tap = 3 dy + dx, C
    innermost; w2 and b2 gain zero rows up to whole output slices."""
    g = torch.Generator().manual_seed(0)
    Fd, C, O = 128, 64, 83
    w1, b1 = torch.randn(Fd, C, 3, 3, generator=g), torch.randn(Fd, generator=g)
    w2, b2 = torch.randn(O, Fd, 1, 1, generator=g), torch.randn(O, generator=g)
    p = repack_weights(w1, b1, w2, b2)
    assert p.w1t.shape == (9 * Fd, C) and p.w1t.is_contiguous()
    for dy in range(3):
        for dx in range(3):
            tap = 3 * dy + dx
            assert torch.equal(p.w1t[tap * Fd:(tap + 1) * Fd], w1[:, :, dy, dx])
    assert (p.os_n, p.n_os) == (96, 1)
    assert torch.equal(p.w2p[:O], w2.reshape(O, Fd)) and not p.w2p[O:].any()
    assert torch.equal(p.b2p[:O], b2) and not p.b2p[O:].any()
    assert p.b1f.dtype == torch.float32 and torch.equal(p.b1f, b1)
    assert repack_weights(w1, None, w2, None).b1f.abs().sum() == 0


@pytest.mark.parametrize("O,want", [(8, (32, 1)), (83, (96, 1)), (128, (128, 1)),
                                    (200, (128, 2)), (256, (128, 2))])
def test_out_slices(O, want):
    """One wgmma width of 32, 64, 96 or 128 channels, or slices of 128."""
    assert out_slices(O) == want


@pytest.mark.parametrize("with_m", [True, False])
@pytest.mark.parametrize("N,H,W,C,Fd,O", [
    (1, 5, 140, 64, 128, 83),    # ragged W: a second tile of 12 pixels; odd H
    (2, 3, 130, 64, 256, 24),    # a tile of 2 pixels; F = 256 in one slice
    (1, 7, 20, 128, 384, 200),   # one partial tile; F and O in slices
])
def test_tiled_matches_jax_xla_tail(with_m, N, H, W, C, Fd, O):
    a, m, w1, b1, w2, b2 = _inputs(N, H, W, C, Fd, O)
    m = m if with_m else None
    ref = _xla_tail(jnp.asarray(a), None if m is None else jnp.asarray(m),
                    jnp.asarray(w1), jnp.asarray(b1[None]), jnp.asarray(w2),
                    jnp.asarray(b2[None]))
    got = _tiled(a, m, w1, b1, w2, b2)
    assert got.shape == (N, H, W, O)
    np.testing.assert_allclose(got, np.asarray(ref), atol=TAIL_TOL, rtol=TAIL_TOL)


@pytest.mark.parametrize("with_m", [True, False])
def test_tiled_matches_jax_pallas_interpreted(with_m):
    """Against the Pallas kernel, interpreted on the CPU as
    tests/test_dpt_tail.py runs it, at an H its band height 8 divides and a
    W of one full and one 8-pixel tile; O padded to its 128 lanes there."""
    N, H, W, C, Fd, O = 1, 8, TILE_PX + 8, 64, 128, 83
    a, m, w1, b1, w2, b2 = _inputs(N, H, W, C, Fd, O, seed=1)
    m = m if with_m else None
    w2p = np.zeros((Fd, 128), np.float32)
    w2p[:, :O] = w2
    b2p = np.zeros((1, 128), np.float32)
    b2p[0, :O] = b2
    ref = j_fused_dpt_tail(jnp.asarray(a), None if m is None else jnp.asarray(m),
                           jnp.asarray(w1), jnp.asarray(b1[None]), jnp.asarray(w2p),
                           jnp.asarray(b2p), 8)[..., :O]
    got = _tiled(a, m, w1, b1, w2, b2)
    np.testing.assert_allclose(got, np.asarray(ref), atol=TAIL_TOL, rtol=TAIL_TOL)
