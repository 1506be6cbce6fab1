"""K1's backward on the CPU: the port differentiates its flash attention
there through the plain version, held against jax.grad of the JAX package's
attention; and the plain backward written from the kernels' formulas
(`attention_backward_reference`, from the row log-sum-exp) against autograd
of the plain forward. The plain versions are the yardstick of both kernel
routes, bf16 at head dim 64 and float32 at the tiny configuration's head
dims 12 and 16; the kernels themselves run only on a card
(tests/test_torch_gpu.py holds them against these)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicasplat_tpu.models.layers import sdpa as j_sdpa
from vicasplat_tpu_torch.kernels import attention_reference, flash_attention
from vicasplat_tpu_torch.kernels.flash_attn import (
    attention_backward_reference,
    attention_lse_reference,
)

torch.set_num_threads(1)

# float32 on both sides: the logits, softmax and both products of each
# gradient summed in other orders over <= 140 keys
TOL = 1e-5

SHAPES = [((2, 77, 3, 64), 130),   # Sq < Sk, ragged against 64-row tiles
          ((1, 200, 2, 64), 137),  # Sq > Sk
          ((2, 64, 4, 16), 64),    # square, another head dim
          # the float32 configuration configs/experiment/_tiny_smoke.yaml:
          # its decoder's joint attention (2 x 3 frames of 4 image tokens
          # against 3 x 5 with the camera tokens, heads of 48 / 4 = 12) and
          # heads of its encoder's width (64 / 4 = 16), Sq != Sk
          ((2, 12, 4, 12), 15),
          ((2, 37, 4, 16), 20)]


def _inputs(shape_q, sk, seed=0):
    rng = np.random.default_rng(seed)
    b, sq, h, d = shape_q
    q, do = (rng.normal(size=(b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, sk, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("shape_q,sk", SHAPES)
def test_flash_grad_matches_jax(shape_q, sk):
    """dQ, dK, dV of flash_attention on CPU tensors against jax.grad (VJP
    with the same cotangent) of the JAX sdpa."""
    q, k, v, do = _inputs(shape_q, sk)
    _, vjp = jax.vjp(j_sdpa, *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(jnp.asarray(do))
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = flash_attention(*xs)
    got = torch.autograd.grad(out, xs, torch.from_numpy(do))
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("shape_q,sk", SHAPES)
def test_backward_reference_matches_autograd(shape_q, sk):
    """The plain backward from o and the log-sum-exp gives autograd's
    gradients of attention_reference; the log-sum-exp is torch's."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(shape_q, sk, seed=1))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    o = attention_reference(*xs)
    ref = torch.autograd.grad(o, xs, do)
    lse = attention_lse_reference(q, k)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=TOL, atol=TOL)
    got = attention_backward_reference(q, k, v, o.detach(), lse, do)
    for name, a, b in zip("qkv", got, ref):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL, msg=f"d{name}")
