"""Building blocks (port of vicasplat_tpu/models/layers.py).

Weights live in PyTorch's own modules and layouts (nn.Linear (out, in),
nn.Conv2d OIHW, nn.ConvTranspose2d (in, out, kh, kw)); activations keep the
JAX package's layouts: channels last for images, (B, S, H, D) for attention.
Each function takes the compute dtype, as the JAX one does; layer norm
always computes in float32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import QuantLinear, linear_w8a8
from .moe import ExpertLinear


def _dtype(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


def linear(mod: nn.Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    if isinstance(mod, QuantLinear):  # int8-prepared (ops/quant.quantize_tree)
        return linear_w8a8(mod, x, dtype=dtype)
    dt = _dtype(x, mod.weight, dtype)
    b = None if mod.bias is None else mod.bias.to(dt)
    return F.linear(x.to(dt), mod.weight.to(dt), b)


def layernorm(mod: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with float32 statistics, returned in x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], mod.weight.float(),
                     mod.bias.float(), eps)
    return y.to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


def mlp(mod: Mlp, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """fc1 -> exact GELU -> fc2."""
    return linear(mod.fc2, F.gelu(linear(mod.fc1, x, dtype)), dtype)


def conv2d(mod: nn.Conv2d, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """NHWC conv with the module's stride and padding (padding k // 2 is the
    JAX package's SAME for odd kernels)."""
    dt = _dtype(x, mod.weight, dtype)
    b = None if mod.bias is None else mod.bias.to(dt)
    y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), mod.weight.to(dt), b,
                 stride=mod.stride, padding=mod.padding)
    return y.permute(0, 2, 3, 1)


def conv2d_patchify(mod: nn.Conv2d, x: torch.Tensor, patch: int,
                    dtype=None) -> torch.Tensor:
    """Non-overlapping patch x patch stride-patch conv as reshape + matmul.
    x (N, H, W, C) -> (N, H / patch, W / patch, O)."""
    dt = _dtype(x, mod.weight, dtype)
    n, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    xr = x.to(dt).reshape(n, gh, patch, gw, patch, c).transpose(2, 3)
    xr = xr.reshape(n, gh, gw, patch * patch * c)  # (py, px, c) order
    wm = mod.weight.to(dt).permute(0, 2, 3, 1).reshape(mod.out_channels, -1)
    b = None if mod.bias is None else mod.bias.to(dt)
    return F.linear(xr, wm, b)


def conv_transpose2d(mod: nn.ConvTranspose2d, x: torch.Tensor,
                     dtype=None) -> torch.Tensor:
    """NHWC transposed conv (the DPT up-projections: kernel == stride)."""
    dt = _dtype(x, mod.weight, dtype)
    b = None if mod.bias is None else mod.bias.to(dt)
    y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), mod.weight.to(dt), b,
                           stride=mod.stride)
    return y.permute(0, 2, 3, 1)


def _interp_matrix(in_size: int, out_size: int, dtype, device) -> torch.Tensor:
    if out_size == 1 or in_size == 1:
        return torch.full((out_size, in_size), 1.0 / in_size, dtype=dtype,
                          device=device)
    pos = (torch.arange(out_size, dtype=torch.float32, device=device)
           * (in_size - 1) / (out_size - 1))
    lo = pos.floor().long().clamp(0, in_size - 2)
    frac = pos - lo.float()
    rows = torch.arange(out_size, device=device)
    m = torch.zeros(out_size, in_size, dtype=torch.float32, device=device)
    m.index_put_((rows, lo), 1.0 - frac, accumulate=True)
    m.index_put_((rows, lo + 1), frac, accumulate=True)
    return m.to(dtype)


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: Sequence[int]) -> torch.Tensor:
    """NHWC bilinear resize with align_corners=True, as two separable
    interpolation matmuls (the JAX package's form)."""
    _, h, w, _ = x.shape
    wh = _interp_matrix(h, out_hw[0], x.dtype, x.device)
    ww = _interp_matrix(w, out_hw[1], x.dtype, x.device)
    y = torch.einsum("oh,nhwc->nowc", wh, x)
    return torch.einsum("pw,nowc->nopc", ww, y)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over (..., S, H, D) tensors as matmul, softmax and matmul.

    Logits in q's dtype, softmax in float32; mask broadcastable to
    (..., H, Sq, Sk), True = attend.
    """
    s = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = torch.where(mask, s, torch.full((), -1e30, dtype=s.dtype,
                                            device=s.device))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("...hqk,...khd->...qhd", p, v)


# ---------------------------------------------------------------------------
# initialization (the JAX package's distributions, drawn from a Generator)
# ---------------------------------------------------------------------------

@torch.no_grad()
def fill_uniform_(t: torch.Tensor, lo: float, hi: float,
                  gen: torch.Generator) -> None:
    t.copy_(torch.empty(t.shape, device=gen.device).uniform_(lo, hi,
                                                             generator=gen))


@torch.no_grad()
def fill_normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    t.copy_(torch.empty(t.shape, device=gen.device).normal_(0.0, std,
                                                            generator=gen))


def xavier_(t: torch.Tensor, fan_in: int, fan_out: int,
            gen: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    fill_uniform_(t, -limit, limit, gen)


@torch.no_grad()
def init_default_(model: nn.Module, gen: torch.Generator) -> None:
    """Xavier-uniform weights with zero biases for linears, MoE expert
    stacks and convs (conv fans count the kernel window on both sides),
    unit layer norms."""
    for m in model.modules():
        if isinstance(m, ExpertLinear):  # each expert as JAX draws it
            xavier_(m.w, m.w.shape[1], m.w.shape[2], gen)
            m.b.zero_()
            continue
        if isinstance(m, nn.Linear):
            xavier_(m.weight, m.in_features, m.out_features, gen)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            kk = m.kernel_size[0] * m.kernel_size[1]
            xavier_(m.weight, kk * m.in_channels, kk * m.out_channels, gen)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
