"""Int8 weights and dynamic int8 activations (W8A8) for serving (port of
vicasplat_tpu/ops/quant.py).

Symmetric quantization: weights per output channel over the contraction
dim when the engine is built, activations per token at run time (no
calibration data). The int32 accumulator is rescaled by the product of the
two scales, so `layers.linear` callers see float outputs of the usual dtype.
Both sides round half to even, as `jnp.round` does.

A quantized layer is a `QuantLinear` that takes the place of its
`nn.Linear`; `layers.linear` dispatches on it, as the JAX package's
`linear` dispatches on a `"w_q"` entry. Paths are the JAX param tree's
"/"-joined names (`jax_path`), so exclusions like `"/center_head/"` pick
the same layers on both sides, and a family is counted once: the stacked
(L, d_in, d_out) kernel of JAX's encoder or decoder blocks is one family,
although the port keeps L modules for it.

The int8 x int8 -> int32 product is `torch._int_mm` (cuBLASLt) on the card
(JAX takes `lax.dot_general` outside any Pallas kernel); its shape rules
(more than 16 rows, k and n multiples of 8) are met by padding the rows of
short activations with zeros. On the CPU it is an exact int32 product.
"""
from __future__ import annotations

import torch
from torch import nn

from ..utils.weights import STACKED

# Kept float by default (JAX `quant.py:70-75`): the center head's pts3d
# output passes through expm1, which exponentiates quantization noise into
# position error.
SENSITIVE_PATHS = ("/center_head/",)
INT_MM_MIN_ROWS = 17  # torch._int_mm takes more than 16 rows
INT_MM_ALIGN = 8      # ... and k, n multiples of 8


def quantize_weight(w: torch.Tensor):
    """w (..., out, in) float -> (w_q int8 (..., out, in), w_s float32
    (..., out)): row j is round(w[j] / s_j), s_j = max|w[j]| / 127, the JAX
    package's column scale in its (in, out) layout."""
    w = w.detach().float()
    s = torch.clamp(w.abs().amax(dim=-1) / 127.0, min=1e-8)
    w_q = torch.clamp(torch.round(w / s[..., None]), -127, 127).to(torch.int8)
    return w_q, s


class QuantLinear(nn.Module):
    """An `nn.Linear` prepared for W8A8: `w_q` int8 (out, in), `w_s` float32
    (out,), the float bias."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        w_q, w_s = quantize_weight(linear.weight)
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_s", w_s)
        self.bias = (None if linear.bias is None
                     else nn.Parameter(linear.bias.detach().clone(), requires_grad=False))


def quantize_linear(linear: nn.Linear) -> QuantLinear:
    return QuantLinear(linear)


def _int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 @ (out, k)^T int8 -> (m, out) int32, exact."""
    if x_q.device.type == "cpu":
        return x_q.to(torch.int32) @ w_q.to(torch.int32).t()
    m, k = x_q.shape
    if k % INT_MM_ALIGN or w_q.shape[0] % INT_MM_ALIGN:
        raise ValueError(f"torch._int_mm needs k and n multiples of {INT_MM_ALIGN}; "
                         f"got k={k}, n={w_q.shape[0]}")
    if m < INT_MM_MIN_ROWS:  # zero rows leave the real rows' sums unchanged
        x_q = torch.cat([x_q, x_q.new_zeros(INT_MM_MIN_ROWS - m, k)])
    return torch._int_mm(x_q, w_q.t())[:m]


def linear_w8a8(mod: QuantLinear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """The quantized counterpart of `layers.linear`: per-token dynamic int8
    activations, an int8 x int8 product with an int32 accumulator, a rescale
    by (token scale) x (channel scale), the bias in float32."""
    out_dtype = dtype or (x.dtype if x.is_floating_point() else torch.float32)
    xf = x.float()
    ax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    x_q = torch.clamp(torch.round(xf / ax), -127, 127).to(torch.int8)
    acc = _int8_matmul(x_q.reshape(-1, x.shape[-1]), mod.w_q)
    y = acc.reshape(*x.shape[:-1], -1).float() * ax * mod.w_s
    if mod.bias is not None:
        y = y + mod.bias.float()
    return y.to(out_dtype)


def jax_path(name: str) -> str:
    """A module's dotted name -> its family's path in the JAX param tree:
    "backbone.dec_blocks.3.attn.qkv" -> "/backbone/dec_blocks/attn/qkv"
    (stacked blocks drop their index)."""
    parts = name.split(".")
    out = []
    for i, p in enumerate(parts):
        if i > 0 and parts[i - 1] in STACKED and p.isdigit():
            continue
        out.append(p)
    return "/" + "/".join(out)


def _eligible(mod: nn.Module, min_size: int) -> bool:
    return (isinstance(mod, nn.Linear)
            and mod.in_features * mod.out_features >= min_size)


def quantizable_paths(model: nn.Module, min_size: int = 1 << 14) -> list:
    """Paths of the families `quantize_tree` would touch, each once."""
    out = []
    for name, mod in model.named_modules():
        path = jax_path(name)
        if _eligible(mod, min_size) and path not in out:
            out.append(path)
    return out


def quantize_tree(model: nn.Module, min_size: int = 1 << 14, exclude: tuple = (),
                  include_only: tuple = ()):
    """Replace every `nn.Linear` of `model` whose kernel has at least
    `min_size` elements by its `QuantLinear`, in place, from the model's
    float weights. `exclude`: path substrings whose families stay float;
    `include_only`: if non-empty, only families whose path matches. Convs
    (the patch embed, the DPT heads) are not linears and stay untouched.

    Returns (model, the number of families quantized)."""
    families = set()
    for name, mod in list(model.named_modules()):
        if not _eligible(mod, min_size):
            continue
        path = jax_path(name)
        if any(e in path for e in exclude):
            continue
        if include_only and not any(e in path for e in include_only):
            continue
        parent_name, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent_name), attr, quantize_linear(mod))
        families.add(path)
    return model, len(families)


def cast_tree_preserving_quant(model: nn.Module, dtype) -> nn.Module:
    """Cast the float parameters and buffers of `model` to `dtype` in place,
    except inside quantized linears: `w_q` stays int8 and `w_s` float32 (the
    dequantizing rescale is the accuracy-critical multiply)."""
    for mod in model.modules():
        keep = {"w_q", "w_s"} if isinstance(mod, QuantLinear) else set()
        for name, p in mod.named_parameters(recurse=False):
            if p.is_floating_point() and name not in keep:
                p.data = p.data.to(dtype)
        for name, b in mod.named_buffers(recurse=False):
            if b.is_floating_point() and name not in keep:
                setattr(mod, name, b.to(dtype))
    return model
