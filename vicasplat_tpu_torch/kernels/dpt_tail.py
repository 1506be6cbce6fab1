"""K3: the fused DPT head tail (csrc/dpt_tail.cu), its plain version, and
the autograd function that carries both.

out = conv1x1(relu(conv3x3_SAME(a + m) + b1)) + b2, channels last. Replaces
the Pallas TPU kernel `vicasplat_tpu/ops/dpt_tail.py` (`_kernel`,
`_pallas_tail`, `fused_dpt_tail`); as there, the backward recomputes through
the plain version. Weights come in PyTorch's conv layouts: w1 (F, C, 3, 3),
w2 (O, F, 1, 1) or (O, F); both frameworks compute cross-correlation.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import build

CHANNEL_CHUNK = 32      # input channels the kernel stages at a time
FEATURE_SLICE = 128     # F runs in slices of this many features
OUT_SLICE = 128         # O above this runs in slices of this many channels
# a, m, w1, b1, w2, b2, out, N, H, W, C, F, O, O_pad, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def dpt_tail_reference(a: torch.Tensor, m: Optional[torch.Tensor],
                       w1: torch.Tensor, b1: Optional[torch.Tensor],
                       w2: torch.Tensor, b2: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel's function in float32 products, rounded where the kernel
    rounds: a + m and h to a's dtype before the next product, the output to
    a's dtype. a, m (N, H, W, C) -> (N, H, W, O)."""
    f32 = torch.float32
    x = a if m is None else a + m
    h = F.conv2d(x.permute(0, 3, 1, 2).to(f32), w1.to(f32),
                 None if b1 is None else b1.to(f32), padding=1)
    h = F.relu(h).to(a.dtype).to(f32)
    y = F.conv2d(h, w2.reshape(w2.shape[0], -1, 1, 1).to(f32),
                 None if b2 is None else b2.to(f32))
    return y.permute(0, 2, 3, 1).to(a.dtype)


def _check(a, m, w1, b1, w2, b2):
    if a.ndim != 4:
        raise ValueError(f"a {tuple(a.shape)} is not (N, H, W, C)")
    C = a.shape[-1]
    if m is not None and m.shape != a.shape:
        raise ValueError(f"m {tuple(m.shape)} differs from a {tuple(a.shape)}")
    if w1.ndim != 4 or w1.shape[1:] != (C, 3, 3):
        raise ValueError(f"w1 {tuple(w1.shape)} is not (F, {C}, 3, 3)")
    Fd = w1.shape[0]
    if w2.shape[1] != Fd or w2.numel() != w2.shape[0] * Fd:
        raise ValueError(f"w2 {tuple(w2.shape)} is not (O, {Fd}[, 1, 1])")
    if b1 is not None and b1.shape != (Fd,):
        raise ValueError(f"b1 {tuple(b1.shape)} is not ({Fd},)")
    if b2 is not None and b2.shape != (w2.shape[0],):
        raise ValueError(f"b2 {tuple(b2.shape)} is not ({w2.shape[0]},)")


def _launch(a, m, w1, b1, w2, b2):
    for name, x in (("a", a), ("m", m), ("w1", w1), ("w2", w2)):
        if x is not None and x.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {x.dtype}; the kernel takes bfloat16")
    for name, x in (("a", a), ("m", m)):
        if x is not None and (not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} is not contiguous and 16-byte aligned")
    N, H, W, C = a.shape
    Fd, O = w1.shape[0], w2.shape[0]
    if C % CHANNEL_CHUNK:
        raise ValueError(f"C={C} is not a multiple of {CHANNEL_CHUNK}")
    if Fd % FEATURE_SLICE:
        raise ValueError(f"F={Fd} is not a multiple of {FEATURE_SLICE}")
    if H > 65535 or N > 65535:
        raise ValueError(f"N={N}, H={H} exceed the grid")
    dev = a.device
    # (F, C, dy, dx) -> (dy, dx, F, C): one (F, C) slice per tap
    w1t = w1.permute(2, 3, 0, 1).reshape(9, Fd, C).contiguous()
    b1f = (torch.zeros(Fd, device=dev) if b1 is None
           else b1.to(torch.float32).contiguous())
    # the mma width, or whole slices of OUT_SLICE channels above that
    o_pad = -(-O // 8) * 8 if O <= OUT_SLICE else -(-O // OUT_SLICE) * OUT_SLICE
    w2p = torch.zeros(o_pad, Fd, dtype=torch.bfloat16, device=dev)
    w2p[:O] = w2.reshape(O, Fd)
    b2p = torch.zeros(o_pad, device=dev)
    if b2 is not None:
        b2p[:O] = b2.to(torch.float32)
    out = torch.empty(N, H, W, O, dtype=torch.bfloat16, device=dev)
    fn = build.entry("dpt_tail", "vs_dpt_tail", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), None if m is None else m.data_ptr(), w1t.data_ptr(),
                b1f.data_ptr(), w2p.data_ptr(), b2p.data_ptr(), out.data_ptr(),
                N, H, W, C, Fd, O, o_pad, stream)
    if rc != 0:
        raise RuntimeError(f"dpt_tail launch failed: cudaError {rc}")
    fused_dpt_tail.launches += 1
    return out


class _DptTail(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward: a
    recompute through the plain version, as the JAX package's custom_vjp
    does."""

    @staticmethod
    def forward(ctx, a, m, w1, b1, w2, b2):
        ctx.save_for_backward(a, m, w1, b1, w2, b2)
        if a.device.type == "cpu":
            return dpt_tail_reference(a, m, w1, b1, w2, b2)
        if a.device.type != "cuda":
            raise ValueError(f"fused_dpt_tail does not run on {a.device}")
        return _launch(a, m, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = [x is not None and ctx.needs_input_grad[i]
                for i, x in enumerate(saved)]
        with torch.enable_grad():
            args = [x.detach().requires_grad_(n) if x is not None else None
                    for x, n in zip(saved, need)]
            out = dpt_tail_reference(*args)
            wrt = [x for x, n in zip(args, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
        return tuple(next(grads) if n else None for n in need)


def fused_dpt_tail(a: torch.Tensor, m: Optional[torch.Tensor], w1: torch.Tensor,
                   b1: Optional[torch.Tensor], w2: torch.Tensor,
                   b2: Optional[torch.Tensor]) -> torch.Tensor:
    """conv1x1(relu(conv3x3_SAME(a + m, w1) + b1), w2) + b2 over (N, H, W, C)
    channels-last activations -> (N, H, W, O); differentiable.

    A CUDA tensor launches the kernel (bf16 activations and weights, C % 32
    == 0, F % 128 == 0, any O); a CPU tensor takes `dpt_tail_reference`.
    """
    _check(a, m, w1, b1, w2, b2)
    return _DptTail.apply(a, m, w1, b1, w2, b2)


fused_dpt_tail.launches = 0  # kernel launches since the last reset
