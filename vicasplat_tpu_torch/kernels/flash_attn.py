"""K1: flash attention, forward (csrc/flash_attn.cu) and backward
(csrc/flash_attn_bwd.cu), with their plain versions.

Replaces the Pallas TPU flash-attention kernel behind
`vicasplat_tpu/models/vicanet.py:242` (`_flash_unmasked`), which carries the
mix decoder's joint image attention, and its library VJP
(`_flash_attention_bwd_dkv`, `_flash_attention_bwd_dq`). A CUDA tensor that
needs a gradient runs through `_FlashAttention`: the forward kernel also
writes each row's log-sum-exp (natural log, float32 (B, H, Sq)), and the
backward kernels form dQ, dK and dV from it. A CPU tensor takes
`attention_reference`, which autograd differentiates.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

HEAD_DIM = 64
# q, k, v, o, lse, B, Sq, Sk, H, stream
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v in float32 matmul, softmax and matmul.

    q: (B, Sq, H, D), k/v: (B, Sk, H, D). Returns float32 (B, Sq, H, D).
    """
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    s = qf @ kf.transpose(-1, -2) / math.sqrt(q.shape[-1])
    return (torch.softmax(s, dim=-1) @ vf).transpose(1, 2)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The row log-sum-exp of q k^T / sqrt(d) in float32: (B, H, Sq)."""
    s = q.float().transpose(1, 2) @ k.float().transpose(1, 2).transpose(-1, -2)
    return torch.logsumexp(s / math.sqrt(q.shape[-1]), dim=-1)


def attention_backward_reference(q, k, v, o, lse, do):
    """(dQ, dK, dV) in float32 from the backward kernels' formulas:
    P = exp(S - lse), D = rowsum(dO o O), dV = P^T dO, dP = dO V^T,
    dS = P o (dP - D), dQ = dS K / sqrt(d), dK = dS^T Q / sqrt(d).

    q, o, do: (B, Sq, H, D); k, v: (B, Sk, H, D); lse: (B, H, Sq).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, dof = (x.float().transpose(1, 2) for x in (q, k, v, o, do))
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse.float()[..., None])
    delta = (dof * of).sum(-1, keepdim=True)
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dq = ds @ kf * scale
    dk = ds.transpose(-1, -2) @ qf * scale
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def _check_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, S, H, D) tensors")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in B, H or D")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")


def _check_cuda(**tensors):
    for name, x in tensors.items():
        if x.shape[-1] != HEAD_DIM:
            raise ValueError(f"{name}: head dim {x.shape[-1]} != {HEAD_DIM}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {x.dtype}; the kernel takes bfloat16")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _forward(q, k, v, with_lse: bool):
    """Launch the forward kernel: out, and lse when asked (else None)."""
    B, Sq, H, _ = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = build.entry("flash_attn", "vs_flash_attn_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, Sq, k.shape[1], H,
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_backward(q, k, v, o, lse, do):
    """(dQ, dK, dV) in bf16 through the backward kernels: one call launches
    the D pass, the dK/dV kernel and the dQ kernel. CUDA tensors only."""
    _check_cuda(q=q, k=k, v=v, o=o, do=do)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("lse must be contiguous float32 (B, H, Sq)")
    B, Sq, H, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, Sq):
        raise ValueError("o and dO must match q, and lse be (B, H, Sq)")
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = build.entry("flash_attn_bwd", "vs_flash_attn_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, Sq, k.shape[1], H, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: cudaError {rc}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward and backward both through the kernels; the backward gets dO
    in whatever layout autograd hands it and makes it contiguous."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _forward(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_backward(q, k, v, o, lse,
                                        do.to(torch.bfloat16).contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention over (B, S, H, D) tensors, Sq != Sk allowed.

    A CUDA tensor launches the forward kernel (bf16, contiguous, D = 64),
    and, when a gradient is needed, runs the backward kernels in the
    backward; a CPU tensor takes `attention_reference`, cast back to q's
    dtype, differentiable by autograd.
    """
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q, k, v).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention does not run on {q.device}")
    _check_cuda(q=q, k=k, v=v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v)
    return _forward(q, k, v, with_lse=False)[0]


flash_attention.launches = 0           # forward kernel launches
flash_attention_backward.launches = 0  # backward calls (3 kernels each)
