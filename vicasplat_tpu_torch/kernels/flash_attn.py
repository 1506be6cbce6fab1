"""K1: flash attention, forward and backward, with their plain versions.

Replaces the Pallas TPU flash-attention kernel behind
`vicasplat_tpu/models/vicanet.py:242` (`_flash_unmasked`), which carries the
mix decoder's joint image attention, and its library VJP
(`_flash_attention_bwd_dkv`, `_flash_attention_bwd_dq`). Two routes on a
CUDA tensor, chosen by its dtype:
- bf16 at head dim 64 (every bf16 configuration of the repo): the Hopper
  kernels `csrc/flash_attn.cu` (TMA, mbarriers, wgmma) and
  `csrc/flash_attn_bwd.cu` (a D pass, dK/dV and dQ, wgmma);
- float32 at any head dim up to 128 (the float32 training configuration,
  `configs/experiment/_tiny_smoke.yaml`, heads of 12 and 16):
  `csrc/flash_attn_f32.cu`, in full float32.
Any other dtype or head dim raises. A CUDA tensor that needs a gradient
runs through `_FlashAttention`: the forward kernel also writes each row's
log-sum-exp (natural log, float32 (B, H, Sq)), and the backward kernels
form dQ, dK and dV from it. A CPU tensor that needs a gradient takes
`attention_reference`, which autograd differentiates.

Both kernels are also custom operators, `torch.ops.vicasplat.flash_attn`
and `torch.ops.vicasplat.flash_attn_bwd` (`torch.library.custom_op`): on a
CUDA tensor they launch the kernels, on a CPU tensor they run the plain
versions, and their fake implementations give `torch.export` the output
shapes without touching data. Every call without a gradient goes through
the operator, so an exported program launches the kernel wherever it runs.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

HEAD_DIM = 64        # the bf16 kernels' head dim
MAX_F32_HEAD_DIM = 128
TILE = 64            # query rows of the bf16 backward's padded lse and D
# q, k, v, o, lse, B, Sq, Sk, H, stream
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# q, k, v, o, dout, lse, scratch, dq, dk, dv, B, Sq, Sk, H, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# the float32 route's: the same, and D before the stream
_F32_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_F32_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# the bf16 entry points return this plus a CUresult when a TMA map is refused
_TENSOR_MAP_ERROR = 100000


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


def _check_cuda(aligned=True, **tensors):
    """Raise unless the tensors are what one of the two routes takes: all
    bf16 at head dim 64, or all float32 at head dim 1..128; contiguous and
    (unless `aligned` is False, for tensors without data) 16-byte aligned."""
    dtype = next(iter(tensors.values())).dtype
    for name, x in tensors.items():
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, the others {dtype}")
        d = x.shape[-1]
        if dtype == torch.bfloat16:
            if d != HEAD_DIM:
                raise ValueError(f"{name}: bf16 head dim {d} != {HEAD_DIM}")
        elif dtype == torch.float32:
            if not 1 <= d <= MAX_F32_HEAD_DIM:
                raise ValueError(f"{name}: float32 head dim {d} is not in "
                                 f"1..{MAX_F32_HEAD_DIM}")
        else:
            raise TypeError(f"{name} is {dtype}; the kernels take bfloat16 "
                            "(head dim 64) or float32 (head dim <= 128)")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if aligned and x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _raise_for(rc: int, what: str):
    if rc >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed: CUresult "
                           f"{rc - _TENSOR_MAP_ERROR}")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _forward(q, k, v, with_lse: bool):
    """Launch the forward kernel of q's route: out, and lse when asked
    (else None)."""
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    f32 = q.dtype == torch.float32
    fn = (build.entry("flash_attn_f32", "vs_flash_attn_f32_fwd", _F32_FWD_ARGTYPES)
          if f32 else build.entry("flash_attn", "vs_flash_attn_fwd", _FWD_ARGTYPES))
    with torch.cuda.device(q.device):
        stream = build.raw_stream(q.device)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, Sq, k.shape[1], H)
        rc = fn(*args, D, stream) if f32 else fn(*args, stream)
    _raise_for(rc, "flash_attn_f32" if f32 else "flash_attn")
    if f32:
        flash_attention.f32_launches += 1
    else:
        flash_attention.launches += 1
    return out, lse


def flash_attention_backward(q, k, v, o, lse, do):
    """(dQ, dK, dV) in q's dtype through the backward kernels of its route:
    one call launches the D pass, the dK/dV kernel and the dQ kernel. CUDA
    tensors only."""
    _check_cuda(q=q, k=k, v=v, o=o, do=do)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("lse must be contiguous float32 (B, H, Sq)")
    B, Sq, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, Sq):
        raise ValueError("o and dO must match q, and lse be (B, H, Sq)")
    f32 = q.dtype == torch.float32
    # D; the bf16 kernels' lse * log2(e) and D, padded to whole tiles
    n = B * H * (Sq if f32 else 2 * -(-Sq // TILE) * TILE)
    scratch = torch.empty(n, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = (build.entry("flash_attn_f32", "vs_flash_attn_f32_bwd", _F32_BWD_ARGTYPES)
          if f32 else build.entry("flash_attn_bwd", "vs_flash_attn_bwd",
                                  _BWD_ARGTYPES))
    with torch.cuda.device(q.device):
        stream = build.raw_stream(q.device)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, Sq, k.shape[1], H)
        rc = fn(*args, D, stream) if f32 else fn(*args, stream)
    _raise_for(rc, "flash_attn_f32 backward" if f32 else "flash_attn_bwd")
    if f32:
        flash_attention_backward.f32_launches += 1
    else:
        flash_attention_backward.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward and backward both through the kernels; the backward gets dO
    in whatever layout autograd hands it and makes it contiguous."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = torch.ops.vicasplat.flash_attn(q, k, v, True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return torch.ops.vicasplat.flash_attn_bwd(q, k, v, o, lse,
                                                  do.to(q.dtype).contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention over (B, S, H, D) tensors, Sq != Sk allowed.

    A CUDA tensor launches the forward kernel of its route (bf16 at D = 64,
    or float32 at D <= 128; contiguous) and, when a gradient is needed, the
    backward kernels in the backward; anything else raises. A CPU tensor
    takes `attention_reference`, cast back to q's dtype: through the
    operator without a gradient, differentiable by autograd with one.
    """
    _check_shapes(q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if q.device.type == "cpu":
            return attention_reference(q, k, v).to(q.dtype)
        return _FlashAttention.apply(q, k, v)
    return torch.ops.vicasplat.flash_attn(q, k, v, False)[0]


flash_attention.launches = 0               # bf16 forward kernel launches
flash_attention.f32_launches = 0           # float32 forward kernel launches
flash_attention_backward.launches = 0      # bf16 backward calls (3 kernels each)
flash_attention_backward.f32_launches = 0  # float32 backward calls (3 kernels each)


# ---- the custom operators ----

def _no_lse(q: torch.Tensor) -> torch.Tensor:
    """The lse output of a call that did not ask for it: empty."""
    return q.new_empty(0, dtype=torch.float32)


@torch.library.custom_op("vicasplat::flash_attn", mutates_args=(), device_types="cuda")
def flash_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse), lse (B, H, Sq) float32 when `with_lse`, else empty."""
    _check_cuda(q=q, k=k, v=v)
    out, lse = _forward(q, k, v, with_lse)
    return out, _no_lse(q) if lse is None else lse


# the CPU implementations return contiguous tensors, as the fake ones and
# the kernels do, so that a trace's strides hold at run time

@flash_attn_op.register_kernel("cpu")
def _(q, k, v, with_lse):
    out = attention_reference(q, k, v).to(q.dtype).contiguous()
    return out, attention_lse_reference(q, k) if with_lse else _no_lse(q)


@flash_attn_op.register_fake
def _(q, k, v, with_lse):
    if q.device.type == "cuda":
        _check_cuda(aligned=False, q=q, k=k, v=v)
    B, Sq, H, _ = q.shape
    lse = q.new_empty(B, H, Sq, dtype=torch.float32) if with_lse else _no_lse(q)
    return q.new_empty(q.shape), lse


@torch.library.custom_op("vicasplat::flash_attn_bwd", mutates_args=(),
                         device_types="cuda")
def flash_attn_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor,
                      do: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) in q's dtype."""
    return flash_attention_backward(q, k, v, o, lse, do)


@flash_attn_bwd_op.register_kernel("cpu")
def _(q, k, v, o, lse, do):
    return tuple(x.to(q.dtype).contiguous()
                 for x in attention_backward_reference(q, k, v, o, lse, do))


@flash_attn_bwd_op.register_fake
def _(q, k, v, o, lse, do):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)
