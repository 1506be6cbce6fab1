"""K1: flash attention, forward and backward, with their plain versions.

Replaces the Pallas TPU flash-attention kernel behind
`vicasplat_tpu/models/vicanet.py:242` (`_flash_unmasked`), which carries the
mix decoder's joint image attention, and its library VJP
(`_flash_attention_bwd_dkv`, `_flash_attention_bwd_dq`). Two routes on a
CUDA tensor, chosen by its dtype and head dim (`route`):
- bf16 at head dim 64 (every bf16 configuration of the repo): the Hopper
  kernels `csrc/flash_attn.cu` (TMA, mbarriers, wgmma) and
  `csrc/flash_attn_bwd.cu` (a D pass, dK/dV and dQ, wgmma);
- float32 at any head dim up to 128 (the float32 training configuration,
  `configs/experiment/_tiny_smoke.yaml`, heads of 12 and 16), and bf16 at
  any other head dim up to 128, upcast to float32 and the results cast
  back (bf16 values are exact in TF32): `csrc/flash_attn_f32.cu`, wgmma
  on the tensor cores with each float32 product taken as three TF32
  products. `flash_f32_split_walk` repeats that arithmetic on the CPU.
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


# the float32 route's tiles: a block's own rows, and the walked rows (one
# 128-byte row of 32 floats in a transposed tile)
F32_OWN, F32_WALK = 64, 32
# a transposed tile stores key 8i + _KEY_ORDER[c] at column 8i + c: the
# accumulator gives a thread keys 2t and 2t + 1 of each 8, the TF32 A
# fragment takes k-columns t and t + 4
_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as `cvt.rna.tf32.f32`: by integer operations on the
    bits (add half of the dropped 13 bits' range, clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x, products):
    """(big, small) of x, small None for a single product."""
    big = tf32_rna(x)
    return big, (tf32_rna(x - big) if products == 3 else None)


def _mm3(a, b, products):
    """a @ b^T of float32 a (..., M, K) and b (..., N, K) as the kernels take
    it: Ab Bb + Ab Bs + As Bb of TF32 parts, summed in float32 (each part
    product is exact in float32); Ab Bb alone when `products` is 1."""
    (ab, as_), (bb, bs) = _split(a, products), _split(b, products)
    out = ab @ bb.transpose(-1, -2)
    if products == 3:
        out = out + ab @ bs.transpose(-1, -2) + as_ @ bb.transpose(-1, -2)
    return out


def _walk_order(n: int) -> torch.Tensor:
    """The stored order of n walked keys (n a multiple of 8)."""
    return torch.tensor([8 * (i // 8) + _KEY_ORDER[i % 8] for i in range(n)])


def _tiles(x, rows, dp):
    """(B, S, H, D) -> float32 (B, H, S padded to `rows`, dp), zeros padded."""
    B, S, H, D = x.shape
    out = x.new_zeros(B, H, -(-S // rows) * rows, dp, dtype=torch.float32)
    out[:, :, :S, :D] = x.float().transpose(1, 2)
    return out


def flash_f32_split_walk(q, k, v, do, products=3):
    """K1's float32 route (csrc/flash_attn_f32.cu) walked tile by tile in
    plain PyTorch on the CPU, for the tests: head dims padded with zeros to
    DP, the forward's 64-query blocks walking 32-key tiles with the online
    softmax in the log2 domain, the backward's dkdv (64 keys, 32-query
    tiles) and dq (64 queries, 32-key tiles) blocks; every product as
    three TF32 products (`products=3`; 1 for a single TF32 product), P and
    dS split as they enter theirs, and the products over keys or queries
    taken in the transposed tiles' key order.

    q, do: (B, Sq, H, D); k, v: (B, Sk, H, D). Returns float32 (out, lse,
    dq, dk, dv) in the kernels' layouts; the backward starts from the
    walk's own out and lse, as it does from the forward kernel's.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dp = 32 * -(-D // 32) if D <= 64 else (96 if D <= 96 else 128)
    scale = 1.0 / math.sqrt(D)
    c = scale * 1.4426950408889634  # scale * log2(e)
    Q, dO = (_tiles(x, F32_OWN, dp) for x in (q, do))
    K, V = (_tiles(x, F32_OWN, dp) for x in (k, v))
    order = _walk_order(F32_WALK)

    def walk_rows(x, j0):  # a walked tile and its transposed, reordered tile
        w = x[:, :, j0:j0 + F32_WALK]
        return w, w[:, :, order].transpose(-1, -2)

    # forward
    out = torch.zeros_like(Q)
    m = torch.full(Q.shape[:3], -math.inf)
    l_sum = torch.zeros(Q.shape[:3])
    for q0 in range(0, Q.shape[2], F32_OWN):
        qt = Q[:, :, q0:q0 + F32_OWN]
        m_run = torch.full(qt.shape[:3], -math.inf)
        l_run = torch.zeros(qt.shape[:3])
        acc = torch.zeros_like(qt)
        for k0 in range(0, Sk, F32_WALK):
            kt, _ = walk_rows(K, k0)
            _, vt = walk_rows(V, k0)
            s = _mm3(qt, kt, products)
            keys = torch.arange(k0, k0 + F32_WALK)
            s = s.masked_fill(keys >= Sk, -math.inf)
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp2((m_run - m_new) * c)
            p = torch.exp2(s * c - (m_new * c)[..., None])
            l_run = l_run * alpha + p.sum(-1)
            m_run = m_new
            acc = acc * alpha[..., None] + _mm3(p[..., order], vt, products)
        out[:, :, q0:q0 + F32_OWN] = acc / l_run[..., None]
        m[:, :, q0:q0 + F32_OWN], l_sum[:, :, q0:q0 + F32_OWN] = m_run, l_run
    lse = ((m * c + torch.log2(l_sum)) * math.log(2.0))[:, :, :Sq]
    o = out[:, :, :Sq, :D].transpose(1, 2).contiguous()

    # backward: D and lse * log2(e), +inf and 0 past Sq (P = 0)
    lse2 = torch.full(Q.shape[:3], math.inf)
    lse2[:, :, :Sq] = lse * 1.4426950408889634
    delta = torch.zeros(Q.shape[:3])
    delta[:, :, :Sq] = (do.float() * o).sum(-1).transpose(1, 2)
    dq = torch.zeros_like(Q)
    for q0 in range(0, Q.shape[2], F32_OWN):
        rows = slice(q0, q0 + F32_OWN)
        acc = torch.zeros_like(Q[:, :, rows])
        for k0 in range(0, Sk, F32_WALK):
            (kt, kt_t), (vt, _) = walk_rows(K, k0), walk_rows(V, k0)
            s = _mm3(Q[:, :, rows], kt, products)
            dpv = _mm3(dO[:, :, rows], vt, products)
            p = torch.exp2(s * c - lse2[:, :, rows, None])
            p = p.masked_fill(torch.arange(k0, k0 + F32_WALK) >= Sk, 0.0)
            ds = p * (dpv - delta[:, :, rows, None])
            acc = acc + _mm3(ds[..., order], kt_t, products)
        dq[:, :, rows] = acc * scale
    dk, dv = torch.zeros_like(K), torch.zeros_like(V)
    Qw, dOw = (_tiles(x, F32_WALK, dp) for x in (q, do))
    for k0 in range(0, K.shape[2], F32_OWN):
        rows = slice(k0, k0 + F32_OWN)
        acc_k, acc_v = torch.zeros_like(K[:, :, rows]), torch.zeros_like(V[:, :, rows])
        for q0 in range(0, Qw.shape[2], F32_WALK):
            (qt, qt_t), (dot, dot_t) = walk_rows(Qw, q0), walk_rows(dOw, q0)
            cols = slice(q0, q0 + F32_WALK)
            s = _mm3(K[:, :, rows], qt, products)       # S^T
            dpv = _mm3(V[:, :, rows], dot, products)    # dP^T
            p = torch.exp2(s * c - lse2[:, :, None, cols])
            ds = p * (dpv - delta[:, :, None, cols])
            acc_v = acc_v + _mm3(p[..., order], dot_t, products)
            acc_k = acc_k + _mm3(ds[..., order], qt_t, products)
        dk[:, :, rows], dv[:, :, rows] = acc_k * scale, acc_v

    def back(x, S):
        return x[:, :, :S, :D].transpose(1, 2).contiguous()

    return o, lse.contiguous(), back(dq, Sq), back(dk, Sk), back(dv, Sk)


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


def route(dtype: torch.dtype, d: int) -> str:
    """The kernels that take a CUDA tensor of `dtype` at head dim `d`:
    "bf16" (flash_attn.cu, flash_attn_bwd.cu) for bf16 at 64, "f32"
    (flash_attn_f32.cu) for float32 at 1..128 and bf16 at any other head
    dim in 1..128 (upcast). Raises TypeError for another dtype and
    ValueError for a head dim out of range."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{dtype}: the kernels take bfloat16 or float32")
    if not 1 <= d <= MAX_F32_HEAD_DIM:
        raise ValueError(f"head dim {d} is not in 1..{MAX_F32_HEAD_DIM}")
    return "bf16" if dtype == torch.bfloat16 and d == HEAD_DIM else "f32"


def _check_cuda(aligned=True, **tensors):
    """Raise unless the tensors are what `route` takes, all of one dtype;
    contiguous and (unless `aligned` is False, for tensors without data)
    16-byte aligned."""
    dtype = next(iter(tensors.values())).dtype
    for name, x in tensors.items():
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, the others {dtype}")
        try:
            route(dtype, x.shape[-1])
        except (TypeError, ValueError) as e:
            raise type(e)(f"{name}: {e}") from None
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
    (else None). bf16 on the float32 route is upcast, and out cast back."""
    B, Sq, H, D = q.shape
    f32 = route(q.dtype, D) == "f32"
    if f32 and q.dtype != torch.float32:
        out, lse = _forward(q.float(), k.float(), v.float(), with_lse)
        return out.to(q.dtype), lse
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
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
    f32 = route(q.dtype, D) == "f32"
    if f32 and q.dtype != torch.float32:  # bf16 on the float32 route
        grads = flash_attention_backward(*(x.float() for x in (q, k, v, o)), lse,
                                         do.float())
        return tuple(x.to(q.dtype) for x in grads)
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

    A CUDA tensor launches the forward kernel of its route (`route`: bf16
    at D = 64, float32 or bf16 at another D <= 128; contiguous) and, when a
    gradient is needed, the
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
