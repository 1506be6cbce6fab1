"""K3: the fused DPT head tail (csrc/dpt_tail.cu), its plain version, and
the autograd function that carries both.

out = conv1x1(relu(conv3x3_SAME(a + m) + b1)) + b2, channels last. Replaces
the Pallas TPU kernel `vicasplat_tpu/ops/dpt_tail.py` (`_kernel`,
`_pallas_tail`, `fused_dpt_tail`); as there, the backward recomputes through
the plain version. Weights come in PyTorch's conv layouts: w1 (F, C, 3, 3),
w2 (O, F, 1, 1) or (O, F); both frameworks compute cross-correlation.

`repack_weights` gives the layouts the kernel's TMA loads read, and
`dpt_tail_tiled` walks the kernel's order over them in plain PyTorch (tiles
of 128 pixels, 64-channel chunks, 9 taps from a shifted window with zeros
outside the image), so that the CPU tests check the layout and edge logic
the kernel relies on.

The forward is also the custom operator `torch.ops.vicasplat.dpt_tail`
(`torch.library.custom_op`): the kernel on CUDA tensors (the repack runs
inside it, on the weights it is given), the plain version on CPU ones, and
a fake implementation that gives `torch.export` the output shape.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import build

CHANNEL_CHUNK = 64      # input channels a step: one 128-byte TMA row of bf16
TILE_PX = 128           # output pixels of a tile, along one image row
OUT_SLICE = 128         # O above this runs in slices of this many channels
# a, m, w1, b1, w2, b2, out, N, H, W, C, F, O, os_n, n_os, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


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


def feature_slice(Fd: int) -> int:
    """The features the kernel accumulates at once: all 256, or slices of 128."""
    return 256 if Fd == 256 else 128


def out_slices(O: int) -> tuple[int, int]:
    """(channels a slice, slices) of the second product: one slice of O
    rounded up to 32 (a wgmma width of 32, 64, 96 or 128), or slices of
    OUT_SLICE above that."""
    if O <= OUT_SLICE:
        return -(-O // 32) * 32, 1
    return OUT_SLICE, -(-O // OUT_SLICE)


class Packed(NamedTuple):
    """The weights in the layouts the kernel reads."""
    w1t: torch.Tensor   # (9 F, C), row tap * F + f, tap = 3 dy + dx; C innermost
    b1f: torch.Tensor   # (F,) float32
    w2p: torch.Tensor   # (os_n * n_os, F), zero rows past O
    b2p: torch.Tensor   # (os_n * n_os,) float32, zeros past O
    os_n: int
    n_os: int


def repack_weights(w1: torch.Tensor, b1: Optional[torch.Tensor], w2: torch.Tensor,
                   b2: Optional[torch.Tensor]) -> Packed:
    Fd, C = w1.shape[:2]
    O = w2.shape[0]
    dev = w1.device
    # (F, C, dy, dx) -> (dy, dx, F, C): one (F, C) slice per tap
    w1t = w1.permute(2, 3, 0, 1).reshape(9 * Fd, C).contiguous()
    b1f = (torch.zeros(Fd, device=dev) if b1 is None
           else b1.to(torch.float32).contiguous())
    os_n, n_os = out_slices(O)
    w2p = torch.zeros(os_n * n_os, Fd, dtype=w2.dtype, device=dev)
    w2p[:O] = w2.reshape(O, Fd)
    b2p = torch.zeros(os_n * n_os, device=dev)
    if b2 is not None:
        b2p[:O] = b2.to(torch.float32)
    return Packed(w1t, b1f, w2p, b2p, os_n, n_os)


def dpt_tail_tiled(a: torch.Tensor, m: Optional[torch.Tensor], packed: Packed,
                   O: int) -> torch.Tensor:
    """The kernel's walk in plain PyTorch, over `repack_weights`' layouts: for
    each tile of 128 pixels of a row, the window rows y - 1 .. y + 1 and
    pixels x0 - 1 .. x0 + 128, zero wherever a coordinate falls outside the
    image (TMA's fill); for each feature slice, each 64-channel chunk and
    each tap (dy, dx), the window shifted by dx against the tap's (FS, 64)
    slice of w1; then b1, relu, h rounded to a's dtype, and the second
    product in output slices, accumulated over the feature slices. All rows
    of a tile column run at once. a, m (N, H, W, C) -> (N, H, W, O)."""
    N, H, W, C = a.shape
    Fd = packed.b1f.shape[0]
    FS, os_n = feature_slice(Fd), packed.os_n
    f32, dev = torch.float32, a.device
    x = (a if m is None else a + m).to(f32)  # rounded in a's dtype first
    w1t = packed.w1t.to(f32).reshape(9, Fd, C)
    w2p = packed.w2p.to(f32)
    rows = torch.arange(H, device=dev)[:, None] + torch.arange(3, device=dev) - 1
    row_ok = (rows >= 0) & (rows < H)                                # (H, 3)
    out = torch.empty(N, H, W, O, dtype=a.dtype, device=dev)
    for x0 in range(0, W, TILE_PX):
        cols = x0 - 1 + torch.arange(TILE_PX + 2, device=dev)        # (130,)
        col_ok = (cols >= 0) & (cols < W)
        win = x[:, rows.clamp(0, H - 1)][:, :, :, cols.clamp(0, W - 1)]
        win = win * (row_ok[:, :, None] & col_ok)[None, ..., None]   # (N, H, 3, 130, C)
        y = torch.zeros(N, H, TILE_PX, os_n * packed.n_os, dtype=f32, device=dev)
        for f0 in range(0, Fd, FS):
            acc = torch.zeros(N, H, TILE_PX, FS, dtype=f32, device=dev)
            for c0 in range(0, C, CHANNEL_CHUNK):
                for dy in range(3):
                    for dx in range(3):
                        xs = win[:, :, dy, dx:dx + TILE_PX, c0:c0 + CHANNEL_CHUNK]
                        wt = w1t[3 * dy + dx, f0:f0 + FS, c0:c0 + CHANNEL_CHUNK]
                        acc += xs @ wt.T
            h = torch.relu(acc + packed.b1f[f0:f0 + FS]).to(a.dtype).to(f32)
            for o0 in range(0, os_n * packed.n_os, os_n):
                y[..., o0:o0 + os_n] += h @ w2p[o0:o0 + os_n, f0:f0 + FS].T
        y = y + packed.b2p
        n = min(TILE_PX, W - x0)
        out[:, :, x0:x0 + n] = y[:, :, :n, :O].to(a.dtype)
    return out


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
    if Fd % 128:
        raise ValueError(f"F={Fd} is not a multiple of 128")
    p = repack_weights(w1, b1, w2, b2)
    out = torch.empty(N, H, W, O, dtype=torch.bfloat16, device=a.device)
    fn = build.entry("dpt_tail", "vs_dpt_tail", _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = build.raw_stream(a.device)
        rc = fn(a.data_ptr(), None if m is None else m.data_ptr(), p.w1t.data_ptr(),
                p.b1f.data_ptr(), p.w2p.data_ptr(), p.b2p.data_ptr(), out.data_ptr(),
                N, H, W, C, Fd, O, p.os_n, p.n_os, stream)
    if rc != 0:
        raise RuntimeError(f"dpt_tail launch failed: error {rc}")
    fused_dpt_tail.launches += 1
    return out


def cluster_size() -> int:
    """The blocks of a cluster that share each w1 slice (built library)."""
    return build.entry("dpt_tail", "vs_dpt_tail_cluster_size", [])()


def shift_probe(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's dx shift alone, on the card: out[r] = x[r:r + 64] @ w.T
    for r = 0..7, each through one wgmma whose A descriptor starts r rows of
    128 bytes into x's swizzled tile, as the kernel's taps dx = 1, 2 do.
    x (136, 64), w (64, 64) bf16 -> (8, 64, 64) float32."""
    if x.shape != (136, 64) or w.shape != (64, 64) or x.dtype != torch.bfloat16 \
            or w.dtype != torch.bfloat16 or x.device.type != "cuda":
        raise ValueError("shift_probe takes x (136, 64) and w (64, 64) bf16 on the card")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty(8, 64, 64, device=x.device)
    fn = build.entry("dpt_tail", "vs_dpt_tail_shift_probe", [ctypes.c_void_p] * 4)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                build.raw_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"dpt_tail shift probe failed: error {rc}")
    return out


class _DptTail(torch.autograd.Function):
    """Forward: the operator, so the kernel (CUDA) or the plain version
    (CPU). Backward: a recompute through the plain version, as the JAX
    package's custom_vjp does."""

    @staticmethod
    def forward(ctx, a, m, w1, b1, w2, b2):
        ctx.save_for_backward(a, m, w1, b1, w2, b2)
        return torch.ops.vicasplat.dpt_tail(a, m, w1, b1, w2, b2)

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

    A CUDA tensor launches the kernel (bf16 activations and weights, C % 64
    == 0, F % 128 == 0, any O); a CPU tensor takes `dpt_tail_reference`.
    Without a gradient the operator is called directly.
    """
    _check(a, m, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (a, m, w1, b1, w2, b2)):
        return _DptTail.apply(a, m, w1, b1, w2, b2)
    return torch.ops.vicasplat.dpt_tail(a, m, w1, b1, w2, b2)


fused_dpt_tail.launches = 0  # kernel launches since the last reset


@torch.library.custom_op("vicasplat::dpt_tail", mutates_args=(), device_types="cuda")
def dpt_tail_op(a: torch.Tensor, m: Optional[torch.Tensor], w1: torch.Tensor,
                b1: Optional[torch.Tensor], w2: torch.Tensor,
                b2: Optional[torch.Tensor]) -> torch.Tensor:
    """(N, H, W, O) bf16 through the kernel."""
    return _launch(a, m, w1, b1, w2, b2)


@dpt_tail_op.register_kernel("cpu")
def _(a, m, w1, b1, w2, b2):
    return dpt_tail_reference(a, m, w1, b1, w2, b2).contiguous()


@dpt_tail_op.register_fake
def _(a, m, w1, b1, w2, b2):
    return a.new_empty(*a.shape[:3], w2.shape[0])
