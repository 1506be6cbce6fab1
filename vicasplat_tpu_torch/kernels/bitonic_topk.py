"""K4: per-row ascending sort of unsigned 32-bit words, first `keep` kept
(csrc/bitonic_topk.cu), and its plain version.

Replaces the Pallas TPU kernel `vicasplat_tpu/ops/rasterize/pallas_bitonic.py`
(`_bitonic_kernel`, `bitonic_topk_u32`) that origin binning uses to
depth-order each tile's candidates. Torch has no sortable uint32, so the
words travel as their bit patterns in int32 (`to_u32_bits`): the kernel
reads them as unsigned, and an int32 tensor cannot hold a word wider than
32 bits. `from_u32_bits` gives the values back in int64, the port's carrier
of every uint32 key of the JAX package.

`bitonic_topk_pruned_walk` walks the kernel's pruned network (the same
stages, directions and prunes) on the CPU, so that its order can be held
against the JAX package's network where no card exists.

`bitonic_topk` calls the custom operator `torch.ops.vicasplat.bitonic_topk`
(`torch.library.custom_op`): the kernel on a CUDA tensor, `topk_reference`
on a CPU one, and a fake implementation for `torch.export`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_SMEM_BYTES = 227 * 1024  # shared memory one block may use on Hopper
U32_MAX = 0xFFFFFFFF
# words, out, rows, m, keep, stream
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def to_u32_bits(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same 32 bits."""
    return torch.where(values > 0x7FFFFFFF, values - (1 << 32), values).to(torch.int32)


def from_u32_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values in int64."""
    return bits.long() & U32_MAX


def topk_reference(words: torch.Tensor, keep: int) -> torch.Tensor:
    """The first `keep` of each row in ascending unsigned order: torch.sort
    of the unsigned values held in int64."""
    return to_u32_bits(torch.sort(from_u32_bits(words), dim=1).values[:, :keep])


def pruned_stages(m: int, keep: int):
    """The kernel's network as (partner distance j, direction bit kdir)
    stages: a pair (i, i + j) is ascending where (i & kdir) == 0. Runs of R
    (the next power of two >= keep) are sorted, alternately ascending and
    descending; then, while more than one run is left, each ascending run
    takes the minimum with the descending run at distance `len` (kdir = m:
    every pair ascending) and sorts the bitonic run that gives."""
    R = 1
    while R < keep:
        R <<= 1
    k = 2
    while k <= R:
        j = k >> 1
        while j:
            yield j, k
            j >>= 1
        k <<= 1
    length = R
    while length < m:
        yield length, m
        j = R >> 1
        while j:
            yield j, length << 1
            j >>= 1
        length <<= 1


def bitonic_topk_pruned_walk(words: torch.Tensor, keep: int) -> torch.Tensor:
    """The kernel's function by its own network (`pruned_stages`), in plain
    PyTorch: (rows, m) int32 bit patterns -> (rows, keep), each row's
    smallest `keep` in ascending unsigned order."""
    _check(words, keep)
    x = from_u32_bits(words)
    rows, m = x.shape
    for j, kdir in pruned_stages(m, keep):
        xr = x.reshape(rows, m // (2 * j), 2, j)
        lo, hi = xr[:, :, 0], xr[:, :, 1]
        i = (torch.arange(m // (2 * j))[:, None] * 2 * j + torch.arange(j)[None])
        asc = (i & kdir) == 0
        mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
        x = torch.stack([torch.where(asc, mn, mx), torch.where(asc, mx, mn)],
                        dim=2).reshape(rows, m)
    return to_u32_bits(x[:, :keep])


def _check(words: torch.Tensor, keep: int):
    if words.ndim != 2:
        raise ValueError(f"bitonic_topk takes (rows, m) words, got {tuple(words.shape)}")
    if words.dtype != torch.int32:
        raise TypeError(f"words are {words.dtype}; 32-bit words travel as int32 "
                        "bit patterns (to_u32_bits)")
    m = words.shape[1]
    if m < 2 or m & (m - 1):
        raise ValueError(f"row length {m} is not a power of two >= 2")
    if not 0 < keep <= m:
        raise ValueError(f"keep={keep} outside 1..{m}")


def bitonic_topk(words: torch.Tensor, keep: int) -> torch.Tensor:
    """(rows, m) int32 bit patterns of u32 words, m a power of two ->
    (rows, keep), each row's smallest `keep` in ascending unsigned order.

    A CUDA tensor launches the kernel (contiguous, m * 4 bytes within one
    block's shared memory); a CPU tensor takes `topk_reference`.
    """
    _check(words, keep)
    return torch.ops.vicasplat.bitonic_topk(words, keep)


@torch.library.custom_op("vicasplat::bitonic_topk", mutates_args=(),
                         device_types="cuda")
def bitonic_topk_op(words: torch.Tensor, keep: int) -> torch.Tensor:
    """The kernel's launch: (rows, keep) int32."""
    rows, m = words.shape
    if m * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"row of {m} words exceeds {MAX_SMEM_BYTES} bytes of shared memory")
    if not words.is_contiguous():
        raise ValueError("words are not contiguous")
    out = torch.empty(rows, keep, dtype=torch.int32, device=words.device)
    fn = build.entry("bitonic_topk", "vs_bitonic_topk", _ARGTYPES)
    with torch.cuda.device(words.device):
        stream = build.raw_stream(words.device)
        rc = fn(words.data_ptr(), out.data_ptr(), rows, m, keep, stream)
    if rc != 0:
        raise RuntimeError(f"bitonic_topk launch failed: cudaError {rc}")
    bitonic_topk.launches += 1
    return out


@bitonic_topk_op.register_kernel("cpu")
def _(words, keep):
    return topk_reference(words, keep).contiguous()


@bitonic_topk_op.register_fake
def _(words, keep):
    return words.new_empty(words.shape[0], keep)


bitonic_topk.launches = 0  # kernel launches since the last reset
