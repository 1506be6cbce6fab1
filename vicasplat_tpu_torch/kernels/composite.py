"""K2: per-tile alpha compositing with early exit (csrc/composite.cu).

Replaces the forward of the Pallas TPU kernel
`vicasplat_tpu/ops/rasterize/pallas_composite.py` (`_kernel`, `_chunk_math`,
`_composite_pallas_raw`). This module is the launch alone; the plain
version, the autograd function and the device dispatch around it are in
`ops/rasterize/pallas_composite.py`, as the JAX package keeps them beside
its kernel there.

The launch is also the custom operator `torch.ops.vicasplat.composite`
(`torch.library.custom_op`): the kernel on a CUDA payload, the plain
version on a CPU one, and a fake implementation that gives `torch.export`
the output shapes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

PAYLOAD_COLS = 16
MAX_SMEM_BYTES = 227 * 1024  # shared memory one block may use on Hopper
# payload, 7 ints (tiles, K, chunk, tile_px, tw, H, W), bg, rgb, depth,
# alpha, stream
_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5


@functools.lru_cache(maxsize=None)
def _smem_bytes(chunk: int) -> int:
    """Shared memory of one block, as the kernel's library computes it."""
    return build.entry("composite", "vs_composite_smem_bytes", [ctypes.c_int])(chunk)


def composite_launch(payload: torch.Tensor, image_shape: tuple, tile_px: int,
                     background: torch.Tensor, chunk: int):
    """payload (tiles, K, 16) float32 on the card -> (rgb (H, W, 3),
    depth (H, W), alpha = 1 - T_final (H, W)), through the kernel.

    Raises unless the payload is a contiguous, 16-byte aligned float32 CUDA
    tensor, a tile has at most 1024 pixels, K is a multiple of `chunk` and
    the kernel's shared memory at `chunk` rows a stage fits one block.
    """
    if payload.device.type != "cuda":
        raise ValueError(f"the composite kernel does not run on {payload.device}")
    if payload.dtype != torch.float32:
        raise TypeError(f"payload is {payload.dtype}; the kernel takes float32")
    if not payload.is_contiguous() or payload.data_ptr() % 16:
        raise ValueError("payload is not contiguous and 16-byte aligned")
    if tile_px * tile_px > 1024:
        raise ValueError(f"tile_px {tile_px} gives more than 1024 threads a block")
    smem = _smem_bytes(chunk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk} needs {smem} bytes of shared memory, more "
                         "than one block has")
    H, W = image_shape
    tw = -(-W // tile_px)
    num_tiles, K, _ = payload.shape
    if K % chunk:
        raise ValueError(f"K {K} is not a multiple of chunk {chunk}")
    rgb = payload.new_empty(H, W, 3)
    depth = payload.new_empty(H, W)
    alpha = payload.new_empty(H, W)
    bg = background
    if bg.device != payload.device or bg.dtype != torch.float32 \
            or not bg.is_contiguous():
        bg = bg.detach().to(payload.device, torch.float32).contiguous()
    fn = build.entry("composite", "vs_composite", _ARGTYPES)
    with torch.cuda.device(payload.device):
        stream = build.raw_stream(payload.device)
        rc = fn(payload.data_ptr(), num_tiles, K, chunk, tile_px, tw, H, W,
                bg.data_ptr(), rgb.data_ptr(), depth.data_ptr(), alpha.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"composite launch failed: cudaError {rc}")
    composite_launch.launches += 1
    return rgb, depth, alpha


composite_launch.launches = 0  # kernel launches since the last reset


@torch.library.custom_op("vicasplat::composite", mutates_args=(), device_types="cuda")
def composite_op(payload: torch.Tensor, background: torch.Tensor, height: int,
                 width: int, tile_px: int,
                 chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rgb (H, W, 3), depth (H, W), alpha (H, W)) of a (tiles, K, 16) payload."""
    return composite_launch(payload, (height, width), tile_px, background, chunk)


@composite_op.register_kernel("cpu")
def _(payload, background, height, width, tile_px, chunk):
    # imported here: ops/rasterize/pallas_composite.py imports this module
    from ..ops.rasterize.pallas_composite import composite_reference

    return tuple(x.contiguous() for x in composite_reference(
        payload, (height, width), tile_px, background, chunk))


@composite_op.register_fake
def _(payload, background, height, width, tile_px, chunk):
    return (payload.new_empty(height, width, 3), payload.new_empty(height, width),
            payload.new_empty(height, width))
