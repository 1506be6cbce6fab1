"""Rotary position embeddings (port of vicasplat_tpu/ops/rope.py).

Two conventions, as in the JAX package:

1. half-split 2D RoPE for image tokens: the head dim splits into a y half and
   an x half, each rotated NeoX-style (rotate = [-x2, x1]) by the token's
   integer grid position, base 100;
2. interleaved-pair n-D RoPE for the camera tokens (temporal, theta 30):
   frequencies repeated by 2, rotate = (-odd, even) pairs.

Tables are built in float64 with numpy and stored float32, once per
arguments and device (`utils/device_cache.py`); application runs in the
input's dtype.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..utils.device_cache import as_device, device_constant


def grid_positions(h: int, w: int) -> np.ndarray:
    """Integer (y, x) positions of an h x w patch grid, row-major. (N, 2)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([ys.reshape(-1), xs.reshape(-1)], axis=-1)


def make_rope_2d_tables(positions: np.ndarray, head_dim: int,
                        base: float = 100.0, device=None):
    """(cos, sin) of shape (N, head_dim): [y half | x half], each [f, f].
    One cached pair per (positions, head_dim, base, device)."""
    pos = np.ascontiguousarray(positions)
    return _rope_2d_tables(pos.tobytes(), pos.shape, pos.dtype.str, head_dim,
                           float(base), as_device(device))


@device_constant
def _rope_2d_tables(pos_bytes: bytes, shape: tuple, np_dtype: str, head_dim: int,
                    base: float, device):
    positions = np.frombuffer(pos_bytes, np.dtype(np_dtype)).reshape(shape)
    d_half = head_dim // 2
    inv_freq = 1.0 / (base ** (np.arange(0, d_half, 2, dtype=np.float64) / d_half))

    def table(pos_1d):
        f = np.einsum("i,j->ij", pos_1d.astype(np.float64), inv_freq)
        return np.concatenate([f, f], axis=-1)

    f = np.concatenate([table(positions[:, 0]), table(positions[:, 1])], axis=-1)
    return (torch.tensor(np.cos(f), dtype=torch.float32, device=device),
            torch.tensor(np.sin(f), dtype=torch.float32, device=device))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope_2d(x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    """x: (..., N, head_dim); cos/sin broadcast against it."""
    y_half, x_half = x.chunk(2, dim=-1)
    rot = torch.cat([_rotate_half(y_half), _rotate_half(x_half)], dim=-1)
    return x * cos.to(x.dtype) + rot * sin.to(x.dtype)


def make_rope_nd_tables(rope_dim_list: Sequence[int], sizes: Sequence[int],
                        theta: float = 10000.0, device=None):
    """(cos, sin) of shape (prod(sizes), sum(rope_dim_list)), interleaved.
    One cached pair per (dims, sizes, theta, device)."""
    return _rope_nd_tables(tuple(int(d) for d in rope_dim_list),
                           tuple(int(s) for s in sizes), float(theta),
                           as_device(device))


@device_constant
def _rope_nd_tables(rope_dim_list: tuple, sizes: tuple, theta: float, device):
    grid = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in sizes],
                       indexing="ij")
    cos_parts, sin_parts = [], []
    for i, dim in enumerate(rope_dim_list):
        inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        f = np.repeat(np.einsum("i,j->ij", grid[i].reshape(-1), inv_freq), 2,
                      axis=-1)
        cos_parts.append(np.cos(f))
        sin_parts.append(np.sin(f))
    return (torch.tensor(np.concatenate(cos_parts, -1), dtype=torch.float32,
                         device=device),
            torch.tensor(np.concatenate(sin_parts, -1), dtype=torch.float32,
                         device=device))


def _rotate_interleaved(x: torch.Tensor) -> torch.Tensor:
    x2 = x.unflatten(-1, (-1, 2))
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, dim); cos/sin broadcast against it."""
    return x * cos.to(x.dtype) + _rotate_interleaved(x) * sin.to(x.dtype)
