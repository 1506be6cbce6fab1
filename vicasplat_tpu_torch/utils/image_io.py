"""Image and video output on the host (port of
vicasplat_tpu/utils/image_io.py:13-70). PNGs are written by this module
with zlib and struct (8-bit RGB or grey, no filtering), so no imaging
package is needed; `save_video` imports OpenCV only when it is called, and
without it writes the frames as PNGs, as the JAX version does."""
from __future__ import annotations

import importlib.util
import pathlib
import struct
import zlib

import numpy as np


def to_uint8(image: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(image), 0.0, 1.0) * 255).round().astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> PNG bytes."""
    if pixels.ndim == 3 and pixels.shape[-1] == 1:
        pixels = pixels[..., 0]
    if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3) or (
            pixels.ndim == 3 and pixels.shape[-1] != 3):
        raise ValueError(f"expected (H, W[, 3]) uint8, got {pixels.shape} {pixels.dtype}")
    h, w = pixels.shape[:2]
    color_type = 2 if pixels.ndim == 3 else 0
    rows = np.ascontiguousarray(pixels).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def save_image(image: np.ndarray, path) -> None:
    """(H, W, 3) or (H, W) float in [0, 1] -> PNG."""
    path = pathlib.Path(path)
    if path.suffix.lower() != ".png":
        raise ValueError(f"{path}: only PNG is written")
    path.parent.mkdir(exist_ok=True, parents=True)
    path.write_bytes(encode_png(to_uint8(image)))


def save_video(frames: np.ndarray, path, fps: int = 30) -> None:
    """(T, H, W, 3) float in [0, 1] -> mp4 through OpenCV, or without it
    one PNG a frame in a directory named after the video."""
    path = pathlib.Path(path)
    path.parent.mkdir(exist_ok=True, parents=True)
    frames8 = to_uint8(frames)
    if importlib.util.find_spec("cv2") is None:
        stem = path.with_suffix("")
        stem.mkdir(exist_ok=True, parents=True)
        for i, f in enumerate(frames8):
            (stem / f"{i:04d}.png").write_bytes(encode_png(f))
        return
    import cv2

    h, w = frames8.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames8:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


def hcat(*images: np.ndarray, gap: int = 2) -> np.ndarray:
    """Concatenate images side by side (heights padded to the largest),
    with white gaps."""
    h = max(im.shape[0] for im in images)
    cols = []
    for im in images:
        if im.ndim == 2:
            im = np.repeat(im[..., None], 3, -1)
        pad = h - im.shape[0]
        if pad:
            im = np.pad(im, ((0, pad), (0, 0), (0, 0)))
        cols.append(im)
        cols.append(np.ones((h, gap, 3), im.dtype))
    return np.concatenate(cols[:-1], axis=1)


def vcat(*images: np.ndarray, gap: int = 2) -> np.ndarray:
    return hcat(*[im.transpose(1, 0, 2) for im in images], gap=gap).transpose(1, 0, 2)


def vis_depth_map(depth: np.ndarray, lo_q: float = 0.01, hi_q: float = 0.99) -> np.ndarray:
    """A depth map coloured by matplotlib's turbo table, near red and far
    blue, after log-quantile normalization (JAX `image_io.vis_depth_map`)."""
    from ..visualization.colormaps import TURBO, lookup

    d = np.asarray(depth, np.float64)
    valid = d > 0
    x = np.zeros_like(d)
    if valid.any():
        lo = np.quantile(np.log(d[valid]), lo_q)
        hi = np.quantile(np.log(d[valid]), hi_q)
        x[valid] = (np.log(d[valid]) - lo) / max(hi - lo, 1e-9)
        x = np.clip(x, 0, 1)
    return lookup(TURBO, 1.0 - x)
