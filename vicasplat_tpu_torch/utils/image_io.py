"""Image and video input and output on the host (port of
vicasplat_tpu/utils/image_io.py:13-70). PNGs are written (8-bit RGB or
grey, no filtering) and read (`decode_png`: 8-bit grey, grey + alpha, RGB,
RGBA and palette images, every filter) by this module with zlib and
struct, and `resize_lanczos` resizes as PIL's LANCZOS does, so no imaging
package is needed; `save_video` imports OpenCV only when it is called, and
without it writes the frames as PNGs, as the JAX version does. JPEG input
is not ported (ROADMAP §1 item 5)."""
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


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# bytes a pixel, by colour type: grey, RGB, palette, grey + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
JPEG_NOT_PORTED = ("JPEG input waits for the card's JPEG route, decided with the "
                   "RE10K readers (ROADMAP §1 item 5); convert the frames to PNG")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo each scanline's filter (PNG spec 9.2) -> (h, stride) uint8.
    None and Up run on whole rows, Sub as a cumulative sum of each byte
    lane mod 256; Average and Paeth, whose predictor needs the byte just
    reconstructed, run byte by byte."""
    rows = np.frombuffer(data, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {rows.size} bytes, not "
                         f"{h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:
            lanes = line.astype(np.int64).reshape(-1, bpp)
            cur = (np.cumsum(lanes, axis=0) % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prior  # uint8 wraps mod 256
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    cur[x] = (cur[x] + ((a + up[x]) >> 1)) & 0xFF
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    cur[x] = (cur[x] + _paeth(a, up[x], c)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG filter type {ftype} is not one of 0-4")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, as PIL's `convert("RGB")` gives it:
    grey repeated, alpha dropped, a palette looked up. Bit depth 8 only:
    16-bit, sub-byte and Adam7-interlaced images raise ValueError."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, idat, palette, header = len(PNG_SIGNATURE), [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not one of 0, 2, 3, 4, 6")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth}: only 8 bits a sample are read "
                         "(16-bit and sub-byte PNGs wait, ROADMAP §1 item 5)")
    if interlace:
        raise ValueError("Adam7-interlaced PNG: not read (ROADMAP §1 item 5)")
    bpp = _PNG_CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp).reshape(h, w, bpp)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_rgb8(path) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB. PNG only: a .jpg or .jpeg
    raises NotImplementedError."""
    path = pathlib.Path(path)
    if path.suffix.lower() in (".jpg", ".jpeg"):
        raise NotImplementedError(f"{path}: {JPEG_NOT_PORTED}")
    return decode_png(path.read_bytes())


def load_image(path) -> np.ndarray:
    """-> (H, W, 3) float32 in [0, 1] (JAX `image_io.load_image`)."""
    return read_rgb8(path).astype(np.float32) / 255.0


# PIL's resampling (Pillow's libImaging/Resample.c): coefficients in
# float64, normalized, stored in fixed point with 22 fraction bits; each
# sum starts at one half and is shifted down, then clipped to uint8, after
# each pass
_PRECISION_BITS = 32 - 8 - 2
_LANCZOS_SUPPORT = 3.0


def _sinc(x: np.ndarray) -> np.ndarray:
    safe = np.where(x == 0.0, 1.0, x * np.pi)
    return np.where(x == 0.0, 1.0, np.sin(safe) / safe)


def _lanczos(x: np.ndarray) -> np.ndarray:
    return np.where((x >= -3.0) & (x < 3.0), _sinc(x) * _sinc(x / 3.0), 0.0)


def _resample_coeffs(in_size: int, out_size: int):
    """(first source index (out,), fixed-point weights (out, ksize)) of one
    axis, as Pillow's `precompute_coeffs` and `normalize_coeffs_8bpc`."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    count = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                       in_size) - xmin
    x = np.arange(ksize)
    valid = x[None] < count[:, None]
    w = np.where(valid, _lanczos((x[None] + xmin[:, None] - center[:, None] + 0.5)
                                 / filterscale), 0.0)
    ww = w.sum(1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    one = float(1 << _PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along `axis` (1: horizontal, 0: vertical) of an (H, W, C)
    uint8 image."""
    in_size = img.shape[axis]
    xmin, k = _resample_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)           # (in, other, C)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None], in_size - 1)
    acc = np.einsum("ok,okxc->oxc", k, src[idx]) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_lanczos(img: np.ndarray, size: tuple) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 for size = (w, h), as PIL's
    `Image.resize(size, Image.LANCZOS)`: the horizontal pass first, then
    the vertical one, each skipped where that side keeps its length."""
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != img.shape[0]:
        out = _resample_axis(out, h, 0)
    return out


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
