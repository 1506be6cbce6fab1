"""Image and video input and output on the host (port of
vicasplat_tpu/utils/image_io.py:13-70). PNGs are written (8-bit RGB or
grey, no filtering) and read (`decode_png_samples`: 8 and 16 bits a
sample, grey, grey + alpha, RGB, RGBA and palette images, every filter,
Adam7 interlacing) by this module with zlib and struct; JPEGs are read by
the port's own codec (`utils/host_image.py`); `resize_lanczos` and
`resize_bicubic` resize as PIL's LANCZOS and BICUBIC do (8-bit sums by
the host library, 16-bit ones in numpy). So no imaging
package is needed. `save_video` imports OpenCV only when it is called, and
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
    """(H, W, 3) or (H, W) uint8, or (H, W) uint16 (16-bit grey, as depth
    maps are stored) -> PNG bytes."""
    if pixels.ndim == 3 and pixels.shape[-1] == 1:
        pixels = pixels[..., 0]
    grey16 = pixels.dtype == np.uint16 and pixels.ndim == 2
    if not grey16 and (pixels.dtype != np.uint8 or pixels.ndim not in (2, 3) or (
            pixels.ndim == 3 and pixels.shape[-1] != 3)):
        raise ValueError(f"expected (H, W[, 3]) uint8 or (H, W) uint16, got "
                         f"{pixels.shape} {pixels.dtype}")
    h, w = pixels.shape[:2]
    color_type = 2 if pixels.ndim == 3 else 0
    if grey16:  # PNG samples are big-endian
        pixels = pixels.astype(">u2").view(np.uint8)
    rows = np.ascontiguousarray(pixels).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16 if grey16 else 8,
                                          color_type, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel, by colour type: grey, RGB, palette, grey + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))


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


def decode_png_samples(data: bytes):
    """PNG bytes -> (samples (H, W, C) uint8 or uint16, colour type,
    palette (N, 3) uint8 or None). 8 or 16 bits a sample (sub-byte depths
    raise ValueError), plain or Adam7-interlaced."""
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
    if depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(f"PNG bit depth {depth} with colour type {ctype}: 8 and 16 "
                         "bits a sample are read, not sub-byte depths")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace} is not 0 or 1")
    ch, nbytes = _PNG_CHANNELS[ctype], depth // 8
    bpp = ch * nbytes
    raw = zlib.decompress(b"".join(idat))
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    px = np.zeros((h, w, bpp), np.uint8)
    at = 0
    for y0, x0, dy, dx in passes:
        ph, pw = (h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx
        if ph <= 0 or pw <= 0:
            continue
        size = ph * (pw * bpp + 1)
        if at + size > len(raw):
            raise ValueError(f"PNG image data holds {len(raw)} bytes, fewer than its size")
        sub = _unfilter(raw[at:at + size], ph, pw * bpp, bpp)
        px[y0::dy, x0::dx] = sub.reshape(ph, pw, bpp)
        at += size
    if at != len(raw):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, not {at}")
    if nbytes == 2:  # big-endian samples
        px = px.reshape(h, w, ch, 2).astype(np.uint16)
        px = (px[..., 0] << 8) | px[..., 1]
    return px, ctype, palette


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, as PIL's `convert("RGB")` gives it:
    grey repeated, alpha dropped, a palette looked up; 16-bit colour keeps
    each sample's high byte (PIL's "RGB;16B" unpacking), 16-bit grey is
    clipped to 255 (PIL's I;16 -> RGB)."""
    px, ctype, palette = decode_png_samples(data)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[px[..., 0]]
    if px.dtype == np.uint16:
        px = (np.minimum(px, 255) if ctype == 0 else px >> 8).astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_rgb8(path) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB: a PNG through `decode_png`, a
    .jpg or .jpeg through the port's JPEG decoder."""
    path = pathlib.Path(path)
    if path.suffix.lower() in (".jpg", ".jpeg"):
        from .host_image import decode_jpeg

        try:
            return decode_jpeg(path.read_bytes())
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    return decode_png(path.read_bytes())


def load_image(path) -> np.ndarray:
    """-> (H, W, 3) float32 in [0, 1] (JAX `image_io.load_image`)."""
    return read_rgb8(path).astype(np.float32) / 255.0


# PIL's resampling (Pillow's libImaging/Resample.c): coefficients in
# float64, normalized; for 8-bit samples stored in fixed point with 22
# fraction bits, each sum starting at one half, shifted down and clipped to
# uint8 after each pass; for 16-bit samples summed in float64 and rounded
_PRECISION_BITS = 32 - 8 - 2


def _sinc(x: np.ndarray) -> np.ndarray:
    safe = np.where(x == 0.0, 1.0, x * np.pi)
    return np.where(x == 0.0, 1.0, np.sin(safe) / safe)


def _lanczos(x: np.ndarray) -> np.ndarray:
    return np.where((x >= -3.0) & (x < 3.0), _sinc(x) * _sinc(x / 3.0), 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a, x = -0.5, np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


_FILTERS = {"lanczos": (3.0, _lanczos), "bicubic": (2.0, _bicubic)}


def _resample_weights(in_size: int, out_size: int, name: str = "lanczos"):
    """(first source index (out,), normalized float64 weights (out, ksize))
    of one axis, as Pillow's `precompute_coeffs`."""
    support0, fn = _FILTERS[name]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    count = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                       in_size) - xmin
    x = np.arange(ksize)
    valid = x[None] < count[:, None]
    w = np.where(valid, fn((x[None] + xmin[:, None] - center[:, None] + 0.5)
                           / filterscale), 0.0)
    ww = w.sum(1, keepdims=True)
    return xmin, np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)


def _resample_coeffs(in_size: int, out_size: int, name: str = "lanczos"):
    """(first source index (out,), fixed-point weights (out, ksize)) of one
    axis, as Pillow's `precompute_coeffs` and `normalize_coeffs_8bpc`."""
    xmin, w = _resample_weights(in_size, out_size, name)
    one = float(1 << _PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, fixed.astype(np.int64)


def _taps(img: np.ndarray, xmin: np.ndarray, ksize: int, axis: int) -> np.ndarray:
    """(out, ksize, other) source samples of each output position."""
    in_size = img.shape[axis]
    idx = np.minimum(xmin[:, None] + np.arange(ksize)[None], in_size - 1)
    return np.moveaxis(img, axis, 0)[idx]


def _resample_axis16(img: np.ndarray, out_size: int, axis: int, name: str) -> np.ndarray:
    """One pass of Pillow's I;16 resampling (`ImagingResampleHorizontal_16bpc`)
    along `axis` of an (H, W) uint16 image: the float64 sum taken tap by tap,
    rounded half away from zero, its low byte and high byte each clipped to
    0..255."""
    xmin, w = _resample_weights(img.shape[axis], out_size, name)
    src = _taps(img, xmin, w.shape[1], axis).astype(np.float64)  # (out, k, other)
    ss = np.zeros((out_size, src.shape[2]))
    for j in range(w.shape[1]):
        ss = ss + src[:, j] * w[:, j, None]
    si = np.where(ss >= 0, ss + 0.5, ss - 0.5).astype(np.int64)  # C's (int) cast
    lo = np.clip(np.fmod(si, 256), 0, 255)
    hi = np.clip(si >> 8, 0, 255)
    return np.moveaxis((hi * 256 + lo).astype(np.uint16), 0, axis)


def resize_lanczos(img: np.ndarray, size: tuple) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 for size = (w, h), as PIL's
    `Image.resize(size, Image.LANCZOS)`: the horizontal pass first, then
    the vertical one, each skipped where that side keeps its length; the
    sums by the host library (`host_image.resize_batch`)."""
    from .host_image import resize_batch

    return resize_batch(img[None], size, "lanczos", n_threads=1)[0]


def resize_bicubic(img: np.ndarray, size: tuple) -> np.ndarray:
    """PIL's `Image.resize(size)` (its default filter, BICUBIC) for size =
    (w, h): an (H, W, C) uint8 image in 8-bit fixed point by the host
    library (`host_image.resize_batch`), an (H, W) uint16 image (PIL's mode
    I;16) in float64 with PIL's 16-bit rounding."""
    if img.dtype != np.uint16:
        from .host_image import resize_batch

        return resize_batch(img[None], size, "bicubic", n_threads=1)[0]
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _resample_axis16(out, w, 1, "bicubic")
    if h != img.shape[0]:
        out = _resample_axis16(out, h, 0, "bicubic")
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
