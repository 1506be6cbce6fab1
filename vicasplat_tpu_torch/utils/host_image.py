"""JPEG decode and encode, and PIL's 8-bit resize of frame batches, on
the host through the port's own C++ library (`csrc/image_host.cpp`,
compiled by g++ at first use by `kernels/build.load_host`). The card's
machine has neither PIL nor libjpeg; this library needs only g++ and the
source in the repository, and nothing falls back to another route.

The decoder reproduces libjpeg's arithmetic (the islow IDCT, fancy chroma
upsampling, fixed-point YCbCr -> RGB), so a decoded frame equals PIL's
`Image.open(f).convert("RGB")` byte for byte; progressive, arithmetic-coded,
12-bit, CMYK and corrupt streams raise ValueError naming the frame. The
encoder writes the file that PIL's `save(..., quality=q)` writes (baseline,
4:2:0, the standard tables). `resize_batch` equals PIL's 8-bit LANCZOS
and BICUBIC resize frame by frame (`image_io.resize_lanczos` and
`resize_bicubic`'s uint8 case are one frame of it). Each call
releases the GIL and spreads the frames over threads (`n_threads`, 0: one
a core)."""
from __future__ import annotations

import ctypes
import functools

import numpy as np

_ERR_LEN = 512
_c = ctypes


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..kernels.build import load_host

    lib = load_host("image_host")
    cint_p = _c.POINTER(_c.c_int)
    lib.vs_jpeg_info.argtypes = [_c.c_char_p, _c.c_size_t, cint_p, cint_p, cint_p,
                                 _c.c_char_p, _c.c_int]
    lib.vs_jpeg_info.restype = _c.c_int
    lib.vs_jpeg_decode_batch.argtypes = [
        _c.POINTER(_c.c_char_p), _c.POINTER(_c.c_size_t), _c.c_int, _c.c_void_p,
        _c.c_int, _c.c_int, _c.c_int, _c.c_char_p, _c.c_int]
    lib.vs_jpeg_decode_batch.restype = _c.c_int
    lib.vs_jpeg_encode_batch.argtypes = [
        _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_void_p,
        _c.c_size_t, _c.POINTER(_c.c_size_t), _c.c_int, _c.c_char_p, _c.c_int]
    lib.vs_jpeg_encode_batch.restype = _c.c_int
    lib.vs_resample_batch.argtypes = [
        _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_void_p, _c.c_int,
        _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int, _c.c_void_p, _c.c_void_p,
        _c.c_int, _c.c_int]
    lib.vs_resample_batch.restype = None
    return lib


def _as_bytes(buf) -> bytes:
    """bytes of a buffer, a numpy array or a torch uint8 tensor (through
    the buffer protocol: bytes(tensor) would iterate element by element)."""
    if isinstance(buf, (bytes, bytearray, memoryview)):
        return bytes(buf)
    return np.asarray(buf, dtype=np.uint8).tobytes()


def jpeg_info(buf) -> tuple:
    """(width, height, components) from a JPEG stream's headers; raises
    ValueError for what the decoder refuses at its frame header."""
    data = _as_bytes(buf)
    w, h, n = _c.c_int(), _c.c_int(), _c.c_int()
    err = _c.create_string_buffer(_ERR_LEN)
    if _lib().vs_jpeg_info(data, len(data), _c.byref(w), _c.byref(h), _c.byref(n),
                           err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return w.value, h.value, n.value


def decode_jpegs_u8(raw_list, n_threads: int = 0) -> np.ndarray:
    """JPEG streams of one size -> (V, H, W, 3) uint8 RGB. Raises
    ValueError naming the first frame that is refused, or of another size."""
    bufs = [_as_bytes(b) for b in raw_list]
    if not bufs:
        raise ValueError("no JPEG frames to decode")
    try:
        w, h, _ = jpeg_info(bufs[0])
    except ValueError as e:
        raise ValueError(f"JPEG frame 0: {e}") from None
    n = len(bufs)
    out = np.empty((n, h, w, 3), np.uint8)
    datas = (_c.c_char_p * n)(*bufs)
    lens = (_c.c_size_t * n)(*[len(b) for b in bufs])
    err = _c.create_string_buffer(_ERR_LEN)
    bad = _lib().vs_jpeg_decode_batch(datas, lens, n, out.ctypes.data, w, h,
                                      int(n_threads), err, _ERR_LEN)
    if bad >= 0:
        raise ValueError(f"JPEG frame {bad}: {err.value.decode()}")
    return out


def decode_jpeg(buf) -> np.ndarray:
    """One JPEG stream -> (H, W, 3) uint8 RGB."""
    return decode_jpegs_u8([buf], n_threads=1)[0]


def encode_jpegs(images: np.ndarray, quality: int = 95, n_threads: int = 0) -> list:
    """(N, H, W, 3) uint8 RGB -> N baseline 4:2:0 JPEG files (bytes) at
    libjpeg `quality`, as PIL's `save(..., quality=quality)` writes them."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) uint8 frames, got {images.shape}")
    n, h, w, _ = images.shape
    out, step = [], 16  # frames a call: bounds the output buffer

    def run(frames, cap):
        m = frames.shape[0]
        buf = np.empty(m * cap, np.uint8)
        lens = (_c.c_size_t * m)()
        err = _c.create_string_buffer(_ERR_LEN)
        bad = _lib().vs_jpeg_encode_batch(frames.ctypes.data, m, w, h, int(quality),
                                          buf.ctypes.data, cap, lens, int(n_threads),
                                          err, _ERR_LEN)
        if bad >= 0:
            raise ValueError(f"JPEG encode of frame {bad}: {err.value.decode()}")
        return buf, list(lens)

    cap = 3 * h * w + 4096
    for s in range(0, n, step):
        frames = images[s:s + step]
        buf, lens = run(frames, cap)
        for i, ln in enumerate(lens):
            if ln <= cap:
                out.append(buf[i * cap:i * cap + ln].tobytes())
            else:  # longer than the first guess: once more at its length
                one, _ = run(frames[i:i + 1], ln)
                out.append(one.tobytes())
    return out


def resize_batch(images: np.ndarray, size: tuple, name: str = "lanczos",
                 n_threads: int = 0) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, h, w, C) for size = (w, h), as PIL's
    `Image.resize(size, filter)` of each frame, for the filter `name`
    ("lanczos" or "bicubic"): the coefficients of
    `image_io._resample_coeffs`, summed by the host library."""
    from .image_io import _resample_coeffs

    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, h, w, c = images.shape
    ow, oh = size
    out = np.empty((n, oh, ow, c), np.uint8)
    xw, kw = _resample_coeffs(w, ow, name) if ow != w else (np.zeros(1, np.int64),) * 2
    xh, kh = _resample_coeffs(h, oh, name) if oh != h else (np.zeros(1, np.int64),) * 2
    xw, kw, xh, kh = (np.ascontiguousarray(a, np.int64) for a in (xw, kw, xh, kh))
    _lib().vs_resample_batch(images.ctypes.data, n, h, w, c, out.ctypes.data, oh, ow,
                             xw.ctypes.data, kw.ctypes.data, kw.shape[-1] if kw.ndim == 2 else 0,
                             xh.ctypes.data, kh.ctypes.data, kh.shape[-1] if kh.ndim == 2 else 0,
                             int(n_threads))
    return out
