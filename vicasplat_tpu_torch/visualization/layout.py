"""Image layout (port of vicasplat_tpu/visualization/layout.py): concatenation,
borders, labels and a colormap, on numpy (H, W, 3) float images in [0, 1].
Labels are drawn with the port's bitmap font (`bitmap_font.py`) and the
colormap comes from the port's tables (`colormaps.py`), so neither an
imaging package nor matplotlib is needed."""
from __future__ import annotations

import numpy as np

from . import bitmap_font, colormaps


def _to3(im: np.ndarray) -> np.ndarray:
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, -1)
    return im.astype(np.float32)


def add_border(image: np.ndarray, border: int = 8, color=1.0) -> np.ndarray:
    image = _to3(image)
    h, w, _ = image.shape
    out = np.full((h + 2 * border, w + 2 * border, 3), color, np.float32)
    out[border:border + h, border:border + w] = image
    return out


def _pad_to(im: np.ndarray, h: int, w: int, color=1.0) -> np.ndarray:
    out = np.full((h, w, 3), color, np.float32)
    oh, ow = (h - im.shape[0]) // 2, (w - im.shape[1]) // 2
    out[oh:oh + im.shape[0], ow:ow + im.shape[1]] = im
    return out


def hcat(*images, align: str = "center", gap: int = 0, gap_color=1.0):
    images = [_to3(im) for im in images]
    h = max(im.shape[0] for im in images)
    cols = []
    for i, im in enumerate(images):
        cols.append(_pad_to(im, h, im.shape[1], gap_color))
        if gap and i < len(images) - 1:
            cols.append(np.full((h, gap, 3), gap_color, np.float32))
    return np.concatenate(cols, axis=1)


def vcat(*images, align: str = "center", gap: int = 0, gap_color=1.0):
    images = [_to3(im) for im in images]
    w = max(im.shape[1] for im in images)
    rows = []
    for i, im in enumerate(images):
        rows.append(_pad_to(im, im.shape[0], w, gap_color))
        if gap and i < len(images) - 1:
            rows.append(np.full((gap, w, 3), gap_color, np.float32))
    return np.concatenate(rows, axis=0)


def add_label(image: np.ndarray, label: str, font_size: int = 14) -> np.ndarray:
    """A white bar of font_size + 8 rows above the image, with `label` in
    black from (4, 3), glyphs scaled to about font_size rows and cut at the
    bar's right edge."""
    image = _to3(image)
    w = image.shape[1]
    bar_h = font_size + 8
    bar = np.ones((bar_h, w, 3), np.float32)
    s = max(1, round(font_size / bitmap_font.HEIGHT))
    x = 4
    for ch in label:
        g = np.kron(bitmap_font.glyph(ch), np.ones((s, s), bool))
        gh, gw = min(g.shape[0], bar_h - 3), min(g.shape[1], w - x)
        if gw <= 0:
            break
        bar[3:3 + gh, x:x + gw][g[:gh, :gw]] = 0.0
        x += bitmap_font.WIDTH * s
    return np.concatenate([bar, image], axis=0)


def apply_color_map(x: np.ndarray, cmap: str = "inferno") -> np.ndarray:
    """Scalar map in [0, 1] -> RGB float32, as matplotlib's colormap of the
    same name (`inferno` or `turbo`)."""
    table = {"inferno": colormaps.INFERNO, "turbo": colormaps.TURBO}[cmap]
    return colormaps.lookup(table, np.clip(x, 0, 1))
