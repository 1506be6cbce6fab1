"""Drawing (port of vicasplat_tpu/visualization/drawing.py): camera frustums,
points and lines over images, and a figure of camera trajectories.

`_frustum_points`, `draw_points` and `draw_line` are numpy copies of the
JAX package's. Its `draw_cameras_figure` renders a matplotlib 3D figure;
the port imports no plotting package, so it draws the same frustum edges
(GT blue, predicted red, matplotlib's tab:blue and tab:red) on the same
600 x 600 canvas itself: an orthographic view from matplotlib's default 3D
angle (elevation 30, azimuth -60 degrees), each axis scaled to the unit
cube as `set_box_aspect((1, 1, 1))` does, lines by `draw_line`, and a
legend drawn with the port's bitmap font.
"""
from __future__ import annotations

import math

import numpy as np

from . import bitmap_font

TAB_BLUE = (0x1F / 255, 0x77 / 255, 0xB4 / 255)
TAB_RED = (0xD6 / 255, 0x27 / 255, 0x28 / 255)
FIGURE_PX = 600  # matplotlib's figsize (6, 6) at its default 100 dpi
VIEW_ELEV, VIEW_AZIM = 30.0, -60.0


def get_fov_np(intrinsics: np.ndarray) -> np.ndarray:
    """Normalized K (..., 3, 3) -> (..., 2) [fov_x, fov_y] radians (a copy
    of vicasplat_tpu/geometry_np.py's)."""
    inv = np.linalg.inv(intrinsics)

    def angle(a, b):
        an = a / np.linalg.norm(a, axis=-1, keepdims=True)
        bn = b / np.linalg.norm(b, axis=-1, keepdims=True)
        return np.arccos(np.clip((an * bn).sum(-1), -1.0, 1.0))

    batch = intrinsics.shape[:-2]
    ones = np.ones(batch, np.float32)
    zeros = np.zeros(batch, np.float32)

    def tr(v):
        return np.einsum("...ij,...j->...i", inv, np.stack(v, -1))

    left = tr([zeros, 0.5 * ones, ones])
    right = tr([ones, 0.5 * ones, ones])
    top = tr([0.5 * ones, zeros, ones])
    bottom = tr([0.5 * ones, ones, ones])
    return np.stack([angle(left, right), angle(top, bottom)], axis=-1)


def _frustum_points(extrinsic: np.ndarray, intrinsic: np.ndarray,
                    scale: float = 0.2) -> np.ndarray:
    """5 points (apex + 4 image corners) of a camera frustum in world space."""
    fov = get_fov_np(intrinsic)
    tx, ty = np.tan(fov[0] / 2) * scale, np.tan(fov[1] / 2) * scale
    corners_cam = np.array(
        [
            [0.0, 0.0, 0.0],
            [-tx, -ty, scale],
            [tx, -ty, scale],
            [tx, ty, scale],
            [-tx, ty, scale],
        ]
    )
    R, t = extrinsic[:3, :3], extrinsic[:3, 3]
    return corners_cam @ R.T + t


def draw_points(image: np.ndarray, xy: np.ndarray, color=(1.0, 0.0, 0.0),
                radius: int = 2) -> np.ndarray:
    """Draw normalized-coordinate points onto an (H, W, 3) image."""
    out = image.copy()
    h, w = image.shape[:2]
    for x, y in np.atleast_2d(xy):
        cx, cy = int(x * w), int(y * h)
        y0, y1 = max(0, cy - radius), min(h, cy + radius + 1)
        x0, x1 = max(0, cx - radius), min(w, cx + radius + 1)
        out[y0:y1, x0:x1] = color
    return out


def draw_line(image: np.ndarray, p0, p1, color=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Draw a line between normalized coords via dense sampling."""
    h, w = image.shape[:2]
    n = int(max(h, w) * max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 2
    ts = np.linspace(0, 1, n)
    xs = ((p0[0] + (p1[0] - p0[0]) * ts) * w).astype(int)
    ys = ((p0[1] + (p1[1] - p0[1]) * ts) * h).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    out = image.copy()
    out[ys[ok], xs[ok]] = color
    return out


_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]


def _view_project(points: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """World points -> normalized image coords (x right, y down) of the
    figure's orthographic view: each axis mapped to [-1/2, 1/2], then seen
    from elevation VIEW_ELEV and azimuth VIEW_AZIM with z up."""
    p = (points - lo) / np.maximum(hi - lo, 1e-9) - 0.5
    az, el = math.radians(VIEW_AZIM), math.radians(VIEW_ELEV)
    right = np.array([-math.sin(az), math.cos(az), 0.0])
    up = np.array([-math.sin(el) * math.cos(az), -math.sin(el) * math.sin(az),
                   math.cos(el)])
    # the unit cube's projection spans at most sqrt(3) across; keep a margin
    span = 1.9
    return np.stack([0.5 + p @ right / span, 0.5 - p @ up / span], -1)


def _draw_text(image: np.ndarray, text: str, x: int, y: int,
               color=(0.0, 0.0, 0.0)) -> np.ndarray:
    for i, ch in enumerate(text):
        g = bitmap_font.glyph(ch)
        x0 = x + i * bitmap_font.WIDTH
        image[y:y + g.shape[0], x0:x0 + g.shape[1]][g > 0] = color
    return image


def draw_cameras_figure(gt_extrinsics: np.ndarray,
                        pred_extrinsics: np.ndarray | None = None,
                        scale: float = 0.15):
    """A figure of camera frustums (GT blue, predicted red) -> (600, 600, 3)
    float32 image in [0, 1], white background."""
    K = np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]])
    groups = [(np.asarray(gt_extrinsics), TAB_BLUE, "ground truth")]
    if pred_extrinsics is not None:
        groups.append((np.asarray(pred_extrinsics), TAB_RED, "predicted"))
    frusta = [(np.stack([_frustum_points(e, K, scale) for e in extr]), color, label)
              for extr, color, label in groups]
    every = np.concatenate([f.reshape(-1, 3) for f, _, _ in frusta])
    lo, hi = every.min(0), every.max(0)
    img = np.ones((FIGURE_PX, FIGURE_PX, 3), np.float32)
    for pts, color, _ in frusta:
        for cam in pts:
            xy = _view_project(cam, lo, hi)
            for a, b in _EDGES:
                img = draw_line(img, xy[a], xy[b], color)
    # the legend, upper right
    for i, (_, color, label) in enumerate(frusta):
        y = 12 + 16 * i
        x = FIGURE_PX - 12 - bitmap_font.WIDTH * len(label) - 28
        img[y + 5:y + 7, x:x + 20] = color
        _draw_text(img, label, x + 26, y)
    return img
