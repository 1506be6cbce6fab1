"""Numpy twins of two geometry helpers for the host-side data pipeline
(port of vicasplat_tpu/geometry_np.py:8-32), so that the readers make no
device transfer."""
from __future__ import annotations

import numpy as np


def get_fov_np(intrinsics: np.ndarray) -> np.ndarray:
    """Normalized K (..., 3, 3) -> (..., 2) [fov_x, fov_y] radians."""
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


def camera_normalization_np(pivot_c2w: np.ndarray, poses: np.ndarray) -> np.ndarray:
    """Poses relative to `pivot_c2w` (the first context camera)."""
    return np.linalg.inv(pivot_c2w) @ poses
