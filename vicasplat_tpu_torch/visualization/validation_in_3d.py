"""Near-orthographic projections of a Gaussian scene for validation visuals
(port of vicasplat_tpu/visualization/validation_in_3d.py): the camera
backs far off with a tiny field of view and renders the scene along +x,
+y and +z through `decoder_forward`."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..decoder.splatting import DecoderSplattingConfig, decoder_forward
from ..models.adapter import Gaussians


def _look_at(forward: np.ndarray, up: np.ndarray, position: np.ndarray):
    f = forward / np.linalg.norm(forward)
    r = np.cross(up, f)
    r = r / np.linalg.norm(r)
    u = np.cross(f, r)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = r, u, f, position
    return m


def orthographic_camera(direction: str, extent: float, margin: float = 1.2,
                        fov_degrees: float = 0.5):
    """c2w + normalized K approximating an orthographic view along an axis."""
    half = extent * margin
    distance = half / math.tan(math.radians(fov_degrees) / 2)
    axes = {
        "x": (np.array([1.0, 0, 0]), np.array([0, -1.0, 0])),
        "y": (np.array([0, 1.0, 0]), np.array([0, 0, 1.0])),
        "z": (np.array([0, 0, 1.0]), np.array([0, -1.0, 0])),
    }
    fwd, up = axes[direction]
    c2w = _look_at(fwd, up, -fwd * distance)
    f = 0.5 / math.tan(math.radians(fov_degrees) / 2)
    K = np.array([[f, 0, 0.5], [0, f, 0.5], [0, 0, 1.0]], np.float32)
    return c2w, K, distance


@torch.no_grad()
def render_projections(gaussians: Gaussians, resolution: int = 256,
                       directions: tuple = ("x", "y", "z"),
                       dec_cfg: DecoderSplattingConfig = DecoderSplattingConfig()
                       ) -> np.ndarray:
    """-> (len(directions), resolution, resolution, 3) float32."""
    means = gaussians.means.reshape(-1, 3).float().cpu().numpy()
    center = means.mean(0)
    extent = float(np.abs(means - center).max() + 1e-3)
    dev = gaussians.means.device

    images = []
    for d in directions:
        c2w, K, distance = orthographic_camera(d, extent)
        c2w[:3, 3] += center
        out = decoder_forward(
            dec_cfg, gaussians,
            torch.from_numpy(c2w).to(dev)[None, None],
            torch.from_numpy(K).to(dev)[None, None],
            torch.full((1, 1), distance - extent, device=dev),
            torch.full((1, 1), distance + 3 * extent, device=dev),
            (resolution, resolution))
        images.append(out.color[0, 0].float().cpu().numpy())
    return np.stack(images)
