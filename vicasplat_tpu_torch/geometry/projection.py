"""Camera projection helpers (port of vicasplat_tpu/geometry/projection.py,
the part the camera loss uses)."""
from __future__ import annotations

import torch


def get_fov(intrinsics: torch.Tensor) -> torch.Tensor:
    """Normalized K (..., 3, 3) -> (..., 2) [fov_x, fov_y] in radians: the
    angles between the rays through the middles of opposite image edges."""
    inv = torch.linalg.inv(intrinsics)
    ones = torch.ones(intrinsics.shape[:-2], dtype=intrinsics.dtype,
                      device=intrinsics.device)
    zeros = torch.zeros_like(ones)

    def ray(x, y):
        return (inv @ torch.stack([x, y, ones], -1)[..., None])[..., 0]

    def angle(a, b):
        an = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
        bn = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
        return torch.arccos(torch.clamp((an * bn).sum(-1), -1.0, 1.0))

    left, right = ray(zeros, 0.5 * ones), ray(ones, 0.5 * ones)
    top, bottom = ray(0.5 * ones, zeros), ray(0.5 * ones, ones)
    return torch.stack([angle(left, right), angle(top, bottom)], dim=-1)
