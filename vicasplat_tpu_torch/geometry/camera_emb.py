"""Camera-intrinsics ray embedding (port of
vicasplat_tpu/geometry/camera_emb.py): each pixel's camera-space ray
direction encoded by real spherical harmonics."""
from __future__ import annotations

import torch

from ..ops.sh import sh_basis
from .projection import get_local_rays, sample_image_grid


def get_intrinsic_embedding(intrinsics: torch.Tensor, image_shape: tuple,
                            degree: int = 4, merge_hw: bool = False) -> torch.Tensor:
    """Normalized K (..., 3, 3) -> (..., H, W, (degree + 1)^2) SH features
    of the ray directions, or (..., H * W, ...) with `merge_hw`."""
    coords, _ = sample_image_grid(image_shape, dtype=intrinsics.dtype,
                                  device=intrinsics.device)
    emb = sh_basis(get_local_rays(coords, intrinsics[..., None, None, :, :]), degree)
    if merge_hw:
        emb = emb.reshape(*emb.shape[:-3], -1, emb.shape[-1])
    return emb
