"""Point-map geometry of the DUSt3R family (port of
vicasplat_tpu/geometry/ptc.py): `geotrf` (batched rigid transform of point
maps), depth <-> camera-space points, and average-distance normalization
(the loss's own masked variant is in loss/conf_point.py)."""
from __future__ import annotations

from typing import Optional

import torch


def geotrf(transform: torch.Tensor, pts: torch.Tensor,
           ncol: Optional[int] = None) -> torch.Tensor:
    """(..., 4, 4) or (..., 3, 4) transforms applied to (..., 3) points,
    broadcast over the leading dimensions."""
    out = (torch.einsum("...ij,...j->...i", transform[..., :3, :3], pts)
           + transform[..., :3, 3])
    return out[..., :ncol] if ncol else out


def depth_to_pts3d(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """(..., H, W) z-depth and normalized K (..., 3, 3) -> camera-space
    (..., H, W, 3) points K^-1 [u, v, 1] z at pixel centres."""
    h, w = depth.shape[-2:]
    u = (torch.arange(w, dtype=depth.dtype, device=depth.device) + 0.5) / w
    v = (torch.arange(h, dtype=depth.dtype, device=depth.device) + 0.5) / h
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    pix = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)
    rays = torch.einsum("...ij,hwj->...hwi", torch.linalg.inv(intrinsics), pix)
    return rays * depth[..., None]


def pts3d_to_depth(pts_cam: torch.Tensor) -> torch.Tensor:
    """Camera-space points -> z-depth."""
    return pts_cam[..., 2]


def normalize_pointcloud(pts: torch.Tensor, valid: Optional[torch.Tensor] = None,
                         eps: float = 1e-8):
    """Scale points so that their mean (masked) distance to the origin is 1;
    returns (normalized points, scale)."""
    dist = torch.linalg.vector_norm(pts, dim=-1)
    if valid is None:
        scale = dist.mean()
    else:
        scale = (dist * valid).sum() / valid.sum().clamp(min=1.0)
    scale = scale.clamp(min=eps)
    return pts / scale, scale
