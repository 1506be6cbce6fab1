"""Epipolar ray overlap of two views (port of
vicasplat_tpu/geometry/epipolar.py:20-55), which the evaluation-index
generator uses to measure how much two frames see of each other.

A ray overlaps a target image when a point along it, in front of the target
camera, projects inside the unit image square; the points are sampled
log-uniformly along the ray, as the JAX package does.
"""
from __future__ import annotations

import math

import torch

from .projection import get_world_rays, project, sample_image_grid


def ray_image_overlap(origins: torch.Tensor, directions: torch.Tensor,
                      extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                      t_min: float = 1e-3, t_max: float = 1e3,
                      num_samples: int = 64) -> torch.Tensor:
    """(N,) bool: does each ray (origins, unit directions (N, 3), world)
    project into the target image (c2w `extrinsics`, normalized K)?"""
    ts = torch.logspace(math.log10(t_min), math.log10(t_max), num_samples,
                        dtype=origins.dtype, device=origins.device)
    pts = origins[:, None, :] + directions[:, None, :] * ts[None, :, None]
    xy, in_front = project(pts, extrinsics, intrinsics)
    inside = ((xy[..., 0] >= 0.0) & (xy[..., 0] <= 1.0)
              & (xy[..., 1] >= 0.0) & (xy[..., 1] <= 1.0) & in_front)
    return inside.any(dim=-1)


def view_overlap_fraction(extrinsics_a, intrinsics_a, extrinsics_b, intrinsics_b,
                          grid: int = 32) -> torch.Tensor:
    """Fraction of view A's rays (a grid x grid sample) that overlap view
    B's image."""
    xy, _ = sample_image_grid((grid, grid), dtype=extrinsics_a.dtype,
                              device=extrinsics_a.device)
    origins, dirs = get_world_rays(xy.reshape(-1, 2), extrinsics_a, intrinsics_a)
    return ray_image_overlap(origins, dirs, extrinsics_b, intrinsics_b).float().mean()
