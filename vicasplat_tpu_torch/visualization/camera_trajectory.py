"""Camera trajectories (port of vicasplat_tpu/visualization/camera_trajectory.py):
ScLERP between poses, piecewise trajectories through a pose sequence, and
wobble around a pose. Where JAX maps over the phases `t` with `vmap`, the
port broadcasts them as a leading batch dim."""
from __future__ import annotations

import math

import torch

from ..geometry import dual_quaternion as dq


def interpolate_extrinsics(start: torch.Tensor, end: torch.Tensor,
                           t: torch.Tensor) -> torch.Tensor:
    """ScLERP between two (4, 4) c2w poses at phases t (S,) -> (S, 4, 4)."""
    a, b = dq.from_matrix(start), dq.from_matrix(end)
    return dq.homogeneous_matrix(dq.sclerp(a, b, t.to(start.dtype)[:, None]))


def interpolate_trajectory(poses: torch.Tensor, steps_per_segment: int = 10):
    """Piecewise ScLERP through a (V, 4, 4) pose sequence ->
    ((V - 1) * steps_per_segment + 1, 4, 4)."""
    t = torch.linspace(0.0, 1.0, steps_per_segment + 1, dtype=poses.dtype,
                       device=poses.device)[:-1]  # endpoint excluded
    segs = [interpolate_extrinsics(poses[i], poses[i + 1], t)
            for i in range(poses.shape[0] - 1)]
    return torch.cat(segs + [poses[-1:]], dim=0)


def generate_wobble_transformation(radius, t: torch.Tensor) -> torch.Tensor:
    """(S,) phase -> (S, 4, 4) circular in-plane translation offsets."""
    tf = torch.eye(4, dtype=t.dtype, device=t.device).repeat(*t.shape, 1, 1)
    radius = torch.as_tensor(radius, dtype=t.dtype, device=t.device)
    tf[..., 0, 3] = radius * torch.sin(2 * math.pi * t)
    tf[..., 1, 3] = -radius * torch.cos(2 * math.pi * t)
    return tf


def generate_wobble(extrinsics: torch.Tensor, radius, t: torch.Tensor) -> torch.Tensor:
    """Wobble a camera around its pose: (4, 4), scalar radius, (S,) -> (S, 4, 4)."""
    return extrinsics @ generate_wobble_transformation(radius, t)
