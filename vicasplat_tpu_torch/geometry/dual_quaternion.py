"""Dual-quaternion rigid motions (port of
vicasplat_tpu/geometry/dual_quaternion.py, the parts the camera decode, se3
and the camera loss use). The 8-vector layout is [q_r(xyzw), q_d(xyzw)].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .quaternion import qconj, qmul, qnorm, quat_to_matrix


class DualQuaternion(NamedTuple):
    qr: torch.Tensor  # (..., 4) xyzw real part
    qd: torch.Tensor  # (..., 4) xyzw dual part


def from_dq_array(arr: torch.Tensor, normalize: bool = False) -> DualQuaternion:
    """[..., 8] -> DualQuaternion; optionally divides both parts by |q_r|."""
    qr, qd = arr[..., :4], arr[..., 4:]
    if normalize:
        n = qnorm(qr)
        qr, qd = qr / n, qd / n
    return DualQuaternion(qr, qd)


def to_dq_array(dq: DualQuaternion) -> torch.Tensor:
    return torch.cat([dq.qr, dq.qd], dim=-1)


def identity(shape=(), dtype=torch.float32, device=None) -> DualQuaternion:
    qr = torch.zeros(*shape, 4, dtype=dtype, device=device)
    qr[..., 3] = 1.0
    return DualQuaternion(qr, torch.zeros(*shape, 4, dtype=dtype, device=device))


def dqmul(a: DualQuaternion, b: DualQuaternion) -> DualQuaternion:
    """(a_r + eps a_d)(b_r + eps b_d)."""
    return DualQuaternion(qmul(a.qr, b.qr), qmul(a.qr, b.qd) + qmul(a.qd, b.qr))


def quaternion_conjugate(dq: DualQuaternion) -> DualQuaternion:
    return DualQuaternion(qconj(dq.qr), qconj(dq.qd))


def normalized(dq: DualQuaternion) -> DualQuaternion:
    """Both parts divided by |q_r|."""
    n = qnorm(dq.qr)
    return DualQuaternion(dq.qr / n, dq.qd / n)


def from_quat_pose(arr: torch.Tensor) -> DualQuaternion:
    """[..., 7] = [q_r(xyzw), t(xyz)] -> r + eps/2 * t * r (q_r normalized)."""
    qr = arr[..., :4] / qnorm(arr[..., :4])
    t = arr[..., 4:]
    tq = torch.cat([t, torch.zeros_like(t[..., :1])], dim=-1)
    return DualQuaternion(qr, qmul(0.5 * tq, qr))


def translation(dq: DualQuaternion) -> torch.Tensor:
    """t = 2 * q_d * q_r^* (vector part)."""
    return qmul(2.0 * dq.qd, qconj(dq.qr))[..., :3]


def homogeneous_matrix(dq: DualQuaternion) -> torch.Tensor:
    """Unit dual quaternion -> 4x4 homogeneous transform."""
    top = torch.cat([quat_to_matrix(dq.qr), translation(dq)[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
