"""Dual-quaternion rigid motions (port of
vicasplat_tpu/geometry/dual_quaternion.py): the camera decode's, se3's and
the camera loss's algebra, and the screw power and ScLERP of the camera
trajectories. The 8-vector layout is [q_r(xyzw), q_d(xyzw)]. Batched over
leading dims; `exponent` and `t` broadcast against them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .quaternion import matrix_to_quat, qconj, qmul, qnorm, quat_to_matrix


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


def from_translation(t: torch.Tensor) -> DualQuaternion:
    q = torch.zeros(*t.shape[:-1], 4, dtype=t.dtype, device=t.device)
    q[..., 3] = 1.0
    return from_quat_pose(torch.cat([q, t], dim=-1))


def dual_number_conjugate(dq: DualQuaternion) -> DualQuaternion:
    return DualQuaternion(dq.qr, -dq.qd)


def combined_conjugate(dq: DualQuaternion) -> DualQuaternion:
    return DualQuaternion(qconj(dq.qr), -qconj(dq.qd))


def inverse(dq: DualQuaternion) -> DualQuaternion:
    """Inverse of a *unit* dual quaternion (|q_r| = 1)."""
    qr_inv = qconj(dq.qr)
    return DualQuaternion(qr_inv, -qmul(qmul(qr_inv, dq.qd), qr_inv))


def from_matrix(m: torch.Tensor) -> DualQuaternion:
    """4x4 homogeneous transform -> unit dual quaternion."""
    q = matrix_to_quat(m[..., :3, :3])
    return from_quat_pose(torch.cat([q, m[..., :3, 3]], dim=-1))


def dqpow(dq: DualQuaternion, exponent) -> DualQuaternion:
    """Screw power sigma^e (for ScLERP), branchless as in JAX: the screw
    parameters (theta, d, axis, moment) scaled by `exponent`, and a pure
    translation where |sin(theta / 2)| < 1e-6. The small branch's divisor is
    replaced by 1 before dividing, so the branch not taken holds finite
    values and `where` passes no NaN (nor a NaN gradient) through."""
    w = torch.clamp(dq.qr[..., 3:4], -1.0, 1.0)
    theta = 2.0 * torch.arccos(w)
    sin_half = torch.sin(theta / 2.0)
    small = torch.abs(sin_half) < 1e-6
    safe_sin = torch.where(small, torch.ones_like(sin_half), sin_half)

    s0 = dq.qr[..., :3] / safe_sin
    d = -2.0 * dq.qd[..., 3:4] / safe_sin
    se = (dq.qd[..., :3] - s0 * d / 2.0 * torch.cos(theta / 2.0)) / safe_sin

    e = exponent
    half = e * theta / 2.0
    qr = torch.cat([torch.sin(half) * s0, torch.cos(half)], dim=-1)
    qd = torch.cat([e * d / 2.0 * torch.cos(half) * s0 + torch.sin(half) * se,
                    -e * d / 2.0 * torch.sin(half)], dim=-1)
    fallback = from_translation(e * translation(dq))
    return DualQuaternion(torch.where(small, fallback.qr, qr),
                          torch.where(small, fallback.qd, qd))


def sclerp(start: DualQuaternion, stop: DualQuaternion, t) -> DualQuaternion:
    """Screw linear interpolation start * (start^-1 stop)^t, on the shortest
    path: `start` is negated (the same motion) where the real parts lie in
    opposite hemispheres."""
    flip = qmul(start.qr, stop.qr)[..., 3:4] < 0
    s = DualQuaternion(torch.where(flip, -start.qr, start.qr),
                       torch.where(flip, -start.qd, start.qd))
    return dqmul(s, dqpow(dqmul(inverse(s), stop), t))


def transform_point(dq: DualQuaternion, p: torch.Tensor) -> torch.Tensor:
    """Apply the rigid motion: p' = R p + t."""
    return torch.einsum("...ij,...j->...i", quat_to_matrix(dq.qr), p) + translation(dq)
