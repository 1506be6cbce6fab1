"""Quaternion algebra, xyzw (port of vicasplat_tpu/geometry/quaternion.py).

Batched over leading dims and differentiable.
"""
from __future__ import annotations

import torch


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two xyzw quaternions."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def qconj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def qnorm(q: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def qnormalize(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return q / (qnorm(q) + eps)


def qidentity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """The identity quaternion (0, 0, 0, 1), broadcast to (*shape, 4)."""
    q = torch.zeros((*shape, 4), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def qrotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by xyzw quaternions q (..., 4): q v q*."""
    qv = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    return qmul(qmul(q, qv), qconj(q))[..., :3]


def quat_to_matrix(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """xyzw quaternion (not assumed unit) -> 3x3 rotation, 2/(|q|^2+eps)."""
    i, j, k, r = q.unbind(-1)
    two_s = 2.0 / ((q * q).sum(-1) + eps)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.unflatten(-1, (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> unit xyzw quaternion with w >= 0 (largest pivot)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    one = torch.ones_like(tr)

    def _stack(x, y, z, w):
        return torch.stack([x, y, z, w], dim=-1)

    qw = _stack(m21 - m12, m02 - m20, m10 - m01, one + tr)
    qx = _stack(one + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12)
    qy = _stack(m01 + m10, one + m11 - m00 - m22, m12 + m21, m02 - m20)
    qz = _stack(m02 + m20, m12 + m21, one + m22 - m00 - m11, m10 - m01)
    piv = torch.stack(
        [one + m00 - m11 - m22, one + m11 - m00 - m22, one + m22 - m00 - m11,
         one + tr],
        dim=-1,
    )
    best = piv.argmax(-1)
    cands = torch.stack([qx, qy, qz, qw], dim=-2)  # (..., 4 candidates, 4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = qnormalize(torch.gather(cands, -2, idx)[..., 0, :], eps=1e-12)
    return torch.where(q[..., 3:4] < 0, -q, q)
