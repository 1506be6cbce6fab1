"""SE(3) helpers (port of vicasplat_tpu/geometry/se3.py): exponential map,
rigid inverse, camera matrices. Batched and branchless."""
from __future__ import annotations

import torch

from . import dual_quaternion as dqlib
from .quaternion import matrix_to_quat, qnormalize


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).unflatten(-1, (3, 3))


def _rotation_coeffs(theta: torch.Tensor):
    """(A, B, C, W, W2) of the SO(3)/SE(3) exponentials; Taylor branches in
    angle^2 near 0."""
    W = skew(theta)
    W2 = W @ W
    sq = (theta * theta).sum(-1)[..., None, None]
    small = sq < 1e-8
    safe_sq = torch.where(small, torch.ones_like(sq), sq)
    angle = torch.sqrt(safe_sq)
    A = torch.where(small, 1.0 - sq / 6.0, torch.sin(angle) / angle)
    B = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(angle)) / safe_sq)
    C = torch.where(small, 1.0 / 6.0 - sq / 120.0,
                    (angle - torch.sin(angle)) / (safe_sq * angle))
    return A, B, C, W, W2


def so3_exp(theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, batched, smooth at the identity."""
    A, B, _, W, W2 = _rotation_coeffs(theta)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device).expand(W.shape)
    return eye + A * W + B * W2


def so3_left_jacobian(theta: torch.Tensor) -> torch.Tensor:
    """V(theta) such that t = V @ rho in the SE(3) exponential."""
    _, B, C, W, W2 = _rotation_coeffs(theta)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device).expand(W.shape)
    return eye + B * W + C * W2


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """tau = [rho(3), theta(3)] -> 4x4 transform."""
    rho, theta = tau[..., :3], tau[..., 3:]
    R = so3_exp(theta)
    t = (so3_left_jacobian(theta) @ rho[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rigid_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid 4x4 transform: [R^T, -R^T t]."""
    Rt = m[..., :3, :3].transpose(-1, -2)
    ti = -(Rt @ m[..., :3, 3:4])
    top = torch.cat([Rt, ti], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def update_pose(cam_trans_delta: torch.Tensor, cam_rot_delta: torch.Tensor,
                extrinsics: torch.Tensor) -> torch.Tensor:
    """The left SE(3) retraction of the w2c matrix by [trans, rot] deltas;
    takes and returns c2w, batched."""
    tau = torch.cat([cam_trans_delta, cam_rot_delta], dim=-1)
    return rigid_inverse(se3_exp(tau) @ rigid_inverse(extrinsics))


def camera_normalization(pivot_pose: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """Every c2w pose relative to the pivot (first-context) pose:
    pivot^-1 @ poses."""
    return torch.linalg.inv(pivot_pose) @ poses


def camera_matrix_from_dq_array(dq_array: torch.Tensor,
                                normalize: bool = False) -> torch.Tensor:
    return dqlib.homogeneous_matrix(
        dqlib.from_dq_array(dq_array, normalize=normalize))


def camera_matrix_from_qt_array(qt_array: torch.Tensor) -> torch.Tensor:
    """(..., 7) [xyzw quaternion, translation] -> (..., 4, 4) transform."""
    return dqlib.homogeneous_matrix(dqlib.from_quat_pose(qt_array))


def camera_dq_array_from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) + translation (..., 3) -> dq array (..., 8)."""
    q = qnormalize(matrix_to_quat(R), eps=0.0)
    return dqlib.to_dq_array(dqlib.from_quat_pose(torch.cat([q, t], dim=-1)))


def intrinsics_from_fov(fov: torch.Tensor) -> torch.Tensor:
    """(..., 2) [fov_x, fov_y] radians -> normalized 3x3 K, cx = cy = 0.5."""
    fx = 0.5 / torch.tan(0.5 * fov[..., 0])
    fy = 0.5 / torch.tan(0.5 * fov[..., 1])
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    K = torch.stack([fx, zero, 0.5 * one, zero, fy, 0.5 * one, zero, zero, one],
                    dim=-1)
    return K.unflatten(-1, (3, 3))


def pose_error_angles(pred: torch.Tensor, gt: torch.Tensor):
    """(rotation geodesic error, angle between the translation directions),
    both in degrees, of (..., 4, 4) poses."""
    R_err = pred[..., :3, :3] @ gt[..., :3, :3].transpose(-1, -2)
    trace = R_err.diagonal(dim1=-2, dim2=-1).sum(-1)
    rot_deg = torch.rad2deg(torch.arccos(((trace - 1.0) / 2.0).clamp(-1.0, 1.0)))
    tp, tg = pred[..., :3, 3], gt[..., :3, 3]
    denom = torch.linalg.vector_norm(tp, dim=-1) * torch.linalg.vector_norm(tg, dim=-1)
    cos_t = ((tp * tg).sum(-1) / denom.clamp(min=1e-10)).clamp(-1.0, 1.0)
    return rot_deg, torch.rad2deg(torch.arccos(cos_t))


def get_pnp_pose(pts3d, opacity, intrinsics, h: int, w: int,
                 opacity_threshold: float = 0.3):
    """The camera's c2w pose (4, 4) numpy, by OpenCV's PnP-RANSAC (SQPnP)
    on the host, from a point map pts3d (H, W, 3) of world points at the
    pixels whose opacity (H, W) is above the threshold; intrinsics
    normalized (3, 3). Tensors or arrays. Raises RuntimeError when RANSAC
    finds no pose."""
    import cv2
    import numpy as np

    def host(x, dtype):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, dtype)

    pts3d = host(pts3d, np.float32)
    opacity = host(opacity, np.float32)
    K = host(intrinsics, np.float64).copy()
    K[0, :] *= w
    K[1, :] *= h
    pixels = np.mgrid[:w, :h].T.astype(np.float32)
    mask = opacity > opacity_threshold
    success, rvec, tvec, _ = cv2.solvePnPRansac(
        pts3d[mask], pixels[mask], K, None, iterationsCount=100,
        reprojectionError=5, flags=cv2.SOLVEPNP_SQPNP)
    if not success:
        raise RuntimeError("PnP-RANSAC failed")
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = cv2.Rodrigues(rvec)[0]
    w2c[:3, 3] = tvec.reshape(3)
    return np.linalg.inv(w2c)
