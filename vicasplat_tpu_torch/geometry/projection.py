"""Camera projection helpers (port of vicasplat_tpu/geometry/projection.py:
14-107): `get_fov` for the camera loss, the rigid transforms between camera
and world space, and projection, rays and the pixel grid for the
epipolar overlap of the evaluation index (geometry/epipolar.py).
Intrinsics are normalized (pixel coordinates in [0, 1]), extrinsics are
c2w 4x4 matrices, pixel centres sit at (i + 0.5) / size."""
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


def homogenize_points(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def homogenize_vectors(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)


def transform_rigid(xh: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", m, xh)


def transform_cam2world(xh: torch.Tensor, c2w: torch.Tensor) -> torch.Tensor:
    """Homogeneous camera-space points or vectors -> world space."""
    return transform_rigid(xh, c2w)


def transform_world2cam(xh: torch.Tensor, c2w: torch.Tensor) -> torch.Tensor:
    """Homogeneous world-space points or vectors -> camera space, by the
    inverse of the c2w matrix."""
    return transform_rigid(xh, torch.linalg.inv(c2w))


def project_camera_space(points: torch.Tensor, intrinsics: torch.Tensor,
                         epsilon: float = 1.19e-7) -> torch.Tensor:
    z = points[..., -1:]
    points = torch.nan_to_num(points / (z + epsilon), posinf=1e8, neginf=-1e8)
    return torch.einsum("...ij,...j->...i", intrinsics, points)[..., :-1]


def project(points, extrinsics, intrinsics, epsilon: float = 1.19e-7):
    """World points -> (normalized image xy, in-front-of-camera flag)."""
    cam = transform_rigid(homogenize_points(points), torch.linalg.inv(extrinsics))[..., :-1]
    return project_camera_space(cam, intrinsics, epsilon=epsilon), cam[..., -1] >= 0


def unproject(coordinates, z, intrinsics):
    dirs = torch.einsum("...ij,...j->...i", torch.linalg.inv(intrinsics),
                        homogenize_points(coordinates))
    return dirs * z[..., None]


def get_world_rays(coordinates, extrinsics, intrinsics):
    """Normalized pixel coordinates -> world (origins, unit directions)."""
    directions = unproject(coordinates, torch.ones_like(coordinates[..., 0]), intrinsics)
    directions = directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    directions = transform_rigid(homogenize_vectors(directions), extrinsics)[..., :3]
    origins = torch.broadcast_to(extrinsics[..., :3, 3], directions.shape)
    return origins, directions


def sample_image_grid(shape: tuple, dtype=torch.float32, device=None):
    """(coords (h, w, 2) in xy order at pixel centres, indices (h, w, 2) in
    ij order)."""
    h, w = shape
    row = torch.arange(h, device=device)
    col = torch.arange(w, device=device)
    ii, jj = torch.meshgrid(row, col, indexing="ij")
    x = (col.to(dtype) + 0.5) / w
    y = (row.to(dtype) + 0.5) / h
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1), torch.stack([ii, jj], dim=-1)


def get_local_rays(coordinates, intrinsics):
    """Normalized pixel coordinates -> unit camera-space ray directions."""
    directions = unproject(coordinates, torch.ones_like(coordinates[..., 0]), intrinsics)
    return directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
