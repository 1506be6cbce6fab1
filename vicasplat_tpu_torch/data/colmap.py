"""COLMAP text-model loader (port of vicasplat_tpu/data/colmap.py:14-76):
reads a sparse reconstruction's cameras.txt and images.txt into (c2w
extrinsics, normalized intrinsics, image names), so that a scene can be
converted into the chunk format."""
from __future__ import annotations

import pathlib

import numpy as np


def _qvec_to_rotmat(qvec):
    """COLMAP stores wxyz quaternions; returns world->cam rotation."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def read_cameras_txt(path) -> dict:
    """camera_id -> normalized 3x3 K (PINHOLE / SIMPLE_PINHOLE / RADIAL*)."""
    cams = {}
    for line in pathlib.Path(path).read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cam_id, model = int(parts[0]), parts[1]
        w, h = float(parts[2]), float(parts[3])
        p = [float(x) for x in parts[4:]]
        if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        elif model in ("PINHOLE", "OPENCV", "RADIAL_FISHEYE", "OPENCV_FISHEYE"):
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        else:
            raise ValueError(f"unsupported COLMAP camera model {model}")
        K = np.array(
            [[fx / w, 0, cx / w], [0, fy / h, cy / h], [0, 0, 1]], np.float32
        )
        cams[cam_id] = K
    return cams


def read_images_txt(path):
    """-> list of (image_name, camera_id, c2w 4x4), sorted by name."""
    out = []
    lines = [
        ln for ln in pathlib.Path(path).read_text().splitlines()
        if ln and not ln.startswith("#")
    ]
    for i in range(0, len(lines), 2):  # every other line is 2D points
        parts = lines[i].split()
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        w2c = np.eye(4)
        w2c[:3, :3] = _qvec_to_rotmat(qvec)
        w2c[:3, 3] = tvec
        out.append((name, cam_id, np.linalg.inv(w2c).astype(np.float32)))
    return sorted(out, key=lambda x: x[0])


def load_colmap_scene(sparse_dir):
    """-> (extrinsics (V,4,4) c2w, intrinsics (V,3,3) normalized, names)."""
    sparse_dir = pathlib.Path(sparse_dir)
    cams = read_cameras_txt(sparse_dir / "cameras.txt")
    images = read_images_txt(sparse_dir / "images.txt")
    ext = np.stack([e for _, _, e in images])
    K = np.stack([cams[c] for _, c, _ in images])
    names = [n for n, _, _ in images]
    return ext, K, names
