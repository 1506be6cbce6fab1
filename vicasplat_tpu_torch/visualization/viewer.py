"""Offline scene viewer (port of vicasplat_tpu/visualization/viewer.py): an
exported 3DGS PLY (and the demo's transforms.json) rendered along an orbit
around the scene, written as a video.

Usage (on the card unless --device cpu):
  python -m vicasplat_tpu_torch.visualization.viewer --ply out/gaussians.ply \
      [--transforms out/transforms.json] [--output orbit.mp4] [--frames 60]
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib

import numpy as np


def orbit_poses(center: np.ndarray, radius: float, n: int, elevation=0.3):
    poses = []
    for i in range(n):
        ang = 2 * math.pi * i / n
        pos = center + radius * np.array(
            [math.sin(ang), -elevation, -math.cos(ang)]
        )
        fwd = center - pos
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        r = np.cross(up, fwd)
        r /= np.linalg.norm(r)
        u = np.cross(fwd, r)
        m = np.eye(4, dtype=np.float32)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = r, u, fwd, pos
        poses.append(m)
    return np.stack(poses)


def render_orbit(ply, transforms=None, frames: int = 60, size: int = 256,
                 fov: float = 60.0, device="cuda"):
    """A PLY's splats along `orbit_poses` -> ((frames, size, size, 3)
    float32, the number of splats).
    The orbit circles the splats' centre at 2.5 times their mean absolute
    spread, or, with a transforms.json, a point ahead of its cameras."""
    import torch

    from ..decoder.splatting import DecoderSplattingConfig, decoder_forward
    from ..models.adapter import Gaussians, build_covariance
    from ..utils.ply import read_ply

    data = read_ply(ply)

    def dev(x):  # a leading batch axis: the decoder takes (B, N, ...)
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)[None]

    scales, rotations = dev(data["scales"]), dev(data["rotations"])
    g = Gaussians(means=dev(data["means"]),
                  covariances=build_covariance(scales, rotations),
                  harmonics=dev(data["harmonics"]), opacities=dev(data["opacities"]),
                  scales=scales, rotations=rotations)
    center = data["means"].mean(0)
    radius = 2.5 * float(np.abs(data["means"] - center).mean() + 1e-3)
    if transforms and pathlib.Path(transforms).exists():
        with open(transforms) as f:
            tj = json.load(f)
        poses = np.stack([np.asarray(fr["transform_matrix"], np.float32)
                          for fr in tj["frames"]])
        center = poses[:, :3, 3].mean(0) + poses[:, :3, 2].mean(0) * radius * 0.5

    traj = torch.from_numpy(orbit_poses(center, radius, frames)).to(device)
    f = 0.5 / math.tan(math.radians(fov) / 2)
    K = torch.tensor([[f, 0, 0.5], [0, f, 0.5], [0, 0, 1.0]], device=device)
    with torch.no_grad():
        out = decoder_forward(
            DecoderSplattingConfig(), g, traj[None], K.expand(1, frames, 3, 3),
            torch.full((1, frames), 0.01 * radius, device=device),
            torch.full((1, frames), 100.0 * radius, device=device), (size, size))
    return out.color[0].float().cpu().numpy(), data["means"].shape[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ply", required=True)
    ap.add_argument("--transforms", default=None)
    ap.add_argument("--output", default="orbit.mp4")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--fov", type=float, default=60.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..utils.image_io import save_video

    frames, n = render_orbit(args.ply, args.transforms, args.frames, args.size,
                             args.fov, args.device)
    save_video(frames, args.output)
    print(f"wrote {args.output} ({args.frames} frames, {n} splats)")


if __name__ == "__main__":
    main()
