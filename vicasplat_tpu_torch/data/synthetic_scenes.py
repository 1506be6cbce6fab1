"""Synthetic scenes with exact ground-truth poses (port of
vicasplat_tpu/data/synthetic_scenes.py): clustered anisotropic Gaussians in
front of a backdrop plane that spans the frustum, and smooth camera
trajectories, made with numpy from a seed (the same seed gives the same
arrays, bit for bit, as the JAX package's generator); golden frames
rendered by the port's rasterizer (`render_scene_frames`, with their
depth `render_scene_views`); and the
stage-split dataset of the `synthetic` experiment (`DatasetSyntheticScenes`),
whose examples follow the RE10K loader's contract: frame-0-relative
cameras scaled to a context baseline of 1, and near and far divided by the
same scale.

A scene at the flagship's size (`SyntheticScenesConfig(input_image_shape=
(256, 256), n_gaussians=524288)`) covers every pixel of its views, which is
what K2 and K4 are timed on (chip_smoke.py, phases k2 and k4).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticScenesConfig:
    name: str = "synthetic"
    n_scenes: int = 64            # train split size
    n_val_scenes: int = 4
    n_test_scenes: int = 8        # held out: never seen in training
    n_frames: int = 8             # frames rendered per scene
    input_image_shape: tuple = (64, 64)
    n_gaussians: int = 3072
    n_clusters: int = 24
    fov_deg: float = 60.0
    near: float = 0.05
    far: float = 100.0
    seed: int = 0
    # epochs over the scene list per __iter__ pass (train only)
    repeats: int = 1_000_000
    overfit_to_scene: Optional[str] = None
    cameras_are_circular: bool = False
    # x-reflection augmentation at train time (data/shims.py)
    augment: bool = False
    # spatial-frequency multiplier of the backdrop's colour waves and height
    # ripple; 1.0 is the generator's default
    texture_detail: float = 1.0


def _look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray):
    """c2w with camera -z ... +z forward convention (OpenCV: +z forward,
    +y down) matching the rasterizer's projection."""
    f = center - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)  # down
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = r
    c2w[:3, 1] = d
    c2w[:3, 2] = f
    c2w[:3, 3] = eye
    return c2w


def scene_gaussians(rng: np.random.Generator, cfg: SyntheticScenesConfig):
    """Clustered, textured random geometry: `n_clusters` anisotropic blobs
    in the camera frustum plus a far backdrop plane (so every ray
    terminates — pure-background pixels carry no parallax signal)."""
    n, k = cfg.n_gaussians, cfg.n_clusters
    n_back = n // 4
    n_fg = n - n_back
    centers = np.stack([
        rng.uniform(-1.2, 1.2, k),
        rng.uniform(-0.9, 0.9, k),
        rng.uniform(1.8, 4.0, k),
    ], -1)
    sizes = rng.uniform(0.08, 0.35, (k, 3))
    palette = rng.uniform(-1.5, 1.5, (k, 3))
    idx = rng.integers(0, k, n_fg)
    means = centers[idx] + rng.normal(0, 1, (n_fg, 3)) * sizes[idx]
    # texture: per-splat color jitter on the cluster palette
    colors = palette[idx] + rng.normal(0, 0.45, (n_fg, 3))
    scales = np.exp(rng.normal(np.log(0.035), 0.4, (n_fg, 3)))
    # backdrop: a wall at z ~ 5.5 spanning the frustum
    bx = rng.uniform(-4.5, 4.5, n_back)
    by = rng.uniform(-3.5, 3.5, n_back)
    td = cfg.texture_detail
    bz = 5.5 + 0.2 * np.sin(3.0 * td * bx) * np.cos(2.0 * td * by)
    b_means = np.stack([bx, by, bz], -1)
    b_colors = np.stack([
        0.5 * np.sin(2.5 * td * bx) + 0.2 * np.cos(4.0 * td * by),
        0.5 * np.cos(1.7 * td * bx + 2.0 * td * by),
        0.4 * np.sin(3.3 * td * by),
    ], -1) + rng.normal(0, 0.25, (n_back, 3))
    b_scales = np.exp(rng.normal(np.log(0.12), 0.3, (n_back, 3)))

    means = np.concatenate([means, b_means]).astype(np.float32)
    colors = np.concatenate([colors, b_colors]).astype(np.float32)
    scales = np.concatenate([scales, b_scales]).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.55, 0.95, n).astype(np.float32)
    # SH degree 0: color = C0 * sh0 with C0 = 0.2820947917
    sh0 = (colors / 0.2820947917)[:, :, None]
    return {"means": means, "scales": scales, "rotations": quats,
            "harmonics": sh0.astype(np.float32), "opacities": opac}


def scene_trajectory(rng: np.random.Generator, cfg: SyntheticScenesConfig):
    """Smooth forward+lateral arc with look-at jitter. Returns c2w (T,4,4)
    float32 with meaningful (non-degenerate) rotation AND translation."""
    T = cfg.n_frames
    t = np.linspace(0.0, 1.0, T)
    base = np.array([0.0, 0.0, 0.0])
    dirv = np.array([rng.uniform(-0.8, 0.8),
                     rng.uniform(-0.4, 0.4),
                     rng.uniform(-0.35, 0.55)])
    wob_f = rng.uniform(1.5, 3.0, 2)
    wob_a = rng.uniform(0.03, 0.12, 2)
    eyes = base[None] + t[:, None] * dirv[None]
    eyes[:, 0] += wob_a[0] * np.sin(2 * np.pi * wob_f[0] * t)
    eyes[:, 1] += wob_a[1] * np.sin(2 * np.pi * wob_f[1] * t + 1.0)
    center0 = np.array([rng.uniform(-0.4, 0.4), rng.uniform(-0.3, 0.3),
                        rng.uniform(2.2, 3.2)])
    drift = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.3, 0.3), 0.0])
    up = np.array([0.0, -1.0, 0.0])
    poses = np.stack([
        _look_at(eyes[i], center0 + t[i] * drift, up) for i in range(T)
    ])
    return poses.astype(np.float32)


def intrinsics_for(cfg: SyntheticScenesConfig) -> np.ndarray:
    f = 0.5 / np.tan(np.radians(cfg.fov_deg) / 2)
    return np.array([[f, 0, 0.5], [0, f, 0.5], [0, 0, 1]], np.float32)


def scene_rng(scene_id: int, cfg: SyntheticScenesConfig) -> np.random.Generator:
    """The generator of scene `scene_id`, as the JAX package's
    `generate_scene` seeds it: draw `scene_gaussians`, then
    `scene_trajectory`, from it in that order."""
    return np.random.default_rng(cfg.seed * 1_000_003 + scene_id)


def render_scene_frames(gauss: dict, poses: np.ndarray, K: np.ndarray,
                        image_shape: tuple, device="cpu") -> np.ndarray:
    """Golden frames (T, H, W, 3) in [0, 1] from the port's rasterizer on
    `device` (JAX `render_scene_frames`, `:151-185`: max_per_tile 256, a
    black background, SH degree 0, colour clipped to [0, 1])."""
    return render_scene_views(gauss, poses, K, image_shape, device)[0]


def render_scene_views(gauss: dict, poses: np.ndarray, K: np.ndarray,
                       image_shape: tuple, device="cpu") -> tuple:
    """`render_scene_frames`'s frames and the expected depth (T, H, W) in
    the cameras' units, 0 where the accumulated alpha is under 0.5."""
    from ..ops.rasterize import RasterizeConfig, render
    from ..ops.rasterize.projection import cov6_from_scale_rot

    g = {k: torch.from_numpy(v).to(device) for k, v in gauss.items()}
    T = poses.shape[0]
    with torch.no_grad():
        color, depth, alpha = render(
            g["means"], cov6_from_scale_rot(g["scales"], g["rotations"]),
            g["harmonics"], g["opacities"], torch.from_numpy(poses).to(device),
            torch.from_numpy(K).to(device).expand(T, 3, 3), tuple(image_shape),
            torch.zeros(3, device=device), 0, cfg=RasterizeConfig(max_per_tile=256))
        depth = torch.where(alpha > 0.5, depth / alpha.clamp(min=1e-6), torch.zeros_like(depth))
    return color.clamp(0.0, 1.0).cpu().numpy(), depth.cpu().numpy()


def generate_scene(scene_id: int, cfg: SyntheticScenesConfig, device="cpu") -> dict:
    """Deterministic per-id scene: Gaussians, ground-truth cameras and
    frames rendered on `device`. The same id gives the same geometry and
    cameras, bit for bit, as the JAX package's."""
    rng = scene_rng(scene_id, cfg)
    gauss = scene_gaussians(rng, cfg)
    poses = scene_trajectory(rng, cfg)
    K = intrinsics_for(cfg)
    images = render_scene_frames(gauss, poses, K, cfg.input_image_shape, device)
    return {"gaussians": gauss, "extrinsics": poses, "intrinsics": K,
            "images": images, "scene": f"synthetic_{scene_id:05d}"}


class DatasetSyntheticScenes:
    """Stage-split procedural scenes (JAX `:200-276`). Scene ids: train
    [0, n_scenes), val [n_scenes, +n_val), test [n_scenes + n_val, +n_test);
    test scenes are never iterated in training. Frames render on `device`."""

    def __init__(self, cfg: SyntheticScenesConfig, stage: str, view_sampler,
                 seed: int = 0, device="cpu"):
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        self.device = device
        self.rng = np.random.default_rng(seed + 17)
        if stage == "train":
            self.ids = list(range(cfg.n_scenes))
        elif stage == "val":
            self.ids = list(range(cfg.n_scenes, cfg.n_scenes + cfg.n_val_scenes))
        else:
            s0 = cfg.n_scenes + cfg.n_val_scenes
            self.ids = list(range(s0, s0 + cfg.n_test_scenes))
        self._cache: dict = {}

    def _scene(self, sid: int) -> dict:
        if sid not in self._cache:
            self._cache[sid] = generate_scene(sid, self.cfg, self.device)
        return self._cache[sid]

    def _example(self, sid: int) -> Optional[dict]:
        from .view_samplers import NotEnoughFramesError

        sc = self._scene(sid)
        T = sc["images"].shape[0]
        try:
            ctx_idx, tgt_idx, _ = self.view_sampler.sample(sc["scene"], T, self.rng)
        except NotEnoughFramesError:
            return None
        extrinsics = sc["extrinsics"]
        # baseline-1 and frame-0-relative normalization (the training-time
        # camera convention of the RE10K loader)
        a, b = extrinsics[ctx_idx[0], :3, 3], extrinsics[ctx_idx[-1], :3, 3]
        scale = float(np.linalg.norm(a - b))
        if scale < 1e-6:
            return None
        extrinsics = extrinsics.copy()
        extrinsics[:, :3, 3] /= scale
        rel = np.linalg.inv(extrinsics[ctx_idx[0]])[None] @ extrinsics
        K = sc["intrinsics"]

        def views(idx):
            idx = np.asarray(idx)
            return {
                "extrinsics": rel[idx].astype(np.float32),
                "intrinsics": np.broadcast_to(K, (len(idx), 3, 3)).astype(np.float32),
                "image": sc["images"][idx].astype(np.float32),
                "near": np.full(len(idx), self.cfg.near / scale, np.float32),
                "far": np.full(len(idx), self.cfg.far / scale, np.float32),
                "index": idx.astype(np.int64),
            }

        example = {"context": views(ctx_idx), "target": views(tgt_idx),
                   "scene": sc["scene"]}
        if self.cfg.augment and self.stage == "train":
            from .shims import apply_augmentation_shim

            example = apply_augmentation_shim(example, self.rng)
        return example

    def __iter__(self) -> Iterator[dict]:
        reps = self.cfg.repeats if self.stage == "train" else 1
        for _ in range(reps):
            ids = list(self.ids)
            if self.stage == "train":
                self.rng.shuffle(ids)
            for sid in ids:
                ex = self._example(sid)
                if ex is not None:
                    yield ex
