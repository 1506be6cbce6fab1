"""Long-video reconstruction (port of vicasplat_tpu/streaming.py): sliding
windows, scale-aligned pose chaining, and Gaussians re-based into one global
frame.

- A T-frame window slides with `overlap` shared frames (stride T - overlap),
  and each window is reconstructed on its own: frame 0 is the identity, at
  the window's own monocular scale. Every window replays the engine's one
  captured reconstruct program.
- Each window's scale is aligned to the running global scale by the median
  ratio of relative-translation magnitudes over the shared frames.
- Poses chain through the shared frame: G_k = G_prev @ pose_prev[shift].
- The Gaussians of each window's new frames are re-based rigidly into the
  global frame, eagerly on the card (means, covariances and rotations
  rotated, SH rotated by `ops.sh.rotate_sh`, the scale applied); the
  overlap frames keep the earlier window's Gaussians.

The chaining math is host numpy on (4, 4) matrices, copied from the JAX
package.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from .geometry.quaternion import matrix_to_quat, qmul
from .models.adapter import Gaussians
from .ops.sh import rotate_sh


# ---------------------------------------------------------------------------
# chaining math (host, numpy)
# ---------------------------------------------------------------------------

def plan_windows(n_frames: int, window: int, overlap: int):
    """Start indices of each window; the last window is shifted left to end
    exactly at n_frames (its overlap with the previous one then grows)."""
    if n_frames < window:
        raise ValueError(f"need >= {window} frames, got {n_frames}")
    if not 1 <= overlap < window:
        raise ValueError("overlap must be in [1, window)")
    step = window - overlap
    starts = list(range(0, n_frames - window + 1, step))
    if starts[-1] + window < n_frames:
        starts.append(n_frames - window)
    return starts


def align_window_scale(prev_poses: np.ndarray, cur_poses: np.ndarray,
                       shift: int) -> float:
    """Scale of the current window relative to the previous one: the median
    ratio of consecutive shared frames' translation steps. The current
    window's frame j is the previous window's frame j + shift."""
    T = cur_poses.shape[0]
    n_shared = T - shift
    ratios = []
    for j in range(n_shared - 1):
        d_prev = np.linalg.norm(prev_poses[shift + j + 1, :3, 3]
                                - prev_poses[shift + j, :3, 3])
        d_cur = np.linalg.norm(cur_poses[j + 1, :3, 3] - cur_poses[j, :3, 3])
        if d_cur > 1e-9 and d_prev > 1e-9:
            ratios.append(d_prev / d_cur)
    return float(np.median(ratios)) if ratios else 1.0


def chain_windows(window_poses, starts):
    """Per-window local poses (T, 4, 4) -> (global poses (F, 4, 4), scales,
    bases): window k's local pose p becomes `bases[k] @ scale_t(p,
    scales[k])`, scale_t scaling the translation. Overlap frames keep the
    earlier window's pose."""
    T = window_poses[0].shape[0]
    n_frames = starts[-1] + T
    global_poses = np.zeros((n_frames, 4, 4))
    scales, bases = [], []
    base = np.eye(4)
    scale = 1.0
    for k, (s, poses) in enumerate(zip(starts, window_poses)):
        if k > 0:
            shift = s - starts[k - 1]
            rel_scale = align_window_scale(window_poses[k - 1], poses, shift)
            scale = scales[k - 1] * rel_scale
            prev_anchor = window_poses[k - 1][shift].copy()
            prev_anchor[:3, 3] *= scales[k - 1]
            base = bases[k - 1] @ prev_anchor
        scales.append(scale)
        bases.append(base)
        first_new = 0 if k == 0 else (starts[k - 1] + T) - s
        for j in range(first_new, T):
            p = poses[j].copy()
            p[:3, 3] *= scale
            global_poses[s + j] = base @ p
    return global_poses, np.asarray(scales), np.stack(bases)


# ---------------------------------------------------------------------------
# Gaussian re-basing (eager, on the Gaussians' device)
# ---------------------------------------------------------------------------

def rebase_gaussians(g: Gaussians, base: torch.Tensor, scale: torch.Tensor,
                     sh_degree: int) -> Gaussians:
    """Rigidly transform pixel-aligned Gaussians (leading dims arbitrary)
    by the 4x4 `base` after scaling the window's metric by `scale`."""
    R, t = base[:3, :3], base[:3, 3]
    means = scale * g.means @ R.T + t
    cov = (scale ** 2) * torch.einsum("ij,...jk,lk->...il", R, g.covariances, R)
    q_r = matrix_to_quat(R).expand(g.rotations.shape)
    return Gaussians(means=means, covariances=cov,
                     harmonics=rotate_sh(g.harmonics, R, degree=sh_degree),
                     opacities=g.opacities, scales=scale * g.scales,
                     rotations=qmul(q_r, g.rotations))


# ---------------------------------------------------------------------------
# engine orchestration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamedScene:
    """Global-frame reconstruction of a long video."""
    gaussians: Gaussians          # leading dims (F, H, W), one frame each
    poses: np.ndarray             # (F, 4, 4) global c2w, frame 0 identity
    intrinsics: Optional[np.ndarray]  # (F, 3, 3) when predicted
    window_scales: np.ndarray     # per-window scale factors applied


def _field(g: Gaussians, fn) -> Gaussians:
    return Gaussians(*(None if x is None else fn(x) for x in g))


@torch.no_grad()
def reconstruct_video(engine, images01, intrinsics=None, window: int = 8,
                      overlap: int = 2) -> StreamedScene:
    """Reconstruct a monocular video of any length with a fixed-T engine.
    images01: (F, H, W, 3) float in [0, 1]; intrinsics (F, 3, 3) normalized
    (optional if the model predicts them)."""
    images01 = np.asarray(images01)
    F = images01.shape[0]
    starts = plan_windows(F, window, overlap)
    if overlap < 2 and len(starts) > 1:
        warnings.warn(
            "overlap=1 leaves zero shared relative translations, so "
            "per-window monocular scale cannot be aligned (scale factors "
            "stay 1.0 and the global metric may drift between windows); "
            "use overlap >= 2", stacklevel=2)
    sh_degree = engine.cfg.gaussian_adapter.sh_degree

    window_poses, window_scenes, window_intr = [], [], []
    for s in starts:
        K = None if intrinsics is None else np.asarray(intrinsics[s:s + window])[None]
        scene = engine.reconstruct(images01[s:s + window][None], K)
        window_scenes.append(scene)
        window_poses.append(scene.poses[0].double().cpu().numpy())
        window_intr.append(None if scene.intrinsics is None
                           else scene.intrinsics[0].float().cpu().numpy())

    global_poses, scales, bases = chain_windows(window_poses, starts)

    frame_gaussians = [None] * F
    intr_out = None if window_intr[0] is None else np.zeros((F, 3, 3))
    dev = engine.device
    for k, (s, scene) in enumerate(zip(starts, window_scenes)):
        first_new = 0 if k == 0 else (starts[k - 1] + window) - s
        g_new = _field(scene.gaussians, lambda x: x[0, first_new:].float())
        g_new = rebase_gaussians(
            g_new, torch.as_tensor(bases[k], dtype=torch.float32).to(dev),
            torch.tensor(scales[k], dtype=torch.float32).to(dev), sh_degree)
        for j in range(first_new, window):
            frame_gaussians[s + j] = _field(g_new, lambda x: x[j - first_new])
            if intr_out is not None:
                intr_out[s + j] = window_intr[k][j]
    gaussians = Gaussians(*(torch.stack(xs) for xs in zip(*frame_gaussians)))
    return StreamedScene(gaussians=gaussians, poses=global_poses,
                         intrinsics=intr_out, window_scales=scales)
