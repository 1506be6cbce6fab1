"""Evaluation metrics (port of vicasplat_tpu/evaluation/metrics.py:24-170):
image quality (PSNR, SSIM) on tensors, and camera-trajectory quality (ATE
and RPE after a Umeyama Sim(3) alignment, rotation and translation angles,
pose AUC) in numpy, copied from the JAX package's."""
from __future__ import annotations

import numpy as np
import torch

from ..loss.ssim import ssim as _ssim


# ---------------------------------------------------------------------------
# image metrics
# ---------------------------------------------------------------------------

def compute_psnr(ground_truth: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    """PSNR of images in [0, 1], over the last three dims."""
    gt = ground_truth.clamp(0.0, 1.0)
    pr = predicted.clamp(0.0, 1.0)
    mse = ((gt - pr) ** 2).mean(dim=(-1, -2, -3))
    return -10.0 * torch.log10(mse.clamp(min=1e-12))


def compute_ssim(ground_truth: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    return _ssim(ground_truth.clamp(0, 1), predicted.clamp(0, 1))


# ---------------------------------------------------------------------------
# trajectory metrics
# ---------------------------------------------------------------------------

def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares Sim(3): find (s, R, t) minimizing ||y - (s R x + t)||.

    x, y: (3, N) point sets. Returns (R, t, s). Standard Umeyama (1991) —
    the same algorithm evo uses for `align=True, correct_scale=True`.
    """
    mean_x = x.mean(axis=1, keepdims=True)
    mean_y = y.mean(axis=1, keepdims=True)
    xc, yc = x - mean_x, y - mean_y
    n = x.shape[1]
    sigma2 = (xc**2).sum() / n
    cov = yc @ xc.T / n
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    # degenerate (zero-variance) trajectories: scale is unidentifiable,
    # fall back to 1 instead of propagating NaN (evo raises here; returning
    # identity alignment keeps batch evaluation going on static scenes)
    s = (
        float(np.trace(np.diag(d) @ S) / sigma2)
        if with_scale and sigma2 > 1e-12
        else 1.0
    )
    t = mean_y - s * R @ mean_x
    return R, t.squeeze(-1), s


def ate(gt_c2w: np.ndarray, pred_c2w: np.ndarray, correct_scale: bool = True):
    """Absolute trajectory error: RMSE of aligned positions (meters).

    Returns None (metric skipped, summaries use nanmean) rather than NaN
    when the trajectories are degenerate — non-finite poses or fewer than
    2 frames (reference evo raises here; we keep batch evaluation going)."""
    gt_pos = gt_c2w[:, :3, 3].T     # (3, N)
    pr_pos = pred_c2w[:, :3, 3].T
    if (gt_pos.shape[1] < 2 or not np.isfinite(gt_pos).all()
            or not np.isfinite(pr_pos).all()):
        return None
    R, t, s = umeyama_alignment(pr_pos, gt_pos, with_scale=correct_scale)
    aligned = s * R @ pr_pos + t[:, None]
    err = np.linalg.norm(aligned - gt_pos, axis=0)
    val = float(np.sqrt((err**2).mean()))
    return val if np.isfinite(val) else None


def _relative_poses(c2w: np.ndarray, delta: int = 1) -> np.ndarray:
    return np.linalg.inv(c2w[:-delta]) @ c2w[delta:]


def rpe(gt_c2w: np.ndarray, pred_c2w: np.ndarray, delta: int = 1):
    """Relative pose error over consecutive frames: (trans RMSE, rot RMSE deg).

    Trajectories are Sim(3)-aligned first (evo's align+scale semantics).
    Returns (None, None) on degenerate inputs (see ate()).
    """
    if (len(gt_c2w) <= delta or not np.isfinite(gt_c2w).all()
            or not np.isfinite(pred_c2w).all()):
        return None, None
    # scale-align prediction to GT first (monocular scale ambiguity)
    R, t, s = umeyama_alignment(
        pred_c2w[:, :3, 3].T, gt_c2w[:, :3, 3].T, with_scale=True
    )
    pred_aligned = pred_c2w.copy()
    pred_aligned[:, :3, 3] = (s * R @ pred_c2w[:, :3, 3].T + t[:, None]).T
    pred_aligned[:, :3, :3] = R @ pred_c2w[:, :3, :3]

    rel_gt = _relative_poses(gt_c2w, delta)
    rel_pr = _relative_poses(pred_aligned, delta)
    err = np.linalg.inv(rel_gt) @ rel_pr
    trans = np.linalg.norm(err[:, :3, 3], axis=-1)
    cos = np.clip((np.trace(err[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)
    rot_deg = np.degrees(np.arccos(cos))
    return float(np.sqrt((trans**2).mean())), float(np.sqrt((rot_deg**2).mean()))


def rotation_angle_deg(R1: np.ndarray, R2: np.ndarray) -> np.ndarray:
    """Geodesic angle between rotation matrices, degrees, batched."""
    cos = np.clip(
        (np.trace(R1 @ np.swapaxes(R2, -1, -2), axis1=-2, axis2=-1) - 1) / 2,
        -1, 1,
    )
    return np.degrees(np.arccos(cos))


def translation_angle_deg(t1: np.ndarray, t2: np.ndarray) -> np.ndarray:
    """Angle between translation directions, degrees, batched."""
    n = np.linalg.norm(t1, axis=-1) * np.linalg.norm(t2, axis=-1)
    cos = np.clip((t1 * t2).sum(-1) / np.maximum(n, 1e-10), -1, 1)
    return np.degrees(np.arccos(cos))


def camera_eval_metrics(gt_c2w: np.ndarray, pred_c2w: np.ndarray) -> dict:
    """ATE + RPE(trans, rot) + per-pair angular errors for one trajectory."""
    gt = np.asarray(gt_c2w, np.float64)
    pr = np.asarray(pred_c2w, np.float64)
    out = {}
    ate_val = ate(gt, pr)
    if ate_val is not None:
        out["ate"] = ate_val
    if len(gt) >= 3:
        rpe_t, rpe_r = rpe(gt, pr)
        if rpe_t is not None:
            out["rpe_trans"] = rpe_t
            out["rpe_rot"] = rpe_r
    # pairwise relative rotation/translation-direction errors vs frame 0
    if np.isfinite(gt).all() and np.isfinite(pr).all():
        rel_gt = np.linalg.inv(gt[:1]) @ gt[1:]
        rel_pr = np.linalg.inv(pr[:1]) @ pr[1:]
        out["rot_err_deg"] = rotation_angle_deg(
            rel_gt[:, :3, :3], rel_pr[:, :3, :3])
        out["trans_err_deg"] = translation_angle_deg(
            rel_gt[:, :3, 3], rel_pr[:, :3, 3])
    return out


def pose_auc(errors, thresholds=(5, 10, 20)) -> list:
    """Area under the recall curve at angular-error thresholds
    (reference cam_utils.py:186-198)."""
    errors = np.sort(np.asarray(errors, np.float64))
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    aucs = []
    for t in thresholds:
        last = np.searchsorted(errors, t)
        r = np.r_[recall[:last], recall[last - 1]]
        e = np.r_[errors[:last], t]
        aucs.append(float(np.trapezoid(r, x=e) / t))
    return aucs
