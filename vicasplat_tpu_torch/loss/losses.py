"""Training losses (port of vicasplat_tpu/loss/losses.py): mse, the camera
pose losses, translation direction, depth smoothness and the flagship's
total. SSIM is in loss/ssim.py, LPIPS in loss/lpips.py and the
distillation's Regr3D in loss/conf_point.py."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..geometry import dual_quaternion as dqlib
from ..geometry.projection import get_fov
from ..geometry.quaternion import matrix_to_quat
from ..geometry.se3 import camera_dq_array_from_Rt


@dataclasses.dataclass(frozen=True)
class LossMseConfig:
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class LossCameraConfig:
    weight: float = 0.1
    use_dq_loss: bool = True
    camera_type: str = "dq"
    # the angle between predicted and true translation directions; 0 = off
    trans_dir_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class LossLpipsConfig:
    weight: float = 0.05
    apply_after_step: int = 0


@dataclasses.dataclass(frozen=True)
class LossDepthConfig:
    weight: float = 0.25


def l1(a, b):
    """mean |a - b|, with JAX's derivative where a == b: +1, as lax.abs's
    (torch's abs takes 0 there). A zero-initialised camera head predicts
    the identity exactly, so the first step meets such entries."""
    d = a - b
    return torch.where(d >= 0, d, -d).mean()


def l2(a, b):
    return ((a - b) ** 2).mean()


def mse_loss(pred_color: torch.Tensor, target_color: torch.Tensor,
             cfg: LossMseConfig = LossMseConfig()) -> torch.Tensor:
    return cfg.weight * l2(pred_color, target_color)


def camera_dq_loss(pred_dq_array: torch.Tensor,
                   gt_dq_array: torch.Tensor) -> torch.Tensor:
    """L1(pred * gt^*, identity) + L1(gt * pred^*, identity)."""
    pred = dqlib.from_dq_array(pred_dq_array)
    gt = dqlib.from_dq_array(gt_dq_array)
    ident = dqlib.to_dq_array(dqlib.identity(
        pred_dq_array.shape[:-1], pred_dq_array.dtype, pred_dq_array.device))
    a = dqlib.to_dq_array(dqlib.dqmul(pred, dqlib.quaternion_conjugate(gt)))
    b = dqlib.to_dq_array(dqlib.dqmul(gt, dqlib.quaternion_conjugate(pred)))
    return l1(a, ident) + l1(b, ident)


def camera_loss(
    pred_extrins: torch.Tensor,        # (B, T-1, 8|7) normalized head output
    context_extrinsics: torch.Tensor,  # (B, T, 4, 4) c2w, frame-0-relative
    pred_intrins: Optional[torch.Tensor] = None,        # (B, 2) FoV
    context_intrinsics: Optional[torch.Tensor] = None,  # (B, T, 3, 3)
    cfg: LossCameraConfig = LossCameraConfig(),
) -> torch.Tensor:
    gt = context_extrinsics[:, 1:]
    if cfg.camera_type == "dq":
        gt_array = camera_dq_array_from_Rt(gt[..., :3, :3], gt[..., :3, 3])
        loss = l1(pred_extrins, gt_array)
        if cfg.use_dq_loss:
            loss = loss + camera_dq_loss(pred_extrins, gt_array)
    else:
        q = matrix_to_quat(gt[..., :3, :3])
        gt_array = torch.cat([q, gt[..., :3, 3]], dim=-1)
        loss = l1(pred_extrins, gt_array)
    if pred_intrins is not None and context_intrinsics is not None:
        loss = loss + l2(pred_intrins, get_fov(context_intrinsics.mean(dim=1)))
    loss = cfg.weight * loss
    if cfg.trans_dir_weight > 0.0:
        if cfg.camera_type == "dq":
            pred_t = dqlib.translation(
                dqlib.normalized(dqlib.from_dq_array(pred_extrins)))
        else:
            pred_t = pred_extrins[..., 4:7]
        loss = loss + cfg.trans_dir_weight * translation_direction_loss(
            pred_t, gt[..., :3, 3])
    return loss


def translation_direction_loss(pred_t: torch.Tensor,
                               gt_t: torch.Tensor) -> torch.Tensor:
    """Mean (1 - cos angle) between predicted and true translation
    directions over the pairs whose true translation is not ~0; the norms
    are smoothed so that the gradient stays finite at pred_t = 0."""
    pred_t, gt_t = pred_t.float(), gt_t.float()
    pn = torch.sqrt((pred_t ** 2).sum(-1) + 1e-12)
    gn = torch.sqrt((gt_t ** 2).sum(-1) + 1e-12)
    cos = (pred_t * gt_t).sum(-1) / (pn * gn)
    valid = (gn > 1e-4).to(cos.dtype)
    return ((1.0 - cos) * valid).sum() / valid.sum().clamp(min=1.0)


def depth_smoothness_loss(depth: torch.Tensor, image: torch.Tensor,
                          cfg: LossDepthConfig = LossDepthConfig()) -> torch.Tensor:
    """Edge-aware penalty on log-depth gradients: depth (B, V, H, W), image
    (B, V, H, W, 3)."""
    d = torch.log(depth.clamp(min=1e-6))
    dx = (d[..., :, 1:] - d[..., :, :-1]).abs()
    dy = (d[..., 1:, :] - d[..., :-1, :]).abs()
    ix = (image[..., :, 1:, :] - image[..., :, :-1, :]).abs().mean(-1)
    iy = (image[..., 1:, :, :] - image[..., :-1, :, :]).abs().mean(-1)
    return cfg.weight * ((dx * torch.exp(-ix)).mean() + (dy * torch.exp(-iy)).mean())


def total_loss(
    pred_color: torch.Tensor,
    target_color: torch.Tensor,
    pred_extrins: torch.Tensor,
    context_extrinsics: torch.Tensor,
    pred_intrins: Optional[torch.Tensor] = None,
    context_intrinsics: Optional[torch.Tensor] = None,
    mse_cfg: LossMseConfig = LossMseConfig(),
    cam_cfg: LossCameraConfig = LossCameraConfig(),
    lpips_fn=None,
    lpips_cfg: LossLpipsConfig = LossLpipsConfig(),
) -> tuple:
    """The flagship objective, mse + camera (+ lpips when a function is
    given). Returns (loss, {term: value})."""
    losses = {
        "mse": mse_loss(pred_color, target_color, mse_cfg),
        "camera": camera_loss(pred_extrins, context_extrinsics, pred_intrins,
                              context_intrinsics, cam_cfg),
    }
    if lpips_fn is not None:
        losses["lpips"] = lpips_cfg.weight * lpips_fn(pred_color, target_color)
    return sum(losses.values()), losses
