"""Regr3D distillation loss (port of vicasplat_tpu/loss/conf_point.py):
confidence-weighted 3D point regression against a frozen teacher's point
maps. Teacher points outside each example's 1 % - 99 % distance quantiles
are masked out; with more than two views both point sets are normalized to
unit mean distance; the point term is conf |p - p_t|^2 - alpha log(conf),
plus an L1 match of the confidences."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Regr3DConfig:
    weight: float = 1.0
    alpha: float = 0.2          # weight of the log-confidence regularizer
    quantile_lo: float = 0.01
    quantile_hi: float = 0.99
    normalize_pointcloud: bool = False
    match_confidence: bool = True


def normalize_pointcloud(pts: torch.Tensor, valid: torch.Tensor):
    """Per example, scale points so that their masked mean distance to the
    origin is 1. pts (B, V, H, W, 3), valid (B, V, H, W); returns (points,
    scale (B, 1, 1, 1))."""
    dist = torch.linalg.vector_norm(pts, dim=-1)
    denom = (dist * valid).sum(dim=(1, 2, 3)) / valid.sum(dim=(1, 2, 3)).clamp(min=1.0)
    scale = denom.clamp(min=1e-8)[:, None, None, None, None]
    return pts / scale, scale[..., 0]


def regr3d_loss(pred_pts: torch.Tensor, pred_conf: torch.Tensor,
                teacher_pts: torch.Tensor, teacher_conf: torch.Tensor,
                cfg: Regr3DConfig = Regr3DConfig()):
    """pred_pts, teacher_pts (B, V, H, W, 3) in the canonical frame;
    pred_conf (>= 1), teacher_conf (B, V, H, W). Returns (loss, logs).
    The quantiles interpolate linearly, as jnp.quantile's do."""
    dist = torch.linalg.vector_norm(teacher_pts.float(), dim=-1)
    flat = dist.reshape(dist.shape[0], -1)
    q = torch.tensor([cfg.quantile_lo, cfg.quantile_hi], dtype=flat.dtype,
                     device=flat.device)
    lo, hi = torch.quantile(flat, q, dim=-1)[:, :, None, None, None]
    valid = ((dist >= lo) & (dist <= hi)).float()

    if cfg.normalize_pointcloud:
        pred_pts, _ = normalize_pointcloud(pred_pts, valid)
        teacher_pts, _ = normalize_pointcloud(teacher_pts, valid)

    sq = ((pred_pts - teacher_pts) ** 2).sum(-1)
    conf = pred_conf.clamp(min=1.0 + 1e-6)
    weighted = conf * sq - cfg.alpha * torch.log(conf)
    denom = valid.sum().clamp(min=1.0)
    point_loss = (weighted * valid).sum() / denom

    logs = {"regr3d_point": point_loss}
    loss = point_loss
    if cfg.match_confidence:
        conf_loss = ((pred_conf - teacher_conf).abs() * valid).sum() / denom
        logs["regr3d_conf"] = conf_loss
        loss = loss + conf_loss
    return cfg.weight * loss, logs
