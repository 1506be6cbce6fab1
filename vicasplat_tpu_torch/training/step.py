"""The training step (port of vicasplat_tpu/training/step.py): encode the
context video -> Gaussians + poses, render the target views, sum the losses,
AdamW update.

Three phases, picked per step by `pick_phase`: "distill_only" (no render:
the camera loss and the frozen teacher's Regr3D term), "distill" (the full
objective plus the teacher's term) and "full".
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..decoder.splatting import DecoderSplattingConfig, decoder_forward
from ..loss.losses import (
    LossCameraConfig,
    LossLpipsConfig,
    LossMseConfig,
    camera_loss,
    mse_loss,
)
from ..loss.conf_point import Regr3DConfig, regr3d_loss
from ..models.vicasplat import VicaSplatConfig, vicasplat_forward
from .optimizer import AdamW, OptimizerConfig, global_norm


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: VicaSplatConfig = VicaSplatConfig()
    decoder: DecoderSplattingConfig = DecoderSplattingConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    mse: LossMseConfig = LossMseConfig()
    camera: LossCameraConfig = LossCameraConfig()
    lpips: LossLpipsConfig = LossLpipsConfig()
    dtype: str = "bfloat16"
    remat: bool = True
    # "none": recompute each block whole; "dots": keep the linear layers'
    # products (models/vicanet.py)
    remat_policy: str = "none"
    distill_weight: float = 1.0
    distill_only_steps: int = 0
    distill_max_steps: int = 0
    # micro-batches per step, their gradients averaged before one update
    accumulate_steps: int = 1


PHASES = ("distill_only", "distill", "full")


def anchor_frame(global_step: int, micro: int, T: int) -> int:
    """The first frame j of the anchor pair (j, j + 1), uniform over
    [0, max(T - 1, 1)), drawn from a host generator seeded by the step and
    the micro-batch. At T = 2 it is always 0, as JAX's draw is."""
    return int(np.random.default_rng([global_step, micro]).integers(0, max(T - 1, 1)))


def distillation_loss(out: dict, teacher_fn, batch: dict, anchor: int):
    """The teacher's term (JAX `distillation_loss`): the anchor frames
    (anchor, anchor + 1) through the frozen teacher, its points taken from
    view 1's camera into the canonical (first context) frame by the anchor's
    c2w pose, and Regr3D against the student's points and confidence there.
    Returns (loss, logs)."""
    ctx = batch["context"]
    T = ctx["image"].shape[1]
    idx = [anchor, anchor + 1]
    anchor_img = ctx["image"][:, idx]  # (B, 2, H, W, 3) in [0, 1]
    teacher = teacher_fn(anchor_img[:, 0] * 2 - 1, anchor_img[:, 1] * 2 - 1)
    first_ext = ctx["extrinsics"][:, anchor]  # (B, 4, 4)

    def to_canonical(pts):
        return (torch.einsum("bij,bhwj->bhwi", first_ext[:, :3, :3], pts)
                + first_ext[:, None, None, :3, 3])

    pseudo = torch.stack([to_canonical(teacher["view1"]["pts3d"]),
                          to_canonical(teacher["view2"]["pts3d"])], dim=1)
    pseudo_conf = torch.stack([teacher["view1"]["conf"], teacher["view2"]["conf"]],
                              dim=1)
    pred_pts = out["gaussian_centers"][:, idx]
    has_conf = out.get("confidence") is not None
    pred_conf = out["confidence"][:, idx] if has_conf else torch.ones_like(pseudo_conf)
    return regr3d_loss(pred_pts, pred_conf, pseudo, pseudo_conf,
                       Regr3DConfig(normalize_pointcloud=T > 2,
                                    match_confidence=has_conf))


def compute_loss(model: nn.Module, cfg: TrainConfig, batch: dict,
                 global_step: int, lpips_fn=None, phase: str = "full",
                 teacher_fn=None, anchor: Optional[int] = None):
    """batch: {"context": {image (B, T, H, W, 3) in [0, 1], intrinsics,
    extrinsics, near, far}, "target": {...}}. The context images are
    shimmed to [-1, 1] for the encoder. `phase` is one of PHASES; the two
    distillation phases need `teacher_fn` and take the anchor pair's first
    frame `anchor` (default: `anchor_frame(global_step, 0, T)`). Returns
    (loss, logs); "distill_only" logs the PSNR of an MSE of 1 (no render),
    as JAX does."""
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r} is not one of {PHASES}")
    if phase != "full" and teacher_fn is None:
        raise ValueError(f"phase {phase!r} needs a teacher")
    ctx, tgt = batch["context"], batch["target"]
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    out = vicasplat_forward(
        model, dict(ctx, image=ctx["image"] * 2.0 - 1.0), global_step,
        distill=phase == "distill_only", dtype=dtype, remat=cfg.remat,
        remat_policy=None if cfg.remat_policy == "none" else cfg.remat_policy)
    losses = {"camera": camera_loss(out["pred_extrins"], ctx["extrinsics"],
                                    out["pred_intrins"], ctx.get("intrinsics"),
                                    cfg.camera)}
    if phase == "distill_only":
        mse_val = torch.ones((), device=ctx["image"].device)
    else:
        h, w = tgt["image"].shape[-3:-1]
        rendered = decoder_forward(cfg.decoder, out["gaussians"], tgt["extrinsics"],
                                   tgt["intrinsics"], tgt["near"], tgt["far"], (h, w))
        losses["mse"] = mse_loss(rendered.color, tgt["image"], cfg.mse)
        if lpips_fn is not None:
            gate = 1.0 if global_step >= cfg.lpips.apply_after_step else 0.0
            losses["lpips"] = cfg.lpips.weight * gate * lpips_fn(rendered.color,
                                                                 tgt["image"])
        mse_val = ((rendered.color - tgt["image"]) ** 2).mean()
    if phase != "full":
        if anchor is None:
            anchor = anchor_frame(global_step, 0, ctx["image"].shape[1])
        d_loss, _ = distillation_loss(out, teacher_fn, batch, anchor)
        losses["distillation"] = cfg.distill_weight * d_loss
    loss = sum(losses.values())
    logs = dict(losses, psnr=-10.0 * torch.log10(mse_val.clamp(min=1e-10)))
    return loss, logs


def pick_phase(cfg: TrainConfig, global_step: int, has_teacher: bool) -> str:
    """The stage of a step: "distill_only" before distill_only_steps,
    "distill" up to distill_max_steps, then "full" (always "full" without a
    teacher)."""
    if has_teacher and global_step < cfg.distill_only_steps:
        return "distill_only"
    if has_teacher and global_step <= cfg.distill_max_steps:
        return "distill"
    return "full"


def make_train_step(cfg: TrainConfig, model: nn.Module, optimizer: AdamW,
                    lpips_fn=None, teacher_fn=None):
    """train_step(batch, global_step, phase="full") -> logs: one optimizer
    update of `model` in place. With accumulate_steps = A the batch splits
    into A contiguous micro-batches; their gradients, loss and logs are
    averaged. The distillation phases call `teacher_fn`
    (models/dust3r.make_teacher_fn, no parameter of `model`); micro-batch i
    draws its anchor pair by `anchor_frame(step, i, T)`. In "distill_only"
    the Gaussian-parameter head takes no part: its gradients are zeros, and
    AdamW still decays it, as optax does. Non-finite gradient entries
    become zero in each micro-batch (the NaN guard), before the average and
    the clip; logs["grad_norm"] is the norm of the averaged gradients before
    clipping, and `train_step.nonfinite` counts the entries the guard zeroed
    in the last step (a tensor, read without a host sync)."""
    params = [p for p in model.parameters() if p.requires_grad]

    def grads_once(batch, global_step, phase, micro=0):
        anchor = anchor_frame(global_step, micro, batch["context"]["image"].shape[1])
        loss, logs = compute_loss(model, cfg, batch, global_step, lpips_fn,
                                  phase, teacher_fn, anchor)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            params, torch.autograd.grad(loss, params, allow_unused=True))]
        finite = [torch.isfinite(g) for g in grads]
        train_step.nonfinite += sum((~f).sum() for f in finite)
        grads = [torch.where(f, g, torch.zeros_like(g))
                 for f, g in zip(finite, grads)]
        return loss.detach(), {k: v.detach() for k, v in logs.items()}, grads

    def train_step(batch: dict, global_step: int, phase: str = "full") -> dict:
        train_step.nonfinite = 0
        A = cfg.accumulate_steps
        if A <= 1:
            loss, logs, grads = grads_once(batch, global_step, phase)
        else:
            def split(tree):
                if isinstance(tree, dict):
                    return {k: split(v) for k, v in tree.items()}
                if tree.shape[0] % A:
                    raise ValueError(f"batch dim {tree.shape[0]} not divisible "
                                     f"by accumulate_steps={A}")
                return tree.split(tree.shape[0] // A)

            def pick(tree, i):
                if isinstance(tree, dict):
                    return {k: pick(v, i) for k, v in tree.items()}
                return tree[i]

            micro = split(batch)
            loss, logs, grads = grads_once(pick(micro, 0), global_step, phase)
            for i in range(1, A):
                li, lg, gi = grads_once(pick(micro, i), global_step, phase, i)
                loss = loss + li
                logs = {k: logs[k] + lg[k] for k in logs}
                grads = [a + b for a, b in zip(grads, gi)]
            grads = [g * (1.0 / A) for g in grads]
            loss = loss * (1.0 / A)
            logs = {k: v * (1.0 / A) for k, v in logs.items()}
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        logs["loss"] = loss
        logs["grad_norm"] = global_norm(grads)
        return logs

    return train_step
