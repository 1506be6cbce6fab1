"""The training step (port of vicasplat_tpu/training/step.py): encode the
context video -> Gaussians + poses, render the target views, sum the losses,
AdamW update.

The "full" phase is ported; main.py's train mode runs it. The distillation
phases need the frozen teacher (JAX `models/dust3r.py`), which is not
ported yet (ROADMAP.md §1 item 5b): they raise.
"""
from __future__ import annotations

import dataclasses

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


def compute_loss(model: nn.Module, cfg: TrainConfig, batch: dict,
                 global_step: int, lpips_fn=None, phase: str = "full"):
    """batch: {"context": {image (B, T, H, W, 3) in [0, 1], intrinsics,
    extrinsics, near, far}, "target": {...}}. The context images are
    shimmed to [-1, 1] for the encoder. Returns (loss, logs)."""
    if phase != "full":
        raise NotImplementedError(
            f"phase {phase!r} needs the distillation teacher, not ported")
    ctx, tgt = batch["context"], batch["target"]
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    out = vicasplat_forward(
        model, dict(ctx, image=ctx["image"] * 2.0 - 1.0), global_step,
        dtype=dtype, remat=cfg.remat,
        remat_policy=None if cfg.remat_policy == "none" else cfg.remat_policy)
    losses = {"camera": camera_loss(out["pred_extrins"], ctx["extrinsics"],
                                    out["pred_intrins"], ctx.get("intrinsics"),
                                    cfg.camera)}
    h, w = tgt["image"].shape[-3:-1]
    rendered = decoder_forward(cfg.decoder, out["gaussians"], tgt["extrinsics"],
                               tgt["intrinsics"], tgt["near"], tgt["far"], (h, w))
    losses["mse"] = mse_loss(rendered.color, tgt["image"], cfg.mse)
    if lpips_fn is not None:
        gate = 1.0 if global_step >= cfg.lpips.apply_after_step else 0.0
        losses["lpips"] = cfg.lpips.weight * gate * lpips_fn(rendered.color,
                                                             tgt["image"])
    mse_val = ((rendered.color - tgt["image"]) ** 2).mean()
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
                    lpips_fn=None):
    """train_step(batch, global_step, phase="full") -> logs: one optimizer
    update of `model` in place. With accumulate_steps = A the batch splits
    into A contiguous micro-batches; their gradients, loss and logs are
    averaged. Non-finite gradient entries become zero in each micro-batch
    (the NaN guard), before the average and the clip; logs["grad_norm"] is
    the norm of the averaged gradients before clipping, and
    `train_step.nonfinite` counts the entries the guard zeroed in the last
    step (a tensor, read without a host sync)."""
    params = [p for p in model.parameters() if p.requires_grad]

    def grads_once(batch, global_step, phase):
        loss, logs = compute_loss(model, cfg, batch, global_step, lpips_fn,
                                  phase)
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
                li, lg, gi = grads_once(pick(micro, i), global_step, phase)
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
