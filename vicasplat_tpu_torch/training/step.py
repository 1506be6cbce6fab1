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
from .optimizer import AdamW, OptimizerConfig, local


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
                 teacher_fn=None, anchor: Optional[int] = None,
                 parallel: Optional[dict] = None):
    """batch: {"context": {image (B, T, H, W, 3) in [0, 1], intrinsics,
    extrinsics, near, far}, "target": {...}}. The context images are
    shimmed to [-1, 1] for the encoder. `phase` is one of PHASES; the two
    distillation phases need `teacher_fn` and take the anchor pair's first
    frame `anchor` (default: `anchor_frame(global_step, 0, T)`). Returns
    (loss, logs); "distill_only" logs the PSNR of an MSE of 1 (no render),
    as JAX does. `parallel`: the backbone's mesh arguments
    (vicasplat_forward)."""
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r} is not one of {PHASES}")
    if phase != "full" and teacher_fn is None:
        raise ValueError(f"phase {phase!r} needs a teacher")
    ctx, tgt = batch["context"], batch["target"]
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    out = vicasplat_forward(
        model, dict(ctx, image=ctx["image"] * 2.0 - 1.0), global_step,
        distill=phase == "distill_only", dtype=dtype, remat=cfg.remat,
        remat_policy=None if cfg.remat_policy == "none" else cfg.remat_policy,
        parallel=parallel)
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


def _wrap_ddp(model: nn.Module, group):
    from torch.nn.parallel import DistributedDataParallel

    dev = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        process_group=group, broadcast_buffers=False,
        # the distill_only phase leaves the Gaussian-parameter head unused
        find_unused_parameters=True)


def _sq_norm_sum(params, grads, split_group: dict):
    """The sum of squares of every gradient of the whole model: a gradient
    split over a group (split_group[id(p)]: an FSDP shard, a pipeline
    stage's blocks, a tensor-parallel slice, a rank's experts) summed over
    that group, anything else counted once."""
    import torch.distributed as dist

    total = torch.zeros((), device=grads[0].device)
    split = {}  # id(group) -> [group, sum], in the same order on every rank
    for p, g in zip(params, grads):
        sq = (local(g).float() ** 2).sum()
        group = split_group.get(id(p))
        if group is None:
            total = total + sq
        else:
            entry = split.setdefault(id(group), [group, 0.0])
            entry[1] = entry[1] + sq
    for group, sq in split.values():
        dist.all_reduce(sq, group=group)
        total = total + sq
    return total


def _in_block_stack(p) -> bool:
    """A parameter of a block that runs on one pipeline stage only (marked
    by parallel/pp.pipeline_scan)."""
    return getattr(p, "_pipeline_block", False)


def _average_replicas(grads: list, group) -> None:
    """The gradients of the parameters that every pipeline stage holds (the
    rest of the step: heads, render, losses), averaged over the stages in
    place. Each stage computes its own copy of them, and the render's
    atomics leave those copies a rounding apart on the card: unaveraged,
    the replicas would drift apart."""
    import torch.distributed as dist

    _all_reduce_div(grads, group, dist.get_world_size(group))


# the largest flat buffer of one all-reduce in the step's reduction (gloo
# moves a CUDA tensor through the host, one call per bucket)
BUCKET_BYTES = 1 << 28


def _all_reduce_div(tensors, group, divisor: int):
    """Sum each tensor over `group` in place, then divide it by `divisor`;
    the tensors go in flat buckets of one dtype of at most BUCKET_BYTES."""
    import torch.distributed as dist

    if group is not None and dist.get_world_size(group) > 1:
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            i = 0
            while i < len(ts):
                j, size = i + 1, ts[i].numel() * ts[i].element_size()
                while j < len(ts) and size + ts[j].numel() * ts[j].element_size() \
                        <= BUCKET_BYTES:
                    size += ts[j].numel() * ts[j].element_size()
                    j += 1
                flat = torch.cat([t.reshape(-1) for t in ts[i:j]])
                dist.all_reduce(flat, group=group)
                for t, f in zip(ts[i:j], flat.split([t.numel() for t in ts[i:j]])):
                    t.copy_(f.view_as(t))
                i = j
    if divisor != 1:
        for t in tensors:
            t.div_(divisor)


def make_train_step(cfg: TrainConfig, model: nn.Module, optimizer: AdamW,
                    lpips_fn=None, teacher_fn=None, *, ddp_group=None,
                    pipeline_group=None, pipeline_n_micro: Optional[int] = None,
                    sp_mesh=None):
    """train_step(batch, global_step, phase="full") -> logs: one optimizer
    update of `model` in place. With accumulate_steps = A the batch splits
    into A contiguous micro-batches; their gradients, loss and logs are
    averaged. The distillation phases call `teacher_fn`
    (models/dust3r.make_teacher_fn, no parameter of `model`); micro-batch i
    draws its anchor pair by `anchor_frame(step, i, T)`. In "distill_only"
    the Gaussian-parameter head takes no part: its gradients are zeros, and
    AdamW still decays it, as optax does. Non-finite gradient entries
    become zero in each micro-batch's gradient (the NaN guard), before the
    average and the clip; logs["grad_norm"] is the norm of the averaged
    gradients before clipping, and `train_step.nonfinite` counts the entries
    the guard zeroed in the last step (a tensor, read without a host sync).

    Every route runs the same step: the model's forward (`VicaSplat.forward`
    applies compute_loss) through its wrapper, if any, then `.backward()`,
    then the guard on the gradient that the route has reduced, each
    micro-batch's. Each equals the single-process step on the whole batch,
    guard included, and each rank passes its own slice of the global batch
    (parallel/mesh.shard_batch):
    - ddp_group: data parallelism by DDP. Each rank renders only its own
      examples. DDP averages each micro-batch's gradients across the group
      (no `no_sync`), so the guard sees the micro-batch's gradient of the
      whole batch, as JAX's data mesh guards it.
    - a model sharded by parallel/mesh.shard_params_fsdp (FSDP2): the same
      on the local shards, the small replicated leaves' gradients averaged
      here.
    - pipeline_group (pipeline_n_micro): the backbone's stacks as a GPipe
      pipeline (parallel/pp.py; shard_params_pp on the model's stacks);
      each stage updates its own blocks, the clip takes the norm over all.
      Every stage runs its own copy of the rest of the step, whose
      gradients the render's atomics leave a rounding apart: they are
      averaged over the stages, so that the replicas stay equal.
    - sp_mesh: sequence parallelism on a ("data", "seq") mesh (JAX's
      make_train_step(sp_mesh=...); parallel/sp.py). Each rank passes its
      "data" slice and computes its "data" row's loss; every gradient is
      averaged over the mesh (the adjoint convention: the "seq" ranks'
      gradients sum to n_seq times their loss's). A MoE model routes its
      "data" row's tokens together.
    - a model sharded by parallel/tp.shard_params_tp: tensor parallelism
      on its ("data", "model") mesh, each rank passing its "data" slice.
      Megatron's one-copy convention: every "model" rank holds the whole
      gradient of its slices and of each replicated leaf. Slices are
      averaged over "data", replicated leaves over the mesh (equal on the
      "model" ranks, so the replicas stay bit for bit equal); the clip's
      norm sums the slices' squares over "model".
    - a model sharded by parallel/ep.shard_params_ep: expert parallelism on
      its ("data", "expert") mesh, each rank passing its slice of the
      batch over both axes. Replicated leaves (the router included) are
      averaged over the mesh; each expert's gradient, summed by the
      all_to_all's backward over the ranks its tokens came from, is summed
      over "data" and divided by the mesh's size; the clip's norm counts
      each expert once.
    Sequence, tensor and expert parallelism take no other route with them;
    a model sharded for EP refuses sp_mesh, as JAX's forward does."""
    import torch.distributed as dist

    from ..parallel.mesh import mesh_group

    fsdp_group = getattr(model, "fsdp_group", None)
    params = [p for p in model.parameters() if p.requires_grad and not p.is_meta]
    # parameters sliced by parallel/tp.py or ep.py, each marked by its split
    splits = {id(p): p._grad_split for p in params if hasattr(p, "_grad_split")}
    kinds = {id(s): s for s in splits.values()}
    routes = [name for name, on in (
        ("ddp_group", ddp_group is not None), ("pipeline_group", pipeline_group is not None),
        ("FSDP2", fsdp_group is not None), ("sp_mesh", sp_mesh is not None))
        if on] + ["tensor or expert parallelism"] * len(kinds)
    if (sp_mesh is not None or splits) and len(routes) > 1:
        raise ValueError(f"sequence, tensor and expert parallelism train alone: "
                         f"{routes}")
    entry = _wrap_ddp(model, ddp_group) if ddp_group is not None else model
    parallel = {}
    if pipeline_group is not None:
        parallel.update(pipeline_group=pipeline_group,
                        pipeline_n_micro=pipeline_n_micro)
    if ddp_group is not None and cfg.model.backbone.moe_experts:
        parallel["moe_token_group"] = ddp_group  # route the whole batch
    # reduce: (parameters, group, divisor), each gradient summed over the
    # group and divided; norm_split: the group each split gradient's
    # squares are summed over for the clip's norm
    reduce, norm_split = [], {}
    reduce_group = ddp_group if ddp_group is not None else fsdp_group
    if fsdp_group is not None:
        replicated = {id(p) for p in model.fsdp_replicated}
        reduce.append(([p for p in params if id(p) in replicated], fsdp_group,
                       dist.get_world_size(fsdp_group)))
        norm_split.update((id(p), fsdp_group) for p in params if hasattr(p, "to_local"))
    if sp_mesh is not None:
        parallel["sp_mesh"] = sp_mesh
        reduce_group = mesh_group(sp_mesh)
        reduce.append((params, reduce_group, sp_mesh.size()))
        if cfg.model.backbone.moe_experts:
            parallel["moe_token_group"] = sp_mesh.get_group("data")
    for cut in kinds.values():  # at most one
        reduce_group = cut.mesh
        if cut.tokens is not None:
            parallel["moe_token_group"] = cut.tokens
        reduce.append(([p for p in params if id(p) in splits], cut.reduce, cut.divisor))
        reduce.append(([p for p in params if id(p) not in splits], cut.mesh,
                       cut.mesh_size))
        norm_split.update((i, cut.norm) for i in splits)

    def average(t, group):
        if group is None:
            return t
        t = t.detach().clone()
        dist.all_reduce(t, group=group)
        return t / dist.get_world_size(group)

    def grads_once(batch, global_step, phase, micro=0):
        anchor = anchor_frame(global_step, micro, batch["context"]["image"].shape[1])
        for p in params:
            p.grad = None
        loss, logs = entry(compute_loss, cfg, batch, global_step, lpips_fn,
                           phase, teacher_fn, anchor, parallel)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        index = {id(p): i for i, p in enumerate(params)}
        for ps, group, divisor in reduce:
            _all_reduce_div([local(grads[index[id(p)]]) for p in ps], group, divisor)
        if pipeline_group is not None:  # the replicated rest (marked by the forward)
            _average_replicas([grads[index[id(p)]] for p in params
                               if not _in_block_stack(p)], pipeline_group)
        for g in grads:  # the NaN guard, on each rank's own shard
            gl = local(g)
            f = torch.isfinite(gl)
            train_step.nonfinite += (~f).sum()
            gl.copy_(torch.where(f, gl, torch.zeros_like(gl)))
        logs = {k: v.detach() for k, v in logs.items()}
        if "psnr" in logs and reduce_group is not None \
                and dist.get_world_size(reduce_group) > 1:
            # the PSNR of the batch's MSE, as JAX's data mesh logs it, not
            # the mean of the ranks' PSNRs: averaged through the MSE
            mse = average(10.0 ** (-0.1 * logs["psnr"]), reduce_group)
            logs["psnr"] = -10.0 * torch.log10(mse)
        logs = {k: v if k == "psnr" else average(v, reduce_group)
                for k, v in logs.items()}
        return average(loss.detach(), reduce_group), logs, grads

    def split(tree, A):
        if isinstance(tree, dict):
            return {k: split(v, A) for k, v in tree.items()}
        if tree.shape[0] % A:
            raise ValueError(f"batch dim {tree.shape[0]} not divisible "
                             f"by accumulate_steps={A}")
        return tree.split(tree.shape[0] // A)

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    def train_step(batch: dict, global_step: int, phase: str = "full") -> dict:
        train_step.nonfinite = 0
        A = cfg.accumulate_steps
        if A <= 1:
            loss, logs, grads = grads_once(batch, global_step, phase)
        else:
            micro = split(batch, A)
            loss, logs, grads = grads_once(pick(micro, 0), global_step, phase)
            for i in range(1, A):
                li, lg, gi = grads_once(pick(micro, i), global_step, phase, i)
                loss = loss + li
                logs = {k: logs[k] + lg[k] for k in logs}
                for a, b in zip(grads, gi):  # no other reference: p.grad was reset
                    a.add_(b)
                del gi
            grads = [g * (1.0 / A) for g in grads]
            loss = loss * (1.0 / A)
            logs = {k: v * (1.0 / A) for k, v in logs.items()}
        for p, g in zip(params, grads):
            p.grad = g
        if pipeline_group is not None:  # marked by the forward
            norm_split.update((id(p), pipeline_group) for p in params
                              if _in_block_stack(p))
        g_norm = torch.sqrt(_sq_norm_sum(params, grads, norm_split))
        optimizer.step(g_norm=g_norm)
        logs["loss"] = loss
        logs["grad_norm"] = g_norm
        return logs

    return train_step
