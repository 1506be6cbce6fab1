"""Novel-view-synthesis test harness (port of
vicasplat_tpu/evaluation/nvs_eval.py:29-262): per scene, encode the
context, align each target view's pose by gradient descent through the
render, render the targets, score PSNR and SSIM (and LPIPS when given)
against them and ATE / RPE of the predicted context poses, and save
transforms.json, the context and rendered PNGs and a comparison grid.

The encode runs in bf16 over the model's float32 parameters on images
scaled to [-1, 1]. The alignment is the JAX package's optax
`multi_transform` of two Adams over the (B, V, 3) rotation and translation
deltas, here two parameter groups of one `torch.optim.Adam` (the same
update: lr * m_hat / (sqrt(v_hat) + 1e-8)); its gradients flow through
`decoder_forward`'s pose deltas.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional

import numpy as np
import torch

from ..decoder.splatting import DecoderSplattingConfig, coverage_report, decoder_forward
from ..loss.ssim import ssim
from ..models.vicasplat import VicaSplatConfig, vicasplat_forward
from ..utils.benchmarker import Benchmarker
from ..utils.image_io import hcat, save_image, save_video
from ..utils.ply import export_ply
from .metrics import camera_eval_metrics, compute_psnr, compute_ssim


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    output_path: str = "outputs/eval_results"
    align_pose: bool = True
    pose_align_steps: int = 100
    rot_opt_lr: float = 0.005
    trans_opt_lr: float = 0.005
    compute_scores: bool = True
    save_image: bool = True
    save_video: bool = False
    save_compare: bool = True
    save_gs: bool = False
    # per-scene rasterizer coverage diagnostics (coverage_report): warn when
    # the static-shape caps (dup_hw, max_per_tile) truncate the scene
    coverage_check: bool = True


def make_align_objective(loss_cfg=None, lpips_fn=None):
    """(image_loss(pred, target), mode) for test-time pose alignment: the
    experiment's image losses ("mse", "mse+lpips") from `loss_cfg`, or,
    with no loss_cfg or with LPIPS configured but no `lpips_fn`, the
    stand-in 0.8 * MSE + 0.2 * (1 - SSIM) ("ssim_fallback")."""
    use_protocol = loss_cfg is not None and loss_cfg.mse is not None
    if use_protocol and loss_cfg.lpips is not None and lpips_fn is None:
        use_protocol = False
    if use_protocol:
        lpips_weight = loss_cfg.lpips.weight if loss_cfg.lpips is not None else 0.0
        mse_weight = loss_cfg.mse.weight

        def image_loss(pred, target):
            total = mse_weight * ((pred - target) ** 2).mean()
            if lpips_weight > 0.0:
                total = total + lpips_weight * lpips_fn(pred, target)
            return total

        return image_loss, ("mse+lpips" if lpips_weight > 0.0 else "mse")

    def image_loss(pred, target):
        mse = ((pred - target) ** 2).mean()
        return 0.8 * mse + 0.2 * (1.0 - ssim(pred, target))

    return image_loss, "ssim_fallback"


def make_pose_align_step(model_cfg: VicaSplatConfig, dec_cfg: DecoderSplattingConfig,
                         eval_cfg: EvalConfig, image_shape, loss_cfg=None,
                         lpips_fn=None):
    """align(gaussians, tgt) -> {"rot", "trans"}: `pose_align_steps` Adam
    steps on per-target-view SE(3) deltas, rendering against the targets."""
    image_loss, _ = make_align_objective(loss_cfg, lpips_fn)

    def align(gaussians, tgt):
        b, v = tgt["extrinsics"].shape[:2]
        dev = tgt["extrinsics"].device
        rot = torch.zeros(b, v, 3, device=dev, requires_grad=True)
        trans = torch.zeros(b, v, 3, device=dev, requires_grad=True)
        opt = torch.optim.Adam([{"params": [rot], "lr": eval_cfg.rot_opt_lr},
                                {"params": [trans], "lr": eval_cfg.trans_opt_lr}])
        with torch.enable_grad():
            for _ in range(eval_cfg.pose_align_steps):
                rendered = decoder_forward(
                    dec_cfg, gaussians, tgt["extrinsics"], tgt["intrinsics"],
                    tgt["near"], tgt["far"], image_shape,
                    cam_rot_delta=rot, cam_trans_delta=trans)
                opt.zero_grad(set_to_none=True)
                image_loss(rendered.color, tgt["image"]).backward()
                opt.step()
        return {"rot": rot.detach(), "trans": trans.detach()}

    return align


def default_encode(model, ctx):
    return vicasplat_forward(model, dict(ctx, image=ctx["image"] * 2 - 1),
                             dtype=torch.bfloat16)


@torch.no_grad()
def evaluate_scene(model, model_cfg: VicaSplatConfig, dec_cfg: DecoderSplattingConfig,
                   eval_cfg: EvalConfig, batch: dict, encode_fn=None, render_fn=None,
                   align_fn=None, benchmarker: Optional[Benchmarker] = None,
                   lpips_fn=None) -> dict:
    """One scene (a batch of 1, tensors on the model's device): scores and
    coverage as floats, and `_rendered`, `_depth` (numpy) and `_outputs`
    (the encoder's) for `save_scene_outputs`."""
    ctx, tgt = batch["context"], batch["target"]
    assert ctx["image"].shape[0] == 1, (
        "evaluate_scene scores one scene at a time; split batches first")
    h, w = tgt["image"].shape[-3:-1]
    bench = benchmarker or Benchmarker()
    encode_fn = encode_fn or default_encode
    if render_fn is None:
        def render_fn(g, t, rot, trans):
            return decoder_forward(dec_cfg, g, t["extrinsics"], t["intrinsics"],
                                   t["near"], t["far"], (h, w),
                                   cam_rot_delta=rot, cam_trans_delta=trans)

    out = bench.time_fn("encoder", encode_fn, model, ctx)
    gaussians = out["gaussians"]

    b, v = tgt["extrinsics"].shape[:2]
    zeros = torch.zeros(b, v, 3, device=tgt["extrinsics"].device)
    deltas = {"rot": zeros, "trans": zeros}
    if eval_cfg.align_pose and eval_cfg.pose_align_steps > 0 and align_fn is not None:
        deltas = bench.time_fn("pose_align", align_fn, gaussians, tgt)

    rendered = bench.time_fn("decoder", render_fn, gaussians, tgt, deltas["rot"],
                             deltas["trans"])

    result = {"scene": batch.get("scene", ["?"])[0]}
    if eval_cfg.coverage_check:
        cov = coverage_report(dec_cfg, gaussians, tgt["extrinsics"], tgt["intrinsics"],
                              (h, w), tag=str(result["scene"]))
        result["coverage_truncated_frac"] = cov["truncated_frac"]
        result["coverage_tile_overflow_frac"] = cov["tile_overflow_frac"]
    if eval_cfg.compute_scores:
        result["psnr"] = float(compute_psnr(tgt["image"], rendered.color).mean())
        result["ssim"] = float(compute_ssim(tgt["image"], rendered.color))
        if lpips_fn is not None:
            result["lpips"] = float(lpips_fn(tgt["image"], rendered.color))
        gt_poses = ctx["extrinsics"][0].double().cpu().numpy()
        pred_poses = out["gaussian_camera_extrins"][0].double().cpu().numpy()
        result.update({k: v for k, v in camera_eval_metrics(gt_poses, pred_poses).items()
                       if np.isscalar(v) or isinstance(v, float)})
    result["_rendered"] = rendered.color[0].float().cpu().numpy()
    result["_depth"] = rendered.depth[0].float().cpu().numpy()
    result["_deltas"] = {k: x.cpu().numpy() for k, x in deltas.items()}
    result["_outputs"] = out
    return result


def save_scene_outputs(result: dict, batch: dict, eval_cfg: EvalConfig,
                       model_cfg: VicaSplatConfig):
    """Write transforms.json, per-view PNGs, compare.png and the PLY under
    `output_path/<scene>`."""
    out_dir = pathlib.Path(eval_cfg.output_path) / str(result["scene"])
    out_dir.mkdir(parents=True, exist_ok=True)
    out = result["_outputs"]
    ctx = {k: v.cpu().numpy() for k, v in batch["context"].items()
           if isinstance(v, torch.Tensor)}
    tgt_images = batch["target"]["image"][0].cpu().numpy()

    poses = out["gaussian_camera_extrins"][0].double().cpu().numpy()
    intr = ctx["intrinsics"][0]
    h, w = ctx["image"].shape[2:4]
    transforms = {
        "camera_model": "PINHOLE",
        "fl_x": float(intr[0, 0, 0] * w),
        "fl_y": float(intr[0, 1, 1] * h),
        "cx": float(intr[0, 0, 2] * w),
        "cy": float(intr[0, 1, 2] * h),
        "w": int(w),
        "h": int(h),
        "frames": [{"file_path": f"context/{i:03d}.png",
                    "transform_matrix": poses[i].tolist()} for i in range(len(poses))],
    }
    with open(out_dir / "transforms.json", "w") as f:
        json.dump(transforms, f, indent=2)

    if eval_cfg.save_image:
        for i, img in enumerate(ctx["image"][0]):
            save_image(img, out_dir / "context" / f"{i:03d}.png")
        for i, img in enumerate(result["_rendered"]):
            save_image(img, out_dir / "color" / f"{i:03d}.png")
    if eval_cfg.save_compare:
        rows = [hcat(gt, pr) for gt, pr in zip(tgt_images, result["_rendered"])]
        save_image(np.concatenate(rows, axis=0), out_dir / "compare.png")
    if eval_cfg.save_video:
        save_video(result["_rendered"], out_dir / "render.mp4")
    if eval_cfg.save_gs:
        g = out["gaussians"]

        def flat(x, *tail):
            return x.float().cpu().numpy().reshape(-1, *tail)

        export_ply(flat(g.means, 3), flat(g.scales, 3), flat(g.rotations, 4),
                   flat(g.harmonics, *g.harmonics.shape[-2:]), flat(g.opacities),
                   out_dir / "gaussians.ply")
