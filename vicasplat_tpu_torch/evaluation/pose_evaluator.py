"""Pose evaluator (port of vicasplat_tpu/evaluation/pose_evaluator.py:26-144):
per-scene quality of the predicted context poses (ATE, RPE, and the
rotation and translation-direction errors that pose AUC summarizes), with
an optional render-and-compare refinement of those poses against the
context images (`refine_steps`, 0 by default as in the reference)."""
from __future__ import annotations

import dataclasses
import json
import pathlib
from collections import defaultdict

import numpy as np
import torch

from ..decoder.splatting import DecoderSplattingConfig, decoder_forward
from ..geometry.se3 import update_pose
from ..loss.ssim import ssim_components
from ..models.vicasplat import VicaSplatConfig
from .metrics import camera_eval_metrics, pose_auc
from .nvs_eval import default_encode


@dataclasses.dataclass(frozen=True)
class PoseEvalConfig:
    refine_steps: int = 0
    rot_opt_lr: float = 0.005
    trans_opt_lr: float = 0.005
    output_path: str = "outputs/pose_eval"


class PoseEvaluator:
    def __init__(self, model, model_cfg: VicaSplatConfig,
                 dec_cfg: DecoderSplattingConfig, cfg: PoseEvalConfig):
        self.model = model
        self.model_cfg = model_cfg
        self.dec_cfg = dec_cfg
        self.cfg = cfg
        self.metrics = defaultdict(list)

    @torch.no_grad()
    def evaluate_batch(self, batch: dict) -> dict:
        ctx = batch["context"]
        out = default_encode(self.model, ctx)
        pred = out["gaussian_camera_extrins"][0].double().cpu().numpy()
        gt = ctx["extrinsics"][0].double().cpu().numpy()
        if self.cfg.refine_steps > 0:
            pred = self._refine(out, ctx, pred)

        m = camera_eval_metrics(gt, pred)
        # a degenerate trajectory gives no entry: NaN, which the summary's
        # nanmean skips
        result = {
            "scene": batch.get("scene", ["?"])[0],
            "ate": m.get("ate", float("nan")),
            "rpe_trans": m.get("rpe_trans", float("nan")),
            "rpe_rot": m.get("rpe_rot", float("nan")),
        }
        for k, v in result.items():
            if k != "scene":
                self.metrics[k].append(v)
        if "rot_err_deg" in m:
            self.metrics["rot_err_deg"].extend(m["rot_err_deg"].tolist())
            self.metrics["trans_err_deg"].extend(m["trans_err_deg"].tolist())
        return result

    def _refine(self, out, ctx, pred):
        """SE(3) deltas of the predicted context poses, `refine_steps` Adam
        steps (one learning rate, `rot_opt_lr`) on MSE + (1 - SSIM
        structure) against the context images; the refined c2w poses."""
        h, w = ctx["image"].shape[2:4]
        gaussians = out["gaussians"]
        ext = out["gaussian_camera_extrins"]
        b, v = ext.shape[:2]
        rot = torch.zeros(b, v, 3, device=ext.device, requires_grad=True)
        trans = torch.zeros(b, v, 3, device=ext.device, requires_grad=True)
        opt = torch.optim.Adam([rot, trans], lr=self.cfg.rot_opt_lr)
        with torch.enable_grad():
            for _ in range(self.cfg.refine_steps):
                color = decoder_forward(
                    self.dec_cfg, gaussians, ext, ctx["intrinsics"], ctx["near"],
                    ctx["far"], (h, w), cam_rot_delta=rot, cam_trans_delta=trans).color
                mse = ((color - ctx["image"]) ** 2).mean()
                structure = ssim_components(color.reshape(-1, h, w, 3),
                                            ctx["image"].reshape(-1, h, w, 3))["structure"]
                opt.zero_grad(set_to_none=True)
                (mse + (1.0 - structure)).backward()
                opt.step()
        refined = update_pose(trans.detach()[0].double(), rot.detach()[0].double(),
                              torch.from_numpy(pred).to(ext.device))
        return refined.cpu().numpy()

    def summary(self) -> dict:
        out = {k: float(np.nanmean(v)) for k, v in self.metrics.items()
               if k not in ("rot_err_deg", "trans_err_deg")}
        errs = np.maximum(np.asarray(self.metrics["rot_err_deg"]),
                          np.asarray(self.metrics["trans_err_deg"]))
        if len(errs):
            a5, a10, a20 = pose_auc(errs, (5, 10, 20))
            out.update({"auc@5": a5, "auc@10": a10, "auc@20": a20})
            (a30,) = pose_auc(errs, (30,))
            out["auc@30"] = a30
        return out

    def dump(self):
        path = pathlib.Path(self.cfg.output_path)
        path.mkdir(parents=True, exist_ok=True)
        with open(path / "pose_metrics.json", "w") as f:
            json.dump(self.summary(), f, indent=2)
        return path / "pose_metrics.json"
