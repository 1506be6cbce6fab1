"""The VicaSplat model (port of vicasplat_tpu/models/vicasplat.py): unposed
frames -> 3D Gaussians + camera poses.

`vicasplat_forward` takes a context {image (B, T, H, W, 3) in [-1, 1],
intrinsics (B, T, 3, 3) normalized} and returns the Gaussian scene and the
per-frame poses decoded from normalized dual quaternions (frame 0 pinned to
the identity).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ..geometry import dual_quaternion as dqlib
from ..geometry.quaternion import qnormalize
from ..geometry.se3 import intrinsics_from_fov
from ..utils.device_cache import device_constant
from .adapter import GaussianAdapterConfig, adapt_gaussians, opacity_warmup_map
from .heads import (
    DPT,
    CameraHead,
    DPTConfig,
    LinearHead,
    camera_head,
    dpt_gs_head,
    dpt_regression_head,
    linear_head,
    postprocess_conf_exp,
    postprocess_pts3d_exp,
)
from .layers import fill_normal_, init_default_, xavier_
from .vicanet import VicaNet, VicaNetConfig


@dataclasses.dataclass(frozen=True)
class OpacityMappingConfig:
    initial: float = 0.0
    final: float = 0.0
    warm_up: int = 1


@dataclasses.dataclass(frozen=True)
class VicaSplatConfig:
    backbone: VicaNetConfig = VicaNetConfig()
    gaussian_adapter: GaussianAdapterConfig = GaussianAdapterConfig()
    opacity_mapping: OpacityMappingConfig = OpacityMappingConfig()
    predict_opacity: bool = False
    predict_conf: bool = False
    camera_type: str = "dq"  # "dq" | "qt"
    gs_center_head_type: str = "dpt"    # "dpt" | "linear"
    gs_param_head_type: str = "dpt_gs"  # "dpt" | "dpt_gs" | "linear"
    input_mean: tuple = (0.5, 0.5, 0.5)  # normalize_images
    input_std: tuple = (0.5, 0.5, 0.5)
    pts3d_bounds: tuple = (0.0, float("inf"))
    # DPT tails: "xla" | "pallas" (the fused tail K3) | "auto" (by device)
    head_tail_backend: str = "xla"
    # DPT heads for training from random init (DPTConfig.stabilize)
    dpt_stabilize: bool = False

    @property
    def camera_extrinsic_channels(self) -> int:
        return 8 if self.camera_type == "dq" else 7

    def dpt_hooks(self) -> tuple:
        l2 = self.backbone.dec_depth
        return (0, l2 * 2 // 4, l2 * 3 // 4, l2)

    def center_dpt(self) -> DPTConfig:
        bb = self.backbone
        return DPTConfig(
            hook_dims=(bb.enc_embed_dim,) + (bb.dec_embed_dim,) * 3,
            num_channels=3 + (1 if self.predict_conf else 0),
            patch_size=bb.patch_size, head_type="regression",
            tail_backend=self.head_tail_backend, stabilize=self.dpt_stabilize)

    def gs_dpt(self) -> DPTConfig:
        bb = self.backbone
        return DPTConfig(
            hook_dims=(bb.enc_embed_dim,) + (bb.dec_embed_dim,) * 3,
            num_channels=self.gaussian_adapter.raw_gs_dim,
            patch_size=bb.patch_size, head_type="gs_params",
            use_input_merger=True, tail_backend=self.head_tail_backend,
            stabilize=self.dpt_stabilize)


class VicaSplat(nn.Module):
    """Backbone, DPT center and Gaussian-parameter heads, camera heads."""

    def __init__(self, cfg: VicaSplatConfig):
        super().__init__()
        self.cfg = cfg
        bb = cfg.backbone
        self.backbone = VicaNet(bb)
        center, gs = cfg.center_dpt(), cfg.gs_dpt()
        if cfg.gs_center_head_type == "dpt":
            self.center_head = DPT(center)
        elif cfg.gs_center_head_type == "linear":
            self.center_head = LinearHead(bb.dec_embed_dim, bb.patch_size,
                                          center.num_channels)
        else:
            raise ValueError(f"gs_center_head_type={cfg.gs_center_head_type!r}")
        if cfg.gs_param_head_type in ("dpt", "dpt_gs"):
            self.gaussian_param_head = DPT(gs)
        elif cfg.gs_param_head_type == "linear":
            self.gaussian_param_head = LinearHead(bb.dec_embed_dim, bb.patch_size,
                                                  gs.num_channels)
        else:
            raise ValueError(f"gs_param_head_type={cfg.gs_param_head_type!r}")
        self.camera_extrinsic_head = CameraHead(bb.dec_embed_dim,
                                                cfg.camera_extrinsic_channels)
        if not bb.use_intrinsic_embedding:
            self.camera_intrinsic_head = CameraHead(bb.dec_embed_dim, 2)

    def forward(self, fn, *args, **kwargs):
        """fn(self, *args, **kwargs): the entry through which a DDP or FSDP2
        wrapper sees the model's forward (training/step.py); the model
        itself is applied by the functions of this module."""
        return fn(self, *args, **kwargs)


@torch.no_grad()
def init_vicasplat(cfg: VicaSplatConfig, generator: torch.Generator,
                   device="cuda") -> VicaSplat:
    """A VicaSplat with the JAX package's init distributions, drawn from
    `generator`: xavier-uniform weights, zero biases, camera tokens
    N(0, 0.02), zero AdaLN modulations and zero camera heads (identity poses
    and an intrinsic head that starts at a 50-degree field of view)."""
    with torch.device(device):
        model = VicaSplat(cfg)
    init_default_(model, generator)
    bb = model.backbone
    ps = cfg.backbone.patch_size
    xavier_(bb.patch_embed.proj.weight, ps * ps * 3, cfg.backbone.enc_embed_dim,
            generator)
    fill_normal_(bb.camera_extrinsic_token, 0.02, generator)
    fill_normal_(bb.camera_intrinsic_token, 0.02, generator)
    for blk in bb.dec_blocks:
        if cfg.backbone.use_framewise_modulation:
            blk.modulation1.proj.weight.zero_()
            blk.modulation2.proj.weight.zero_()
    model.camera_extrinsic_head.proj.weight.zero_()
    if hasattr(model, "camera_intrinsic_head"):
        model.camera_intrinsic_head.proj.weight.zero_()
        model.camera_intrinsic_head.proj.bias.fill_(math.pi * 50 / 180)
    return model


def decode_camera(pred: torch.Tensor, camera_type: str):
    """Raw head output -> (normalized parameter vector, 4x4 c2w poses); +1 on
    the real quaternion part makes the zero head decode to the identity."""
    pred = pred.float().clone()
    pred[..., 3] += 1.0
    if camera_type == "dq":
        pred = pred / torch.linalg.vector_norm(pred[..., :4], dim=-1, keepdim=True)
        mats = dqlib.homogeneous_matrix(dqlib.from_dq_array(pred))
    elif camera_type == "qt":
        pred = torch.cat([qnormalize(pred[..., :4]), pred[..., 4:]], dim=-1)
        mats = dqlib.homogeneous_matrix(dqlib.from_quat_pose(pred))
    else:
        raise ValueError(camera_type)
    return pred, mats


def vicasplat_forward(model: VicaSplat, context: dict, global_step: int = 0, *,
                      distill: bool = False, compute_viewspace_depth: bool = False,
                      dtype=torch.bfloat16, remat: bool = False,
                      remat_policy: Optional[str] = None,
                      parallel: Optional[dict] = None) -> dict:
    """Frames -> Gaussians and poses. Heads run in landscape: a portrait
    batch (H > W) has its token grids and head outputs transposed.

    `remat` recomputes each backbone block in the backward
    (`torch.utils.checkpoint`); `remat_policy="dots"` keeps the linear
    layers' products. `distill=True` (the distill_only phase) returns after
    the centre head, without the Gaussian-parameter head and the adapter;
    `compute_viewspace_depth=True` adds `context_view_depths` (B, T, H, W),
    the z of R^-1 (p - t) in each context camera (c2w `extrinsics` of the
    context), else None. `parallel` holds the backbone's mesh arguments
    (VicaNet.forward: pipeline_group, pipeline_n_micro, sp_mesh, ep_group,
    moe_token_group), as JAX's pipeline_mesh and sp_mesh."""
    cfg = model.cfg
    bb = cfg.backbone
    images = context["image"]
    B, T, H, W, _ = images.shape

    _, camera_embeds, global_embeds, interms = model.backbone(
        images, context.get("intrinsics"), dtype=dtype, remat=remat,
        remat_policy=remat_policy, **(parallel or {}))

    pred_raw = camera_head(model.camera_extrinsic_head, camera_embeds, dtype)
    pred_extrins, pred_mats = decode_camera(pred_raw, cfg.camera_type)
    eye = torch.eye(4, dtype=pred_mats.dtype, device=pred_mats.device)
    extrinsics_4x4 = torch.cat([eye.expand(B, 1, 4, 4), pred_mats], dim=1)

    if global_embeds is not None:
        pred_intrins = camera_head(model.camera_intrinsic_head, global_embeds,
                                   dtype).float()
        intrinsics_3x3 = intrinsics_from_fov(pred_intrins)[:, None].expand(
            B, T, 3, 3)
    else:
        pred_intrins = intrinsics_3x3 = None

    gh, gw = H // bb.patch_size, W // bb.patch_size
    n_patches = gh * gw
    portrait = H > W

    def head_grid(tok):
        tok = tok.reshape(B * T, n_patches, tok.shape[-1])
        if portrait:
            tok = tok.reshape(B * T, gh, gw, -1).transpose(1, 2).reshape(
                B * T, n_patches, -1)
        return tok

    def head_out(x):
        return x.transpose(1, 2) if portrait else x

    hook_tokens = [head_grid(interms[h]) for h in cfg.dpt_hooks()]
    grid_hw = (gw, gh) if portrait else (gh, gw)
    head_images = images.reshape(B * T, H, W, 3)
    if portrait:
        head_images = head_images.transpose(1, 2)

    if cfg.gs_center_head_type == "dpt":
        center_out = dpt_regression_head(model.center_head, hook_tokens, grid_hw,
                                         dtype)
    else:
        center_out = linear_head(model.center_head, hook_tokens[-1], grid_hw,
                                 bb.patch_size, cfg.center_dpt().num_channels, dtype)
    center_out = head_out(center_out)
    gs_centers = postprocess_pts3d_exp(center_out[..., :3],
                                       *cfg.pts3d_bounds).reshape(B, T, H, W, 3)
    conf = (postprocess_conf_exp(center_out[..., 3]).reshape(B, T, H, W)
            if cfg.predict_conf else None)

    viewspace_depth = None
    if compute_viewspace_depth and "extrinsics" in context:
        ext = context["extrinsics"]
        rel = gs_centers - ext[:, :, None, None, :3, 3]
        viewspace_depth = torch.einsum("btji,bthwj->bthwi", ext[:, :, :3, :3],
                                       rel)[..., 2]
    if distill:
        return dict(pred_extrins=pred_extrins, pred_intrins=pred_intrins,
                    gaussian_camera_extrins=extrinsics_4x4,
                    gaussian_camera_intrins=intrinsics_3x3,
                    gaussian_centers=gs_centers, confidence=conf,
                    context_view_depths=viewspace_depth)

    if cfg.gs_param_head_type in ("dpt", "dpt_gs"):
        gs_params_out = dpt_gs_head(model.gaussian_param_head, hook_tokens,
                                    grid_hw, head_images, dtype)
    else:
        gs_params_out = linear_head(model.gaussian_param_head, hook_tokens[-1],
                                    grid_hw, bb.patch_size,
                                    cfg.gaussian_adapter.raw_gs_dim, dtype)
    gs_params_out = head_out(gs_params_out)
    raw_gaussians = torch.cat(
        [gs_centers, gs_params_out.reshape(B, T, H, W, -1).float()], dim=-1)
    om = cfg.opacity_mapping
    opacity_map = (None if cfg.predict_opacity else
                   opacity_warmup_map(om.initial, om.final, om.warm_up, global_step))
    gaussians = adapt_gaussians(raw_gaussians, cfg.gaussian_adapter, opacity_map)
    return dict(
        gaussians=gaussians,
        pred_extrins=pred_extrins,
        pred_intrins=pred_intrins,
        raw_gaussians=raw_gaussians,
        gaussian_camera_extrins=extrinsics_4x4,
        gaussian_camera_intrins=intrinsics_3x3,
        gaussian_centers=gs_centers,
        confidence=conf,
        context_view_depths=viewspace_depth,
    )


@device_constant
def _input_stats(mean: tuple, std: tuple, dtype, device):
    return (torch.tensor(mean, dtype=dtype, device=device),
            torch.tensor(std, dtype=dtype, device=device))


def normalize_images(images_01: torch.Tensor, cfg: VicaSplatConfig) -> torch.Tensor:
    """The encoder's data shim: [0, 1] images -> (x - input_mean) / input_std."""
    mean, std = _input_stats(tuple(cfg.input_mean), tuple(cfg.input_std),
                             images_01.dtype, images_01.device)
    return (images_01 - mean) / std
