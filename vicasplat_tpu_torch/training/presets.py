"""Training configurations and seeded batches shared by chip_smoke.py, the
card tests and the diagnostics, so that each builds the same thing.

- `flagship_train_config` / `flagship_train_batch`: configs/main.yaml with
  configs/experiment/re10k_8view.yaml (8 context frames of 256^2, bf16,
  remat "dots"), as the JAX package's main.py builds it.
- `tiny_smoke_config` / `tiny_smoke_model` / `tiny_smoke_views`:
  configs/experiment/_tiny_smoke.yaml, the float32 configuration with heads
  of 12 (decoder) and 16 (encoder).
"""
from __future__ import annotations

import torch

from ..decoder.splatting import DecoderSplattingConfig
from ..loss.losses import LossCameraConfig, LossMseConfig
from ..models import GaussianAdapterConfig, VicaNetConfig, VicaSplatConfig, init_vicasplat
from ..models.layers import fill_normal_
from ..ops.rasterize import RasterizeConfig
from .optimizer import OptimizerConfig
from .step import TrainConfig


def flagship_train_config() -> TrainConfig:
    """configs/main.yaml with configs/experiment/re10k_8view.yaml (no LPIPS:
    its VGG weights are not in the repository; no distillation: distiller
    is '')."""
    return TrainConfig(
        model=VicaSplatConfig(backbone=VicaNetConfig(use_intrinsic_embedding=True),
                              gaussian_adapter=GaussianAdapterConfig(sh_degree=4)),
        optimizer=OptimizerConfig(
            lr=4e-5, warm_up_steps=1, backbone_lr_multiplier=0.25,
            cosine_annealing=True, max_steps=20_000, gradient_clip_val=0.5,
            new_param_keywords=("gaussian_param_head", "intrinsic_encoder")),
        mse=LossMseConfig(weight=1.0),
        camera=LossCameraConfig(weight=0.1, use_dq_loss=True, camera_type="dq"),
        dtype="bfloat16", remat=True, remat_policy="dots")


def flagship_train_batch(dev, B: int, V: int, size: int = 256, T: int = 8,
                         seed: int = 3) -> dict:
    """A flagship training batch from a seed: images uniform in [0, 1],
    frame-0-relative context poses with small random rotations (about 0.05
    rad) and translations (about 0.1), targets drawn among the context
    poses, near 1 and far 100."""
    from ..geometry.se3 import se3_exp

    g = torch.Generator(device=dev).manual_seed(seed)
    tau = torch.randn(B, T, 6, generator=g, device=dev) * torch.tensor(
        [0.1] * 3 + [0.05] * 3, device=dev)
    tau[:, 0] = 0.0
    ext = se3_exp(tau)
    K = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]],
                     device=dev).expand(B, T, 3, 3).contiguous()
    pick = torch.randint(0, T, (B, V), generator=g, device=dev)

    def view(image, e, k, n):
        return {"image": image, "extrinsics": e, "intrinsics": k,
                "near": torch.ones(B, n, device=dev),
                "far": torch.full((B, n), 100.0, device=dev)}

    return {
        "context": view(torch.rand(B, T, size, size, 3, generator=g, device=dev),
                        ext, K, T),
        "target": view(torch.rand(B, V, size, size, 3, generator=g, device=dev),
                       torch.stack([ext[b, pick[b]] for b in range(B)]),
                       K[:, :1].expand(B, V, 3, 3).contiguous(), V)}


def tiny_smoke_config() -> TrainConfig:
    """configs/experiment/_tiny_smoke.yaml on configs/main.yaml, as the JAX
    package's main.py builds it: 32^2 images, encoder 64 wide (4 heads of 16,
    depth 2), decoder 48 wide (4 heads of 12, depth 4), SH degree 1, 3
    context and 2 target views, batch 2, float32, no remat, mse 1.0 +
    camera 0.1, lr 1e-5 with 2 warm-up steps."""
    return TrainConfig(
        model=VicaSplatConfig(
            backbone=VicaNetConfig(img_size=32, enc_embed_dim=64, enc_depth=2,
                                   enc_num_heads=4, dec_embed_dim=48, dec_depth=4,
                                   dec_num_heads=4, use_intrinsic_embedding=True),
            gaussian_adapter=GaussianAdapterConfig(sh_degree=1)),
        decoder=DecoderSplattingConfig(rasterize=RasterizeConfig(
            tile_px=8, dup_hw=(2, 2), max_per_tile=64, chunk=32, tile_group=4)),
        optimizer=OptimizerConfig(lr=1e-5, warm_up_steps=2, max_steps=6),
        mse=LossMseConfig(weight=1.0), camera=LossCameraConfig(weight=0.1),
        dtype="float32", remat=False)


def tiny_smoke_model(cfg: TrainConfig, g: torch.Generator):
    """The model on the CPU from `g`, with a small random camera head (it
    starts at zero), so that the poses depend on the backbone."""
    model = init_vicasplat(cfg.model, g, "cpu")
    fill_normal_(model.camera_extrinsic_head.proj.weight, 0.02, g)
    return model


def tiny_smoke_views(g: torch.Generator, n: int, batch: int = 2,
                     size: int = 32) -> dict:
    """n views on the CPU from `g`: identity rotations with translations of
    about 0.1, normalized intrinsics, images uniform in [0, 1]."""
    ext = torch.eye(4).expand(batch, n, 4, 4).clone()
    ext[:, :, :3, 3] = 0.1 * torch.randn(batch, n, 3, generator=g)
    K = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]])
    return dict(image=torch.rand(batch, n, size, size, 3, generator=g),
                extrinsics=ext, intrinsics=K.expand(batch, n, 3, 3).clone(),
                near=torch.ones(batch, n), far=torch.full((batch, n), 100.0))
