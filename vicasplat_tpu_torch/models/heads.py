"""Prediction heads (port of vicasplat_tpu/models/heads.py): the DPT trunk,
the regression head, the Gaussian-parameter head with its RGB merger, the
pts3d exp postprocess and the camera head. Activations are NHWC.

`DPTConfig.tail_backend` picks the full-resolution tail as in JAX: "xla"
runs conv -> relu -> conv, "pallas" the fused tail K3
(`kernels/dpt_tail.py`; in this package "pallas" names the hand-written
CUDA kernel, which takes its plain version on CPU tensors), "auto" the
kernel for CUDA tensors and the plain convs for CPU tensors. The gates on
the shapes are the JAX package's, so one config takes the kernel in both.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.dpt_tail import fused_dpt_tail
from .layers import conv2d, conv_transpose2d, linear, resize_bilinear_align_corners

TAIL_BACKENDS = ("xla", "pallas", "auto")


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    hook_dims: tuple = (1024, 768, 768, 768)
    layer_dims: tuple = (96, 192, 384, 768)
    feature_dim: int = 256
    last_dim: int = 128
    num_channels: int = 3
    patch_size: int = 16  # carried for the JAX config; the trunk reads grid_hw
    head_type: str = "regression"  # or "gs_params"
    use_input_merger: bool = False
    tail_backend: str = "xla"  # "xla" | "pallas" | "auto"
    # training from random init: a LayerScale (init 0.1) on each RCU's
    # residual branch and a channel LayerNorm on the trunk's output
    stabilize: bool = False

    def __post_init__(self):
        if self.tail_backend not in TAIL_BACKENDS:
            raise ValueError(f"tail_backend={self.tail_backend!r} is not one "
                             f"of {TAIL_BACKENDS}")


def _conv(c_in, c_out, k, bias=True, stride=1):
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2, bias=bias)


class RCU(nn.Module):
    """Residual conv unit: x + ls * conv2(relu(conv1(relu(x)))), the
    LayerScale `ls` only when stabilized."""

    def __init__(self, features: int, stabilize: bool = False):
        super().__init__()
        self.conv1 = _conv(features, features, 3)
        self.conv2 = _conv(features, features, 3)
        if stabilize:
            self.ls = nn.Parameter(torch.full((features,), 0.1))

    def forward(self, x, dtype):
        h = conv2d(self.conv1, F.relu(x), dtype)
        h = conv2d(self.conv2, F.relu(h), dtype)
        if hasattr(self, "ls"):
            h = h * self.ls.to(h.dtype)
        return h + x


class Fusion(nn.Module):
    def __init__(self, features: int, stabilize: bool = False):
        super().__init__()
        self.rcu1 = RCU(features, stabilize)
        self.rcu2 = RCU(features, stabilize)
        self.out_conv = _conv(features, features, 1)

    def forward(self, path, skip, dtype):
        if skip is not None:
            path = path + self.rcu1(skip, dtype)
        path = self.rcu2(path, dtype)
        _, h, w, _ = path.shape
        path = resize_bilinear_align_corners(path, (2 * h, 2 * w))
        return conv2d(self.out_conv, path, dtype)


class DPT(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        ld, hd, fd = cfg.layer_dims, cfg.hook_dims, cfg.feature_dim
        self.proj0 = _conv(hd[0], ld[0], 1)
        self.up0 = nn.ConvTranspose2d(ld[0], ld[0], 4, stride=4)
        self.proj1 = _conv(hd[1], ld[1], 1)
        self.up1 = nn.ConvTranspose2d(ld[1], ld[1], 2, stride=2)
        self.proj2 = _conv(hd[2], ld[2], 1)
        self.proj3 = _conv(hd[3], ld[3], 1)
        # stride-2 3x3 with symmetric (1, 1) padding, torch's Conv2d(padding=1)
        self.down3 = _conv(ld[3], ld[3], 3, stride=2)
        for i in range(4):
            setattr(self, f"scratch{i}", _conv(ld[i], fd, 3, bias=False))
            setattr(self, f"refinenet{i + 1}", Fusion(fd, cfg.stabilize))
        if cfg.stabilize:
            self.trunk_norm = nn.LayerNorm(fd, eps=1e-6)
        if cfg.head_type == "regression":
            self.head = nn.ModuleDict({
                "conv1": _conv(fd, fd // 2, 3),
                "conv2": _conv(fd // 2, cfg.last_dim, 3),
                "conv3": _conv(cfg.last_dim, cfg.num_channels, 1),
            })
        elif cfg.head_type == "gs_params":
            self.head = nn.ModuleDict({
                "conv1": _conv(fd, fd, 3, bias=False),
                "conv2": _conv(fd, cfg.num_channels, 1),
            })
        else:
            raise ValueError(cfg.head_type)
        if cfg.use_input_merger:
            self.input_merger = nn.ModuleDict({"conv": _conv(3, fd, 7)})

    def trunk(self, hook_tokens: Sequence[torch.Tensor], grid_hw: tuple,
              dtype) -> torch.Tensor:
        """4 hook tensors (B, N, C_hook) -> (B, 8 gh, 8 gw, feature_dim)."""
        gh, gw = grid_hw
        f = [t.reshape(t.shape[0], gh, gw, t.shape[-1]) for t in hook_tokens]
        l0 = conv_transpose2d(self.up0, conv2d(self.proj0, f[0], dtype), dtype)
        l1 = conv_transpose2d(self.up1, conv2d(self.proj1, f[1], dtype), dtype)
        l2 = conv2d(self.proj2, f[2], dtype)
        l3 = conv2d(self.down3, conv2d(self.proj3, f[3], dtype), dtype)
        l0 = conv2d(self.scratch0, l0, dtype)
        l1 = conv2d(self.scratch1, l1, dtype)
        l2 = conv2d(self.scratch2, l2, dtype)
        l3 = conv2d(self.scratch3, l3, dtype)
        p4 = self.refinenet4(l3, None, dtype)[:, : l2.shape[1], : l2.shape[2]]
        p3 = self.refinenet3(p4, l2, dtype)
        p2 = self.refinenet2(p3, l1, dtype)
        p1 = self.refinenet1(p2, l0, dtype)
        if hasattr(self, "trunk_norm"):
            p1 = _channel_norm(self.trunk_norm, p1)
        return p1


def _channel_norm(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over channels with float32 statistics (biased variance, eps
    1e-6 inside the rsqrt), learned affine, returned in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    return (y * mod.weight + mod.bias).to(x.dtype)


def _cast(conv: nn.Conv2d, dtype):
    """(weight, bias) in the activations' dtype, as the JAX tail casts them."""
    return conv.weight.to(dtype), None if conv.bias is None else conv.bias.to(dtype)


def _tail_backend(cfg: DPTConfig, x: torch.Tensor) -> str:
    if cfg.tail_backend == "auto":
        return "pallas" if x.device.type == "cuda" else "xla"
    return cfg.tail_backend


def dpt_regression_head(mod: DPT, hook_tokens, grid_hw, dtype) -> torch.Tensor:
    """DPT + regression head -> (B, H, W, num_channels) at image resolution."""
    h = conv2d(mod.head["conv1"], mod.trunk(hook_tokens, grid_hw, dtype), dtype)
    _, hh, ww, _ = h.shape
    h = resize_bilinear_align_corners(h, (2 * hh, 2 * ww))
    conv2, conv3 = mod.head["conv2"], mod.head["conv3"]
    # the JAX gate: the fused tail pays off only with >= 64 output channels
    if _tail_backend(mod.cfg, h) == "pallas" and not (
            h.shape[1] % 8 or h.shape[-1] % 128 or conv2.out_channels % 128
            or mod.cfg.num_channels < 64):
        return fused_dpt_tail(h.contiguous(), None, *_cast(conv2, h.dtype),
                              *_cast(conv3, h.dtype))
    h = F.relu(conv2d(conv2, h, dtype))
    return conv2d(conv3, h, dtype)


def dpt_gs_head(mod: DPT, hook_tokens, grid_hw, images, dtype) -> torch.Tensor:
    """DPT + Gaussian-parameter head; images (B, H, W, 3) normalized frames
    whose 7x7-conv features join the upsampled path before the output convs."""
    p1 = mod.trunk(hook_tokens, grid_hw, dtype)
    _, hh, ww, _ = p1.shape
    p1 = resize_bilinear_align_corners(p1, (2 * hh, 2 * ww))
    conv1, conv2 = mod.head["conv1"], mod.head["conv2"]
    if mod.cfg.use_input_merger:
        direct = F.relu(conv2d(mod.input_merger["conv"], images.to(p1.dtype),
                               dtype))
        # the JAX gate: odd sizes (portrait or rectangular crops) stay plain
        if _tail_backend(mod.cfg, p1) == "pallas" and not (
                p1.shape[1] % 8 or p1.shape[-1] % 128):
            # the kernel reads channels-last rows: the einsum resize and the
            # conv may hand back other strides
            return fused_dpt_tail(p1.contiguous(), direct.contiguous(),
                                  *_cast(conv1, p1.dtype), *_cast(conv2, p1.dtype))
        p1 = p1 + direct
    h = F.relu(conv2d(conv1, p1, dtype))
    return conv2d(conv2, h, dtype)


def postprocess_pts3d_exp(raw_xyz: torch.Tensor, vmin: float = 0.0,
                          vmax: float = float("inf")) -> torch.Tensor:
    """xyz = (v / |v|) * clip(expm1(|v|), vmin, vmax), with the raw clamp at
    1e8 and the smooth norm of the JAX package."""
    x = raw_xyz.float().clamp(-1e8, 1e8)
    d = torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)
    return x / d.clamp(min=1e-8) * torch.expm1(d).clamp(vmin, vmax)


def postprocess_conf_exp(raw: torch.Tensor, vmin: float = 1.0,
                         vmax: float = float("inf")) -> torch.Tensor:
    return vmin + torch.exp(raw.float()).clamp(max=vmax - vmin)


class LinearHead(nn.Module):
    """The linear pixel-shuffle head: relu -> linear -> patch x patch pixels."""

    def __init__(self, dim_in: int, patch_size: int, num_channels: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, patch_size ** 2 * num_channels)


def linear_head(mod: LinearHead, tokens: torch.Tensor, grid_hw: tuple,
                patch_size: int, num_channels: int, dtype) -> torch.Tensor:
    """tokens (B, N, C) -> (B, H, W, num_channels) by pixel shuffle."""
    gh, gw = grid_hw
    x = linear(mod.proj, F.relu(tokens), dtype)
    b = x.shape[0]
    x = x.reshape(b, gh, gw, patch_size, patch_size, num_channels)
    return x.transpose(2, 3).reshape(b, gh * patch_size, gw * patch_size,
                                     num_channels)


class CameraHead(nn.Module):
    """ReLU -> Linear; zero-initialized so the first pose is the identity."""

    def __init__(self, dim: int, channels: int):
        super().__init__()
        self.proj = nn.Linear(dim, channels)


def camera_head(mod: CameraHead, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    return linear(mod.proj, F.relu(tokens), dtype)
