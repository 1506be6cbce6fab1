"""Gaussian adapter (port of vicasplat_tpu/models/adapter.py): raw head
outputs -> 3D Gaussian parameters.

Raw layout per pixel: [xyz(3) | opacity(1) | scale(3) | rotation xyzw(4) |
sh(3 * (deg + 1)^2)]; xyz comes from the center head, the rest from the
Gaussian-parameter head.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..geometry.quaternion import quat_to_matrix
from ..utils.device_cache import as_device, device_constant


class Gaussians(NamedTuple):
    """Pixel-aligned Gaussian scene; leading dims arbitrary."""

    means: torch.Tensor        # (..., 3)
    covariances: torch.Tensor  # (..., 3, 3)
    harmonics: torch.Tensor    # (..., 3, d_sh)
    opacities: torch.Tensor    # (...,)
    scales: torch.Tensor       # (..., 3)
    rotations: torch.Tensor    # (..., 4) xyzw


@dataclasses.dataclass(frozen=True)
class GaussianAdapterConfig:
    gaussian_scale_min: float = 0.005
    gaussian_scale_max: float = 0.04
    sh_degree: int = 4
    scale_act: str = "softplus"  # bounded | exp | softplus

    @property
    def d_sh(self) -> int:
        return (self.sh_degree + 1) ** 2

    @property
    def d_in(self) -> int:
        return 7 + 3 * self.d_sh

    @property
    def raw_gs_dim(self) -> int:
        return 1 + self.d_in


def sh_degree_mask(sh_degree: int, device=None) -> torch.Tensor:
    """Degree d scaled by 0.1 * 0.25^d (the DC term by 1); one cached tensor
    per degree and device."""
    return _sh_degree_mask(sh_degree, as_device(device))


@device_constant
def _sh_degree_mask(sh_degree: int, device) -> torch.Tensor:
    mask = [1.0]
    for deg in range(1, sh_degree + 1):
        mask.extend([0.1 * 0.25**deg] * (2 * deg + 1))
    return torch.tensor(mask, dtype=torch.float32, device=device)


def build_covariance(scales: torch.Tensor, rotations_xyzw: torch.Tensor) -> torch.Tensor:
    """Sigma = R diag(s) diag(s) R^T."""
    RS = quat_to_matrix(rotations_xyzw) * scales[..., None, :]
    return RS @ RS.transpose(-1, -2)


def adapt_gaussians(raw: torch.Tensor, cfg: GaussianAdapterConfig,
                    opacity_map: Optional[Callable] = None,
                    eps: float = 1e-8) -> Gaussians:
    """raw: (..., 1 + 10 + 3 * d_sh) channel-last head output."""
    raw = raw.float()
    xyz, opacity = raw[..., 0:3], raw[..., 3]
    scales, rotations = raw[..., 4:7], raw[..., 7:11]
    sh = raw[..., 11:].unflatten(-1, (3, cfg.d_sh)) * sh_degree_mask(
        cfg.sh_degree, raw.device)

    opacity = torch.sigmoid(opacity)
    if opacity_map is not None:
        opacity = opacity_map(opacity)
    if cfg.scale_act == "bounded":
        lo, hi = cfg.gaussian_scale_min, cfg.gaussian_scale_max
        scales = lo + (hi - lo) * torch.sigmoid(scales)
    elif cfg.scale_act == "exp":
        scales = torch.exp(scales).clamp(max=0.3)
    elif cfg.scale_act == "softplus":
        scales = (0.001 * F.softplus(scales)).clamp(max=0.3)
    else:
        raise ValueError(cfg.scale_act)
    norm = torch.linalg.vector_norm(rotations, dim=-1, keepdim=True)
    rotations = rotations / norm.clamp(min=eps)
    return Gaussians(
        means=xyz,
        covariances=build_covariance(scales, rotations),
        harmonics=sh,
        opacities=opacity,
        scales=scales,
        rotations=rotations,
    )


def opacity_warmup_map(cfg_initial: float, cfg_final: float, warm_up: int,
                       global_step: int) -> Callable:
    """pdf -> opacity warm-up map; the identity when initial == final == 0."""
    frac = min(float(global_step) / warm_up, 1.0)
    exponent = 2.0 ** (cfg_initial + frac * (cfg_final - cfg_initial))

    def _map(pdf):
        return 0.5 * (1 - (1 - pdf) ** exponent + pdf ** (1 / exponent))

    return _map
