"""Real spherical harmonics to degree 4 (port of vicasplat_tpu/ops/sh.py).

color = clamp(SH(dir) . coeffs + 0.5, min=0), the 3DGS convention.
`rotate_sh` turns coefficients with a rotation of their frame (the
long-video path's re-basing, `streaming.py`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device_cache import device_constant

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)

MAX_DEGREE = 4


def sh_basis_cols(dirs: torch.Tensor, degree: int) -> list:
    """dirs (..., 3) unit vectors -> list of (degree+1)^2 tensors shaped
    like dirs[..., 0]."""
    if degree > MAX_DEGREE:
        raise NotImplementedError(f"SH degree {degree} > {MAX_DEGREE}")
    x, y, z = dirs.unbind(-1)
    out = [torch.full_like(x, _C0)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            _C3[0] * y * (3 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4 * zz - xx - yy),
            _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            _C3[4] * x * (4 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3 * yy),
        ]
    if degree >= 4:
        out += [
            _C4[0] * xy * (xx - yy),
            _C4[1] * yz * (3 * xx - yy),
            _C4[2] * xy * (7 * zz - 1),
            _C4[3] * yz * (7 * zz - 3),
            _C4[4] * (zz * (35 * zz - 30) + 3),
            _C4[5] * xz * (7 * zz - 3),
            _C4[6] * (xx - yy) * (7 * zz - 1),
            _C4[7] * xz * (xx - 3 * yy),
            _C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return out


def eval_sh_colors(harmonics: torch.Tensor, dirs: torch.Tensor,
                   degree: int) -> torch.Tensor:
    """harmonics (..., 3, d_sh), dirs (..., 3) -> RGB (..., 3)."""
    basis = torch.stack(sh_basis_cols(dirs, degree), dim=-1)
    n = (degree + 1) ** 2
    rgb = torch.einsum("...cd,...d->...c", harmonics[..., :n], basis)
    return torch.clamp(rgb + 0.5, min=0.0)


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """dirs (..., 3) unit vectors -> (..., (degree+1)^2) basis values."""
    return torch.stack(sh_basis_cols(dirs, degree), dim=-1)


def _sample_dirs(d_sh: int) -> np.ndarray:
    """max(4 d_sh, 64) quasi-uniform unit vectors (golden-angle spiral),
    float32, as JAX `rotate_sh` draws them."""
    m = max(4 * d_sh, 64)
    i = np.arange(m) + 0.5
    phi = np.arccos(1 - 2 * i / m)           # polar
    theta = np.pi * (1 + 5**0.5) * i         # golden-angle azimuth
    return np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=-1).astype(np.float32)


@device_constant
def _refit_tables(degree: int, device):
    """(sample dirs (M, 3), pinv(B(dirs)) (d_sh, M)) on `device`. The pseudo-
    inverse depends only on the degree; it is taken once, in float32 on the
    CPU (on a CUDA tensor `torch.linalg.pinv` would wait for the card)."""
    d_sh = (degree + 1) ** 2
    dirs = torch.from_numpy(_sample_dirs(d_sh))
    pinv = torch.linalg.pinv(sh_basis(dirs, degree))
    return dirs.to(device), pinv.to(device)


def rotate_sh(harmonics: torch.Tensor, rotation: torch.Tensor,
              degree: Optional[int] = None) -> torch.Tensor:
    """Rotate SH coefficients by a 3x3 rotation (JAX `ops/sh.py:155-190`):
    the rotated function's coefficients are refit on fixed sample
    directions, pinv(B(dirs)) @ B(R^T dirs), a (d_sh, d_sh) Wigner-D.

    harmonics (..., d_sh); rotation (3, 3) applied to the function's frame
    (f'(x) = f(R^T x)).
    """
    d_sh = harmonics.shape[-1]
    if degree is None:
        degree = int(round(d_sh**0.5)) - 1
    dirs, pinv = _refit_tables(degree, harmonics.device)
    b_rot = sh_basis(dirs @ rotation.to(dirs.dtype), degree)  # R^T on rows
    transfer = pinv @ b_rot
    return torch.einsum("de,...e->...d", transfer, harmonics)
