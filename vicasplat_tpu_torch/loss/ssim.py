"""Windowed SSIM with a separable Gaussian filter (port of
vicasplat_tpu/loss/ssim.py:13-136): an 11 x 11 window, sigma 1.5, each
channel filtered alone, over the windows that lie inside the image (the
JAX package's SAME filtering with the window_size // 2 margin cropped).
Images are (..., H, W, C) in [0, 1].

The filter is a weighted sum of shifted slices, in float32 on every
device: through cuDNN, a convolution on the card would run in TF32 where
`torch.backends.cudnn.allow_tf32` is on (its default), and the 10-bit
mantissa moves a scene's mean SSIM by about 0.002.
"""
from __future__ import annotations

import numpy as np
import torch


def _gaussian_weights(window_size: int, sigma: float) -> list:
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32).tolist()


def _filter_valid(x: torch.Tensor, w: list) -> torch.Tensor:
    """Separable filtering of (N, H, W, C) over the windows inside the
    image: (N, H - n + 1, W - n + 1, C)."""
    n = len(w)
    h, wd = x.shape[1] - n + 1, x.shape[2] - n + 1
    y = sum(wi * x[:, i:i + h] for i, wi in enumerate(w))
    return sum(wi * y[:, :, i:i + wd] for i, wi in enumerate(w))


def _moments(img1, img2, window_size, sigma):
    """(mu_x, mu_y, E[x^2], E[y^2], E[xy]) over the interior windows."""
    h, w, c = img1.shape[-3:]
    x = img1.reshape(-1, h, w, c).float()
    y = img2.reshape(-1, h, w, c).float()
    k = _gaussian_weights(window_size, sigma)
    return tuple(_filter_valid(t, k) for t in (x, y, x * x, y * y, x * y))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> torch.Tensor:
    """Mean SSIM over all pixels and channels; leading dims are flattened.
    Variances are clamped at 0 and sigma_xy is held within the
    Cauchy-Schwarz bound, which is detached: where a window is constant
    (variance 0), sqrt' is inf and the clamp's tie would send inf * 0 = NaN
    into every upstream gradient."""
    mu_x, mu_y, exx, eyy, exy = _moments(img1, img2, window_size, sigma)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    zero = mu_x.new_zeros(())
    sigma_x = torch.maximum(exx - mu_x2, zero)
    sigma_y = torch.maximum(eyy - mu_y2, zero)
    sigma_xy = exy - mu_xy
    bound = torch.sqrt(sigma_x * sigma_y).detach()
    # jnp.clip's minimum(maximum(.)): a tie passes half the gradient
    sigma_xy = torch.minimum(torch.maximum(sigma_xy, -bound), bound)
    ssim_map = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sigma_x + sigma_y + c2))
    return ssim_map.mean()


def ssim_components(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
                    sigma: float = 1.5, c1: float = 0.01 ** 2,
                    c2: float = 0.03 ** 2) -> dict:
    """SSIM split into brightness, contrast and structure terms: the
    sign-corrected sigma_xy within the Cauchy-Schwarz bound, C3 = C2 / 2,
    contrast and structure capped at 0.98. Returns scalars ssim,
    brightness, contrast, structure and cs."""
    mu_x, mu_y, exx, eyy, exy = _moments(img1, img2, window_size, sigma)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x, sigma_y, sigma_xy = exx - mu_x2, eyy - mu_y2, exy - mu_xy

    cs_map = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    lum_map = (2 * mu_xy + c1) / (mu_x2 + mu_y2 + c1)
    eps = mu_x.new_tensor(float(np.finfo(np.float32).eps) ** 2)
    sx = torch.maximum(sigma_x, eps)
    sy = torch.maximum(sigma_y, eps)
    sxy_bound = torch.sqrt(sx * sy)
    sxy = torch.sign(sigma_xy) * torch.minimum(sxy_bound, sigma_xy.abs())
    c3 = c2 / 2
    cap = mu_x.new_tensor(0.98)
    contrast_map = torch.minimum((2 * sxy_bound + c2) / (sx + sy + c2), cap)
    structure_map = torch.minimum((sxy + c3) / (sxy_bound + c3), cap)
    return {
        "ssim": (lum_map * cs_map).mean(),
        "cs": cs_map.mean(),
        "brightness": lum_map.mean(),
        "contrast": contrast_map.mean(),
        "structure": structure_map.mean(),
    }
