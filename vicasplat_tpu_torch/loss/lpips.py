"""LPIPS, the VGG16 perceptual distance (port of vicasplat_tpu/loss/lpips.py:
53-172): the VGG16 convolution trunk, each stage's features unit-normalized
over channels, their squared difference weighted by a 1x1 head per stage
and averaged over space.

Parameters keep the JAX package's layout, so its pickle loads as it is:
{"convs": [{"w": (3, 3, in, out), "b": (out,)}, ...13], "lins": [(C,), ...5]},
here as torch tensors. The convolutions are cuDNN's on the card
(`torch.nn.functional.conv2d`).

The repository ships no VGG weights: `make_lpips_fn` raises without a
weights file unless `allow_random`, when a seeded random VGG
(`init_random_lpips`) backs the same graph - a stand-in that drives the
pipeline, not the trained metric.
"""
from __future__ import annotations

import math
import pathlib
import pickle
import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16's stages: (output channels, convolutions)
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# LPIPS's input scaling of [-1, 1] images
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
DEFAULT_WEIGHTS = pathlib.Path(__file__).parent / "weights" / "lpips_vgg.pkl"


def convert_lpips_torch_state(sd: dict) -> dict:
    """The torch `lpips.LPIPS(net='vgg')` state dict -> the parameter layout
    above, as numpy: 'net.slice{k}.{i}.weight/bias' (OIHW convolutions) and
    'lin{k}.model.1.weight' (1x1 heads)."""
    conv_keys = sorted(
        (k for k in sd if k.startswith("net.") and k.endswith(".weight")),
        key=lambda k: (int(k.split("slice")[1].split(".")[0]), int(k.split(".")[2])))
    params = {"convs": [], "lins": []}
    for k in conv_keys:
        params["convs"].append({
            "w": np.asarray(sd[k]).transpose(2, 3, 1, 0),  # OIHW -> HWIO
            "b": np.asarray(sd[k.replace(".weight", ".bias")])})
    for i in range(5):
        params["lins"].append(np.asarray(sd[f"lin{i}.model.1.weight"]).reshape(-1))
    return params


def params_to_torch(params: dict, device="cpu") -> dict:
    """Numpy (or any array) parameters -> float32 tensors on `device`."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return {"convs": [{"w": t(c["w"]), "b": t(c["b"])} for c in params["convs"]],
            "lins": [t(x) for x in params["lins"]]}


def _vgg_features(params: dict, x: torch.Tensor) -> list:
    """x: (N, H, W, 3) in [-1, 1] -> the 5 stage outputs, (N, C, h, w)."""
    shift = torch.tensor(SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(SCALE, dtype=x.dtype, device=x.device)
    h = ((x - shift) / scale).permute(0, 3, 1, 2)
    feats, idx = [], 0
    for stage, (_, n_convs) in enumerate(VGG_STAGES):
        for _ in range(n_convs):
            p = params["convs"][idx]
            idx += 1
            w = p["w"].to(h.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
            h = F.relu(F.conv2d(h, w, p["b"].to(h.dtype), padding=1))
        feats.append(h)
        if stage < 4:
            # JAX's "VALID" window: an odd last row or column is dropped
            h = F.max_pool2d(h, 2, 2)
    return feats


def lpips_distance(params: dict, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """pred, target: (..., H, W, 3) in [0, 1] -> the mean LPIPS."""
    shape = pred.shape
    x = pred.reshape(-1, *shape[-3:]) * 2.0 - 1.0
    y = target.reshape(-1, *shape[-3:]) * 2.0 - 1.0
    total = 0.0
    for f1, f2, lin in zip(_vgg_features(params, x), _vgg_features(params, y),
                           params["lins"]):
        n1 = f1 / torch.sqrt((f1 ** 2).sum(1, keepdim=True) + 1e-10)
        n2 = f2 / torch.sqrt((f2 ** 2).sum(1, keepdim=True) + 1e-10)
        d = (n1 - n2) ** 2
        total = total + (d * lin.to(d.dtype)[:, None, None]).sum(1).mean((-1, -2))
    return total.mean()


def init_random_lpips(generator: torch.Generator, device="cpu") -> dict:
    """A seeded random VGG16 (He-normal kernels, zero biases) and uniform
    heads 1/C, in the layout above (JAX `init_random_lpips`; the numbers
    come from `generator`, not from JAX's key). A stand-in for the trained
    metric."""
    params = {"convs": [], "lins": []}
    c_in = 3
    for c_out, n_convs in VGG_STAGES:
        for _ in range(n_convs):
            w = torch.randn(3, 3, c_in, c_out, generator=generator, device=device)
            params["convs"].append({"w": w * math.sqrt(2.0 / (9 * c_in)),
                                    "b": torch.zeros(c_out, device=device)})
            c_in = c_out
        params["lins"].append(torch.full((c_out,), 1.0 / c_out, device=device))
    return params


def make_lpips_fn(weights_path: Optional[str] = None, allow_random: bool = False,
                  seed: int = 0, device="cuda"):
    """(pred, target) -> scalar on `device`. Raises without a weights file
    (the JAX package's pickle, or one written from a torch state dict by
    `convert_lpips_torch_state`), unless allow_random."""
    path = pathlib.Path(weights_path) if weights_path else DEFAULT_WEIGHTS
    if not path.exists():
        if not allow_random:
            raise FileNotFoundError(
                f"LPIPS VGG weights not found at {path}. Convert them once with "
                "convert_lpips_torch_state from a torch lpips state dict and pickle "
                "the result there (or pass allow_random=True for a seeded random "
                "stand-in)")
        print("lpips: weights not found; using SEEDED-RANDOM VGG features "
              "(pipeline stand-in, not the trained metric)", file=sys.stderr)
        params = init_random_lpips(torch.Generator(device).manual_seed(seed), device)
    else:
        with open(path, "rb") as f:
            params = params_to_torch(pickle.load(f), device)
    return lambda pred, target: lpips_distance(params, pred, target)
