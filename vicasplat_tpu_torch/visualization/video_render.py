"""Trajectory videos of a Gaussian scene (port of
vicasplat_tpu/visualization/video_render.py): a wobble around the first
context view, and the ScLERP interpolation through the predicted poses,
rendered through `decoder_forward`."""
from __future__ import annotations

import numpy as np
import torch

from ..decoder.splatting import DecoderSplattingConfig, decoder_forward
from ..models.adapter import Gaussians
from .camera_trajectory import generate_wobble, interpolate_trajectory


def _render(gaussians: Gaussians, traj: torch.Tensor, K: torch.Tensor,
            image_shape: tuple, dec_cfg: DecoderSplattingConfig) -> np.ndarray:
    n = traj.shape[0]
    full = lambda v: torch.full((1, n), v, device=traj.device)  # noqa: E731
    with torch.no_grad():
        out = decoder_forward(dec_cfg, gaussians, traj[None],
                              K.expand(n, 3, 3)[None], full(0.05), full(100.0),
                              tuple(image_shape))
    return out.color[0].float().cpu().numpy()


def render_video_wobble(gaussians: Gaussians, extrinsics: torch.Tensor,
                        intrinsics: torch.Tensor, image_shape: tuple,
                        num_frames: int = 60,
                        dec_cfg: DecoderSplattingConfig = DecoderSplattingConfig()
                        ) -> np.ndarray:
    """(V, 4, 4) context c2w (wobbles around view 0), (V, 3, 3) ->
    (num_frames, H, W, 3) float32."""
    delta = torch.linalg.vector_norm(extrinsics[0, :3, 3] - extrinsics[-1, :3, 3])
    t = torch.linspace(0, 1, num_frames, dtype=extrinsics.dtype,
                       device=extrinsics.device)
    traj = generate_wobble(extrinsics[0], 0.25 * float(delta), t)
    return _render(gaussians, traj, intrinsics[0], image_shape, dec_cfg)


def render_video_interpolation(gaussians: Gaussians, extrinsics: torch.Tensor,
                               intrinsics: torch.Tensor, image_shape: tuple,
                               steps_per_segment: int = 10,
                               dec_cfg: DecoderSplattingConfig = DecoderSplattingConfig()
                               ) -> np.ndarray:
    """(V, 4, 4) predicted c2w, (V, 3, 3) -> ((V - 1) * steps_per_segment
    + 1, H, W, 3) float32."""
    traj = interpolate_trajectory(extrinsics, steps_per_segment)
    return _render(gaussians, traj, intrinsics[0], image_shape, dec_cfg)
