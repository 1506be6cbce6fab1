"""VicaNet backbone (port of vicasplat_tpu/models/vicanet.py).

A per-frame ViT encoder (2D RoPE base 100, optional camera-intrinsic token
at grid position (gh, 0)), then a "mix" video decoder with per-frame camera
tokens: AdaLN modulation of the image tokens by the camera token, joint
video-camera attention over the frame-major [cam_t, img_t...] keys
(blocked-causal mask for the camera queries, temporal RoPE theta 30 on
camera q/k) and a cross-neighbour attention term.

The decoder's joint image attention runs through kernel K1
(kernels/flash_attn.py) when `use_flash_attention` is set; on a CPU tensor
K1's wrapper takes its plain version.

With `remat=True` each encoder and decoder block runs under
`torch.utils.checkpoint` and is recomputed in the backward;
`remat_policy="dots"` keeps the products of the linear layers (aten mm and
addmm, no batch dimension), the counterpart of JAX's
`dots_with_no_batch_dims_saveable`, and recomputes the rest, the batched
attention products included.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..kernels.flash_attn import flash_attention
from ..ops import rope as rope_lib
from ..utils.device_cache import as_device, device_constant
from .layers import Mlp, conv2d_patchify, layernorm, linear, mlp, sdpa


@dataclasses.dataclass(frozen=True)
class VicaNetConfig:
    img_size: int = 256
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: float = 4.0
    temporal_rope_theta: float = 30.0
    rope_dim_list: tuple = (32, 32)
    spatial_rope_base: float = 100.0
    use_blocked_causal_attention: bool = True
    use_framewise_modulation: bool = True
    use_cross_neighbor_attention: bool = True
    use_intrinsic_embedding: bool = True
    use_flash_attention: bool = True
    enc_use_flash_attention: bool = False
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def enc_head_dim(self) -> int:
        return self.enc_embed_dim // self.enc_num_heads

    @property
    def dec_head_dim(self) -> int:
        return self.dec_embed_dim // self.dec_num_heads


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class CrossAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)


class Modulation(nn.Module):
    def __init__(self, dim: int, n_mods: int):
        super().__init__()
        self.proj = nn.Linear(dim, n_mods * dim)
        self.n_mods = n_mods

    def forward(self, cam_normed: torch.Tensor, dtype):
        """(B, T, C) -> n_mods tensors of (B, T, 1, C)."""
        h = F.silu(cam_normed.float()).to(cam_normed.dtype)
        return linear(self.proj, h, dtype)[:, :, None, :].chunk(self.n_mods, -1)


def _split_qkv(qkv: torch.Tensor, n_heads: int):
    return tuple(x.unflatten(-1, (n_heads, -1)) for x in qkv.chunk(3, dim=-1))


def _neighbor_kv(k: torch.Tensor, v: torch.Tensor, T: int):
    """Cross-neighbour keys/values along the frame axis of (B, T, N, H, D):
    T == 2 sees the other frame; T > 2 sees prev + next, boundary frames
    their one neighbour twice."""
    if T == 2:
        return k.roll(1, 1), v.roll(1, 1)

    def both(x):
        prev, nxt = x.roll(1, 1), x.roll(-1, 1)
        prev[:, 0] = nxt[:, 0]
        nxt[:, -1] = prev[:, -1]
        return torch.cat([prev, nxt], dim=2)

    return both(k), both(v)


class EncBlock(nn.Module):
    def __init__(self, cfg: VicaNetConfig):
        super().__init__()
        d = cfg.enc_embed_dim
        self.n_heads = cfg.enc_num_heads
        self.flash = cfg.enc_use_flash_attention
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = Attention(d)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio))

    def forward(self, x, cos, sin, dtype):
        """x (B, N, C); rope tables (N, D)."""
        h = layernorm(self.norm1, x)
        q, k, v = _split_qkv(linear(self.attn.qkv, h, dtype), self.n_heads)
        q = rope_lib.apply_rope_2d(q, cos[:, None, :], sin[:, None, :])
        k = rope_lib.apply_rope_2d(k, cos[:, None, :], sin[:, None, :])
        a = flash_attention(q, k, v.contiguous()) if self.flash else sdpa(q, k, v)
        x = x + linear(self.attn.proj, a.reshape(x.shape), dtype)
        return x + mlp(self.mlp, layernorm(self.norm2, x), dtype)


class DecBlock(nn.Module):
    """One MixDecoderBlock over img (B, T, N, C) and cam (B, T, C)."""

    def __init__(self, cfg: VicaNetConfig):
        super().__init__()
        d = cfg.dec_embed_dim
        hidden = int(d * cfg.mlp_ratio)
        self.cfg = cfg
        self.cam_norm1 = nn.LayerNorm(d, eps=1e-6)
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = Attention(d)
        self.cam_norm2 = nn.LayerNorm(d, eps=1e-6)
        self.norm3 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = Mlp(d, hidden)
        self.mlp_cam = Mlp(d, hidden)
        if cfg.use_framewise_modulation:
            self.modulation1 = Modulation(d, 3)
            self.modulation2 = Modulation(
                d, 6 if cfg.use_cross_neighbor_attention else 3)
        if cfg.use_cross_neighbor_attention:
            self.norm2 = nn.LayerNorm(d, eps=1e-6)
            self.cross_attn = CrossAttention(d)

    def forward(self, img, cam, tables, dtype):
        cfg = self.cfg
        B, T, N, C = img.shape
        H = cfg.dec_num_heads
        cos_s, sin_s, cos_t, sin_t, cam_mask = tables
        modulate = cfg.use_framewise_modulation
        cross = cfg.use_cross_neighbor_attention

        cam_normed = layernorm(self.cam_norm1, cam)
        img_n = layernorm(self.norm1, img)
        gate_sa = None
        if modulate:
            scale_sa, shift_sa, gate_sa = self.modulation1(cam_normed, dtype)
            img_n = img_n * (1.0 + scale_sa) + shift_sa

        # ---- joint video-camera attention ----
        q_i, k_i, v_i = _split_qkv(linear(self.attn.qkv, img_n, dtype), H)
        q_i = rope_lib.apply_rope_2d(q_i, cos_s[:, None, :], sin_s[:, None, :])
        k_i = rope_lib.apply_rope_2d(k_i, cos_s[:, None, :], sin_s[:, None, :])
        q_c, k_c, v_c = _split_qkv(linear(self.attn.qkv, cam_normed, dtype), H)
        q_c = rope_lib.apply_rope_interleaved(q_c, cos_t[:, None, :], sin_t[:, None, :])
        k_c = rope_lib.apply_rope_interleaved(k_c, cos_t[:, None, :], sin_t[:, None, :])

        # frame-major fused keys: [cam_t, img_t...] per frame
        k_f = torch.cat([k_c[:, :, None], k_i], dim=2).reshape(B, T * (N + 1), H, -1)
        v_f = torch.cat([v_c[:, :, None], v_i], dim=2).reshape(B, T * (N + 1), H, -1)
        q_if = q_i.reshape(B, T * N, H, -1)
        attend = flash_attention if cfg.use_flash_attention else sdpa
        img_a = attend(q_if, k_f, v_f).reshape(B, T, N, C)
        mask = None if cam_mask is None else cam_mask[None, None]
        cam_a = sdpa(q_c, k_f, v_f, mask=mask).reshape(B, T, C)

        img_a = linear(self.attn.proj, img_a, dtype)
        cam_a = linear(self.attn.proj, cam_a, dtype)
        img = img + (img_a if gate_sa is None else (1.0 + gate_sa) * img_a)
        cam = cam + cam_a

        # ---- cross-neighbour attention + MLP, both AdaLN-modulated ----
        cam_normed = layernorm(self.cam_norm2, cam)
        gate_ca = gate_m = None
        if modulate and cross:
            (scale_ca, shift_ca, gate_ca, scale_m, shift_m,
             gate_m) = self.modulation2(cam_normed, dtype)
        elif modulate:
            scale_m, shift_m, gate_m = self.modulation2(cam_normed, dtype)

        if cross:
            img_n = layernorm(self.norm2, img)
            if gate_ca is not None:
                img_n = img_n * (1.0 + scale_ca) + shift_ca
            ca = self.cross_attn
            q = linear(ca.projq, img_n, dtype).unflatten(-1, (H, -1))
            k = linear(ca.projk, img_n, dtype).unflatten(-1, (H, -1))
            v = linear(ca.projv, img_n, dtype).unflatten(-1, (H, -1))
            q = rope_lib.apply_rope_2d(q, cos_s[:, None, :], sin_s[:, None, :])
            k = rope_lib.apply_rope_2d(k, cos_s[:, None, :], sin_s[:, None, :])
            k_n, v_n = _neighbor_kv(k, v, T)
            out = sdpa(q.flatten(0, 1), k_n.flatten(0, 1), v_n.flatten(0, 1))
            out = linear(ca.proj, out.reshape(B, T, N, C), dtype)
            img = img + (out if gate_ca is None else (1.0 + gate_ca) * out)

        img_n = layernorm(self.norm3, img)
        if gate_m is not None:
            img_n = img_n * (1.0 + scale_m) + shift_m
        img_m = mlp(self.mlp, img_n, dtype)
        img = img + (img_m if gate_m is None else (1.0 + gate_m) * img_m)
        cam = cam + mlp(self.mlp_cam, cam_normed, dtype)
        return img, cam


REMAT_POLICIES = (None, "dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _block_runner(remat: bool, remat_policy: Optional[str]):
    """Call a block directly, or under checkpoint with the policy's saves."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={remat_policy!r} is not one of "
                         f"{REMAT_POLICIES}")
    if not remat:
        return lambda blk, *args: blk(*args)
    kw = {}
    if remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_dots)
    return lambda blk, *args: checkpoint(blk, *args, use_reentrant=False, **kw)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


def camera_blocked_causal_mask(T: int, n_tokens: int, first_token_full_attn: bool,
                               device=None) -> torch.Tensor:
    """(T, T * (1 + n_tokens)) bool mask of the camera queries over the fused
    frame-major keys. True = attend. One cached mask per arguments and
    device."""
    return _camera_mask(T, n_tokens, first_token_full_attn, as_device(device))


@device_constant
def _camera_mask(T: int, n_tokens: int, first_token_full_attn: bool,
                 device) -> torch.Tensor:
    frame = np.tril(np.ones((T, T), dtype=bool))
    if first_token_full_attn:
        frame[0, :] = True
    return torch.tensor(np.repeat(frame, 1 + n_tokens, axis=1), device=device)


def _spatial_rope_tables(cfg: VicaNetConfig, head_dim: int, grid_hw, device):
    gh, gw = grid_hw
    pos = rope_lib.grid_positions(gh, gw)
    if cfg.use_intrinsic_embedding:
        pos = np.concatenate([pos, np.array([[gh, 0]])], axis=0)
    return rope_lib.make_rope_2d_tables(pos, head_dim, cfg.spatial_rope_base,
                                        device=device)


class VicaNet(nn.Module):
    def __init__(self, cfg: VicaNetConfig):
        super().__init__()
        if cfg.moe_experts > 0:
            raise NotImplementedError("MoE decoder MLPs are not ported yet")
        self.cfg = cfg
        d_e, d_d = cfg.enc_embed_dim, cfg.dec_embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, d_e)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg) for _ in range(cfg.enc_depth))
        self.enc_norm = nn.LayerNorm(d_e, eps=1e-6)
        self.decoder_embed = nn.Linear(d_e, d_d)
        self.camera_extrinsic_token = nn.Parameter(torch.zeros(d_d))
        self.camera_intrinsic_token = nn.Parameter(torch.zeros(d_d))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg) for _ in range(cfg.dec_depth))
        self.dec_norm = nn.LayerNorm(d_d, eps=1e-6)
        self.camera_dec_norm = nn.LayerNorm(d_d, eps=1e-6)
        if cfg.use_intrinsic_embedding:
            self.intrinsic_encoder = nn.Linear(9, d_e)

    def forward(self, images: torch.Tensor,
                intrinsics: Optional[torch.Tensor] = None, *,
                dtype=torch.bfloat16, remat: bool = False,
                remat_policy: Optional[str] = None):
        """images (B, T, H, W, 3) in [-1, 1]; intrinsics (B, T, 3, 3).

        Returns (x_final, camera_extrinsic_tokens, camera_intrinsic_tokens,
        intermediates): intermediates are [enc_out] + the decoder blocks'
        outputs (the last one normed), each (B, T, n_patches, C).
        """
        cfg = self.cfg
        run = _block_runner(remat, remat_policy)
        dev = images.device
        B, T, Himg, Wimg, _ = images.shape
        gh, gw = Himg // cfg.patch_size, Wimg // cfg.patch_size
        n_patches = gh * gw
        N = n_patches + (1 if cfg.use_intrinsic_embedding else 0)

        x = conv2d_patchify(self.patch_embed.proj,
                            images.reshape(B * T, Himg, Wimg, 3),
                            cfg.patch_size, dtype)
        x = x.reshape(B * T, n_patches, cfg.enc_embed_dim)
        if cfg.use_intrinsic_embedding:
            if intrinsics is None:
                raise ValueError("backbone configured with intrinsic embedding")
            emb = linear(self.intrinsic_encoder, intrinsics.reshape(B, T, 9), dtype)
            x = torch.cat([x, emb.reshape(B * T, 1, cfg.enc_embed_dim)], dim=1)

        cos_e, sin_e = _spatial_rope_tables(cfg, cfg.enc_head_dim, (gh, gw), dev)
        for blk in self.enc_blocks:
            x = run(blk, x, cos_e, sin_e, dtype)
        enc_out = layernorm(self.enc_norm, x).reshape(B, T, N, cfg.enc_embed_dim)

        img = linear(self.decoder_embed, enc_out, dtype)
        d = cfg.dec_embed_dim
        tok_i = self.camera_intrinsic_token.to(img.dtype)
        tok_e = self.camera_extrinsic_token.to(img.dtype)
        cam = torch.cat([tok_i.expand(B, 1, d), (tok_i + tok_e).expand(B, T - 1, d)],
                        dim=1)

        cos_s, sin_s = _spatial_rope_tables(cfg, cfg.dec_head_dim, (gh, gw), dev)
        cos_t, sin_t = rope_lib.make_rope_nd_tables(
            [cfg.dec_head_dim], [T], theta=cfg.temporal_rope_theta, device=dev)
        cam_mask = (
            camera_blocked_causal_mask(T, N, not cfg.use_intrinsic_embedding, dev)
            if cfg.use_blocked_causal_attention else None
        )
        tables = (cos_s, sin_s, cos_t, sin_t, cam_mask)
        inter = []
        for blk in self.dec_blocks:
            img, cam = run(blk, img, cam, tables, dtype)
            inter.append(img)

        intermediates = [enc_out] + inter
        intermediates[-1] = layernorm(self.dec_norm, intermediates[-1])
        cam = layernorm(self.camera_dec_norm, cam)
        if cfg.use_intrinsic_embedding:
            intermediates = [t[:, :, :-1] for t in intermediates]
            camera_intrinsic = None
        else:
            camera_intrinsic = cam[:, 0]
        return intermediates[-1], cam[:, 1:], camera_intrinsic, intermediates
