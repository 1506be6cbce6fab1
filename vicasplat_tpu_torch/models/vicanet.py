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

With `moe_experts > 0` the decoder blocks' image-token MLP is a
mixture of experts (models/moe.py; `mlp_cam` stays dense). The forward
takes JAX's mesh arguments (parallel/): a GPipe pipeline over the block
stacks, sequence parallelism over the patch tokens, expert parallelism;
tensor parallelism is set on the blocks by parallel/tp.shard_params_tp.

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
from ..parallel.comm import copy_to_group, reduce_from_group
from .layers import Mlp, conv2d_patchify, layernorm, linear, mlp, sdpa
from .moe import MoeMlp, moe_mlp


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


def _split_heads(qkv: torch.Tensor, head_dim: int):
    """(..., 3 * h * head_dim) -> q, k, v of (..., h, head_dim): the local
    heads, which are all heads unless tensor parallelism cut them."""
    return tuple(x.unflatten(-1, (-1, head_dim)) for x in qkv.chunk(3, dim=-1))


def _row_linear(mod: nn.Linear, x: torch.Tensor, dtype, group) -> torch.Tensor:
    """A linear; under tensor parallelism (`group`) a row-parallel one: the
    local product summed over the group, then the bias once."""
    if group is None:
        return linear(mod, x, dtype)
    dt = dtype if dtype is not None else torch.promote_types(x.dtype, mod.weight.dtype)
    y = reduce_from_group(F.linear(x.to(dt), mod.weight.to(dt)), group)
    return y if mod.bias is None else y + mod.bias.to(dt)


def _mlp_tp(mod: Mlp, x: torch.Tensor, dtype, group) -> torch.Tensor:
    """layers.mlp with fc1 column- and fc2 row-parallel under `group`."""
    if group is None:
        return mlp(mod, x, dtype)
    h = F.gelu(linear(mod.fc1, copy_to_group(x, group), dtype))
    return _row_linear(mod.fc2, h, dtype, group)


class EncBlock(nn.Module):
    def __init__(self, cfg: VicaNetConfig):
        super().__init__()
        d = cfg.enc_embed_dim
        self.n_heads = cfg.enc_num_heads
        self.head_dim = d // cfg.enc_num_heads
        self.flash = cfg.enc_use_flash_attention
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = Attention(d)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio))
        self.tp_group = None  # set by parallel/tp.shard_params_tp

    def forward(self, x, cos, sin, dtype, sp=None):
        """x (B, N, C); rope tables (N, D). Under sequence parallelism (`sp`,
        a parallel/sp.SeqShard) x and the tables hold this rank's tokens and
        the keys and values are gathered whole."""
        g = self.tp_group
        h = copy_to_group(layernorm(self.norm1, x), g)
        q, k, v = _split_heads(linear(self.attn.qkv, h, dtype), self.head_dim)
        q = rope_lib.apply_rope_2d(q, cos[:, None, :], sin[:, None, :])
        k = rope_lib.apply_rope_2d(k, cos[:, None, :], sin[:, None, :])
        if sp is not None:
            k, v = sp.gather(k, 1), sp.gather(v, 1)
        a = flash_attention(q, k, v.contiguous()) if self.flash else sdpa(q, k, v)
        x = x + _row_linear(self.attn.proj, a.flatten(-2), dtype, g)
        return x + _mlp_tp(self.mlp, layernorm(self.norm2, x), dtype, g)


class DecBlock(nn.Module):
    """One MixDecoderBlock over img (B, T, N, C) and cam (B, T, C). The image
    tokens' MLP is an MoeMlp when cfg.moe_experts > 0 (mlp_cam stays
    dense)."""

    def __init__(self, cfg: VicaNetConfig):
        super().__init__()
        d = cfg.dec_embed_dim
        hidden = int(d * cfg.mlp_ratio)
        self.cfg = cfg
        self.n_heads = cfg.dec_num_heads
        self.cam_norm1 = nn.LayerNorm(d, eps=1e-6)
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = Attention(d)
        self.cam_norm2 = nn.LayerNorm(d, eps=1e-6)
        self.norm3 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = (Mlp(d, hidden) if cfg.moe_experts == 0
                    else MoeMlp(d, hidden, cfg.moe_experts))
        self.mlp_cam = Mlp(d, hidden)
        if cfg.use_framewise_modulation:
            self.modulation1 = Modulation(d, 3)
            self.modulation2 = Modulation(
                d, 6 if cfg.use_cross_neighbor_attention else 3)
        if cfg.use_cross_neighbor_attention:
            self.norm2 = nn.LayerNorm(d, eps=1e-6)
            self.cross_attn = CrossAttention(d)
        self.tp_group = None  # set by parallel/tp.shard_params_tp

    def forward(self, img, cam, tables, dtype, sp=None, moe=None):
        """-> (img, cam, the MoE load-balance loss or None). `sp`: as in
        EncBlock (img holds this rank's tokens of each frame); `moe`:
        moe_mlp's keyword arguments beyond the config's."""
        cfg = self.cfg
        B, T, N, C = img.shape
        hd = cfg.dec_head_dim
        g = self.tp_group
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
        q_i, k_i, v_i = _split_heads(
            linear(self.attn.qkv, copy_to_group(img_n, g), dtype), hd)
        q_i = rope_lib.apply_rope_2d(q_i, cos_s[:, None, :], sin_s[:, None, :])
        k_i = rope_lib.apply_rope_2d(k_i, cos_s[:, None, :], sin_s[:, None, :])
        q_c, k_c, v_c = _split_heads(
            linear(self.attn.qkv, copy_to_group(cam_normed, g), dtype), hd)
        q_c = rope_lib.apply_rope_interleaved(q_c, cos_t[:, None, :], sin_t[:, None, :])
        k_c = rope_lib.apply_rope_interleaved(k_c, cos_t[:, None, :], sin_t[:, None, :])
        if sp is not None:
            k_i, v_i = sp.gather(k_i, 2), sp.gather(v_i, 2)
        Nk, Hl = k_i.shape[2], k_i.shape[3]

        # frame-major fused keys: [cam_t, img_t...] per frame
        k_f = torch.cat([k_c[:, :, None], k_i], dim=2).reshape(B, T * (Nk + 1), Hl, hd)
        v_f = torch.cat([v_c[:, :, None], v_i], dim=2).reshape(B, T * (Nk + 1), Hl, hd)
        q_if = q_i.reshape(B, T * N, Hl, hd)
        attend = flash_attention if cfg.use_flash_attention else sdpa
        img_a = attend(q_if, k_f, v_f).reshape(B, T, N, Hl * hd)
        mask = None if cam_mask is None else cam_mask[None, None]
        cam_a = sdpa(q_c, k_f, v_f, mask=mask).reshape(B, T, Hl * hd)

        img_a = _row_linear(self.attn.proj, img_a, dtype, g)
        cam_a = _row_linear(self.attn.proj, cam_a, dtype, g)
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
            img_n = copy_to_group(img_n, g)
            q = linear(ca.projq, img_n, dtype).unflatten(-1, (-1, hd))
            k = linear(ca.projk, img_n, dtype).unflatten(-1, (-1, hd))
            v = linear(ca.projv, img_n, dtype).unflatten(-1, (-1, hd))
            q = rope_lib.apply_rope_2d(q, cos_s[:, None, :], sin_s[:, None, :])
            k = rope_lib.apply_rope_2d(k, cos_s[:, None, :], sin_s[:, None, :])
            if sp is not None:
                k, v = sp.gather(k, 2), sp.gather(v, 2)
            k_n, v_n = _neighbor_kv(k, v, T)
            out = sdpa(q.flatten(0, 1), k_n.flatten(0, 1), v_n.flatten(0, 1))
            out = _row_linear(ca.proj, out.reshape(B, T, N, -1), dtype, g)
            img = img + (out if gate_ca is None else (1.0 + gate_ca) * out)

        img_n = layernorm(self.norm3, img)
        if gate_m is not None:
            img_n = img_n * (1.0 + scale_m) + shift_m
        aux = None
        if isinstance(self.mlp, MoeMlp):
            # capacity counts every token of the call: route them whole
            full = img_n if sp is None else sp.gather(img_n, 2)
            moe = moe or {}
            img_m = moe_mlp(self.mlp, full, top_k=cfg.moe_top_k,
                            capacity_factor=cfg.moe_capacity_factor,
                            dtype=dtype, **moe)
            if moe.get("return_aux"):
                img_m, aux = img_m
            if sp is not None:
                img_m = sp.shard(img_m, 2)
        else:
            img_m = _mlp_tp(self.mlp, img_n, dtype, g)
        img = img + (img_m if gate_m is None else (1.0 + gate_m) * img_m)
        cam = cam + _mlp_tp(self.mlp_cam, cam_normed, dtype, g)
        return img, cam, aux


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
                remat_policy: Optional[str] = None,
                pipeline_group=None, pipeline_n_micro: Optional[int] = None,
                sp_mesh=None, ep_group=None, moe_token_group=None,
                return_moe_aux: bool = False):
        """images (B, T, H, W, 3) in [-1, 1]; intrinsics (B, T, 3, 3).

        Returns (x_final, camera_extrinsic_tokens, camera_intrinsic_tokens,
        intermediates[, moe_aux]): intermediates are [enc_out] + the decoder
        blocks' outputs (the last one normed), each (B, T, n_patches, C);
        moe_aux is the decoder blocks' mean load-balance loss (0 for dense
        MLPs).

        The mesh arguments of JAX's `vicanet_forward` (parallel/):
        - pipeline_group: a "pipe" process group or mesh; each stack whose
          depth the stage count divides runs as a GPipe pipeline of
          pipeline_n_micro micro-batches (the encoder's over B*T frames,
          the decoder's over gcd(B, n) examples); other depths run plain.
          Not with MoE, nor with sp_mesh, as in JAX.
        - sp_mesh: a ("data", "seq") mesh; the patch tokens split over
          "seq" (parallel/sp.py); images are this rank's "data" slice.
          Under autograd every rank's gradient is its share of the
          gradient of the "seq" ranks' summed losses (each collective's
          backward is its adjoint): training/step.make_train_step(
          sp_mesh=...) averages it over the mesh.
        - ep_group: the group the MoE experts are sharded over
          (parallel/ep.py), with moe_token_group the ranks whose tokens
          make up the call (default all); moe_token_group alone (DDP)
          routes the whole call's tokens with every expert local.
        - tensor parallelism needs no argument: parallel/tp.shard_params_tp
          gives each block its group."""
        cfg = self.cfg
        if sp_mesh is not None and pipeline_group is not None:
            raise ValueError("sp_mesh and pipeline_group are exclusive")
        if sp_mesh is not None and ep_group is not None:
            raise ValueError("sp_mesh and ep_group are exclusive (one mesh "
                             "per forward, as in JAX)")
        run = _block_runner(remat, remat_policy)
        dev = images.device
        B, T, Himg, Wimg, _ = images.shape
        gh, gw = Himg // cfg.patch_size, Wimg // cfg.patch_size
        n_patches = gh * gw
        N = n_patches + (1 if cfg.use_intrinsic_embedding else 0)
        sp = None
        if sp_mesh is not None:
            from ..parallel.sp import SeqShard

            sp = SeqShard(sp_mesh, N)

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
        if sp is not None:
            x, cos_e, sin_e = sp.shard(x, 1), sp.shard(cos_e, 0), sp.shard(sin_e, 0)
        S = 0 if pipeline_group is None else _stages(pipeline_group)
        if S and cfg.enc_depth % S == 0:
            from ..parallel.pp import pipeline_scan

            x = pipeline_scan(lambda h, blk: run(blk, h, cos_e, sin_e, dtype),
                              self.enc_blocks, x, pipeline_group,
                              n_micro=pipeline_n_micro)
        else:
            for blk in self.enc_blocks:
                x = run(blk, x, cos_e, sin_e, dtype, sp)
        enc_out = layernorm(self.enc_norm, x).reshape(B, T, -1, cfg.enc_embed_dim)

        img = linear(self.decoder_embed, enc_out, dtype)
        d = cfg.dec_embed_dim
        tok_i = self.camera_intrinsic_token.to(img.dtype)
        tok_e = self.camera_extrinsic_token.to(img.dtype)
        cam = torch.cat([tok_i.expand(B, 1, d), (tok_i + tok_e).expand(B, T - 1, d)],
                        dim=1)

        cos_s, sin_s = _spatial_rope_tables(cfg, cfg.dec_head_dim, (gh, gw), dev)
        if sp is not None:
            cos_s, sin_s = sp.shard(cos_s, 0), sp.shard(sin_s, 0)
        cos_t, sin_t = rope_lib.make_rope_nd_tables(
            [cfg.dec_head_dim], [T], theta=cfg.temporal_rope_theta, device=dev)
        cam_mask = (
            camera_blocked_causal_mask(T, N, not cfg.use_intrinsic_embedding, dev)
            if cfg.use_blocked_causal_attention else None
        )
        tables = (cos_s, sin_s, cos_t, sin_t, cam_mask)
        moe = {"return_aux": return_moe_aux}  # the aux only when asked
        if ep_group is not None:
            moe["ep_group"] = ep_group
        if moe_token_group is not None:
            moe["token_group"] = moe_token_group
        aux_sum = None
        if S and cfg.dec_depth % S == 0:
            if cfg.moe_experts:
                raise ValueError("MoE decoder MLPs don't compose with the "
                                 "pipeline; use ep_group instead")
            from ..parallel.pp import decoder_micro, pipeline_scan

            def dec_step(carry, blk):
                i, c, _ = run(blk, carry[0], carry[1], tables, dtype)
                return (i, c), i

            (img, cam), ys = pipeline_scan(
                dec_step, self.dec_blocks, (img, cam), pipeline_group,
                n_micro=decoder_micro(B, pipeline_n_micro or S),
                collect_outputs=True)
            inter = list(ys.unbind(0))
        else:
            inter = []
            for blk in self.dec_blocks:
                img, cam, aux = run(blk, img, cam, tables, dtype, sp, moe)
                inter.append(img)
                if aux is not None:
                    aux_sum = aux if aux_sum is None else aux_sum + aux

        intermediates = [enc_out] + inter
        if sp is not None:
            intermediates = [sp.gather(t, 2) for t in intermediates]
        intermediates[-1] = layernorm(self.dec_norm, intermediates[-1])
        cam = layernorm(self.camera_dec_norm, cam)
        if cfg.use_intrinsic_embedding:
            intermediates = [t[:, :, :-1] for t in intermediates]
            camera_intrinsic = None
        else:
            camera_intrinsic = cam[:, 0]
        out = (intermediates[-1], cam[:, 1:], camera_intrinsic, intermediates)
        if not return_moe_aux:
            return out
        if aux_sum is None:
            aux_sum = torch.zeros((), device=dev)
        return out + (aux_sum / cfg.dec_depth,)


def _stages(group) -> int:
    from ..parallel.comm import group_of

    import torch.distributed as dist

    return dist.get_world_size(group_of(group, "pipe"))
