"""DUSt3R/MASt3R two-view teacher (port of vicasplat_tpu/models/dust3r.py),
the frozen target of the distillation stage.

A shared ViT encoder over both views (2D RoPE base 100), then two CroCo
decoders of `dec_depth` blocks, one a view: each block runs self-attention,
cross-attention to the other view's tokens of the previous layer (through
`norm_y`), then an MLP, with 2D RoPE on every q and k. Two DPT regression
heads (hooks 0, dec_depth / 2, 3 dec_depth / 4, dec_depth) give each
view's points (exp-mapped) and confidence in view 1's frame.

Attention is the plain `layers.sdpa`, as in JAX: the teacher never ran
through the Pallas kernel, so it does not run through K1. Its weights come
from `init_dust3r` (random, from a Generator) or from a DUSt3R/MASt3R
checkpoint through `utils/ckpt_convert.convert_dust3r_state_dict`.
`make_teacher_fn` freezes the module: no gradient, no optimizer, no
checkpoint.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import rope as rope_lib
from .heads import DPT, DPTConfig, dpt_regression_head, postprocess_conf_exp, postprocess_pts3d_exp
from .layers import Mlp, conv2d_patchify, init_default_, layernorm, linear, mlp, sdpa
from .vicanet import Attention, CrossAttention, EncBlock, PatchEmbed, VicaNetConfig, _split_qkv


@dataclasses.dataclass(frozen=True)
class Dust3RConfig:
    img_size: int = 256  # a multiple of 16 (512 for the released checkpoints)
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: float = 4.0
    rope_base: float = 100.0
    predict_conf: bool = True

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def enc_head_dim(self) -> int:
        return self.enc_embed_dim // self.enc_num_heads

    @property
    def dec_head_dim(self) -> int:
        return self.dec_embed_dim // self.dec_num_heads

    def head(self) -> DPTConfig:
        return DPTConfig(hook_dims=(self.enc_embed_dim,) + (self.dec_embed_dim,) * 3,
                         num_channels=3 + (1 if self.predict_conf else 0),
                         head_type="regression", patch_size=self.patch_size)

    def hooks(self) -> tuple:
        return (0, self.dec_depth * 2 // 4, self.dec_depth * 3 // 4, self.dec_depth)


class CrossBlock(nn.Module):
    """CroCo's DecoderBlock: norm1 + self-attention, norm2 + cross-attention
    to the other view (keys and values through norm_y), norm3 + MLP."""

    def __init__(self, cfg: Dust3RConfig):
        super().__init__()
        d = cfg.dec_embed_dim
        self.n_heads = cfg.dec_num_heads
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = Attention(d)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.cross_attn = CrossAttention(d)
        self.norm3 = nn.LayerNorm(d, eps=1e-6)
        self.norm_y = nn.LayerNorm(d, eps=1e-6)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio))

    def forward(self, x, y, cos, sin, dtype):
        """x (B, N, C) this view, y (B, N, C) the other view's previous layer."""
        cos, sin = cos[:, None, :], sin[:, None, :]
        h = layernorm(self.norm1, x)
        q, k, v = _split_qkv(linear(self.attn.qkv, h, dtype), self.n_heads)
        a = sdpa(rope_lib.apply_rope_2d(q, cos, sin), rope_lib.apply_rope_2d(k, cos, sin), v)
        x = x + linear(self.attn.proj, a.reshape(x.shape), dtype)

        yn = layernorm(self.norm_y, y)
        hq = layernorm(self.norm2, x)
        ca = self.cross_attn
        q = linear(ca.projq, hq, dtype).unflatten(-1, (self.n_heads, -1))
        k = linear(ca.projk, yn, dtype).unflatten(-1, (self.n_heads, -1))
        v = linear(ca.projv, yn, dtype).unflatten(-1, (self.n_heads, -1))
        a = sdpa(rope_lib.apply_rope_2d(q, cos, sin), rope_lib.apply_rope_2d(k, cos, sin), v)
        x = x + linear(ca.proj, a.reshape(x.shape), dtype)
        return x + mlp(self.mlp, layernorm(self.norm3, x), dtype)


def _enc_config(cfg: Dust3RConfig) -> VicaNetConfig:
    """The encoder block's widths in VicaNet's config (plain attention)."""
    return VicaNetConfig(enc_embed_dim=cfg.enc_embed_dim, enc_num_heads=cfg.enc_num_heads,
                         mlp_ratio=cfg.mlp_ratio, enc_use_flash_attention=False)


class Dust3R(nn.Module):
    """The teacher's modules, named as the JAX package's param tree."""

    def __init__(self, cfg: Dust3RConfig):
        super().__init__()
        self.cfg = cfg
        enc = _enc_config(cfg)
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.enc_embed_dim)
        self.enc_blocks = nn.ModuleList(EncBlock(enc) for _ in range(cfg.enc_depth))
        self.enc_norm = nn.LayerNorm(cfg.enc_embed_dim, eps=1e-6)
        self.decoder_embed = nn.Linear(cfg.enc_embed_dim, cfg.dec_embed_dim)
        self.dec_blocks = nn.ModuleList(CrossBlock(cfg) for _ in range(cfg.dec_depth))
        self.dec_blocks2 = nn.ModuleList(CrossBlock(cfg) for _ in range(cfg.dec_depth))
        self.dec_norm = nn.LayerNorm(cfg.dec_embed_dim, eps=1e-6)
        self.head1 = DPT(cfg.head())
        self.head2 = DPT(cfg.head())


@torch.no_grad()
def init_dust3r(cfg: Dust3RConfig, generator: torch.Generator, device="cuda") -> Dust3R:
    """A teacher with the JAX package's init distributions drawn from
    `generator`: xavier-uniform weights (conv fans over the kernel window),
    zero biases, unit layer norms."""
    with torch.device(device):
        model = Dust3R(cfg)
    init_default_(model, generator)
    return model


def dust3r_forward(model: Dust3R, img1: torch.Tensor, img2: torch.Tensor, *,
                   dtype=torch.bfloat16) -> dict:
    """img1, img2 (B, H, W, 3) in [-1, 1] -> {"view1": {"pts3d" (B, H, W, 3),
    "conf" (B, H, W)}, "view2": ...}, both in view 1's frame, float32."""
    cfg = model.cfg
    B, H, W, _ = img1.shape
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    pos = rope_lib.grid_positions(gh, gw)
    dev = img1.device

    def encode(img):
        x = conv2d_patchify(model.patch_embed.proj, img, cfg.patch_size, dtype)
        x = x.reshape(B, gh * gw, cfg.enc_embed_dim)
        cos, sin = rope_lib.make_rope_2d_tables(pos, cfg.enc_head_dim, cfg.rope_base,
                                                device=dev)
        for blk in model.enc_blocks:
            x = blk(x, cos, sin, dtype)
        return layernorm(model.enc_norm, x)

    f1, f2 = encode(img1), encode(img2)
    cos, sin = rope_lib.make_rope_2d_tables(pos, cfg.dec_head_dim, cfg.rope_base,
                                            device=dev)
    x1 = linear(model.decoder_embed, f1, dtype)
    x2 = linear(model.decoder_embed, f2, dtype)
    inter1, inter2 = [], []
    for b1, b2 in zip(model.dec_blocks, model.dec_blocks2):
        x1, x2 = b1(x1, x2, cos, sin, dtype), b2(x2, x1, cos, sin, dtype)
        inter1.append(x1)
        inter2.append(x2)

    def run_head(head, f_enc, inter):
        toks = ([f_enc] + [inter[h - 1] for h in cfg.hooks()[1:-1]]
                + [layernorm(model.dec_norm, inter[-1])])
        out = dpt_regression_head(head, toks, (gh, gw), dtype)
        res = {"pts3d": postprocess_pts3d_exp(out[..., :3])}
        if cfg.predict_conf:
            res["conf"] = postprocess_conf_exp(out[..., 3])
        return res

    return {"view1": run_head(model.head1, f1, inter1),
            "view2": run_head(model.head2, f2, inter2)}


def make_teacher_fn(model: Dust3R, dtype=torch.bfloat16):
    """Freeze `model` (eval mode, no gradient) and return
    teacher_fn(img1, img2) -> dust3r_forward's outputs, computed without
    autograd."""
    model.eval().requires_grad_(False)

    def teacher_fn(img1, img2):
        with torch.no_grad():
            return dust3r_forward(model, img1, img2, dtype=dtype)

    teacher_fn.model = model
    return teacher_fn
