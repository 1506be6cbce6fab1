"""PyTorch checkpoints of the reference's layout -> this port's state_dicts
(port of vicasplat_tpu/utils/ckpt_convert.py).

Reads the reference's released Lightning checkpoints ({"state_dict": ...}
with `encoder.`-prefixed keys), raw VicaSplat state dicts, and DUSt3R /
MASt3R checkpoints ({"model": ...}). The port keeps PyTorch's layouts
(Linear (out, in), Conv2d OIHW, ConvTranspose2d IOHW), so a conversion only
renames keys: `backbone.enc_blocks.3.attn.qkv.weight` stays itself, the
DPT's `act_postprocess.0.1` becomes `up0`, `scratch.refinenet1.
resConfUnit2.conv1` becomes `refinenet1.rcu2.conv1`, `head.4` becomes
`head.conv3`, and so on (the JAX package's tree names, which the port's
modules carry). Keys the model does not know are left out, as in JAX.

Every function takes {key: numpy array or tensor} and returns {key: float32
tensor}; the two exports return the reference's layouts.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch


def _t(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(v, np.float32))


def _param(sd, src: str, dst: str, out: dict) -> None:
    """weight and (when present) bias of a linear, conv or layer norm."""
    out[dst + ".weight"] = _t(sd[src + ".weight"])
    if src + ".bias" in sd:
        out[dst + ".bias"] = _t(sd[src + ".bias"])


def _mlp(sd, src, dst, out):
    _param(sd, src + ".fc1", dst + ".fc1", out)
    _param(sd, src + ".fc2", dst + ".fc2", out)


def _enc_block(sd, src, dst, out):
    for name in ("norm1", "attn.qkv", "attn.proj", "norm2"):
        _param(sd, f"{src}.{name}", f"{dst}.{name}", out)
    _mlp(sd, src + ".mlp", dst + ".mlp", out)


def _dec_block(sd, src, dst, out):
    """A VicaNet mix-decoder block; modulations and cross-neighbour
    attention when the checkpoint has them."""
    for name in ("cam_norm1", "norm1", "attn.qkv", "attn.proj", "cam_norm2", "norm3"):
        _param(sd, f"{src}.{name}", f"{dst}.{name}", out)
    _mlp(sd, src + ".mlp", dst + ".mlp", out)
    _mlp(sd, src + ".mlp_cam", dst + ".mlp_cam", out)
    if src + ".modulation1.proj.weight" in sd:
        _param(sd, src + ".modulation1.proj", dst + ".modulation1.proj", out)
        _param(sd, src + ".modulation2.proj", dst + ".modulation2.proj", out)
    if src + ".cross_attn.projq.weight" in sd:
        _param(sd, src + ".norm2", dst + ".norm2", out)
        for name in ("projq", "projk", "projv", "proj"):
            _param(sd, f"{src}.cross_attn.{name}", f"{dst}.cross_attn.{name}", out)


def _cross_block(sd, src, dst, out):
    """A CroCo decoder block of the DUSt3R teacher."""
    for name in ("norm1", "attn.qkv", "attn.proj", "norm2", "cross_attn.projq",
                 "cross_attn.projk", "cross_attn.projv", "cross_attn.proj", "norm3",
                 "norm_y"):
        _param(sd, f"{src}.{name}", f"{dst}.{name}", out)
    _mlp(sd, src + ".mlp", dst + ".mlp", out)


# the DPT's reference names -> the port's, and the heads' output convs
_DPT_TRUNK = {"act_postprocess.0.0": "proj0", "act_postprocess.0.1": "up0",
              "act_postprocess.1.0": "proj1", "act_postprocess.1.1": "up1",
              "act_postprocess.2.0": "proj2", "act_postprocess.3.0": "proj3",
              "act_postprocess.3.1": "down3",
              **{f"scratch.layer{i + 1}_rn": f"scratch{i}" for i in range(4)},
              **{f"scratch.refinenet{i}.{a}": f"refinenet{i}.{b}"
                 for i in range(1, 5)
                 for a, b in (("resConfUnit1.conv1", "rcu1.conv1"),
                              ("resConfUnit1.conv2", "rcu1.conv2"),
                              ("resConfUnit2.conv1", "rcu2.conv1"),
                              ("resConfUnit2.conv2", "rcu2.conv2"),
                              ("out_conv", "out_conv"))}}
_DPT_HEAD = {"regression": {"head.0": "head.conv1", "head.2": "head.conv2",
                            "head.4": "head.conv3"},
             "gs_params": {"head.0": "head.conv1", "head.4": "head.conv2"}}


def _dpt(sd, src, dst, head_type, out):
    """src points at '<head>.dpt'."""
    for a, b in {**_DPT_TRUNK, **_DPT_HEAD[head_type]}.items():
        _param(sd, f"{src}.{a}", f"{dst}.{b}", out)
    if src + ".input_merger.0.weight" in sd:
        _param(sd, src + ".input_merger.0", dst + ".input_merger.conv", out)


def _depth(sd, pattern: str) -> int:
    return 1 + max(int(m.group(1)) for k in sd if (m := re.match(pattern, k)))


def resample_patch_embed(kernel: torch.Tensor, new_hw: tuple) -> torch.Tensor:
    """FlexiViT's resampling of a patch-embedding kernel (O, I, kh, kw) to
    (O, I, *new_hw): the resize operator B is built column by column (the
    bicubic, antialiased resize of each basis patch), and pinv(B^T) applied,
    so that the resampled kernel on a resized image approximates the
    original kernel on the original image."""
    o, c, kh, kw = kernel.shape
    nh, nw = new_hw
    if (kh, kw) == (nh, nw):
        return kernel

    def resize(x):
        t = torch.from_numpy(np.asarray(x, np.float32))[None, None]
        return torch.nn.functional.interpolate(t, size=(nh, nw), mode="bicubic",
                                               antialias=True)[0, 0].numpy()

    basis = np.eye(kh * kw, dtype=np.float32)
    B = np.stack([resize(b.reshape(kh, kw)).reshape(-1) for b in basis], axis=1)
    P = np.linalg.pinv(B.T)  # (nh * nw, kh * kw)
    flat = kernel.detach().cpu().numpy().transpose(2, 3, 1, 0).reshape(kh * kw, c * o)
    out = (P @ flat).reshape(nh, nw, c, o).astype(np.float32).transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(out)).to(kernel.dtype)


def convert_state_dict(sd: Dict, patch_size: Optional[int] = None) -> dict:
    """A reference VicaSplat state dict (`encoder.`-prefixed or not) -> the
    port's VicaSplat state_dict. With `patch_size` different from the
    checkpoint's, the patch-embedding kernel is FlexiViT-resampled."""
    if any(k.startswith("encoder.") for k in sd):
        sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    n_enc = _depth(sd, r"backbone\.enc_blocks\.(\d+)\.")
    n_dec = _depth(sd, r"backbone\.dec_blocks\.(\d+)\.")
    out = {}
    _param(sd, "backbone.patch_embed.proj", "backbone.patch_embed.proj", out)
    if patch_size is not None:
        out["backbone.patch_embed.proj.weight"] = resample_patch_embed(
            out["backbone.patch_embed.proj.weight"], (patch_size, patch_size))
    for i in range(n_enc):
        _enc_block(sd, f"backbone.enc_blocks.{i}", f"backbone.enc_blocks.{i}", out)
    for name in ("enc_norm", "decoder_embed", "dec_norm", "camera_dec_norm"):
        _param(sd, f"backbone.{name}", f"backbone.{name}", out)
    for name in ("camera_extrinsic_token", "camera_intrinsic_token"):
        out[f"backbone.{name}"] = _t(sd[f"backbone.{name}"])
    for i in range(n_dec):
        _dec_block(sd, f"backbone.dec_blocks.{i}", f"backbone.dec_blocks.{i}", out)
    _dpt(sd, "downstream_head1.dpt", "center_head", "regression", out)
    _dpt(sd, "gaussian_param_head.dpt", "gaussian_param_head", "gs_params", out)
    _param(sd, "camera_extrinsic_head.1", "camera_extrinsic_head.proj", out)
    if "backbone.intrinsic_encoder.weight" in sd:
        _param(sd, "backbone.intrinsic_encoder", "backbone.intrinsic_encoder", out)
    if "camera_intrinsic_head.1.weight" in sd:
        _param(sd, "camera_intrinsic_head.1", "camera_intrinsic_head.proj", out)
    return out


def convert_dust3r_state_dict(sd: Dict) -> dict:
    """A DUSt3R / MASt3R state dict -> the port's `Dust3R` state_dict; a
    checkpoint without `dec_blocks2` has `dec_blocks` copied into it."""
    if not any(k.startswith("dec_blocks2") for k in sd):
        sd = dict(sd, **{k.replace("dec_blocks.", "dec_blocks2.", 1): v
                         for k, v in sd.items() if k.startswith("dec_blocks.")})
    n_enc = _depth(sd, r"enc_blocks\.(\d+)\.")
    n_dec = _depth(sd, r"dec_blocks\.(\d+)\.")
    out = {}
    _param(sd, "patch_embed.proj", "patch_embed.proj", out)
    for i in range(n_enc):
        _enc_block(sd, f"enc_blocks.{i}", f"enc_blocks.{i}", out)
    for name in ("enc_norm", "decoder_embed", "dec_norm"):
        _param(sd, name, name, out)
    for dec in ("dec_blocks", "dec_blocks2"):
        for i in range(n_dec):
            _cross_block(sd, f"{dec}.{i}", f"{dec}.{i}", out)
    _dpt(sd, "downstream_head1.dpt", "head1", "regression", out)
    _dpt(sd, "downstream_head2.dpt", "head2", "regression", out)
    return out


def export_dust3r_state_dict(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's `Dust3R` state_dict -> a DUSt3R / MASt3R checkpoint's
    layout (the inverse of `convert_dust3r_state_dict`): the trunk's keys
    as they are, the heads under `downstream_head{1,2}.dpt` by the
    reference's names."""
    inv = {b: a for a, b in {**_DPT_TRUNK, **_DPT_HEAD["regression"]}.items()}
    sd = {}
    for k, v in state.items():
        if k.startswith(("head1.", "head2.")):
            head, rest = k.split(".", 1)
            mod, leaf = rest.rsplit(".", 1)
            k = f"downstream_head{head[-1]}.dpt.{inv[mod]}.{leaf}"
        sd[k] = v.detach().cpu().clone()
    return sd


def read_torch_checkpoint(path) -> Dict[str, torch.Tensor]:
    """The tensors of a checkpoint file: its `state_dict` (Lightning), its
    `model` (DUSt3R / MASt3R) or the file's own dict. The file is trusted:
    Lightning checkpoints pickle more than tensors."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_torch_checkpoint(path) -> dict:
    """A checkpoint file -> the port's state_dict: a two-view decoder's keys
    (`dec_blocks.`, `downstream_head2.`) without `backbone.` or `encoder.`
    go to `convert_dust3r_state_dict` (the teacher), anything else to
    `convert_state_dict`."""
    sd = read_torch_checkpoint(path)
    is_dust3r = (any(k.startswith(("dec_blocks.", "downstream_head2.")) for k in sd)
                 and not any(k.startswith(("backbone.", "encoder.")) for k in sd))
    return convert_dust3r_state_dict(sd) if is_dust3r else convert_state_dict(sd)


def export_torch_state_dict(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's VicaSplat state_dict -> the reference's Lightning layout
    (`encoder.`-prefixed), with the DPT's `scratch.layer_rn.<i>` aliases the
    released checkpoints also carry."""
    sd = {}

    def put(dst, src):
        for suffix in (".weight", ".bias"):
            if src + suffix in state:
                sd["encoder." + dst + suffix] = state[src + suffix].detach().cpu().clone()

    put("backbone.patch_embed.proj", "backbone.patch_embed.proj")
    for name in ("intrinsic_encoder", "enc_norm", "decoder_embed", "dec_norm",
                 "camera_dec_norm"):
        put(f"backbone.{name}", f"backbone.{name}")
    for name in ("camera_extrinsic_token", "camera_intrinsic_token"):
        sd[f"encoder.backbone.{name}"] = state[f"backbone.{name}"].detach().cpu().clone()
    blocks = {}
    for k in state:
        if m := re.match(r"(backbone\.(?:enc|dec)_blocks\.\d+)\.(.+)\.(weight|bias)$", k):
            blocks.setdefault(m.group(1), set()).add(m.group(2))
    for blk, names in blocks.items():
        for name in names:
            put(f"{blk}.{name}", f"{blk}.{name}")

    def put_dpt(dst, src, head_type):
        for a, b in {**_DPT_TRUNK, **_DPT_HEAD[head_type]}.items():
            put(f"{dst}.{a}", f"{src}.{b}")
        for i in range(4):
            put(f"{dst}.scratch.layer_rn.{i}", f"{src}.scratch{i}")
        put(f"{dst}.input_merger.0", f"{src}.input_merger.conv")

    put_dpt("downstream_head1.dpt", "center_head", "regression")
    put_dpt("gaussian_param_head.dpt", "gaussian_param_head", "gs_params")
    put("camera_extrinsic_head.1", "camera_extrinsic_head.proj")
    put("camera_intrinsic_head.1", "camera_intrinsic_head.proj")
    return sd


def mast3r_to_vicasplat_params(sd: Dict, state: Dict[str, torch.Tensor],
                               drop_conf: bool = True) -> dict:
    """Overlay a MASt3R / DUSt3R state dict on the port's VicaSplat
    state_dict `state` (a new dict; `state` is not changed): the encoder,
    the first decoder's self- and cross-attention, norms and MLPs on the
    student's decoder blocks, and the first head on the centre head, whose
    confidence channel is sliced off when the student has one channel
    fewer. VicaNet's own parameters (camera tokens, modulations, mlp_cam,
    the Gaussian-parameter head) keep their values."""
    out = {k: v.detach().clone() for k, v in state.items()}
    _param(sd, "patch_embed.proj", "backbone.patch_embed.proj", out)
    for name in ("enc_norm", "decoder_embed", "dec_norm"):
        _param(sd, name, f"backbone.{name}", out)
    n_enc = _depth(state, r"backbone\.enc_blocks\.(\d+)\.")
    for i in range(n_enc):
        _enc_block(sd, f"enc_blocks.{i}", f"backbone.enc_blocks.{i}", out)
    n_dec = _depth(state, r"backbone\.dec_blocks\.(\d+)\.")
    cross = "backbone.dec_blocks.0.cross_attn.projq.weight" in state
    for i in range(n_dec):
        names = ["norm1", "norm2", "norm3", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"]
        if cross:
            names += [f"cross_attn.{n}" for n in ("projq", "projk", "projv", "proj")]
        for name in names:
            if f"backbone.dec_blocks.{i}.{name}.weight" not in out:
                raise KeyError(f"backbone.dec_blocks.{i}.{name}")
            _param(sd, f"dec_blocks.{i}.{name}", f"backbone.dec_blocks.{i}.{name}", out)
    head = {}
    _dpt(sd, "downstream_head1.dpt", "center_head", "regression", head)
    tgt_out = state["center_head.head.conv3.bias"].shape[0]
    src_out = head["center_head.head.conv3.bias"].shape[0]
    if drop_conf and src_out == tgt_out + 1:
        head["center_head.head.conv3.weight"] = head["center_head.head.conv3.weight"][:tgt_out]
        head["center_head.head.conv3.bias"] = head["center_head.head.conv3.bias"][:tgt_out]
    out = {k: v for k, v in out.items() if not k.startswith("center_head.")}
    out.update(head)
    return out
