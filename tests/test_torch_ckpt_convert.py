"""The port's checkpoint converter (vicasplat_tpu_torch/utils/ckpt_convert.py)
against the JAX package's on the CPU, on state dicts in the reference's key
layout that the tests build (no released checkpoint is in the repository):
each converted tree through the weight bridge, key for key and bit for bit;
FlexiViT's patch-embedding resampling; the export and its round trip;
DUSt3R / MASt3R checkpoints and the overlay on a student; `.ckpt` files
written here and read back through `checkpointing.load_weights`. The train
mode taking its teacher from a converted checkpoint is in
tests/test_torch_distill_train.py."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_distill import TEACHER, teacher_params
from test_torch_training import numpy_params, to_port_config
from test_training import tiny_train_cfg

from vicasplat_tpu.models import dust3r as jd
from vicasplat_tpu.utils import ckpt_convert as jcc
from vicasplat_tpu_torch.models import dust3r as td
from vicasplat_tpu_torch.models.vicasplat import VicaSplat, VicaSplatConfig
from vicasplat_tpu_torch.training import AdamW
from vicasplat_tpu_torch.utils import checkpointing as tck
from vicasplat_tpu_torch.utils import ckpt_convert as tcc
from vicasplat_tpu_torch.utils import weights

torch.set_num_threads(1)

# the student's variants: the tiny training config (intrinsic token,
# modulations, cross-neighbour attention), and one with the intrinsic head
# and neither optional block
VARIANTS = {
    "default": {},
    "plain": dict(use_intrinsic_embedding=False, use_framewise_modulation=False,
                  use_cross_neighbor_attention=False),
}


@functools.lru_cache(maxsize=None)
def _student(variant="default"):
    """(JAX params drawn by numpy, the port's config) of the tiny student;
    callers do not change them."""
    jcfg = tiny_train_cfg().model
    jcfg = dataclasses.replace(jcfg, backbone=dataclasses.replace(jcfg.backbone,
                                                                  **VARIANTS[variant]))
    return numpy_params(jcfg), to_port_config(VicaSplatConfig, dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_sd(params, prefix=True):
    """The reference's Lightning layout of a student, by the JAX package's
    export; with `prefix=False` the raw module's keys."""
    sd = jcc.export_torch_state_dict(params)
    return sd if prefix else {k[len("encoder."):]: v for k, v in sd.items()}


def _dust3r_reference_sd(p, with_dec2=True):
    """A DUSt3R / MASt3R checkpoint's layout of the JAX teacher tree `p`:
    torch Linear (out, in), Conv2d OIHW, blocks by index, the heads as
    downstream_head{1,2}.dpt (their DPT names by the JAX package's export
    of a student carrying the head)."""
    p = _np(p)
    sd = {}

    def put(prefix, q):
        w = q["w"] if "w" in q else q["scale"]
        sd[prefix + ".weight"] = w.T if w.ndim == 2 and "w" in q else (
            w.transpose(3, 2, 0, 1) if w.ndim == 4 else w)
        if "b" in q or "bias" in q:
            sd[prefix + ".bias"] = q.get("b", q.get("bias"))

    def walk(prefix, node):
        if "w" in node or "scale" in node:
            put(prefix, node)
            return
        for k, v in node.items():
            walk(f"{prefix}.{k}", v)

    put("patch_embed.proj", p["patch_embed"]["proj"])
    for name in ("enc_norm", "decoder_embed", "dec_norm"):
        put(name, p[name])
    for stack in ("enc_blocks", "dec_blocks", "dec_blocks2"):
        if stack == "dec_blocks2" and not with_dec2:
            continue
        depth = p[stack]["norm1"]["scale"].shape[0]
        for i in range(depth):
            walk(f"{stack}.{i}", jax.tree.map(lambda a: a[i], p[stack]))
    student, _ = _student()
    for h in ("1", "2"):
        exp = jcc.export_torch_state_dict(dict(student, center_head=p["head" + h]))
        pre = "encoder.downstream_head1.dpt."
        sd.update({f"downstream_head{h}.dpt." + k[len(pre):]: v for k, v in exp.items()
                   if k.startswith(pre)})
    return sd


def _assert_state_equal(got, want_tree):
    want = weights.state_dict_from_jax(want_tree)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), v.float().numpy(), err_msg=k)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("prefix", [True, False])
def test_convert_state_dict_matches_jax(variant, prefix):
    """A reference state dict, with and without Lightning's `encoder.`
    prefix and with the layer_rn aliases, converts to JAX's tree key for
    key and bit for bit, and loads strictly into the port's model."""
    params, tcfg = _student(variant)
    sd = _reference_sd(params, prefix)
    got = tcc.convert_state_dict(sd)
    _assert_state_equal(got, jcc.convert_state_dict(sd))
    VicaSplat(tcfg).load_state_dict(got, strict=True)


@pytest.mark.parametrize("size", [8, 14, 16, 24])
def test_resample_patch_embed_matches_jax(size):
    """FlexiViT's pseudo-inverse resampling of a 16 x 16 kernel, in the
    port's OIHW layout against JAX's HWIO (both resize the basis with
    torch's antialiased bicubic and take numpy's pinv: equal to float32
    rounding, held at 1e-5 of the largest entry); and through
    convert_state_dict(patch_size=...)."""
    rng = np.random.default_rng(size)
    k = rng.normal(size=(16, 16, 3, 5)).astype(np.float32)
    want = jcc.resample_patch_embed(k, (size, size)).transpose(3, 2, 0, 1)
    got = tcc.resample_patch_embed(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                                   (size, size))
    assert got.shape == (5, 3, size, size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    params, _ = _student()
    sd = _reference_sd(params)
    key = "backbone.patch_embed.proj.weight"
    want = weights.state_dict_from_jax(jcc.convert_state_dict(sd, patch_size=size))[key]
    np.testing.assert_allclose(tcc.convert_state_dict(sd, patch_size=size)[key].numpy(),
                               want.numpy(), rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_export_matches_jax_and_round_trips(variant):
    """export_torch_state_dict of the port's state equals JAX's export of
    the same params (the aliases included), and converts back to itself."""
    params, _ = _student(variant)
    state = weights.state_dict_from_jax(params)
    got = tcc.export_torch_state_dict(state)
    want = jcc.export_torch_state_dict(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    back = tcc.convert_state_dict(got)
    assert sorted(back) == sorted(state)
    assert all(torch.equal(back[k], state[k]) for k in state)


@pytest.fixture(scope="module")
def dust3r():
    """(JAX teacher params, its DUSt3R-layout state dict)."""
    params = teacher_params(jd.Dust3RConfig(**TEACHER), seed=3)
    return params, _dust3r_reference_sd(params)


@pytest.mark.parametrize("with_dec2", [True, False])
def test_convert_dust3r_matches_jax(dust3r, with_dec2):
    """A DUSt3R checkpoint (MASt3R's two decoders, or one decoder copied
    into dec_blocks2) converts to JAX's teacher tree and loads strictly;
    the port's export gives the checkpoint's keys back."""
    params, _ = dust3r
    sd = _dust3r_reference_sd(params, with_dec2)
    got = tcc.convert_dust3r_state_dict(sd)
    _assert_state_equal(got, jcc.convert_dust3r_state_dict(sd))
    if not with_dec2:
        assert all(torch.equal(got[k], got[k.replace("dec_blocks.", "dec_blocks2.", 1)])
                   for k in got if k.startswith("dec_blocks."))
    td.Dust3R(td.Dust3RConfig(**TEACHER)).load_state_dict(got, strict=True)
    # the port's export back to the checkpoint's layout (no alias keys),
    # and its conversion back to the same state
    back = tcc.export_dust3r_state_dict(got)
    want = {k: v for k, v in sd.items() if ".layer_rn." not in k
            and (with_dec2 or not k.startswith("dec_blocks2."))}
    if not with_dec2:
        want.update({k: back[k] for k in back if k.startswith("dec_blocks2.")})
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    again = tcc.convert_dust3r_state_dict(back)
    assert all(torch.equal(again[k], got[k]) for k in got)


@functools.lru_cache(maxsize=None)
def _student_conf(conf: bool):
    jcfg = tiny_train_cfg().model
    jcfg = dataclasses.replace(jcfg, predict_conf=conf)
    return numpy_params(jcfg), to_port_config(VicaSplatConfig, dataclasses.asdict(jcfg))


@pytest.mark.parametrize("conf", [False, True])
def test_mast3r_overlay_matches_jax(dust3r, conf):
    """The teacher's trunk, first decoder and first head on the student
    (widths shared), against JAX's overlay through the bridge, key for key:
    a 3-channel centre head has the confidence channel sliced off, a
    4-channel one keeps it; VicaNet's own parameters keep their values."""
    _, sd = dust3r
    params, tcfg = _student_conf(conf)
    state = weights.state_dict_from_jax(params)
    got = tcc.mast3r_to_vicasplat_params(sd, state)
    _assert_state_equal(got, jcc.mast3r_to_vicasplat_params(sd, params))
    assert got["center_head.head.conv3.weight"].shape[0] == (4 if conf else 3)
    for k in ("backbone.camera_extrinsic_token", "backbone.dec_blocks.1.mlp_cam.fc1.weight",
              "gaussian_param_head.head.conv2.weight"):
        assert torch.equal(got[k], state[k]), k
    assert not torch.equal(got["backbone.enc_blocks.0.attn.qkv.weight"],
                           state["backbone.enc_blocks.0.attn.qkv.weight"])
    VicaSplat(tcfg).load_state_dict(got, strict=True)


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


@pytest.mark.parametrize("fmt", ["lightning", "raw", "dust3r"])
def test_ckpt_files_load_as_jax_reads_them(tmp_path, dust3r, fmt):
    """`.ckpt` files written here ({"state_dict"} with Lightning's extras,
    a raw state dict, a DUSt3R {"model"}) through load_torch_checkpoint,
    against JAX's reading of the same file; the students' through
    `checkpointing.load_weights` into a model (strict), which also treats
    them as weights only."""
    params, tcfg = _student()
    path = tmp_path / f"{fmt}.ckpt"
    if fmt == "lightning":
        torch.save({"state_dict": _tensors(_reference_sd(params)), "epoch": 3,
                    "hyper_parameters": {"lr": 1e-4}}, path)
    elif fmt == "raw":
        torch.save(_tensors(_reference_sd(params, prefix=False)), path)
    else:
        torch.save({"model": _tensors(dust3r[1]), "args": "croco"}, path)
    got = tcc.load_torch_checkpoint(path)
    _assert_state_equal(got, jcc.load_torch_checkpoint(str(path)))
    if fmt == "dust3r":
        assert "head2.head.conv3.weight" in got
        return
    model = VicaSplat(tcfg)
    assert tck.load_weights(path, model) == {}
    _assert_state_equal(model.state_dict(), params)
    assert not tck.is_full_state(path) and not tck.load_ema(path, model)
    assert tck.restore_train_state(path, model, AdamW(model, tiny_train_cfg().optimizer)) == 0
