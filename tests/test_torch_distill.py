"""The port's distillation slice against the JAX package on the CPU, in
float32 at toy size: the DUSt3R teacher, Regr3D, the point-map helpers and
the ray embedding, the distill forward with view-space depth, the
teacher's loss term at T = 2 and T = 4, and the teacher of the train mode
when its checkpoint is missing. Two train steps through "distill_only" and
"distill" are in tests/test_torch_distill_step.py; the train mode with a
converted teacher checkpoint in tests/test_torch_ckpt_convert.py.

Inputs and parameters are drawn by numpy from a seed, in the shapes of the
JAX package's init (`jax.eval_shape`; JAX's threefry takes 16 s for the
teacher's 38 M parameters, most of them in its two DPT heads), and carried
across by the weight bridge."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import _torch_batch, numpy_params, to_port_config
from test_training import tiny_batch, tiny_train_cfg

from vicasplat_tpu.geometry import camera_emb as jemb
from vicasplat_tpu.geometry import ptc as jptc
from vicasplat_tpu.loss import conf_point as jcp
from vicasplat_tpu.models import dust3r as jd
from vicasplat_tpu.models import vicasplat as jvs
from vicasplat_tpu.training import step as jstep
from vicasplat_tpu_torch import main as tmain
from vicasplat_tpu_torch.geometry import camera_emb as temb
from vicasplat_tpu_torch.geometry import ptc as tptc
from vicasplat_tpu_torch.loss import conf_point as tcp
from vicasplat_tpu_torch.models import dust3r as td
from vicasplat_tpu_torch.models.vicasplat import VicaSplat, vicasplat_forward
from vicasplat_tpu_torch.training import TrainConfig
from vicasplat_tpu_torch.training import step as tstep
from vicasplat_tpu_torch.utils import weights

torch.set_num_threads(1)

# the JAX package's own toy teacher (tests/test_distill.py): 32^2 frames,
# encoder 64 x 2, decoders 48 x 4, the DPT heads at their fixed widths
TEACHER = dict(img_size=32, patch_size=16, enc_embed_dim=64, enc_depth=2, enc_num_heads=4,
               dec_embed_dim=48, dec_depth=4, dec_num_heads=4)
# float32 on both sides through a ViT, two cross-attention decoders and a
# DPT head ending in an exp map: each op summed in another order by XLA and
# torch; the points and confidences agree within 1e-5 of their largest
# entry (measured gaps about 3e-6), held at 1e-4
TEACHER_TOL = 1e-4
# elementwise float32 arithmetic and one quantile: 1e-6 relative
ELEM_TOL = 1e-6
# Regr3D's terms conf |dp|^2 - alpha log(conf) are O(1) and of both signs,
# and their float32 mean is summed in another order: 1e-5 absolute beside
# 1e-6 relative (measured gaps under 1e-6)
LOSS_ATOL = 1e-5


def numpy_tree(shapes, seed: int):
    """Arrays for a tree of JAX shapes, drawn by numpy: xavier-normal
    kernels (a conv's fans over its window), unit-ish layer-norm scales,
    small biases."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "w":
            window = int(np.prod(shape[:-2])) if len(shape) == 4 else 1
            a = rng.normal(0, np.sqrt(2.0 / (window * (shape[-2] + shape[-1]))), shape)
        elif name == "scale":
            a = 1.0 + rng.normal(0, 0.05, shape)
        else:
            a = rng.normal(0, 0.02, shape)
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def teacher_params(cfg: jd.Dust3RConfig, seed: int = 0):
    return numpy_tree(jax.eval_shape(lambda k: jd.init_dust3r(k, cfg),
                                     jax.random.PRNGKey(0)), seed)


@pytest.fixture(scope="module")
def teacher():
    """(JAX params, the JAX teacher jitted in float32, the port's
    teacher_fn in float32)."""
    jcfg = jd.Dust3RConfig(**TEACHER)
    params = teacher_params(jcfg)
    model = weights.load_jax_params(td.Dust3R(td.Dust3RConfig(**TEACHER)), params)
    fwd = jax.jit(lambda a, b: jd.dust3r_forward(params, jcfg, a, b, dtype=jnp.float32))
    return params, fwd, td.make_teacher_fn(model, torch.float32)


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max() + 1e-12, err_msg=what)


def test_teacher_matches_jax(teacher):
    """dust3r_forward on a non-square pair: both views' points and
    confidences; the port's random init has JAX's names and shapes."""
    params, jax_fwd, teacher_fn = teacher
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32) for _ in range(2))
    want = jax_fwd(jnp.asarray(a), jnp.asarray(b))
    got = teacher_fn(torch.from_numpy(a), torch.from_numpy(b))
    assert not teacher_fn.model.training
    assert not any(p.requires_grad for p in teacher_fn.model.parameters())
    for view in ("view1", "view2"):
        assert got[view]["pts3d"].shape == (2, 32, 48, 3)
        assert (got[view]["conf"] >= 1).all()
        for k in ("pts3d", "conf"):
            _close(got[view][k].numpy(), want[view][k], TEACHER_TOL, f"{view} {k}")
    init = td.init_dust3r(td.Dust3RConfig(**TEACHER), torch.Generator().manual_seed(1), "cpu")
    shapes = {k: tuple(v.shape) for k, v in weights.state_dict_from_jax(params).items()}
    assert {k: tuple(v.shape) for k, v in init.state_dict().items()} == shapes


@pytest.mark.parametrize("normalize,match", [(False, True), (True, True), (False, False)])
def test_regr3d_matches_jax(normalize, match):
    """regr3d_loss with the 1 % / 99 % quantile mask (outliers planted on
    both tails), with and without normalization and the confidence match."""
    rng = np.random.default_rng(1)
    shape = (3, 2, 8, 12)
    teacher_pts = rng.normal(size=shape + (3,)).astype(np.float32)
    teacher_pts[0, 0, 0, :3] *= 1e3
    teacher_pts[1, 1, 2, :2] *= 1e-3
    pred = (teacher_pts + 0.3 * rng.normal(size=teacher_pts.shape)).astype(np.float32)
    pred_conf = (1 + rng.exponential(size=shape)).astype(np.float32)
    teacher_conf = (1 + rng.exponential(size=shape)).astype(np.float32)
    jcfg = jcp.Regr3DConfig(normalize_pointcloud=normalize, match_confidence=match)
    jloss, jlogs = jcp.regr3d_loss(*map(jnp.asarray, (pred, pred_conf, teacher_pts,
                                                      teacher_conf)), jcfg)
    tloss, tlogs = tcp.regr3d_loss(*map(torch.from_numpy, (pred, pred_conf, teacher_pts,
                                                           teacher_conf)),
                                   tcp.Regr3DConfig(**dataclasses.asdict(jcfg)))
    assert set(tlogs) == set(jlogs)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=ELEM_TOL, atol=LOSS_ATOL)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), rtol=ELEM_TOL,
                                   atol=LOSS_ATOL, err_msg=k)
    valid = rng.random(shape) > 0.3
    j, js = jcp.normalize_pointcloud(jnp.asarray(pred), jnp.asarray(valid, jnp.float32))
    t, ts = tcp.normalize_pointcloud(torch.from_numpy(pred), torch.from_numpy(valid).float())
    _close(t.numpy(), j, ELEM_TOL)
    _close(ts.numpy(), js, ELEM_TOL)


def test_ptc_and_camera_emb_match_jax():
    """geotrf (4x4 and 3x4, ncol), depth <-> points, the point-cloud
    normalization with and without a mask, and the SH ray embedding."""
    rng = np.random.default_rng(2)
    T = rng.normal(size=(2, 3, 4, 4)).astype(np.float32)
    pts = rng.normal(size=(2, 3, 5, 7, 3)).astype(np.float32)
    Tb = T[:, :, None, None]
    for tr, ncol in ((Tb, None), (Tb[..., :3, :], None), (Tb, 2)):
        _close(tptc.geotrf(torch.from_numpy(np.ascontiguousarray(tr)), torch.from_numpy(pts),
                           ncol).numpy(),
               jptc.geotrf(jnp.asarray(tr), jnp.asarray(pts), ncol), ELEM_TOL)
    K = np.tile(np.array([[1.1, 0, 0.45], [0, 0.9, 0.55], [0, 0, 1]], np.float32), (2, 1, 1))
    depth = rng.uniform(0.5, 3, (2, 6, 9)).astype(np.float32)
    got = tptc.depth_to_pts3d(torch.from_numpy(depth), torch.from_numpy(K))
    _close(got.numpy(), jptc.depth_to_pts3d(jnp.asarray(depth), jnp.asarray(K)), ELEM_TOL)
    np.testing.assert_allclose(tptc.pts3d_to_depth(got).numpy(), depth, rtol=1e-5)
    valid = (rng.random(pts.shape[:-1]) > 0.5).astype(np.float32)
    for v in (None, valid):
        t, ts = tptc.normalize_pointcloud(torch.from_numpy(pts),
                                          None if v is None else torch.from_numpy(v))
        j, js = jptc.normalize_pointcloud(jnp.asarray(pts), None if v is None else jnp.asarray(v))
        _close(t.numpy(), j, ELEM_TOL)
        np.testing.assert_allclose(float(ts), float(js), rtol=ELEM_TOL)
    for merge in (False, True):
        _close(temb.get_intrinsic_embedding(torch.from_numpy(K), (6, 9), 4, merge).numpy(),
               jemb.get_intrinsic_embedding(jnp.asarray(K), (6, 9), 4, merge), ELEM_TOL)


def _student(B=1, T=2):
    """The JAX package's tiny training config with a confidence channel,
    its numpy-drawn params, a batch and the port's model on the same
    weights."""
    jcfg = tiny_train_cfg()
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, predict_conf=True),
                               distill_only_steps=1, distill_max_steps=1)
    params = numpy_params(jcfg.model)
    batch = jax.tree.map(lambda x: np.asarray(x, np.float32),
                         tiny_batch(jax.random.PRNGKey(1), B=B, T=T))
    rng = np.random.default_rng(3)
    ext = np.tile(np.eye(4, dtype=np.float32), (B, T, 1, 1))
    ext[..., :3, 3] = rng.normal(0, 0.3, (B, T, 3))
    th = rng.uniform(-0.3, 0.3, (B, T))  # a turn about z: every term shows
    ext[..., 0, 0], ext[..., 0, 1] = np.cos(th), -np.sin(th)
    ext[..., 1, 0], ext[..., 1, 1] = np.sin(th), np.cos(th)
    batch["context"]["extrinsics"] = ext
    tcfg = to_port_config(TrainConfig, dataclasses.asdict(jcfg))
    model = weights.load_jax_params(VicaSplat(tcfg.model), params)
    return jcfg, tcfg, params, batch, model


def test_distill_forward_matches_jax():
    """vicasplat_forward(distill=True, compute_viewspace_depth=True): the
    early return's keys (JAX's, by tracing) and values, the view-space depth
    R^-1 (p - t); the full forward carries the same values and depth."""
    jcfg, tcfg, params, batch, model = _student()
    ctx = dict(batch["context"], image=batch["context"]["image"] * 2 - 1)
    jctx = jax.tree.map(jnp.asarray, ctx)
    want = jax.jit(lambda p, c: jvs.vicasplat_forward(
        p, jcfg.model, c, 0, dtype=jnp.float32, compute_viewspace_depth=True))(params, jctx)
    early = jax.eval_shape(lambda p, c: jvs.vicasplat_forward(
        p, jcfg.model, c, 0, dtype=jnp.float32, distill=True,
        compute_viewspace_depth=True), params, jctx)
    for distill, keys in ((True, set(early)), (False, set(want))):
        got = vicasplat_forward(model, _torch_batch(ctx), 0, dtype=torch.float32,
                                distill=distill, compute_viewspace_depth=True)
        assert set(got) == keys
        for k in ("gaussian_centers", "confidence", "context_view_depths", "pred_extrins"):
            _close(got[k].detach().numpy(), want[k], 1e-4, k)
    assert "gaussians" not in early
    assert vicasplat_forward(model, _torch_batch(ctx), 0, dtype=torch.float32,
                             distill=True)["context_view_depths"] is None


@pytest.mark.parametrize("T,conf", [(2, True), (4, True), (4, False)])
def test_distillation_loss_matches_jax(teacher, T, conf):
    """The teacher's term at T = 2 (anchor 0) and T = 4 (JAX's draw for the
    key, passed to the port; normalize_pointcloud on), with and without the
    student's confidence."""
    _, jax_fwd, teacher_fn = teacher
    rng = np.random.default_rng(4 + T)
    B, H, W = 2, 32, 32
    batch = {"context": {
        "image": rng.uniform(0, 1, (B, T, H, W, 3)).astype(np.float32),
        "extrinsics": np.tile(np.eye(4, dtype=np.float32), (B, T, 1, 1))}}
    batch["context"]["extrinsics"][..., :3, :] += rng.normal(0, 0.1, (B, T, 3, 4))
    out = {"gaussian_centers": rng.normal(size=(B, T, H, W, 3)).astype(np.float32),
           "confidence": ((1 + rng.exponential(size=(B, T, H, W))).astype(np.float32)
                          if conf else None)}
    key = jax.random.PRNGKey(T)
    anchor = int(jax.random.randint(key, (), 0, max(T - 1, 1)))
    jloss, _ = jstep.distillation_loss(jax.tree.map(jnp.asarray, out),
                                       jax_fwd,
                                       jax.tree.map(jnp.asarray, batch), key)
    tout = {k: None if v is None else torch.from_numpy(v) for k, v in out.items()}
    tloss, logs = tstep.distillation_loss(tout, teacher_fn, _torch_batch(batch), anchor)
    assert set(logs) == ({"regr3d_point", "regr3d_conf"} if conf else {"regr3d_point"})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    if T == 2:
        assert tstep.anchor_frame(7, 0, T) == 0


def test_missing_teacher_checkpoint_gives_random_weights(tmp_path, monkeypatch, capsys):
    """_maybe_distiller: no teacher without train.distiller; with one and
    no checkpoint file, the JAX package's warning and a frozen random
    teacher from a generator seeded 1 (the same weights each time)."""
    from vicasplat_tpu_torch.utils.config import parse_cli

    assert tmain._maybe_distiller(parse_cli(["+experiment=synthetic_pose"]), "cpu") is None
    monkeypatch.setattr(tmain, "teacher_config", lambda cfg: td.Dust3RConfig(**TEACHER))
    monkeypatch.setenv("DISTILLER_CKPT", str(tmp_path / "missing.ckpt"))
    cfg = parse_cli(["+experiment=distill"])
    assert cfg.train.distiller == "mast3r"
    fns = [tmain._maybe_distiller(cfg, "cpu") for _ in range(2)]
    assert "missing.ckpt missing" in capsys.readouterr().out
    a, b = (m.model.state_dict() for m in fns)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not any(p.requires_grad for p in fns[0].model.parameters())
    img = torch.zeros(1, 32, 32, 3)
    assert fns[0](img, img)["view1"]["pts3d"].dtype == torch.float32
