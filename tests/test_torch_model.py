"""Parity of the port's VicaSplat forward (backbone, DPT heads, camera head,
Gaussian adapter) with the JAX package's, in float32 on the CPU, and of the
weight bridge's key set with the port's modules."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicasplat_tpu.decoder import splatting as jsp
from vicasplat_tpu.models import adapter as jad
from vicasplat_tpu.models import heads as jheads
from vicasplat_tpu.models import vicasplat as jvs
from vicasplat_tpu.models.vicanet import VicaNetConfig as JNetCfg
from vicasplat_tpu_torch.decoder import splatting as tsp
from vicasplat_tpu_torch.models import adapter as tad
from vicasplat_tpu_torch.models import heads as theads
from vicasplat_tpu_torch.models import vicasplat as tvs
from vicasplat_tpu_torch.models.vicanet import VicaNetConfig as TNetCfg
from vicasplat_tpu_torch.utils import weights

torch.set_num_threads(1)

# compositing: exp/log1p of the splats over a pixel accumulated by two
# matmuls per chunk in different orders; far below one splat's 1/255
IMG_TOL = 1e-4
# float32 on both sides; the DPT heads add ~20 convs and an exp map to the
# backbone's 6 blocks, each summed in another order by XLA and by torch
# (~1e-6 relative per op). 2e-4 relative + absolute covers that and still
# fails on any wrong layout, padding or channel order
TOL = 2e-4


def tiny_cfgs(T=3, use_intrin=True, sh_degree=1, **extra):
    """The tiny config of tests/test_model.py, for both packages."""
    net = dict(img_size=32, patch_size=16, enc_embed_dim=64, enc_depth=2,
               enc_num_heads=4, dec_embed_dim=48, dec_depth=4, dec_num_heads=4,
               use_intrinsic_embedding=use_intrin, temporal_rope_theta=30.0)
    jcfg = jvs.VicaSplatConfig(
        backbone=JNetCfg(**net),
        gaussian_adapter=jad.GaussianAdapterConfig(sh_degree=sh_degree), **extra)
    tcfg = tvs.VicaSplatConfig(
        backbone=TNetCfg(**net),
        gaussian_adapter=tad.GaussianAdapterConfig(sh_degree=sh_degree), **extra)
    return jcfg, tcfg


def perturbed_params(jcfg, seed=1, scale=0.02):
    """JAX params whose zero-initialized leaves (biases, the camera head, the
    AdaLN modulations) get small random values, which would otherwise hide
    the pose decode, the bias layouts and the AdaLN split order."""
    leaves, tree = jax.tree.flatten(jvs.init_vicasplat(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(rng.normal(0, scale, x.shape) if not x.any() else x,
                          jnp.float32) for x in leaves]
    return jax.tree.unflatten(tree, leaves)


def tiny_context(B=2, T=3, H=32, W=32, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (B, T, H, W, 3)).astype(np.float32)
    K = np.broadcast_to(np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5],
                                  [0.0, 0.0, 1.0]], np.float32), (B, T, 3, 3))
    return images, np.ascontiguousarray(K)


def run_both(jcfg, tcfg, params, images, K):
    ref = jax.jit(lambda p, c: jvs.vicasplat_forward(p, jcfg, c, dtype=jnp.float32))(
        params, {"image": jnp.asarray(images), "intrinsics": jnp.asarray(K)})
    model = weights.load_jax_params(tvs.VicaSplat(tcfg), params)
    with torch.no_grad():
        out = tvs.vicasplat_forward(
            model, {"image": torch.from_numpy(images),
                    "intrinsics": torch.from_numpy(K)}, dtype=torch.float32)
    return ref, out


def assert_close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol,
                               rtol=tol, err_msg=msg)


@pytest.mark.parametrize("use_intrin,H,W,conf", [(True, 32, 32, False),
                                                 (False, 48, 32, True)])
def test_forward_matches_jax(use_intrin, H, W, conf):
    """Square frames with the intrinsic token; portrait frames (the heads'
    transposition) with the FoV intrinsic head and the confidence channel."""
    jcfg, tcfg = tiny_cfgs(use_intrin=use_intrin, predict_conf=conf)
    params = perturbed_params(jcfg)
    images, K = tiny_context(H=H, W=W)
    ref, out = run_both(jcfg, tcfg, params, images, K)
    for name in ("means", "covariances", "harmonics", "opacities", "scales",
                 "rotations"):
        assert_close(getattr(out["gaussians"], name),
                     getattr(ref["gaussians"], name), msg=name)
    for name in ("raw_gaussians", "pred_extrins", "gaussian_camera_extrins"):
        assert_close(out[name], ref[name], msg=name)
    if use_intrin:
        assert out["gaussian_camera_intrins"] is None
    else:
        assert_close(out["gaussian_camera_intrins"], ref["gaussian_camera_intrins"])
    if conf:
        assert_close(out["confidence"], ref["confidence"])
    else:
        assert out["confidence"] is None
    assert out["gaussians"].means.shape == (2, 3, H, W, 3)


def test_random_init_gives_identity_poses():
    _, tcfg = tiny_cfgs()
    model = tvs.init_vicasplat(tcfg, torch.Generator().manual_seed(0), "cpu")
    images, K = tiny_context()
    with torch.no_grad():
        out = tvs.vicasplat_forward(model, {"image": torch.from_numpy(images),
                                            "intrinsics": torch.from_numpy(K)},
                                    dtype=torch.float32)
    poses = out["gaussian_camera_extrins"]
    torch.testing.assert_close(poses, torch.eye(4).expand_as(poses), atol=1e-6,
                               rtol=0)
    assert torch.isfinite(out["raw_gaussians"]).all()


@pytest.mark.parametrize("camera_type", ["dq", "qt"])
def test_decode_camera_matches_jax(camera_type):
    c = 8 if camera_type == "dq" else 7
    pred = np.random.default_rng(3).normal(0, 0.5, (2, 5, c)).astype(np.float32)
    pj, mj = jvs.decode_camera(jnp.asarray(pred), camera_type)
    pt, mt = tvs.decode_camera(torch.from_numpy(pred), camera_type)
    assert_close(pt, pj, 1e-5)
    assert_close(mt, mj, 1e-5)


@pytest.mark.parametrize("scale_act", ["softplus", "bounded", "exp"])
def test_adapter_matches_jax(scale_act):
    raw = np.random.default_rng(4).normal(0, 1.0, (2, 6, 11 + 3 * 16))
    raw = raw.astype(np.float32)
    gj = jad.adapt_gaussians(jnp.asarray(raw), jad.GaussianAdapterConfig(
        sh_degree=3, scale_act=scale_act))
    gt = tad.adapt_gaussians(torch.from_numpy(raw), tad.GaussianAdapterConfig(
        sh_degree=3, scale_act=scale_act))
    for name in gt._fields:
        assert_close(getattr(gt, name), getattr(gj, name), 1e-5, name)


def test_postprocess_pts3d_matches_jax():
    rng = np.random.default_rng(5)
    raw = rng.normal(0, 2.0, (4, 7, 3)).astype(np.float32)
    raw[0, 0] = 0.0  # the smooth norm at exactly zero
    for bounds in [(0.0, float("inf")), (0.5, 20.0)]:
        assert_close(theads.postprocess_pts3d_exp(torch.from_numpy(raw), *bounds),
                     jheads.postprocess_pts3d_exp(jnp.asarray(raw), *bounds), 1e-5)


def test_forward_and_render_end_to_end():
    """Tiny forward -> 3 target views, each package end to end."""
    jcfg, tcfg = tiny_cfgs()
    params = perturbed_params(jcfg)
    images, K = tiny_context()
    ref, out = run_both(jcfg, tcfg, params, images, K)
    B, V, size = 2, 3, 32
    ext = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    ext[:, :, 2, 3] = np.linspace(-8.0, -4.0, V)  # back off to see the scene
    tK = np.ascontiguousarray(K[:, :1].repeat(V, axis=1))
    jdec = jax.jit(lambda g, e, k: jsp.decoder_forward(
        jsp.DecoderSplattingConfig(), g, e, k, jnp.ones((B, V)),
        jnp.full((B, V), 100.0), (size, size)))
    rj = jdec(ref["gaussians"], jnp.asarray(ext), jnp.asarray(tK))
    rt = tsp.decoder_forward(tsp.DecoderSplattingConfig(), out["gaussians"],
                             torch.from_numpy(ext), torch.from_numpy(tK),
                             torch.ones(B, V), torch.full((B, V), 100.0),
                             (size, size))
    assert rt.color.shape == (B, V, size, size, 3)
    assert float(rt.alpha.max()) > 0.1  # splats land in the views
    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)), atol=IMG_TOL,
                                   rtol=IMG_TOL, err_msg=name)


def _expected_shapes(shape_tree):
    """{port key: shape} from a JAX param tree of shapes, by the bridge's
    naming rule (weights.torch_key)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in weights.STACKED:
                    depth = jax.tree.leaves(v)[0].shape[0]
                    for i in range(depth):
                        walk(jax.tree.map(lambda s: s.shape[1:], v,
                                          is_leaf=lambda s: hasattr(s, "shape")),
                             path + [k, str(i)])
                else:
                    walk(v, path + [k])
            return
        shape = tuple(node.shape) if hasattr(node, "shape") else tuple(node)
        key, perm = weights.torch_key(path, len(shape))
        out[key] = tuple(shape[p] for p in perm) if perm else shape

    walk(shape_tree, [])
    return out


@pytest.mark.parametrize("flagship", [False, True])
def test_bridge_keys_cover_the_model(flagship):
    """Every port parameter has one JAX leaf of the right shape, at the
    flagship config too (shapes only: no weights are made)."""
    if flagship:
        net = dict()
        jcfg = jvs.VicaSplatConfig(gaussian_adapter=jad.GaussianAdapterConfig(
            sh_degree=4))
        tcfg = tvs.VicaSplatConfig(gaussian_adapter=tad.GaussianAdapterConfig(
            sh_degree=4))
        assert dataclasses.asdict(jcfg.backbone) == dataclasses.asdict(
            TNetCfg(**net))
    else:
        jcfg, tcfg = tiny_cfgs(use_intrin=False)
    shape_tree = jax.eval_shape(lambda k: jvs.init_vicasplat(k, jcfg),
                                jax.random.PRNGKey(0))
    with torch.device("meta"):
        model = tvs.VicaSplat(tcfg)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == _expected_shapes(shape_tree)


def test_gs_head_fused_tail_matches_jax():
    """dpt_gs_head with tail_backend="pallas" (the fused tail K3, its plain
    version here) against the JAX head with its Pallas tail, interpreted;
    the sizes of the JAX package's own gated-path test."""
    kw = dict(hook_dims=(64, 64, 64, 64), layer_dims=(24, 48, 96, 192),
              feature_dim=128, head_type="gs_params", num_channels=82,
              use_input_merger=True, tail_backend="pallas")
    jcfg = jheads.DPTConfig(**kw)
    params = jheads.init_dpt(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(6)
    gh = 4
    hooks = [rng.normal(size=(2, gh * gh, 64)).astype(np.float32) for _ in range(4)]
    imgs = rng.normal(size=(2, 16 * gh, 16 * gh, 3)).astype(np.float32)
    ref = jheads.dpt_gs_head(params, jcfg, [jnp.asarray(h) for h in hooks],
                             (gh, gh), jnp.asarray(imgs), jnp.float32)
    mod = theads.DPT(theads.DPTConfig(**kw))
    mod.load_state_dict(weights.state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        out = theads.dpt_gs_head(mod, [torch.from_numpy(h) for h in hooks],
                                 (gh, gh), torch.from_numpy(imgs), torch.float32)
    assert out.shape == (2, 64, 64, 82)
    assert_close(out, ref)


def test_forward_fused_tail_matches_jax():
    """The forward with head_tail_backend="pallas": the GS head takes the
    fused tail in both packages (the 3-channel centre head stays plain by
    the JAX gate), and the bridge loads the same parameters."""
    jcfg, tcfg = tiny_cfgs(head_tail_backend="pallas")
    assert tcfg.gs_dpt().tail_backend == "pallas"
    params = perturbed_params(jcfg)
    images, K = tiny_context()
    ref, out = run_both(jcfg, tcfg, params, images, K)
    for name in ("raw_gaussians", "gaussian_camera_extrins"):
        assert_close(out[name], ref[name], msg=name)
    for name in ("harmonics", "opacities", "scales"):
        assert_close(getattr(out["gaussians"], name),
                     getattr(ref["gaussians"], name), msg=name)
