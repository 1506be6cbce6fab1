"""The port's configs and decoder contract against the JAX package's, in
float32 on the CPU: every JAX config converts to the port's by
`dataclasses.asdict`, the weight bridge covers the linear-head and
stabilized-head configuration of configs/experiment/synthetic_pose.yaml,
and a JAX-shaped `decoder_forward` call (near, far, scale invariance,
pruning) renders what JAX renders."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import IMG_TOL, _expected_shapes
from test_torch_training import to_port_config

from vicasplat_tpu.decoder import splatting as jsp
from vicasplat_tpu.loss import losses as jl
from vicasplat_tpu.models import adapter as jad
from vicasplat_tpu.models import heads as jheads
from vicasplat_tpu.models import vicasplat as jvs
from vicasplat_tpu.models.vicanet import VicaNetConfig as JNetCfg
from vicasplat_tpu.ops.rasterize.render import RasterizeConfig as JRasterCfg
from vicasplat_tpu.training import optimizer as jopt
from vicasplat_tpu.training import step as jstep
from vicasplat_tpu_torch.decoder import splatting as tsp
from vicasplat_tpu_torch.loss import losses as tl
from vicasplat_tpu_torch.models import adapter as tad
from vicasplat_tpu_torch.models import heads as theads
from vicasplat_tpu_torch.models import vicasplat as tvs
from vicasplat_tpu_torch.models.vicanet import VicaNetConfig as TNetCfg
from vicasplat_tpu_torch.training import optimizer as topt
from vicasplat_tpu_torch.training import step as tstep

torch.set_num_threads(1)

# the synthetic_pose experiment's model: linear heads, a 384-wide backbone
SYNTHETIC_POSE = dict(
    backbone=dict(img_size=64, enc_embed_dim=384, enc_depth=6, enc_num_heads=6,
                  dec_embed_dim=384, dec_depth=4, dec_num_heads=6,
                  use_intrinsic_embedding=True),
    gaussian_adapter=dict(sh_degree=1), gs_center_head_type="linear",
    gs_param_head_type="linear", pts3d_bounds=(0.1, 20.0))


@pytest.mark.parametrize("jcls,tcls", [
    (jsp.DecoderSplattingConfig, tsp.DecoderSplattingConfig),
    (jvs.VicaSplatConfig, tvs.VicaSplatConfig),
    (jheads.DPTConfig, theads.DPTConfig),
    (JNetCfg, TNetCfg),
    (jad.GaussianAdapterConfig, tad.GaussianAdapterConfig),
    (jvs.OpacityMappingConfig, tvs.OpacityMappingConfig),
    (JRasterCfg, tsp.RasterizeConfig),
    (jl.LossMseConfig, tl.LossMseConfig),
    (jl.LossCameraConfig, tl.LossCameraConfig),
    (jl.LossLpipsConfig, tl.LossLpipsConfig),
    (jl.LossDepthConfig, tl.LossDepthConfig),
    (jopt.OptimizerConfig, topt.OptimizerConfig),
    (jstep.TrainConfig, tstep.TrainConfig)])
def test_every_jax_config_converts(jcls, tcls):
    """Same field names, defaults and values, nested configs included."""
    jcfg = jcls()
    tcfg = to_port_config(tcls, dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert [f.name for f in dataclasses.fields(tcls)] == [
        f.name for f in dataclasses.fields(jcls)]


def test_non_default_fields_convert():
    """The F1 fields with non-default values carry over and build."""
    jcfg = jvs.VicaSplatConfig(dpt_stabilize=True, gs_center_head_type="linear",
                               input_mean=(0.4, 0.5, 0.6), input_std=(0.2, 0.3, 0.4))
    tcfg = to_port_config(tvs.VicaSplatConfig, dataclasses.asdict(jcfg))
    assert tcfg.center_dpt().stabilize and tcfg.gs_dpt().stabilize
    assert tcfg.gs_dpt().patch_size == jcfg.backbone.patch_size
    imgs = np.random.default_rng(0).uniform(size=(1, 2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tvs.normalize_images(torch.from_numpy(imgs), tcfg).numpy(),
        np.asarray(jvs.normalize_images(jnp.asarray(imgs), jcfg)), rtol=1e-6)
    d = to_port_config(tsp.DecoderSplattingConfig, dataclasses.asdict(
        jsp.DecoderSplattingConfig(make_scale_invariant=True, prune_fraction=0.25)))
    assert d.make_scale_invariant and d.prune_fraction == 0.25
    with pytest.raises(ValueError):
        tvs.VicaSplat(tvs.VicaSplatConfig(gs_param_head_type="conv"))


def test_bridge_keys_cover_synthetic_pose_config():
    """Linear heads (synthetic_pose.yaml), and the stabilized DPT heads'
    LayerScales and trunk norms: every port parameter has one JAX leaf of
    the right shape (shapes only)."""
    for extra in ({}, {"gs_center_head_type": "dpt", "gs_param_head_type": "dpt_gs",
                       "dpt_stabilize": True}):
        kw = dict(SYNTHETIC_POSE, **extra)
        jcfg = jvs.VicaSplatConfig(**dict(
            kw, backbone=JNetCfg(**kw["backbone"]),
            gaussian_adapter=jad.GaussianAdapterConfig(**kw["gaussian_adapter"])))
        tcfg = to_port_config(tvs.VicaSplatConfig, dataclasses.asdict(jcfg))
        shape_tree = jax.eval_shape(lambda k: jvs.init_vicasplat(k, jcfg),
                                    jax.random.PRNGKey(0))
        with torch.device("meta"):
            model = tvs.VicaSplat(tcfg)
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == _expected_shapes(shape_tree)


def _gaussians(rng, B=2, N=600):
    means = np.stack([rng.uniform(-1.5, 1.5, (B, N)), rng.uniform(-1.2, 1.2, (B, N)),
                      rng.uniform(2.0, 6.0, (B, N))], -1)
    scales = rng.uniform(0.03, 0.2, (B, N, 3))
    quats = rng.normal(size=(B, N, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    sh = rng.normal(0, 0.3, (B, N, 3, 4))
    opac = rng.uniform(0.05, 1.0, (B, N))
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return [f(x) for x in (means, scales, quats, sh, opac)]


@pytest.mark.parametrize("scale_invariant,prune", [(True, 0.25), (False, 0.0)])
def test_decoder_forward_matches_jax(scale_invariant, prune):
    """decoder_forward(cfg, g, extrinsics, intrinsics, near, far, image_shape)
    with per-example near planes (2 and 0.5, so the scale divides and
    multiplies), against JAX; covariances filled for both packages."""
    rng = np.random.default_rng(0)
    means, scales, quats, sh, opac = _gaussians(rng)
    B, V, size = 2, 2, 32
    ext = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    ext[:, 1, :3, 3] = [0.2, -0.1, 0.3]
    K = np.tile(np.array([[0.9, 0, 0.5], [0, 1.1, 0.48], [0, 0, 1]], np.float32),
                (B, V, 1, 1))
    near = np.array([[2.0, 2.0], [0.5, 0.5]], np.float32)
    far = np.full((B, V), 100.0, np.float32)
    raster = dict(tile_px=8, dup_hw=(4, 4), max_per_tile=64, chunk=32, tile_group=16)
    kw = dict(make_scale_invariant=scale_invariant, prune_fraction=prune)
    jcfg = jsp.DecoderSplattingConfig(rasterize=JRasterCfg(**raster), **kw)
    tcfg = to_port_config(tsp.DecoderSplattingConfig, dataclasses.asdict(jcfg))
    from vicasplat_tpu.models.adapter import build_covariance as j_cov
    from vicasplat_tpu_torch.models.adapter import build_covariance as t_cov

    jg = jad.Gaussians(jnp.asarray(means), j_cov(jnp.asarray(scales), jnp.asarray(quats)),
                       jnp.asarray(sh), jnp.asarray(opac), jnp.asarray(scales),
                       jnp.asarray(quats))
    tg = tad.Gaussians(*(torch.from_numpy(x) for x in (means,)),
                       t_cov(torch.from_numpy(scales), torch.from_numpy(quats)),
                       *(torch.from_numpy(x) for x in (sh, opac, scales, quats)))
    ref = jsp.decoder_forward(jcfg, jg, *(jnp.asarray(x) for x in (ext, K, near, far)),
                              (size, size))
    out = tsp.decoder_forward(tcfg, tg, *(torch.from_numpy(x) for x in (ext, K, near, far)),
                              (size, size))
    assert float(out.alpha.max()) > 0.1  # splats land in the views
    for name in ("color", "depth", "alpha"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=IMG_TOL,
                                   rtol=IMG_TOL, err_msg=name)


def test_prune_keeps_the_most_opaque():
    rng = np.random.default_rng(1)
    means, scales, quats, sh, opac = _gaussians(rng, N=1000)
    g = tad.Gaussians(torch.from_numpy(means), None, torch.from_numpy(sh),
                      torch.from_numpy(opac), torch.from_numpy(scales),
                      torch.from_numpy(quats))
    kept = tsp.prune_gaussians(g, 0.25)
    assert kept.opacities.shape == (2, 640)  # 750 rounded down to 128s
    assert kept.covariances is None
    for b in range(2):
        want = np.sort(opac[b])[::-1][:640]
        np.testing.assert_array_equal(np.sort(kept.opacities[b].numpy())[::-1], want)
        i = np.argsort(-opac[b])[:640]
        order = np.argsort(-kept.opacities[b].numpy())
        np.testing.assert_array_equal(kept.means[b].numpy()[order], means[b][i])
        np.testing.assert_array_equal(kept.harmonics[b].numpy()[order], sh[b][i])
