"""The port's synthetic scene generator (vicasplat_tpu_torch/data/) against
the JAX package's, bit for bit from the same seeds, and one view of the
generator's default scene through the port's accelerator render on the CPU
against the JAX package's Pallas render run interpreted."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_render import EXIT_TOL, SMALL, jax_exact_depth_order
from vicasplat_tpu.data import synthetic_scenes as jscenes
from vicasplat_tpu.ops.rasterize import projection as jproj
from vicasplat_tpu.ops.rasterize.render import RasterizeConfig as JRasterCfg
from vicasplat_tpu.ops.rasterize.render import render as jrender
from vicasplat_tpu_torch.data import synthetic_scenes as tscenes
from vicasplat_tpu_torch.ops.rasterize import projection as tproj
from vicasplat_tpu_torch.ops.rasterize.render import RasterizeConfig as TRasterCfg
from vicasplat_tpu_torch.ops.rasterize.render import render as trender

torch.set_num_threads(1)


def _cfgs(**kw):
    return jscenes.SyntheticScenesConfig(**kw), tscenes.SyntheticScenesConfig(**kw)


def test_config_matches_jax():
    """The port's config has every field of the JAX config's, with its
    default (the dataset's fields since the evaluation slice)."""
    jcfg, tcfg = _cfgs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("shape,n,scene_id", [((64, 64), 3072, 0), ((64, 64), 3072, 5),
                                              ((256, 256), 4096, 0)])
def test_generator_matches_jax_bit_for_bit(shape, n, scene_id):
    """Gaussians, trajectory and intrinsics from the generator's own seeding
    (`generate_scene`: seed * 1_000_003 + scene id)."""
    jcfg, tcfg = _cfgs(input_image_shape=shape, n_gaussians=n)
    jr = np.random.default_rng(jcfg.seed * 1_000_003 + scene_id)
    tr = tscenes.scene_rng(scene_id, tcfg)
    jg, tg = jscenes.scene_gaussians(jr, jcfg), tscenes.scene_gaussians(tr, tcfg)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        assert tg[k].dtype == jg[k].dtype and tg[k].shape == jg[k].shape, k
        np.testing.assert_array_equal(tg[k], jg[k], err_msg=k)
    np.testing.assert_array_equal(tscenes.scene_trajectory(tr, tcfg),
                                  jscenes.scene_trajectory(jr, jcfg))
    np.testing.assert_array_equal(tscenes.intrinsics_for(tcfg), jscenes.intrinsics_for(jcfg))
    eye, center, up = np.array([0.1, -0.2, 0.3]), np.array([0.5, 0.1, 3.0]), \
        np.array([0.0, -1.0, 0.0])
    np.testing.assert_array_equal(tscenes._look_at(eye, center, up),
                                  jscenes._look_at(eye, center, up))


def test_default_scene_render_matches_jax():
    """Frame 0 of scene 0 (64 x 64, 3,072 Gaussians, SH degree 0) through
    the accelerator configuration on both sides: the port's plain versions
    of K2 and K4 on the CPU, the JAX package's Pallas kernels interpreted.
    Its pixels are 0.7 covered on average, up to 0.9995 (with 64 rows a
    tile, none reaches T < 1e-4)."""
    _, cfg = _cfgs()
    rng = tscenes.scene_rng(0, cfg)
    g = tscenes.scene_gaussians(rng, cfg)
    ext = tscenes.scene_trajectory(rng, cfg)[:1]
    K = tscenes.intrinsics_for(cfg)[None]
    shape = cfg.input_image_shape
    bg = np.zeros(3, np.float32)
    raster = dict(SMALL, backend="pallas", binning="origin")
    cov6 = jproj.cov6_from_scale_rot(jnp.asarray(g["scales"]), jnp.asarray(g["rotations"]))
    with jax_exact_depth_order():  # JAX's origin words tie close depths
        ref = jrender(jnp.asarray(g["means"]), None, jnp.asarray(g["harmonics"]),
                      jnp.asarray(g["opacities"]), jnp.asarray(ext), jnp.asarray(K),
                      shape, tuple(bg.tolist()), 0, cfg=JRasterCfg(**raster), cov6=cov6)
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    out = trender(t["means"], tproj.cov6_from_scale_rot(t["scales"], t["rotations"]),
                  t["harmonics"], t["opacities"], torch.from_numpy(ext),
                  torch.from_numpy(K), shape, torch.from_numpy(bg), 0,
                  cfg=TRasterCfg(**raster))
    assert out[0].shape == (1, *shape, 3)
    assert float(out[2].mean()) > 0.5 and float(out[2].max()) > 0.999
    for name, a, b in zip(("color", "depth", "alpha"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=EXIT_TOL[name],
                                   rtol=0, err_msg=name)
