"""Parity of the port's rasterizer (projection, dup-sort and origin binning,
matmul and kernel compositing) with the JAX package's, in float32 on the
CPU, where the port's kernels take their plain versions and the JAX
package's Pallas kernels run interpreted. Renders are compared as images,
never as ids. The port composites each tile's splats in exact depth order;
the JAX package's u32 sort words keep only some bits of the depth and order
the splats they tie arbitrarily, so where such a tie reaches a pixel the
JAX reference is taken with each tile's kept list put in exact depth order
(`jax_exact_depth_order`)."""
import contextlib
import dataclasses
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicasplat_tpu.geometry.se3 import rigid_inverse as j_rigid_inverse
from vicasplat_tpu.ops.rasterize import projection as jproj
from vicasplat_tpu.ops.rasterize.render import RasterizeConfig as JRasterCfg
from vicasplat_tpu.ops.rasterize.render import render as jrender
from vicasplat_tpu.ops.rasterize.tiles import TileBins as JTileBins
from vicasplat_tpu_torch.ops.rasterize import projection as tproj
from vicasplat_tpu_torch.ops.rasterize.render import RasterizeConfig as TRasterCfg
from vicasplat_tpu_torch.ops.rasterize.render import render as trender

torch.set_num_threads(1)


@contextlib.contextmanager
def jax_exact_depth_order():
    """The JAX package's renders with its own binning (windows, caps and the
    splats each tile keeps), each tile's kept list then sorted by its exact
    depth before compositing. JAX's dup-sort keys keep 32 - tile_bits bits
    of the depth and its origin words 32 - log2(merged width), and splats
    whose bits tie composite in whatever order the sort leaves them; the
    port's keys keep the exact order (ops/rasterize/tiles.py)."""
    mod = importlib.import_module("vicasplat_tpu.ops.rasterize.render")

    def exact(bin_fn):
        def wrapped(*args, **kw):
            p = bin_fn(*args, **kw).payload
            key = jnp.where(p[..., 5] > 0, p[..., 9], jnp.inf)  # empty slots last
            order = jnp.argsort(key, axis=1, stable=True)
            return JTileBins(jnp.take_along_axis(p, order[..., None], axis=1))
        return wrapped

    with mock.patch.object(mod, "bin_splats", exact(mod.bin_splats)), \
            mock.patch.object(mod, "bin_splats_origin", exact(mod.bin_splats_origin)):
        yield

# projection: elementwise float32 formulas in the same order, a few ulp
PROJ_TOL = 1e-5
# compositing: exp/log1p of ~100 splats per pixel accumulated by two
# matmuls per chunk in different orders; 1e-4 on [0, 1] colours and O(5)
# depths is far below one splat's contribution (>= 1/255 of its colour)
IMG_TOL = 1e-4
# the compositing kernels stop a pixel (port's kernel) or a tile (JAX's)
# once its transmittance is below 1e-4; the plain version never stops. What
# one of them drops is at most 1e-4 of a splat's feature: colours stay
# below 2 and depths below 7 in these scenes, alpha below 1
EXIT_T = 1e-4
EXIT_TOL = {"color": IMG_TOL + EXIT_T * 2.0, "depth": IMG_TOL + EXIT_T * 7.0,
            "alpha": IMG_TOL + EXIT_T}
# gradients: the same recompute through matmul compositing on both sides,
# summed in other orders over ~100 splats a pixel; relative to the largest
GRAD_TOL = 1e-3
# the sizes of the JAX package's own Pallas and origin-binning tests
SMALL = dict(tile_px=8, dup_hw=(4, 4), max_per_tile=64, chunk=32, tile_group=16,
             pallas_chunk=32)


def scene(n=400, sh_degree=2, seed=0):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(2.0, 6.0, n)], -1)
    scales = rng.uniform(0.03, 0.2, (n, 3))
    quats = rng.normal(size=(n, 4))
    sh = rng.normal(0, 0.3, (n, 3, (sh_degree + 1) ** 2))
    opac = rng.uniform(0.2, 1.0, n)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f(means), f(scales), f(quats), f(sh), f(opac)


def cameras(V=2):
    ext = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    ext[1, :3, 3] = [0.2, -0.1, 0.3]
    c, s = np.cos(0.1), np.sin(0.1)
    ext[1, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    K = np.tile(np.array([[0.9, 0, 0.5], [0, 1.1, 0.48], [0, 0, 1]], np.float32),
                (V, 1, 1))
    return ext, K


def test_projection_matches_jax():
    means, scales, quats, sh, opac = scene()
    cov6_j = jproj.cov6_from_scale_rot(jnp.asarray(scales), jnp.asarray(quats))
    cov6_t = tproj.cov6_from_scale_rot(torch.from_numpy(scales), torch.from_numpy(quats))
    np.testing.assert_allclose(cov6_t.numpy(), np.asarray(cov6_j), atol=PROJ_TOL,
                               rtol=PROJ_TOL)
    ext, K = cameras()
    vm = np.asarray(j_rigid_inverse(jnp.asarray(ext[1])))
    sj = jproj.project_gaussians(jnp.asarray(means), None, jnp.asarray(sh),
                                 jnp.asarray(opac), jnp.asarray(vm), jnp.asarray(K[1]),
                                 (40, 56), 2, cov6=cov6_j)
    st = tproj.project_gaussians(torch.from_numpy(means), cov6_t, torch.from_numpy(sh),
                                 torch.from_numpy(opac), torch.tensor(vm),
                                 torch.from_numpy(K[1]), (40, 56), 2)
    assert 0 < (st.radius > 0).sum() < len(means)  # some splats are culled
    for name in st._fields:
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), atol=PROJ_TOL,
                                   rtol=PROJ_TOL, err_msg=name)


@pytest.mark.parametrize("image_shape,max_per_tile,chunk",
                         [((48, 64), 512, 256), ((40, 56), 128, 64)])
def test_render_matches_jax(image_shape, max_per_tile, chunk):
    """A full-size 4-chunk tile list, and a ragged image (cropped tiles) with
    a small K that overflows in the dense tiles."""
    means, scales, quats, sh, opac = scene()
    ext, K = cameras()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jcfg = JRasterCfg(max_per_tile=max_per_tile, chunk=chunk, tile_group=4)
    tcfg = TRasterCfg(max_per_tile=max_per_tile, chunk=chunk, tile_group=4)
    cov6 = jproj.cov6_from_scale_rot(jnp.asarray(scales), jnp.asarray(quats))
    ref = jax.jit(lambda *a: jrender(*a, image_shape, jnp.asarray(bg), 2,
                                     cfg=jcfg, cov6=cov6))(
        jnp.asarray(means), None, jnp.asarray(sh), jnp.asarray(opac),
        jnp.asarray(ext), jnp.asarray(K))
    out = trender(
        torch.from_numpy(means),
        tproj.cov6_from_scale_rot(torch.from_numpy(scales), torch.from_numpy(quats)),
        torch.from_numpy(sh), torch.from_numpy(opac), torch.from_numpy(ext),
        torch.from_numpy(K), image_shape, torch.from_numpy(bg), 2, cfg=tcfg)
    assert out[0].shape == (2, *image_shape, 3)
    assert float(out[2].max()) > 0.5  # the scene covers the views
    for name, a, b in zip(("color", "depth", "alpha"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=IMG_TOL,
                                   rtol=IMG_TOL, err_msg=name)


def _both(cfg_kw, image_shape, bg, n=400):
    """Inputs of one scene for both packages and their two configs."""
    means, scales, quats, sh, opac = scene(n=n)
    ext, K = cameras()
    jargs = (jnp.asarray(means), None, jnp.asarray(sh), jnp.asarray(opac),
             jnp.asarray(ext), jnp.asarray(K))
    targs = (torch.from_numpy(means),
             tproj.cov6_from_scale_rot(torch.from_numpy(scales),
                                       torch.from_numpy(quats)),
             torch.from_numpy(sh), torch.from_numpy(opac), torch.from_numpy(ext),
             torch.from_numpy(K))
    cov6 = jproj.cov6_from_scale_rot(jnp.asarray(scales), jnp.asarray(quats))
    return jargs, targs, cov6, JRasterCfg(**cfg_kw), TRasterCfg(**cfg_kw)


@pytest.mark.parametrize("image_shape", [(32, 32), (40, 56)])
@pytest.mark.parametrize("backend,binning", [("pallas", "dup_sort"),
                                             ("xla", "origin"),
                                             ("pallas", "origin")])
def test_accelerator_render_matches_jax(backend, binning, image_shape):
    """The accelerator configuration's compositing (K2) and origin binning
    (K4) against the JAX package's Pallas paths, on a square image and on a
    ragged one (cropped edge tiles)."""
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jargs, targs, cov6, jcfg, tcfg = _both(
        dict(SMALL, backend=backend, binning=binning), image_shape, bg)
    # the Pallas path takes the background as a static tuple; the ragged
    # image's origin words tie splats that the port orders exactly
    with jax_exact_depth_order():
        ref = jrender(*jargs, image_shape, tuple(bg.tolist()), 2, cfg=jcfg, cov6=cov6)
    out = trender(*targs, image_shape, torch.from_numpy(bg), 2, cfg=tcfg)
    assert float(out[2].max()) > 0.99  # saturated pixels: the exit matters
    for name, a, b in zip(("color", "depth", "alpha"), out, ref):
        tol = EXIT_TOL[name] if backend == "pallas" else IMG_TOL
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0,
                                   err_msg=name)


def test_origin_binning_tiny_scene():
    """Fewer splats than one tile holds: the sorted keys are padded."""
    bg = np.zeros(3, np.float32)
    jargs, targs, cov6, jcfg, tcfg = _both(dict(SMALL, binning="origin"),
                                           (32, 32), bg, n=6)
    ref = jrender(*jargs, (32, 32), jnp.asarray(bg), 2, cfg=jcfg, cov6=cov6)
    out = trender(*targs, (32, 32), torch.from_numpy(bg), 2, cfg=tcfg)
    for name, a, b in zip(("color", "depth", "alpha"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=IMG_TOL,
                                   rtol=0, err_msg=name)


def test_accelerator_render_grads_match_jax():
    """Gradients of a scalar of the render to means, opacities and pose
    deltas, through K2's autograd function and origin binning, against
    jax.grad through the Pallas path's custom_vjp."""
    image_shape = (32, 32)
    bg = np.zeros(3, np.float32)
    jargs, targs, cov6, jcfg, tcfg = _both(
        dict(SMALL, backend="pallas", binning="origin"), image_shape, bg, n=200)
    rng = np.random.default_rng(7)
    rot = rng.normal(0, 0.01, (2, 3)).astype(np.float32)
    tra = rng.normal(0, 0.01, (2, 3)).astype(np.float32)

    def jloss(means, opac, r, t):
        c, d, a = jrender(means, None, jargs[2], opac, *jargs[4:], image_shape,
                          tuple(bg.tolist()), 2, cam_rot_delta=r, cam_trans_delta=t,
                          cfg=jcfg, cov6=cov6)
        return (c ** 2).sum() + 1e-2 * d.sum() + a.sum()

    gj = jax.grad(jloss, argnums=(0, 1, 2, 3))(jargs[0], jargs[3],
                                               jnp.asarray(rot), jnp.asarray(tra))
    leaves = [targs[0].clone().requires_grad_(), targs[3].clone().requires_grad_(),
              torch.from_numpy(rot).requires_grad_(),
              torch.from_numpy(tra).requires_grad_()]
    c, d, a = trender(leaves[0], targs[1], targs[2], leaves[1], *targs[4:],
                      image_shape, torch.from_numpy(bg), 2, cam_rot_delta=leaves[2],
                      cam_trans_delta=leaves[3], cfg=tcfg)
    ((c ** 2).sum() + 1e-2 * d.sum() + a.sum()).backward()
    for name, t, j in zip(("means", "opacities", "rot", "trans"), leaves, gj):
        j = np.asarray(j)
        assert np.abs(j).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=0,
                                   atol=GRAD_TOL * np.abs(j).max(), err_msg=name)


def test_accelerator_render_background_grad_matches_jax():
    """A learnable background through K2's autograd function (the port's
    Pallas path), against jax.grad through the JAX package's XLA path: the
    JAX Pallas path takes the background as a static tuple and has no such
    gradient. The colour is T_final * background plus the splats' part in
    both, so the gradients are the same function."""
    image_shape = (32, 32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jargs, targs, cov6, _, tcfg = _both(
        dict(SMALL, backend="pallas", binning="origin"), image_shape, bg, n=200)
    jcfg = JRasterCfg(**dict(SMALL, backend="xla", binning="origin"))

    def jloss(b):
        c, d, _ = jrender(*jargs, image_shape, b, 2, cfg=jcfg, cov6=cov6)
        return (c ** 2).sum() + 1e-2 * d.sum()

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(bg)))
    leaf = torch.from_numpy(bg).requires_grad_()
    c, d, _ = trender(*targs, image_shape, leaf, 2, cfg=tcfg)
    ((c ** 2).sum() + 1e-2 * d.sum()).backward()
    assert np.abs(gj).min() > 0
    np.testing.assert_allclose(leaf.grad.numpy(), gj, rtol=0,
                               atol=GRAD_TOL * np.abs(gj).max())


def test_config_converts_from_jax():
    """Every field and value of the JAX config carries over by name."""
    jcfg = JRasterCfg(backend="pallas", binning="origin", pallas_chunk=64)
    tcfg = TRasterCfg(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("field,value", [("backend", "cuda"),
                                         ("binning", "radix"),
                                         ("tail_backend", "triton"),
                                         ("head_tail_backend", "triton")])
def test_unknown_backend_names_raise(field, value):
    from vicasplat_tpu_torch.models.heads import DPTConfig
    from vicasplat_tpu_torch.models.vicasplat import VicaSplatConfig

    if field == "tail_backend":
        make = lambda: DPTConfig(tail_backend=value)  # noqa: E731
    elif field == "head_tail_backend":
        make = lambda: VicaSplatConfig(head_tail_backend=value).gs_dpt()  # noqa: E731
    else:
        make = lambda: TRasterCfg(**{field: value})  # noqa: E731
    with pytest.raises(ValueError):
        make()
