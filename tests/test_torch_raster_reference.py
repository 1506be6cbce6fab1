"""The port's brute-force render oracle (ops/rasterize/reference.py) against
the JAX package's, the port's tiled render against its own oracle (as
tests/test_rasterizer.py holds JAX's), the packed row gather against JAX's,
and the rigid camera transforms. Float32 on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicasplat_tpu.geometry import projection as jgeo
from vicasplat_tpu.models.adapter import build_covariance
from vicasplat_tpu.ops.rasterize import RasterizeConfig as JRasterCfg
from vicasplat_tpu.ops.rasterize import render as jrender
from vicasplat_tpu.ops.rasterize import reference as jref
from vicasplat_tpu.ops.rasterize import tiles as jtiles
from vicasplat_tpu_torch.geometry import projection as tgeo
from vicasplat_tpu_torch.ops.rasterize import reference as tref
from vicasplat_tpu_torch.ops.rasterize import tiles as ttiles
from vicasplat_tpu_torch.ops.rasterize.projection import cov6_from_matrix
from vicasplat_tpu_torch.ops.rasterize.render import (RasterizeConfig, coverage_stats,
                                                      render)

torch.set_num_threads(1)

# oracle against oracle: the same float32 formulas, summed by two matmul
# orders over <= 64 splats a pixel (tests/test_torch_render.py's rule)
IMG_TOL = 1e-4
# tiled render against the oracle: JAX's own tolerances
# (tests/test_rasterizer.py:58-60); the tiles' caps and K2's early stop at
# transmittance 1e-4 sit inside them
TILED = {"color": 2e-3, "alpha": 2e-3, "depth": 2e-2}
# packed against exact rows: bf16 alpha and colour (tests/test_rasterizer.py:389)
PACKED = {"color": 1.5e-2, "alpha": 1.5e-2, "depth": 5e-2}
# gradients through the packed gather, port against JAX, relative to the
# largest entry (tests/test_torch_render.py's GRAD_TOL)
GRAD_TOL = 1e-3
BG = np.zeros(3, np.float32)
K = np.array([[1.2, 0.0, 0.5], [0.0, 1.2, 0.5], [0.0, 0.0, 1.0]], np.float32)
CFG = dict(tile_px=8, dup_hw=(4, 4), max_per_tile=64, chunk=32, tile_group=16,
           pallas_chunk=32)


def make_scene(seed=0, n=64):
    """tests/test_rasterizer.py:13's scene, drawn with numpy."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    means[:, 2] += 3.0
    scales = rng.uniform(0.02, 0.1, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    covs = np.array(build_covariance(jnp.asarray(scales), jnp.asarray(quats)))
    sh = (rng.normal(size=(n, 3, 1)) * 0.3).astype(np.float32)
    opac = rng.uniform(0.3, 0.9, n).astype(np.float32)
    return means, covs, sh, opac


def _torch(means, covs, sh, opac):
    t = torch.from_numpy
    return t(means), cov6_from_matrix(t(covs)), t(sh), t(opac)


@pytest.mark.parametrize("shape", [(32, 32), (24, 40)])
def test_bruteforce_matches_jax(shape):
    means, covs, sh, opac = make_scene(0)
    args = (jnp.eye(4), jnp.asarray(K), shape, jnp.asarray(BG), 0)
    ref = jref.render_view_bruteforce(*map(jnp.asarray, (means, covs, sh, opac)),
                                      *args)
    ref_c = jref.render_view_bruteforce_chunked(
        *map(jnp.asarray, (means, covs, sh, opac)), *args, px_chunk=100)
    targs = (torch.eye(4), torch.from_numpy(K), shape, torch.from_numpy(BG), 0)
    got = tref.render_view_bruteforce(*_torch(means, covs, sh, opac), *targs)
    got_c = tref.render_view_bruteforce_chunked(*_torch(means, covs, sh, opac),
                                                *targs, px_chunk=100)
    for a, b, c, d in zip(got, ref, got_c, ref_c):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=IMG_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(d), atol=IMG_TOL)
        # the chunks change nothing but the pairwise buffers' extent
        np.testing.assert_array_equal(a.numpy(), c.numpy())
    assert float(got[2].max()) > 0.5  # the scene covers the view


@pytest.mark.parametrize("binning", ["dup_sort", "origin"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("seed,n", [(0, 64), (3, 4)])
def test_tiled_render_matches_oracle(backend, binning, seed, n):
    """The matmul compositing and K2's plain version, through either
    binning, against the oracle (tests/test_rasterizer.py:41-60, :85-101)."""
    means, covs, sh, opac = make_scene(seed, n)
    m, c6, s, o = _torch(means, covs, sh, opac)
    dup = (4, 4) if n > 4 else (2, 2)
    cfg = RasterizeConfig(**dict(CFG, dup_hw=dup), backend=backend, binning=binning)
    color, depth, alpha = render(m, c6, s, o, torch.eye(4)[None],
                                 torch.from_numpy(K)[None], (32, 32),
                                 torch.from_numpy(BG), 0, cfg=cfg)
    rc, rd, ra = tref.render_view_bruteforce(m, c6, s, o, torch.eye(4),
                                             torch.from_numpy(K), (32, 32),
                                             torch.from_numpy(BG), 0)
    np.testing.assert_allclose(color[0].numpy(), rc.numpy(), atol=TILED["color"])
    np.testing.assert_allclose(alpha[0].numpy(), ra.numpy(), atol=TILED["alpha"])
    np.testing.assert_allclose(depth[0].numpy(), rd.numpy(), atol=TILED["depth"])


@pytest.mark.parametrize("near_first", [True, False])
@pytest.mark.parametrize("binning", ["dup_sort", "origin"])
def test_tiled_render_orders_close_depths_exactly(binning, near_first):
    """Two overlapping splats of opposite colours whose depths are 12 ulp
    apart: the same word in the JAX package's u32 keys, so their order there
    is the sort's. The port's keys order them exactly, either index first.
    Opacity 0.3 keeps alpha under 1/255 beyond 3 sigma, so the oracle and
    the tiles give each splat the same pixels."""
    far = np.float32(3.0).view(np.uint32) + np.uint32(12)
    depths = np.array([3.0, far.view(np.float32)], np.float32)
    if not near_first:
        depths = depths[::-1].copy()
    means = np.array([[0.0, 0.0, 0.0], [0.1, 0.05, 0.0]], np.float32)
    means[:, 2] = depths
    covs = np.tile(np.eye(3, dtype=np.float32) * 0.1 ** 2, (2, 1, 1))
    sh = np.array([[[1.5]] * 3, [[-1.5]] * 3], np.float32)
    opac = np.full(2, 0.3, np.float32)
    m, c6, s, o = _torch(means, covs, sh, opac)
    for backend in ("xla", "pallas"):
        cfg = RasterizeConfig(**CFG, backend=backend, binning=binning)
        got = render(m, c6, s, o, torch.eye(4)[None], torch.from_numpy(K)[None],
                     (32, 32), torch.from_numpy(BG), 0, cfg=cfg)
        ref = tref.render_view_bruteforce(m, c6, s, o, torch.eye(4),
                                          torch.from_numpy(K), (32, 32),
                                          torch.from_numpy(BG), 0)
        for name, a, r in zip(("color", "depth", "alpha"), got, ref):
            np.testing.assert_allclose(a[0].numpy(), r.numpy(), atol=TILED[name],
                                       err_msg=f"{backend} {name}")


def test_tiled_render_matches_oracle_on_dense_scene():
    """chip_smoke.py's 1,000-splat scene (SH degree 4, 96 x 128, 2 views) at
    dup (4, 4), where coverage_stats reports no splat truncated and no tile
    full: both binnings and both compositings against the oracle with the
    tiles' 3-sigma support, within the tolerance above. The oracle without
    that support differs on view 0 by splats of opacity near 1 that pass
    1/255 up to 3.24 sigma from their centre, in tiles their rect misses."""
    from chip_smoke import small_scene

    means, cov6, sh, opac, ext, Kc = small_scene()
    bg = torch.zeros(3)
    for v in range(ext.shape[0]):
        view = torch.linalg.inv(ext[v])
        ref = tref.render_view_bruteforce(means, cov6, sh, opac, view, Kc[v],
                                          (96, 128), bg, 4, support_tile_px=16)
        for binning in ("dup_sort", "origin"):
            for backend in ("xla", "pallas"):
                cfg = RasterizeConfig(dup_hw=(4, 4), backend=backend, binning=binning)
                cov = coverage_stats(means, cov6, sh, opac, view, Kc[v], (96, 128), 4,
                                     cfg=cfg)
                assert float(cov["truncated_frac"]) == 0.0
                assert float(cov["tile_overflow_frac"]) == 0.0
                got = render(means, cov6, sh, opac, ext[v:v + 1], Kc[v:v + 1],
                             (96, 128), bg, 4, cfg=cfg)
                for name, a, r in zip(("color", "depth", "alpha"), got, ref):
                    np.testing.assert_allclose(
                        a[0].numpy(), r.numpy(), atol=TILED[name],
                        err_msg=f"view {v} {binning} {backend} {name}")


def test_oracle_tile_support():
    """support_tile_px only removes contributions: with one tile covering
    the image it is the plain oracle; with 8-pixel tiles it differs from it
    only where a splat's rect misses the pixel's tile, and the chunked form
    computes the same thing."""
    means, covs, sh, opac = make_scene(0)
    m, c6, s, o = _torch(means, covs, sh, opac)
    args = (m, c6, s, o, torch.eye(4), torch.from_numpy(K), (32, 32),
            torch.from_numpy(BG), 0)
    plain = tref.render_view_bruteforce(*args)
    whole = tref.render_view_bruteforce(*args, support_tile_px=64)
    for a, b in zip(plain, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    tiled = tref.render_view_bruteforce(*args, support_tile_px=8)
    chunked = tref.render_view_bruteforce_chunked(*args, px_chunk=100,
                                                  support_tile_px=8)
    for a, b in zip(tiled, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float((tiled[2] - plain[2]).max()) <= 0.0  # less coverage, never more


def test_pack_words_match_jax():
    p = np.random.default_rng(5).normal(size=(64, 16)).astype(np.float32)
    words = ttiles._pack_words(torch.from_numpy(p))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(jtiles._pack_words(jnp.asarray(p)))
                                  .view(np.uint32))
    back = ttiles._unpack_words(words).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jtiles._unpack_words(jtiles._pack_words(jnp.asarray(p)))))
    for col in (0, 1, 2, 3, 4, 9):  # geometry and depth exact
        np.testing.assert_array_equal(back[:, col], p[:, col])


@pytest.mark.parametrize("binning", ["dup_sort", "origin"])
def test_packed_render_matches_jax(binning):
    means, covs, sh, opac = make_scene(11)
    kw = dict(CFG, binning=binning)
    jout = jrender(*map(jnp.asarray, (means, covs, sh, opac)), jnp.eye(4)[None],
                   jnp.asarray(K)[None], (32, 32), jnp.asarray(BG), sh_degree=0,
                   cfg=JRasterCfg(packed_gather=True, **kw))
    args = (*_torch(means, covs, sh, opac), torch.eye(4)[None],
            torch.from_numpy(K)[None], (32, 32), torch.from_numpy(BG), 0)
    packed = render(*args, cfg=RasterizeConfig(packed_gather=True, **kw))
    exact = render(*args, cfg=RasterizeConfig(**kw))
    for name, a, b, e in zip(("color", "depth", "alpha"), packed, jout, exact):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=IMG_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=PACKED[name])


def test_packed_gradients_match_jax():
    means, covs, sh, opac = make_scene(12, 32)
    jcfg = JRasterCfg(tile_px=8, dup_hw=(3, 3), max_per_tile=64, chunk=32,
                      tile_group=4, packed_gather=True)

    def jloss(m, s, o):
        c, _, _ = jrender(m, jnp.asarray(covs), s, o, jnp.eye(4)[None],
                          jnp.asarray(K)[None], (16, 16), jnp.asarray(BG),
                          sh_degree=0, cfg=jcfg)
        return (c ** 2).sum()

    gj = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (means, sh, opac)))
    m, c6, s, o = (x.requires_grad_(x.dtype.is_floating_point)
                   for x in _torch(means, covs, sh, opac))
    c6 = c6.detach()
    c, _, _ = render(m, c6, s, o, torch.eye(4)[None], torch.from_numpy(K)[None],
                     (16, 16), torch.from_numpy(BG), 0,
                     cfg=RasterizeConfig(**dataclasses.asdict(jcfg)))
    (c ** 2).sum().backward()
    for t, j in zip((m, s, o), gj):
        j = np.asarray(j)
        np.testing.assert_allclose(t.grad.numpy(), j,
                                   atol=GRAD_TOL * np.abs(j).max())


def test_camera_transforms_match_jax():
    rng = np.random.default_rng(7)
    c2w = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for i in range(3):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w[i, :3, :3] = q
        c2w[i, :3, 3] = rng.normal(size=3)
    pts = rng.normal(size=(3, 5, 3)).astype(np.float32)
    xh = np.asarray(jgeo.homogenize_points(jnp.asarray(pts)))
    for jf, tf in ((jgeo.transform_cam2world, tgeo.transform_cam2world),
                   (jgeo.transform_world2cam, tgeo.transform_world2cam)):
        want = np.asarray(jf(jnp.asarray(xh), jnp.asarray(c2w)[:, None]))
        got = tf(torch.from_numpy(xh), torch.from_numpy(c2w)[:, None]).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
    back = tgeo.transform_cam2world(
        tgeo.transform_world2cam(torch.from_numpy(xh), torch.from_numpy(c2w)[:, None]),
        torch.from_numpy(c2w)[:, None])
    np.testing.assert_allclose(back.numpy(), xh, atol=1e-5)
