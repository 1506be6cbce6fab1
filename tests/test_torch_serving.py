"""Parity of the port's serving engine (vicasplat_tpu_torch/serving.py) with
the JAX package's InferenceEngine, in float32 on the CPU at the tiny config:
reconstruct and render, the program cache, the HTTP routes on loopback
(float32 and JPEG payloads), the bad-request and not-ported answers, and
the adaptive rasterizer caps."""
import io
import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import IMG_TOL, TOL, perturbed_params, tiny_cfgs
from vicasplat_tpu import serving as jserving
from vicasplat_tpu.decoder.splatting import DecoderSplattingConfig as JDecCfg
from vicasplat_tpu.models.adapter import Gaussians as JGaussians
from vicasplat_tpu.ops.rasterize import RasterizeConfig as JRasterCfg
from vicasplat_tpu_torch import serving as tserving
from vicasplat_tpu_torch.decoder.splatting import DecoderSplattingConfig as TDecCfg
from vicasplat_tpu_torch.models.adapter import Gaussians as TGaussians
from vicasplat_tpu_torch.ops.rasterize import RasterizeConfig as TRasterCfg

torch.set_num_threads(1)

K1 = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32)


def inputs(B=1, T=3, size=32, seed=0):
    images = np.random.default_rng(seed).uniform(0, 1, (B, T, size, size, 3))
    return images.astype(np.float32), np.ascontiguousarray(np.broadcast_to(K1, (B, T, 3, 3)))


def target_views(B=1, V=3):
    """Cameras backed off along -z, so that the splats land in the views."""
    ext = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    ext[:, :, 2, 3] = np.linspace(-8.0, -4.0, V)
    return ext, np.ascontiguousarray(np.broadcast_to(K1, (B, V, 3, 3)))


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = tiny_cfgs()
    params = perturbed_params(jcfg)
    return (jserving.InferenceEngine(jcfg, params=params, dtype=jnp.float32),
            tserving.InferenceEngine(tcfg, params=params, dtype=torch.float32,
                                     device="cpu"))


def close(t, j, tol=TOL, msg=""):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), atol=tol, rtol=tol, err_msg=msg)


def test_reconstruct_and_render_match_jax(engines):
    je, te = engines
    images, K = inputs()
    js, ts = je.reconstruct(images, K), te.reconstruct(images, K)
    assert ts.poses.shape == (1, 3, 4, 4)
    np.testing.assert_allclose(ts.poses[0, 0].numpy(), np.eye(4), atol=1e-6)
    close(ts.poses, js.poses, msg="poses")
    assert ts.intrinsics is None and js.intrinsics is None
    for name in TGaussians._fields:
        close(getattr(ts.gaussians, name), getattr(js.gaussians, name), msg=name)
    # the render on the same Gaussians (JAX's), since the 1/255 alpha cut
    # turns the reconstructions' float32 rounding gaps into step changes
    same = tserving.SceneBatch(gaussians=TGaussians(
        *(torch.tensor(np.asarray(x)) for x in js.gaussians)), poses=ts.poses,
        intrinsics=None)
    ext, tK = target_views()
    jo, to = je.render(js, ext, tK, (32, 32)), te.render(same, ext, tK, (32, 32))
    assert to.color.shape == (1, 3, 32, 32, 3)
    assert float(np.asarray(jo.alpha).max()) > 0.1  # splats land in the views
    for name in ("color", "depth", "alpha"):
        close(getattr(to, name), getattr(jo, name), IMG_TOL, name)


def test_program_cache_reuse_and_eviction(engines):
    _, te = engines
    images, K = inputs()
    te.reconstruct(images, K)
    f1 = te._reconstruct_fn(images.shape, K.shape)
    calls = f1.calls
    te.reconstruct(images, K)
    assert te._reconstruct_fn(images.shape, K.shape) is f1
    assert f1.calls == calls + 1
    # a ninth shape evicts the least recently used program
    progs = [te._render_fn((1, v, 4, 4), (32, 32)) for v in range(1, 9)]
    assert te._render_fn((1, 1, 4, 4), (32, 32)) is progs[0]  # refreshed
    te._render_fn((1, 9, 4, 4), (32, 32))
    assert te._render_fn((1, 1, 4, 4), (32, 32)) is progs[0]
    assert te._render_fn((1, 2, 4, 4), (32, 32)) is not progs[1]  # evicted


def test_throughput_reports_method(engines):
    _, te = engines
    images, K = inputs()
    r = te.throughput(images, K, iters=3)
    assert r["method"] == "eager" and r["batch"] == 1
    assert r["latency_s"] > 0 and r["scenes_per_s"] > 0


def post(srv, path, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}{path}",
                                 data=buf.getvalue(), method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=120).read())


@pytest.fixture(scope="module")
def servers(engines):
    srvs = [jserving.serve(e, port=0, block=False) if i == 0 else
            tserving.serve(e, port=0, block=False) for i, e in enumerate(engines)]
    yield srvs
    for s in srvs:
        s.shutdown()
        s.server_close()


def test_reconstruct_endpoint_matches_jax(servers):
    images, K = inputs(B=2, seed=1)
    jb, tb = (post(s, "/reconstruct", images=images, intrinsics=K) for s in servers)
    assert set(tb) == set(jb)
    assert tb["num_gaussians"] == jb["num_gaussians"] == 2 * 3 * 32 * 32
    close(np.asarray(tb["poses"]), jb["poses"], msg="poses")
    close(np.asarray(tb["centers_mean"]), jb["centers_mean"], msg="centers_mean")
    assert tb["latency_s"] > 0


def test_reconstruct_jpeg_endpoint_matches_jax(servers):
    """A compressed request (the frames as one JPEG byte stream, their
    sizes and (B, T)): the port decodes with its own codec the pixels the
    JAX server gets from libjpeg, so the answers agree as for float32."""
    from PIL import Image

    images, K = inputs(B=2, seed=2)
    bufs = []
    for frame in images.reshape(-1, 32, 32, 3):
        b = io.BytesIO()
        Image.fromarray((frame * 255).astype(np.uint8)).save(b, format="JPEG", quality=90)
        bufs.append(np.frombuffer(b.getvalue(), np.uint8))
    body = dict(jpeg_data=np.concatenate(bufs), jpeg_sizes=np.array([len(b) for b in bufs]),
                batch_shape=np.array([2, 3]), intrinsics=K)
    jb, tb = (post(s, "/reconstruct", **body) for s in servers)
    assert set(tb) == set(jb)
    close(np.asarray(tb["poses"]), jb["poses"], msg="poses")
    close(np.asarray(tb["centers_mean"]), jb["centers_mean"], msg="centers_mean")


def test_reconstruct_video_endpoint_matches_jax(servers):
    F = 5
    frames = np.random.default_rng(3).uniform(0, 1, (F, 32, 32, 3)).astype(np.float32)
    K = np.ascontiguousarray(np.broadcast_to(K1, (F, 3, 3)))
    body = dict(images=frames, intrinsics=K, window=np.int64(3), overlap=np.int64(2))
    jb, tb = (post(s, "/reconstruct_video", **body) for s in servers)
    assert set(tb) == set(jb)
    assert len(tb["poses"]) == F and tb["num_gaussians"] == jb["num_gaussians"]
    np.testing.assert_allclose(np.asarray(tb["poses"][0]), np.eye(4), atol=1e-6)
    close(np.asarray(tb["poses"]), jb["poses"], msg="poses")
    close(np.asarray(tb["window_scales"]), jb["window_scales"], msg="window_scales")


def test_bad_requests(servers):
    srv = servers[1]
    with pytest.raises(urllib.error.HTTPError) as ei:  # fewer frames than the window
        post(srv, "/reconstruct_video", images=np.zeros((3, 32, 32, 3), np.float32))
    assert ei.value.code == 400
    assert "need >=" in json.loads(ei.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as ei:  # no images
        post(srv, "/reconstruct", intrinsics=K1)
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:  # not a JPEG stream
        post(srv, "/reconstruct", jpeg_data=np.zeros(8, np.uint8),
             jpeg_sizes=np.array([8]), batch_shape=np.array([1, 1]))
    assert ei.value.code == 400
    assert "JPEG frame 0" in json.loads(ei.value.read())["error"]
    # a header-only stream declaring 65535^2: refused before any allocation
    huge = (b"\xff\xd8\xff\xc0\x00\x11\x08\xff\xff\xff\xff\x03"
            b"\x01\x22\x00\x02\x11\x01\x03\x11\x01\xff\xd9")
    with pytest.raises(urllib.error.HTTPError) as ei:
        post(srv, "/reconstruct", jpeg_data=np.frombuffer(huge * 8, np.uint8),
             jpeg_sizes=np.array([len(huge)] * 8), batch_shape=np.array([1, 8]))
    assert ei.value.code == 400
    assert "larger than the limit" in json.loads(ei.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        post(srv, "/nowhere", images=np.zeros(1, np.float32))
    assert ei.value.code == 404


def test_view_mesh_raises(engines, tmp_path):
    """A view_mesh engine (a world-1 gloo group) renders what the plain
    engine renders, bit for bit; two weight sources still raise."""
    import torch.distributed as dist

    from vicasplat_tpu_torch.parallel import make_mesh

    _, tcfg = tiny_cfgs()
    _, te = engines
    images, K = inputs()
    scene = te.reconstruct(images, K)
    ext, tK = target_views()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        ve = tserving.InferenceEngine(tcfg, model=te.model, dtype=torch.float32,
                                      view_mesh=make_mesh(), device="cpu")
        got, want = ve.render(scene, ext, tK, (32, 32)), te.render(scene, ext, tK, (32, 32))
    finally:
        dist.destroy_process_group()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="at most one"):
        tserving.InferenceEngine(tcfg, params={}, ckpt="x.npz", device="cpu")


def caps_scenes():
    """The JAX engine test's dense scene (300 fat, overlapping, opaque
    splats in front of the camera) and sparse one (small splats spread over
    the image plane), made with numpy."""
    rng = np.random.default_rng(3)
    n = 300
    means = rng.normal(0, 0.02, (1, n, 3)) + np.array([0.0, 0.0, 3.0])
    harm = rng.normal(0, 0.3, (1, n, 3, 1))
    rot = np.broadcast_to(np.array([1.0, 0.0, 0.0, 0.0]), (1, n, 4))
    spread = rng.uniform(-1.2, 1.2, (1, n, 2))
    sparse_means = np.concatenate([spread * means[..., 2:3], means[..., 2:3]], -1)
    return {"dense": (means, np.full((1, n, 3), 0.15)),
            "sparse": (sparse_means, np.full((1, n, 3), 0.01))}, harm, rot


@pytest.mark.parametrize("which", ["dense", "sparse"])
def test_adaptive_caps_match_jax(which):
    jcfg, tcfg = tiny_cfgs()
    base = dict(tile_px=8, dup_hw=(2, 2), max_per_tile=64, chunk=32, tile_group=16)
    je = jserving.InferenceEngine(jcfg, dtype=jnp.float32, adaptive_caps=True,
                                  decoder=JDecCfg(rasterize=JRasterCfg(**base)))
    te = tserving.InferenceEngine(tcfg, dtype=torch.float32, adaptive_caps=True,
                                  device="cpu",
                                  decoder=TDecCfg(rasterize=TRasterCfg(**base)))
    scenes, harm, rot = caps_scenes()
    means, scales = scenes[which]
    n = means.shape[1]
    arrays = dict(means=means, harmonics=harm, opacities=np.full((1, n), 0.9),
                  scales=scales, rotations=rot)
    ext = np.broadcast_to(np.eye(4, dtype=np.float32), (1, 1, 4, 4))
    K = np.array([[1.2, 0.0, 0.5], [0.0, 1.2, 0.5], [0.0, 0.0, 1.0]], np.float32)
    K = np.broadcast_to(K, (1, 1, 3, 3))
    jg = JGaussians(covariances=None,
                    **{k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()})
    tg = TGaussians(covariances=None,
                    **{k: torch.tensor(v, dtype=torch.float32) for k, v in arrays.items()})
    js = jserving.SceneBatch(gaussians=jg, poses=jnp.asarray(ext), intrinsics=K)
    ts = tserving.SceneBatch(gaussians=tg, poses=torch.tensor(ext), intrinsics=K)
    je.render(js, ext, K, (64, 64))
    out = te.render(ts, ext, K, (64, 64))
    assert ts.raster_cfg.dup_hw == js.raster_cfg.dup_hw
    assert ts.raster_cfg.max_per_tile == js.raster_cfg.max_per_tile
    if which == "dense":
        assert max(ts.raster_cfg.dup_hw) > 2 and ts.raster_cfg.max_per_tile > 64
    else:
        assert ts.raster_cfg.dup_hw == (2, 2) and ts.raster_cfg.max_per_tile == 64
    assert out.color.shape == (1, 1, 64, 64, 3) and torch.isfinite(out.color).all()
    sel = ts.raster_cfg
    te.render(ts, ext, K, (64, 64))
    assert ts.raster_cfg is sel  # probed once per scene
