"""The port's evaluation math against the JAX package on the CPU: SSIM and
its components with their gradients (loss/ssim.py), every function of
evaluation/metrics.py, the rasterizer's coverage statistics, the SE(3)
retraction of the pose evaluator, and the PNG writer read back by PIL."""
import importlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vicasplat_tpu.evaluation import metrics as jm
from vicasplat_tpu.geometry import se3 as jse3
from vicasplat_tpu.ops.rasterize import projection as jproj
from vicasplat_tpu.ops.rasterize.render import RasterizeConfig as JRasterCfg
from vicasplat_tpu.ops.rasterize.render import coverage_stats as jcoverage
from vicasplat_tpu.utils.ply import export_ply as jexport_ply
from vicasplat_tpu_torch.evaluation import metrics as tm
from vicasplat_tpu_torch.geometry import se3 as tse3
from vicasplat_tpu_torch.loss import ssim as tssim
from vicasplat_tpu_torch.ops.rasterize import projection as tproj
from vicasplat_tpu_torch.ops.rasterize.render import RasterizeConfig as TRasterCfg
from vicasplat_tpu_torch.ops.rasterize.render import coverage_stats as tcoverage
from vicasplat_tpu_torch.utils.benchmarker import Benchmarker
from vicasplat_tpu_torch.utils.image_io import encode_png, hcat, save_image, to_uint8, vcat
from vicasplat_tpu_torch.utils.ply import export_ply

torch.set_num_threads(1)

# the package exports the function `ssim` under the module's name
jssim = importlib.import_module("vicasplat_tpu.loss.ssim")

# float32 on both sides, the same windows summed in other orders (XLA's
# depthwise convolution against cuDNN-free torch conv2d on the CPU)
SSIM_TOL = 1e-5
# gradients of the same: relative to the largest entry
SSIM_GRAD_TOL = 1e-4


def _images(seed, shape=(2, 3, 24, 20, 3), smooth=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, shape), 0, 1).astype(np.float32)
    if smooth:  # constant windows: variance 0, where the bound's sqrt' is inf
        a[..., :12, :, :] = 0.5
        b[..., :12, :, :] = 0.25
    return a, b


@pytest.mark.parametrize("smooth", [False, True])
def test_ssim_and_gradients_match_jax(smooth):
    a, b = _images(0, smooth=smooth)
    want, (ga, gb) = jax.value_and_grad(jssim.ssim, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    got = tssim.ssim(ta, tb)
    got.backward()
    assert abs(got.item() - float(want)) < SSIM_TOL
    for t, j in ((ta.grad, ga), (tb.grad, gb)):
        j = np.asarray(j)
        assert np.isfinite(t.numpy()).all()
        assert np.abs(t.numpy() - j).max() / np.abs(j).max() < SSIM_GRAD_TOL


def test_ssim_grad_finite_on_all_zero_images():
    """tests/test_losses.py:138 on the port: an all-zero image against a
    textured one, zero against zero, and a half-constant image; every
    gradient finite, and each pair's value and gradients as JAX's."""
    rng = np.random.default_rng(3)
    gt = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    zero = np.zeros_like(gt)
    mixed = gt.copy()
    mixed[16:] = 0.25
    for pred, target in ((zero, gt), (zero, zero), (mixed, gt)):
        want, jg = jax.value_and_grad(jssim.ssim)(jnp.asarray(pred), jnp.asarray(target))
        tp = torch.from_numpy(pred.copy()).requires_grad_()
        got = tssim.ssim(tp, torch.from_numpy(target))
        got.backward()
        assert np.isfinite(tp.grad.numpy()).all()
        assert abs(got.item() - float(want)) < SSIM_TOL
        jg = np.asarray(jg)
        assert np.abs(tp.grad.numpy() - jg).max() <= SSIM_GRAD_TOL * max(
            np.abs(jg).max(), 1.0)


def test_ssim_components_and_gradients_match_jax():
    a, b = _images(1, shape=(4, 32, 32, 3))
    want = jssim.ssim_components(jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    got = tssim.ssim_components(ta, tb)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k].item() - float(want[k])) < SSIM_TOL, k
    jg = jax.grad(lambda x, y: jssim.ssim_components(x, y)["structure"])(
        jnp.asarray(a), jnp.asarray(b))
    got["structure"].backward()
    jg = np.asarray(jg)
    assert np.abs(ta.grad.numpy() - jg).max() / np.abs(jg).max() < SSIM_GRAD_TOL


def test_image_metrics_match_jax():
    a, b = _images(2)
    np.testing.assert_allclose(
        tm.compute_psnr(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jm.compute_psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    assert abs(tm.compute_ssim(torch.from_numpy(a), torch.from_numpy(b)).item()
               - float(jm.compute_ssim(jnp.asarray(a), jnp.asarray(b)))) < SSIM_TOL


def _trajectory(rng, n, noise):
    tau = rng.normal(0, 0.2, (n, 6))
    gt = np.asarray(jse3.se3_exp(jnp.asarray(tau, jnp.float32)), np.float64)
    pred = gt.copy()
    pred[:, :3, 3] = 1.7 * pred[:, :3, 3] + rng.normal(0, noise, (n, 3))
    rot = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(0, noise, (n, 3)),
                                              jnp.float32)), np.float64)
    pred[:, :3, :3] = rot @ pred[:, :3, :3]
    return gt, pred


@pytest.mark.parametrize("n,noise", [(8, 0.05), (4, 0.2), (2, 0.0), (1, 0.1)])
def test_trajectory_metrics_match_jax(n, noise):
    """The numpy parts are copies: equal to the last bit, degenerate
    trajectories (one or two frames) included."""
    rng = np.random.default_rng(n)
    gt, pred = _trajectory(rng, n, noise)
    got, want = tm.camera_eval_metrics(gt, pred), jm.camera_eval_metrics(gt, pred)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    x, y = rng.normal(size=(3, 9)), rng.normal(size=(3, 9))
    for a, b in zip(tm.umeyama_alignment(x, y), jm.umeyama_alignment(x, y)):
        np.testing.assert_array_equal(a, b)
    assert tm.ate(gt, pred) == jm.ate(gt, pred)
    assert tm.rpe(gt, pred) == jm.rpe(gt, pred)
    np.testing.assert_array_equal(tm.rotation_angle_deg(gt[:, :3, :3], pred[:, :3, :3]),
                                  jm.rotation_angle_deg(gt[:, :3, :3], pred[:, :3, :3]))
    np.testing.assert_array_equal(tm.translation_angle_deg(gt[:, :3, 3], pred[:, :3, 3]),
                                  jm.translation_angle_deg(gt[:, :3, 3], pred[:, :3, 3]))
    errs = rng.uniform(0, 40, 50)
    assert tm.pose_auc(errs, (5, 10, 20, 30)) == jm.pose_auc(errs, (5, 10, 20, 30))


def test_se3_retraction_matches_jax():
    rng = np.random.default_rng(3)
    theta = rng.normal(0, 0.5, (6, 3)).astype(np.float32)
    theta[0] = 0.0  # the Taylor branch
    for fn in ("so3_exp", "so3_left_jacobian"):
        np.testing.assert_allclose(getattr(tse3, fn)(torch.from_numpy(theta)).numpy(),
                                   np.asarray(getattr(jse3, fn)(jnp.asarray(theta))),
                                   atol=1e-6, err_msg=fn)
    ext = np.array(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.3, (6, 6)), jnp.float32)))
    trans = rng.normal(0, 0.1, (6, 3)).astype(np.float32)
    got = tse3.update_pose(torch.from_numpy(trans), torch.from_numpy(theta),
                           torch.from_numpy(ext)).numpy()
    want = np.asarray(jse3.update_pose(jnp.asarray(trans), jnp.asarray(theta),
                                       jnp.asarray(ext)))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape,dup_hw,max_per_tile", [((64, 64), (2, 2), 256),
                                                       ((48, 80), (3, 2), 16)])
def test_coverage_stats_match_jax(shape, dup_hw, max_per_tile):
    """Live, truncated and overflowing shares of one view of 2,000 random
    splats with SH degree 1; the counts are equal (ratios of the same
    integers), the occupancy mean within float32 rounding."""
    rng = np.random.default_rng(4)
    n = 2000
    means = (rng.uniform(-1, 1, (n, 3)) * [1.5, 1.5, 1.0] + [0, 0, 3.0]).astype(np.float32)
    scales = np.exp(rng.normal(np.log(0.05), 0.6, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    sh = rng.normal(0, 0.5, (n, 3, 4)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0.1, -0.05, 0.2]
    K = np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32)
    kw = dict(dup_hw=dup_hw, max_per_tile=max_per_tile)
    cov = np.asarray(jproj.cov6_from_scale_rot(jnp.asarray(scales), jnp.asarray(quats)))
    cov33 = np.zeros((n, 3, 3), np.float32)
    for (i, j), c in zip(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)), cov.T):
        cov33[:, i, j] = cov33[:, j, i] = c
    want = jcoverage(jnp.asarray(means), jnp.asarray(cov33), jnp.asarray(sh),
                     jnp.asarray(opac), jnp.asarray(view), jnp.asarray(K), shape, 1,
                     cfg=JRasterCfg(**kw))
    got = tcoverage(torch.from_numpy(means),
                    tproj.cov6_from_scale_rot(torch.from_numpy(scales),
                                              torch.from_numpy(quats)),
                    torch.from_numpy(sh), torch.from_numpy(opac), torch.from_numpy(view),
                    torch.from_numpy(K), shape, 1, cfg=TRasterCfg(**kw))
    assert sorted(got) == sorted(want)
    assert 0 < float(want["truncated_frac"]) < 1
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 9)])
def test_png_reads_back_through_pil(tmp_path, shape):
    rng = np.random.default_rng(5)
    image = rng.uniform(-0.1, 1.1, shape).astype(np.float32)
    save_image(image, tmp_path / "a.png")
    back = np.asarray(Image.open(tmp_path / "a.png"))
    np.testing.assert_array_equal(back, to_uint8(image))
    pixels = rng.integers(0, 256, (3, 2, 3), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(pixels)))),
                                  pixels)
    grid = vcat(hcat(image, image), hcat(image, image))
    assert grid.shape[:2] == (2 * shape[0] + 2, 2 * shape[1] + 2)


def test_ply_export_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    n = 50
    args = (rng.normal(size=(n, 3)), np.exp(rng.normal(size=(n, 3))),
            rng.normal(size=(n, 4)), rng.normal(size=(n, 3, 4)), rng.uniform(0, 1, n))
    assert export_ply(*args, tmp_path / "t.ply") == jexport_ply(*args, tmp_path / "j.ply")
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_benchmarker_writes_the_jax_keys(tmp_path):
    bench = Benchmarker()
    for _ in range(3):
        assert bench.time_fn("encoder", lambda x: x + 1, 1) == 2
    bench.time_fn("decoder", lambda: None)
    bench.dump(tmp_path / "benchmark.json")
    summary = json.loads((tmp_path / "benchmark.json").read_text())
    assert sorted(summary) == ["decoder", "encoder"]
    assert sorted(summary["encoder"]) == ["calls_s", "count", "mean_s", "mean_warm_s",
                                          "total_s"]
    assert summary["encoder"]["count"] == 3
    bench.dump_memory(tmp_path / "peak_memory.json")
    assert json.loads((tmp_path / "peak_memory.json").read_text()) == \
        Benchmarker.memory_stats()
