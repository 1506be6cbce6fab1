"""Parity of the port's long-video path (vicasplat_tpu_torch/streaming.py)
and `ops/sh.rotate_sh` with the JAX package's, in float32 on the CPU:
window planning and pose chaining exactly, SH rotation and Gaussian
re-basing within TOL, and `reconstruct_video` through both engines at the
tiny config."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import TOL, perturbed_params, tiny_cfgs
from vicasplat_tpu import serving as jserving
from vicasplat_tpu import streaming as jstream
from vicasplat_tpu.models.adapter import Gaussians as JGaussians
from vicasplat_tpu.ops import sh as jsh
from vicasplat_tpu_torch import serving as tserving
from vicasplat_tpu_torch import streaming as tstream
from vicasplat_tpu_torch.models.adapter import Gaussians as TGaussians
from vicasplat_tpu_torch.ops import sh as tsh

torch.set_num_threads(1)


def rand_rot(rng):
    q = rng.normal(size=4)
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def trajectory(rng, n):
    poses = [np.eye(4)]
    for _ in range(n - 1):
        step = np.eye(4)
        step[:3, :3] = rand_rot(rng)
        step[:3, 3] = rng.normal(size=3)
        poses.append(poses[-1] @ step)
    return np.stack(poses)


@pytest.mark.parametrize("n,window,overlap", [(8, 8, 2), (14, 8, 2), (15, 8, 2),
                                              (20, 8, 4), (10, 4, 2), (7, 3, 2)])
def test_plan_windows_equals_jax(n, window, overlap):
    assert tstream.plan_windows(n, window, overlap) == \
        jstream.plan_windows(n, window, overlap)


def test_plan_windows_rejects_what_jax_rejects():
    for args in [(3, 8, 2), (8, 4, 0), (8, 4, 4)]:
        with pytest.raises(ValueError):
            jstream.plan_windows(*args)
        with pytest.raises(ValueError):
            tstream.plan_windows(*args)


@pytest.mark.parametrize("n,window,overlap", [(12, 5, 3), (9, 4, 2), (11, 4, 1)])
def test_chain_windows_equals_jax(n, window, overlap):
    """Local windows at random per-window scales: the same global poses,
    scales and bases, bit for bit."""
    rng = np.random.default_rng(n)
    G = trajectory(rng, n)
    starts = tstream.plan_windows(n, window, overlap)
    locals_ = []
    for s in starts:
        local = np.einsum("ij,tjk->tik", np.linalg.inv(G[s]), G[s:s + window])
        local[:, :3, 3] *= rng.uniform(0.3, 3.0)
        locals_.append(local)
    for got, ref in zip(tstream.chain_windows(locals_, starts),
                        jstream.chain_windows(locals_, starts)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("degree", [1, 4])
def test_rotate_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    harm = rng.normal(size=(2, 5, 3, (degree + 1) ** 2)).astype(np.float32)
    R = rand_rot(rng).astype(np.float32)
    ref = jsh.rotate_sh(jnp.asarray(harm), jnp.asarray(R), degree=degree)
    got = tsh.rotate_sh(torch.from_numpy(harm), torch.from_numpy(R), degree=degree)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    # a rotation's SH transfer preserves each band's energy
    np.testing.assert_allclose((got ** 2).sum(-1).numpy(), (harm ** 2).sum(-1),
                               rtol=1e-3)


def gaussians(rng, shape=(2, 4, 4), d_sh=25):
    q = rng.normal(size=shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    A = rng.normal(size=shape + (3, 3))
    return dict(means=rng.normal(size=shape + (3,)),
                covariances=A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(3),
                harmonics=rng.normal(size=shape + (3, d_sh)),
                opacities=rng.uniform(size=shape),
                scales=rng.uniform(0.1, 1, shape + (3,)), rotations=q)


def test_rebase_gaussians_matches_jax():
    rng = np.random.default_rng(2)
    g = {k: v.astype(np.float32) for k, v in gaussians(rng).items()}
    base = np.eye(4)
    base[:3, :3] = rand_rot(rng)
    base[:3, 3] = rng.normal(size=3)
    base = base.astype(np.float32)
    ref = jstream.rebase_gaussians(JGaussians(**{k: jnp.asarray(v) for k, v in g.items()}),
                                   jnp.asarray(base), jnp.float32(2.0), sh_degree=4)
    got = tstream.rebase_gaussians(TGaussians(**{k: torch.from_numpy(v) for k, v in g.items()}),
                                   torch.from_numpy(base), torch.tensor(2.0), sh_degree=4)
    for name in TGaussians._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = tiny_cfgs()
    params = perturbed_params(jcfg)
    return (jserving.InferenceEngine(jcfg, params=params, dtype=jnp.float32),
            tserving.InferenceEngine(tcfg, params=params, dtype=torch.float32,
                                     device="cpu"))


def test_reconstruct_video_matches_jax(engines):
    """7 frames, window 3, overlap 2: 5 windows, each through the engine's
    one reconstruct program."""
    je, te = engines
    F = 7
    rng = np.random.default_rng(5)
    frames = rng.uniform(0, 1, (F, 32, 32, 3)).astype(np.float32)
    K = np.ascontiguousarray(np.broadcast_to(
        np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32),
        (F, 3, 3)))
    ref = jstream.reconstruct_video(je, frames, K, window=3, overlap=2)
    got = tstream.reconstruct_video(te, frames, K, window=3, overlap=2)
    assert len(te._recon.items) == 1
    assert te._reconstruct_fn((1, 3, 32, 32, 3), (1, 3, 3, 3)).calls == 5
    assert got.poses.shape == (F, 4, 4) and got.intrinsics is None
    np.testing.assert_allclose(got.poses[0], np.eye(4), atol=1e-6)
    np.testing.assert_allclose(got.poses, ref.poses, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.window_scales, ref.window_scales, rtol=TOL)
    for name in TGaussians._fields:
        np.testing.assert_allclose(getattr(got.gaussians, name).numpy(),
                                   np.asarray(getattr(ref.gaussians, name)),
                                   atol=TOL, rtol=TOL, err_msg=name)


def test_overlap_one_warns(engines):
    _, te = engines
    frames = np.zeros((5, 32, 32, 3), np.float32)
    K = np.broadcast_to(np.eye(3, dtype=np.float32), (5, 3, 3))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        scene = tstream.reconstruct_video(te, frames, K, window=3, overlap=1)
    assert any("overlap=1" in str(x.message) for x in w)
    assert scene.gaussians.means.shape[:3] == (5, 32, 32)
