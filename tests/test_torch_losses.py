"""Parity of the port's losses (vicasplat_tpu_torch/loss/losses.py) and the
geometry they call with the JAX package's, in float32 on the CPU: each
value and its gradient to the prediction."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicasplat_tpu.geometry import dual_quaternion as jdq
from vicasplat_tpu.geometry.projection import get_fov as j_get_fov
from vicasplat_tpu.geometry.se3 import camera_dq_array_from_Rt as j_dq_from_Rt
from vicasplat_tpu.loss import losses as jl
from vicasplat_tpu_torch.geometry import dual_quaternion as tdq
from vicasplat_tpu_torch.geometry.projection import get_fov as t_get_fov
from vicasplat_tpu_torch.geometry.se3 import camera_dq_array_from_Rt as t_dq_from_Rt
from vicasplat_tpu_torch.loss import losses as tl

torch.set_num_threads(1)

# float32 elementwise formulas and means over a few hundred entries, in
# other orders: values within 1e-5, gradients within 1e-5 of their largest
# entry (the arccos of get_fov and the smoothed norms stay away from their
# singular points on these inputs)
TOL = 1e-5


def _rot(rng, n):
    """n random rotation matrices (QR of a Gaussian, det +1)."""
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def _poses(rng, B=2, T=4):
    ext = np.tile(np.eye(4, dtype=np.float32), (B, T, 1, 1))
    ext[:, 1:, :3, :3] = _rot(rng, B * (T - 1)).reshape(B, T - 1, 3, 3)
    ext[:, 1:, :3, 3] = rng.normal(0, 0.5, (B, T - 1, 3))
    ext[0, 1, :3, 3] = 0.0  # a pair with no translation direction
    return ext


def _intrinsics(rng, B=2, T=4):
    K = np.tile(np.eye(3, dtype=np.float32), (B, T, 1, 1))
    K[..., 0, 0] = rng.uniform(0.8, 1.2, (B, T))
    K[..., 1, 1] = rng.uniform(0.8, 1.2, (B, T))
    K[..., 0, 2] = K[..., 1, 2] = 0.5
    return K


def _check(jfn, tfn, pred, *rest, tol=TOL):
    """Value and gradient to the first argument, JAX against the port."""
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(pred),
                                      *(jnp.asarray(x) for x in rest))
    p = torch.tensor(pred, requires_grad=True)
    tv = tfn(p, *(torch.from_numpy(np.asarray(x)) for x in rest))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=tol, atol=tol)
    jg = np.asarray(jg)
    np.testing.assert_allclose(p.grad.numpy(), jg, rtol=0,
                               atol=tol * max(np.abs(jg).max(), 1e-6))


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    ext = _poses(rng)
    R, t = ext[..., :3, :3], ext[..., :3, 3]
    np.testing.assert_allclose(
        t_dq_from_Rt(torch.from_numpy(R), torch.from_numpy(t)).numpy(),
        np.asarray(j_dq_from_Rt(jnp.asarray(R), jnp.asarray(t))), atol=TOL)
    K = _intrinsics(rng)
    np.testing.assert_allclose(t_get_fov(torch.from_numpy(K)).numpy(),
                               np.asarray(j_get_fov(jnp.asarray(K))), atol=TOL)
    a, b = (rng.normal(size=(3, 8)).astype(np.float32) for _ in range(2))
    ja, jb = jdq.from_dq_array(jnp.asarray(a)), jdq.from_dq_array(jnp.asarray(b))
    ta, tb = tdq.from_dq_array(torch.from_numpy(a)), tdq.from_dq_array(torch.from_numpy(b))
    for jx, tx in [(jdq.dqmul(ja, jb), tdq.dqmul(ta, tb)),
                   (jdq.quaternion_conjugate(ja), tdq.quaternion_conjugate(ta)),
                   (jdq.normalized(ja), tdq.normalized(ta)),
                   (jdq.identity((3,)), tdq.identity((3,)))]:
        np.testing.assert_allclose(tdq.to_dq_array(tx).numpy(),
                                   np.asarray(jdq.to_dq_array(jx)), atol=TOL)


def test_mse_and_depth_smoothness_match_jax():
    rng = np.random.default_rng(1)
    color, target = (rng.uniform(size=(2, 3, 16, 16, 3)).astype(np.float32)
                     for _ in range(2))
    _check(lambda c, t: jl.mse_loss(c, t, jl.LossMseConfig(0.7)),
           lambda c, t: tl.mse_loss(c, t, tl.LossMseConfig(0.7)), color, target)
    depth = rng.uniform(0.5, 5.0, (2, 3, 16, 16)).astype(np.float32)
    depth[0, 0, 0, :3] = 0.0  # the clamp at 1e-6
    _check(lambda d, im: jl.depth_smoothness_loss(d, im),
           lambda d, im: tl.depth_smoothness_loss(d, im), depth, color)


@pytest.mark.parametrize("camera_type,trans_dir,with_intrinsics", [
    ("dq", 0.0, False), ("dq", 0.5, True), ("qt", 0.0, True), ("qt", 0.3, False)])
def test_camera_loss_matches_jax(camera_type, trans_dir, with_intrinsics):
    """The dq loss with its L1 of pred * gt^* in both orders, the qt loss,
    the FoV term and the translation-direction term."""
    rng = np.random.default_rng(2)
    ext = _poses(rng)
    c = 8 if camera_type == "dq" else 7
    pred = rng.normal(0, 0.3, (2, 3, c)).astype(np.float32)
    pred[..., 3] += 1.0
    fov = rng.uniform(0.7, 1.2, (2, 2)).astype(np.float32)
    K = _intrinsics(rng)
    kw = dict(camera_type=camera_type, trans_dir_weight=trans_dir)
    jcfg, tcfg = jl.LossCameraConfig(**kw), tl.LossCameraConfig(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    if with_intrinsics:
        _check(lambda p, e, f, k: jl.camera_loss(p, e, f, k, jcfg),
               lambda p, e, f, k: tl.camera_loss(p, e, f, k, tcfg), pred, ext, fov, K)
        _check(lambda f, p, e, k: jl.camera_loss(p, e, f, k, jcfg),
               lambda f, p, e, k: tl.camera_loss(p, e, f, k, tcfg), fov, pred, ext, K)
    else:
        _check(lambda p, e: jl.camera_loss(p, e, cfg=jcfg),
               lambda p, e: tl.camera_loss(p, e, cfg=tcfg), pred, ext)


@pytest.mark.parametrize("camera_type", ["dq", "qt"])
def test_camera_loss_at_the_identity_head_matches_jax(camera_type):
    """A zero-initialised camera head predicts the identity exactly, so
    against ground truth with identity rotations some entries of pred - gt
    are 0; JAX's |x| takes the derivative +1 there, and so must the
    port's L1 (torch's abs takes 0)."""
    rng = np.random.default_rng(3)
    ext = np.tile(np.eye(4, dtype=np.float32), (2, 4, 1, 1))
    ext[:, 1:, :3, 3] = rng.normal(0, 0.5, (2, 3, 3))
    c = 8 if camera_type == "dq" else 7
    raw = np.zeros((2, 3, c), np.float32)
    raw[..., 3] += 1.0  # the decode's +1 on the real quaternion part
    jcfg = jl.LossCameraConfig(camera_type=camera_type)
    tcfg = tl.LossCameraConfig(camera_type=camera_type)
    assert (raw[..., :4] == np.asarray(j_dq_from_Rt(jnp.asarray(ext[:, 1:, :3, :3]),
                                                   jnp.asarray(ext[:, 1:, :3, 3]))
                                      )[..., :4]).any()
    _check(lambda p, e: jl.camera_loss(p, e, cfg=jcfg),
           lambda p, e: tl.camera_loss(p, e, cfg=tcfg), raw, ext)


def test_translation_direction_and_total_match_jax():
    rng = np.random.default_rng(3)
    pred_t = rng.normal(size=(2, 5, 3)).astype(np.float32)
    gt_t = rng.normal(size=(2, 5, 3)).astype(np.float32)
    gt_t[1, 2] = 0.0  # masked out: no direction
    pred_t[0, 0] = 0.0  # the smoothed norm at zero
    _check(jl.translation_direction_loss, tl.translation_direction_loss,
           pred_t, gt_t)
    ext = _poses(rng)
    color, target = (rng.uniform(size=(2, 2, 8, 8, 3)).astype(np.float32)
                     for _ in range(2))
    pred = rng.normal(0, 0.3, (2, 3, 8)).astype(np.float32)
    jloss, jlogs = jl.total_loss(jnp.asarray(color), jnp.asarray(target),
                                 jnp.asarray(pred), jnp.asarray(ext))
    tloss, tlogs = tl.total_loss(*(torch.from_numpy(x) for x in (color, target,
                                                                  pred, ext)))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), rtol=TOL)
