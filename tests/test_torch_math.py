"""Parity of the port's math layer with the JAX package's: RoPE, quaternions,
dual quaternions, SE(3) and spherical harmonics, in float32 on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicasplat_tpu.geometry import dual_quaternion as jdq
from vicasplat_tpu.geometry import quaternion as jq
from vicasplat_tpu.geometry import se3 as jse3
from vicasplat_tpu.ops import rope as jrope
from vicasplat_tpu.ops import sh as jsh
from vicasplat_tpu_torch.geometry import dual_quaternion as tdq
from vicasplat_tpu_torch.geometry import quaternion as tq
from vicasplat_tpu_torch.geometry import se3 as tse3
from vicasplat_tpu_torch.ops import rope as trope
from vicasplat_tpu_torch.ops import sh as tsh

torch.set_num_threads(1)

# elementwise float32 formulas evaluated in the same order on both sides:
# a few ulp apart, so 1e-5 absolute on O(1) values
TOL = 1e-5


def close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=tol)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


@pytest.mark.parametrize("gh,gw,intrinsic", [(4, 4, True), (3, 5, False)])
def test_rope_2d(gh, gw, intrinsic):
    pos = jrope.grid_positions(gh, gw)
    if intrinsic:  # the intrinsic token at grid position (gh, 0)
        pos = np.concatenate([pos, np.array([[gh, 0]])], axis=0)
    np.testing.assert_array_equal(trope.grid_positions(gh, gw),
                                  jrope.grid_positions(gh, gw))
    cj, sj = jrope.make_rope_2d_tables(pos, 16, base=100.0)
    ct, st = trope.make_rope_2d_tables(pos, 16, base=100.0)
    close(ct, cj)
    close(st, sj)
    x = rand(2, len(pos), 3, 16)  # (B, N, H, D) with tables (N, 1, D)
    close(trope.apply_rope_2d(torch.from_numpy(x), ct[:, None], st[:, None]),
          jrope.apply_rope_2d(jnp.asarray(x), cj[:, None], sj[:, None]))


def test_rope_temporal():
    cj, sj = jrope.make_rope_nd_tables([12], [5], theta=30.0)
    ct, st = trope.make_rope_nd_tables([12], [5], theta=30.0)
    close(ct, cj)
    close(st, sj)
    x = rand(2, 5, 4, 12)  # (B, T, H, D) with tables (T, 1, D)
    close(trope.apply_rope_interleaved(torch.from_numpy(x), ct[:, None], st[:, None]),
          jrope.apply_rope_interleaved(jnp.asarray(x), cj[:, None], sj[:, None]))


def test_quaternion():
    a, b = rand(6, 4, seed=1), rand(6, 4, seed=2)
    close(tq.qmul(torch.from_numpy(a), torch.from_numpy(b)),
          jq.qmul(jnp.asarray(a), jnp.asarray(b)))
    close(tq.qnormalize(torch.from_numpy(a)), jq.qnormalize(jnp.asarray(a)))
    R = jq.quat_to_matrix(jnp.asarray(a))
    close(tq.quat_to_matrix(torch.from_numpy(a)), R)
    # every pivot branch: rotations near identity and by ~pi about each axis
    mats = np.concatenate([np.asarray(R), np.diag([1.0, -1, -1])[None],
                           np.diag([-1.0, 1, -1])[None],
                           np.diag([-1.0, -1, 1])[None]]).astype(np.float32)
    close(tq.matrix_to_quat(torch.from_numpy(mats)),
          jq.matrix_to_quat(jnp.asarray(mats)))


def test_dual_quaternion_and_se3():
    dq = rand(5, 8, seed=3)
    for norm in (False, True):
        close(tse3.camera_matrix_from_dq_array(torch.from_numpy(dq), norm),
              jse3.camera_matrix_from_dq_array(jnp.asarray(dq), norm))
    qt = rand(5, 7, seed=4)
    close(tdq.homogeneous_matrix(tdq.from_quat_pose(torch.from_numpy(qt))),
          jdq.homogeneous_matrix(jdq.from_quat_pose(jnp.asarray(qt))))
    tau = rand(6, 6, seed=5)
    tau[0] = 0.0  # the Taylor branch at the identity
    tau[1, 3:] = 1e-5
    m = jse3.se3_exp(jnp.asarray(tau))
    close(tse3.se3_exp(torch.from_numpy(tau)), m)
    close(tse3.rigid_inverse(torch.tensor(np.asarray(m))), jse3.rigid_inverse(m))
    fov = np.abs(rand(3, 2, seed=6)) + 0.3
    close(tse3.intrinsics_from_fov(torch.from_numpy(fov)),
          jse3.intrinsics_from_fov(jnp.asarray(fov)))


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_spherical_harmonics(degree):
    d = rand(50, 3, seed=7)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for a, b in zip(tsh.sh_basis_cols(torch.from_numpy(d), degree),
                    jsh.sh_basis_cols(jnp.asarray(d), degree)):
        close(a, b)
    coeffs = rand(50, 3, (degree + 1) ** 2, seed=8, scale=0.5)
    close(tsh.eval_sh_colors(torch.from_numpy(coeffs), torch.from_numpy(d), degree),
          jsh.eval_sh_colors(jnp.asarray(coeffs), jnp.asarray(d), degree))


def test_qidentity_and_qrotate():
    for shape in ((), (3,), (2, 5)):
        close(tq.qidentity(shape), jq.qidentity(shape))
    q = rand(4, 6, 4, seed=8)
    v = rand(4, 6, 3, seed=9)
    close(tq.qrotate(torch.from_numpy(q), torch.from_numpy(v)),
          jq.qrotate(jnp.asarray(q), jnp.asarray(v)))
    # a unit quaternion rotates: the identity leaves v, lengths are kept
    u = q / np.linalg.norm(q, axis=-1, keepdims=True)
    r = tq.qrotate(torch.from_numpy(u), torch.from_numpy(v))
    close(torch.linalg.vector_norm(r, dim=-1), np.linalg.norm(v, axis=-1))
    close(tq.qrotate(tq.qidentity((4, 6)), torch.from_numpy(v)), v)


def _poses(n, seed):
    tau = rand(n, 6, seed=seed, scale=0.5)
    return np.array(jse3.se3_exp(jnp.asarray(tau)))


def test_camera_normalization_and_qt_matrix():
    poses = _poses(5, 10)
    got = tse3.camera_normalization(torch.from_numpy(poses[0]), torch.from_numpy(poses))
    close(got, jse3.camera_normalization(jnp.asarray(poses[0]), jnp.asarray(poses)))
    close(got[0], np.eye(4))
    qt = rand(3, 5, 7, seed=11)
    close(tse3.camera_matrix_from_qt_array(torch.from_numpy(qt)),
          jse3.camera_matrix_from_qt_array(jnp.asarray(qt)))


def test_pose_error_angles():
    pred, gt = _poses(6, 12), _poses(6, 13)
    gt[0] = pred[0]  # zero error: arccos at the clip
    gt[1, :3, 3] = -pred[1, :3, 3]  # opposite translations: 180 degrees
    rot_t, trans_t = tse3.pose_error_angles(torch.from_numpy(pred), torch.from_numpy(gt))
    rot_j, trans_j = jse3.pose_error_angles(jnp.asarray(pred), jnp.asarray(gt))
    # degrees of an arccos: 1e-5 of a cosine near 1 is about 0.26 degrees,
    # so the O(10)-degree values are held to 1e-3 and the clipped ends to
    # the clip's own width
    close(rot_t[1:], rot_j[1:], tol=1e-3)
    close(trans_t, trans_j, tol=1e-3)
    assert float(rot_t[0]) < 0.3 and float(rot_j[0]) < 0.3
    assert abs(float(trans_t[1]) - 180.0) < 1e-3


def test_get_pnp_pose():
    """On the point map JAX's test builds (tests/test_geometry.py TestPnP):
    both recover the camera within 1e-3 and agree within 1e-5."""
    pytest.importorskip("cv2")
    from vicasplat_tpu.geometry.projection import get_world_rays

    h = w = 32
    K = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.asarray(jse3.so3_exp(jnp.array([0.1, -0.2, 0.05])))
    c2w[:3, 3] = [0.3, -0.1, 0.2]
    jj, ii = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    coords = np.stack([jj / w, ii / h], axis=-1).astype(np.float32).reshape(-1, 2)
    o, d = get_world_rays(jnp.asarray(coords), jnp.asarray(c2w), jnp.asarray(K))
    depths = np.random.default_rng(0).uniform(2.0, 5.0, (h * w, 1)).astype(np.float32)
    pts = (np.asarray(o) + np.asarray(d) * depths).reshape(h, w, 3)
    opacity = np.ones((h, w), np.float32)
    opacity[:4] = 0.1  # rows under the threshold are left out
    got = tse3.get_pnp_pose(torch.from_numpy(pts), torch.from_numpy(opacity),
                            torch.from_numpy(K), h, w)
    ref = jse3.get_pnp_pose(pts, opacity, K, h, w)
    np.testing.assert_allclose(got, c2w, atol=1e-3)
    np.testing.assert_allclose(got, ref, atol=1e-5)
