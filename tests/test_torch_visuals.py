"""Parity of the port's visual outputs with the JAX package's, in float32 on
the CPU: the dual-quaternion rest (screw power, ScLERP), camera
trajectories and trajectory videos, near-orthographic projections, PLY,
GLB, the drawing helpers and the camera figure, the offline viewer and the
WebGL viewer server, and the train mode's validation visuals."""
import http.client

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_render import jax_exact_depth_order
from tests.test_torch_train import TOY
from vicasplat_tpu.decoder.splatting import DecoderSplattingConfig as JDecCfg
from vicasplat_tpu.decoder.splatting import decoder_forward as j_decoder_forward
from vicasplat_tpu.geometry import dual_quaternion as jdq
from vicasplat_tpu.models.adapter import Gaussians as JGaussians
from vicasplat_tpu.models.adapter import build_covariance as j_build_covariance
from vicasplat_tpu.utils import ply as jply
from vicasplat_tpu.visualization import camera_trajectory as jtraj
from vicasplat_tpu.visualization import drawing as jdraw
from vicasplat_tpu.visualization import glb as jglb
from vicasplat_tpu.visualization import validation_in_3d as jval3d
from vicasplat_tpu.visualization import video_render as jvideo
from vicasplat_tpu.visualization import viewer as jviewer
from vicasplat_tpu.visualization import viewer_server as jserver
from vicasplat_tpu_torch import main as tmain
from vicasplat_tpu_torch.decoder.splatting import DecoderSplattingConfig as TDecCfg
from vicasplat_tpu_torch.geometry import dual_quaternion as tdq
from vicasplat_tpu_torch.models.adapter import Gaussians as TGaussians
from vicasplat_tpu_torch.models.adapter import build_covariance as t_build_covariance
from vicasplat_tpu_torch.utils import ply as tply
from vicasplat_tpu_torch.visualization import camera_trajectory as ttraj
from vicasplat_tpu_torch.visualization import drawing as tdraw
from vicasplat_tpu_torch.visualization import glb as tglb
from vicasplat_tpu_torch.visualization import validation_in_3d as tval3d
from vicasplat_tpu_torch.visualization import video_render as tvideo
from vicasplat_tpu_torch.visualization import viewer as tviewer
from vicasplat_tpu_torch.visualization import viewer_server as tserver

torch.set_num_threads(1)

# elementwise float32 formulas (quaternion products, arccos, sin, cos) in
# the same order on both sides: a few ulp of values of order 1
POSE_TOL = 1e-5
# renders: the same splats composited by two matmul orders; 1e-4 on [0, 1]
# colours is far below one splat's contribution (>= 1/255 of its colour)
IMG_TOL = 1e-4


def rigid(rng, n, angle=None):
    """n random c2w matrices (4, 4): axis-angle rotations (angle in [0, pi)
    unless given) and translations in [-1, 1]^3."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = rng.uniform(0, np.pi, n) if angle is None else np.full(n, angle)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    K = K - K.transpose(0, 2, 1)
    R = (np.eye(3) + np.sin(ang)[:, None, None] * K
         + (1 - np.cos(ang))[:, None, None] * K @ K)
    m = np.tile(np.eye(4), (n, 1, 1))
    m[:, :3, :3], m[:, :3, 3] = R, rng.uniform(-1, 1, (n, 3))
    return m.astype(np.float32)


def dq_pair(m):
    """The same motions as (JAX, port) dual quaternions, by each's from_matrix."""
    return jdq.from_matrix(jnp.asarray(m)), tdq.from_matrix(torch.from_numpy(m))


def close(t, j, tol=POSE_TOL, msg=""):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), atol=tol, rtol=0, err_msg=msg)


def close_dq(t, j, tol=POSE_TOL, msg=""):
    close(tdq.to_dq_array(t), jdq.to_dq_array(j), tol, msg)


def motions(seed=0):
    """Random motions, a rotation angle of 1e-7 (the screw power's
    pure-translation branch) and the identity."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rigid(rng, 6), rigid(rng, 2, angle=1e-7),
                           np.eye(4, dtype=np.float32)[None]])


def test_dual_quaternion_rest_matches_jax():
    m = motions()
    j, t = dq_pair(m)
    close_dq(t, j, msg="from_matrix")
    rng = np.random.default_rng(1)
    tr = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    close_dq(tdq.from_translation(torch.from_numpy(tr)),
             jdq.from_translation(jnp.asarray(tr)), msg="from_translation")
    for name in ("dual_number_conjugate", "combined_conjugate", "inverse"):
        close_dq(getattr(tdq, name)(t), getattr(jdq, name)(j), msg=name)
    pts = rng.uniform(-2, 2, (len(m), 3)).astype(np.float32)
    close(tdq.transform_point(t, torch.from_numpy(pts)),
          jdq.transform_point(j, jnp.asarray(pts)), msg="transform_point")
    # the inverse undoes the motion
    close(tdq.homogeneous_matrix(tdq.dqmul(t, tdq.inverse(t))),
          np.tile(np.eye(4), (len(m), 1, 1)), msg="sigma sigma^-1")


@pytest.mark.parametrize("exponent", [0.0, 0.3, 1.0, 2.5])
def test_dqpow_matches_jax_including_the_small_angle_branch(exponent):
    j, t = dq_pair(motions())
    e = np.float32(exponent)
    tp, jp = tdq.dqpow(t, torch.tensor(e)), jdq.dqpow(j, jnp.asarray(e))
    close_dq(tp, jp, msg=f"dqpow {exponent}")
    assert torch.isfinite(tdq.to_dq_array(tp)).all()
    if exponent == 1.0:  # sigma^1 = sigma
        close_dq(tp, j)


def test_sclerp_matches_jax_across_hemispheres():
    rng = np.random.default_rng(2)
    a, b = rigid(rng, 5), rigid(rng, 5)
    (ja, ta), (jb, tb) = dq_pair(a), dq_pair(b)
    # the same motions with the real parts negated: opposite hemispheres
    tb_neg = tdq.DualQuaternion(-tb.qr, -tb.qd)
    jb_neg = jdq.DualQuaternion(-jb.qr, -jb.qd)
    for t_val in (0.0, 0.25, 0.5, 1.0):
        tt = np.float32(t_val)
        for tstop, jstop, label in ((tb, jb, "same"), (tb_neg, jb_neg, "flipped")):
            ts = tdq.sclerp(ta, tstop, torch.tensor(tt))
            js = jdq.sclerp(ja, jstop, jnp.asarray(tt))
            close_dq(ts, js, msg=f"sclerp {label} t={t_val}")
            # the interpolated motion is the same either way round
            close(tdq.homogeneous_matrix(ts), tdq.homogeneous_matrix(
                tdq.sclerp(ta, tb, torch.tensor(tt))), msg=label)
    # the endpoints
    close(tdq.homogeneous_matrix(tdq.sclerp(ta, tb, torch.tensor(1.0))), b, 1e-5)
    close(tdq.homogeneous_matrix(tdq.sclerp(ta, tb, torch.tensor(0.0))), a, 1e-5)


def test_trajectories_match_jax():
    rng = np.random.default_rng(3)
    poses = np.concatenate([rigid(rng, 3), rigid(rng, 1, angle=1e-7)])
    poses[3, :3, :3] = poses[2, :3, :3]  # a pure translation segment
    t = np.linspace(0, 1, 7).astype(np.float32)
    close(ttraj.interpolate_extrinsics(torch.from_numpy(poses[0]),
                                       torch.from_numpy(poses[1]), torch.from_numpy(t)),
          jtraj.interpolate_extrinsics(jnp.asarray(poses[0]), jnp.asarray(poses[1]),
                                       jnp.asarray(t)), msg="interpolate_extrinsics")
    for steps in (1, 6, 10):
        tt = ttraj.interpolate_trajectory(torch.from_numpy(poses), steps)
        jt = jtraj.interpolate_trajectory(jnp.asarray(poses), steps)
        assert tt.shape == (3 * steps + 1, 4, 4) == jt.shape
        close(tt, jt, msg=f"interpolate_trajectory {steps}")
    close(ttraj.generate_wobble(torch.from_numpy(poses[0]), 0.3, torch.from_numpy(t)),
          jtraj.generate_wobble(jnp.asarray(poses[0]), 0.3, jnp.asarray(t)),
          msg="generate_wobble")


# ---- Gaussian scenes and renders ----

def scene_pair(n=300, sh_degree=1, seed=0):
    """One example of n splats in front of the identity camera, as (JAX,
    port) Gaussians with a leading batch axis."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    means = f(np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                        rng.uniform(2.5, 5.0, n)], -1))
    scales = f(rng.uniform(0.03, 0.15, (n, 3)))
    quats = rng.normal(size=(n, 4))
    quats = f(quats / np.linalg.norm(quats, axis=-1, keepdims=True))
    sh = f(rng.normal(0, 0.4, (n, 3, (sh_degree + 1) ** 2)))
    opac = f(rng.uniform(0.3, 1.0, n))
    j = JGaussians(means=jnp.asarray(means)[None],
                   covariances=j_build_covariance(jnp.asarray(scales),
                                                  jnp.asarray(quats))[None],
                   harmonics=jnp.asarray(sh)[None], opacities=jnp.asarray(opac)[None],
                   scales=jnp.asarray(scales)[None], rotations=jnp.asarray(quats)[None])
    s, q = torch.from_numpy(scales), torch.from_numpy(quats)
    t = TGaussians(means=torch.from_numpy(means)[None],
                   covariances=t_build_covariance(s, q)[None],
                   harmonics=torch.from_numpy(sh)[None],
                   opacities=torch.from_numpy(opac)[None], scales=s[None],
                   rotations=q[None])
    return j, t, dict(means=means, scales=scales, rotations=quats, harmonics=sh,
                      opacities=opac)


def context_poses(V=3):
    """Small motions around the identity (the scene stays in view)."""
    rng = np.random.default_rng(4)
    m = rigid(rng, V, angle=0.1)
    m[:, :3, 3] *= 0.3
    m[0] = np.eye(4)
    K = np.tile(np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32),
                (V, 1, 1))
    return m, K


def test_video_renders_match_jax():
    jg, tg, _ = scene_pair()
    ext, K = context_poses()
    tv = tvideo.render_video_interpolation(tg, torch.from_numpy(ext),
                                           torch.from_numpy(K), (24, 32), 3)
    jv = jvideo.render_video_interpolation(jg, jnp.asarray(ext), jnp.asarray(K),
                                           (24, 32), 3)
    assert tv.shape == (7, 24, 32, 3) == jv.shape and tv.dtype == np.float32
    assert tv.max() > 0.05  # the splats are in view
    close(tv, jv, IMG_TOL, "interpolation video")
    tw = tvideo.render_video_wobble(tg, torch.from_numpy(ext), torch.from_numpy(K),
                                    (24, 32), num_frames=5)
    jw = jvideo.render_video_wobble(jg, jnp.asarray(ext), jnp.asarray(K), (24, 32),
                                    num_frames=5)
    assert tw.shape == (5, 24, 32, 3)
    close(tw, jw, IMG_TOL, "wobble video")


def test_render_projections_match_jax():
    jg, tg, _ = scene_pair(seed=5)
    tp = tval3d.render_projections(tg, resolution=24)
    # far back and narrow, the orthographic cameras bring the depths within
    # JAX's u32 key resolution, which orders the tied splats arbitrarily
    with jax_exact_depth_order():
        jp = jval3d.render_projections(jg, resolution=24)
    assert tp.shape == (3, 24, 24, 3) == jp.shape
    assert tp.max() > 0.05
    close(tp, jp, IMG_TOL, "projections")
    for d in "xyz":
        for a, b in zip(tval3d.orthographic_camera(d, 1.7), jval3d.orthographic_camera(d, 1.7)):
            np.testing.assert_array_equal(a, b)


def test_ply_round_trip_and_reader_match_jax(tmp_path):
    _, _, g = scene_pair(n=50, sh_degree=2, seed=6)
    g["opacities"][:5] = 0.001  # pruned
    args = (g["means"], g["scales"], g["rotations"], g["harmonics"], g["opacities"])
    assert tply.export_ply(*args, tmp_path / "t.ply") == jply.export_ply(
        *args, tmp_path / "j.ply") == 45
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    t, j = tply.read_ply(tmp_path / "t.ply"), jply.read_ply(tmp_path / "j.ply")
    assert sorted(t) == sorted(j)
    for k in t:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    keep = np.argsort(-g["opacities"][g["opacities"] >= 0.005])
    np.testing.assert_allclose(t["means"], g["means"][g["opacities"] >= 0.005][keep])


def test_glb_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    poses = rigid(rng, 14)  # more cameras than colours: the palette cycles
    for kw in ({}, {"camera_poses": poses, "focal": 0.87}, {"camera_poses": poses[:2]}):
        tglb.write_glb(tmp_path / "t.glb", pts, cols, **kw)
        jglb.write_glb(tmp_path / "j.glb", pts, cols, **kw)
        assert (tmp_path / "t.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()
        js = tglb.read_glb_json(tmp_path / "t.glb")
        assert js == jglb.read_glb_json(tmp_path / "j.glb")
        assert len(js["meshes"]) == 1 + len(kw.get("camera_poses", []))
    u8 = (cols * 255).astype(np.uint8)
    tglb.write_glb(tmp_path / "t.glb", pts, u8)
    jglb.write_glb(tmp_path / "j.glb", pts, u8)
    assert (tmp_path / "t.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()


def test_drawing_helpers_match_jax():
    rng = np.random.default_rng(8)
    K = np.array([[0.8, 0, 0.5], [0, 1.1, 0.45], [0, 0, 1.0]])
    for e in rigid(rng, 3):
        np.testing.assert_array_equal(tdraw._frustum_points(e, K, 0.3),
                                      jdraw._frustum_points(e, K, 0.3))
    img = rng.uniform(0, 1, (30, 40, 3)).astype(np.float32)
    xy = rng.uniform(-0.1, 1.1, (6, 2))
    np.testing.assert_array_equal(tdraw.draw_points(img, xy, radius=3),
                                  jdraw.draw_points(img, xy, radius=3))
    for p0, p1 in ((xy[0], xy[1]), ((0.1, 0.2), (0.9, 0.95)), ((-0.5, 0.5), (1.5, 0.5))):
        np.testing.assert_array_equal(tdraw.draw_line(img, p0, p1),
                                      jdraw.draw_line(img, p0, p1))


def test_camera_figure_draws_the_frusta_on_jax_canvas():
    """matplotlib's 3D figure cannot be rebuilt pixel for pixel without
    matplotlib: the port's figure holds the same frusta on a canvas of the
    same size, in the same two colours, with a legend."""
    rng = np.random.default_rng(9)
    gt = rigid(rng, 4)
    pred = gt.copy()
    pred[:, :3, 3] += 0.05
    t = tdraw.draw_cameras_figure(gt, pred)
    j = jdraw.draw_cameras_figure(gt, pred)
    assert t.shape == j.shape == (600, 600, 3) and t.dtype == j.dtype == np.float32
    assert 0.0 <= t.min() and t.max() <= 1.0
    for color in (tdraw.TAB_BLUE, tdraw.TAB_RED):
        hit = np.abs(t - np.asarray(color, np.float32)).max(-1) < 1e-6
        assert hit.sum() > 200, color
    only_gt = tdraw.draw_cameras_figure(gt)
    red = np.abs(only_gt - np.asarray(tdraw.TAB_RED, np.float32)).max(-1) < 1e-6
    assert not red.any()
    # each frustum vertex projects inside the canvas
    lo, hi = gt[:, :3, 3].min(0) - 1, gt[:, :3, 3].max(0) + 1
    xy = tdraw._view_project(gt[:, :3, 3], lo, hi)
    assert ((xy > 0) & (xy < 1)).all()


def test_orbit_poses_and_viewer_page_match_jax():
    c = np.array([0.1, -0.2, 3.0])
    np.testing.assert_array_equal(tviewer.orbit_poses(c, 2.5, 9),
                                  jviewer.orbit_poses(c, 2.5, 9))
    assert tserver._PAGE == jserver._PAGE


def test_viewer_orbit_render_matches_jax(tmp_path):
    """The viewer's orbit render of a PLY against the same steps composed
    from the JAX package (read_ply, build_covariance, decoder_forward)."""
    _, _, g = scene_pair(n=200, seed=10)
    tply.export_ply(g["means"], g["scales"], g["rotations"], g["harmonics"],
                    g["opacities"], tmp_path / "s.ply")
    frames, n = tviewer.render_orbit(tmp_path / "s.ply", frames=4, size=24, device="cpu")
    data = jply.read_ply(tmp_path / "s.ply")
    jg = JGaussians(
        means=jnp.asarray(data["means"])[None],
        covariances=j_build_covariance(jnp.asarray(data["scales"]),
                                       jnp.asarray(data["rotations"]))[None],
        harmonics=jnp.asarray(data["harmonics"])[None],
        opacities=jnp.asarray(data["opacities"])[None],
        scales=jnp.asarray(data["scales"])[None],
        rotations=jnp.asarray(data["rotations"])[None])
    center = data["means"].mean(0)
    radius = 2.5 * float(np.abs(data["means"] - center).mean() + 1e-3)
    traj = jviewer.orbit_poses(center, radius, 4)
    f = 0.5 / np.tan(np.radians(60.0) / 2)
    K = np.array([[f, 0, 0.5], [0, f, 0.5], [0, 0, 1.0]], np.float32)
    ref = j_decoder_forward(JDecCfg(), jg, jnp.asarray(traj)[None],
                            jnp.broadcast_to(jnp.asarray(K), (1, 4, 3, 3)),
                            jnp.full((1, 4), 0.01 * radius),
                            jnp.full((1, 4), 100.0 * radius), (24, 24))
    assert n == 200 and frames.shape == (4, 24, 24, 3) and frames.max() > 0.05
    close(frames, ref.color[0], IMG_TOL, "orbit")
    out = tmp_path / "orbit.mp4"
    tviewer.main(["--ply", str(tmp_path / "s.ply"), "--output", str(out), "--frames", "3",
                  "--size", "16", "--device", "cpu"])
    assert out.exists() or out.with_suffix("").is_dir()


def test_viewer_server_on_loopback(tmp_path):
    rng = np.random.default_rng(11)
    tglb.write_glb(tmp_path / "s.glb", rng.normal(size=(10, 3)),
                   rng.uniform(0, 1, (10, 3)), camera_poses=rigid(rng, 2))
    srv = tserver.serve_scene(tmp_path / "s.glb", port=0, block=False)
    try:
        port = srv.server_address[1]
        got = {}
        for path in ("/", "/index.html", "/scene.glb", "/missing"):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            conn.request("GET", path)
            r = conn.getresponse()
            got[path] = (r.status, r.getheader("Content-Type"), r.read())
            conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
    assert got["/"] == got["/index.html"] == (200, "text/html", jserver._PAGE.encode())
    assert got["/scene.glb"] == (200, "model/gltf-binary",
                                 (tmp_path / "s.glb").read_bytes())
    assert got["/missing"][0] == 404


def test_train_mode_writes_the_validation_visuals(tmp_path, capsys):
    """main(... mode=train ...) at toy size: the validation step writes the
    projections, the camera figure and the interpolation video beside the
    comparison grid, and prints no 'skipped'."""
    out = tmp_path / "run"
    tmain.main(["+experiment=synthetic_pose", "mode=train", *TOY, "trainer.max_steps=1",
                "trainer.val_check_interval=1", "checkpointing.every_n_train_steps=1",
                f"output_dir={out}", f"checkpointing.output_dir={out}/ckpts"],
               device="cpu")
    assert "skipped" not in capsys.readouterr().out
    val = out / "val/step_0000001"
    for name in ("comparison.png", "projections.png", "cameras.png"):
        assert (val / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
    from vicasplat_tpu_torch.utils.image_io import load_image

    proj = load_image(val / "projections.png")
    assert proj.shape[0] == 256 and proj.shape[1] >= 3 * 256
    assert load_image(val / "cameras.png").shape == (600, 600, 3)
    video = val / "interpolation.mp4"
    frames = (sorted(video.with_suffix("").glob("*.png")) if not video.exists()
              else None)
    # 4 context frames, 6 steps a segment: 19 frames
    if frames is not None:
        assert len(frames) == 19
    else:
        import cv2

        cap = cv2.VideoCapture(str(video))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 19
        cap.release()


def test_png_reader_serves_the_visual_outputs():
    """The PNG writer's output reads back through the port's decoder."""
    from vicasplat_tpu_torch.utils.image_io import decode_png, encode_png

    img = np.random.default_rng(12).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)
    grey = img[..., 0]
    np.testing.assert_array_equal(decode_png(encode_png(grey)),
                                  np.repeat(grey[..., None], 3, -1))
