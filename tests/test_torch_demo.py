"""Parity of the port's demo flow (vicasplat_tpu_torch/demo.py) with the JAX
package's, in float32 on the CPU: PNG input without PIL against PIL, the
LANCZOS resize and crop against the root demo.py's `load_images`, and
`run_demo` at toy size (one forward and the streamed route) against the
same steps composed from the JAX package."""
import io
import json
import pathlib
import struct
import sys
import zlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_model import TOL, perturbed_params, tiny_cfgs
from vicasplat_tpu import serving as jserving
from vicasplat_tpu import streaming as jstreaming
from vicasplat_tpu.decoder.splatting import DecoderSplattingConfig as JDecCfg
from vicasplat_tpu.decoder.splatting import decoder_forward as j_decoder_forward
from vicasplat_tpu.models import vicasplat as jvs
from vicasplat_tpu.models.adapter import Gaussians as JGaussians
from vicasplat_tpu.utils.ply import export_ply as j_export_ply
from vicasplat_tpu.visualization.camera_trajectory import (
    interpolate_trajectory as j_interpolate_trajectory,
)
from vicasplat_tpu.visualization.glb import write_glb as j_write_glb
from vicasplat_tpu_torch import demo as tdemo
from vicasplat_tpu_torch import models as tmodels
from vicasplat_tpu_torch.models import vicasplat as tvs
from vicasplat_tpu_torch.models.vicanet import VicaNetConfig as TNetCfg
from vicasplat_tpu_torch.utils import image_io as tio
from vicasplat_tpu_torch.utils import weights

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import demo as root_demo  # noqa: E402  (the JAX demo at the repository root)

torch.set_num_threads(1)

# elementwise float32 formulas in the same order: a few ulp
POSE_TOL = 1e-5
# the same splats composited by two matmul orders, far below 1/255
IMG_TOL = 1e-4


def make_image(h=37, w=53, seed=0):
    """Gradients (so PIL picks Sub, Up, Average and Paeth rows) and noise."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    ramp = np.linspace(0, 255, w)[None, :, None] + np.linspace(0, 60, h)[:, None, None]
    img[: h // 2] = ramp[: h // 2].astype(np.uint8)
    return img


def pil_png(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def colour_types():
    img = make_image()
    return {"L": Image.fromarray(img[..., 0], "L"),
            "LA": Image.fromarray(img[..., :2], "LA"),
            "RGB": Image.fromarray(img[..., :3], "RGB"),
            "RGBA": Image.fromarray(img, "RGBA"),
            "P": Image.fromarray(img[..., :3], "RGB").quantize(40)}


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("opts", [{}, {"optimize": True}, {"compress_level": 0}],
                         ids=["default", "optimize", "stored"])
def test_load_image_matches_pil(tmp_path, mode, opts):
    data = pil_png(colour_types()[mode], **opts)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32) / 255.0
    (tmp_path / "x.png").write_bytes(data)
    got = tio.load_image(tmp_path / "x.png")
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_png_filters_each_decode(tmp_path):
    """Every filter type on every row, written by hand (PIL chooses its own)."""
    img = make_image(9, 11)[..., :3]
    h, w, _ = img.shape
    for ftype in range(5):
        raw, prior = bytearray(), np.zeros(w * 3, np.int64)
        for y in range(h):
            cur = img[y].reshape(-1).astype(np.int64)
            left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
            upleft = np.concatenate([np.zeros(3, np.int64), prior[:-3]])
            if ftype == 4:
                p = left + prior - upleft
                pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
                pred = np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, prior, upleft))
            else:
                pred = [0 * cur, left, prior, (left + prior) // 2][ftype]
            raw += bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
            prior = cur

        def chunk(kind, body):
            return (struct.pack(">I", len(body)) + kind + body
                    + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

        png = (tio.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
               + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))
        np.testing.assert_array_equal(tio.decode_png(png), img, err_msg=f"filter {ftype}")
        ref = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
        np.testing.assert_array_equal(ref, img)


def adam7_png(px: np.ndarray, depth: int, ctype: int) -> bytes:
    """An Adam7-interlaced PNG of `px` ((H, W, C) samples), each pass's
    rows unfiltered (PIL writes no interlaced PNG)."""
    h, w = px.shape[:2]
    raw = b""
    for y0, x0, dy, dx in ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
                           (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)):
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = sub.astype(">u2" if depth == 16 else np.uint8).reshape(sub.shape[0], -1)
        for r in rows:
            raw += b"\x00" + r.tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (tio.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                            0, 0, 1))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_unsupported_inputs_raise(tmp_path):
    """JPEG frames are read by the port's codec as PIL reads them; 16-bit
    and Adam7-interlaced PNGs as PIL reads them; sub-byte PNGs and other
    files still raise."""
    img = make_image()[..., :3]
    Image.fromarray(img).save(tmp_path / "x.jpg", quality=90)
    np.testing.assert_array_equal(
        tio.read_rgb8(tmp_path / "x.jpg"),
        np.asarray(Image.open(tmp_path / "x.jpg").convert("RGB")))
    (tmp_path / "bad.jpg").write_bytes(b"\xff\xd8\xff\xd9")
    with pytest.raises(ValueError, match="bad.jpg"):
        tio.load_image(tmp_path / "bad.jpg")
    rng = np.random.default_rng(5)
    cases = [(img, 8, 2), (img[..., :1], 8, 0),
             (rng.integers(0, 65536, img.shape[:2] + (1,)), 16, 0),
             (rng.integers(0, 65536, img.shape), 16, 2),
             (rng.integers(0, 65536, img.shape[:2] + (4,)), 16, 6)]
    for px, depth, ctype in cases:
        png = adam7_png(px, depth, ctype)
        ref = Image.open(io.BytesIO(png))
        samples, got_type, _ = tio.decode_png_samples(png)
        assert got_type == ctype
        np.testing.assert_array_equal(samples, px, err_msg=f"{depth}-bit type {ctype}")
        if ref.mode in ("L", "I;16"):
            np.testing.assert_array_equal(samples[..., 0], np.asarray(ref))
        np.testing.assert_array_equal(tio.decode_png(png), np.asarray(ref.convert("RGB")),
                                      err_msg=f"{depth}-bit type {ctype} as RGB")
    sixteen = Image.fromarray(img[..., 0].astype(np.uint16) * 257)
    np.testing.assert_array_equal(tio.decode_png_samples(pil_png(sixteen))[0][..., 0],
                                  np.asarray(sixteen))
    two_bit = bytearray(pil_png(Image.fromarray(img[..., 0])))
    two_bit[24] = 2  # the IHDR's bit depth, its CRC rewritten
    two_bit[29:33] = struct.pack(">I", zlib.crc32(bytes(two_bit[12:29])) & 0xFFFFFFFF)
    with pytest.raises(ValueError, match="bit depth 2"):
        tio.decode_png(bytes(two_bit))
    with pytest.raises(ValueError, match="not a PNG"):
        tio.decode_png(b"GIF89a")


@pytest.mark.parametrize("hw", [(48, 70), (70, 48), (33, 33), (20, 90)])
def test_load_images_match_root_demo(tmp_path, hw):
    """The port's resize (Pillow's LANCZOS coefficients in fixed point,
    horizontal then vertical pass) equals PIL's to the bit, upscaling and
    downscaling, so the frames agree exactly."""
    rng = np.random.default_rng(1)
    for i in range(3):
        img = make_image(*hw, seed=i)[..., :3]
        img[hw[0] // 2:] = rng.integers(0, 256, img[hw[0] // 2:].shape)
        (tmp_path / f"{i:03d}.png").write_bytes(pil_png(Image.fromarray(img)))
    for size in (32, 40):
        got = tdemo.load_images(tmp_path, size)
        ref = root_demo.load_images(tmp_path, size)
        assert got.shape == ref.shape == (3, size, size, 3)
        np.testing.assert_array_equal(got, ref)


def test_load_images_refuses_jpeg_and_empty_dirs(tmp_path):
    """An empty directory raises; JPEG frames load as the root demo's
    `load_images` (PIL) loads them."""
    with pytest.raises(FileNotFoundError):
        tdemo.load_images(tmp_path)
    for i in range(2):
        Image.fromarray(make_image(48, 70, seed=i)[..., :3]).save(tmp_path / f"{i}.jpeg",
                                                                  quality=95)
    np.testing.assert_array_equal(tdemo.load_images(tmp_path, 32),
                                  root_demo.load_images(tmp_path, 32))


# ---- run_demo at toy size ----

@pytest.fixture(scope="module")
def toy():
    jcfg, tcfg = tiny_cfgs()
    return jcfg, tcfg, perturbed_params(jcfg)


def frames01(T, size=32, seed=2):
    return np.random.default_rng(seed).uniform(0, 1, (T, size, size, 3)).astype(np.float32)


K_DEMO = tdemo.intrinsics_from_fov(60.0)


def jax_rest(g_np, centers, poses, images, K, out_dir, steps):
    """The JAX demo's steps after the forward (export_ply, transforms.json,
    write_glb, interpolate_trajectory, decoder_forward) on given Gaussians
    and poses."""
    size = images.shape[1]
    n = j_export_ply(g_np.means.reshape(-1, 3), g_np.scales.reshape(-1, 3),
                     g_np.rotations.reshape(-1, 4),
                     g_np.harmonics.reshape(-1, *g_np.harmonics.shape[-2:]),
                     g_np.opacities.reshape(-1), out_dir / "gaussians.ply")
    j_write_glb(out_dir / "xyz_and_camera.glb", centers.reshape(-1, 3),
                images.reshape(-1, 3), camera_poses=poses, focal=float(K[0, 0]),
                cam_size=0.05)
    traj = j_interpolate_trajectory(jnp.asarray(poses), steps)
    V = traj.shape[0]
    g = JGaussians(*(jnp.asarray(x) for x in g_np))
    out = j_decoder_forward(JDecCfg(), g, traj[None],
                            jnp.broadcast_to(jnp.asarray(K), (1, V, 3, 3)),
                            jnp.full((1, V), 0.05), jnp.full((1, V), 100.0),
                            (size, size))
    return n, np.asarray(traj), np.asarray(out.color[0])


def host_gaussians(g):
    return JGaussians(*(x.float().numpy() for x in g))


def check_against_jax(res, out_dir, images, steps, tmp_path):
    """The port's files and frames against the JAX steps on the port's own
    forward output: the files to the byte, trajectory and frames within
    the stated tolerances. (The render starts from the same Gaussians on
    both sides: the 1/255 alpha cut turns the two forwards' float32
    rounding gaps into step changes of a pixel.)"""
    g = host_gaussians(res["gaussians"])
    jdir = tmp_path / "jax"
    jdir.mkdir()
    n, traj, colour = jax_rest(g, g.means, res["poses"], images, K_DEMO, jdir, steps)
    assert res["n_kept"] == n
    for name in ("gaussians.ply", "xyz_and_camera.glb"):
        assert (out_dir / name).read_bytes() == (jdir / name).read_bytes(), name
    np.testing.assert_allclose(res["trajectory"].numpy(), traj, atol=POSE_TOL, rtol=0)
    assert res["frames"].shape == colour.shape
    assert res["frames"].max() > 0.01
    np.testing.assert_allclose(res["frames"], colour, atol=IMG_TOL, rtol=0)
    tj = json.loads((out_dir / "transforms.json").read_text())
    assert len(tj["frames"]) == images.shape[0] and tj["w"] == images.shape[1]
    np.testing.assert_array_equal(
        np.asarray([f["transform_matrix"] for f in tj["frames"]], np.float32), res["poses"])
    video = out_dir / "render.mp4"
    assert video.exists() or len(list(video.with_suffix("").glob("*.png"))) == len(traj)


def test_run_demo_forward_matches_jax(toy, tmp_path):
    jcfg, tcfg, params = toy
    images = frames01(3)
    model = weights.load_jax_params(tvs.VicaSplat(tcfg), params).eval()
    res = tdemo.run_demo(tcfg, model, images, K_DEMO, tmp_path / "port",
                         steps_per_segment=4, dtype=torch.float32, device="cpu")
    ref = jax.jit(lambda p, b: jvs.vicasplat_forward(p, jcfg, b, dtype=jnp.float32))(
        params, {"image": jnp.asarray(images)[None] * 2.0 - 1.0,
                 "intrinsics": jnp.broadcast_to(jnp.asarray(K_DEMO), (1, 3, 3, 3))})
    np.testing.assert_allclose(res["poses"], np.asarray(ref["gaussian_camera_extrins"][0]),
                               atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(res["gaussians"].means.numpy(),
                               np.asarray(ref["gaussians"].means), atol=TOL, rtol=TOL)
    assert res["windows"] is None and res["frames"].shape == (9, 32, 32, 3)
    assert set(res["coverage"]) == {"live_frac", "truncated_frac", "tile_occupancy_mean",
                                    "tile_overflow_frac"}
    check_against_jax(res, tmp_path / "port", images, 4, tmp_path)


def test_run_demo_streams_long_clips_like_jax(toy, tmp_path):
    jcfg, tcfg, params = toy
    images = frames01(5, seed=3)
    model = weights.load_jax_params(tvs.VicaSplat(tcfg), params).eval()
    res = tdemo.run_demo(tcfg, model, images, K_DEMO, tmp_path / "port", window=3,
                         overlap=2, steps_per_segment=2, dtype=torch.float32,
                         device="cpu")
    eng = jserving.InferenceEngine(jcfg, params=params, dtype=jnp.float32)
    ref = jstreaming.reconstruct_video(eng, images, np.broadcast_to(K_DEMO, (5, 3, 3)),
                                       window=3, overlap=2)
    assert res["windows"]["count"] == len(ref.window_scales) == 3
    np.testing.assert_allclose(res["windows"]["scales"], ref.window_scales,
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(res["poses"], ref.poses.astype(np.float32),
                               atol=TOL, rtol=TOL)
    assert res["gaussians"].means.shape == (1, 5, 32, 32, 3)
    check_against_jax(res, tmp_path / "port", images, 2, tmp_path)


def test_demo_cli_end_to_end(tmp_path):
    """main(argv, device="cpu") with the backbone cut to the toy widths (the
    CLI builds the flagship): PNG frames of another size in, the four
    outputs out, and the same run from a checkpoint of the port."""
    net = dict(patch_size=16, enc_embed_dim=64, enc_depth=2, enc_num_heads=4,
               dec_embed_dim=48, dec_depth=2, dec_num_heads=4)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, img in enumerate(frames01(3, 40, seed=4)):
        (frames / f"{i:02d}.png").write_bytes(
            tio.encode_png((img[:, :30] * 255).astype(np.uint8)))
    out = tmp_path / "out"
    with mock.patch.object(tmodels, "VicaNetConfig",
                           lambda img_size: TNetCfg(img_size=img_size, **net)):
        res = tdemo.main(["--image_dir", str(frames), "--output_dir", str(out),
                          "--size", "32", "--steps_per_segment", "3"], device="cpu")
    assert res["frames"].shape == (7, 32, 32, 3)
    assert np.isfinite(res["frames"]).all()
    from vicasplat_tpu_torch.utils.ply import read_ply
    from vicasplat_tpu_torch.visualization.glb import read_glb_json

    assert read_ply(out / "gaussians.ply")["means"].shape[0] == res["n_kept"]
    assert len(json.loads((out / "transforms.json").read_text())["frames"]) == 3
    assert len(read_glb_json(out / "xyz_and_camera.glb")["meshes"]) == 4
    video = out / "render.mp4"
    assert video.exists() or video.with_suffix("").is_dir()
