"""Parity of the port's RE10K data path with the JAX package's on the CPU:
the port's JPEG codec (utils/host_image.py, csrc/image_host.cpp) against
the JAX package's `decode_jpegs_u8` (libjpeg, or PIL) and PIL's encoder,
the crop shims, `DatasetRE10k` on chunks the tests write (every sampler,
sharded over workers), the ScanNet reader on scene directories, the COLMAP
loader and `convert_scenes`. Frames are written by PIL here; the card's
machine has no PIL, and the port reads them without it."""
import dataclasses
import io
import json
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from vicasplat_tpu.data import colmap as jcolmap
from vicasplat_tpu.data import convert_scripts as jconvert
from vicasplat_tpu.data import shims as jshims
from vicasplat_tpu.data.data_module import _build_dataset as jbuild_dataset
from vicasplat_tpu.data.dataset_re10k import decode_jpegs_u8 as jdecode
from vicasplat_tpu.utils.config import load_config as jload_config
from vicasplat_tpu_torch import main as tmain
from vicasplat_tpu_torch.data import colmap as tcolmap
from vicasplat_tpu_torch.data import convert_scripts as tconvert
from vicasplat_tpu_torch.data import shims as tshims
from vicasplat_tpu_torch.data.data_module import DataModule
from vicasplat_tpu_torch.data.data_module import _build_dataset as tbuild_dataset
from vicasplat_tpu_torch.utils import host_image
from vicasplat_tpu_torch.utils.config import load_config
from vicasplat_tpu_torch.utils.image_io import resize_bicubic, resize_lanczos

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAIN = ROOT / "configs" / "main.yaml"
# cameras: the same float32 numpy on both sides (inverse, normalization):
# equal, held at 1e-6
CAM_TOL = 1e-6


def frame(h, w, seed=0):
    """A uint8 frame with edges, gradients and noise."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y * (seed + 1)) % 256, (x * y // 7) % 256,
                     (255 - x + 2 * y) % 256], -1).astype(np.float64)
    base += r.normal(0, 25, base.shape)
    base[h // 3:h // 2, w // 4:w // 2] = r.integers(0, 256, 3)
    return np.clip(base, 0, 255).astype(np.uint8)


def pil_jpeg(a, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(a).save(b, format="JPEG", **kw)
    return b.getvalue()


def trajectory(n, seed=0):
    """c2w (n, 4, 4) along a gently turning path, normalized K (n, 3, 3)."""
    r = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    c2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    yaw = 0.3 * t + 0.01 * r.normal(size=n)
    c2w[:, 0, 0], c2w[:, 0, 2] = np.cos(yaw), np.sin(yaw)
    c2w[:, 2, 0], c2w[:, 2, 2] = -np.sin(yaw), np.cos(yaw)
    c2w[:, :3, 3] = np.stack([2.0 * t, 0.1 * np.sin(6 * t), 0.3 * t], -1)
    K = np.tile(np.array([[0.9, 0, 0.5], [0, 1.6, 0.5], [0, 0, 1]], np.float32), (n, 1, 1))
    return c2w.astype(np.float32), K


def cameras_18(c2w, K):
    w2c = np.linalg.inv(c2w)
    out = np.zeros((len(c2w), 18), np.float32)
    out[:, 0], out[:, 1], out[:, 2], out[:, 3] = K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]
    out[:, 6:] = w2c[:, :3].reshape(-1, 12)
    return out


# ---- the JPEG codec ----

DECODE_CASES = ([(37, 53, q, s) for q in (50, 90, 95) for s in (0, 1, 2)]
                + [(360, 640, 95, s) for s in (0, 1, 2)])


@pytest.mark.parametrize("h,w,quality,subsampling", DECODE_CASES)
def test_decode_matches_jax(h, w, quality, subsampling):
    """4:4:4, 4:2:2 and 4:2:0 at qualities 50, 90 and 95, a size that is no
    multiple of the MCU and RE10K's 360x640: equal byte for byte."""
    raws = [pil_jpeg(frame(h, w, s), quality=quality, subsampling=subsampling)
            for s in range(3)]
    got = host_image.decode_jpegs_u8(raws)
    np.testing.assert_array_equal(got, jdecode(raws))
    np.testing.assert_array_equal(got[0], np.asarray(Image.open(io.BytesIO(raws[0]))))


@pytest.mark.parametrize("kind", ["grey", "restart_blocks", "restart_rows", "tensor"])
def test_decode_grey_restarts_and_tensors(kind):
    img = frame(37, 53)
    if kind == "grey":
        raw = pil_jpeg(img[..., 0], quality=90)
    elif kind == "restart_blocks":
        raw = pil_jpeg(img, quality=90, restart_marker_blocks=2)
    elif kind == "restart_rows":
        raw = pil_jpeg(img, quality=90, subsampling=0, restart_marker_rows=1)
    else:
        raw = pil_jpeg(img, quality=95)
    if kind.startswith("restart"):
        assert b"\xff\xdd" in raw and b"\xff\xd0" in raw  # DRI and RST0
    buf = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if kind == "tensor" else raw
    got = host_image.decode_jpegs_u8([buf, buf])
    np.testing.assert_array_equal(got, jdecode([raw, raw]))


def test_decode_refuses_other_streams():
    """Progressive, arithmetic-coded, 12-bit, CMYK, truncated streams and
    batches of mixed sizes raise ValueError naming the frame."""
    good = pil_jpeg(frame(37, 53), quality=90)
    sof = good.index(b"\xff\xc0")
    arith = good[:sof + 1] + b"\xc9" + good[sof + 2:]
    twelve = good[:sof + 4] + b"\x0c" + good[sof + 5:]
    b = io.BytesIO()
    Image.fromarray(frame(16, 16)).convert("CMYK").save(b, format="JPEG")
    cmyk = b.getvalue()
    cases = {"progressive": pil_jpeg(frame(37, 53), progressive=True),
             "arithmetic": arith, "12-bit": twelve, "4 components": cmyk,
             "truncated|ends early|EOI": good[:len(good) // 2],
             "differs from the batch": pil_jpeg(frame(16, 16))}
    for msg, raw in cases.items():
        with pytest.raises(ValueError, match=f"JPEG frame 1: .*({msg})"):
            host_image.decode_jpegs_u8([good, raw])


def test_decode_survives_corrupt_streams():
    """Bytes of a stream overwritten at random (headers and entropy data):
    each decode returns a frame of the batch's size or raises ValueError;
    none crashes the process."""
    good = pil_jpeg(frame(37, 53), quality=90, restart_marker_blocks=3)
    rng = np.random.default_rng(0)
    decoded = refused = 0
    for _ in range(300):
        bad = bytearray(good)
        for pos in rng.integers(2, len(bad), rng.integers(1, 4)):
            bad[pos] = int(rng.integers(0, 256))
        try:
            out = host_image.decode_jpegs_u8([good, bytes(bad)])
        except ValueError as e:
            assert str(e).startswith("JPEG frame 1: ")
            refused += 1
        else:
            assert out.shape == (2, 37, 53, 3)
            decoded += 1
    assert decoded and refused


def header_only_jpeg(w, h) -> bytes:
    """SOI, a baseline frame header declaring w x h with 3 components at
    4:2:0, and EOI: no tables, no scan."""
    sof = bytes([0xFF, 0xC0, 0, 17, 8, h >> 8, h & 255, w >> 8, w & 255, 3,
                 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    return b"\xff\xd8" + sof + b"\xff\xd9"


@pytest.mark.parametrize("case", ["over_pil_limit", "too_large_for_stream"])
def test_decode_refuses_oversized_frames(case):
    """A frame header that declares more pixels than PIL's limit, or more
    blocks than the stream's bits could code, is refused before any plane
    or output is allocated: ValueError naming the frame, and the process's
    peak memory grows by far less than one such frame."""
    import resource

    if case == "over_pil_limit":
        raw, msg = header_only_jpeg(65535, 65535), "larger than the limit"
    else:  # a real stream's tables and scan, its frame header claiming 12000^2
        good = pil_jpeg(frame(37, 53), quality=90)
        sof = good.index(b"\xff\xc0")
        raw = good[:sof + 5] + bytes([12000 >> 8, 12000 & 255] * 2) + good[sof + 9:]
        msg = "cannot hold a frame of 12000x12000"
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KiB
    with pytest.raises(ValueError, match=msg):
        host_image.jpeg_info(raw)
    with pytest.raises(ValueError, match=f"JPEG frame 0: .*{msg}"):
        host_image.decode_jpegs_u8([raw, raw])
    good = pil_jpeg(frame(37, 53), quality=90)
    with pytest.raises(ValueError, match=f"JPEG frame 1: .*{msg}"):
        host_image.decode_jpegs_u8([good, raw])
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - peak
    assert grown < 256 * 1024, f"peak memory grew by {grown} KiB"


@pytest.mark.parametrize("h,w,quality", [(37, 53, 50), (37, 53, 95), (360, 640, 95),
                                         (17, 1, 95), (1, 30, 90), (3, 5, 75)])
def test_encode_matches_pil(h, w, quality):
    """The port's baseline 4:2:0 encoder: PIL decodes its file into the
    pixels it decodes from its own, and the entropy-coded data is PIL's
    (sizes that leave partial MCUs and dummy blocks on either edge)."""
    imgs = np.stack([frame(h, w, s) for s in range(2)])
    mine = host_image.encode_jpegs(imgs, quality=quality)
    for img, raw in zip(imgs, mine):
        pil = pil_jpeg(img, quality=quality)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(raw))),
                                      np.asarray(Image.open(io.BytesIO(pil))))
        assert raw[raw.index(b"\xff\xda"):] == pil[pil.index(b"\xff\xda"):]
        np.testing.assert_array_equal(host_image.decode_jpeg(raw),
                                      np.asarray(Image.open(io.BytesIO(raw))))


# ---- resize and crop ----

@pytest.mark.parametrize("size", [(455, 256), (64, 36), (30, 40), (700, 400)])
def test_resize_batch_matches_pil(size):
    """The host library's 8-bit LANCZOS and BICUBIC batches, and the 16-bit
    BICUBIC (PIL's I;16) in numpy, equal to PIL byte for byte."""
    imgs = np.stack([frame(360, 640, s) for s in range(2)])
    for name, pil_filter in (("lanczos", Image.LANCZOS), ("bicubic", Image.BICUBIC)):
        got = host_image.resize_batch(imgs, size, name)
        for img, g in zip(imgs, got):
            np.testing.assert_array_equal(
                g, np.asarray(Image.fromarray(img).resize(size, pil_filter)))
    np.testing.assert_array_equal(got[0], resize_bicubic(imgs[0], size))
    np.testing.assert_array_equal(resize_lanczos(imgs[0], size),
                                  np.asarray(Image.fromarray(imgs[0]).resize(size, Image.LANCZOS)))
    depth = np.random.default_rng(0).integers(0, 65536, (48, 64)).astype(np.uint16)
    np.testing.assert_array_equal(resize_bicubic(depth, size),
                                  np.asarray(Image.fromarray(depth).resize(size)))
    np.testing.assert_array_equal(resize_bicubic(imgs[0], size),
                                  np.asarray(Image.fromarray(imgs[0]).resize(size)))


@pytest.mark.parametrize("hw,shape", [((360, 640), (256, 256)), ((36, 64), (32, 32)),
                                      ((48, 40), (24, 24))])
def test_crop_shims_match_jax(hw, shape):
    """u8 and float rescale-and-crop, the depth crop and the example shim:
    images equal byte for byte, intrinsics within CAM_TOL."""
    imgs = np.stack([frame(*hw, s) for s in range(3)])
    _, K = trajectory(3)
    (ti, tk), (ji, jk) = (m.rescale_and_crop_u8(imgs, K, shape) for m in (tshims, jshims))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tk, jk, atol=CAM_TOL)
    depth = np.random.default_rng(1).uniform(0.5, 9, (3, *hw)).astype(np.float32)
    ex = {side: {"image": imgs.astype(np.float32) / 255, "intrinsics": K, "depth": depth}
          for side in ("context", "target")}
    t, j = tshims.apply_crop_shim(ex, shape), jshims.apply_crop_shim(ex, shape)
    for side in ("context", "target"):
        for key in ("image", "depth"):
            np.testing.assert_array_equal(t[side][key], j[side][key], err_msg=key)
        np.testing.assert_allclose(t[side]["intrinsics"], j[side]["intrinsics"], atol=CAM_TOL)


# ---- DatasetRE10k on chunks ----

N_FRAMES = (24, 30, 20, 27)


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    """4 scenes of 36x64 JPEG frames in 2 chunks of each stage, an index.json
    each, and an evaluation index."""
    root = tmp_path_factory.mktemp("re10k")
    for stage in ("train", "test"):
        (root / stage).mkdir()
        index = {}
        for c in range(2):
            examples = []
            for k in range(2):
                s = 2 * c + k
                c2w, K = trajectory(N_FRAMES[s], seed=s)
                examples.append({
                    "key": f"{stage}_{s:02d}",
                    "cameras": torch.from_numpy(cameras_18(c2w, K)),
                    "images": [torch.frombuffer(bytearray(pil_jpeg(frame(36, 64, 7 * s + i),
                                                                   quality=90)),
                                                dtype=torch.uint8)
                               for i in range(N_FRAMES[s])],
                    "url": "", "timestamps": torch.arange(N_FRAMES[s])})
                index[f"{stage}_{s:02d}"] = f"{c:06d}.torch"
            torch.save(examples, root / stage / f"{c:06d}.torch")
        (root / stage / "index.json").write_text(json.dumps(index))
    ev = {f"test_{s:02d}": {"context": [1, 5, 9], "target": [2, 6], "overlap": 0.4}
          for s in range(3)}
    ev["test_03"] = None
    (root / "index_eval.json").write_text(json.dumps(ev))
    return root


SAMPLERS = {
    "sequential": {"name": "sequential", "num_context_views": 3, "num_target_views": 2,
                   "min_distance_between_context_views": 2,
                   "max_distance_between_context_views": 5},
    "bounded": {"name": "bounded", "num_context_views": 3, "num_target_views": 2,
                "min_distance_between_context_views": 4,
                "max_distance_between_context_views": 9},
    "evaluation": {"name": "evaluation", "num_context_views": 3},
}


def _ds_dict(chunks, sampler):
    s = dict(SAMPLERS[sampler])
    if sampler == "evaluation":
        s["index_path"] = str(chunks / "index_eval.json")
    return {"name": "re10k", "roots": [str(chunks)], "input_image_shape": [32, 32],
            "view_sampler": s}


def assert_examples_equal(t, j):
    assert [e["scene"] for e in t] == [e["scene"] for e in j]
    for te, je in zip(t, j):
        for side in ("context", "target"):
            a, b = te[side], je[side]
            assert set(a) == set(b)
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["index"], b["index"])
            for k in ("extrinsics", "intrinsics", "near", "far"):
                np.testing.assert_allclose(a[k], b[k], rtol=CAM_TOL, atol=CAM_TOL, err_msg=k)


@pytest.mark.parametrize("sampler,stage", [("sequential", "train"), ("sequential", "test"),
                                           ("bounded", "train"), ("evaluation", "test")])
@pytest.mark.parametrize("workers", [1, 2])
def test_dataset_re10k_matches_jax(chunks, sampler, stage, workers):
    """Every example of every shard: images equal, cameras, near/far within
    CAM_TOL, indices equal, at the same seed (train: shuffled chunks and
    examples, the reflection augmentation)."""
    ds = _ds_dict(chunks, sampler)
    t = tbuild_dataset(ds, stage, None, 11, "cpu")
    j = jbuild_dataset(ds, stage, None, 11)
    n = 0
    for w in range(workers):
        te, je = list(t.iter_shard(w, workers)), list(j.iter_shard(w, workers))
        assert_examples_equal(te, je)
        n += len(te)
    assert n == (3 if sampler == "evaluation" else 4)
    assert t.index == j.index


@pytest.mark.parametrize("experiment", sorted(p.stem for p in (ROOT / "configs/experiment")
                                               .glob("*.yaml")))
def test_every_experiment_dataset_builds(experiment):
    """Each dataset an experiment names builds on both sides for train and
    test (no data under the configured roots): the same reader and the
    same sampler configuration."""
    tcfg = load_config(MAIN, experiment, [])
    jcfg = jload_config(MAIN, experiment, [])
    for name, ds in tcfg.dataset.items():
        ds = dict(ds, name=ds.get("name", name))
        for stage in ("train", "test"):
            t = tbuild_dataset(ds, stage, None, 0, "cpu")
            j = jbuild_dataset(dict(jcfg.dataset[name], name=ds["name"]), stage, None, 0)
            assert type(t).__name__ == type(j).__name__
            assert dataclasses.asdict(t.view_sampler.cfg) == dataclasses.asdict(j.view_sampler.cfg)


def test_sharded_train_loader(chunks):
    """The train loader with 2 workers: one producer a shard and a
    collator, every example once per pass (in either shard's order)."""
    dm = DataModule({"re10k": _ds_dict(chunks, "sequential")},
                    {"train": {"batch_size": 2, "num_workers": 2, "seed": 3}}, device="cpu")
    loader = dm.train_dataloader()
    try:
        batches = [next(loader) for _ in range(2)]
    finally:
        loader.close()
    assert all(not th.is_alive() for th in loader._threads)
    scenes = sorted(s for b in batches for s in b["scene"])
    assert scenes == ["train_00", "train_01", "train_02", "train_03"]
    assert batches[0]["context"]["image"].shape == (2, 3, 32, 32, 3)


def test_re10k_train_mode_from_chunks(chunks, tmp_path):
    """main(mode=train) of re10k_8view on the chunks at toy widths, 2 steps
    with the reader sharded over 2 workers: finite losses, the step count,
    a checkpoint, and no loader thread left."""
    import threading

    threads = set(threading.enumerate())
    r = tmain.main([
        "+experiment=re10k_8view", "mode=train", f"dataset.re10k.roots=[{chunks}]",
        "dataset.re10k.input_image_shape=[32,32]", "dataset.re10k.original_image_shape=[36,64]",
        "dataset.re10k.view_sampler={name: sequential, num_context_views: 3, "
        "num_target_views: 2, min_distance_between_context_views: 2, "
        "max_distance_between_context_views: 5}",
        "data_loader.train.num_workers=2", "encoder.backbone.img_size=32",
        "encoder.backbone.enc_embed_dim=64", "encoder.backbone.enc_depth=2",
        "encoder.backbone.enc_num_heads=4", "encoder.backbone.dec_embed_dim=48",
        "encoder.backbone.dec_depth=2", "encoder.backbone.dec_num_heads=4",
        "trainer.precision=float32", "trainer.max_steps=2", "train.print_log_every_n_steps=1",
        "wandb.mode=offline", "checkpointing.async_save=false", f"output_dir={tmp_path}",
        f"checkpointing.output_dir={tmp_path}/ckpts"], device="cpu")
    assert r["step"] == 2 and [x["step"] for x in r["logs"]] == [1, 2]
    assert all(np.isfinite(x[k]) for x in r["logs"] for k in ("loss", "mse", "camera", "psnr"))
    assert (tmp_path / "ckpts" / "step_00000002.npz").exists()
    assert not [t for t in set(threading.enumerate()) - threads if t.is_alive()]


# ---- ScanNet, COLMAP, conversion ----

def test_scannet_matches_jax(tmp_path):
    """Scene directories (JPEG colour, 16-bit depth PNGs in millimetres):
    both readers give the same examples, images and depths equal."""
    root = tmp_path / "scannet"
    names = ["scene0000_00", "scene0001_00"]
    for s, name in enumerate(names):
        d = root / "test" / name
        for sub in ("color", "depth", "intrinsic"):
            (d / sub).mkdir(parents=True)
        c2w, _ = trajectory(8, seed=s)
        np.save(d / "extrinsics.npy", c2w)
        K4 = np.eye(4)
        K4[0, 0], K4[1, 1], K4[0, 2], K4[1, 2] = 50.0, 52.0, 32.0, 24.0
        np.savetxt(d / "intrinsic" / "intrinsic_color.txt", K4)
        for i in range(8):
            Image.fromarray(frame(48, 64, i + s)).save(d / "color" / f"{i}.jpg", quality=90)
            dep = np.random.default_rng(i).integers(300, 6000, (48, 64)).astype(np.uint16)
            Image.fromarray(dep).save(d / "depth" / f"{i}.png")
    (root / "test_idx.txt").write_text("\n".join(names))
    idx = tmp_path / "idx.json"
    idx.write_text(json.dumps({n: {"context": [0, 3, 6], "target": [1, 5]} for n in names}))
    ds = {"name": "scannet", "roots": [str(root)], "input_image_shape": [64, 64],
          "view_sampler": {"name": "evaluation", "index_path": str(idx),
                           "num_context_views": 3}}
    t = list(tbuild_dataset(ds, "test", None, 0, "cpu"))
    j = list(jbuild_dataset(ds, "test", None, 0))
    assert len(t) == len(j) == 2
    assert_examples_equal(t, j)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a["context"]["depth"], b["context"]["depth"])


def test_colmap_matches_jax(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "# camera list\n1 PINHOLE 640 480 500 510 320 240\n2 SIMPLE_RADIAL 320 240 300 160 120 0.01\n")
    (tmp_path / "images.txt").write_text(
        "# image list\n"
        "2 0.9 0.1 0.2 0.3 1.0 2.0 3.0 1 b.jpg\n10 20 -1\n"
        "1 0.7 -0.1 0.5 0.2 -1.0 0.5 2.0 2 a.jpg\n\n")
    te, tk, tn = tcolmap.load_colmap_scene(tmp_path)
    je, jk, jn = jcolmap.load_colmap_scene(tmp_path)
    assert tn == jn == ["a.jpg", "b.jpg"]
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tk, jk)


def test_convert_scenes_matches_jax(tmp_path):
    """PNG frames with pixel intrinsics in cameras.npz, JPEG frames with
    transforms.json: the same index and cameras, and the same pixels from
    every stored JPEG (PNG frames encoded at quality 95)."""
    src = tmp_path / "scenes"
    a = src / "scene_a" / "images"
    a.mkdir(parents=True)
    c2w, K = trajectory(4)
    for i in range(4):
        Image.fromarray(frame(36, 64, i)).save(a / f"{i:03d}.png")
    Kpix = K.copy()
    Kpix[:, 0] *= 64
    Kpix[:, 1] *= 36
    np.savez(src / "scene_a" / "cameras.npz", intrinsics=Kpix, extrinsics_c2w=c2w)
    b = src / "scene_b"
    b.mkdir()
    for i in range(3):
        Image.fromarray(frame(36, 64, 9 + i)).save(b / f"{i}.jpg", quality=85)
    (b / "transforms.json").write_text(json.dumps({
        "w": 64, "h": 36, "fl_x": 50.0, "fl_y": 49.0,
        "frames": [{"transform_matrix": m.tolist()} for m in c2w[:3]]}))
    (src / "not_a_scene").mkdir()
    tconvert.main(["--input_dir", str(src), "--output_dir", str(tmp_path / "t")])
    jconvert.convert_scenes(src, tmp_path / "j")
    ti = json.loads((tmp_path / "t/test/index.json").read_text())
    assert ti == json.loads((tmp_path / "j/test/index.json").read_text())
    assert sorted(ti) == ["scene_a", "scene_b"]
    tc = torch.load(tmp_path / "t/test/000000.torch", weights_only=True)
    jc = torch.load(tmp_path / "j/test/000000.torch", weights_only=False)
    for te, je in zip(tc, jc):
        assert te["key"] == je["key"]
        np.testing.assert_allclose(te["cameras"].numpy(), je["cameras"].numpy(), atol=CAM_TOL)
        for x, y in zip(te["images"], je["images"]):
            np.testing.assert_array_equal(
                np.asarray(Image.open(io.BytesIO(x.numpy().tobytes()))),
                np.asarray(Image.open(io.BytesIO(y.numpy().tobytes()))))
