"""Parity of the port's evaluation-index tools and metric recomputation with
the JAX package's on the CPU: the epipolar view overlap, the 2-view index
generator and its extension to N context views (chunk and scene-directory
layouts), `metric_computer` on saved renderings, and a tiny re10k_8view
test mode on chunks against the JAX package's test mode from the same
weights."""
import json
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_data_re10k import cameras_18, frame, pil_jpeg, trajectory
from tests.test_torch_train import jax_load, jax_weights_npz
from vicasplat_tpu import main as jmain
from vicasplat_tpu.evaluation import extend_index as jextend
from vicasplat_tpu.evaluation import metric_computer as jmetric
from vicasplat_tpu.evaluation import nvs_eval as jnvs
from vicasplat_tpu.evaluation.index_generator import EvaluationIndexGenerator as JGen
from vicasplat_tpu.evaluation.index_generator import IndexGeneratorConfig as JGenCfg
from vicasplat_tpu.geometry.epipolar import view_overlap_fraction as j_overlap
from vicasplat_tpu.utils.config import load_config as jload_config
from vicasplat_tpu_torch import main as tmain
from vicasplat_tpu_torch.evaluation import extend_index as textend
from vicasplat_tpu_torch.evaluation import index_generator as tindex
from vicasplat_tpu_torch.evaluation import metric_computer as tmetric
from vicasplat_tpu_torch.geometry.epipolar import view_overlap_fraction as t_overlap

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAIN = ROOT / "configs" / "main.yaml"
# a fraction of 32 x 32 rays, each decided by float32 projections of the
# same cameras: equal unless a sample point falls within float32 roundings
# of the image border; held at 1e-5 (less than one ray in 1024)
OVERLAP_TOL = 1e-5
# PSNR (a mean over views of float32 logs) and SSIM (a float32 filter) of
# the same PNG pixels
PSNR_TOL = 1e-4
SSIM_TOL = 1e-5


def camera_pair(seed):
    r = np.random.default_rng(seed)
    c2w, K = trajectory(40, seed=seed)
    i, j = r.integers(0, 40, 2)
    return c2w[i], K[i], c2w[j], K[j]


@pytest.mark.parametrize("seed", range(6))
def test_overlap_fraction_matches_jax(seed):
    ea, ka, eb, kb = camera_pair(seed)
    t = float(t_overlap(*(torch.from_numpy(x) for x in (ea, ka, eb, kb))))
    j = float(j_overlap(*(jnp.asarray(x) for x in (ea, ka, eb, kb))))
    assert abs(t - j) <= OVERLAP_TOL, (t, j)
    assert 0.0 < j <= 1.0


@pytest.fixture(scope="module")
def chunk_root(tmp_path_factory):
    """3 scenes of 60 frames (16x24 JPEGs) in one chunk of the test stage,
    and one of 5 frames."""
    root = tmp_path_factory.mktemp("chunks") / "test"
    root.mkdir()
    examples = []
    for s, n in enumerate((60, 60, 60, 5)):
        c2w, K = trajectory(n, seed=s)
        examples.append({"key": f"scene_{s}", "cameras": torch.from_numpy(cameras_18(c2w, K)),
                         "images": [torch.frombuffer(bytearray(pil_jpeg(frame(16, 24, i))),
                                                     dtype=torch.uint8) for i in range(n)],
                         "url": "", "timestamps": torch.arange(n)})
    torch.save(examples, root / "000000.torch")
    return root


GEN = {"num_target_views": 3, "min_distance": 5, "max_distance": 30,
       "min_overlap": 0.5, "max_overlap": 0.95, "seed": 4}


def test_index_generator_matches_jax(chunk_root, tmp_path):
    """The port's CLI on the chunks and the JAX generator on the same
    cameras: identical JSON (a short scene has no pair: null)."""
    from vicasplat_tpu.data.dataset_re10k import convert_poses

    path = tindex.main(["--data_root", str(chunk_root), "--output_path", str(tmp_path / "t"),
                        *[f"--{k}={v}" for k, v in GEN.items()]])
    gen = JGen(JGenCfg(output_path=str(tmp_path / "j"), **GEN))
    for ex in torch.load(chunk_root / "000000.torch", weights_only=True):
        gen.process_scene(ex["key"], *convert_poses(ex["cameras"].numpy()))
    jpath = gen.save()
    got = json.loads(pathlib.Path(path).read_text())
    assert got == json.loads(jpath.read_text())
    assert got["scene_3"] is None and any(v is not None for v in got.values())


@pytest.mark.parametrize("layout", ["chunks", "scene_dirs"])
def test_extend_index_matches_jax(chunk_root, tmp_path, layout):
    index = {"scene_0": {"context": [3, 20], "target": [5, 9, 14]},
             "scene_1": {"context": [40, 58], "target": [41, 50, 55]},
             "scene_2": None, "scene_3": {"context": [0, 4], "target": [1, 2, 3]}}
    (tmp_path / "i2.json").write_text(json.dumps(index))
    root = chunk_root
    if layout == "scene_dirs":
        root = tmp_path / "dirs"
        for s, n in enumerate((60, 60, 60, 5)):
            (root / f"scene_{s}").mkdir(parents=True)
            np.save(root / f"scene_{s}" / "extrinsics.npy", trajectory(n, seed=s)[0])
    args = ["--index_2v", str(tmp_path / "i2.json"), "--data_root", str(root),
            "--n_context", "8", "--n_target", "4", "--seed", "3"]
    if layout == "scene_dirs":
        args.append("--scene_dirs")
    textend.main([*args, "--output", str(tmp_path / "t.json")])
    jextend.main([*args, "--output", str(tmp_path / "j.json")])
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == json.loads((tmp_path / "j.json").read_text())
    assert len(got["scene_0"]["context"]) == 8


def test_metric_computer_matches_jax(tmp_path):
    """Two methods' renderings of two scenes against ground truth: the same
    summary within PSNR_TOL and SSIM_TOL, through the port's CLI."""
    gt = tmp_path / "gt"
    for s in range(2):
        for i in range(3):
            img = frame(32, 32, 10 * s + i)
            (gt / f"s{s}").mkdir(parents=True, exist_ok=True)
            Image.fromarray(img).save(gt / f"s{s}" / f"{i:03d}.png")
            for m, noise in (("m1", 8), ("m2", 30)):
                d = tmp_path / m / f"s{s}" / "color"
                d.mkdir(parents=True, exist_ok=True)
                noisy = img + np.random.default_rng(i).normal(0, noise, img.shape)
                Image.fromarray(np.clip(noisy, 0, 255).astype(np.uint8)).save(d / f"{i:03d}.png")
    got = tmetric.main([str(gt), str(tmp_path / "m1"), str(tmp_path / "m2"),
                        "--output_path", str(tmp_path / "out")])
    assert json.loads((tmp_path / "out/metrics.json").read_text()) == got
    ref = jmetric.MetricComputer(jmetric.MetricComputerConfig())
    for m in ("m1", "m2"):
        for s in range(2):
            ref.score_scene(m, f"s{s}", tmp_path / m / f"s{s}" / "color", gt / f"s{s}",
                            overlap=0.4)
    want = {k: v for k, v in ref.summary().items() if k.endswith("/all")}
    assert sorted(got) == sorted(want) == ["m1/all", "m2/all"]
    for group in want:
        assert abs(got[group]["psnr"] - want[group]["psnr"]) <= PSNR_TOL
        assert abs(got[group]["ssim"] - want[group]["ssim"]) <= SSIM_TOL
    assert got["m1/all"]["psnr"] > got["m2/all"]["psnr"]
    assert tmetric.get_overlap_tag(0.4) == jmetric.get_overlap_tag(0.4) == "medium"


# ---- the re10k_8view test mode on chunks, at toy size ----

TOY = ["encoder.backbone.img_size=32", "encoder.backbone.enc_embed_dim=64",
       "encoder.backbone.enc_depth=2", "encoder.backbone.enc_num_heads=4",
       "encoder.backbone.dec_embed_dim=48", "encoder.backbone.dec_depth=2",
       "encoder.backbone.dec_num_heads=4", "dataset.re10k.input_image_shape=[32,32]",
       "dataset.re10k.original_image_shape=[36,64]", "test.pose_align_steps=2",
       "test.save_image=false", "test.save_compare=false"]
# both sides encode in bf16 (the test mode's forward), render and align in
# float32 with 2 Adam steps: measured per-scene gaps 2e-6 dB, 4e-10 SSIM
# and 0 ATE; held at a tenth of the card's test-mode limits against the
# JAX package (chip_smoke.py EVAL_TOL: 0.15 dB, 0.01, 0.01)
E2E_TOL = {"psnr": 0.015, "ssim": 0.001, "ate": 0.001}


def test_re10k_test_mode_matches_jax(tmp_path):
    """`main(mode=test)` of re10k_8view on chunks the tests write (36x64
    frames cropped to 32x32, an 8-view evaluation index): the port's
    per-scene scores against the JAX package's test mode from the same
    weights, and the same output files."""
    root = tmp_path / "re10k" / "test"
    root.mkdir(parents=True)
    examples, index = [], {}
    for s in range(2):
        c2w, K = trajectory(20, seed=s)
        examples.append({"key": f"s{s}", "cameras": torch.from_numpy(cameras_18(c2w, K)),
                         "images": [torch.frombuffer(bytearray(pil_jpeg(frame(36, 64, i + s),
                                                                        quality=95)),
                                                     dtype=torch.uint8) for i in range(20)],
                         "url": "", "timestamps": torch.arange(20)})
        index[f"s{s}"] = {"context": list(range(s, s + 16, 2)), "target": [3, 10],
                          "overlap": 0.5}
    torch.save(examples, root / "000000.torch")
    (tmp_path / "index.json").write_text(json.dumps(index))
    args = [*TOY, f"dataset.re10k.roots=[{tmp_path / 're10k'}]",
            "dataset.re10k.view_sampler={name: evaluation, index_path: "
            f"{tmp_path / 'index.json'}, num_context_views: 8}}"]
    jcfg = jload_config(MAIN, "re10k_8view", args)
    npz = jax_weights_npz(tmp_path / "w.npz", jcfg)
    args += [f"checkpointing.load={npz}", "mode=test"]
    jscenes = []
    save = jnvs.save_scene_outputs

    def record(r, *a, **kw):
        jscenes.append(r)
        return save(r, *a, **kw)

    with mock.patch("vicasplat_tpu.utils.checkpointing.load_weights", jax_load), \
            mock.patch("vicasplat_tpu.evaluation.nvs_eval.save_scene_outputs", record):
        jmain.main(["+experiment=re10k_8view", *args, f"test.output_path={tmp_path}/j"])
    summary, results = tmain.main(["+experiment=re10k_8view", *args,
                                   f"test.output_path={tmp_path}/t"], device="cpu")
    assert [r["scene"] for r in results] == [r["scene"] for r in jscenes] == ["s0", "s1"]
    for t, j in zip(results, jscenes):
        for k, tol in E2E_TOL.items():
            assert np.isfinite(t[k]) and abs(t[k] - float(j[k])) <= tol, (t["scene"], k)
    for name in ("scores_all_avg.json", "benchmark.json", "s0/transforms.json"):
        assert (tmp_path / "t" / name).exists() and (tmp_path / "j" / name).exists()
    assert summary["n_scenes"] == 2
    assert jax.devices()[0].platform == "cpu"
