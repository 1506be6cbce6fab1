"""The train and test modes of `re10k_2view`, `acid_2view` and
`re10k_4view` at toy widths on the CPU (the configs' own settings as in
tests/test_torch_experiments.py, whose chunks and toy arguments these
reuse), and the ScanNet layout that chip_smoke.py's experiments phase
writes:

- `main(mode=train)` for 2 steps from the chunks, then `main(mode=test)`
  on one indexed scene with the checkpoint it wrote (re10k_4view on a
  4-view index by extend_index, in the accelerator configuration);
- chip_smoke.py's ScanNet-layout writer read back by both readers, and
  `eval_pose` with `dataset=scannet_pose` on what it wrote.
"""
import json
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_data_re10k import assert_examples_equal, frame, pil_jpeg, trajectory
from test_torch_experiments import EXPERIMENTS, MAIN, TOY, chunks, dataset_key, toy_args  # noqa: F401

import chip_smoke
from vicasplat_tpu.data import data_module as jdm
from vicasplat_tpu_torch import eval_pose as teval_pose
from vicasplat_tpu_torch import main as tmain
from vicasplat_tpu_torch.data import data_module as tdm
from vicasplat_tpu_torch.evaluation import extend_index
from vicasplat_tpu_torch.utils.config import load_config

torch.set_num_threads(1)


def train_then_test(experiment, chunks, out, extra_test=()):
    """main(mode=train) for 2 steps from the chunks, then main(mode=test)
    on one scene of the 2-view index (or its 4-view extension) with the
    checkpoint it wrote."""
    ds = dataset_key(experiment)
    args = toy_args(experiment, chunks)
    r = tmain.main([f"+experiment={experiment}", "mode=train", *args, "trainer.max_steps=2",
                    "train.print_log_every_n_steps=1", "trainer.val_check_interval=0",
                    "wandb.mode=disabled", "checkpointing.async_save=false",
                    f"output_dir={out}", f"checkpointing.output_dir={out}/ckpts"], device="cpu")
    assert r["step"] == 2 and [x["step"] for x in r["logs"]] == [1, 2]
    assert all(np.isfinite(x[k]) for x in r["logs"]
               for k in ("loss", "mse", "camera", "psnr", "grad_norm"))
    assert "lpips" not in r["logs"][0]
    ckpt = out / "ckpts" / "step_00000002.npz"
    assert ckpt.exists()
    n_ctx = tcfg_views(experiment)
    index = chunks / "index_2v.json"
    if n_ctx != 2:
        index = out / f"index_{n_ctx}v.json"
        ext = extend_index.main(["--index_2v", str(chunks / "index_2v.json"), "--data_root",
                                 str(chunks / "test"), "--n_context", str(n_ctx),
                                 "--n_target", "3", "--output", str(index)])
        assert len(ext["test_00"]["context"]) == n_ctx
    summary, results = tmain.main([
        f"+experiment={experiment}", "mode=test", *args,
        f"dataset.{ds}.view_sampler={{name: evaluation, index_path: {index}, "
        f"num_context_views: {n_ctx}}}", "test.pose_align_steps=2",
        f"test.output_path={out}/test", f"checkpointing.load={ckpt}", *extra_test],
        device="cpu")
    assert [x["scene"] for x in results] == ["test_00"]
    assert all(np.isfinite(results[0][k]) for k in ("psnr", "ssim", "ate"))
    assert summary["n_scenes"] == 1
    for name in ("scores_all_avg.json", "benchmark.json", "peak_memory.json",
                 "test_00/transforms.json", "test_00/compare.png", "test_00/color/000.png",
                 f"test_00/context/{n_ctx - 1:03d}.png"):
        assert (out / "test" / name).exists(), name


def tcfg_views(experiment):
    return load_config(MAIN, experiment, []).dataset[dataset_key(experiment)][
        "view_sampler"]["num_context_views"]


# the accelerator configuration, as chip_smoke.py's experiments phase tests
# re10k_4view (on the CPU each kernel's plain version)
ACCEL = ("encoder.head_tail_backend=pallas", "decoder.rasterize.backend=pallas",
         "decoder.rasterize.binning=origin")


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_train_and_test_modes(experiment, chunks, tmp_path):
    torch.set_num_threads(1)
    train_then_test(experiment, chunks, tmp_path,
                    ACCEL if experiment == "re10k_4view" else ())


def test_scannet_layout_round_trip(tmp_path):
    """chip_smoke.py's ScanNet writer on a 2-frame scene at ScanNet's
    480x640: the JPEG files are PIL's at quality 95, byte for byte; both
    readers give the same example, with the files' pixels, the millimetres
    written as depths and the cameras given; then `eval_pose` with
    `dataset=scannet_pose` at toy widths gives a finite ATE and pose AUCs."""
    torch.set_num_threads(1)
    h, w = 480, 640
    frames = np.stack([frame(h, w, i) for i in range(2)])
    depth = np.random.default_rng(0).uniform(0.3, 6.0, (2, h, w))
    depth[0, :8] = 0.0  # no depth
    c2w, K = trajectory(2)
    root = tmp_path / "scannet"
    chip_smoke.write_scannet_scene(root / "test" / "scene0000_00", frames, depth, c2w, K[0])
    (root / "test_idx.txt").write_text("scene0000_00\n")
    idx = tmp_path / "idx.json"
    idx.write_text(json.dumps({"scene0000_00": {"context": [0, 1], "target": [0, 1]}}))
    ds = {"name": "scannet_pose", "roots": [str(root)], "input_image_shape": [h, w],
          "make_baseline_1": False, "relative_pose": False,
          "view_sampler": {"name": "evaluation", "index_path": str(idx),
                           "num_context_views": 2}}
    t = list(tdm._build_dataset(ds, "test", None, 0, "cpu"))
    j = list(jdm._build_dataset(ds, "test", None, 0))
    assert_examples_equal(t, j)
    ctx = t[0]["context"]
    np.testing.assert_array_equal(ctx["depth"], j[0]["context"]["depth"])
    np.testing.assert_allclose(ctx["depth"], np.round(depth * 1000) / 1000, atol=1e-6)
    np.testing.assert_allclose(ctx["intrinsics"], K, atol=1e-6)
    np.testing.assert_allclose(ctx["extrinsics"], c2w, atol=1e-6)
    for i in range(2):
        path = root / "test/scene0000_00/color" / f"{i}.jpg"
        assert path.read_bytes() == pil_jpeg(frames[i], quality=95)
        np.testing.assert_array_equal(np.round(ctx["image"][i] * 255), np.asarray(Image.open(path)))

    out = tmp_path / "pose"
    scannet = (f"dataset={{scannet_pose: {{name: scannet_pose, roots: [{root}], "
               f"view_sampler: {{name: evaluation, index_path: {idx}, "
               "num_context_views: 2}}}")
    ev = teval_pose.main(["+experiment=re10k_2view", *TOY, scannet,
                          f"test.output_path={out}"], device="cpu")
    summary = ev.summary()
    # two views: ATE and the pose AUCs; RPE needs 3 (JAX camera_eval_metrics)
    assert all(np.isfinite(summary[k]) for k in ("ate", "auc@5", "auc@10", "auc@20", "auc@30"))
    assert np.isnan(summary["rpe_trans"]) and np.isnan(summary["rpe_rot"])
    assert pathlib.Path(f"{out}_pose/pose_metrics.json").exists()
