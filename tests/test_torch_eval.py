"""The port's evaluation path against the JAX package on the CPU, with the
repository's trained checkpoint (outputs/synthetic_pose/ckpt_committed/
weights_latest.npz): one test example of the synthetic dataset, one
held-out scene through `evaluate_scene` with a few pose-alignment steps in
float32, the pose evaluator with and without refinement, and the two
entry points (`main` in test mode, `eval_pose`) with the files and keys of
the JAX package's outputs."""
import json
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicasplat_tpu.data.data_module import _build_dataset as jbuild_dataset
from vicasplat_tpu.evaluation import nvs_eval as jnvs
from vicasplat_tpu.evaluation import pose_evaluator as jpose
from vicasplat_tpu.models import init_vicasplat as jinit
from vicasplat_tpu.models import vicasplat_forward as jforward
from vicasplat_tpu.utils.config import load_config as jload_config
from vicasplat_tpu_torch import eval_pose as teval_pose
from vicasplat_tpu_torch import main as tmain
from vicasplat_tpu_torch.data.data_module import DataModule, _build_dataset, collate, to_device
from vicasplat_tpu_torch.evaluation import nvs_eval as tnvs
from vicasplat_tpu_torch.evaluation import pose_evaluator as tpose
from vicasplat_tpu_torch.models import vicasplat_forward
from vicasplat_tpu_torch.utils.config import load_config, parse_cli

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAIN = ROOT / "configs" / "main.yaml"
NPZ = ROOT / "outputs/synthetic_pose/ckpt_committed/weights_latest.npz"
JAX_RUN = ROOT / "outputs/synthetic_pose/nvs_eval_v6_96k"  # the JAX package's outputs
OVERRIDES = ["mode=test", "dataset.synthetic.n_scenes=4096", f"checkpointing.load={NPZ}"]
ALIGN_STEPS = 3
# frames of the two rasterizers (the port's matmul compositing on the CPU,
# the JAX package's XLA path), both float32: the same splats summed in other
# orders agree within FRAME_TOL; a splat whose alpha sits on the 1/255 cut
# may be kept on one side only, which moves its pixels by at most its own
# share and the transmittance of those behind it, 2/255, and such pixels
# are rare
FRAME_TOL = 2e-4
FRAME_CUT_TOL = 2 / 255
FRAME_CUT_SHARE = 1e-3
# float32 forward and render on both sides, then 3 Adam steps of lr 0.005:
# the deltas (about 0.015 after them) agree to float32 roundings of the
# gradients (measured 4e-6), the colours as the frames do (a splat on the
# alpha cut), and the scores to far below their own spread across scenes
DELTA_TOL = 5e-5
SCORE_TOL = {"psnr": 1e-3, "ssim": 1e-4, "ate": 1e-6, "rpe_trans": 1e-6,
             "rpe_rot": 1e-4, "coverage_truncated_frac": 1e-4,
             "coverage_tile_overflow_frac": 0.0}


@pytest.fixture(scope="module")
def cfgs():
    return (jload_config(MAIN, "synthetic_pose", OVERRIDES),
            load_config(MAIN, "synthetic_pose", OVERRIDES))


@pytest.fixture(scope="module")
def models(cfgs):
    """The committed weights on both sides: JAX params restored in the
    tree's leaf order, and the port's model loaded by load_weights."""
    jcfg, tcfg = cfgs
    leaves, treedef = jax.tree_util.tree_flatten(jinit(jax.random.PRNGKey(0), jcfg.encoder))
    with np.load(NPZ) as z:
        params = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(z[f"arr_{i}"].astype(np.float32))
                      for i in range(len(leaves))])
    return params, tmain.build_model(tcfg, "cpu")


def _first_example(cfgs, stage, **ds_kw):
    """The first example of `stage` on both sides, from the loader's seed."""
    jcfg, tcfg = cfgs
    seed = jcfg.data_loader[stage]["seed"]
    jex = next(iter(jbuild_dataset(dict(jcfg.dataset["synthetic"], **ds_kw), stage,
                                   None, seed)))
    tex = next(iter(_build_dataset(dict(tcfg.dataset["synthetic"], **ds_kw), stage,
                                   None, seed)))
    return jex, tex


@pytest.fixture(scope="module")
def example(cfgs):
    """The first test example (scene synthetic_04100) on both sides."""
    return _first_example(cfgs, "test")


def _float32_encoders():
    jenc = jax.jit(lambda p, c, cfg: jforward(p, cfg, dict(c, image=c["image"] * 2 - 1),
                                              dtype=jnp.float32), static_argnums=2)

    def tenc(model, ctx):
        return vicasplat_forward(model, dict(ctx, image=ctx["image"] * 2 - 1),
                                 dtype=torch.float32)

    return jenc, tenc


@pytest.mark.parametrize("stage", ["test", "train"])
def test_dataset_example_matches_jax(cfgs, example, stage):
    """Scene id, view indices, cameras, near and far are equal; frames agree
    within FRAME_TOL but for a few pixels on the alpha cut. The train stage
    draws its scene, its views and the reflection augmentation from the
    same generator as the JAX package's (4 training scenes)."""
    if stage == "test":
        jex, tex = example
        assert tex["scene"] == jex["scene"] == "synthetic_04100"
    else:
        jex, tex = _first_example(cfgs, "train", n_scenes=4, augment=True)
        assert tex["scene"] == jex["scene"]
    for side in ("context", "target"):
        for k in ("index", "extrinsics", "intrinsics", "near", "far"):
            np.testing.assert_array_equal(tex[side][k], jex[side][k], err_msg=f"{side} {k}")
        diff = np.abs(tex[side]["image"] - jex[side]["image"])
        assert diff.max() <= FRAME_CUT_TOL, side
        assert (diff > FRAME_TOL).mean() <= FRAME_CUT_SHARE, side
    assert len(tex["context"]["index"]) == 4
    assert len(tex["target"]["index"]) == (7 if stage == "test" else 2)


class _Steps:
    def __init__(self, step):
        self.step = step

    def get_step(self):
        return self.step


@pytest.mark.parametrize("stage,step,kw", [
    ("test", 0, {}),
    ("train", 0, {}),
    ("train", 150, {"cameras_are_circular": True}),
    ("val", 0, {"is_overfitting": True}),
])
def test_sequential_sampler_matches_jax(stage, step, kw):
    """The sequential sampler draws the same context and target indices as
    the JAX package's from the same seeded generator: test, train with its
    order reversal, the warm-up schedule on circular cameras, overfitting."""
    from vicasplat_tpu.data.view_samplers import make_view_sampler as jmake
    from vicasplat_tpu_torch.data.view_samplers import make_view_sampler as tmake

    cfg = {"name": "sequential", "num_context_views": 4, "num_target_views": 3,
           "min_distance_between_context_views": 2,
           "max_distance_between_context_views": 5, "warm_up_steps": 300}
    js, ts = (make(cfg, stage, _Steps(step), **kw) for make in (jmake, tmake))
    jrng, trng = np.random.default_rng(11), np.random.default_rng(11)
    for num_views in (24, 37, 64):
        for _ in range(5):
            jc, jt, jo = js.sample("s", num_views, jrng)
            tc, tt, to = ts.sample("s", num_views, trng)
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_array_equal(tt, jt)
            assert to == jo


def test_unported_samplers_raise():
    """Every sampler of the JAX package is ported; an unknown name raises,
    and so does a scene too short for the sampler."""
    from vicasplat_tpu_torch.data.view_samplers import NotEnoughFramesError, make_view_sampler

    for name in ("bounded", "arbitrary", "all"):
        assert make_view_sampler({"name": name}, "train").cfg.name == name
    with pytest.raises(ValueError, match="unknown view sampler"):
        make_view_sampler({"name": "nearest"}, "train")
    with pytest.raises(NotEnoughFramesError):
        make_view_sampler({"name": "sequential", "num_context_views": 4,
                           "min_distance_between_context_views": 5},
                          "train").sample("s", 8, np.random.default_rng(0))


def test_data_module_schema_and_loaders(cfgs):
    _, tcfg = cfgs
    with pytest.raises(ValueError, match="unknown data_loader"):
        DataModule(tcfg.dataset, {"test": {"batchsize": 1}}, device="cpu").test_dataloader()
    with pytest.raises(ValueError, match="unknown dataset"):
        DataModule({"x": {"name": "imagenet"}}, {}, device="cpu").test_dataloader()
    # the chunk reader is ported: no chunks under its roots, no batches
    assert list(DataModule({"re10k": {"name": "re10k", "roots": []}}, {},
                           device="cpu").test_dataloader()) == []
    # the train loader collates on prefetch threads (tests/test_torch_train.py)
    train = DataModule(tcfg.dataset, tcfg.data_loader, device="cpu").loader("train")
    try:
        assert next(train)["context"]["image"].shape == (8, 4, 64, 64, 3)
    finally:
        train.close()
    ds = dict(tcfg.dataset["synthetic"], n_test_scenes=3)
    batches = list(DataModule({"synthetic": ds}, {"test": {"batch_size": 2, "seed": 9}},
                              device="cpu").test_dataloader())
    assert [b["scene"] for b in batches] == [["synthetic_04100", "synthetic_04101"],
                                             ["synthetic_04102"]]
    assert batches[0]["context"]["image"].shape == (2, 4, 64, 64, 3)
    assert batches[0]["target"]["extrinsics"].dtype == torch.float32


@pytest.fixture(scope="module")
def scene_results(cfgs, models, example):
    """evaluate_scene on synthetic_04100 with ALIGN_STEPS steps, float32
    encodes, on both sides (the port's batch made from the JAX example, so
    that the frames are the same)."""
    jcfg, tcfg = cfgs
    params, model = models
    jex, _ = example
    jbatch = jax.tree.map(lambda x: x[None], {k: jex[k] for k in ("context", "target")})
    jbatch["scene"] = [jex["scene"]]
    tbatch = to_device(collate([jex]), "cpu")
    jenc, tenc = _float32_encoders()
    jeval = jnvs.EvalConfig(pose_align_steps=ALIGN_STEPS, output_path="unused")
    teval = tnvs.EvalConfig(pose_align_steps=ALIGN_STEPS, output_path="unused")
    jalign = jnvs.make_pose_align_step(jcfg.encoder, jcfg.decoder, jeval, (64, 64),
                                       loss_cfg=jcfg.loss)
    talign = tnvs.make_pose_align_step(tcfg.encoder, tcfg.decoder, teval, (64, 64),
                                       loss_cfg=tcfg.loss)
    jr = jnvs.evaluate_scene(params, jcfg.encoder, jcfg.decoder, jeval, jbatch,
                             encode_fn=lambda p, c: jenc(p, c, jcfg.encoder),
                             align_fn=jalign)
    jdeltas = jalign(jr["_outputs"]["gaussians"], jbatch["target"])
    tr = tnvs.evaluate_scene(model, tcfg.encoder, tcfg.decoder, teval, tbatch,
                             encode_fn=tenc, align_fn=talign)
    return jr, jdeltas, tr, tbatch


def test_evaluate_scene_matches_jax(scene_results):
    jr, jdeltas, tr, _ = scene_results
    assert tr["scene"] == jr["scene"]
    for k in ("rot", "trans"):
        d = np.asarray(jdeltas[k])
        assert np.abs(d).max() > 0.01  # 3 steps of lr 0.005 moved them
        np.testing.assert_allclose(tr["_deltas"][k], d, atol=DELTA_TOL, rtol=0, err_msg=k)
    diff = np.abs(tr["_rendered"] - jr["_rendered"])
    assert diff.max() <= FRAME_CUT_TOL and (diff > FRAME_TOL).mean() <= FRAME_CUT_SHARE
    keys = sorted(k for k in jr if not k.startswith("_") and k != "scene")
    assert sorted(k for k in tr if not k.startswith("_") and k != "scene") == keys
    for k in keys:
        assert abs(tr[k] - jr[k]) <= SCORE_TOL[k], (k, tr[k], jr[k])


def test_save_scene_outputs_writes_the_jax_files(scene_results, tmp_path, cfgs):
    _, tcfg = cfgs
    _, _, tr, tbatch = scene_results
    teval = tnvs.EvalConfig(output_path=str(tmp_path), save_gs=True)
    tnvs.save_scene_outputs(tr, tbatch, teval, tcfg.encoder)
    out = tmp_path / "synthetic_04100"
    ref = JAX_RUN / "synthetic_04100"
    for name in ("transforms.json", "compare.png", "context/000.png", "color/006.png"):
        assert (out / name).exists() and (ref / name).exists(), name
    got, want = (json.loads((d / "transforms.json").read_text()) for d in (out, ref))
    assert sorted(got) == sorted(want) and len(got["frames"]) == len(want["frames"]) == 4
    assert (out / "gaussians.ply").read_bytes().startswith(b"ply\n")


@pytest.mark.parametrize("refine_steps", [0, 2])
def test_pose_evaluator_matches_jax(cfgs, models, example, refine_steps):
    """Float32 encodes on both sides (the evaluators' own are bf16); with
    refinement, 2 Adam steps of the context poses through the render."""
    jcfg, tcfg = cfgs
    params, model = models
    jex, _ = example
    jbatch = jax.tree.map(lambda x: x[None], {k: jex[k] for k in ("context", "target")})
    jbatch["scene"] = [jex["scene"]]
    jenc, tenc = _float32_encoders()
    jev = jpose.PoseEvaluator(params, jcfg.encoder, jcfg.decoder,
                              jpose.PoseEvalConfig(refine_steps=refine_steps))
    jev._encode = lambda p, c: jenc(p, c, jcfg.encoder)
    tev = tpose.PoseEvaluator(model, tcfg.encoder, tcfg.decoder,
                              tpose.PoseEvalConfig(refine_steps=refine_steps))
    want = jev.evaluate_batch(jbatch)
    with mock.patch.object(tpose, "default_encode", tenc):
        got = tev.evaluate_batch(to_device(collate([jex]), "cpu"))
    assert got["scene"] == want["scene"]
    # ATE and RPE of the same float32 poses; refined poses differ by the
    # deltas' float32 roundings
    tol = 1e-5 if refine_steps == 0 else 1e-4
    for k in ("ate", "rpe_trans"):
        assert abs(got[k] - want[k]) <= tol * max(1.0, abs(want[k])), k
    assert abs(got["rpe_rot"] - want["rpe_rot"]) <= 100 * tol
    jsum, tsum = jev.summary(), tev.summary()
    assert sorted(tsum) == sorted(jsum)
    for k in jsum:
        assert abs(tsum[k] - jsum[k]) <= 100 * tol * max(1.0, abs(jsum[k])), k


def test_main_test_mode_writes_the_jax_outputs(tmp_path):
    """main(argv) in test mode on one scene with one alignment step: the
    files and keys of the JAX package's run (outputs/synthetic_pose/
    nvs_eval_v6_96k), and its summary format."""
    out = tmp_path / "eval"
    summary, results = tmain.main(
        ["+experiment=synthetic_pose", *OVERRIDES, f"test.output_path={out}",
         "dataset.synthetic.n_test_scenes=1", "test.pose_align_steps=1"], device="cpu")
    want = json.loads((JAX_RUN / "scores_all_avg.json").read_text())
    got = json.loads((out / "scores_all_avg.json").read_text())
    assert got == json.loads(json.dumps(summary))
    assert sorted(got) == sorted(want) and sorted(got["n_valid"]) == sorted(want["n_valid"])
    assert got["n_scenes"] == 1 and [r["scene"] for r in results] == ["synthetic_04100"]
    bench = json.loads((out / "benchmark.json").read_text())
    jbench = json.loads((JAX_RUN / "benchmark.json").read_text())
    assert sorted(bench) == sorted(jbench) == ["decoder", "encoder", "pose_align"]
    assert sorted(bench["encoder"]) == sorted(jbench["encoder"])
    assert (out / "peak_memory.json").exists()
    assert (out / "synthetic_04100" / "compare.png").exists()
    # no teacher without train.distiller (distillation: tests/test_torch_distill*.py)
    assert tmain._maybe_distiller(parse_cli(["+experiment=synthetic_pose"]), "cpu") is None


def test_eval_pose_cli(tmp_path):
    ev = teval_pose.main(["+experiment=synthetic_pose", *OVERRIDES[1:],
                          f"test.output_path={tmp_path / 'e'}",
                          "dataset.synthetic.n_test_scenes=2"], device="cpu")
    got = json.loads((tmp_path / "e_pose" / "pose_metrics.json").read_text())
    assert got == json.loads(json.dumps(ev.summary()))
    assert sorted(got) == ["ate", "auc@10", "auc@20", "auc@30", "auc@5", "rpe_rot",
                           "rpe_trans"]
    assert len(ev.metrics["ate"]) == 2 and all(np.isfinite(list(got.values())))
