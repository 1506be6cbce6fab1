"""JAX reference scores of the committed synthetic_pose checkpoint.

Runs the JAX package's test mode (`vicasplat_tpu.main.test`) and its pose
evaluator (`PoseEvaluator`, as `eval_pose.py` runs it) on the committed
float16 weights (`outputs/synthetic_pose/ckpt_committed/weights_latest.npz`)
with the arguments of `tools/jobs/054_nvs_eval_v6_final.py`: the
`synthetic_pose` experiment, `dataset.synthetic.n_scenes=4096` (test scenes
synthetic_04100 ... 04107), 100 pose-alignment steps. The weights are
restored in the leaf order of `tools/pose_segments.py:load_committed` and
handed to `main.test` in place of its loader; nothing in the JAX package
changes.

It writes the per-scene and mean PSNR, SSIM, ATE, RPE and coverage
fractions, and the pose evaluator's summary, to
`vicasplat_tpu_torch/evaluation/reference_synthetic_pose_96k.json`, which
`chip_smoke.py` holds the port's test mode against.

With `--binning origin` it runs the test mode only, with
`decoder.rasterize.binning=origin` (JAX's origin binning sorts on the CPU
too, `ops/rasterize/tiles.py:440-441`), and stores its per-scene and mean
scores under the key "origin" of the same JSON, beside the default ones;
`chip_smoke.py` holds `eval-accel` (the port's origin binning through K2
and K4) to them scene by scene.

Usage, from the repository root, on the CPU:
    env JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR=build/jax_cache \
        python tools/jax_eval_reference.py [--out-dir build/jax_eval_reference] \
        [--binning origin]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import platform
import sys
import time
from unittest import mock

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NPZ = "outputs/synthetic_pose/ckpt_committed/weights_latest.npz"
JSON_OUT = ROOT / "vicasplat_tpu_torch/evaluation/reference_synthetic_pose_96k.json"
OVERRIDES = ("dataset.synthetic.n_scenes=4096", "mode=test")
KEYS = ("psnr", "ssim", "ate", "rpe_trans", "rpe_rot", "coverage_truncated_frac",
        "coverage_tile_overflow_frac")


def load_npz_params(path, template):
    """The committed npz's arr_0 ... arr_67, in the template's tree_flatten
    order, cast to the template's dtypes (tools/pose_segments.py:64-79)."""
    import jax

    with np.load(path) as z:
        leaves, treedef = jax.tree_util.tree_flatten(template)
        n = sum(1 for k in z.files if k.startswith("arr_"))
        if n != len(leaves):
            raise ValueError(f"npz has {n} leaves, the template {len(leaves)}")
        restored = [np.asarray(z[f"arr_{i}"]).astype(np.asarray(t).dtype)
                    for i, t in enumerate(leaves)]
        steps = int(z["_total_steps"])
    return jax.tree_util.tree_unflatten(treedef, restored), steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="build/jax_eval_reference",
                    help="test.output_path of the run (images, scores)")
    ap.add_argument("--json", default=str(JSON_OUT))
    ap.add_argument("--binning", default="dup_sort", choices=("dup_sort", "origin"))
    args = ap.parse_args(argv)
    origin = args.binning == "origin"
    extra = ["decoder.rasterize.binning=origin"] if origin else []

    import jax

    from vicasplat_tpu import main as jmain
    from vicasplat_tpu.data import DataModule
    from vicasplat_tpu.evaluation import nvs_eval
    from vicasplat_tpu.evaluation.pose_evaluator import PoseEvalConfig, PoseEvaluator
    from vicasplat_tpu.models import init_vicasplat
    from vicasplat_tpu.utils.config import load_config

    t_start = time.perf_counter()
    out_dir = str(ROOT / args.out_dir) + ("_origin" if origin else "")
    cfg = load_config(ROOT / "configs/main.yaml", experiment="synthetic_pose",
                      overrides=[*OVERRIDES, *extra, f"checkpointing.load={NPZ}",
                                 f"test.output_path={out_dir}"])
    np.random.seed(cfg.seed)
    template = init_vicasplat(jax.random.PRNGKey(cfg.seed), cfg.encoder)
    params, steps = load_npz_params(ROOT / NPZ, template)

    scenes = []
    evaluate = nvs_eval.evaluate_scene

    def recording(*a, **kw):
        r = evaluate(*a, **kw)
        scenes.append({"scene": r["scene"], **{k: r[k] for k in KEYS if k in r}})
        return r

    t0 = time.perf_counter()
    with mock.patch("vicasplat_tpu.utils.checkpointing.load_weights",
                    lambda path, template=None: params), \
            mock.patch.object(nvs_eval, "evaluate_scene", recording):
        jmain.test(cfg)
    test_s = time.perf_counter() - t0
    summary = json.loads((pathlib.Path(out_dir) / "scores_all_avg.json").read_text())
    if origin:
        record = json.loads(pathlib.Path(args.json).read_text())
        record["origin"] = {
            "command": "env JAX_PLATFORMS=cpu python tools/jax_eval_reference.py "
                       "--binning origin",
            "overrides": [*OVERRIDES, *extra, f"checkpointing.load={NPZ}"],
            "scenes": scenes, "mean": summary, "seconds": {"test": test_s}}
        pathlib.Path(args.json).write_text(json.dumps(record, indent=1) + "\n")
        print(json.dumps(summary), flush=True)
        print(f"test {test_s:.1f} s -> {args.json} (origin)", flush=True)
        return

    t0 = time.perf_counter()
    evaluator = PoseEvaluator(params, cfg.encoder, cfg.decoder,
                              PoseEvalConfig(output_path=out_dir + "_pose"))
    pose_scenes = [evaluator.evaluate_batch(b)
                   for b in DataModule(cfg.dataset, cfg.data_loader, None).test_dataloader()]
    pose_s = time.perf_counter() - t0

    record = {
        "what": "JAX main.test and PoseEvaluator on the committed float16 "
                "synthetic_pose weights, on the CPU",
        "command": "env JAX_PLATFORMS=cpu python tools/jax_eval_reference.py",
        "checkpoint": NPZ, "total_steps": steps,
        "overrides": [*OVERRIDES, f"checkpointing.load={NPZ}"],
        "experiment": "synthetic_pose",
        "pose_align_steps": cfg.test.pose_align_steps,
        "scenes": scenes, "mean": summary,
        "pose_eval": {"scenes": pose_scenes, "summary": evaluator.summary()},
        "seconds": {"test": test_s, "pose_eval": pose_s,
                    "total": time.perf_counter() - t_start},
        "jax": jax.__version__, "platform": jax.default_backend(),
        "python": platform.python_version(),
    }
    pathlib.Path(args.json).write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record["mean"]), flush=True)
    print(f"test {test_s:.1f} s, pose eval {pose_s:.1f} s -> {args.json}", flush=True)


if __name__ == "__main__":
    main()
