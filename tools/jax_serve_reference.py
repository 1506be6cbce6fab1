"""JAX reference answers of the serving path on the committed synthetic_pose
checkpoint.

Builds the JAX package's `InferenceEngine` for the `synthetic_pose`
experiment's model (64^2, encoder 384 x 6, decoder 384 x 4, linear heads)
on the committed float16 weights
(`outputs/synthetic_pose/ckpt_committed/weights_latest.npz`, restored as
`tools/jax_eval_reference.py` restores them), in bfloat16 (the engine's
serving dtype) and in float32, and records what the port's HTTP routes
answer for the same inputs:

- `/reconstruct` on the context frames (4 of 64^2) of the held-out scenes
  synthetic_04100 ... 04103 (`dataset.synthetic.n_scenes=4096`, the test
  loader of the experiment): poses, `centers_mean` (the mean of the means
  over frames and pixels, as the handler computes it) and `num_gaussians`;
- `/reconstruct_video` through `streaming.reconstruct_video` on scene
  synthetic_04100 rendered with 10 frames, window 4 and overlap 2 (4
  windows): the chained poses, the window scales and `num_gaussians`.

It writes them to
`vicasplat_tpu_torch/evaluation/reference_synthetic_pose_serve.json`, which
`chip_smoke.py` (phase `serve-trained`) holds the port's answers to. Nothing
in the JAX package changes.

Usage, from the repository root, on the CPU:
    env JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR=build/jax_cache \
        python tools/jax_serve_reference.py
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import platform
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.jax_eval_reference import NPZ, load_npz_params  # noqa: E402

JSON_OUT = ROOT / "vicasplat_tpu_torch/evaluation/reference_synthetic_pose_serve.json"
OVERRIDES = ("dataset.synthetic.n_scenes=4096", "mode=test")
N_SCENES = 4           # held-out scenes posted to /reconstruct
VIDEO = {"scene_offset": 0, "n_frames": 10, "window": 4, "overlap": 2}


def video_config(ds: dict, scenes_cls, n_frames: int):
    """The experiment's synthetic-scene config with `n_frames` frames."""
    fields = {f.name for f in dataclasses.fields(scenes_cls)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in ds.items() if k in fields}
    return scenes_cls(**dict(kw, n_frames=n_frames))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=str(JSON_OUT))
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from vicasplat_tpu.data import DataModule
    from vicasplat_tpu.data.synthetic_scenes import (
        SyntheticScenesConfig,
        generate_scene,
    )
    from vicasplat_tpu.models import init_vicasplat
    from vicasplat_tpu.serving import InferenceEngine
    from vicasplat_tpu.streaming import reconstruct_video
    from vicasplat_tpu.utils.config import load_config

    t_start = time.perf_counter()
    cfg = load_config(ROOT / "configs/main.yaml", experiment="synthetic_pose",
                      overrides=list(OVERRIDES))
    template = init_vicasplat(jax.random.PRNGKey(cfg.seed), cfg.encoder)
    params, steps = load_npz_params(ROOT / NPZ, template)

    requests = []
    for batch in DataModule(cfg.dataset, cfg.data_loader, None).test_dataloader():
        ctx = batch["context"]
        for i in range(ctx["image"].shape[0]):
            requests.append({"scene": batch["scene"][i],
                             "images": np.asarray(ctx["image"][i:i + 1], np.float32),
                             "intrinsics": np.asarray(ctx["intrinsics"][i:i + 1], np.float32)})
        if len(requests) >= N_SCENES:
            break
    requests = requests[:N_SCENES]
    s0 = cfg.dataset["synthetic"]["n_scenes"] + cfg.dataset["synthetic"]["n_val_scenes"]
    vcfg = video_config(cfg.dataset["synthetic"], SyntheticScenesConfig, VIDEO["n_frames"])
    video = generate_scene(s0 + VIDEO["scene_offset"], vcfg)
    frames = np.asarray(video["images"], np.float32)
    video_K = np.broadcast_to(video["intrinsics"], (frames.shape[0], 3, 3)).astype(np.float32)

    record = {
        "what": "JAX InferenceEngine answers of /reconstruct and "
                "/reconstruct_video on the committed synthetic_pose weights, on the CPU",
        "command": "env JAX_PLATFORMS=cpu python tools/jax_serve_reference.py",
        "checkpoint": NPZ, "total_steps": steps, "overrides": list(OVERRIDES),
        "experiment": "synthetic_pose",
        "inputs": {"scenes": [{"scene": r["scene"],
                               "images_sum": float(r["images"].astype(np.float64).sum())}
                              for r in requests],
                   "video": dict(VIDEO, scene=video["scene"],
                                 images_sum=float(frames.astype(np.float64).sum()))},
        "answers": {},
    }
    seconds = {}
    for name, dtype in (("bfloat16", jnp.bfloat16), ("float32", jnp.float32)):
        t0 = time.perf_counter()
        engine = InferenceEngine(cfg.encoder, params=params, dtype=dtype,
                                 decoder=cfg.decoder)
        scenes = []
        for r in requests:
            scene = engine.reconstruct(r["images"], r["intrinsics"])
            means = np.asarray(jax.device_get(scene.gaussians.means), np.float32)
            scenes.append({"scene": r["scene"],
                           "poses": np.asarray(scene.poses, np.float64).tolist(),
                           "centers_mean": np.mean(means, axis=(1, 2, 3)).tolist(),
                           "num_gaussians": int(np.prod(means.shape[:-1]))})
        streamed = reconstruct_video(engine, frames, video_K, window=VIDEO["window"],
                                     overlap=VIDEO["overlap"])
        record["answers"][name] = {
            "reconstruct": scenes,
            "reconstruct_video": {
                "poses": np.asarray(streamed.poses).tolist(),
                "window_scales": np.asarray(streamed.window_scales).tolist(),
                "num_gaussians": int(np.prod(streamed.gaussians.means.shape[:-1]))}}
        seconds[name] = time.perf_counter() - t0
    record["seconds"] = dict(seconds, total=time.perf_counter() - t_start)
    record.update(jax=jax.__version__, platform=jax.default_backend(),
                  python=platform.python_version())
    pathlib.Path(args.json).write_text(json.dumps(record, indent=1) + "\n")
    print(f"{len(requests)} scenes + a {frames.shape[0]}-frame video, "
          f"{record['seconds']['total']:.1f} s -> {args.json}", flush=True)


if __name__ == "__main__":
    main()
