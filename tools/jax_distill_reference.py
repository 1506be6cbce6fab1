"""JAX reference of two distillation train steps, for chip_smoke.py's `distill`.

Runs the JAX package's train step (`vicasplat_tpu.training.make_train_step`)
on the CPU in float32: the `synthetic_pose` student from the committed
float16 weights (`outputs/synthetic_pose/ckpt_committed/weights_latest.npz`,
64^2, encoder 384 x 6, decoder 384 x 4, linear heads) with a small DUSt3R
teacher (`TEACHER`: 64^2, encoder 96 x 2, decoders 64 x 4, the DPT heads at
their fixed widths), step 0 in "distill_only" and step 1 in "distill"
(`train.distill_only_steps=1`, `train.distill_max_steps=1`), on one batch
of 2 examples of 2 context frames and 2 targets. Nothing in the JAX package
changes.

The teacher's weights are not committed: its two DPT heads alone hold 38 M
parameters (152 MB in float32). They are drawn by numpy from `SEED`, leaf
by leaf, each leaf's generator seeded by `SEED` and the CRC-32 of its tree
path (`teacher_leaf`); `chip_smoke.py` draws the same arrays through the
port's leaf specs. The batch is drawn the same way on both sides
(`reference_batch`). tests/test_torch_distill.py holds both recipes equal.

It writes each step's phase and logs (loss, camera, distillation, mse,
psnr, grad_norm) to `vicasplat_tpu_torch/training/reference_distill.json`.

Usage, from the repository root, on the CPU (about a minute):
    env JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR=build/jax_cache \\
        python tools/jax_distill_reference.py
"""
from __future__ import annotations

import argparse
import json
import pathlib
import platform
import sys
import time
import zlib
from unittest import mock

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.jax_eval_reference import NPZ, load_npz_params  # noqa: E402

JSON_OUT = ROOT / "vicasplat_tpu_torch/training/reference_distill.json"
TEACHER = dict(img_size=64, patch_size=16, enc_embed_dim=96, enc_depth=2, enc_num_heads=4,
               dec_embed_dim=64, dec_depth=4, dec_num_heads=4)
SEED = 2026
OVERRIDES = ["mode=train", "trainer.precision=float32", "train.distiller=mast3r",
             "train.distill_only_steps=1", "train.distill_max_steps=1"]


def teacher_leaf(path: str, shape: tuple, seed: int = SEED) -> np.ndarray:
    """One teacher leaf (JAX layout) by its tree path 'a/b/w': xavier-normal
    kernels (a conv's fans over its window; stacked blocks' leading depth
    axis aside), layer-norm scales near 1, small biases."""
    rng = np.random.default_rng([seed, zlib.crc32(path.encode())])
    name = path.rsplit("/", 1)[-1]
    if name == "w":
        window = int(np.prod(shape[:-2])) if len(shape) == 4 else 1
        std = np.sqrt(2.0 / (window * (shape[-2] + shape[-1])))
        return rng.normal(0, std, shape).astype(np.float32)
    if name == "scale":
        return (1.0 + rng.normal(0, 0.05, shape)).astype(np.float32)
    return rng.normal(0, 0.02, shape).astype(np.float32)


def reference_batch(seed: int = SEED, B: int = 2, T: int = 2, V: int = 2,
                    hw: int = 64) -> dict:
    """{"context": {image (B, T, hw, hw, 3) in [0, 1], intrinsics, extrinsics
    (c2w: frame 0 the identity, then a small turn and step), near, far},
    "target": {...}}, float32 numpy."""
    rng = np.random.default_rng(seed)
    K = np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32)

    def views(n, first_identity):
        ext = np.tile(np.eye(4, dtype=np.float32), (B, n, 1, 1))
        th = rng.uniform(-0.2, 0.2, (B, n))
        ext[..., 0, 0], ext[..., 0, 2] = np.cos(th), np.sin(th)
        ext[..., 2, 0], ext[..., 2, 2] = -np.sin(th), np.cos(th)
        ext[..., :3, 3] = rng.normal(0, 0.2, (B, n, 3))
        if first_identity:
            ext[:, 0] = np.eye(4, dtype=np.float32)
        return {"image": rng.uniform(0, 1, (B, n, hw, hw, 3)).astype(np.float32),
                "intrinsics": np.tile(K, (B, n, 1, 1)), "extrinsics": ext,
                "near": np.full((B, n), 0.5, np.float32),
                "far": np.full((B, n), 100.0, np.float32)}

    return {"context": views(T, True), "target": views(V, False)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=str(JSON_OUT))
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from vicasplat_tpu import main as jmain
    from vicasplat_tpu.models.dust3r import Dust3RConfig, dust3r_forward, init_dust3r
    from vicasplat_tpu.training import make_train_step
    from vicasplat_tpu.training.step import pick_phase
    from vicasplat_tpu.utils.config import load_config

    cfg = load_config(ROOT / "configs/main.yaml", experiment="synthetic_pose",
                      overrides=[*OVERRIDES, f"checkpointing.load={NPZ}"])

    def load(path, template=None):
        return load_npz_params(path, template)[0]

    with mock.patch("vicasplat_tpu.utils.checkpointing.load_weights", load):
        train_cfg, params, optimizer = jmain.build_all(cfg)
    t_cfg = Dust3RConfig(**TEACHER)
    shapes = jax.eval_shape(lambda k: init_dust3r(k, t_cfg), jax.random.PRNGKey(0))
    t_params = jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(teacher_leaf("/".join(k.key for k in p), s.shape)), shapes)

    def teacher_fn(img1, img2):
        return jax.lax.stop_gradient(dust3r_forward(t_params, t_cfg, img1, img2,
                                                    dtype=jnp.float32))

    step = jax.jit(make_train_step(train_cfg, optimizer, teacher_fn=teacher_fn),
                   static_argnames="phase")
    batch = jax.tree.map(jnp.asarray, reference_batch())
    opt_state = optimizer.init(params)
    t0 = time.perf_counter()
    steps = []
    for i in range(2):
        phase = pick_phase(train_cfg, i, True)
        params, opt_state, logs = step(params, opt_state, batch, i, phase=phase)
        steps.append(dict(step=i, phase=phase, **{k: float(v) for k, v in logs.items()}))
        print(f"step {i} ({phase}): " + ", ".join(f"{k} {v:.6f}" for k, v in
                                                  sorted(logs.items())), flush=True)
    record = {
        "what": "two JAX make_train_step steps (distill_only, then distill) of the "
                "committed synthetic_pose student with a numpy-drawn DUSt3R teacher, "
                "float32, on the CPU",
        "command": "env JAX_PLATFORMS=cpu python tools/jax_distill_reference.py",
        "checkpoint": NPZ, "experiment": "synthetic_pose", "overrides": OVERRIDES,
        "teacher": TEACHER, "seed": SEED, "steps": steps,
        "seconds": time.perf_counter() - t0,
        "jax": jax.__version__, "platform": jax.default_backend(),
        "python": platform.python_version(),
    }
    pathlib.Path(args.json).write_text(json.dumps(record, indent=1) + "\n")


if __name__ == "__main__":
    main()
