"""JAX reference of the synthetic_pose train mode from the committed checkpoint.

Runs the JAX package's train loop (`vicasplat_tpu.main.train`) on the CPU
with the `synthetic_pose` experiment at its own widths (64^2, encoder 384 x
6, decoder 384 x 4, batch 8 of 4 context frames and 2 targets, bf16 compute
over float32 parameters, AdamW with clip 0.5, warm-up 200 and cosine), from
the committed float16 weights
(`outputs/synthetic_pose/ckpt_committed/weights_latest.npz`), for the
number of steps `chip_smoke.py`'s `train-mode` phase runs. Only the step
count, the checkpoint interval and the validation interval are cut. The
weights are restored as `tools/jax_eval_reference.py` restores them
(`load_npz_params`) and handed to `main.train` in place of its loader; the
checkpoint writes are skipped (the JAX package writes orbax directories);
each step's scalars are taken from its logger (`train.print_log_every_n_steps
=1`), and each batch's scene ids from its train loader. Nothing in the JAX
package changes.

It writes every step's loss, mse, camera loss, PSNR, gradient norm and
scene ids to `vicasplat_tpu_torch/training/reference_synthetic_pose_train.json`.

Usage, from the repository root, on the CPU:
    env JAX_PLATFORMS=cpu JAX_COMPILATION_CACHE_DIR=build/jax_cache \
        python tools/jax_train_reference.py [--steps 4]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import platform
import sys
import time
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.jax_eval_reference import NPZ, load_npz_params  # noqa: E402

JSON_OUT = ROOT / "vicasplat_tpu_torch/training/reference_synthetic_pose_train.json"


def overrides(steps: int, out_dir: str) -> list:
    """The train mode's arguments on both sides: the experiment's widths,
    with the step count, the checkpoint and validation intervals cut, and a
    log line every step."""
    return ["mode=train", f"trainer.max_steps={steps}",
            f"checkpointing.every_n_train_steps={steps}", "trainer.val_check_interval=0",
            "train.print_log_every_n_steps=1", f"output_dir={out_dir}",
            f"checkpointing.output_dir={out_dir}/ckpts"]


class Recorder:
    """The logger's surface: keeps every scalar by step."""

    def __init__(self):
        self.steps = {}

    def add_scalar(self, tag, value, step):
        self.steps.setdefault(int(step), {})[tag.split("/", 1)[1]] = float(value)

    def add_image(self, *a, **kw):
        pass

    def close(self):
        pass


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out-dir", default="build/jax_train_reference")
    ap.add_argument("--json", default=str(JSON_OUT))
    args = ap.parse_args(argv)

    import jax

    from vicasplat_tpu import main as jmain
    from vicasplat_tpu.data.data_module import DataModule
    from vicasplat_tpu.utils.config import load_config

    ov = overrides(args.steps, str(ROOT / args.out_dir))
    cfg = load_config(ROOT / "configs/main.yaml", experiment="synthetic_pose",
                      overrides=[*ov, f"checkpointing.load={NPZ}"])
    rec, scenes = Recorder(), []
    loader = DataModule.train_dataloader

    def recording_loader(self):
        for batch in loader(self):
            scenes.append(list(batch["scene"]))
            yield batch

    def load(path, template=None):
        return load_npz_params(path, template)[0]

    t0 = time.perf_counter()
    with mock.patch("vicasplat_tpu.utils.checkpointing.load_weights", load), \
            mock.patch("vicasplat_tpu.utils.loggers.make_logger", lambda cfg: rec), \
            mock.patch.object(DataModule, "train_dataloader", recording_loader), \
            mock.patch("vicasplat_tpu.utils.checkpointing.CheckpointManager.save",
                       lambda self, step, params, **kw: None), \
            mock.patch("vicasplat_tpu.utils.checkpointing.CheckpointManager.finalize",
                       lambda self: None):
        jmain.train(cfg)
    seconds = time.perf_counter() - t0
    steps = [dict(step=s, scenes=scenes[s - 1], **rec.steps[s]) for s in sorted(rec.steps)]
    record = {
        "what": "JAX main.train on the committed float16 synthetic_pose weights, "
                "on the CPU, one log line a step",
        "command": f"env JAX_PLATFORMS=cpu python tools/jax_train_reference.py "
                   f"--steps {args.steps}",
        "checkpoint": NPZ, "experiment": "synthetic_pose",
        "overrides": [o for o in ov if not o.startswith(("output_dir", "checkpointing.out"))],
        "steps": steps, "seconds": seconds,
        "jax": jax.__version__, "platform": jax.default_backend(),
        "python": platform.python_version(),
    }
    pathlib.Path(args.json).write_text(json.dumps(record, indent=1) + "\n")
    for s in steps:
        print(f"step {s['step']}: loss {s['loss']:.6f} psnr {s['psnr']:.4f}", flush=True)
    print(f"{seconds:.1f} s -> {args.json}", flush=True)


if __name__ == "__main__":
    main()
