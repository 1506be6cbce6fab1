"""Where `eval-accel`'s per-scene gap to `eval` comes from (chip_smoke.py):
origin binning, or K2 against its plain version. Runs the synthetic_pose
test mode on the committed checkpoint (the 8 held-out scenes, 100
pose-alignment steps) in four configurations, each in its own process,
all started together (the scores do not depend on timing):

    python -m vicasplat_tpu_torch.diagnostics.eval_split [--out eval_split.json]

- "default": the default render (chip_smoke.py's `eval`);
- "origin": binning=origin, with K2 and K4 swapped for their plain
  versions (`composite_reference`, `topk_reference`);
- "origin64": the same, with the plain compositing summed in chunks of 64
  rows instead of 128: the same function in another float32 order, the
  rounding floor of 100 alignment steps;
- "accel": backend=pallas, binning=origin through K2 and K4
  (chip_smoke.py's `eval-accel`).
It prints each run's scores and K2 and K4 launches, and the largest
per-scene gaps of PSNR, SSIM and ATE: origin - default (the binning),
accel - origin (the kernels), origin64 - origin (the floor). Needs one
CUDA card. chip_smoke.py runs "origin" and "origin64" through `--run`
beside its own `eval-accel`.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parents[2]
NPZ = "outputs/synthetic_pose/ckpt_committed/weights_latest.npz"
ACCEL = ["decoder.rasterize.backend=pallas", "decoder.rasterize.binning=origin"]
RUNS = {"default": [], "origin": ACCEL, "origin64": ACCEL, "accel": ACCEL}
PAIRS = {"binning": ("origin", "default"), "kernels": ("accel", "origin"),
         "floor": ("origin64", "origin")}
SCORES = ("psnr", "ssim", "ate")


def run_one(name: str, out_dir: pathlib.Path, scenes: int = 8) -> dict:
    """One test mode in this process, on the first `scenes` held-out
    scenes: per-scene scores and launches."""
    import torch

    from .. import main as tmain
    from ..kernels import bitonic_topk, composite_launch, flash_attention, topk_reference
    from ..ops.rasterize import pallas_composite, tiles
    from ..ops.rasterize.pallas_composite import composite_reference
    from ..utils.config import parse_cli

    cfg = parse_cli(["+experiment=synthetic_pose", "mode=test",
                     "dataset.synthetic.n_scenes=4096", f"checkpointing.load={ROOT / NPZ}",
                     f"test.output_path={out_dir / name}",
                     f"dataset.synthetic.n_test_scenes={scenes}", *RUNS[name]])
    patches = []
    if name.startswith("origin"):
        chunk = 64 if name == "origin64" else None

        def plain(payload, background, image_shape, tile_px, c):
            return composite_reference(payload, image_shape, tile_px, background,
                                       chunk or c)

        patches = [mock.patch.object(pallas_composite, "_forward", plain),
                   mock.patch.object(tiles, "bitonic_topk", topk_reference)]
    for p in patches:
        p.start()
    try:
        summary, results = tmain.test(cfg, device="cuda")
    finally:
        for p in patches:
            p.stop()
    torch.cuda.synchronize()
    return {"scenes": [{k: r[k] for k in ("scene", *SCORES)} for r in results],
            "mean": {k: summary[k] for k in SCORES},
            "launches": {"flash_attn": flash_attention.launches,
                         "composite": composite_launch.launches,
                         "bitonic_topk": bitonic_topk.launches}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="eval_split.json")
    ap.add_argument("--run", help=argparse.SUPPRESS)  # a child: one configuration
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    ap.add_argument("--scenes", type=int, default=8, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        rec = run_one(args.run, pathlib.Path(args.dir), args.scenes)
        (pathlib.Path(args.dir) / f"{args.run}.json").write_text(json.dumps(rec))
        return

    from ..kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    build.build_all(("flash_attn", "composite", "bitonic_topk"))  # once, before the children
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", "vicasplat_tpu_torch.diagnostics.eval_split",
             "--run", name, "--dir", tmp], cwd=ROOT, stdout=subprocess.DEVNULL)
            for name in RUNS}
        failed = [name for name, p in procs.items() if p.wait() != 0]
        if failed:
            raise SystemExit(f"eval_split: runs {failed} failed")
        runs = {name: json.loads((pathlib.Path(tmp) / f"{name}.json").read_text())
                for name in RUNS}
    gaps = {}
    for label, (a, b) in PAIRS.items():
        gaps[label] = {k: max(abs(x[k] - y[k]) for x, y in
                              zip(runs[a]["scenes"], runs[b]["scenes"])) for k in SCORES}
    for name, r in runs.items():
        print(f"{name}: means {r['mean']}, launches {r['launches']}; " + "; ".join(
            f"{s['scene']} " + " ".join(f"{k} {s[k]:.6f}" for k in SCORES)
            for s in r["scenes"]), flush=True)
    for label, (a, b) in PAIRS.items():
        print(f"{label} ({a} - {b}), largest per-scene gap: " + ", ".join(
            f"{k} {v:.6f}" for k, v in gaps[label].items()), flush=True)
    pathlib.Path(args.out).write_text(json.dumps(
        {"device": smi, "runs": runs, "gaps": gaps, "pairs": PAIRS}, indent=1))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
