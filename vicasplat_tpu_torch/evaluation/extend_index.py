"""Extend a 2-view evaluation index to N context views, for the video
evaluation (port of vicasplat_tpu/evaluation/extend_index.py:29-110): the
2-view context interval becomes the frame gap, clamped to the scene
length; N equally spaced context frames and sorted random target frames
inside the span. The scene length comes from the chunk's camera count
(RE10K layout) or each scene directory's extrinsics.npy (--scene_dirs,
ScanNet layout). The numpy Generator draws are the JAX package's.

Usage:
  python -m vicasplat_tpu_torch.evaluation.extend_index \
      --index_2v assets/evaluation_index_re10k.json \
      --data_root datasets/re10k/test \
      --n_context 8 --n_target 3 --output assets/evaluation_index_re10k_8v.json
  python -m vicasplat_tpu_torch.evaluation.extend_index --scene_dirs \
      --index_2v assets/evaluation_index_scannet.json \
      --data_root datasets/scannet/test \
      --n_context 8 --n_target 9 --output assets/evaluation_index_scannet_8v.json
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np


def extend_entry(entry, n_total_views: int, n_context: int, n_target: int,
                 rng: np.random.Generator):
    if entry is None:
        return None
    c1, c2 = entry["context"][:2]
    interval = c2 - c1
    if 1 + interval * (n_context - 1) > n_total_views:
        interval = (n_total_views - 1) // (n_context - 1)
    if interval < 1:
        return None
    if c1 + interval * (n_context - 1) > n_total_views - 1:
        start_max = n_total_views - 1 - interval * (n_context - 1)
        start = int(rng.integers(0, start_max + 1))
    else:
        start = c1
    ctx = np.arange(n_context) * interval + start
    span = int(ctx[-1] - ctx[0] + 1)
    tgt = rng.choice(span, size=min(n_target, span), replace=False) + ctx[0]
    return {
        "context": ctx.tolist(),
        "target": np.sort(tgt).tolist(),
        "overlap": 0.5,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index_2v", required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--n_context", type=int, default=8)
    ap.add_argument("--n_target", type=int, default=3)
    ap.add_argument("--output", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--scene_dirs", action="store_true",
        help="data_root holds one dir per scene with extrinsics.npy "
             "(ScanNet layout) instead of .torch chunks",
    )
    args = ap.parse_args(argv)

    with open(args.index_2v) as f:
        index = json.load(f)
    rng = np.random.default_rng(args.seed)

    root = pathlib.Path(args.data_root)
    new_index = {}
    if args.scene_dirs:
        for scene_dir in sorted(p for p in root.iterdir() if p.is_dir()):
            entry = index.get(scene_dir.name)
            if entry is None:
                continue
            ext_path = scene_dir / "extrinsics.npy"
            if not ext_path.exists():
                continue
            n_total = int(np.load(ext_path).shape[0])
            out = extend_entry(entry, n_total, args.n_context, args.n_target,
                               rng)
            if out is not None:
                new_index[scene_dir.name] = out
    else:
        import torch

        for chunk_path in sorted(root.glob("*.torch")):
            chunk = torch.load(chunk_path, weights_only=True)
            for example in chunk:
                scene = example["key"]
                entry = index.get(scene)
                if entry is None:
                    continue
                out = extend_entry(
                    entry, example["cameras"].shape[0],
                    args.n_context, args.n_target, rng,
                )
                if out is not None:
                    new_index[scene] = out
    with open(args.output, "w") as f:
        json.dump(new_index, f, indent=2)
    print(f"wrote {len(new_index)} scenes -> {args.output}")
    return new_index


if __name__ == "__main__":
    main()
