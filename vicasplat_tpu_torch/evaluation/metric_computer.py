"""Recompute image metrics from the saved renderings of several methods
(port of vicasplat_tpu/evaluation/metric_computer.py:23-108): walks each
method's per-scene output directories, scores the rendered PNGs against the
ground truth's (PSNR, SSIM, and LPIPS when a function is given), and
averages them per overlap bucket. Images are read by `image_io.load_image`
(the port's PNG and JPEG readers) and scored in float32 on the CPU.

    python -m vicasplat_tpu_torch.evaluation.metric_computer gt_dir method1_dir [...]
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from ..utils.image_io import load_image
from .metrics import compute_psnr, compute_ssim


def get_overlap_tag(overlap: float) -> Optional[str]:
    """Bucket an overlap ratio (reference src/misc/utils.py:38-48)."""
    if 0.05 <= overlap <= 0.3:
        return "small"
    if overlap <= 0.55:
        return "medium"
    if overlap <= 0.8:
        return "large"
    return None


@dataclasses.dataclass(frozen=True)
class MetricComputerConfig:
    methods: tuple = ()          # (name, path) pairs or names
    ground_truth_dir: str = ""
    output_path: str = "outputs/metrics"
    lpips_fn: object = None


class MetricComputer:
    def __init__(self, cfg: MetricComputerConfig):
        self.cfg = cfg
        self.scores = defaultdict(lambda: defaultdict(list))

    def score_scene(self, method: str, scene: str,
                    rendered_dir: pathlib.Path, gt_dir: pathlib.Path,
                    overlap: Optional[float] = None):
        rendered = sorted(rendered_dir.glob("*.png"))
        gts = sorted(gt_dir.glob("*.png"))
        if not rendered or len(rendered) != len(gts):
            return None
        pr = torch.from_numpy(np.stack([load_image(p) for p in rendered]))
        gt = torch.from_numpy(np.stack([load_image(p) for p in gts]))
        entry = {
            "psnr": float(compute_psnr(gt, pr).mean()),
            "ssim": float(compute_ssim(gt, pr)),
        }
        if self.cfg.lpips_fn is not None:
            entry["lpips"] = float(self.cfg.lpips_fn(pr, gt))
        tags = ["all"]
        if overlap is not None:
            tag = get_overlap_tag(overlap)
            if tag:
                tags.append(tag)
        for tag in tags:
            for k, v in entry.items():
                self.scores[f"{method}/{tag}"][k].append(v)
        return entry

    def summary(self) -> dict:
        return {
            group: {k: float(np.mean(v)) for k, v in metrics.items()}
            for group, metrics in self.scores.items()
        }

    def dump(self):
        out = pathlib.Path(self.cfg.output_path)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "metrics.json", "w") as f:
            json.dump(self.summary(), f, indent=2)
        return out / "metrics.json"


def main(argv=None) -> dict:
    """CLI: gt_dir method1_dir [method2_dir ...]; prints and dumps the
    summary (to `outputs/metrics/metrics.json`, or `--output_path`)."""
    import argparse

    ap = argparse.ArgumentParser(description="Score saved renderings against ground truth.")
    ap.add_argument("gt_dir")
    ap.add_argument("method_dirs", nargs="+")
    ap.add_argument("--output_path", default=MetricComputerConfig.output_path)
    args = ap.parse_args(argv)
    gt_root = pathlib.Path(args.gt_dir)
    computer = MetricComputer(MetricComputerConfig(ground_truth_dir=str(gt_root),
                                                   output_path=args.output_path))
    for method_dir in args.method_dirs:
        method_dir = pathlib.Path(method_dir)
        for scene_dir in sorted(p for p in method_dir.iterdir() if p.is_dir()):
            gt_dir = gt_root / scene_dir.name
            if gt_dir.exists():
                computer.score_scene(
                    method_dir.name, scene_dir.name,
                    scene_dir / "color" if (scene_dir / "color").exists() else scene_dir,
                    gt_dir,
                )
    print(json.dumps(computer.summary(), indent=2))
    computer.dump()
    return computer.summary()


if __name__ == "__main__":
    main()
