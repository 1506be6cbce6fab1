"""Evaluation-index generator (port of
vicasplat_tpu/evaluation/index_generator.py:22-102): per scene, a context
pair within an epipolar-overlap band and random target views between them,
written as the frozen JSON index that the `evaluation` view sampler reads.
The numpy Generator draws are the JAX package's, and the overlap is the
same float32 computation (geometry/epipolar.py), so that the same seed and
cameras give the same JSON.

    python -m vicasplat_tpu_torch.evaluation.index_generator \\
        --data_root datasets/re10k/test --output_path assets/index
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
from typing import Optional

import numpy as np
import torch

from ..geometry.epipolar import view_overlap_fraction


@dataclasses.dataclass(frozen=True)
class IndexGeneratorConfig:
    num_target_views: int = 3
    min_distance: int = 45
    max_distance: int = 135
    min_overlap: float = 0.6
    max_overlap: float = 0.8
    output_path: str = "outputs/evaluation_index"
    seed: int = 0


@dataclasses.dataclass
class IndexEntry:
    context: tuple
    target: tuple
    overlap: Optional[float] = None


class EvaluationIndexGenerator:
    def __init__(self, cfg: IndexGeneratorConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.index: dict = {}

    def process_scene(self, scene: str, extrinsics: np.ndarray,
                      intrinsics: np.ndarray) -> Optional[IndexEntry]:
        """extrinsics (V, 4, 4) c2w, intrinsics (V, 3, 3) normalized ->
        the chosen entry, also kept in `self.index` (None marks a scene with
        no pair in the band)."""
        cfg = self.cfg
        v = extrinsics.shape[0]
        ext = torch.tensor(np.asarray(extrinsics, np.float32))
        K = torch.tensor(np.asarray(intrinsics, np.float32))

        def overlap_of(a, b):
            return float(view_overlap_fraction(ext[a], K[a], ext[b], K[b]))

        for context_index in self.rng.permutation(v):
            ci = int(context_index)
            valid = []
            for step in (1, -1):
                current = ci + step * cfg.min_distance
                while 0 <= current < v:
                    overlap = min(overlap_of(current, ci), overlap_of(ci, current))
                    delta = abs(current - ci)
                    if cfg.min_overlap <= overlap <= cfg.max_overlap:
                        valid.append((current, overlap))
                    if overlap < cfg.min_overlap or delta > cfg.max_distance:
                        break
                    current += step
            if valid:
                chosen, overlap = valid[self.rng.integers(len(valid))]
                left, right = sorted((chosen, ci))
                if right - left < cfg.num_target_views:
                    continue
                target = self.rng.choice(np.arange(left, right + 1),
                                         size=cfg.num_target_views, replace=False)
                entry = IndexEntry(context=(left, right),
                                   target=tuple(int(t) for t in np.sort(target)),
                                   overlap=overlap)
                self.index[scene] = entry
                return entry
        self.index[scene] = None
        return None

    def save(self) -> pathlib.Path:
        out = pathlib.Path(self.cfg.output_path)
        out.mkdir(exist_ok=True, parents=True)
        serial = {k: (None if v is None else dataclasses.asdict(v))
                  for k, v in self.index.items()}
        with open(out / "evaluation_index.json", "w") as f:
            json.dump(serial, f, indent=2)
        return out / "evaluation_index.json"


def main(argv=None) -> pathlib.Path:
    """Index every scene of the chunks in `--data_root` (a stage directory
    of `.torch` files), in chunk order, into
    `<output_path>/evaluation_index.json`."""
    from ..data.dataset_re10k import convert_poses

    ap = argparse.ArgumentParser(description="Write a 2-view evaluation index.")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--output_path", required=True)
    defaults = IndexGeneratorConfig()
    for f in dataclasses.fields(IndexGeneratorConfig):
        if f.name != "output_path":
            ap.add_argument(f"--{f.name}", type=type(getattr(defaults, f.name)),
                            default=getattr(defaults, f.name))
    args = ap.parse_args(argv)
    gen = EvaluationIndexGenerator(IndexGeneratorConfig(
        **{k: v for k, v in vars(args).items() if k != "data_root"}))
    for chunk_path in sorted(pathlib.Path(args.data_root).glob("*.torch")):
        for example in torch.load(chunk_path, weights_only=True):
            c2w, K = convert_poses(np.asarray(example["cameras"], np.float32))
            entry = gen.process_scene(example["key"], c2w, K)
            print(f"{example['key']}: {entry}")
    path = gen.save()
    print(f"wrote {len(gen.index)} scenes -> {path}")
    return path


if __name__ == "__main__":
    main()
