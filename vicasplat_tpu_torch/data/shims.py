"""Host-side example shims (port of the augmentation part of
vicasplat_tpu/data/shims.py:100-119): x-reflection of a training example's
images and cameras. Numpy in, numpy out; images are (V, H, W, 3)."""
from __future__ import annotations

import numpy as np

_REFLECT = np.diag([-1.0, 1.0, 1.0, 1.0]).astype(np.float32)


def reflect_views(views: dict) -> dict:
    return {
        **views,
        "image": views["image"][:, :, ::-1].copy(),
        "extrinsics": _REFLECT @ views["extrinsics"] @ _REFLECT,
    }


def apply_augmentation_shim(example: dict, rng: np.random.Generator) -> dict:
    """x-reflection of images and extrinsics with p = 0.5."""
    if rng.random() < 0.5:
        return example
    return {
        **example,
        "context": reflect_views(example["context"]),
        "target": reflect_views(example["target"]),
    }
