"""RE10K-style chunked dataset reader (port of
vicasplat_tpu/data/dataset_re10k.py:31-261), the pixelSplat `.torch` format
that RE10K, ACID, DL3DV, ScanNet++ and MVImgNet share.

A chunk is a list of examples {"key": str, "cameras": (V, 18) float tensor
[fx fy cx cy 0 0 | w2c 3x4 row-major], "images": list of uint8 tensors of
raw JPEG bytes, ...}, read with `torch.load(..., weights_only=True)`;
`<root>/<stage>/index.json` maps scene -> chunk file. Poses decode to
normalized K and c2w, the world is rescaled to a context baseline of 1,
poses are made relative to the first context frame, the JPEGs are decoded
by the port's own codec (`utils/host_image.py`, PIL's pixels byte for
byte), and the crop and reflection shims are applied. The numpy Generator
draws are the JAX package's, so the same seed gives the same examples.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterator, Optional

import numpy as np
import torch

from ..geometry_np import camera_normalization_np, get_fov_np
from ..utils.host_image import decode_jpegs_u8
from .shims import _REFLECT, rescale_and_crop_u8
from .view_samplers import NotEnoughFramesError


@dataclasses.dataclass(frozen=True)
class DatasetRE10kConfig:
    name: str = "re10k"
    roots: tuple = ()
    input_image_shape: tuple = (256, 256)
    original_image_shape: tuple = (360, 640)
    background_color: tuple = (0.0, 0.0, 0.0)
    cameras_are_circular: bool = False
    overfit_to_scene: Optional[str] = None
    baseline_min: float = 1e-3
    baseline_max: float = 1e10
    max_fov: float = 100.0
    make_baseline_1: bool = True
    augment: bool = True
    relative_pose: bool = True
    skip_bad_shape: bool = True
    near: float = 0.01
    far: float = 100.0


def convert_poses(poses: np.ndarray):
    """(V, 18) -> (c2w (V, 4, 4), normalized K (V, 3, 3))."""
    v = poses.shape[0]
    K = np.tile(np.eye(3, dtype=np.float32), (v, 1, 1))
    fx, fy, cx, cy = poses[:, 0], poses[:, 1], poses[:, 2], poses[:, 3]
    K[:, 0, 0], K[:, 1, 1] = fx, fy
    K[:, 0, 2], K[:, 1, 2] = cx, cy
    w2c = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    w2c[:, :3] = poses[:, 6:].reshape(v, 3, 4)
    return np.linalg.inv(w2c), K


class DatasetRE10k:
    """Iterable over one stage's examples."""

    def __init__(self, cfg: DatasetRE10kConfig, stage: str, view_sampler,
                 seed: int = 0, device=None):
        # `device` is the loader's; this reader makes host arrays only
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        self._seed = seed
        self.rng = np.random.default_rng(seed)
        self.chunks: list = []
        for root in cfg.roots:
            root = pathlib.Path(root) / self.data_stage
            if root.exists():
                self.chunks.extend(sorted(p for p in root.iterdir() if p.suffix == ".torch"))
        if cfg.overfit_to_scene is not None:
            chunk = self.index[cfg.overfit_to_scene]
            self.chunks = [chunk] * max(len(self.chunks), 1)

    @property
    def data_stage(self) -> str:
        if self.cfg.overfit_to_scene is not None:
            return "test"
        return "test" if self.stage == "val" else self.stage

    @property
    def index(self) -> dict:
        merged = {}
        stages = ("test", "train") if self.cfg.overfit_to_scene else (self.data_stage,)
        for stage in stages:
            for root in self.cfg.roots:
                p = pathlib.Path(root) / stage / "index.json"
                if not p.exists():
                    continue
                with p.open() as f:
                    idx = json.load(f)
                merged.update({k: pathlib.Path(root) / stage / v for k, v in idx.items()})
        return merged

    def _load_chunk(self, path: pathlib.Path) -> list:
        return torch.load(path, map_location="cpu", weights_only=True)

    def __iter__(self) -> Iterator[dict]:
        yield from self.iter_shard(0, 1)

    def iter_shard(self, worker_id: int = 0, num_workers: int = 1) -> Iterator[dict]:
        """A disjoint shard of the chunks (the reference DataLoader's
        num_workers split): every worker shuffles the chunk list with the
        same seed, then takes chunks[worker_id::num_workers]. With several
        workers, a pool of 4 threads processes each chunk's examples, each
        example with its own Generator seeded by (seed, worker, chunk,
        example)."""
        chunks = list(self.chunks)
        shuffle_rng = np.random.default_rng(self._seed)
        rng = (self.rng if num_workers == 1
               else np.random.default_rng([self._seed, worker_id]))
        if self.stage in ("train", "val"):
            shuffle_rng.shuffle(chunks)
        chunks = chunks[worker_id::num_workers]
        if num_workers == 1:
            for chunk_path in chunks:
                for raw in self._chunk_examples(chunk_path, rng):
                    ex = self._process(raw, rng)
                    if ex is not None:
                        yield ex
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=4) as pool:
            for ci, chunk_path in enumerate(chunks):
                raws = list(self._chunk_examples(chunk_path, rng))
                rngs = [np.random.default_rng([self._seed, worker_id, ci, i])
                        for i in range(len(raws))]
                for ex in pool.map(self._process, raws, rngs):
                    if ex is not None:
                        yield ex

    def _chunk_examples(self, chunk_path, rng):
        chunk = self._load_chunk(chunk_path)
        if self.cfg.overfit_to_scene is not None:
            chunk = [x for x in chunk if x["key"] == self.cfg.overfit_to_scene]
            chunk = chunk * max(1, len(chunk))
        if self.stage in ("train", "val"):
            rng.shuffle(chunk)
        return chunk

    def _process(self, raw: dict, rng=None) -> Optional[dict]:
        cfg = self.cfg
        rng = self.rng if rng is None else rng
        cameras = np.asarray(raw["cameras"], np.float32)
        extrinsics, intrinsics = convert_poses(cameras)
        scene = raw["key"]
        try:
            ctx_idx, tgt_idx, _ = self.view_sampler.sample(scene, extrinsics.shape[0], rng)
        except NotEnoughFramesError:
            return None
        if np.degrees(get_fov_np(intrinsics)).max() > cfg.max_fov:
            return None
        # a frame index past the scene, or a stream the decoder refuses,
        # drops the example, as the JAX reader drops it on PIL's OSError
        try:
            ctx_images = decode_jpegs_u8([raw["images"][i] for i in ctx_idx])
            tgt_images = decode_jpegs_u8([raw["images"][i] for i in tgt_idx])
        except (IndexError, ValueError):
            return None
        hw_in = cfg.input_image_shape
        if cfg.skip_bad_shape and (
            ctx_images.shape[1] < hw_in[0] or ctx_images.shape[2] < hw_in[1]
            or tgt_images.shape[1] < hw_in[0] or tgt_images.shape[2] < hw_in[1]
        ):
            return None

        scale = 1.0
        if cfg.make_baseline_1:
            a = extrinsics[ctx_idx[0], :3, 3]
            b = extrinsics[ctx_idx[-1], :3, 3]
            scale = float(np.linalg.norm(a - b))
            if scale < cfg.baseline_min or scale > cfg.baseline_max:
                return None
            extrinsics = extrinsics.copy()
            extrinsics[:, :3, 3] /= scale
        if cfg.relative_pose:
            extrinsics = camera_normalization_np(extrinsics[ctx_idx[0]], extrinsics)

        # x-reflection augmentation, decided here and applied to the u8
        # frames; the same draw as the generic shim's
        flip = self.stage == "train" and cfg.augment and not (rng.random() < 0.5)
        if flip:
            ctx_images = ctx_images[:, :, ::-1]
            tgt_images = tgt_images[:, :, ::-1]
            extrinsics = _REFLECT @ extrinsics @ _REFLECT

        shape = tuple(cfg.input_image_shape)

        def views(idx, images):
            images, K = rescale_and_crop_u8(np.ascontiguousarray(images), intrinsics[idx],
                                            shape)
            return {
                "extrinsics": extrinsics[idx].astype(np.float32),
                "intrinsics": K.astype(np.float32),
                "image": images,
                "near": np.full(len(idx), cfg.near / scale, np.float32),
                "far": np.full(len(idx), cfg.far / scale, np.float32),
                "index": np.asarray(idx, np.int64),
            }

        return {
            "context": views(ctx_idx, ctx_images),
            "target": views(tgt_idx, tgt_images),
            "scene": scene,
        }
