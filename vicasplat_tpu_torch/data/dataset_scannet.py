"""ScanNet scene-directory dataset, for the NVS and pose evaluations (port
of vicasplat_tpu/data/dataset_scannet.py:27-152; `scannet_pose` names the
same reader). Layout:
  <root>/<stage>/<scene>/color/<i>.jpg, depth/<i>.png (millimetres),
  extrinsics.npy (V, 4, 4 c2w), intrinsic/intrinsic_color.txt (4x4 pixels),
with <root>/<stage>_idx.txt listing the scenes. Colour frames are resized
to 640x480 and depths likewise, as PIL's `Image.open(path).resize(size)`
does it (its default BICUBIC: 8-bit fixed point for RGB, PIL's I;16
arithmetic for 16-bit depth PNGs; `image_io.resize_bicubic`), depths in
metres; intrinsics normalized by the image size; baseline-1 rescale and
first-context-relative poses as in RE10K; then the shims.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional

import numpy as np

from ..geometry_np import camera_normalization_np
from ..utils.host_image import decode_jpeg, jpeg_info
from ..utils.image_io import decode_png_samples, read_rgb8, resize_bicubic
from .shims import apply_augmentation_shim, apply_crop_shim
from .view_samplers import NotEnoughFramesError


@dataclasses.dataclass(frozen=True)
class DatasetScannetConfig:
    name: str = "scannet"
    roots: tuple = ()
    input_image_shape: tuple = (256, 256)
    original_image_shape: tuple = (480, 640)
    background_color: tuple = (0.0, 0.0, 0.0)
    cameras_are_circular: bool = False
    overfit_to_scene: Optional[str] = None
    make_baseline_1: bool = True
    relative_pose: bool = True
    augment: bool = False
    load_depth: bool = True
    near: float = 0.05
    far: float = 100.0


def _read_samples(path: pathlib.Path) -> np.ndarray:
    """An image file's samples as PIL opens them: (H, W, 3) uint8 RGB for a
    JPEG or a colour PNG, (H, W) uint8 or uint16 for a grey PNG."""
    if path.suffix.lower() in (".jpg", ".jpeg"):
        return decode_jpeg(path.read_bytes())
    px, ctype, _ = decode_png_samples(path.read_bytes())
    if ctype == 0:
        return px[..., 0]
    return read_rgb8(path)


class DatasetScannet:
    def __init__(self, cfg: DatasetScannetConfig, stage: str, view_sampler,
                 seed: int = 0, device=None):
        # `device` is the loader's; this reader makes host arrays only
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        self.rng = np.random.default_rng(seed)
        self.scenes: list = []
        for root in cfg.roots:
            root = pathlib.Path(root)
            idx_file = root / f"{self.data_stage}_idx.txt"
            if idx_file.exists():
                with idx_file.open() as f:
                    names = [ln.strip() for ln in f if ln.strip()]
                self.scenes.extend(root / self.data_stage / n for n in names)
            elif (root / self.data_stage).exists():
                self.scenes.extend(sorted((root / self.data_stage).iterdir()))

    @property
    def data_stage(self) -> str:
        return "test" if self.stage == "val" else self.stage

    def __len__(self):
        return len(self.scenes)

    def _load_image(self, path, size=(640, 480)):
        return resize_bicubic(_read_samples(pathlib.Path(path)), size).astype(np.float32) / 255.0

    def _load_depth(self, path, size=(640, 480)):
        d = resize_bicubic(_read_samples(pathlib.Path(path)), size).astype(np.float32) / 1000.0
        d[~np.isfinite(d)] = 0.0
        return d

    def __getitem__(self, idx: int) -> Optional[dict]:
        cfg = self.cfg
        path = self.scenes[idx]
        scene = path.name
        if not path.exists():
            path = pathlib.Path(str(path)[:-2])

        w0, h0, _ = jpeg_info((path / "color" / "0.jpg").read_bytes())
        extrinsics = np.load(path / "extrinsics.npy").astype(np.float32)
        K4 = np.loadtxt(path / "intrinsic" / "intrinsic_color.txt").astype(np.float32)
        v = extrinsics.shape[0]
        intrinsics = np.tile(K4[None, :3, :3], (v, 1, 1))
        try:
            ctx_idx, tgt_idx, _ = self.view_sampler.sample(scene, v, self.rng)
        except NotEnoughFramesError:
            return None
        intrinsics[:, :1] /= w0
        intrinsics[:, 1:2] /= h0

        ctx_images = np.stack([self._load_image(path / "color" / f"{i}.jpg") for i in ctx_idx])
        tgt_images = np.stack([self._load_image(path / "color" / f"{i}.jpg") for i in tgt_idx])

        scale = 1.0
        if cfg.make_baseline_1:
            a = extrinsics[ctx_idx[0], :3, 3]
            b = extrinsics[ctx_idx[-1], :3, 3]
            scale = float(np.linalg.norm(a - b))
            extrinsics = extrinsics.copy()
            extrinsics[:, :3, 3] /= scale
        if cfg.relative_pose:
            extrinsics = camera_normalization_np(extrinsics[ctx_idx[0]], extrinsics)

        def views(idx_arr, images):
            return {
                "extrinsics": extrinsics[idx_arr].astype(np.float32),
                "intrinsics": intrinsics[idx_arr].astype(np.float32),
                "image": images.astype(np.float32),
                "near": np.full(len(idx_arr), cfg.near / scale, np.float32),
                "far": np.full(len(idx_arr), cfg.far / scale, np.float32),
                "index": np.asarray(idx_arr, np.int64),
            }

        example = {
            "context": views(ctx_idx, ctx_images),
            "target": views(tgt_idx, tgt_images),
            "scene": scene,
        }
        if cfg.load_depth:
            example["context"]["depth"] = np.stack(
                [self._load_depth(path / "depth" / f"{i}.png") for i in ctx_idx]) / scale
            example["target"]["depth"] = np.stack(
                [self._load_depth(path / "depth" / f"{i}.png") for i in tgt_idx]) / scale
        if self.stage == "train" and cfg.augment:
            example = apply_augmentation_shim(example, self.rng)
        return apply_crop_shim(example, tuple(cfg.input_image_shape))

    def __iter__(self):
        order = np.arange(len(self.scenes))
        if self.stage in ("train", "val"):
            self.rng.shuffle(order)
        for i in order:
            ex = self[int(i)]
            if ex is not None:
                yield ex
