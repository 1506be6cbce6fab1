"""Host-side example shims (port of vicasplat_tpu/data/shims.py:13-119):
rescale and centre crop with the intrinsics fixed to match, and the
x-reflection augmentation. Numpy in, numpy out; images are (V, H, W, 3).

The LANCZOS resize is PIL's, byte for byte, by the port's host library
(`utils/host_image.resize_batch`, threaded C++; equal to
`image_io.resize_lanczos`), and the depth maps' NEAREST resize is PIL's
`ImagingScaleAffine` in numpy. The u8 path stays u8 until after the crop.
"""
from __future__ import annotations

import numpy as np

from ..utils.host_image import resize_batch


def _scaled_shape(h_in: int, w_in: int, shape: tuple) -> tuple:
    h_out, w_out = shape
    if h_out > h_in or w_out > w_in:
        raise ValueError(f"crop {shape} larger than the image ({h_in}, {w_in})")
    scale = max(h_out / h_in, w_out / w_in)
    h_s, w_s = round(h_in * scale), round(w_in * scale)
    if h_s != h_out and w_s != w_out:
        raise ValueError(f"rescaled ({h_s}, {w_s}) fits neither side of {shape}")
    return h_s, w_s


def rescale_image(image: np.ndarray, shape: tuple) -> np.ndarray:
    """LANCZOS resize of one (H, W, 3) float image in [0, 1] through uint8."""
    h, w = shape
    arr = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    return resize_batch(arr[None], (w, h))[0].astype(np.float32) / 255.0


def center_crop(images: np.ndarray, intrinsics: np.ndarray, shape: tuple):
    """(V, H, W, C) images and (V, 3, 3) normalized K -> the centre crop and
    K with fx, fy scaled to it."""
    h_in, w_in = images.shape[1:3]
    h_out, w_out = shape
    row = (h_in - h_out) // 2
    col = (w_in - w_out) // 2
    images = images[:, row:row + h_out, col:col + w_out]
    intrinsics = intrinsics.copy()
    intrinsics[:, 0, 0] *= w_in / w_out
    intrinsics[:, 1, 1] *= h_in / h_out
    return images, intrinsics


def rescale_and_crop(images: np.ndarray, intrinsics: np.ndarray, shape: tuple):
    """Float (V, H, W, 3) images: resize so that the crop fits, then crop."""
    h_s, w_s = _scaled_shape(*images.shape[1:3], shape)
    images = np.stack([rescale_image(im, (h_s, w_s)) for im in images])
    return center_crop(images, intrinsics, shape)


def rescale_and_crop_u8(images: np.ndarray, intrinsics: np.ndarray, shape: tuple):
    """uint8 (V, H, W, 3) -> resize and crop at uint8, then one float32 / 255.
    Equal to `rescale_and_crop` on the frames as float / 255 (its u8 round
    trip before the resize is the identity)."""
    h_s, w_s = _scaled_shape(*images.shape[1:3], shape)
    resized = resize_batch(images, (w_s, h_s))
    out, intrinsics = center_crop(resized, intrinsics, shape)
    return out.astype(np.float32) / 255.0, intrinsics


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output sample of PIL's NEAREST resize: the
    position starts at half a step and adds the step once a sample, in
    float64, and is truncated (Geometry.c `ImagingScaleAffine`)."""
    step = in_size / out_size
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    return np.minimum(pos.astype(np.int64), in_size - 1)


def _crop_depth(depth: np.ndarray, shape: tuple) -> np.ndarray:
    """(V, H, W) depth -> NEAREST resize and centre crop matching the image."""
    h_in, w_in = depth.shape[1:3]
    h_out, w_out = shape
    scale = max(h_out / h_in, w_out / w_in)
    h_s, w_s = round(h_in * scale), round(w_in * scale)
    d = depth.astype(np.float32)
    out = d[:, _nearest_index(h_in, h_s)][:, :, _nearest_index(w_in, w_s)]
    row, col = (h_s - h_out) // 2, (w_s - w_out) // 2
    return out[:, row:row + h_out, col:col + w_out]


def apply_crop_shim(example: dict, shape: tuple) -> dict:
    out = dict(example)
    for side in ("context", "target"):
        views = dict(example[side])
        views["image"], views["intrinsics"] = rescale_and_crop(
            views["image"], views["intrinsics"], shape)
        if "depth" in views:
            views["depth"] = _crop_depth(views["depth"], shape)
        out[side] = views
    return out


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
