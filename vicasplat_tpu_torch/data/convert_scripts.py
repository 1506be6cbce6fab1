"""Scene conversion into the chunked `.torch` format (port of
vicasplat_tpu/data/convert_scripts.py:33-148): chunk files of about
`chunk_mb` MB holding {key, url, timestamps, cameras (V, 18), images: list
of uint8 tensors of JPEG bytes}, and `index.json` mapping scene -> chunk.

A scene is a directory `<in_root>/<scene>/` with `images/<frame>.png|jpg`
(or the frames beside the poses) and a poses file: `transforms.json`
(nerfstudio style) or `cameras.npz` with `intrinsics` (V, 3, 3),
normalized or in pixels, and `extrinsics_w2c` or `extrinsics_c2w`
(V, 4, 4). JPEG frames are stored as they are; PNG frames are read by the
port's PNG decoder and encoded by the port's JPEG encoder at quality 95
(the file PIL writes, `utils/host_image.py`).

    python -m vicasplat_tpu_torch.data.convert_scripts --input_dir scenes/ \\
        --output_dir datasets/re10k --stage test
"""
from __future__ import annotations

import argparse
import json
import pathlib
import struct

import numpy as np
import torch

from ..utils.host_image import encode_jpegs, jpeg_info
from ..utils.image_io import read_rgb8

JPEG_SUFFIXES = (".jpg", ".jpeg")


def _image_size(path: pathlib.Path) -> tuple:
    """(width, height) from an image file's header."""
    data = path.read_bytes()
    if path.suffix.lower() in JPEG_SUFFIXES:
        w, h, _ = jpeg_info(data)
        return w, h
    return struct.unpack(">II", data[16:24])  # the PNG's IHDR


def encode_frames(paths) -> list:
    """Image files -> JPEG bytes each: JPEGs as they are, the other frames
    decoded and encoded at quality 95 together (threads in the codec)."""
    paths = [pathlib.Path(p) for p in paths]
    out = [p.read_bytes() if p.suffix.lower() in JPEG_SUFFIXES else None for p in paths]
    todo = [i for i, b in enumerate(out) if b is None]
    by_shape: dict = {}
    for i in todo:
        img = read_rgb8(paths[i])
        by_shape.setdefault(img.shape, []).append((i, img))
    for items in by_shape.values():
        encoded = encode_jpegs(np.stack([img for _, img in items]), quality=95)
        for (i, _), raw in zip(items, encoded):
            out[i] = raw
    return out


def _cameras_18(intrinsics: np.ndarray, w2c: np.ndarray) -> np.ndarray:
    """Normalized K (V, 3, 3) and w2c (V, 4, 4) -> the (V, 18) row format."""
    v = intrinsics.shape[0]
    out = np.zeros((v, 18), np.float32)
    out[:, 0] = intrinsics[:, 0, 0]
    out[:, 1] = intrinsics[:, 1, 1]
    out[:, 2] = intrinsics[:, 0, 2]
    out[:, 3] = intrinsics[:, 1, 2]
    out[:, 6:] = w2c[:, :3].reshape(v, 12)
    return out


def load_scene_cameras(scene_dir: pathlib.Path):
    """-> (normalized K (V, 3, 3), w2c (V, 4, 4), image paths)."""
    scene_dir = pathlib.Path(scene_dir)
    frames_dir = scene_dir / "images" if (scene_dir / "images").exists() else scene_dir
    imgs = sorted(p for p in frames_dir.iterdir()
                  if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
    tj = scene_dir / "transforms.json"
    npz = scene_dir / "cameras.npz"
    if tj.exists():
        with tj.open() as f:
            meta = json.load(f)
        w = meta.get("w", 1)
        h = meta.get("h", 1)
        K = np.eye(3, dtype=np.float32)
        K[0, 0] = meta["fl_x"] / w
        K[1, 1] = meta["fl_y"] / h
        K[0, 2] = meta.get("cx", w / 2) / w
        K[1, 2] = meta.get("cy", h / 2) / h
        c2w = np.stack([np.asarray(fr["transform_matrix"], np.float32)
                        for fr in meta["frames"]])
        v = c2w.shape[0]
        return np.tile(K, (v, 1, 1)), np.linalg.inv(c2w), imgs[:v]
    if npz.exists():
        data = np.load(npz)
        K = data["intrinsics"].astype(np.float32)
        if K[..., 0, 0].max() > 10:  # pixels -> normalize by the image size
            w, h = _image_size(imgs[0])
            K = K.copy()
            K[:, 0] /= w
            K[:, 1] /= h
        if "extrinsics_w2c" in data:
            w2c = data["extrinsics_w2c"].astype(np.float32)
        else:
            w2c = np.linalg.inv(data["extrinsics_c2w"].astype(np.float32))
        return K, w2c, imgs[: K.shape[0]]
    raise FileNotFoundError(f"no transforms.json or cameras.npz in {scene_dir}")


def convert_scenes(in_root, out_root, stage: str = "test", chunk_mb: int = 100):
    """Every scene directory of `in_root` -> chunks and index.json under
    `out_root/stage`; returns the number of chunks written."""
    in_root = pathlib.Path(in_root)
    out_dir = pathlib.Path(out_root) / stage
    out_dir.mkdir(parents=True, exist_ok=True)
    index = {}
    chunk, chunk_bytes, chunk_id = [], 0, 0

    def flush():
        nonlocal chunk, chunk_bytes, chunk_id
        if not chunk:
            return
        name = f"{chunk_id:06d}.torch"
        torch.save(chunk, out_dir / name)
        for ex in chunk:
            index[ex["key"]] = name
        chunk, chunk_bytes = [], 0
        chunk_id += 1

    for scene_dir in sorted(p for p in in_root.iterdir() if p.is_dir()):
        try:
            K, w2c, img_paths = load_scene_cameras(scene_dir)
        except FileNotFoundError as e:
            print(f"skip {scene_dir.name}: {e}")
            continue
        images = []
        for raw in encode_frames(img_paths):
            images.append(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
            chunk_bytes += len(raw)
        chunk.append({
            "key": scene_dir.name,
            "cameras": torch.from_numpy(_cameras_18(K, w2c)),
            "images": images,
            "url": "",
            "timestamps": torch.arange(len(images)),
        })
        if chunk_bytes > chunk_mb * 1024 * 1024:
            flush()
    flush()
    with open(out_dir / "index.json", "w") as f:
        json.dump(index, f, indent=2)
    print(f"wrote {chunk_id} chunks, {len(index)} scenes -> {out_dir}")
    return chunk_id


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--stage", default="test")
    ap.add_argument("--chunk_mb", type=int, default=100)
    args = ap.parse_args(argv)
    return convert_scenes(args.input_dir, args.output_dir, args.stage, args.chunk_mb)


if __name__ == "__main__":
    main()
