"""Inference demo (port of the repository's root demo.py): a folder of
frames -> Gaussians and poses -> a video along the interpolated trajectory,
the Gaussians as PLY, transforms.json and a GLB of centres and cameras.

    python -m vicasplat_tpu_torch.demo --image_dir frames/ \
        [--ckpt weights.npz] [--output_dir outputs/demo] [--fov 60]

Frames are PNGs or JPEGs (`utils/image_io.read_rgb8`), resized on the short side as
PIL's LANCZOS does and centre-cropped. Clips of at most `--window` frames
go through one bf16 forward; longer ones stream through the serving engine
by sliding windows (`streaming.reconstruct_video`). The render is the
default `DecoderSplattingConfig()`. Under `torchrun --nproc_per_node=N`
(WORLD_SIZE > 1) the trajectory's views split over the N cards
(`parallel.decoder_forward_view_sharded`), as the JAX demo splits them over
its devices; every rank reconstructs the same scene and rank 0 writes the
outputs. Runs on the card unless `main(argv, device="cpu")`.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")


def load_images(image_dir: pathlib.Path, size: int = 256) -> np.ndarray:
    """Resize the short side to `size` (PIL's LANCZOS, `resize_lanczos`),
    centre-crop a square (root `demo.py:24-45`). Returns (T, size, size, 3)
    float32 in [0, 1]. PNG and JPEG frames (the port's own decoders)."""
    from .utils.image_io import read_rgb8, resize_lanczos

    paths = sorted(p for p in pathlib.Path(image_dir).iterdir()
                   if p.suffix.lower() in IMAGE_SUFFIXES)
    if not paths:
        raise FileNotFoundError(f"no images in {image_dir}")
    out = []
    for p in paths:
        img = read_rgb8(p)
        h, w = img.shape[:2]
        scale = size / min(w, h)
        img = resize_lanczos(img, (round(w * scale), round(h * scale)))
        h, w = img.shape[:2]
        left, top = (w - size) // 2, (h - size) // 2
        out.append(img[top:top + size, left:left + size].astype(np.float32) / 255.0)
    return np.stack(out)


def intrinsics_from_fov(fov_degrees: float) -> np.ndarray:
    """The normalized K of a centred pinhole camera with this horizontal FoV."""
    f = 0.5 / np.tan(np.radians(fov_degrees) / 2)
    return np.array([[f, 0, 0.5], [0, f, 0.5], [0, 0, 1.0]], np.float32)


def run_demo(cfg, model, images01: np.ndarray, K: np.ndarray, out_dir, *,
             window: int = 8, overlap: int = 2, steps_per_segment: int = 8,
             dtype=torch.bfloat16, tag: str = "", device="cuda",
             view_mesh=None, write: bool = True) -> dict:
    """The demo's pipeline on (T, S, S, 3) frames in [0, 1] and one
    normalized K (3, 3): reconstruct (one forward, or streamed windows when
    T > window), write gaussians.ply, transforms.json, xyz_and_camera.glb,
    report the rasterizer caps' coverage, render the interpolated
    trajectory and write it as render.mp4 (or PNG frames without OpenCV).
    Returns what it computed: poses, Gaussians, trajectory, frames, the
    kept splat count, coverage, windows and seconds. With `view_mesh` (a
    1-D DeviceMesh or process group) the render splits its views over the
    ranks; `write=False` computes everything and writes no file."""
    from .decoder.splatting import DecoderSplattingConfig, coverage_report, decoder_forward
    from .models import Gaussians, vicasplat_forward
    from .utils.image_io import save_video
    from .utils.ply import export_ply
    from .visualization.camera_trajectory import interpolate_trajectory
    from .visualization.glb import write_glb

    device = torch.device(device)
    T, size = images01.shape[0], images01.shape[1]
    secs, windows = {}, None
    t0 = time.perf_counter()
    if T > window:
        # a long video: sliding windows with scale-aligned pose chaining,
        # each window a replay of the engine's one program
        from .serving import InferenceEngine
        from .streaming import reconstruct_video

        eng = InferenceEngine(cfg, model=model, dtype=dtype, device=device)
        scene = reconstruct_video(eng, images01, np.broadcast_to(K, (T, 3, 3)),
                                  window=window, overlap=overlap)
        g = Gaussians(*(None if x is None else x[None] for x in scene.gaussians))
        centers = g.means
        poses = scene.poses.astype(np.float32)
        windows = {"count": len(scene.window_scales),
                   "scales": scene.window_scales.tolist()}
    else:
        ctx = {"image": torch.from_numpy(images01).to(device)[None] * 2.0 - 1.0,
               "intrinsics": torch.from_numpy(K).to(device).expand(1, T, 3, 3)}
        with torch.no_grad():
            out = vicasplat_forward(model, ctx, dtype=dtype)
        g, centers = out["gaussians"], out["gaussian_centers"]
        poses = out["gaussian_camera_extrins"][0].float().cpu().numpy()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs["reconstruct"] = time.perf_counter() - t0

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()

    def host(x, *shape):
        return x.float().cpu().numpy().reshape(*shape)

    if write:
        n_kept = export_ply(host(g.means, -1, 3), host(g.scales, -1, 3),
                            host(g.rotations, -1, 4),
                            host(g.harmonics, -1, *g.harmonics.shape[-2:]),
                            host(g.opacities, -1), out_dir / "gaussians.ply")
    else:  # the count export_ply keeps (opacity >= its threshold)
        n_kept = int((g.opacities >= 0.005).sum())
    transforms = {
        "camera_model": "PINHOLE",
        "fl_x": float(K[0, 0] * size), "fl_y": float(K[1, 1] * size),
        "cx": size / 2, "cy": size / 2, "w": size, "h": size,
        "frames": [{"file_path": f"{i:03d}", "transform_matrix": poses[i].tolist()}
                   for i in range(T)],
    }
    if write:
        with open(out_dir / "transforms.json", "w") as f:
            json.dump(transforms, f, indent=2)
        write_glb(out_dir / "xyz_and_camera.glb", host(centers, -1, 3),
                  images01.reshape(-1, 3), camera_poses=poses,
                  focal=float(K[0, 0]), cam_size=0.05)
    secs["export"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    traj = interpolate_trajectory(torch.from_numpy(poses).to(device), steps_per_segment)
    V = traj.shape[0]
    Kv = torch.from_numpy(K).to(device).expand(1, V, 3, 3)
    dec_cfg = DecoderSplattingConfig()
    # warn where the rasterizer's static caps truncate this scene
    coverage = coverage_report(dec_cfg, g, traj[None], Kv, (size, size), tag=tag)
    render_args = (g, traj[None], Kv, torch.full((1, V), 0.05, device=device),
                   torch.full((1, V), 100.0, device=device), (size, size))
    with torch.no_grad():
        if view_mesh is not None:
            from .parallel import decoder_forward_view_sharded

            rendered = decoder_forward_view_sharded(dec_cfg, *render_args,
                                                    mesh=view_mesh)
        else:
            rendered = decoder_forward(dec_cfg, *render_args)
        frames = rendered.color[0].float().cpu().numpy()
    secs["render"] = time.perf_counter() - t0
    if write:
        save_video(frames, out_dir / "render.mp4")
    return {"poses": poses, "gaussians": g, "trajectory": traj, "frames": frames,
            "n_kept": n_kept, "coverage": coverage, "windows": windows,
            "seconds": secs}


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--ckpt", default=None, help="an npz checkpoint of the port")
    ap.add_argument("--output_dir", default="outputs/demo")
    ap.add_argument("--fov", type=float, default=60.0, help="assumed FoV (deg)")
    ap.add_argument("--steps_per_segment", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--window", type=int, default=8,
                    help="clip length per model pass; longer videos stream "
                         "through sliding windows (streaming.py)")
    ap.add_argument("--overlap", type=int, default=2,
                    help="shared frames between consecutive windows "
                         "(>=2 recommended so window scale is observable)")
    args = ap.parse_args(argv)

    from .models import (
        GaussianAdapterConfig,
        VicaNetConfig,
        VicaSplatConfig,
        init_vicasplat,
    )

    import os

    view_mesh, lead = None, True
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from .parallel.mesh import init_distributed, make_mesh

        rank, _ = init_distributed(device)
        if torch.device(device).type == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        view_mesh, lead = make_mesh(), rank == 0
    images = load_images(pathlib.Path(args.image_dir), args.size)
    print(f"loaded {images.shape[0]} frames at {args.size}x{args.size}")
    cfg = VicaSplatConfig(backbone=VicaNetConfig(img_size=args.size),
                          gaussian_adapter=GaussianAdapterConfig(sh_degree=4))
    model = init_vicasplat(cfg, torch.Generator(device).manual_seed(0), device)
    if args.ckpt:
        from .utils.checkpointing import load_weights

        load_weights(args.ckpt, model)
        print(f"loaded weights from {args.ckpt}")
    else:
        print("WARNING: no checkpoint given — running with random weights")
    res = run_demo(cfg, model.eval(), images, intrinsics_from_fov(args.fov),
                   args.output_dir, window=args.window, overlap=args.overlap,
                   steps_per_segment=args.steps_per_segment,
                   tag=pathlib.Path(args.image_dir).name, device=device,
                   view_mesh=view_mesh, write=lead)
    if res["windows"] is not None:
        print(f"streamed {res['windows']['count']} windows (window {args.window}, "
              f"overlap {args.overlap}); scales "
              f"{np.round(res['windows']['scales'], 3).tolist()}")
    out_dir = args.output_dir
    print(f"reconstruct: {res['seconds']['reconstruct']:.2f}s (includes the first "
          f"call's set-up); wrote {out_dir}/gaussians.ply ({res['n_kept']} splats), "
          f"transforms.json, xyz_and_camera.glb, render.mp4 "
          f"({res['frames'].shape[0]} frames)")
    return res


if __name__ == "__main__":
    main()
