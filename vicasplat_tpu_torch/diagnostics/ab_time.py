"""Time the flagship forward, the flagship training step and K1's host cost
in one tree of the repository, so that two trees can be compared in one
session on one card:

    python vicasplat_tpu_torch/diagnostics/ab_time.py --root TREE --label NAME \
        [--mode all|accel] [--out ab_time.jsonl]

TREE is the root of a checkout (this one, or an older commit unpacked with
git archive); its `vicasplat_tpu_torch` is the one timed, built into its
own build/kernels. The configurations come from this file's
training/presets.py, loaded into TREE's package, so both trees run the same
thing. Run the trees in turns (A, B, B, A) from one shell command. Appends
one JSON line to --out:
- forward_ms: median device time (CUDA events) of the default bf16 forward
  of 8 frames of 256^2 at random weights, 10 timed after 3 warm-ups;
- train_step_ms: median host time of the flagship step at batch 2 x 8
  frames, 12 targets, 3 timed after 2 warm-ups (with a sync);
- k1_host_us: the host time of one K1 forward call (no gradient) at the
  decoder shape, the mean of 200 calls issued back to back, and
  k1_device_ms, the mean device time of those calls.
With --mode accel, only the accelerator forward (head_tail_backend="pallas",
so K3 runs in the GS head) at the same weights and frames:
- accel_forward_ms: median device time (CUDA events) of 10 after 3 warm-ups;
- accel_device_ms: one forward's device kernels by the profiler, and
  k3_device_ms, the part of it in K3's kernels (names holding "dpt_tail").
With --mode render, only the accelerator render (RasterizeConfig(backend=
"pallas", binning="origin"), so K2 and K4 run) of the default forward's
Gaussians at the same weights and frames, 12 target views of 256^2:
- render_ms: median device time (CUDA events) of 10 after 3 warm-ups;
- render_device_ms: one render's device kernels by the profiler, and
  k2_device_ms and k4_device_ms, the parts in K2's and K4's kernels (names
  holding "composite_kernel" and "bitonic_topk_kernel");
- scene_*: the same for one view of the covering scene (frame 0 of the
  synthetic generator's scene 0 at 256^2 with 524,288 Gaussians, made by
  this file's data/synthetic_scenes.py), 20 timed after 3 warm-ups.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import statistics
import sys
import time

import torch

PRESETS = pathlib.Path(__file__).resolve().parents[1] / "training" / "presets.py"
SCENES = pathlib.Path(__file__).resolve().parents[1] / "data" / "synthetic_scenes.py"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True)
    p.add_argument("--label", required=True)
    p.add_argument("--mode", choices=("all", "accel", "render"), default="all")
    p.add_argument("--out", default="ab_time.jsonl")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_time: needs a CUDA card", file=sys.stderr)
        return 1
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import vicasplat_tpu_torch
    from vicasplat_tpu_torch.kernels import flash_attention
    from vicasplat_tpu_torch.models import (
        GaussianAdapterConfig,
        VicaNetConfig,
        VicaSplatConfig,
        init_vicasplat,
        vicasplat_forward,
    )
    from vicasplat_tpu_torch.training import AdamW, make_train_step

    if pathlib.Path(vicasplat_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {vicasplat_tpu_torch.__file__}, not {root}'s")
    spec = importlib.util.spec_from_file_location(
        "vicasplat_tpu_torch.training.presets", PRESETS)
    presets = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(presets)

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    rec = dict(label=args.label, root=str(root), device=torch.cuda.get_device_name(0))
    if args.mode in ("accel", "render"):
        fn = _accel_forward if args.mode == "accel" else _accel_render
        rec.update(fn(dev, VicaSplatConfig, VicaNetConfig, GaussianAdapterConfig,
                      init_vicasplat, vicasplat_forward))
        print(json.dumps(rec), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return 0

    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, s, 12, 64, generator=g, device=dev).bfloat16()
               for s in (2056, 2064, 2064))
    flash_attention(q, k, v)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    t = time.perf_counter()
    for _ in range(200):
        flash_attention(q, k, v)
    rec["k1_host_us"] = (time.perf_counter() - t) / 200 * 1e6
    e1.record()
    torch.cuda.synchronize()
    rec["k1_device_ms"] = e0.elapsed_time(e1) / 200
    del q, k, v

    cfg = VicaSplatConfig(backbone=VicaNetConfig(),
                          gaussian_adapter=GaussianAdapterConfig(sh_degree=4))
    model = init_vicasplat(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    model = model.to(torch.bfloat16).eval()
    context = _context(dev)

    def forward():
        with torch.inference_mode():
            vicasplat_forward(model, context, dtype=torch.bfloat16)

    rec["forward_ms"], rec["forward_all_ms"] = _median_ms(forward, 10)
    del model
    torch.cuda.empty_cache()

    tcfg = presets.flagship_train_config()
    model = init_vicasplat(tcfg.model, torch.Generator(device=dev).manual_seed(0), dev)
    step = make_train_step(tcfg, model, AdamW(model, tcfg.optimizer))
    batch = presets.flagship_train_batch(dev, 2, 12)
    times = []
    for i in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(batch, i)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t) * 1e3)
    rec["train_step_ms"] = statistics.median(times)
    rec["train_all_ms"] = times
    print(json.dumps(rec), flush=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return 0


def _accel_forward(dev, VicaSplatConfig, VicaNetConfig, GaussianAdapterConfig,
                   init_vicasplat, vicasplat_forward):
    """The accelerator forward of the tree's package (its classes passed in)."""
    cfg = VicaSplatConfig(backbone=VicaNetConfig(),
                          gaussian_adapter=GaussianAdapterConfig(sh_degree=4),
                          head_tail_backend="pallas")
    model = init_vicasplat(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    model = model.to(torch.bfloat16).eval()
    context = _context(dev)

    def forward():
        with torch.inference_mode():
            vicasplat_forward(model, context, dtype=torch.bfloat16)

    med, times = _median_ms(forward, 10)
    total, split = _device_split(forward, ("dpt_tail",))
    return {"accel_forward_ms": med, "accel_forward_all_ms": times,
            "accel_device_ms": total, "k3_device_ms": split["dpt_tail"]}


def _context(dev):
    """The 8 context frames of 256^2 every mode runs on, from seed 1."""
    gi = torch.Generator(device=dev).manual_seed(1)
    K = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], device=dev)
    return {"image": torch.rand(1, 8, 256, 256, 3, generator=gi, device=dev) * 2 - 1,
            "intrinsics": K.expand(1, 8, 3, 3)}


def _device_split(fn, names):
    """One call of fn under the profiler: (device kernel ms, {name: ms of
    the kernels whose names hold it})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            {n: sum(e.self_device_time_total for e in kernels if n in e.key) / 1e3
             for n in names})


def _median_ms(fn, iters, warmup=3):
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for i in range(warmup + iters):
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(e0.elapsed_time(e1))
    return statistics.median(times), times


def _accel_render(dev, VicaSplatConfig, VicaNetConfig, GaussianAdapterConfig,
                  init_vicasplat, vicasplat_forward):
    """The accelerator render of the tree's package (its classes passed in),
    of the flagship's Gaussians and of the covering scene."""
    from vicasplat_tpu_torch.decoder.splatting import (
        DecoderSplattingConfig,
        decoder_forward,
    )
    from vicasplat_tpu_torch.ops.rasterize import RasterizeConfig, render
    from vicasplat_tpu_torch.ops.rasterize.projection import cov6_from_scale_rot

    names = ("composite_kernel", "bitonic_topk_kernel")
    raster = RasterizeConfig(backend="pallas", binning="origin")
    cfg = VicaSplatConfig(backbone=VicaNetConfig(),
                          gaussian_adapter=GaussianAdapterConfig(sh_degree=4))
    model = init_vicasplat(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    model = model.to(torch.bfloat16).eval()
    context = _context(dev)
    K = context["intrinsics"][0, 0]
    views = 12
    tgt_ext = torch.eye(4, device=dev).repeat(1, views, 1, 1)
    tgt_ext[:, :, 2, 3] = torch.linspace(0.0, 0.5, views, device=dev)
    near = torch.ones(1, views, device=dev)
    far = torch.full((1, views), 100.0, device=dev)
    with torch.inference_mode():
        gaussians = vicasplat_forward(model, context, dtype=torch.bfloat16)["gaussians"]
    del model

    def flagship():
        with torch.inference_mode():
            decoder_forward(DecoderSplattingConfig(rasterize=raster), gaussians, tgt_ext,
                            K.expand(1, views, 3, 3), near, far, (256, 256))

    spec = importlib.util.spec_from_file_location("synthetic_scenes_ab", SCENES)
    scenes = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = scenes  # its dataclass looks itself up there
    spec.loader.exec_module(scenes)
    scfg = scenes.SyntheticScenesConfig(input_image_shape=(256, 256), n_gaussians=524288)
    rng = scenes.scene_rng(0, scfg)
    g = {k: torch.from_numpy(v).to(dev) for k, v in scenes.scene_gaussians(rng, scfg).items()}
    ext = torch.from_numpy(scenes.scene_trajectory(rng, scfg)[:1]).to(dev)
    sK = torch.from_numpy(scenes.intrinsics_for(scfg)[None]).to(dev)
    cov6 = cov6_from_scale_rot(g["scales"], g["rotations"])

    def scene():
        with torch.inference_mode():
            render(g["means"], cov6, g["harmonics"], g["opacities"], ext, sK, (256, 256),
                   torch.zeros(3, device=dev), 0, cfg=raster)

    rec = {}
    for label, fn, iters in (("", flagship, 10), ("scene_", scene, 20)):
        med, times = _median_ms(fn, iters)
        total, split = _device_split(fn, names)
        rec.update({f"{label}render_ms": med, f"{label}render_all_ms": times,
                    f"{label}render_device_ms": total,
                    f"{label}k2_device_ms": split["composite_kernel"],
                    f"{label}k4_device_ms": split["bitonic_topk_kernel"]})
    return rec


if __name__ == "__main__":
    sys.exit(main())
