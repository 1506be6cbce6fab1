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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True)
    p.add_argument("--label", required=True)
    p.add_argument("--mode", choices=("all", "accel"), default="all")
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
    if args.mode == "accel":
        rec.update(_accel_forward(dev, VicaSplatConfig, VicaNetConfig,
                                  GaussianAdapterConfig, init_vicasplat,
                                  vicasplat_forward))
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
    gi = torch.Generator(device=dev).manual_seed(1)
    K = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], device=dev)
    context = {"image": torch.rand(1, 8, 256, 256, 3, generator=gi, device=dev) * 2 - 1,
               "intrinsics": K.expand(1, 8, 3, 3)}
    times = []
    with torch.inference_mode():
        for i in range(13):
            e0.record()
            vicasplat_forward(model, context, dtype=torch.bfloat16)
            e1.record()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(e0.elapsed_time(e1))
    rec["forward_ms"] = statistics.median(times)
    rec["forward_all_ms"] = times
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = VicaSplatConfig(backbone=VicaNetConfig(),
                          gaussian_adapter=GaussianAdapterConfig(sh_degree=4),
                          head_tail_backend="pallas")
    model = init_vicasplat(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    model = model.to(torch.bfloat16).eval()
    gi = torch.Generator(device=dev).manual_seed(1)
    K = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], device=dev)
    context = {"image": torch.rand(1, 8, 256, 256, 3, generator=gi, device=dev) * 2 - 1,
               "intrinsics": K.expand(1, 8, 3, 3)}
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    with torch.inference_mode():
        for i in range(13):
            e0.record()
            vicasplat_forward(model, context, dtype=torch.bfloat16)
            e1.record()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(e0.elapsed_time(e1))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            vicasplat_forward(model, context, dtype=torch.bfloat16)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"accel_forward_ms": statistics.median(times), "accel_forward_all_ms": times,
            "accel_device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "k3_device_ms": sum(e.self_device_time_total for e in kernels
                                if "dpt_tail" in e.key) / 1e3}


if __name__ == "__main__":
    sys.exit(main())
