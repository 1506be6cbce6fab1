"""Where the time of one `distill.yaml` train step goes on the card:

    python -m vicasplat_tpu_torch.diagnostics.distill_profile [--out distill_profile.json]

The experiment at full width, as chip_smoke.py's `distill` phase runs it:
the ViT-L student with `encoder.dpt_stabilize=true`, the full DUSt3R teacher
with its heads' last conv scaled by 0.1 (random weights both, from seeds),
batch 24 of 2 context and 4 target frames of 256^2 drawn from a seed,
split into 3 micro-batches. Prints one JSON object, also written to --out:
- step_ms: the host time (synchronized) of one step in each phase, after
  one warm-up step in each, and alloc_retries: the caching allocator's
  retries in that step (each frees cached blocks and allocates again);
- teacher_ms: the device time (CUDA events) of the teacher on the step's
  anchor pairs, as the step calls it (one call a micro-batch);
- profile: one "distill" step under torch.profiler: its host window, the
  device time of its kernels, their share of the window, and the top
  operators by the device time of the kernels they launch.
It needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import platform
import subprocess
import sys
import time

import numpy as np
import torch

OVERRIDES = ("+experiment=distill", "mode=train", "encoder.dpt_stabilize=true",
             "train.accumulate_grad_batches=3", "train.distill_only_steps=1",
             "train.distill_max_steps=1")
HEAD_SCALE = 0.1


def make_batch(cfg, device, seed: int = 0) -> dict:
    """A batch of the experiment's shape: uniform frames, normalized K,
    c2w poses near the identity (context frame 0 exactly)."""
    rng = np.random.default_rng(seed)
    B = cfg.data_loader["train"]["batch_size"]
    vs = cfg.dataset["re10k"]["view_sampler"]
    hw = cfg.encoder.backbone.img_size
    K = np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32)

    def views(n, first_identity):
        ext = np.tile(np.eye(4, dtype=np.float32), (B, n, 1, 1))
        ext[..., :3, 3] = rng.normal(0, 0.2, (B, n, 3))
        if first_identity:
            ext[:, 0] = np.eye(4, dtype=np.float32)
        out = {"image": rng.uniform(0, 1, (B, n, hw, hw, 3)),
               "intrinsics": np.tile(K, (B, n, 1, 1)), "extrinsics": ext,
               "near": np.full((B, n), 0.1), "far": np.full((B, n), 100.0)}
        return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in out.items()}

    return {"context": views(vs["num_context_views"], True),
            "target": views(vs["num_target_views"], False)}


def profile_step(fn) -> dict:
    """fn() once under torch.profiler: host window, device kernel time,
    their ratio, and the top operators by their kernels' device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted(((e.key, e.self_device_time_total / 1e3) for e in events
                  if e.device_type == DeviceType.CPU and e.self_device_time_total),
                 key=lambda r: -r[1])
    return {"host_window_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "top": ops[:10]}


def run(overrides=OVERRIDES, device="cuda", teacher_cfg=None) -> dict:
    from vicasplat_tpu_torch import main as tmain
    from vicasplat_tpu_torch.models.dust3r import init_dust3r, make_teacher_fn
    from vicasplat_tpu_torch.training import make_train_step
    from vicasplat_tpu_torch.training.step import PHASES
    from vicasplat_tpu_torch.utils.config import parse_cli

    dev = torch.device(device)
    cfg = parse_cli(list(overrides))
    train_cfg, model, opt = tmain.build_all(cfg, dev)
    teacher = init_dust3r(teacher_cfg or tmain.teacher_config(cfg),
                          torch.Generator(dev).manual_seed(1), dev)
    with torch.no_grad():
        for head in (teacher.head1, teacher.head2):
            head.head["conv3"].weight.mul_(HEAD_SCALE)
    teacher_fn = make_teacher_fn(teacher, torch.bfloat16)
    step = make_train_step(train_cfg, model, opt, teacher_fn=teacher_fn)
    batch = make_batch(cfg, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def retries():
        return (torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
                if dev.type == "cuda" else 0)

    step_ms, alloc_retries, logs = {}, {}, {}
    for i, ph in enumerate(PHASES * 2):  # a warm-up step in each phase, then one timed
        sync()
        r0, t = retries(), time.perf_counter()
        out = step(batch, i, ph)
        sync()
        if i >= len(PHASES):
            step_ms[ph] = (time.perf_counter() - t) * 1e3
            alloc_retries[ph] = retries() - r0
            logs[ph] = {k: float(v) for k, v in out.items()}
    res = {"step_ms": step_ms, "alloc_retries": alloc_retries, "logs": logs,
           "accumulate": train_cfg.accumulate_steps,
           "batch": batch["context"]["image"].shape[0]}
    if dev.type != "cuda":
        return res
    img = batch["context"]["image"] * 2 - 1
    A = train_cfg.accumulate_steps
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for chunk in img.chunk(A):
        teacher_fn(chunk[:, 0], chunk[:, 1])
    e1.record()
    torch.cuda.synchronize(dev)
    res["teacher_ms"] = e0.elapsed_time(e1)
    res["teacher_share"] = res["teacher_ms"] / step_ms["distill"]
    res["profile"] = profile_step(lambda: step(batch, 1, "distill"))
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="distill_profile.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("distill_profile: no CUDA card")
    res = run()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    res.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi.stdout.strip(),
               torch=torch.__version__, python=platform.python_version())
    text = json.dumps(res, indent=1)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
