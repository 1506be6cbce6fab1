"""chip_smoke.py's `re10k` and `experiments` phases alone, with each
experiment config's train step traced by torch.profiler (the card's
activity alone) for its device kernel ms (its host ms then holds the
tracer's cost), and every micro-batch split tried from 1 (chip_smoke.py
starts at the first one its memory reckoning fits), so that the splits
that do not fit show their out-of-memory peaks.

The trace holds a full-width step up for 21-57 s on an H100, so
chip_smoke.py times the step by CUDA events only; this tool gives the
kernels' own time. It needs one CUDA card, prints one JSON line and
writes it to --out.

Usage, from the repository root:
    python tools/experiments_trace.py [--out build/experiments_trace.json]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parents[1]


def device_kernel_ms(fn):
    """(fn(), the device ms of the kernels it ran): torch.profiler tracing
    the card alone (tracing the host's operators too held a full-width
    train step up for 50-120 s, the card alone for 21-57 s; H100 80GB
    HBM3)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3


def traced_train_step(make_step, kernel_ms: list):
    """training.make_train_step's signature around `make_step`, each step
    traced: its device kernel ms appended to `kernel_ms` (a step that runs
    out of memory appends nothing)."""
    def make(cfg, model, optimizer, lpips_fn=None, teacher_fn=None):
        step = make_step(cfg, model, optimizer, lpips_fn, teacher_fn)

        def run(batch, global_step, phase="full"):
            logs, ms = device_kernel_ms(lambda: step(batch, global_step, phase))
            run.nonfinite = step.nonfinite
            kernel_ms.append(ms)
            return logs
        return run
    return make


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "experiments_trace.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from vicasplat_tpu_torch import training
    from vicasplat_tpu_torch.kernels import COUNTERS, build, launch_counts

    if not torch.cuda.is_available():
        sys.exit("experiments_trace: needs a CUDA card")
    smi = chip_smoke.nvidia_smi_line()
    build.build_all(chip_smoke.KERNELS)
    for name in chip_smoke.KERNELS:
        build.load(name)

    def reset_counts():
        for fn, attr in COUNTERS.values():
            setattr(fn, attr, 0)

    def every_split(cfg):
        batch = cfg.data_loader["train"]["batch_size"]
        return [m for m in (1, 2, 4, 8, 16) if batch % m == 0]

    zero = {name: 0 for name in COUNTERS}
    dev = torch.device("cuda", 0)
    kernel_ms = []
    chip_smoke.re10k_phase(dev, smi, reset_counts, launch_counts, zero)
    with mock.patch.object(chip_smoke, "experiment_splits", every_split), \
            mock.patch.object(training, "make_train_step",
                              traced_train_step(training.make_train_step, kernel_ms)):
        rec = chip_smoke.experiments_phase(dev, smi, reset_counts, launch_counts, zero)
    res = {}
    for name in chip_smoke.EXPERIMENTS:  # the phase runs them in this order
        steps = rec[name]["steps"]
        traced, kernel_ms = kernel_ms[:len(steps)], kernel_ms[len(steps):]
        res[name] = dict(micro=rec[name]["micro"], out_of_memory=rec[name]["out_of_memory"],
                         peak_gb=rec[name]["peak_gb"],
                         steps=[dict(traced_ms=st["ms"], kernel_ms=ms)
                                for st, ms in zip(steps, traced)])
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "experiments": res}, indent=1))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
