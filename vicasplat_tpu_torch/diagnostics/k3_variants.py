"""What holds K3 back: csrc/dpt_tail.cu built with its diagnostic switches
and timed at the flagship GS-head shape beside the kernel as built:

    python -m vicasplat_tpu_torch.diagnostics.k3_variants [--out k3_variants.json]

Variants (nvcc -D flags, each into its own library under build/kernels):
- "cluster 2": the kernel as kernels/build.py builds it;
- "cluster 1", "cluster 4": each w1 slice multicast to 1 or 4 blocks;
- "products only" (K3_MODE=1): the wgmma loop with no load, no sum of
  a + m and no barrier wait; its output is meaningless;
- "loads only" (K3_MODE=2): every TMA load, the a + m sums and the ring's
  barriers, with no product.
Each runs a, m (8, 256, 256, 256) bf16, F = 256, O = 83 with and without m:
the mean of 10 back-to-back calls by CUDA events after 3 warm-ups, and one
call's device time by the profiler. The real variants are also held
against the float32 plain version (relative error). cuDNN's unfused bf16
calls are timed beside them. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..kernels import build
from ..kernels.dpt_tail import _ARGTYPES, dpt_tail_reference, repack_weights

VARIANTS = {
    "cluster 2": (),
    "cluster 1": ("-DK3_CLUSTER=1",),
    "cluster 4": ("-DK3_CLUSTER=4",),
    "products only": ("-DK3_MODE=1",),
    "loads only": ("-DK3_MODE=2",),
}
CHECKED = ("cluster 2", "cluster 1", "cluster 4")


def _build(variants):
    """One nvcc a variant, all started together: {name: library path}."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "dpt_tail.cu"
    procs, libs = {}, {}
    for name, flags in variants.items():
        out = build.BUILD_DIR / f"dpt_tail-variant-{name.replace(' ', '_')}.so"
        libs[name] = out
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(out), str(src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
    return libs


def _timed(fn, iters=10, warmup=3):
    for _ in range(warmup):
        fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _device_ms(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="k3_variants.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_variants: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    libs = _build(VARIANTS)

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    N, H, W, C, Fd, O = 8, 256, 256, 256, 256, 83
    a = torch.randn(N, H, W, C, generator=g, device=dev).to(bf)
    m = torch.randn(N, H, W, C, generator=g, device=dev).relu().to(bf)
    w1 = (torch.randn(Fd, C, 3, 3, generator=g, device=dev) / (9 * C) ** 0.5).to(bf)
    b1 = torch.randn(Fd, generator=g, device=dev).to(bf)
    w2 = (torch.randn(O, Fd, 1, 1, generator=g, device=dev) / Fd ** 0.5).to(bf)
    b2 = torch.randn(O, generator=g, device=dev).to(bf)
    packed = repack_weights(w1, b1, w2, b2)
    out = torch.empty(N, H, W, O, dtype=bf, device=dev)

    def launcher(fn, mm):
        def run():
            rc = fn(a.data_ptr(), None if mm is None else mm.data_ptr(),
                    packed.w1t.data_ptr(), packed.b1f.data_ptr(), packed.w2p.data_ptr(),
                    packed.b2p.data_ptr(), out.data_ptr(), N, H, W, C, Fd, O,
                    packed.os_n, packed.n_os, build.raw_stream(dev))
            if rc != 0:
                raise RuntimeError(f"launch failed: error {rc}")
        return run

    def library(mm):
        x = a if mm is None else a + mm
        h = F.relu(F.conv2d(x.permute(0, 3, 1, 2), w1, b1, padding=1))
        return F.conv2d(h, w2, b2)

    refs = {"with m": dpt_tail_reference(a, m, w1, b1, w2, b2).float(),
            "without m": dpt_tail_reference(a, None, w1, b1, w2, b2).float()}
    rec = {"device": smi, "shape": f"a, m ({N}, {H}, {W}, {C}) bf16, F {Fd}, O {O}",
           "variants": {}}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).vs_dpt_tail
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        row = {}
        for label, mm in (("with m", m), ("without m", None)):
            run = launcher(fn, mm)
            run()
            torch.cuda.synchronize()
            r = {"ms": _timed(run), "device_ms": _device_ms(run)}
            if name in CHECKED:
                run()
                ref = refs[label]
                r["rel_err"] = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            row[label] = r
        rec["variants"][name] = row
        print(json.dumps({name: row}), flush=True)
    rec["cudnn"] = {label: {"ms": _timed(lambda: library(mm)),
                            "device_ms": _device_ms(lambda: library(mm))}
                    for label, mm in (("with m", m), ("without m", None))}
    print(json.dumps({"cudnn": rec["cudnn"]}), flush=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
