"""What holds K1's float32 route back: csrc/flash_attn_f32.cu built with its
diagnostic switch and timed at the flagship decoder shape in float32:

    python -m vicasplat_tpu_torch.diagnostics.k1_f32_variants [--out k1_f32_variants.json]

Variants (nvcc -D flags, each into its own library under build/kernels):
- "as built": the kernels as kernels/build.py builds them;
- "products only" (K1F32_MODE=1): the consumers' products, softmax and
  ring with no producer load, split or store; its output is meaningless;
- "loads only" (K1F32_MODE=2): the producers' loads, splits and stores,
  the softmax and the ring, with no product; its output is meaningless;
- "stores only" (K1F32_MODE=3): as "loads only" with values made up in
  registers instead of read from device memory.
Each runs q (1, 2056, 12, 64) and k/v (1, 2064, 12, 64) float32 through
the wrapper's forward and backward, in turns (each variant, then back in
the reverse order): the mean of 20 back-to-back calls by CUDA events
after 3 warm-ups, and each kernel's device time by torch.profiler in the
first turn. "as built" is also held against the float32 plain versions
(relative error). Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import torch

from ..kernels import build
from ..kernels import flash_attn as fa

VARIANTS = {"as built": (), "products only": ("-DK1F32_MODE=1",),
            "loads only": ("-DK1F32_MODE=2",), "stores only": ("-DK1F32_MODE=3",)}


def _build(variants):
    """One nvcc a variant, all started together: {name: library path}."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "flash_attn_f32.cu"
    procs, libs = {}, {}
    for name, flags in variants.items():
        out = build.BUILD_DIR / f"flash_attn_f32-variant-{name.replace(' ', '_')}.so"
        libs[name] = out
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(out), str(src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
    return libs


def _use(path):
    """Route the wrapper's float32 entry points to the library at `path`."""
    build._loaded["flash_attn_f32"] = ctypes.CDLL(str(path))
    for key in [k for k in build._entries if k[0] == "flash_attn_f32"]:
        del build._entries[key]


def _timed(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _kernel_ms(fn):
    """{kernel: device ms} of one call of fn, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"f32_\w+?kernel(<\d+>)?", e.key)
            out[m.group(0) if m else e.key] = e.self_device_time_total / 1e3
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="k1_f32_variants.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_f32_variants: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    libs = _build(VARIANTS)
    g = torch.Generator(device=dev).manual_seed(8)
    b, sq, sk, h, d = 1, 2056, 2064, 12, 64
    q, do = (torch.randn(b, sq, h, d, generator=g, device=dev) for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, generator=g, device=dev) for _ in range(2))
    o_ref = fa.attention_reference(q, k, v).contiguous()
    lse_ref = fa.attention_lse_reference(q, k)
    refs = (o_ref, *fa.attention_backward_reference(q, k, v, o_ref, lse_ref, do))
    rec = {"device": smi, "shape": f"q ({b}, {sq}, {h}, {d}), k/v ({b}, {sk}, {h}, {d}) "
           "float32", "variants": {name: {"forward_ms": [], "backward_ms": []}
                                   for name in libs}}
    for turn, name in enumerate([*libs, *reversed(libs)]):
        _use(libs[name])
        row = rec["variants"][name]
        # the backward of every variant from the plain forward's o and lse
        o = fa._forward(q, k, v, False)[0]
        grads = fa.flash_attention_backward(q, k, v, o_ref, lse_ref, do)
        torch.cuda.synchronize()
        if name == "as built" and turn == 0:
            row["rel_err"] = max(((a - r).abs().max() / r.abs().max()).item()
                                 for a, r in zip((o, *grads), refs))
        row["forward_ms"].append(_timed(lambda: fa._forward(q, k, v, False)))
        row["backward_ms"].append(
            _timed(lambda: fa.flash_attention_backward(q, k, v, o_ref, lse_ref, do)))
        if turn < len(libs):
            row["kernel_ms"] = {**_kernel_ms(lambda: fa._forward(q, k, v, False)),
                                **_kernel_ms(lambda: fa.flash_attention_backward(
                                    q, k, v, o_ref, lse_ref, do))}
        print(json.dumps({name: row}), flush=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
