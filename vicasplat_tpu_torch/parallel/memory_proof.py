"""Per-rank memory of the flagship train step's state under multi-device
layouts (port of vicasplat_tpu/parallel/memory_proof.py).

JAX lowers the whole flagship step on a virtual mesh and reads XLA's buffer
assignment. Here the state is reckoned on the meta device, with nothing
materialised: per rank, the bytes of the parameters, their gradients and
AdamW's two moments (the first in OptimizerConfig.moment_dtype) under
- dp8: 8-way data parallelism (DDP), everything replicated;
- fsdp8: the same with FSDP2 (`mesh.shard_params_fsdp`'s rule): each leaf
  of at least 2**16 entries split 8 ways along a dimension 8 divides;
- pp4xdp2: 4 pipeline stages x 2-way data: the encoder and decoder blocks
  split 4 ways (`pp.shard_params_pp`), the rest replicated;
- dp4, fsdp4, pp4: the same on the four cards of one host (the layouts of
  `python -m vicasplat_tpu_torch.multichip`). Any dp<N>, fsdp<N> or
  pp<S>[xdp<D>] is reckoned.
Activations are not reckoned: they depend on the schedule. On a card,
`measure_step_peak` runs the world-1 flagship step and reads
`torch.cuda.max_memory_allocated`, which holds state and activations, to
set beside the reckoning; `device_bytes` is the card's own memory.

Run: python -m vicasplat_tpu_torch.parallel.memory_proof [--measure]
Writes outputs/multichip_memory_torch/flagship_memory.json.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import time
from typing import Optional

import torch

OUT_PATH = "outputs/multichip_memory_torch/flagship_memory.json"
BLOCK_STACKS = ("enc_blocks", "dec_blocks")
CONFIGS = ("dp8", "fsdp8", "pp4xdp2", "dp4", "fsdp4", "pp4")


def flagship_train_config(moe_experts: int = 0):
    """The production re10k_8view recipe: ViT-L/16 encoder 24 x 1024,
    decoder 12 x 768, SH degree 4, bf16, remat "dots"."""
    from ..models import GaussianAdapterConfig, VicaNetConfig, VicaSplatConfig
    from ..training import TrainConfig

    return TrainConfig(
        model=VicaSplatConfig(
            backbone=VicaNetConfig(moe_experts=moe_experts, moe_top_k=2),
            gaussian_adapter=GaussianAdapterConfig(sh_degree=4)),
        dtype="bfloat16", remat=True, remat_policy="dots")


def device_bytes() -> Optional[int]:
    """The card's memory, or None without one."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(0).total_memory)


def reckon(cfg=None, configs=CONFIGS) -> dict:
    """Per-rank bytes of parameters, gradients and AdamW moments."""
    from ..models.vicasplat import VicaSplat
    from .mesh import fsdp_placement

    cfg = cfg or flagship_train_config()
    with torch.device("meta"):
        model = VicaSplat(cfg.model)
    mu_bytes = 2 if cfg.optimizer.moment_dtype == "bfloat16" else 4
    leaves = [(name, tuple(p.shape), p.numel()) for name, p in
              model.named_parameters()]
    n_params = sum(n for _, _, n in leaves)
    rows = {}
    for name in configs:
        m = re.fullmatch(r"(dp|fsdp)(\d+)|pp(\d+)(?:xdp(\d+))?", name)
        if m is None:
            raise ValueError(name)
        if m.group(1) == "dp":
            share = {leaf: 1.0 for leaf, _, _ in leaves}
            mesh = {"data": int(m.group(2))}
        elif m.group(1) == "fsdp":
            n = int(m.group(2))
            share = {leaf: 1.0 if fsdp_placement(shape, n) is None else 1 / n
                     for leaf, shape, _ in leaves}
            mesh = {"data": n}
        else:
            S = int(m.group(3))
            share = {leaf: 1 / S if leaf.split(".")[1] in BLOCK_STACKS else 1.0
                     for leaf, _, _ in leaves}
            mesh = {"pipe": S, "data": int(m.group(4) or 1)}
        elems = sum(n * share[leaf] for leaf, _, n in leaves)
        row = {"mesh": mesh,
               "param_bytes": int(elems * 4),
               "grad_bytes": int(elems * 4),
               "adam_bytes": int(elems * (mu_bytes + 4))}
        row["state_bytes"] = row["param_bytes"] + row["grad_bytes"] + row["adam_bytes"]
        row["state_gib"] = row["state_bytes"] / 1024**3
        rows[name] = row
    return {"params_m": n_params / 1e6, "configs": rows}


def measure_step_peak(device="cuda", batch: int = 1, n_ctx: int = 8,
                      n_tgt: int = 4, size: int = 256, steps: int = 2,
                      moe_experts: int = 0) -> dict:
    """The world-1 flagship train step on the card: peak allocated bytes
    over `steps` steps of `batch` examples (8 context, 4 target views at
    256², dp8's per-device batch of 1), from seeded random weights."""
    from ..models.vicasplat import init_vicasplat
    from ..training import AdamW, make_train_step

    cfg = flagship_train_config(moe_experts)
    gen = torch.Generator(device).manual_seed(0)
    model = init_vicasplat(cfg.model, gen, device)
    opt = AdamW(model, cfg.optimizer)
    step = make_train_step(cfg, model, opt)
    g = torch.Generator(device).manual_seed(1)

    def views(n):
        K = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], device=device)
        ext = torch.eye(4, device=device).repeat(batch, n, 1, 1)
        ext[..., 2, 3] = -2.0
        return {"image": torch.rand(batch, n, size, size, 3, generator=g,
                                    device=device),
                "intrinsics": K.expand(batch, n, 3, 3).contiguous(),
                "extrinsics": ext,
                "near": torch.full((batch, n), 0.5, device=device),
                "far": torch.full((batch, n), 100.0, device=device)}

    batch_t = {"context": views(n_ctx), "target": views(n_tgt)}
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        logs = step(batch_t, i)
        float(logs["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    peak = int(torch.cuda.max_memory_allocated(device))
    del model, opt, step
    torch.cuda.empty_cache()
    return {"batch": batch, "ctx": n_ctx, "tgt": n_tgt, "image": size,
            "peak_bytes": peak, "peak_gib": peak / 1024**3, "step_ms": times}


def flagship_memory_proof(out_path: str = OUT_PATH, measured: Optional[dict] = None,
                          configs=CONFIGS) -> dict:
    report = reckon(configs=configs)
    report["device_bytes"] = device_bytes()
    report["note"] = ("state bytes per rank reckoned on the meta device "
                      "(parameters, gradients, AdamW moments; no "
                      "activations); measured_world1 is the card's peak "
                      "allocation of the world-1 step")
    if measured is not None:
        report["measured_world1"] = measured
    for name, row in report["configs"].items():
        print(f"memory_proof {name}: mesh={row['mesh']} state "
              f"{row['state_gib']:.2f} GiB a rank", flush=True)
    out = pathlib.Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(f"wrote {out}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--measure", action="store_true",
                    help="also run the world-1 step on the card for its peak")
    ap.add_argument("--out", default=OUT_PATH)
    args = ap.parse_args(argv)
    flagship_memory_proof(args.out, measure_step_peak() if args.measure else None)


if __name__ == "__main__":
    main()
