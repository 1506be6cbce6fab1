"""How well posed the flagship's training step is at its random init, in
float32, and how far the world-2 training routes land from world 1 there:

    python -m vicasplat_tpu_torch.diagnostics.route_posedness [--out FILE]

On one card. The flagship's step of training/presets.flagship_train_config
(remat "dots", dtype float32, a linear warm-up so that the first step
updates) from seed 0 on flagship_train_batch(1, 4): batch 1 x (8 + 4).
Writes one JSON object (default chiprun_out/route_posedness.json):
- clean: the loss, gradient norm and each group's gradient norm (groups:
  backbone, backbone.enc_blocks, backbone.dec_blocks and each head);
- jitter: the relative gaps of those when every weight and context pixel is
  scaled by 1 +- eps (eps 1e-7, 1e-6, 1e-5; signs drawn from seeds 5, 6);
- plain_attention: the gaps when the decoder's attention is the plain
  float32 one in place of K1's 3xTF32 float32 route;
- bf16: the same step in bf16 (K1's bf16 kernels), and the gaps when the
  decoder's attention is SDPA (models/layers.sdpa) in place of K1;
- behind: the share of the Gaussians behind the target cameras (z < near);
- world2: one step of SP (1 x 2), TP (1 x 2) and, for the MoE flagship
  (8 experts, top-2) at batch 2 x (8 + 4), EP (1 x 2), by two processes
  on the card over gloo, against the same step at world 1: the gaps of the
  loss, the gradient norms and each group's update mass.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import gc
import json
import math
import os
import pathlib
import subprocess
import sys

import torch

JITTER = (1e-7, 1e-6, 1e-5)


def _cfg(moe: bool):
    from ..models import GaussianAdapterConfig, VicaNetConfig, VicaSplatConfig
    from ..training.presets import flagship_train_config

    base = flagship_train_config()
    model = base.model
    if moe:
        model = VicaSplatConfig(
            backbone=VicaNetConfig(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25),
            gaussian_adapter=GaussianAdapterConfig(sh_degree=4),
            pts3d_bounds=base.model.pts3d_bounds)
    return dataclasses.replace(base, model=model, dtype="float32", optimizer=dataclasses.replace(
        base.optimizer, cosine_annealing=False))


def _group(name: str) -> str:
    parts = name.split(".")
    if parts[0] == "backbone" and parts[1] in ("enc_blocks", "dec_blocks"):
        return ".".join(parts[:2])
    return parts[0]


def _norms(model) -> dict:
    """Each group's squared gradient norm and update mass, the parameters
    that parallel/tp.py or ep.py sliced summed over their mark's group."""
    import torch.distributed as dist

    from ..training.optimizer import local

    acc, group = {}, None
    for name, p in model.named_parameters():
        mark = getattr(p, "_grad_split", None)
        group = mark.norm if mark is not None else group
        a = acc.setdefault(_group(name), [[0.0, 0.0], [0.0, 0.0]])[mark is not None]
        if p.grad is not None:
            a[0] += float((local(p.grad).double() ** 2).sum())
        a[1] += float((local(p.detach()).double() - p._before).abs().sum())
    keys = list(acc)
    split = torch.tensor([acc[k][1] for k in keys], dtype=torch.float64)
    if group is not None:
        dist.all_reduce(split, group=group)
    return {k: [acc[k][0][0] + s[0], acc[k][0][1] + s[1]]
            for k, s in zip(keys, split.tolist())}


def _step(route: str, dev, world2: bool) -> dict:
    """One step of the route's model from seed 0: loss, gradient norm,
    {group: [squared gradient norm, update mass]}."""
    from .. import parallel as par
    from ..models import init_vicasplat
    from ..training import AdamW, make_train_step
    from ..training.presets import flagship_train_batch

    cfg = _cfg(route == "ep")
    model = init_vicasplat(cfg.model, torch.Generator(device=dev).manual_seed(0), dev)
    batch = flagship_train_batch(dev, 2 if route == "ep" else 1, 4)
    kw = {}
    if world2:
        if route == "sp":
            mesh = kw["sp_mesh"] = par.make_mesh_sp(1, 2)
        elif route == "tp":
            mesh = par.make_mesh_2d(1, 2)
            par.shard_params_tp(mesh, model)
        else:
            mesh = par.make_mesh_ep(1, 2)
            par.shard_params_ep(mesh, model)
        batch = par.shard_batch(mesh, batch, ("data", "expert") if route == "ep" else "data")
    for p in model.parameters():
        p._before = p.detach().double().clone()
    logs = make_train_step(cfg, model, AdamW(model, cfg.optimizer), **kw)(batch, 0)
    out = {"loss": float(logs["loss"]), "grad_norm": float(logs["grad_norm"]),
           "groups": _norms(model)}
    for p in model.parameters():
        del p._before
    return out


def _gaps(got: dict, ref: dict) -> dict:
    def rel(a, r):
        return abs(a - r) / abs(r) if r else abs(a)

    return {"loss": rel(got["loss"], ref["loss"]),
            "grad_norm": rel(got["grad_norm"], ref["grad_norm"]),
            **{f"norm {k}": rel(math.sqrt(got["groups"][k][0]), math.sqrt(v[0]))
               for k, v in ref["groups"].items()},
            **{f"mass {k}": rel(got["groups"][k][1], v[1]) for k, v in ref["groups"].items()}}


def _pass(model, cfg, batch, eps=0.0, seed=0) -> dict:
    """Loss, gradient norm and each group's squared gradient norm of one
    gradient pass, with weights and context images scaled by 1 +- eps."""
    from ..training import compute_loss

    params = dict(model.named_parameters())
    saved = {n: p.detach().clone() for n, p in params.items()} if eps else None
    ctx = batch["context"]
    if eps:
        g = torch.Generator(device=ctx["image"].device).manual_seed(seed)

        def jitter(x):
            flip = torch.rand(x.shape, generator=g, device=x.device) < 0.5
            return x * torch.where(flip, 1 - eps, 1 + eps)

        with torch.no_grad():
            for p in params.values():
                p.copy_(jitter(p))
        batch = dict(batch, context=dict(ctx, image=jitter(ctx["image"])))
    loss, _ = compute_loss(model, cfg, batch, 0)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    groups = {}
    for n, gr in zip(params, grads):
        sq = 0.0 if gr is None else float((gr.double() ** 2).sum())
        groups.setdefault(_group(n), [0.0, 0.0])[0] += sq
    if saved:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(saved[n])
    return {"loss": float(loss.detach()), "grad_norm": math.sqrt(sum(v[0] for v in groups.values())),
            "groups": groups}


def world1(dev) -> dict:
    from ..kernels.flash_attn import attention_reference
    from ..models import init_vicasplat, vicanet, vicasplat_forward
    from ..models.layers import sdpa
    from ..training.presets import flagship_train_batch

    cfg = _cfg(False)
    model = init_vicasplat(cfg.model, torch.Generator(device=dev).manual_seed(0), dev)
    batch = flagship_train_batch(dev, 1, 4)
    clean = _pass(model, cfg, batch)
    out = {"clean": {"loss": clean["loss"], "grad_norm": clean["grad_norm"],
                     "group_norms": {k: math.sqrt(v[0]) for k, v in clean["groups"].items()}},
           "jitter": {}}
    for eps in JITTER:
        out["jitter"][str(eps)] = [
            {k: v for k, v in _gaps(_pass(model, cfg, batch, eps, s), clean).items()
             if not k.startswith("mass")} for s in (5, 6)]
    def norms(r):
        return {k: v for k, v in r.items() if not k.startswith("mass")}

    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    k1 = _pass(model, cfg16, batch)
    out["bf16"] = {"grad_norm": k1["grad_norm"]}
    orig = vicanet.flash_attention
    try:
        vicanet.flash_attention = lambda q, k, v: attention_reference(q, k, v).to(q.dtype)
        out["plain_attention"] = norms(_gaps(_pass(model, cfg, batch), clean))
        vicanet.flash_attention = sdpa
        sd = _pass(model, cfg16, batch)
        out["bf16"].update(sdpa_grad_norm=sd["grad_norm"], sdpa=norms(_gaps(sd, k1)))
    finally:
        vicanet.flash_attention = orig
    ctx, tgt = batch["context"], batch["target"]
    with torch.no_grad():
        g = vicasplat_forward(model, dict(ctx, image=ctx["image"] * 2 - 1), 0,
                              dtype=torch.float32)["gaussians"]
    means = g.means.reshape(-1, 3).double()
    w2c = torch.linalg.inv(tgt["extrinsics"][0].double())
    z = (means @ w2c[:, :3, :3].transpose(-1, -2) + w2c[:, None, :3, 3])[..., 2]
    out["behind"] = float((z < tgt["near"][0, :, None].double()).double().mean())
    return out


def child(rank: int, root: str):
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"), 2),
                            rank=rank, world_size=2, timeout=datetime.timedelta(seconds=300))
    try:
        out = {}
        for route in ("sp", "tp", "ep"):
            out[route] = _step(route, dev, True)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    pathlib.Path(root, f"rank{rank}.json").write_text(json.dumps(out))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/route_posedness.json")
    ap.add_argument("--child", nargs=2)
    a = ap.parse_args(argv)
    if a.child:
        return child(int(a.child[0]), a.child[1])
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = world1(dev)
    refs = {"flagship": _step("tp", dev, False), "moe": _step("ep", dev, False)}
    gc.collect()  # the steps' closures hold their models in cycles
    torch.cuda.empty_cache()
    root = pathlib.Path("build", "route_posedness")
    root.mkdir(parents=True, exist_ok=True)
    for f in root.iterdir():
        f.unlink()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, "--child", str(r),
                               str(root)], env=env) for r in range(2)]
    if any(p.wait(timeout=900) for p in procs):
        raise SystemExit(f"a rank failed: {[p.returncode for p in procs]}")
    got = json.loads((root / "rank0.json").read_text())
    out["world2"] = {r: _gaps(got[r], refs["moe" if r == "ep" else "flagship"])
                     for r in ("sp", "tp", "ep")}
    pathlib.Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(a.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
