"""The checks that hold the port on the card against its plain versions and
against world 1, shared by `chip_smoke.py` (one card) and
`python -m vicasplat_tpu_torch.multichip` (several): the tolerances, with
their reasons, and the records of a train step that they compare."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# bf16 kernel output against the float32 plain version: a half ulp of bf16
# is 2^-9 relative, and P enters the second product rounded to bf16
FLASH_TOL = 2e-2
# the float32 rasterizer on the card against the CPU: exp/log1p and matmul
# sums in another order, far below one splat's 1/255 contribution
RENDER_TOL = 1e-4
# K2 stops a pixel once its transmittance is under 1e-4, its plain version
# never: what it drops is at most 1e-4 of a splat's feature
EXIT_T = 1e-4
# K3 against its float32 plain version with the same roundings, relative
# to the largest output: the two float32 sums run in other orders, so an
# output (or an element of h) near a bf16 rounding midpoint may round one
# ulp apart, at most 2^-7 = 7.8e-3 of the largest output
TAIL_TOL = 1e-2
# K1's backward against the float32 plain backward, each of dQ, dK, dV
# relative to its largest entry: at most twice SDPA's bf16 backward error
# against the same reference, plus this floor (P and dS enter the products
# rounded to bf16, 2^-9 relative)
FLASH_BWD_FLOOR = 2e-3
# K1's float32 route against the float32 plain versions, relative to each
# tensor's largest entry: the kernels take each float32 product as three
# TF32 products (within about 2^-22 of it) and sum in float32 in other
# orders over up to 2,064 keys, and their exp2 is within 2 ulp; a single
# TF32 product would miss it (tests/test_torch_flash_f32_split.py)
F32_TOL = 1e-4
# a step against the same step on another route: the loss is the same
# arithmetic (relative); the gradients' norms and each parameter group's
# norm within FLASH_BWD_FLOOR (the k1-bwd rule's floor: the render's
# backward adds by atomics, in another order each run)
STEP_TOL = 1e-6
# main.py's train mode against a reference run's logged scalars: the loss,
# its mse and camera terms and the gradient's norm before clipping
# relative, the PSNR in dB. Set against the JAX package's train loop on the
# CPU from the committed checkpoint (the same batches, frames from two
# rasterizers within 2e-4, bf16 forwards and backwards on two devices): the
# port on the CPU was 0.46 % from JAX in loss and 0.013 dB in PSNR (its
# camera loss 1.3 %), and on the H100 the largest gaps over 4 steps were
# loss 0.48 %, mse 0.16 %, camera 1.19 % and grad_norm 0.65 %, so about
# three times those
TRAIN_LOSS_TOL = {"loss": 2e-2, "mse": 5e-3, "camera": 4e-2, "grad_norm": 2e-2,
                  "psnr": 0.1}


def grad_group(name: str) -> str:
    """The parameter groups whose gradient norms are compared: each block
    stack, and each other top-level module."""
    parts = name.split(".")
    if parts[0] == "backbone" and parts[1] in ("enc_blocks", "dec_blocks"):
        return ".".join(parts[:2])
    return parts[0]


def rel(a: float, r: float) -> float:
    return abs(a - r) / abs(r) if r else abs(a)


def route_gaps(got: dict, ref: dict) -> dict:
    """Relative gaps of the loss, the gradient norm and each group's
    gradient norm; where the reference has updates, each group's update
    mass and the largest signed-sum gap relative to its mass (`got` must
    have them too). A reference of the loss alone (a forward) gives the
    loss's gap alone."""
    gaps = {"loss": rel(got["loss"], ref["loss"])}
    if "grad_norm" not in ref:
        return gaps
    gaps["grad_norm"] = rel(got["grad_norm"], ref["grad_norm"])
    gaps.update({f"norm {k}": rel(got["group_norms"][k], v)
                 for k, v in ref["group_norms"].items()})
    if "update_mass" in ref:
        gaps.update({f"mass {k}": rel(got["update_mass"][k], v)
                     for k, v in ref["update_mass"].items()})
        gaps["signed"] = max((abs(got["update_sum"][k] - v) / ref["update_mass"][k]
                              for k, v in ref["update_sum"].items()
                              if ref["update_mass"][k]), default=0.0)
    return gaps


def _local(t: torch.Tensor) -> torch.Tensor:
    from ..training.optimizer import local

    return local(t)


def host_copy(model) -> dict:
    """{name: this rank's part of the parameter, on the host}."""
    return {n: _local(p.detach()).to("cpu", copy=True)
            for n, p in model.named_parameters() if not p.is_meta}


def _split(p) -> bool:
    """A parameter of which this rank holds a part, or none: a TP or EP
    slice (a GradSplit mark), an FSDP2 shard, a pipeline stage's block."""
    return (hasattr(p, "_grad_split") or hasattr(p, "device_mesh") or p.is_meta
            or getattr(p, "_pipeline_block", False))


def step_record(model, logs, split_group=None, before: Optional[dict] = None,
                step_fn=None) -> dict:
    """A step's loss and gradient norm, each parameter group's (grad_group)
    gradient norm and parameter sum (float64), whole on every rank: the
    parts of split parameters are summed over `split_group` (by default the
    `norm` group of the GradSplit marks that parallel/tp.py or ep.py left).
    `before` ({name: host_copy}) adds each group's update mass (the sum of
    |p - before|) and signed update sum. `replica_sums` holds the unsplit
    parameters' sums alone, equal on every rank; `nonfinite`, the step's
    count of non-finite gradient entries."""
    acc = {}  # group -> [unsplit, split] x (squares, sum, mass, signed)
    dev = None
    for name, p in model.named_parameters():
        mark = getattr(p, "_grad_split", None)
        if split_group is None and mark is not None:
            split_group = mark.norm
        a = acc.setdefault(grad_group(name), [[0.0] * 4, [0.0] * 4])[int(_split(p))]
        if p.is_meta:
            continue
        w = _local(p.detach()).double()
        dev = dev or w.device
        if p.grad is not None:
            a[0] += float((_local(p.grad).double() ** 2).sum())
        a[1] += float(w.sum())
        if before is not None:
            d = w - before[name].to(w.device).double()
            a[2] += float(d.abs().sum())
            a[3] += float(d.sum())
    keys = list(acc)
    tot = torch.tensor([acc[k][1] for k in keys], dtype=torch.float64)
    if split_group is not None and dist.get_world_size(split_group) > 1:
        if dist.get_backend(split_group) != "gloo":  # NCCL: on the card
            tot = tot.to(dev)
        dist.all_reduce(tot, group=split_group)
    both = {k: [u + s for u, s in zip(acc[k][0], t)] for k, t in zip(keys, tot.tolist())}
    rec = {"loss": float(logs["loss"]), "grad_norm": float(logs["grad_norm"]),
           "group_norms": {k: math.sqrt(v[0]) for k, v in both.items()},
           "param_sums": {k: v[1] for k, v in both.items()},
           "replica_sums": {k: acc[k][0][1] for k in keys},
           "nonfinite": None if step_fn is None else int(step_fn.nonfinite)}
    if before is not None:
        rec["update_mass"] = {k: v[2] for k, v in both.items()}
        rec["update_sum"] = {k: v[3] for k, v in both.items()}
    return rec


def update_record(optimizer, before: dict, lr: Optional[float] = None) -> dict:
    """{lr multiplier: its parameters' update} of the AdamW `optimizer`'s
    last step at learning rate `lr` (by default its schedule's at that
    step) from `before` (host_copy): tensors, tensors that moved, and the
    largest |update| / (lr * multiplier) beside its bound, over this rank's
    parts. AdamW's normalized step m^/sqrt(v^) at count c is at most
    sqrt(sum_i a_i^2 / w_i) sqrt(1 - b2^c) / (1 - b1^c) an entry
    (Cauchy-Schwarz on the moments' weights a_i = (1 - b1) b1^(c-i),
    w_i = (1 - b2) b2^(c-i); 1.0004 at count 2 of betas (0.9, 0.95)),
    1 % more for a bfloat16 first moment; weight decay adds decay * |p|,
    and float32 rounding the spacing at the group's largest |p|."""
    b1, b2 = optimizer.cfg.betas
    c = optimizer.count
    lr = optimizer.schedule(c - 1) if lr is None else lr
    adam = (math.sqrt(sum(((1 - b1) * b1 ** (c - i)) ** 2 / ((1 - b2) * b2 ** (c - i))
                          for i in range(1, c + 1)))
            * math.sqrt(1 - b2 ** c) / (1 - b1 ** c))
    groups = {}
    for n, p in optimizer.params.items():
        m = optimizer.mult[n]
        old = before[n].to(p.device)
        g = groups.setdefault(m, dict(tensors=0, moved=0, ratio=0.0, p_max=0.0))
        g["tensors"] += 1
        if not old.numel():  # an empty FSDP2 shard
            continue
        step = (_local(p.detach()) - old).abs().max().item()
        g["moved"] += step > 0
        g["ratio"] = max(g["ratio"], step / (lr * m))
        g["p_max"] = max(g["p_max"], old.abs().max().item())
    for m, g in groups.items():
        g["bound"] = (1.01 * adam + optimizer.cfg.weight_decay * g["p_max"]
                      + float(np.spacing(np.float32(g["p_max"]))) / (lr * m))
    return dict(lr=lr, count=c, adam_bound=adam, groups=groups)


def update_gaps(records: list) -> list:
    """The update_records of one step (one a rank) merged: the groups whose
    largest ratio exceeds its bound on some rank, or that moved on no rank,
    or whose largest ratio over the ranks is under 0.25 (the entries whose
    two gradients share a sign take at least 0.5 of the bound)."""
    bad = []
    for m in records[0]["groups"]:
        gs = [r["groups"][m] for r in records]
        if (any(g["ratio"] > g["bound"] for g in gs) or not any(g["moved"] for g in gs)
                or max(g["ratio"] for g in gs) < 0.25):
            bad.append({m: [(round(g["ratio"], 4), round(g["bound"], 4), g["moved"])
                            for g in gs]})
    return bad


def flash_bwd_errors(got, ref, lib, what: Optional[str] = None) -> dict:
    """Each of K1's dQ, dK, dV (`got`) against the float32 plain backward
    (`ref`), relative to its largest entry, beside SDPA's bf16 backward
    (`lib`, in SDPA's (B, H, S, D) layout), and the k1-bwd rule's tolerance
    (twice SDPA's error plus FLASH_BWD_FLOOR). With `what`, raises unless
    each is within it."""
    errs = {}
    for name, a, l, r in zip(("dq", "dk", "dv"), got, lib, ref):
        scale = r.abs().max().item()
        err = (a.float() - r).abs().max().item()
        sdpa = (l.transpose(1, 2).float() - r).abs().max().item() / scale
        errs[name] = dict(abs=err, rel=err / scale, sdpa_rel=sdpa,
                          tol=2 * sdpa + FLASH_BWD_FLOOR)
    bad = [n for n, e in errs.items() if not e["rel"] <= e["tol"]]
    if what is not None and bad:
        raise AssertionError(f"{what}: {bad} exceed the noise floor: {errs}")
    return errs


def dq_same_rounding(q, k, v, o, lse, do, dq) -> dict:
    """K1's bf16 dQ (`dq`) against the same algorithm in float32: D from the
    kernel's own O (bf16) and dO, P from its lse, dS = P (dP - D) rounded to
    bf16 before its product with K, the product summed in float32. Both
    sides round dS, so what is left is an entry of dS whose float32 value
    lies on the other side of a bf16 rounding midpoint (one ulp, 2^-8 of
    it) and float32 sums in other orders, each a small part of the sum of
    |dS_ij| |K_jd| that makes dQ_id: held within FLASH_BWD_FLOOR of that
    sum's largest entry (times the softmax scale), plus dQ's own rounding
    to its dtype (half a bf16 spacing at its largest entry, up to 2^-8 of
    it: the kernel writes dQ as bf16, the reference keeps it in float32).

    The k1-bwd rule's floor is relative to dQ's largest entry instead,
    which that sum cancels down: a decoder's keys and values at random
    init share a large common component, and sum_j dS_ij = 0, so O's
    rounding in D and dS's rounding leave dQ ~0.1-0.25 of its largest
    entry from the float32 backward, SDPA's as K1's (`errors`' `sdpa_rel`).
    `cancel`: the sum's largest entry over dQ's; `out_round`: the allowance
    for dQ's rounding; `effective_rel`: the rule's tolerance relative to
    dQ's largest entry."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, dof = (x.float().transpose(1, 2) for x in (q, k, v, o, do))
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse.float()[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - (dof * of).sum(-1, keepdim=True))
    del p
    ds = ds.to(torch.bfloat16).float()
    ref = ds @ kf * scale
    terms = (scale * (ds.abs() @ kf.abs())).max().item()
    peak = ref.abs().max().item()
    err = (dq.float().transpose(1, 2) - ref).abs().max().item()
    top = max(peak, dq.abs().max().item())
    # half the spacing of dq's dtype at its largest entry: eps / 2 * 2^e
    # for top in [2^e, 2^(e+1))
    out_round = math.ldexp(torch.finfo(dq.dtype).eps / 2, math.frexp(top)[1] - 1)
    allow = FLASH_BWD_FLOOR * terms + out_round
    return dict(rel=err / peak, ratio=err / allow, effective_rel=allow / peak,
                cancel=terms / peak, out_round=out_round, ok=err <= allow)


def k1_bwd_held(q, k, v, o, lse, do, what: Optional[str] = None) -> dict:
    """K1's backward on a step's own inputs (K1's forward output `o` and
    `lse` among them): dQ, dK, dV against the float32 plain backward beside
    SDPA's (the k1-bwd rule, flash_bwd_errors), and dQ against the same
    bf16 rounding (dq_same_rounding). With `what`, raises
    unless both hold."""
    import torch.nn.functional as F

    from ..kernels.flash_attn import (
        attention_backward_reference,
        attention_lse_reference,
        attention_reference,
        flash_attention_backward,
    )

    got = flash_attention_backward(q, k, v, o, lse, do)
    xs = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    lib = torch.autograd.grad(F.scaled_dot_product_attention(*xs), xs, do.transpose(1, 2))
    ref = attention_backward_reference(q, k, v, attention_reference(q, k, v),
                                       attention_lse_reference(q, k), do)
    errs = flash_bwd_errors(got, ref, lib)
    del ref, lib, xs
    same = dq_same_rounding(q, k, v, o, lse, do, got[0])
    ok = same["ok"] and all(e["rel"] <= e["tol"] for e in errs.values())
    if what is not None and not ok:
        raise AssertionError(f"{what}: the k1-bwd rule {errs}, dQ against its own "
                             f"rounding {same}")
    return dict(shape=f"q {tuple(q.shape)}, k/v {tuple(k.shape)} {str(q.dtype)[6:]}",
                errors=errs, dq_same_rounding=same, ok=ok)
