"""K1 along a training trajectory: does the kernel stay right on the inputs
that training gives it, and where do the trajectories of K1, SDPA and plain
attention part?

    python -m vicasplat_tpu_torch.diagnostics.k1_trajectory \
        [--steps 7] [--batch 2] [--targets 12] [--init-batches 8] \
        [--out k1_trajectory.json]

The flagship training step (training/presets.py) from the same seeded
weights and batch, once with each decoder attention: K1 ("k1"), SDPA's bf16
math ("sdpa", models/layers.py) and the float32 plain version cast to bf16
("plain"). Every step records the loss, the gradient norm before clipping
and the non-finite gradient entries the step's NaN guard zeroed.

On the K1 trajectory, before each step, one gradient pass of the whole loss
with each attention on the weights the step starts from (gradient norm by
parameter group, non-finite entries).
Every backward call of K1 is checked after its step,
on the inputs it got (q, k, v, and the o, lse and dO of the remat forward):
- K1's forward rerun on q, k, v must give the same o and lse bit for bit
  (the kernels are deterministic), and so must its backward rerun;
- o and lse against the float32 plain versions, beside SDPA's forward;
- dQ, dK, dV against the float32 plain backward, beside SDPA's backward,
  as chip_smoke.py's k1-bwd rule: each within 2 x SDPA's error plus
  FLASH_BWD_FLOOR, relative to the largest entry;
- non-finite entries in every input and output.

At the end of the K1 and the SDPA trajectories, and at the initial weights
on each of --init-batches batches, one gradient pass of the whole loss with
each attention: the gradient norm of each parameter group and its
non-finite entries. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from unittest import mock

import torch
import torch.nn.functional as F

FLASH_BWD_FLOOR = 2e-3  # as chip_smoke.py's k1-bwd rule


def _rel(a, ref):
    """max |a - ref| over max |ref|; 0 where both are all zero (a block
    whose output reaches no loss term gets dO = 0)."""
    err, scale = (a.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()
    return err / scale if scale else (0.0 if err == 0 else math.inf)


def _same(a, b):
    """Equal bit for bit, NaN where the other has NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _nonfinite(*xs):
    return sum(int((~torch.isfinite(x)).sum()) for x in xs)


def check_call(q, k, v, o, lse, do, grads):
    """One K1 backward call's record: `grads` is what the call returned."""
    from ..kernels.flash_attn import (
        _forward,
        attention_backward_reference,
        attention_lse_reference,
        attention_reference,
        flash_attention_backward,
    )

    o2, lse2 = _forward(q, k, v, with_lse=True)
    again = flash_attention_backward(q, k, v, o, lse, do)
    o_ref, lse_ref = attention_reference(q, k, v), attention_lse_reference(q, k)
    xs = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*xs)
    lib = torch.autograd.grad(o_lib, xs, do.transpose(1, 2))
    ref = attention_backward_reference(q, k, v, o_ref, lse_ref, do)
    r = dict(
        nonfinite_inputs=_nonfinite(q, k, v, do),
        nonfinite_outputs=_nonfinite(o, lse, *grads),
        same_forward=_same(o2, o) and _same(lse2, lse),
        same_backward=all(_same(a, b) for a, b in zip(again, grads)),
        q_absmax=q.float().abs().max().item(), k_absmax=k.float().abs().max().item(),
        do_absmax=do.float().abs().max().item(),
        logit_max=(lse_ref.max().item()),
        o_rel=_rel(o, o_ref), o_sdpa_rel=_rel(o_lib.transpose(1, 2), o_ref),
        lse_abs=(lse - lse_ref).abs().max().item())
    ratio = 0.0
    for name, a, lb, rf in zip(("dq", "dk", "dv"), grads, lib, ref):
        e, es = _rel(a, rf), _rel(lb.transpose(1, 2), rf)
        r[name] = dict(rel=e, sdpa_rel=es)
        ratio = max(ratio, e / (2 * es + FLASH_BWD_FLOOR) if math.isfinite(e)
                    else math.inf)
    r["ratio"] = ratio  # above 1: outside the k1-bwd rule
    return r


def grad_group(name):
    parts = name.split(".")
    if parts[0] == "backbone" and parts[1] in ("enc_blocks", "dec_blocks"):
        return ".".join(parts[:2])
    return parts[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=7)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--targets", type=int, default=12)
    p.add_argument("--init-batches", type=int, default=8)
    p.add_argument("--out", default="k1_trajectory.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_trajectory: needs a CUDA card", file=sys.stderr)
        return 1

    from ..kernels import flash_attn
    from ..kernels.flash_attn import attention_reference, flash_attention_backward
    from ..models import init_vicasplat, vicanet
    from ..models.layers import sdpa
    from ..training import AdamW, compute_loss, make_train_step
    from ..training.presets import flagship_train_batch, flagship_train_config

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    cfg = flagship_train_config()
    batch = flagship_train_batch(dev, args.batch, args.targets)
    attends = {"k1": vicanet.flash_attention, "sdpa": sdpa,
               "plain": lambda q, k, v: attention_reference(q, k, v).to(q.dtype)}

    def log(msg):
        print(f"[{time.perf_counter() - t_start:7.1f} s] {msg}", flush=True)

    def grad_pass(model, attend, step_no, batch=batch):
        with mock.patch.object(vicanet, "flash_attention", attend):
            loss, _ = compute_loss(model, cfg, batch, step_no)
            grads = torch.autograd.grad(loss, list(model.parameters()),
                                        allow_unused=True)
        norms, bad = {}, {}
        for (name, _), g in zip(model.named_parameters(), grads):
            key = grad_group(name)
            if g is not None:
                finite = torch.isfinite(g)
                bad[key] = bad.get(key, 0) + int((~finite).sum())
                norms[key] = norms.get(key, 0.0) + float(
                    (torch.where(finite, g, 0).float() ** 2).sum())
        return dict(loss=float(loss.detach()), norms={k: math.sqrt(v) for k, v in norms.items()},
                    nonfinite=bad)

    record = dict(device=torch.cuda.get_device_name(0), steps=args.steps,
                  batch=args.batch, targets=args.targets, trajectories={},
                  same_weights={})
    for which in ("k1", "sdpa", "plain"):
        model = init_vicasplat(cfg.model, torch.Generator(device=dev).manual_seed(0), dev)
        step = make_train_step(cfg, model, AdamW(model, cfg.optimizer))
        rows = []
        for i in range(args.steps):
            calls = []
            # on K1's trajectory: the other attentions' gradient at the
            # weights this step starts from
            others = ({a: grad_pass(model, attends[a], i) for a in attends}
                      if which == "k1" else {})

            def spy(ctx, do):
                q, k, v, o, lse = ctx.saved_tensors
                do = do.to(q.dtype).contiguous()
                grads = flash_attention_backward(q, k, v, o, lse, do)
                calls.append([x.detach().clone() for x in (q, k, v, o, lse, do, *grads)])
                return grads

            with mock.patch.object(vicanet, "flash_attention", attends[which]), \
                    mock.patch.object(flash_attn._FlashAttention, "backward",
                                      staticmethod(spy)):
                logs = step(batch, i)
            row = dict(step=i, nonfinite=int(step.nonfinite),
                       **{k: float(v) for k, v in logs.items()})
            for a, r in others.items():
                row[f"{a}_here"] = dict(
                    r, nonfinite_total=sum(r["nonfinite"].values()),
                    grad_norm=math.sqrt(sum(x * x for x in r["norms"].values())))
            if calls:
                # the backward runs the blocks in reverse: call 0 is block 12
                checks = [check_call(*c[:6], c[6:]) for c in calls]
                n = len(checks)
                row["k1_calls"] = n
                row["k1_worst"] = max(
                    ({"block": n - j, **c} for j, c in enumerate(checks)),
                    key=lambda c: c["ratio"])
                row["k1_nonfinite_inputs"] = [c["nonfinite_inputs"] for c in checks]
                row["k1_nonfinite_outputs"] = [c["nonfinite_outputs"] for c in checks]
                row["k1_deterministic"] = all(c["same_forward"] and c["same_backward"]
                                              for c in checks)
            del calls
            rows.append(row)
            w = row.get("k1_worst")
            log(f"{which} step {i}: loss {row['loss']:.5f} grad_norm "
                f"{row['grad_norm']:.4g} nonfinite {row['nonfinite']}"
                + "".join(f"; {a} here: loss {row[a + '_here']['loss']:.5f} grad_norm "
                          f"{row[a + '_here']['grad_norm']:.4g} nonfinite "
                          f"{row[a + '_here']['nonfinite_total']}" for a in others)
                + ("" if w is None else
                   f"; K1 calls {row['k1_calls']}, deterministic "
                   f"{row['k1_deterministic']}, nonfinite in/out "
                   f"{sum(row['k1_nonfinite_inputs'])}/{sum(row['k1_nonfinite_outputs'])}, "
                   f"worst block {w['block']}: ratio {w['ratio']:.3f} (dq "
                   f"{w['dq']['rel']:.2e}/sdpa {w['dq']['sdpa_rel']:.2e}, dk "
                   f"{w['dk']['rel']:.2e}/{w['dk']['sdpa_rel']:.2e}, dv "
                   f"{w['dv']['rel']:.2e}/{w['dv']['sdpa_rel']:.2e}; o "
                   f"{w['o_rel']:.2e}/{w['o_sdpa_rel']:.2e}; lse "
                   f"{w['lse_abs']:.1e}; |q| {w['q_absmax']:.3g} |k| "
                   f"{w['k_absmax']:.3g} max lse {w['logit_max']:.3g})"))
            if others:
                pl = others["plain"]["norms"]

                def gap(a, g):
                    x, r = others[a]["norms"][g], pl[g]
                    return abs(x - r) / r if r else (0.0 if x == r else math.inf)

                log(f"  gradient norm gaps to plain at these weights, k1 / sdpa: "
                    + ", ".join(f"{g} {gap('k1', g):.2e} / {gap('sdpa', g):.2e}"
                                for g in pl))
        record["trajectories"][which] = rows
        if which in ("k1", "sdpa"):
            same = {a: grad_pass(model, attends[a], args.steps) for a in attends}
            record["same_weights"][which] = same
            for a, r in same.items():
                log(f"at {which}'s weights after {args.steps} steps, {a}: loss "
                    f"{r['loss']:.5f}; " + ", ".join(
                        f"{g} {r['norms'][g]:.4g} ({r['nonfinite'][g]} nonfinite)"
                        for g in r["norms"]))
        del model, step
        torch.cuda.empty_cache()
    # the initial weights, one gradient pass with each attention on each of
    # several batches (batch seeds 0..N-1; the trajectories' batch is seed 3)
    model = init_vicasplat(cfg.model, torch.Generator(device=dev).manual_seed(0), dev)
    record["initial_weights"] = []
    for seed in range(args.init_batches):
        b = flagship_train_batch(dev, args.batch, args.targets, seed=seed)
        r = {a: grad_pass(model, attends[a], 0, b) for a in attends}
        pl = r["plain"]["norms"]
        gaps = {a: {g: abs(r[a]["norms"][g] - pl[g]) / pl[g] if pl[g] else 0.0
                    for g in pl} for a in ("k1", "sdpa")}
        record["initial_weights"].append(dict(seed=seed, passes=r, gaps=gaps))
        log(f"initial weights, batch seed {seed}: gaps to plain, k1 / sdpa: "
            + ", ".join(f"{g} {gaps['k1'][g]:.2e} / {gaps['sdpa'][g]:.2e}" for g in pl)
            + "; nonfinite " + ", ".join(
                f"{a} {sum(r[a]['nonfinite'].values())}" for a in attends))
    del model
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
