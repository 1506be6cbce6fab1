"""Where does the flagship step's gradient first turn non-finite?

    python -m vicasplat_tpu_torch.diagnostics.c1_locate \
        [--batches 2,1] [--targets 12] [--max-steps 9] [--out c1_locate.json]

For each batch size in turn, the flagship training step (training/presets.py,
K1 in the decoder) from the seeded weights, until the step whose NaN guard
zeroes an entry. The weights that step started from are kept on the host;
on them, one gradient pass of the same loss with hooks:
- every module's forward output, in execution order: the first module whose
  output holds a non-finite entry;
- the gradient of every module's output and of the tensors between the
  model and the losses (the Gaussians' fields, the predicted poses, the
  rendered colour, each loss term), in the order the backward reaches them:
  the first whose gradient holds a non-finite entry;
- the same pass under torch.autograd.detect_anomaly: the first backward
  operation that returns NaN, with the forward stack that made it.
Then the smallest batch size that still gives a non-finite step. With
--save, the projection inputs of every Gaussian whose mean gets a
non-finite gradient (its mean, packed covariance, harmonics and opacity,
and each target view's w2c matrix and intrinsics) go to an npz, small
enough to leave the card, which tools/jax_c1_reference.py puts through the
JAX package's projection. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import warnings
from unittest import mock

import torch


def _bad(x) -> int:
    return int((~torch.isfinite(x)).sum()) if torch.is_tensor(x) and \
        x.is_floating_point() else 0


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def hooked_pass(model, cfg, batch, step_no, save=None):
    """One gradient pass with forward and gradient hooks (see the module's
    docstring)."""
    import importlib

    from ..training import step as step_mod

    render_mod = importlib.import_module("vicasplat_tpu_torch.ops.rasterize.render")
    views, means_grad = [], {}

    forward, backward, handles = [], [], []

    def watch(name, t):
        if t.requires_grad:
            t.register_hook(lambda g: backward.append((name, _bad(g), tuple(g.shape),
                                                       float(g.float().nan_to_num(
                                                           0, 0, 0).abs().max()))))

    def fwd_hook(name):
        def hook(mod, args, out):
            if not torch.is_grad_enabled():
                return  # a remat recompute inside the backward
            n = sum(_bad(t) for t in _tensors(out))
            forward.append((name, n))
            for i, t in enumerate(_tensors(out)):
                watch(f"{name}[{i}]", t)
        return hook

    for name, mod in model.named_modules():
        if name:
            handles.append(mod.register_forward_hook(fwd_hook(name)))
    decoder_forward, camera_loss, mse_loss = (step_mod.decoder_forward,
                                             step_mod.camera_loss, step_mod.mse_loss)

    def dec(cfg_, g, *a, **kw):
        for f in g._fields:
            watch(f"gaussians.{f}", getattr(g, f))
        g.means.register_hook(lambda gr: means_grad.setdefault("g", gr.detach()))
        r = decoder_forward(cfg_, g, *a, **kw)
        watch("rendered.color", r.color)
        return r

    def cam(pred, *a, **kw):
        watch("pred_extrins", pred)
        out = camera_loss(pred, *a, **kw)
        watch("loss.camera", out)
        return out

    def mse(*a, **kw):
        out = mse_loss(*a, **kw)
        watch("loss.mse", out)
        return out

    render_view = render_mod.render_view

    def rv(*args, **kw):  # every view's projection inputs, kept by reference
        views.append((args, kw))
        return render_view(*args, **kw)

    params = list(model.parameters())
    try:
        with mock.patch.object(render_mod, "render_view", rv), \
                mock.patch.object(step_mod, "decoder_forward", dec), \
                mock.patch.object(step_mod, "camera_loss", cam), \
                mock.patch.object(step_mod, "mse_loss", mse):
            loss, logs = step_mod.compute_loss(model, cfg, batch, step_no)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    bad_params = {n: _bad(g) for (n, _), g in zip(model.named_parameters(), grads)
                  if g is not None and _bad(g)}
    del grads
    saved = _save_bad(views, means_grad.get("g"), save) if save else None
    del views, means_grad
    first_fwd = next(((n, k) for n, k in forward if k), None)
    first_bwd = next((r for r in backward if r[1]), None)
    # the last gradients before the first non-finite one, in backward order
    i = backward.index(first_bwd) if first_bwd else len(backward)
    # the same pass under anomaly mode: the first backward op returning NaN
    anomaly = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            with torch.autograd.detect_anomaly(check_nan=True):
                loss2, _ = step_mod.compute_loss(model, cfg, batch, step_no)
                torch.autograd.grad(loss2, params, allow_unused=True)
        except RuntimeError as e:
            anomaly = dict(error=str(e).splitlines()[0], forward_stack=[
                str(w.message) for w in caught
                if "Traceback of forward call" in str(w.message)][-1:])
    return dict(loss=float(loss.detach()), logs={k: float(v) for k, v in logs.items()},
                first_nonfinite_forward=first_fwd,
                first_nonfinite_gradient=first_bwd,
                gradients_before=backward[max(0, i - 8):i],
                gradients_after=backward[i:i + 8],
                nonfinite_param_grads=dict(sorted(bad_params.items(),
                                                  key=lambda kv: -kv[1])[:20]),
                n_nonfinite=sum(bad_params.values()), anomaly=anomaly, saved=saved)


@torch.no_grad()
def _save_bad(views, grad, path):
    """Write the projection inputs of the Gaussians whose mean's gradient
    is non-finite (see --save); returns a summary of them."""
    import numpy as np

    from ..ops.rasterize.projection import project_gaussians

    B, n_views = grad.shape[0], len(views) // grad.shape[0]
    grad = grad.reshape(B, -1, 3)
    out, summary = {}, []
    for b in range(B):
        idx = (~torch.isfinite(grad[b])).any(-1).nonzero()[:, 0]
        args, kw = views[b * n_views]
        means, cov6, harmonics, opacities = (x[idx] for x in args[:4])
        vm = torch.stack([views[b * n_views + v][0][4] for v in range(n_views)])
        K = torch.stack([views[b * n_views + v][0][5] for v in range(n_views)])
        kept = torch.stack([project_gaussians(means, cov6, harmonics, opacities, vm[v],
                                              K[v], args[6], args[8]).radius > 0
                            for v in range(n_views)])
        for k, x in dict(index=idx, means=means, cov6=cov6, harmonics=harmonics,
                         opacities=opacities, viewmats=vm, intrinsics=K).items():
            out[f"b{b}_{k}"] = x.float().cpu().numpy() if k != "index" else \
                x.cpu().numpy()
        summary.append(dict(
            batch_item=b, n=int(idx.numel()), kept_in_any_view=int(kept.any(0).sum()),
            means_absmax=float(means.abs().max()) if idx.numel() else None,
            means_abs_min_of_max=float(means.abs().amax(-1).min()) if idx.numel() else None))
    out["image_shape"] = np.asarray(views[0][0][6])
    out["sh_degree"] = np.asarray(views[0][0][8])
    out["near"] = np.asarray(views[0][1].get("near", 0.2))
    np.savez(path, **out)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", default="2,1")
    p.add_argument("--targets", type=int, default=12)
    p.add_argument("--max-steps", type=int, default=9)
    p.add_argument("--out", default="c1_locate.json")
    p.add_argument("--save", default=None,
                   help="npz of the projection inputs of the Gaussians whose "
                        "mean gets a non-finite gradient")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("c1_locate: needs a CUDA card", file=sys.stderr)
        return 1
    from ..models import init_vicasplat
    from ..training import AdamW, make_train_step
    from ..training.presets import flagship_train_batch, flagship_train_config

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    cfg = flagship_train_config()

    def log(msg):
        print(f"[{time.perf_counter() - t0:7.1f} s] {msg}", flush=True)

    record = dict(device=torch.cuda.get_device_name(0), targets=args.targets, runs=[])
    for B in (int(b) for b in args.batches.split(",")):
        model = init_vicasplat(cfg.model, torch.Generator(device=dev).manual_seed(0), dev)
        step = make_train_step(cfg, model, AdamW(model, cfg.optimizer))
        batch = flagship_train_batch(dev, B, args.targets)
        run = dict(batch=B, steps=[], first_nonfinite_step=None)
        for i in range(args.max_steps):
            kept = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
            logs = step(batch, i)
            n = int(step.nonfinite)
            run["steps"].append(dict(step=i, nonfinite=n,
                                     **{k: float(v) for k, v in logs.items()}))
            log(f"batch {B} step {i}: loss {float(logs['loss']):.5f} grad_norm "
                f"{float(logs['grad_norm']):.4g} nonfinite {n}")
            if n:
                run["first_nonfinite_step"] = i
                with torch.no_grad():
                    for nm, prm in model.named_parameters():
                        prm.copy_(kept[nm])
                del kept
                try:
                    run["hooked"] = hooked_pass(model, cfg, batch, i, args.save)
                except Exception:
                    run["hooked"] = dict(error=traceback.format_exc())
                h = run["hooked"]
                log(f"batch {B} step {i} hooked: " + json.dumps(
                    {k: h.get(k) for k in ("first_nonfinite_forward",
                                            "first_nonfinite_gradient", "n_nonfinite",
                                            "gradients_before", "anomaly", "saved",
                                            "error")})[:6000])
                break
            del kept
        record["runs"].append(run)
        del model, step, batch
        torch.cuda.empty_cache()
    hit = [r["batch"] for r in record["runs"] if r["first_nonfinite_step"] is not None]
    record["smallest_nonfinite_batch"] = min(hit) if hit else None
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1, default=str)
    log(f"smallest batch with a non-finite step: {record['smallest_nonfinite_batch']}; "
        f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
