"""AOT export (port of vicasplat_tpu/export.py): the serving engine's
programs as `torch.export` artifacts (`.pt2`) that run without the model's
Python code.

- Weights are call-time ARGUMENTS, never stored in the artifact: the
  program takes a flat dict {state-dict name: tensor} of the engine's
  weights (`weights(engine)`), so one artifact serves any checkpoint of the
  same architecture. Only small constant tables (RoPE, input statistics,
  the background) are stored.
- The calling convention uses plain containers: the `Gaussians` are a dict
  at the boundary.
- The kernels K1-K4 are custom operators (`torch.ops.vicasplat.*`,
  `kernels/`), so the exported graph calls them by name: a process that
  imports `torch` and `vicasplat_tpu_torch.kernels` (which registers them)
  can load and run the artifact, and never imports `models`. On CUDA
  tensors the operators launch the hand-written kernels, on CPU tensors
  they run the plain versions.
- JAX's `platforms` (export on one backend, serve on another) is an
  artifact exported on the CPU and moved with `load_exported(path,
  device="cuda")` (`torch.export.passes.move_to_device_pass`): there it
  launches the kernels through the operators' CUDA implementations.

    python -m vicasplat_tpu_torch.export --out reconstruct.pt2 --batch 1 \\
        --frames 8 [--ckpt weights.npz] [--quantize] [--device cpu]
"""
from __future__ import annotations

import io
import pathlib

import torch
from torch import nn


def _gaussians_to_dict(g) -> dict:
    return dict(g._asdict())


def weights(engine) -> dict:
    """The engine's weights as the exported programs take them: its model's
    state dict (parameters and buffers, int8 ones too)."""
    return {k: v.detach() for k, v in engine.model.state_dict().items()}


class _Bound(nn.Module):
    """A model and a function of it, so that `functional_call` can swap the
    model's tensors for the call's arguments."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _WithWeights(nn.Module):
    """The exported root: weights first, then the program's inputs. The
    model is held outside the module tree, so that none of its tensors
    becomes a parameter or buffer of the artifact."""

    def __init__(self, model: nn.Module, fn, wrap):
        super().__init__()
        object.__setattr__(self, "bound", _Bound(model, fn))
        self.wrap = wrap

    def forward(self, params: dict, *args):
        out = torch.func.functional_call(
            self.bound, {f"model.{k}": v for k, v in params.items()}, args)
        return self.wrap(out)


class _Plain(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _serialize(ep) -> bytes:
    """The artifact's bytes, without the example inputs `torch.export` keeps
    (they hold the weights) and without each node's Python stack trace
    (which doubles the save's time and a third of the file)."""
    ep.example_inputs = None
    for node in ep.graph.nodes:
        node.meta.pop("stack_trace", None)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_reconstruct(engine, batch: int, frames: int, height: int, width: int,
                       with_intrinsics: bool = False) -> bytes:
    """Serialize the engine's reconstruct program for a fixed input shape,
    traced on the engine's device.

    The artifact's call convention is `(params, images01[, intrinsics]) ->
    {"gaussians": {...}, "poses": ..., "intrinsics": ...}` with images01
    float32 (B, T, H, W, 3) in [0, 1] and params `weights(engine)`.
    """
    raw = engine._reconstruct_raw()

    def wrap(out):
        g, poses, intr = out
        res = {"gaussians": _gaussians_to_dict(g), "poses": poses}
        if intr is not None:
            res["intrinsics"] = intr
        return res

    if with_intrinsics:
        fn = raw
    else:
        def fn(images01):
            return raw(images01, None)

    dev = engine.device
    args = [weights(engine),
            torch.zeros(batch, frames, height, width, 3, device=dev)]
    if with_intrinsics:
        args.append(torch.eye(3, device=dev).expand(batch, frames, 3, 3).contiguous())
    with torch.no_grad():
        ep = torch.export.export(_WithWeights(engine.model, fn, wrap), tuple(args),
                                 strict=False)
    return _serialize(ep)


def export_render(engine, scene_dims, n_views: int, image_shape) -> bytes:
    """Serialize the engine's render program, traced on the engine's device.

    `scene_dims` are the Gaussians' leading dims (e.g. (B, T, H, W) for
    pixel-aligned scenes). Call convention: `(gaussians_dict, extrinsics,
    intrinsics, near, far) -> {"color", "depth", "alpha"}`, all float32.
    """
    from .models.adapter import Gaussians

    d_sh = engine.cfg.gaussian_adapter.d_sh
    sd, dev = tuple(scene_dims), engine.device

    def z(*shape):
        return torch.zeros(*shape, device=dev)

    g = {"means": z(*sd, 3), "covariances": z(*sd, 3, 3),
         "harmonics": z(*sd, 3, d_sh), "opacities": z(*sd), "scales": z(*sd, 3),
         "rotations": z(*sd, 4)}
    B, V = sd[0], n_views
    raw = engine._render_raw(tuple(image_shape))

    def fn(g_dict, extrinsics, intrinsics, near, far):
        out = raw(Gaussians(**g_dict), extrinsics, intrinsics, near, far)
        return dict(out._asdict())

    args = (g, torch.eye(4, device=dev).expand(B, V, 4, 4).contiguous(),
            torch.eye(3, device=dev).expand(B, V, 3, 3).contiguous(), z(B, V), z(B, V))
    with torch.no_grad():
        ep = torch.export.export(_Plain(fn), args, strict=False)
    return _serialize(ep)


def save_exported(path, blob: bytes):
    pathlib.Path(path).write_bytes(blob)


def load_exported(path, device=None):
    """Deserialize an artifact -> `torch.export.ExportedProgram`; call it
    with `.module()(*args)`. `device` moves a program exported on another
    device (e.g. the CPU) there first. Needs the operators registered:
    import `vicasplat_tpu_torch.kernels` (done here)."""
    from . import kernels  # noqa: F401  (registers torch.ops.vicasplat.*)

    ep = torch.export.load(str(path))
    if device is not None:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, torch.device(device))
    return ep


def main(argv=None):
    """Release-time artifact build: the flagship config (SH degree 4) with
    the npz's weights, or seeded random ones."""
    import argparse
    import time

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--no-intrinsics", action="store_true",
                    help="export the predicted-intrinsics calling convention")
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="trace on this device (cpu: move the artifact with "
                         "load_exported(path, device='cuda') to serve)")
    args = ap.parse_args(argv)

    from .models import GaussianAdapterConfig, VicaNetConfig, VicaSplatConfig
    from .serving import InferenceEngine

    cfg = VicaSplatConfig(backbone=VicaNetConfig(img_size=args.size),
                          gaussian_adapter=GaussianAdapterConfig(sh_degree=4))
    engine = InferenceEngine(cfg, ckpt=args.ckpt, quantize=args.quantize,
                             device=args.device)
    t0 = time.perf_counter()
    blob = export_reconstruct(engine, args.batch, args.frames, args.size, args.size,
                              with_intrinsics=not args.no_intrinsics)
    save_exported(args.out, blob)
    print(f"wrote {args.out} ({len(blob)} bytes, traced in "
          f"{time.perf_counter() - t0:.1f} s, {args.batch}x{args.frames}x"
          f"{args.size}^2{', int8' if args.quantize else ''}; weights are "
          "arguments: vicasplat_tpu_torch.export.weights(engine))")


if __name__ == "__main__":
    main()
