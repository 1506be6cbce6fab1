"""Check C1 at the projection: do the JAX package's projection and the
port's give the same non-finite gradient to the far Gaussians' means?

On an H100 the port's flagship training step (re10k_8view widths, seed-0
weights, batch 2, 12 targets) zeroes 551,879,107 non-finite gradient
entries at step 6; batch 1 stays finite for 9 steps.
`vicasplat_tpu_torch/diagnostics/c1_locate.py` put the first non-finite
gradient at the means of 921 Gaussians, in the rasterizer's projection
(`v = fy * py * inv_z + cy`), and wrote the projection inputs of those
Gaussians (their means, packed covariances, harmonics, opacities, and the 12
target views of their batch item) to an npz. The projection is elementwise
in the Gaussians, so these Gaussians alone give the same per-Gaussian
gradient as the whole scene.

The means lie about 1.5e36 from the cameras, where `fy * py` overflows
float32 in any projection; so the comparison shows that both packages'
projections turn such means into the same non-finite entries, and nothing
more. Whether the JAX package's training from the same weights reaches such
means is not settled here (ROADMAP.md §3, C1).

This script puts those inputs through the JAX package's `project_gaussians`
and the port's, with a cotangent of ones on every differentiable output
(mean2d, conic, color, alpha, depth), view by view, and counts the
non-finite entries of each side's gradient to the means. It imports the
JAX package and changes nothing in it.

Usage, from the repository root, on the CPU:
    env JAX_PLATFORMS=cpu python tools/jax_c1_reference.py \
        [--npz vicasplat_tpu_torch/diagnostics/c1_gaussians.npz] [--json OUT]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NPZ = ROOT / "vicasplat_tpu_torch/diagnostics/c1_gaussians.npz"
OUTPUTS = ("mean2d", "conic", "color", "alpha", "depth")


def jax_means_grads(z, b):
    """Per view, the gradient of the JAX projection's outputs (summed) to
    the means of batch item b's Gaussians."""
    import jax
    import jax.numpy as jnp

    from vicasplat_tpu.ops.rasterize.projection import project_gaussians

    H, W = (int(x) for x in z["image_shape"])
    cov6, harmonics, opac = (jnp.asarray(z[f"b{b}_{k}"])
                             for k in ("cov6", "harmonics", "opacities"))

    def total(means, vm, K):
        s = project_gaussians(means, None, harmonics, opac, vm, K, (H, W),
                              int(z["sh_degree"]), near=float(z["near"]), cov6=cov6)
        return sum(getattr(s, k).sum() for k in OUTPUTS)

    grad = jax.jit(jax.grad(total))
    return [np.asarray(grad(jnp.asarray(z[f"b{b}_means"]), jnp.asarray(vm), jnp.asarray(K)))
            for vm, K in zip(z[f"b{b}_viewmats"], z[f"b{b}_intrinsics"])]


def port_means_grads(z, b):
    import torch

    from vicasplat_tpu_torch.ops.rasterize.projection import project_gaussians

    H, W = (int(x) for x in z["image_shape"])
    cov6, harmonics, opac = (torch.from_numpy(z[f"b{b}_{k}"])
                             for k in ("cov6", "harmonics", "opacities"))
    out = []
    for vm, K in zip(z[f"b{b}_viewmats"], z[f"b{b}_intrinsics"]):
        means = torch.from_numpy(z[f"b{b}_means"]).requires_grad_()
        s = project_gaussians(means, cov6, harmonics, opac, torch.from_numpy(vm),
                              torch.from_numpy(K), (H, W), int(z["sh_degree"]),
                              near=float(z["near"]))
        g, = torch.autograd.grad(sum(getattr(s, k).sum() for k in OUTPUTS), means)
        out.append(g.numpy())
    return out


def compare(npz=NPZ) -> dict:
    """{batch item: per view, the non-finite gradient entries of each side,
    the Gaussians in front of the camera, and |fy * y_cam| in float32}."""
    z = dict(np.load(npz))
    H = int(z["image_shape"][0])
    items = sorted({k.split("_")[0] for k in z if k.startswith("b")})
    rec = {}
    for item in items:
        b = int(item[1:])
        jg, pg = jax_means_grads(z, b), port_means_grads(z, b)
        means = z[f"b{b}_means"]
        views = []
        for v, (vm, K) in enumerate(zip(z[f"b{b}_viewmats"], z[f"b{b}_intrinsics"])):
            cam = means @ vm[:3, :3].T + vm[:3, 3]
            with np.errstate(over="ignore"):  # the overflow is the finding
                fy_y = np.float32(K[1, 1] * H) * cam[:, 1].astype(np.float32)
            views.append(dict(
                view=v, jax_nonfinite=int((~np.isfinite(jg[v])).sum()),
                port_nonfinite=int((~np.isfinite(pg[v])).sum()),
                same_nonfinite_entries=bool(np.array_equal(~np.isfinite(jg[v]),
                                                           ~np.isfinite(pg[v]))),
                in_front=int((cam[:, 2] > 0.2).sum()),
                fy_y_cam_absmax=float(np.abs(fy_y).max()),
                fy_y_cam_inf=int((~np.isfinite(fy_y)).sum())))
        rec[item] = dict(n=int(means.shape[0]),
                         means_absmax=float(np.abs(means).max()), views=views)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--npz", default=str(NPZ))
    ap.add_argument("--json", default=None, help="write the record here too")
    args = ap.parse_args(argv)
    rec = compare(args.npz)
    for item, r in rec.items():
        jn = sum(v["jax_nonfinite"] for v in r["views"])
        pn = sum(v["port_nonfinite"] for v in r["views"])
        print(f"{item}: {r['n']} Gaussians, |means| up to {r['means_absmax']:.3e}; "
              f"non-finite gradient entries over {len(r['views'])} views: JAX {jn}, "
              f"port {pn}; same entries in every view: "
              f"{all(v['same_nonfinite_entries'] for v in r['views'])}; "
              f"fy * y_cam overflows float32 for "
              f"{max(v['fy_y_cam_inf'] for v in r['views'])} of them at most")
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(rec, indent=1) + "\n")


if __name__ == "__main__":
    main()
