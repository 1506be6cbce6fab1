"""Where the tiled render departs from the brute-force oracle (ROADMAP.md
§3, C4), in the JAX package and in the port, on the same scene.

The scene is `chip_smoke.py`'s 1,000-splat scene (SH degree 4, 2 views of
96 x 128). For each view and each `dup_hw` this script renders:
- the JAX package's oracle (`render_view_bruteforce`) and its tiled render,
  through both binnings;
- the port's oracle, plain and with the tiles' 3-sigma support
  (`support_tile_px=16`), and the port's tiled render through both
  binnings;
- the JAX package's tiled render with each tile's kept list re-sorted by
  exact depth (as `tests/test_torch_render.py::jax_exact_depth_order` does).

It prints one JSON object: each render's largest gap to each oracle, and
`coverage_stats` of the port. Two things separate a tiled render from the
plain oracle when no splat is truncated and no tile is full:
- the sort keys. JAX's u32 keys keep 32 - tile_bits bits of the depth
  (dup-sort) or 32 - log2(merged width) bits (origin), so splats whose depths
  are that close tie and composite in the sort's order. The port's int64 keys
  keep the exact order.
- the support. A splat reaches only the tiles of its 3-sigma rect, as in
  the CUDA rasterizer, while above opacity 0.36 its alpha still passes 1/255
  a little beyond 3 sigma. The oracle with `support_tile_px` gives it the
  same pixels.

It imports the JAX package and changes nothing in it.

Usage, from the repository root, on the CPU (about a minute):
    env JAX_PLATFORMS=cpu python tools/jax_c4_oracle_gap.py [--json OUT]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPE = (96, 128)
DUPS = ((3, 3), (4, 4), (6, 6))
FIELDS = ("color", "depth", "alpha")


def gaps(got, ref) -> dict:
    return {f: float(np.abs(np.asarray(a) - np.asarray(r)).max())
            for f, a, r in zip(FIELDS, got, ref)}


def support_cut(splats, pixel, tile_px=16) -> list:
    """The splats whose alpha passes 1/255 at `pixel` (y, x) while their
    3-sigma rect misses its tile: (id, opacity, alpha there, distance in
    sigmas)."""
    import torch

    px, py = pixel[1] + 0.5, pixel[0] + 0.5
    m, c, r = splats.mean2d, splats.conic, splats.radius
    dx, dy = px - m[:, 0], py - m[:, 1]
    power = -0.5 * (c[:, 0] * dx * dx + c[:, 2] * dy * dy) - c[:, 1] * dx * dy
    a = torch.clamp(splats.alpha * torch.exp(power.clamp(max=0.0)), max=0.99)
    tx, ty = px // tile_px, py // tile_px
    inside = ((tx >= torch.floor((m[:, 0] - r) / tile_px))
              & (tx <= torch.floor((m[:, 0] + r) / tile_px))
              & (ty >= torch.floor((m[:, 1] - r) / tile_px))
              & (ty <= torch.floor((m[:, 1] + r) / tile_px)))
    cut = (r > 0) & (power <= 0) & (a >= 1 / 255) & ~inside
    return [{"id": int(i), "opacity": float(splats.alpha[i]), "alpha": float(a[i]),
             "sigmas": float(torch.sqrt(-2 * power[i]))} for i in cut.nonzero()[:, 0]]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args(argv)

    import jax.numpy as jnp
    import torch

    from chip_smoke import small_scene
    from tests.test_torch_render import jax_exact_depth_order
    from vicasplat_tpu.ops.rasterize import RasterizeConfig as JCfg
    from vicasplat_tpu.ops.rasterize import reference as jref
    from vicasplat_tpu.ops.rasterize import render as jrender
    from vicasplat_tpu_torch.ops.rasterize import reference as tref
    from vicasplat_tpu_torch.ops.rasterize.projection import project_gaussians
    from vicasplat_tpu_torch.ops.rasterize.render import RasterizeConfig, coverage_stats, render

    torch.set_num_threads(2)
    means, cov6, sh, opac, ext, K = small_scene()
    c = cov6
    covs = torch.stack([torch.stack([c[:, 0], c[:, 1], c[:, 2]], -1),
                        torch.stack([c[:, 1], c[:, 3], c[:, 4]], -1),
                        torch.stack([c[:, 2], c[:, 4], c[:, 5]], -1)], -2)
    J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    bg = torch.zeros(3)
    out = {"scene": "chip_smoke.small_scene: 1000 splats, SH 4, 2 views of 96x128",
           "views": []}
    for v in range(ext.shape[0]):
        vm = torch.linalg.inv(ext[v])
        plain = tref.render_view_bruteforce(means, cov6, sh, opac, vm, K[v], SHAPE, bg, 4)
        rect = tref.render_view_bruteforce(means, cov6, sh, opac, vm, K[v], SHAPE, bg, 4,
                                           support_tile_px=16)
        jplain = jref.render_view_bruteforce(J(means), J(covs), J(sh), J(opac), J(vm),
                                             J(K[v]), SHAPE, jnp.zeros(3), 4)
        worst = (rect[0] - plain[0]).abs().amax(-1)
        pixel = divmod(int(worst.argmax()), SHAPE[1])
        splats = project_gaussians(means, cov6, sh, opac, vm, K[v], SHAPE, 4)
        rec = {"view": v, "oracles": {"port_vs_jax": gaps(plain, jplain),
                                      "support_vs_plain": gaps(rect, plain)},
               "support_cut_at_worst_pixel": {"pixel_yx": pixel,
                                              "splats": support_cut(splats, pixel)},
               "dup": {}}
        for dup in DUPS:
            row = {}
            for binning in ("dup_sort", "origin"):
                if binning == "origin" and dup[0] * dup[1] > 32 - 10:
                    continue  # 1,000 ids and the slot bitmap pass a u32 index
                kw = dict(dup_hw=dup, binning=binning)
                jin = (J(means), J(covs), J(sh), J(opac), J(ext[v:v + 1]), J(K[v:v + 1]),
                       SHAPE, jnp.zeros(3))
                jgot = [x[0] for x in jrender(*jin, sh_degree=4, cfg=JCfg(**kw))]
                with jax_exact_depth_order():
                    jexact = [x[0] for x in jrender(*jin, sh_degree=4, cfg=JCfg(**kw))]
                tgot = [x[0] for x in render(means, cov6, sh, opac, ext[v:v + 1],
                                             K[v:v + 1], SHAPE, bg, 4,
                                             cfg=RasterizeConfig(**kw))]
                row[binning] = {
                    "jax_vs_jax_oracle": gaps(jgot, jplain),
                    "jax_exact_order_vs_support_oracle": gaps(jexact, rect),
                    "port_vs_plain_oracle": gaps(tgot, plain),
                    "port_vs_support_oracle": gaps(tgot, rect)}
            cov = coverage_stats(means, cov6, sh, opac, vm, K[v], SHAPE, 4,
                                 cfg=RasterizeConfig(dup_hw=dup))
            row["coverage"] = {k: float(x) for k, x in cov.items()}
            rec["dup"][f"{dup[0]}x{dup[1]}"] = row
        out["views"].append(rec)
    text = json.dumps(out, indent=1)
    print(text)
    if args.json:
        pathlib.Path(args.json).write_text(text)
    return out


if __name__ == "__main__":
    main()
