"""Check C3: has the port's random init the JAX package's scale at full width?

`chip_smoke.py`'s distill phase trains `distill.yaml` at full width from
random weights with two changes (the teacher heads' last conv scaled by
DISTILL_HEAD_SCALE, the student with `encoder.dpt_stabilize=true`), because
its first card run gave a Regr3D of 1e28. The experiment configs
(`re10k_2view`, `acid_2view`, `re10k_4view`) also train the student from
random init at full width. This script compares, on the CPU in float32:

- every leaf's mean and standard deviation between the JAX package's
  `init_vicasplat(PRNGKey(seed), cfg)` and the port's `init_vicasplat(cfg,
  Generator(seed))` at re10k_2view's widths, and between JAX's
  `init_dust3r(PRNGKey(1), Dust3RConfig(img_size=256))` and the port's
  `init_dust3r` from a generator seeded 1 (JAX `main.py:332`, the port's
  `main._maybe_distiller`);
- on one pair of 256^2 frames (numpy, seeded): the student's float32
  centre-head output (`gaussian_centers`) and the teacher's float32 pts3d
  and confidence, each as JAX's forward on JAX's init, the port's forward on
  the same weights carried across by `utils/weights.py`, and the port's
  forward on its own init: their median and largest norms; then, over a
  few draws of each init, the spread of those outputs' median norms, since
  one draw through the norm-free DPT heads' exponential says little.

It imports the JAX package and changes nothing in it. The full-width trees
are made one at a time (about 2.3 GB of float32 each) and the JAX forwards
run op by op, not compiled whole.

Usage, from the repository root, on the CPU (about 10 minutes, 7 GB):
    env JAX_PLATFORMS=cpu python tools/c3_init_scale.py [--json OUT]
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXPERIMENT = "re10k_2view"


def leaf_stats(tree) -> dict:
    """{path: (mean, std, size)} of a JAX-shaped tree, in float64."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf, np.float64)
        out[jax.tree_util.keystr(path)] = (float(a.mean()), float(a.std()), int(a.size))
    return out


def compare_stats(jax_stats: dict, port_stats: dict) -> dict:
    """Per leaf, the port's std over JAX's and the gap of the means in units
    of JAX's std; the leaves furthest from 1 and 0, and the leaves where one
    side is constant and the other is not."""
    rows = []
    for k, (jm, js, n) in jax_stats.items():
        pm, ps, _ = port_stats[k]
        if js == 0.0 or ps == 0.0:
            rows.append((k, n, None if js != ps else 1.0, jm, pm))
            continue
        rows.append((k, n, ps / js, (pm - jm) / js, None))
    constant = [(k, n, jm, pm) for k, n, r, jm, pm in rows if r is None or (
        r == 1.0 and jm != pm)]
    ratios = [(k, n, r, d) for k, n, r, d, extra in rows if extra is None and r is not None]
    worst_std = sorted(ratios, key=lambda x: -abs(np.log(x[2])))[:5]
    worst_mean = sorted(ratios, key=lambda x: -abs(x[3]))[:5]
    weighted = sum(n for _, n, _, _ in ratios)
    return {
        "leaves": len(rows),
        "std_ratio_range": [min(r for _, _, r, _ in ratios), max(r for _, _, r, _ in ratios)],
        # the std ratio's spread over the entries (leaves weighted by size)
        "std_ratio_weighted_mean": sum(n * r for _, n, r, _ in ratios) / weighted,
        "worst_std_ratio": [[k, n, r] for k, n, r, _ in worst_std],
        "worst_mean_gap_in_std": [[k, n, d] for k, n, _, d in worst_mean],
        "constant_mismatch": [[k, n, jm, pm] for k, n, jm, pm in constant],
        "constant_leaves": sum(1 for _, _, r, _, extra in rows if extra is not None),
    }


def norms(x) -> dict:
    n = np.linalg.norm(np.asarray(x, np.float64).reshape(-1, np.shape(x)[-1]), axis=-1)
    return {"median": float(np.median(n)), "max": float(n.max()),
            "finite": bool(np.isfinite(n).all())}


def scalars(x) -> dict:
    a = np.asarray(x, np.float64).ravel()
    return {"median": float(np.median(a)), "max": float(a.max()),
            "finite": bool(np.isfinite(a).all())}


def frames(seed: int = 3) -> np.ndarray:
    """Two 256^2 frames in [0, 1]: smooth colour fields with noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:256, 0:256] / 255.0
    out = []
    for t in range(2):
        base = np.stack([x + 0.1 * t, y, 0.5 * (x + y)], -1)
        out.append(np.clip(base + rng.normal(0, 0.05, base.shape), 0, 1))
    return np.stack(out).astype(np.float32)


def student(seed: int) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from vicasplat_tpu.models import vicasplat as jvs
    from vicasplat_tpu.utils.config import load_config as jload
    from vicasplat_tpu_torch.models import init_vicasplat
    from vicasplat_tpu_torch.models.vicasplat import VicaSplat, vicasplat_forward
    from vicasplat_tpu_torch.utils import weights
    from vicasplat_tpu_torch.utils.config import load_config as tload

    main_yaml = ROOT / "configs" / "main.yaml"
    jcfg = jload(main_yaml, EXPERIMENT, []).encoder
    tcfg = tload(main_yaml, EXPERIMENT, []).encoder
    img = frames()
    K = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32), (1, 2, 1, 1))
    E = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    E[0, 1, 0, 3] = 0.2
    ctx = {"image": img[None] * 2 - 1, "intrinsics": K, "extrinsics": E}

    t = time.perf_counter()
    jparams = jvs.init_vicasplat(jax.random.PRNGKey(seed), jcfg)
    jstats = leaf_stats(jparams)
    jax_init_s = time.perf_counter() - t
    jout = jvs.vicasplat_forward(jparams, jcfg, {k: jnp.asarray(v) for k, v in ctx.items()},
                                 0, dtype=jnp.float32)
    r = {"jax_init_s": jax_init_s,
         "centers": {"jax_on_jax_init": norms(jout["gaussian_centers"])}}
    jcenters = np.asarray(jout["gaussian_centers"])
    del jout
    tctx = {k: torch.tensor(v) for k, v in ctx.items()}
    with torch.no_grad():
        model = weights.load_jax_params(VicaSplat(tcfg), jparams)
        del jparams
        gc.collect()
        c = vicasplat_forward(model, tctx, 0, dtype=torch.float32)["gaussian_centers"].numpy()
        r["centers"]["port_on_jax_init"] = norms(c)
        r["centers"]["port_vs_jax_same_weights_rel"] = float(
            np.abs(c - jcenters).max() / np.abs(jcenters).max())
        del model
        gc.collect()
        t = time.perf_counter()
        model = init_vicasplat(tcfg, torch.Generator().manual_seed(seed), "cpu")
        r["port_init_s"] = time.perf_counter() - t
        pstats = leaf_stats(_port_tree(model, jcfg))
        c = vicasplat_forward(model, tctx, 0, dtype=torch.float32)["gaussian_centers"].numpy()
        r["centers"]["port_on_port_init"] = norms(c)
    r["leaf_stats"] = compare_stats(jstats, pstats)
    return r


def _port_tree(model, jcfg):
    """The port's parameters as the JAX package's tree (shapes from
    jax.eval_shape, nothing drawn)."""
    import jax

    from vicasplat_tpu.models import vicasplat as jvs
    from vicasplat_tpu_torch.utils import weights

    shapes = jax.eval_shape(lambda k: jvs.init_vicasplat(k, jcfg), jax.random.PRNGKey(0))
    return weights.jax_tree_from_state_dict(model.state_dict(), shapes)


def teacher() -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from vicasplat_tpu.models import dust3r as jd
    from vicasplat_tpu_torch.models import dust3r as td
    from vicasplat_tpu_torch.utils import weights

    jcfg, tcfg = jd.Dust3RConfig(img_size=256), td.Dust3RConfig(img_size=256)
    img = frames() * 2 - 1
    t = time.perf_counter()
    jparams = jd.init_dust3r(jax.random.PRNGKey(1), jcfg)
    jstats = leaf_stats(jparams)
    r = {"jax_init_s": time.perf_counter() - t}
    jout = jd.dust3r_forward(jparams, jcfg, jnp.asarray(img[:1]), jnp.asarray(img[1:]),
                             dtype=jnp.float32)

    def summary(out):
        return {v: {"pts3d": norms(out[v]["pts3d"]), "conf": scalars(out[v]["conf"])}
                for v in ("view1", "view2")}

    r["jax_on_jax_init"] = summary(jout)
    jpts = np.asarray(jout["view1"]["pts3d"])
    del jout
    a, b = torch.tensor(img[:1]), torch.tensor(img[1:])
    with torch.no_grad():
        model = weights.load_jax_params(td.Dust3R(tcfg), jparams)
        shapes = jax.eval_shape(lambda k: jd.init_dust3r(k, jcfg), jax.random.PRNGKey(0))
        del jparams
        gc.collect()
        out = td.dust3r_forward(model, a, b, dtype=torch.float32)
        r["port_on_jax_init"] = summary(out)
        r["port_vs_jax_same_weights_rel"] = float(
            np.abs(out["view1"]["pts3d"].numpy() - jpts).max() / np.abs(jpts).max())
        del model, out
        gc.collect()
        model = td.init_dust3r(tcfg, torch.Generator().manual_seed(1), "cpu")
        pstats = leaf_stats(weights.jax_tree_from_state_dict(model.state_dict(), shapes))
        r["port_on_port_init"] = summary(td.dust3r_forward(model, a, b, dtype=torch.float32))
    r["leaf_stats"] = compare_stats(jstats, pstats)
    return r


def draws(n: int, seed: int) -> dict:
    """The forwards' output scale over n draws of each init (seeds seed,
    seed + 1, ... for the student; 1, 2, ... for the teacher): log10 of the
    median norm of the student's centres and the teacher's view-1 pts3d, by
    JAX's forward on JAX's init and the port's on its own."""
    import jax
    import jax.numpy as jnp
    import torch

    from vicasplat_tpu.models import dust3r as jd
    from vicasplat_tpu.models import vicasplat as jvs
    from vicasplat_tpu.utils.config import load_config as jload
    from vicasplat_tpu_torch.models import dust3r as td
    from vicasplat_tpu_torch.models import init_vicasplat
    from vicasplat_tpu_torch.models.vicasplat import vicasplat_forward
    from vicasplat_tpu_torch.utils.config import load_config as tload

    main_yaml = ROOT / "configs" / "main.yaml"
    jcfg = jload(main_yaml, EXPERIMENT, []).encoder
    tcfg = tload(main_yaml, EXPERIMENT, []).encoder
    img = frames()
    K = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32), (1, 2, 1, 1))
    E = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    E[0, 1, 0, 3] = 0.2
    ctx = {"image": img[None] * 2 - 1, "intrinsics": K, "extrinsics": E}
    pair = img * 2 - 1
    out = {k: [] for k in ("student_jax", "student_port", "teacher_jax", "teacher_port")}
    log_median = lambda x: float(np.log10(norms(x)["median"]))  # noqa: E731
    for i in range(n):
        p = jvs.init_vicasplat(jax.random.PRNGKey(seed + i), jcfg)
        out["student_jax"].append(log_median(jvs.vicasplat_forward(
            p, jcfg, {k: jnp.asarray(v) for k, v in ctx.items()}, 0,
            dtype=jnp.float32)["gaussian_centers"]))
        del p
        with torch.no_grad():
            m = init_vicasplat(tcfg, torch.Generator().manual_seed(seed + i), "cpu")
            out["student_port"].append(log_median(vicasplat_forward(
                m, {k: torch.tensor(v) for k, v in ctx.items()}, 0,
                dtype=torch.float32)["gaussian_centers"]))
        del m
        gc.collect()
        dcfg = jd.Dust3RConfig(img_size=256)
        p = jd.init_dust3r(jax.random.PRNGKey(1 + i), dcfg)
        out["teacher_jax"].append(log_median(jd.dust3r_forward(
            p, dcfg, jnp.asarray(pair[:1]), jnp.asarray(pair[1:]),
            dtype=jnp.float32)["view1"]["pts3d"]))
        del p
        with torch.no_grad():
            m = td.init_dust3r(td.Dust3RConfig(img_size=256),
                               torch.Generator().manual_seed(1 + i), "cpu")
            out["teacher_port"].append(log_median(td.dust3r_forward(
                m, torch.tensor(pair[:1]), torch.tensor(pair[1:]),
                dtype=torch.float32)["view1"]["pts3d"]))
        del m
        gc.collect()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="write the figures here too")
    ap.add_argument("--seed", type=int, default=250307, help="the student's seed "
                    "(configs/main.yaml's)")
    ap.add_argument("--draws", type=int, default=4, help="draws of each init for "
                    "the output scale's spread")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import jax
    import torch

    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(4)
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    res = {"student": student(args.seed)}
    gc.collect()
    res["teacher"] = teacher()
    gc.collect()
    res["draws_log10_median_norm"] = draws(args.draws, args.seed)
    res["seconds"] = time.perf_counter() - t
    text = json.dumps(res, indent=1)
    print(text)
    if args.json:
        pathlib.Path(args.json).write_text(text)
    return res


if __name__ == "__main__":
    main()
