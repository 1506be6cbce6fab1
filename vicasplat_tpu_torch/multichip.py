"""The parallel routes across several cards over NCCL: the port's
counterpart of the JAX package's `__graft_entry__.dryrun_multichip(n)`.

    python -m vicasplat_tpu_torch.multichip [--world N] [--device cuda|cpu]

The parent process checks every kernel on every card (phase a), then starts
one process per card (torch.multiprocessing), each joining the group by
`parallel.mesh.init_distributed` (NCCL on the cards, gloo with
`--device cpu`) with a short timeout. The ranks run, in this order:

  ref  the world-1 references, spread over the ranks, each on its own card
       (the DDP one on card 0);
  b    DDP: the flagship step at a global batch of `world` x B against
       world 1 at `world` micro-batches of B; the all-reduce's bus bandwidth
       on the flagship's gradients;
  c    FSDP2 (`mesh.shard_params_fsdp`): the same step, peak a rank beside
       `parallel/memory_proof.reckon`'s fsdp<world>;
  d    TP 1 x world and 2 x world/2;
  e    SP 1 x world, K1 held on the SP step's own q, k, v;
  f    EP: the MoE flagship, its experts over the ranks;
  g    GPipe over `world` stages, with each stage's share of the
       pipeline's span (CUDA events recorded by the host) outside its
       blocks' calls: host dispatch gaps count as busy, so this is no
       measure of the bubble;
  h    the view-sharded render (serving's `view_mesh`) against one card;
  i    main.py's train mode under the group, in the config's bf16: 4
       steps, a checkpoint at 2, a resume, against the train mode at world
       1 on the same global batch in `world` micro-batches (each rank's
       batch shape), every step's frames on each rank world 1's part of
       them; world 1 on the whole batch beside it, not held.

"Flagship" is configs/experiment/re10k_8view.yaml at full width (ViT-L
24 x 1024, decoder 12 x 768, DPT, SH 4), bf16 over float32, remat "dots",
AdamW, from seeded random weights, at B x (8 + 12) a rank. Its gradient
norms are chaotic at random init, so each route b-g holds, as
chip_smoke.py's world-2 steps do, the flagship's loss against world 1
(FLASH_BWD_FLOOR) with its norms printed, and a float32 witness
(configs/experiment/synthetic_pose.yaml, linear heads, bounded depth: a
well-posed step) at the same world that holds the loss (STEP_TOL), every
gradient norm and every group's update (FLASH_BWD_FLOOR). Every step's
update is held to AdamW's bound, K1's launches a rank exactly, and the
unsplit parameters equal on every rank. With `--device cpu` every shape
is a toy one of the same structure (tests/test_torch_multichip.py).

Each rank's log and the summary go to build/multichip/; the last line of
the output is the summary's verdict as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from typing import Optional
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from .diagnostics.holds import (
    EXIT_T,
    F32_TOL,
    FLASH_BWD_FLOOR,
    FLASH_TOL,
    RENDER_TOL,
    STEP_TOL,
    TAIL_TOL,
    TRAIN_LOSS_TOL,
    host_copy,
    k1_bwd_held,
    rel,
    route_gaps,
    step_record,
    update_gaps,
    update_record,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "multichip"
# the group's timeout: a rank stuck in a collective dies after it, and the
# parent then stops the others; the parent stops every rank past RUN_LIMIT_S
GROUP_TIMEOUT_S = 180
RUN_LIMIT_S = 570

KERNELS = ("flash_attn", "flash_attn_bwd", "flash_attn_f32", "bitonic_topk",
           "composite", "dpt_tail")
# NVLink 4 of an H100 SXM: 900 GB/s both ways, 450 GB/s each way, the peak
# of an all-reduce's bus bandwidth
NVLINK_BYTES_PER_S = 450e9
# the MoE flagship: re10k_8view's widths with MoE decoder MLPs
MOE_EXPERTS, MOE_TOP_K, MOE_CAPACITY = 8, 2, 1.25
# train-mode steps, a checkpoint every CKPT_EVERY, from the committed weights
TRAIN_STEPS, CKPT_EVERY = 4, 2
TRAINED_NPZ = "outputs/synthetic_pose/ckpt_committed/weights_latest.npz"

T_START = time.time()


def log(name: str, msg: str) -> None:
    print(f"[{name}] (at {time.time() - T_START:.1f} s) {msg}", flush=True)


# ---------------------------------------------------------------- configs

def _route_optimizer(cfg):
    """A linear warm-up in place of the cosine schedule: the first update
    has lr > 0, so one step from the init both takes the gradient and
    updates (chip_smoke.route_train_config)."""
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, cosine_annealing=False, warm_up_steps=1))


def _with_backbone(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(cfg.model.backbone, **kw)))


def synthetic_pose_config(overrides=()):
    """configs/experiment/synthetic_pose.yaml's TrainConfig (with
    `overrides`), in float32 with the linear warm-up."""
    from .main import build_all
    from .utils.config import load_config

    cfg = load_config(ROOT / "configs" / "main.yaml", "synthetic_pose", list(overrides))
    train_cfg, _, _ = build_all(cfg, "cpu")
    return _route_optimizer(dataclasses.replace(train_cfg, dtype="float32"))


# the toy widths of the CPU run: every head count and depth divides by 4
TOY_NET = dict(img_size=32, enc_embed_dim=64, enc_depth=4, enc_num_heads=4,
               dec_embed_dim=48, dec_depth=4, dec_num_heads=4)


@dataclasses.dataclass
class Sizes:
    """The run's configurations and batch shapes."""
    flagship: object      # TrainConfig
    witness: object       # TrainConfig, float32
    B: int                # flagship examples a DDP rank
    T: int                # context frames
    V: int                # target views
    size: int             # image side
    w_batch: int          # the witness's global batch
    w_T: int
    w_V: int
    steps: tuple          # global step indices of a flagship run
    train_argv: list      # main.py's train mode


def sizes(device: str) -> Sizes:
    from .training.presets import flagship_train_config

    if device == "cpu":
        from .decoder.splatting import DecoderSplattingConfig
        from .ops.rasterize import RasterizeConfig

        # the DPT heads' fixed widths (features of 256 at half the image)
        # would take most of the CPU's time: linear heads here
        flag = _with_backbone(_route_optimizer(flagship_train_config()), **TOY_NET)
        flag = dataclasses.replace(flag, model=dataclasses.replace(
            flag.model, gs_center_head_type="linear", gs_param_head_type="linear"))
        flag = dataclasses.replace(flag, dtype="float32", decoder=DecoderSplattingConfig(
            rasterize=RasterizeConfig(tile_px=8, dup_hw=(2, 2), max_per_tile=64,
                                      chunk=32, tile_group=4)))
        toy = [f"encoder.backbone.{k}={v}" for k, v in TOY_NET.items()]
        data = ["dataset.synthetic.input_image_shape=[32,32]",
                "dataset.synthetic.n_gaussians=256", "dataset.synthetic.n_scenes=8",
                "dataset.synthetic.n_val_scenes=1", "dataset.synthetic.n_test_scenes=1",
                "data_loader.train.batch_size=4"]
        return Sizes(flag, synthetic_pose_config(toy), B=2, T=2, V=2, size=32,
                     w_batch=4, w_T=3, w_V=2, steps=(0,),
                     train_argv=toy + data)
    # the train mode from the committed checkpoint, as chip_smoke.py's
    # train-mode phase, in the config's bf16
    return Sizes(_route_optimizer(flagship_train_config()), synthetic_pose_config(),
                 B=2, T=8, V=12, size=256, w_batch=8, w_T=4, w_V=2, steps=(0, 1),
                 train_argv=[f"checkpointing.load={ROOT / TRAINED_NPZ}"])


def moe_of(cfg):
    return _with_backbone(cfg, moe_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K,
                          moe_capacity_factor=MOE_CAPACITY)


def witness_for(sz: Sizes, route: str, world: int):
    """The witness's config for a route, and the cut it needs: GPipe needs
    a depth the stages divide (cut, never widened), TP 1 x world a head
    count the ranks divide (else the _tiny_smoke widths, heads of 4)."""
    from .training.presets import tiny_smoke_config

    cfg, bb = sz.witness, sz.witness.model.backbone
    if route == "pp":
        cut = {k: getattr(bb, k) // world * world for k in ("enc_depth", "dec_depth")}
        changed = {k: v for k, v in cut.items() if v != getattr(bb, k)}
        return _with_backbone(cfg, **cut), (f"witness depth cut {changed}" if changed
                                            else None)
    if route == "tp" and (bb.enc_num_heads % world or bb.dec_num_heads % world):
        tiny = _route_optimizer(tiny_smoke_config())
        return tiny, (f"witness heads {bb.enc_num_heads}/{bb.dec_num_heads} do not "
                      f"split over {world}: the _tiny_smoke widths (heads 4/4)")
    if route == "ep":
        return moe_of(cfg), None
    return cfg, None


def flagship_batch(dev, B: int, V: int, size: int, T: int, seed: int = 3) -> dict:
    from .training.presets import flagship_train_batch

    return flagship_train_batch(dev, B, V, size=size, T=T, seed=seed)


def witness_batch(dev, sz: Sizes, cfg) -> dict:
    size = cfg.model.backbone.img_size
    return flagship_batch(dev, sz.w_batch, sz.w_V, size, sz.w_T, seed=5)


# ---------------------------------------------------------------- records

def k1_want(cfg, S: int = 1, B: int = 1, A: int = 1) -> dict:
    """K1's launches a rank in one step of `cfg`: one a decoder block a
    micro-batch forward (twice with remat) and one backward; under S
    pipeline stages a stage runs dec_depth / S blocks over gcd(B, S)
    micro-batches (pp.decoder_micro); A accumulated micro-batches."""
    from .kernels import COUNTERS

    d = cfg.model.backbone.dec_depth // S
    calls = d * (math.gcd(B, S) if S > 1 else 1) * A
    keys = (("flash_attn", "flash_attn_bwd") if cfg.dtype == "bfloat16"
            else ("flash_attn_f32", "flash_attn_f32_bwd"))
    want = {name: 0 for name in COUNTERS}
    want.update({keys[0]: (1 + cfg.remat) * calls, keys[1]: calls})
    return want


def digest(views: dict) -> str:
    """A hash of the frames a batch holds: each view set's frame indices
    and extrinsics (made on the host from the scene), so that equal
    batches hash equal on every card."""
    import hashlib

    h = hashlib.sha1()
    for k in sorted(views):
        for f in ("index", "extrinsics"):
            h.update(views[k][f].detach().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def no_logger():
    """The train mode without a logger: what it logs is read from main's
    return value (TensorBoard's import alone takes seconds)."""
    return mock.patch("vicasplat_tpu_torch.utils.loggers.make_logger", lambda cfg: None)


def reset_counts() -> None:
    from .kernels import COUNTERS

    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def free(dev) -> None:
    """The card's memory back after a route (the CPU's own collector is
    left to run when it will)."""
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_gb(dev) -> Optional[float]:
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None


# ---------------------------------------------------------------- phase a

def k1_held(q, k, v, o, lse, do) -> dict:
    """K1's forward and backward on given inputs: the forward within
    FLASH_TOL of the plain version, the backward by holds.k1_bwd_held."""
    from .kernels.flash_attn import attention_reference, flash_attention

    fwd = (flash_attention(q, k, v).float() - attention_reference(q, k, v)).abs().max().item()
    r = k1_bwd_held(q, k, v, o, lse, do)
    return dict(r, fwd_abs=fwd, ok=fwd < FLASH_TOL and r["ok"])


def k1_line(r: dict) -> str:
    """k1_held's errors, each beside the tolerance that holds it."""
    same = r["dq_same_rounding"]
    return (f"forward {r['fwd_abs']:.3e} (tol {FLASH_TOL}); against the float32 "
            "backward " + ", ".join(f"{n} {e['rel']:.2e} (SDPA {e['sdpa_rel']:.2e}, tol "
                                    f"{e['tol']:.2e})" for n, e in r["errors"].items())
            + f"; dQ against its own rounding {same['rel']:.2e} of its largest entry (tol "
            f"{same['effective_rel']:.2e}: {FLASH_BWD_FLOOR} of the largest sum of |dS| |K|, "
            f"{same['cancel']:.1f}x dQ's largest entry, plus dQ's rounding to bf16 "
            f"{same['out_round']:.2e})")


def kernel_checks(dev) -> dict:
    """Every kernel on `dev` against its plain version, at chip_smoke.py's
    tolerances: K1 bf16 (head dim 64, the decoder's shape) forward and
    backward, K1's float32 route forward and backward, K2 on a dense
    payload of the flagship's tile grid, K3 with m, K4 at the flagship's
    rows and at 32,768 words a row (128 KB of shared memory). A launch that
    fails is recorded, not raised."""
    from .kernels import bitonic_topk, dpt_tail_reference, fused_dpt_tail, topk_reference
    from .kernels.flash_attn import (
        _forward,
        attention_backward_reference,
        attention_lse_reference,
        attention_reference,
        flash_attention_backward,
    )
    from .ops.rasterize.pallas_composite import (
        composite_reference,
        composite_tiles_kernel,
        dense_payload,
    )

    g = torch.Generator(device=dev).manual_seed(1)

    def rand(*s, dtype=torch.bfloat16):
        return torch.randn(*s, generator=g, device=dev).to(dtype)

    def k1_bf16():
        q, do = rand(1, 2056, 12, 64), rand(1, 2056, 12, 64)
        k, v = rand(1, 2064, 12, 64), rand(1, 2064, 12, 64)
        o, lse = _forward(q, k, v, with_lse=True)
        r = k1_held(q, k, v, o, lse, do)
        return r["ok"], {"fwd_abs": r["fwd_abs"], **{n: r["errors"][n]["rel"]
                                                     for n in ("dq", "dk", "dv")},
                         "dq_own_rounding": r["dq_same_rounding"]["rel"]}

    def k1_f32():
        f = torch.float32
        q, do = rand(2, 257, 12, 64, dtype=f), rand(2, 257, 12, 64, dtype=f)
        k, v = rand(2, 260, 12, 64, dtype=f), rand(2, 260, 12, 64, dtype=f)
        o, lse = _forward(q, k, v, with_lse=True)
        got = flash_attention_backward(q, k, v, o, lse, do)
        o_ref, lse_ref = attention_reference(q, k, v), attention_lse_reference(q, k)
        ref = attention_backward_reference(q, k, v, o_ref, lse_ref, do)
        errs = {n: ((a - b).abs().max() / b.abs().max()).item()
                for n, a, b in zip(("out", "lse", "dq", "dk", "dv"),
                                   (o, lse, *got), (o_ref, lse_ref, *ref))}
        return all(e < F32_TOL for e in errs.values()), errs

    def k2():
        payload = dense_payload(256, 512, 16, 16, seed=5, device=dev)
        bg = torch.zeros(3, device=dev)
        out = composite_tiles_kernel(payload, (256, 256), 16, bg, 128)
        ref = composite_reference(payload, (256, 256), 16, bg, 128)
        err = max((a - b).abs().max().item() for a, b in zip(out, ref))
        tol = RENDER_TOL + EXIT_T * payload[..., 6:10].abs().max().item()
        return err < tol, {"abs": err, "tol": tol}

    def k3():
        N, H, W, C, Fd, O = 2, 32, 256, 256, 256, 83
        args = (rand(N, H, W, C), rand(N, H, W, C).relu(),
                rand(Fd, C, 3, 3) / (9 * C) ** 0.5, rand(Fd),
                rand(O, Fd, 1, 1) / Fd ** 0.5, rand(O))
        out = fused_dpt_tail(*args).float()
        ref = dpt_tail_reference(*args).float()
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        return err < TAIL_TOL, {"rel": err}

    def k4():
        same = True
        for rows, m, keep in ((256, 2048, 512), (8, 32768, 1024)):
            w = torch.randint(-2 ** 31, 2 ** 31, (rows, m), generator=g, device=dev,
                              dtype=torch.int32)
            same &= torch.equal(bitonic_topk(w, keep), topk_reference(w, keep))
        return bool(same), {"exact": bool(same)}

    rows = {}
    with torch.cuda.device(dev):
        for name, fn in (("K1 bf16", k1_bf16), ("K1 f32", k1_f32), ("K2", k2),
                         ("K3", k3), ("K4", k4)):
            try:
                ok, detail = fn()
                sync(dev)
            except RuntimeError as e:  # a launch refused on this card
                ok, detail = False, {"error": str(e).splitlines()[0]}
            rows[name] = dict(ok=ok, **detail)
    return rows


def phase_a(world: int) -> dict:
    """kernel_checks on cuda:0, then on cuda:1 .. world-1, from this one
    process."""
    t0 = time.time()
    cards = {}
    for i in range(world):
        dev = torch.device("cuda", i)
        cards[str(dev)] = kernel_checks(dev)
        log("a", f"{dev}: " + "; ".join(
            f"{k} {'ok' if r['ok'] else 'FAILED'} "
            + ", ".join(f"{n} {v:.3e}" if isinstance(v, float) else f"{n} {v}"
                        for n, v in r.items() if n != "ok")
            for k, r in cards[str(dev)].items()))
        torch.cuda.empty_cache()
    ok = all(r["ok"] for c in cards.values() for r in c.values())
    return {"ok": ok, "cards": cards, "seconds": time.time() - t0}


# ---------------------------------------------------------------- the ranks

class Rank:
    """One process of the group: its card, the phases, and on rank 0 the
    checks and the summary."""

    def __init__(self, rank: int, world: int, dev, sz: Sizes):
        self.rank, self.world, self.dev, self.sz = rank, world, dev, sz
        self.cuda = dev.type == "cuda"
        self.results, self.failures = {}, []
        self.refs = {}

    # -- plumbing
    def gather(self, obj) -> list:
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def check(self, phase: str, ok: bool, what: str) -> None:
        if not ok and self.rank == 0:
            self.failures.append(f"{phase}: {what}")
            log(phase, f"CHECK FAILED: {what}")

    def init_model(self, cfg, seed: int = 0):
        from .models import init_vicasplat

        return init_vicasplat(cfg.model, torch.Generator(device=self.dev).manual_seed(seed),
                              self.dev)

    def steps(self, model, opt, step_fn, batch, split_group=None, steps=(0,),
              spy_k1=False) -> dict:
        """Train steps at the global step indices `steps` on `batch`; the
        first one's step_record with its update, this rank's update_record
        and K1 launches, each step's host ms, the peak allocated GB; with
        spy_k1 the first K1 backward call's inputs."""
        from .kernels import flash_attn, launch_counts
        from .kernels.flash_attn import flash_attention_backward

        seen = []

        def spy(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            do = do.to(q.dtype).contiguous()
            if not seen:
                seen.append((q, k, v, o, lse, do))
            return flash_attention_backward(q, k, v, o, lse, do)

        out = {"ms": []}
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
        for i in steps:
            first = i == steps[0]
            before = host_copy(model) if first else None
            reset_counts()
            sync(self.dev)
            t = time.perf_counter()
            if first and spy_k1:
                with mock.patch.object(flash_attn._FlashAttention, "backward",
                                       staticmethod(spy)):
                    logs = step_fn(batch, i)
            else:
                logs = step_fn(batch, i)
            sync(self.dev)
            out["ms"].append((time.perf_counter() - t) * 1e3)
            if first:
                out["launches"] = launch_counts()
                out["rec"] = step_record(model, logs, split_group, before, step_fn)
                out["bound"] = update_record(opt, before)
                del before
        out["peak_gb"] = peak_gb(self.dev)
        out["seen"] = seen
        return out

    def hold_step(self, phase: str, label: str, parts: list, ref: dict, want: dict,
                  witness: bool) -> dict:
        """Rank 0: a route's step (every rank's `steps` record) against its
        world-1 reference: the loss (STEP_TOL for a witness, else
        FLASH_BWD_FLOOR), a witness's norms and updates (FLASH_BWD_FLOOR),
        the unsplit parameters equal on every rank, K1's launches a rank,
        AdamW's bound, no non-finite gradient. Returns the row."""
        got = parts[0]["rec"]
        gaps = route_gaps(got, ref["rec"])
        held = gaps if witness else {"loss": gaps["loss"]}
        tol = {k: STEP_TOL if k == "loss" and witness else FLASH_BWD_FLOOR for k in held}
        bad = {k: (v, tol[k]) for k, v in held.items() if not v <= tol[k]}
        self.check(phase, not bad, f"{label} against world 1: {bad}")
        replicas = max(abs(p["rec"]["replica_sums"][k] - v) for p in parts[1:]
                       for k, v in got["replica_sums"].items()) if len(parts) > 1 else 0.0
        self.check(phase, replicas == 0.0, f"{label}: replicas apart by {replicas}")
        launches = [p["launches"] for p in parts]
        if self.cuda:
            self.check(phase, all(x == want for x in launches),
                       f"{label}: launches {launches}, not {want} a rank")
        ubad = update_gaps([p["bound"] for p in parts])
        self.check(phase, not ubad, f"{label}: updates outside AdamW's bound {ubad}")
        nonfinite = sum(p["rec"]["nonfinite"] for p in parts)
        self.check(phase, nonfinite == 0, f"{label}: {nonfinite} non-finite gradients")
        worst = max(held, key=lambda k: held[k] / tol[k])
        row = {"ms": [p["ms"] for p in parts], "peak_gb": [p["peak_gb"] for p in parts],
               "k1": {k: v for k, v in launches[0].items() if v},
               "loss": got["loss"], "ref_loss": ref["rec"]["loss"],
               "gaps": {"loss": gaps["loss"], "grad_norm": gaps.get("grad_norm"),
                        "worst_norm": max((v for k, v in gaps.items()
                                           if k.startswith("norm")), default=None)},
               "worst_held": (worst, held[worst], tol[worst]),
               "max_update_ratio": max(g["ratio"] for p in parts
                                       for g in p["bound"]["groups"].values())}
        if self.rank == 0:
            ms = row["ms"][0]
            norms = ("" if "grad_norm" not in gaps else
                     f", grad_norm {gaps['grad_norm']:.2e}, worst norm "
                     f"{row['gaps']['worst_norm']:.2e}")
            log(phase, f"{label}: loss {got['loss']:.6f} (world 1 {ref['rec']['loss']:.6f}), "
                f"gaps loss {gaps['loss']:.2e}{norms}; held {worst} {held[worst]:.2e} "
                f"(tol {tol[worst]:.0e}); step ms {', '.join(f'{x:.1f}' for x in ms)} "
                f"(world 1 {', '.join(f'{x:.1f}' for x in ref['ms'])}); peak GB "
                + ", ".join("n/a" if x is None else f"{x:.2f}" for x in row["peak_gb"])
                + f"; K1 a rank {row['k1']}; max |update|/(lr mult) "
                f"{row['max_update_ratio']:.4f}")
        return row

    # -- references
    def ref_jobs(self) -> list:
        """The world-1 references: (name, rank that computes it); a
        witness that needs no cut for GPipe or TP is "w" itself."""
        owner = {"flag_ddp": 0, "flag": 1, "moe": 2, "train": 3, "train_whole": 2,
                 "w": 2, "w_pp": 3, "w_tp": 1, "w_ep": 1}
        return [(n, r % self.world) for n, r in owner.items()
                if n not in ("w_pp", "w_tp") or witness_for(self.sz, n[2:], self.world)[1]]

    def ref(self, name: str) -> dict:
        sz, dev = self.sz, self.dev
        from .training import AdamW, make_train_step

        if name.startswith("train"):
            return self.train_mode_world1(whole=name == "train_whole")
        if name == "moe":  # the loss alone: world x (T + V) do not fit one card
            from .training.step import compute_loss

            cfg = moe_of(sz.flagship)
            model = self.init_model(cfg)
            batch = flagship_batch(dev, self.world, sz.V, sz.size, sz.T)
            sync(dev)
            t = time.perf_counter()
            with torch.no_grad():
                loss, _ = compute_loss(model, cfg, batch, 0)
            rec = {"rec": {"loss": float(loss)}, "ms": [(time.perf_counter() - t) * 1e3],
                   "peak_gb": peak_gb(dev)}
            del model
            return rec
        if name.startswith("flag"):
            A = self.world if name == "flag_ddp" else 1
            cfg = dataclasses.replace(sz.flagship, accumulate_steps=A)
            batch = flagship_batch(dev, A * sz.B, sz.V, sz.size, sz.T)
            steps = sz.steps
        else:
            cfg, _ = witness_for(sz, name[2:] if name != "w" else "", self.world)
            batch = witness_batch(dev, sz, cfg)
            steps = (0,)
        model = self.init_model(cfg)
        opt = AdamW(model, cfg.optimizer)
        r = self.steps(model, opt, make_train_step(cfg, model, opt), batch, steps=steps)
        r["want"] = k1_want(cfg, A=cfg.accumulate_steps)
        r.pop("seen")
        del model, opt
        return r

    def phase_refs(self) -> None:
        t0 = time.time()
        mine = {}
        for name, owner in self.ref_jobs():
            if owner == self.rank:
                mine[name] = self.ref(name)
                free(self.dev)
        for part in self.gather(mine):
            self.refs.update(part)
        if self.rank == 0:
            for name, r in self.refs.items():
                if name.startswith("train"):
                    continue
                ok = r["rec"]["loss"] == r["rec"]["loss"]
                self.check("ref", ok and (name == "moe" or not r["rec"]["nonfinite"]),
                           f"{name}: non-finite")
                if self.cuda and "want" in r:
                    self.check("ref", r["launches"] == r["want"],
                               f"{name}: launches {r['launches']}, not {r['want']}")
                if "bound" in r:
                    bad = update_gaps([r["bound"]])
                    self.check("ref", not bad, f"{name}: updates outside AdamW's bound {bad}")
            log("ref", f"world-1 references on their own cards in {time.time() - t0:.1f} s: "
                + "; ".join(f"{n} loss {r['rec']['loss']:.6f}, ms "
                            + ", ".join(f"{x:.1f}" for x in r["ms"])
                            + ("" if r.get("peak_gb") is None else
                               f", peak {r['peak_gb']:.2f} GB")
                            for n, r in self.refs.items() if not n.startswith("train")))
            self.results["ref"] = {n: {k: v for k, v in r.items() if k != "want"}
                                   for n, r in self.refs.items() if not n.startswith("train")}

    # -- the routes
    def route(self, phase: str, label: str, cfg, build, batch, witness: bool,
              ref: str, split=None, want=None, **kw) -> dict:
        """One route: the model from seed 0, sharded by `build(model)` (which
        returns the train step's keyword arguments), the optimizer after it,
        the steps, every rank's record held on rank 0 against the
        reference."""
        from .training import AdamW, make_train_step

        model = self.init_model(cfg)
        step_kw = build(model) or {}
        opt = AdamW(model, cfg.optimizer)
        step_fn = make_train_step(cfg, model, opt, **step_kw)
        group = split(model) if split else None
        r = self.steps(model, opt, step_fn, batch, group,
                       steps=(0,) if witness else self.sz.steps, **kw)
        seen = r.pop("seen")
        parts = self.gather(r)
        row = None
        if self.rank == 0:
            row = self.hold_step(phase, label, parts, self.refs[ref],
                                 want or k1_want(cfg), witness)
        r["seen"] = seen
        self.last = (model, step_fn, r)
        return row

    def done_route(self) -> None:
        self.last = None
        free(self.dev)

    def phase_ddp(self) -> None:
        from . import parallel as par
        from .training.step import BUCKET_BYTES

        sz, dev = self.sz, self.dev
        t0 = time.time()
        mesh = par.make_mesh()
        group = mesh.get_group()
        batch = par.shard_batch(mesh, flagship_batch(dev, self.world * sz.B, sz.V,
                                                     sz.size, sz.T))
        res = {"flagship": self.route("b", f"DDP flagship {self.world} x {sz.B} x "
                                      f"({sz.T} + {sz.V})", sz.flagship,
                                      lambda m: {"ddp_group": group}, batch, False,
                                      "flag_ddp")}
        model = self.last[0]
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        res["all_reduce"] = {name: self.bus_bandwidth(grads, group, b)
                             for name, b in (("one flat buffer", None),
                                             ("the step's buckets", BUCKET_BYTES),
                                             ("DDP's bucket size", 25 << 20))}
        del model, grads
        self.done_route()
        cfg, _ = witness_for(sz, "", self.world)
        res["witness"] = self.route("b", "DDP witness", cfg,
                                    lambda m: {"ddp_group": group},
                                    par.shard_batch(mesh, witness_batch(dev, sz, cfg)),
                                    True, "w")
        self.done_route()
        if self.rank == 0:
            log("b", f"all-reduce of the flagship's gradients: " + "; ".join(
                f"{k}: {v['gbytes']:.3f} GB in {v['buckets']} buckets, "
                + ("not measured (world 1)" if v["ms"] is None else
                   f"{v['ms']:.2f} ms, bus {v['bus_gb_s']:.1f} GB/s "
                   f"({v['bus_gb_s'] * 1e9 / NVLINK_BYTES_PER_S:.3f} of NVLink's 450)")
                for k, v in res["all_reduce"].items()) + f" ({time.time() - t0:.1f} s)")
            self.results["b"] = res

    def bus_bandwidth(self, tensors, group, bucket_bytes: Optional[int]) -> dict:
        """The all-reduce of `tensors` timed by CUDA events on this rank (the
        median of 3 after a warm-up): with bucket_bytes, training/step.py's
        reduction (each bucket of at most bucket_bytes concatenated,
        all-reduced and copied back); without, NCCL's alone on one flat
        buffer. Bus bandwidth: 2 (n - 1) / n x bytes over the time."""
        from .training.step import _all_reduce_div

        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        buckets = max(1, math.ceil(nbytes / bucket_bytes)) if bucket_bytes else 1
        out = {"gbytes": nbytes / 1e9, "buckets": buckets, "ms": None, "bus_gb_s": None}
        n = dist.get_world_size(group)
        if n == 1 or not self.cuda:
            return out
        if bucket_bytes:
            work = [t.detach().clone() for t in tensors]
            patch = mock.patch("vicasplat_tpu_torch.training.step.BUCKET_BYTES",
                               bucket_bytes)

            def reduce():
                _all_reduce_div(work, group, 1)
        else:
            work = torch.cat([t.detach().reshape(-1) for t in tensors])
            patch = nullcontext()

            def reduce():
                dist.all_reduce(work, group=group)
        times = []
        with patch:
            for i in range(4):
                dist.barrier(group=group, device_ids=[self.dev.index])
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                reduce()
                b.record()
                torch.cuda.synchronize(self.dev)
                if i:
                    times.append(a.elapsed_time(b))
        del work
        out["ms"] = float(np.median(times))
        out["bus_gb_s"] = 2 * (n - 1) / n * nbytes / (out["ms"] * 1e-3) / 1e9
        return out

    def phase_fsdp(self) -> None:
        from . import parallel as par
        from .parallel.memory_proof import reckon
        from .parallel.mesh import shard_params_fsdp

        sz, dev = self.sz, self.dev
        mesh = par.make_mesh()
        batch = par.shard_batch(mesh, flagship_batch(dev, self.world * sz.B, sz.V,
                                                     sz.size, sz.T))

        def shard(m):
            shard_params_fsdp(mesh, m)

        res = {"flagship": self.route("c", "FSDP2 flagship", sz.flagship, shard, batch,
                                      False, "flag_ddp", split=lambda m: m.fsdp_group)}
        self.done_route()
        cfg, _ = witness_for(sz, "", self.world)
        res["witness"] = self.route("c", "FSDP2 witness", cfg, shard,
                                    par.shard_batch(mesh, witness_batch(dev, sz, cfg)),
                                    True, "w", split=lambda m: m.fsdp_group)
        self.done_route()
        if self.rank == 0:
            name = f"fsdp{self.world}"
            row = reckon(configs=(name, f"dp{self.world}"))["configs"]
            res["reckoning_gib"] = {k: v["state_gib"] for k, v in row.items()}
            log("c", f"FSDP2 flagship peak a rank "
                + ", ".join("n/a" if x is None else f"{x:.2f}"
                            for x in res["flagship"]["peak_gb"])
                + f" GB; memory_proof's state a rank: " + ", ".join(
                    f"{k} {v:.2f} GiB" for k, v in res["reckoning_gib"].items()))
            self.results["c"] = res

    def phase_tp(self) -> None:
        from . import parallel as par

        sz, dev = self.sz, self.dev
        res = {}
        shapes = [(1, self.world)] + ([(2, self.world // 2)] if self.world % 2 == 0
                                      and self.world > 2 else [])
        for n_data, n_model in shapes:
            mesh = par.make_mesh_2d(n_data, n_model)
            batch = par.shard_batch(mesh, flagship_batch(dev, sz.B, sz.V, sz.size, sz.T))

            def shard(m):
                par.shard_params_tp(mesh, m)

            def split(m):
                return next(p._grad_split.norm for p in m.parameters()
                            if hasattr(p, "_grad_split"))

            key = f"{n_data}x{n_model}"
            res[key] = self.route("d", f"TP {key} flagship", sz.flagship, shard, batch,
                                  False, "flag", split=split)
            self.done_route()
            cfg, cut = witness_for(sz, "tp" if n_data == 1 else "", n_model)
            if cut and self.rank == 0:
                log("d", f"TP {key}: {cut}")
            res[f"{key} witness"] = self.route(
                "d", f"TP {key} witness", cfg, shard,
                par.shard_batch(mesh, witness_batch(dev, sz, cfg)), True,
                "w_tp" if cut else "w", split=split)
            self.done_route()
        if self.rank == 0:
            self.results["d"] = res

    def phase_sp(self) -> None:
        from . import parallel as par

        sz, dev = self.sz, self.dev
        mesh = par.make_mesh_sp(1, self.world)
        res = {"flagship": self.route(
            "e", f"SP 1x{self.world} flagship", sz.flagship,
            lambda m: {"sp_mesh": mesh}, flagship_batch(dev, sz.B, sz.V, sz.size, sz.T),
            False, "flag", spy_k1=self.cuda)}
        seen = self.last[2]["seen"]
        if self.cuda:
            parts = self.gather(k1_held(*seen[0]) if seen else None)
            if self.rank == 0:
                res["k1"] = parts
                log("e", "K1 on the SP step's own inputs, each rank: " + "; ".join(
                    f"{p['shape']}: {k1_line(p)}" for p in parts))
                bad = [i for i, p in enumerate(parts) if p is None or not p["ok"]]
                self.check("e", not bad, f"K1 held on the SP inputs failed on ranks {bad}")
        del seen
        self.done_route()
        cfg, _ = witness_for(sz, "", self.world)
        res["witness"] = self.route("e", f"SP 1x{self.world} witness", cfg,
                                    lambda m: {"sp_mesh": mesh},
                                    witness_batch(dev, sz, cfg), True, "w")
        self.done_route()
        if self.rank == 0:
            self.results["e"] = res

    def phase_ep(self) -> None:
        from . import parallel as par

        sz, dev = self.sz, self.dev
        mesh = par.make_mesh_ep(1, self.world)

        def shard(m):
            par.shard_params_ep(mesh, m)

        def split(m):
            return next(p._grad_split.norm for p in m.parameters()
                        if hasattr(p, "_grad_split"))

        axes = ("data", "expert")
        batch = par.shard_batch(mesh, flagship_batch(dev, self.world, sz.V, sz.size, sz.T),
                                axes)
        res = {"flagship": self.route(
            "f", f"EP 1x{self.world} MoE flagship (E {MOE_EXPERTS}, "
            f"{MOE_EXPERTS // self.world} a card)", moe_of(sz.flagship), shard, batch,
            False, "moe", split=split)}
        self.done_route()
        cfg, _ = witness_for(sz, "ep", self.world)
        res["witness"] = self.route("f", f"EP 1x{self.world} witness (MoE)", cfg, shard,
                                    par.shard_batch(mesh, witness_batch(dev, sz, cfg), axes),
                                    True, "w_ep", split=split)
        self.done_route()
        if self.rank == 0:
            self.results["f"] = res

    @contextmanager
    def timed_pipeline(self, spans: list):
        """parallel/pp.py's pipeline with CUDA events around each
        micro-batch's blocks, forward (`run`) and backward (its
        torch.autograd.backward), and around the whole forward and the
        whole backward: (kind, start, end) into `spans`."""
        from .parallel import pp

        base = pp._Pipeline

        def ev():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        class Timed(base):
            @staticmethod
            def forward(ctx, plan, anchor, *xs):
                run = plan["run"]

                def timed_run(h):
                    a = ev()
                    out = run(h)
                    spans.append(("busy", a, ev()))
                    return out

                a = ev()
                out = base.forward(ctx, dict(plan, run=timed_run), anchor, *xs)
                spans.append(("span", a, ev()))
                return out

            @staticmethod
            def backward(ctx, *grads):
                inner = torch.autograd.backward

                def timed_backward(*args, **kw):
                    a = ev()
                    inner(*args, **kw)
                    spans.append(("busy", a, ev()))

                a = ev()
                with mock.patch.object(torch.autograd, "backward", timed_backward):
                    out = base.backward(ctx, *grads)
                spans.append(("span", a, ev()))
                return out

        with mock.patch.object(pp, "_Pipeline", Timed):
            yield

    def phase_pp(self) -> None:
        from . import parallel as par

        sz, dev = self.sz, self.dev
        S = self.world
        mesh = par.make_mesh_pipe(S)
        group = mesh.get_group()

        def shard(m):
            par.shard_params_pp(mesh, m.backbone.enc_blocks)
            par.shard_params_pp(mesh, m.backbone.dec_blocks)
            return {"pipeline_group": group, "pipeline_n_micro": S}

        spans = []
        res = {}
        ctx = self.timed_pipeline(spans) if self.cuda else nullcontext()
        with ctx:
            bb = sz.flagship.model.backbone
            res["flagship"] = self.route(
                "g", f"GPipe {S} stages flagship ({bb.enc_depth // S} encoder and "
                f"{bb.dec_depth // S} decoder blocks a stage)", sz.flagship, shard,
                flagship_batch(dev, sz.B, sz.V, sz.size, sz.T), False, "flag",
                split=lambda m: group, want=k1_want(sz.flagship, S=S, B=sz.B))
        self.done_route()
        stage_span = None
        if self.cuda:  # the last (warm) step's spans: each step records alike
            torch.cuda.synchronize(dev)
            last = spans[len(spans) - len(spans) // len(sz.steps):]
            span = sum(a.elapsed_time(b) for k, a, b in last if k == "span")
            busy = sum(a.elapsed_time(b) for k, a, b in last if k == "busy")
            stage_span = {"span_ms": span, "in_calls_ms": busy,
                      "outside_share": 1 - busy / span if span else None}
        spans.clear()
        stage_spans = self.gather(stage_span)
        cfg, cut = witness_for(sz, "pp", S)
        if cut and self.rank == 0:
            log("g", f"GPipe witness: {cut}")
        res["witness"] = self.route(
            "g", "GPipe witness", cfg, shard, witness_batch(dev, sz, cfg), True,
            "w_pp" if cut else "w",
            split=lambda m: group, want=k1_want(cfg, S=S, B=sz.w_batch))
        self.done_route()
        if self.rank == 0:
            res["spans"] = stage_spans
            if self.cuda:
                log("g", "each stage's host+device span share outside its blocks' calls "
                    "in the warm step (CUDA events recorded by the host; a call's dispatch "
                    "gaps count as inside it, so this is no measure of GPipe's bubble): "
                    + "; ".join(f"stage {i} {b['outside_share']:.3f} of {b['span_ms']:.1f} "
                                f"ms (in calls {b['in_calls_ms']:.1f})"
                                for i, b in enumerate(stage_spans)))
            self.results["g"] = res

    def phase_render(self) -> None:
        from . import parallel as par
        from .decoder.splatting import decoder_forward, flatten_gaussians
        from .kernels import launch_counts
        from .ops.rasterize import RasterizeConfig
        from .serving import InferenceEngine

        sz, dev = self.sz, self.dev
        t0 = time.time()
        mesh = par.make_mesh()
        cfg = dataclasses.replace(sz.flagship.model, head_tail_backend="pallas")
        dec = dataclasses.replace(sz.flagship.decoder, rasterize=dataclasses.replace(
            sz.flagship.decoder.rasterize, backend="pallas", binning="origin")
            if self.cuda else sz.flagship.decoder.rasterize)
        model = self.init_model(dataclasses.replace(sz.flagship, model=cfg))
        eng = InferenceEngine(cfg, model=model, dtype=torch.bfloat16 if self.cuda
                              else torch.float32, decoder=dec, view_mesh=mesh,
                              device=dev)
        batch = flagship_batch(dev, 1, sz.V, sz.size, sz.T)
        ctx, tgt = batch["context"], batch["target"]
        scene = eng.reconstruct(ctx["image"], ctx["intrinsics"])
        hw = (sz.size, sz.size)
        reset_counts()
        sync(dev)
        t = time.perf_counter()
        out = eng.render(scene, tgt["extrinsics"], tgt["intrinsics"], hw)
        sync(dev)
        ms = (time.perf_counter() - t) * 1e3
        launches = launch_counts()
        per_rank = -(-sz.V // self.world)
        want = dict({k: 0 for k in launches}, **({"composite": per_rank,
                                                  "bitonic_topk": per_rank}
                                                 if self.cuda else {}))
        parts = self.gather({"launches": launches, "ms": ms})
        if self.rank == 0:
            with torch.no_grad():
                V = tgt["extrinsics"].shape[1]
                one = decoder_forward(dec, flatten_gaussians(scene.gaussians),
                                      tgt["extrinsics"],
                                      tgt["intrinsics"], torch.full((1, V), 0.05, device=dev),
                                      torch.full((1, V), 100.0, device=dev), hw)
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(out, one))
            same = all(torch.equal(a, b) for a, b in zip(out, one))
            self.check("h", same, f"view-sharded render against one card: max |d| {err}")
            ok = all(p["launches"] == want for p in parts)
            self.check("h", ok, f"render launches {[p['launches'] for p in parts]}, "
                       f"not {want} a rank")
            self.results["h"] = {"views": sz.V, "max_abs": err, "bitwise": same,
                                 "ms": [p["ms"] for p in parts],
                                 "launches": parts[0]["launches"]}
            log("h", f"{sz.V} views over {self.world} ranks ({per_rank} a rank), "
                f"accelerator configuration: bit for bit {same} (max |d| {err:.3e}) "
                f"against the one-card render; ms a rank "
                + ", ".join(f"{p['ms']:.1f}" for p in parts)
                + f"; launches a rank {dict((k, v) for k, v in launches.items() if v)} "
                f"({time.time() - t0:.1f} s)")
        del eng, model, scene, out
        free(dev)

    # -- main.py's train mode
    def train_argv(self, out: pathlib.Path, steps: int, resume: bool = False,
                   accumulate: int = 1) -> list:
        return ["+experiment=synthetic_pose", "mode=train", *self.sz.train_argv,
                f"trainer.max_steps={steps}",
                f"checkpointing.every_n_train_steps={CKPT_EVERY}",
                "checkpointing.save_weights_only=false", "trainer.val_check_interval=0",
                "train.print_log_every_n_steps=1", "wandb.mode=disabled",
                f"train.accumulate_grad_batches={accumulate}",
                f"output_dir={out}", f"checkpointing.output_dir={out}/ckpts",
                f"checkpointing.resume={str(resume).lower()}"]

    def train_mode(self, out: pathlib.Path, device: str, writer: bool,
                   accumulate: int = 1) -> dict:
        """main.py's train mode: CKPT_EVERY steps, then a resumed run from
        their checkpoint to TRAIN_STEPS (its loader starts the data over,
        as JAX's main does). Each logged step's scalars, each step's batch
        as `digest`s of the frames it holds (cut in `self.world` equal
        parts at world 1), the checkpoints after the first run, the steps
        each run ended at, the seconds; the `writer` (the rank that logs
        and checkpoints) then removes the checkpoints."""
        from . import main as tmain
        from .training import make_train_step

        digests = []
        parts = self.world if int(os.environ["WORLD_SIZE"]) == 1 else 1

        def recording(*a, **kw):
            step_fn = make_train_step(*a, **kw)

            def step(batch, i, **kw2):
                m = batch["context"]["index"].shape[0] // parts
                digests.append([digest({k: {f: batch[k][f][j * m:(j + 1) * m]
                                            for f in ("index", "extrinsics")}
                                        for k in ("context", "target")})
                                for j in range(parts)])
                return step_fn(batch, i, **kw2)
            return step

        t = time.perf_counter()
        with no_logger(), mock.patch("vicasplat_tpu_torch.training.make_train_step",
                                     recording):
            first = tmain.main(self.train_argv(out, CKPT_EVERY, accumulate=accumulate),
                               device=device)
            ckpts = sorted(p.name for p in (out / "ckpts").glob("*.npz"))
            second = tmain.main(self.train_argv(out, TRAIN_STEPS, resume=True,
                                                accumulate=accumulate), device=device)
        if writer:  # the full train states, read back by the resume: no longer needed
            shutil.rmtree(out / "ckpts")
        return {"logs": [{k: float(v) for k, v in x.items()}
                         for x in first["logs"] + second["logs"]],
                "digests": digests, "checkpoints": ckpts,
                "steps": [first["step"], second["step"]], "s": time.perf_counter() - t}

    def train_mode_world1(self, whole: bool) -> dict:
        """The train mode at world 1 on the same global batch: in `world`
        micro-batches (each the size of a rank's part: the reference the
        group is held to), or whole (a witness of bf16's rounding: the
        same steps with other batch shapes)."""
        with mock.patch.dict(os.environ, {"WORLD_SIZE": "1"}):
            return self.train_mode(OUT / f"train_reference{'_whole' * whole}",
                                   str(self.dev), True, accumulate=1 if whole else self.world)

    def phase_train(self) -> None:
        r = self.train_mode(OUT / f"train_world{self.world}",
                            "cuda" if self.cuda else "cpu", self.rank == 0)
        got, ckpts, s = r["logs"], r["checkpoints"], r["s"]
        digests = self.gather(r["digests"])
        if self.rank != 0:
            return
        ref, whole = self.refs["train"], self.refs["train_whole"]
        steps = [x["step"] for x in got]
        self.check("i", steps == [x["step"] for x in ref["logs"]] == list(
            range(1, TRAIN_STEPS + 1)), f"logged steps {steps}")
        # each rank's part of each step's batch is world 1's part of it, and
        # the resumed run starts the data over: steps 3, 4 see 1, 2's frames
        mine = [[d[i][0] for d in digests] for i in range(TRAIN_STEPS)]
        self.check("i", mine == ref["digests"] == whole["digests"]
                   and mine[CKPT_EVERY:] == mine[:TRAIN_STEPS - CKPT_EVERY],
                   f"the batches' frames differ: ranks {mine}, world 1 {ref['digests']}, "
                   f"whole {whole['digests']}")

        def gaps(a_logs, b_logs):
            g = [{k: (abs(a[k] - b[k]) if k == "psnr" else rel(a[k], b[k]))
                  for k in TRAIN_LOSS_TOL} for a, b in zip(a_logs, b_logs)]
            return {k: max(x[k] for x in g) for k in TRAIN_LOSS_TOL}

        worst = gaps(got, ref["logs"])
        bad = {k: (v, TRAIN_LOSS_TOL[k]) for k, v in worst.items()
               if not v <= TRAIN_LOSS_TOL[k]}
        self.check("i", not bad, f"train mode at world {self.world} against world 1 in "
                   f"{self.world} micro-batches: {bad}")
        self.check("i", f"step_{CKPT_EVERY:08d}.npz" in ckpts,
                   f"no checkpoint at step {CKPT_EVERY}: {ckpts}")
        self.check("i", r["steps"] == [CKPT_EVERY, TRAIN_STEPS],
                   f"the runs ended at steps {r['steps']}")
        witness = gaps(whole["logs"], ref["logs"])
        self.results["i"] = {"logs": got, "ref_logs": ref["logs"],
                             "whole_logs": whole["logs"], "worst": worst,
                             "whole_vs_micro": witness, "vs_whole": gaps(got, whole["logs"]),
                             "checkpoints": ckpts, "s": s, "ref_s": ref["s"]}

        def losses(logs):
            return ", ".join(f"{x['loss']:.5f}" for x in logs)

        log("i", f"main.py train mode, synthetic_pose, world {self.world}: "
            f"{CKPT_EVERY} steps, checkpoints {ckpts}, then resumed to step "
            f"{TRAIN_STEPS}, as world 1 did in {self.world} micro-batches; the same "
            f"frames a rank at every step; losses {losses(got)} (world 1 "
            f"{losses(ref['logs'])}); worst gaps " + ", ".join(
                f"{k} {v:.2e}" for k, v in worst.items())
            + f" (tol {TRAIN_LOSS_TOL}); {s:.1f} s (world 1 {ref['s']:.1f} s). "
            f"Rounding witness, not held: world 1 on the whole batch (losses "
            f"{losses(whole['logs'])}) against world 1 in micro-batches: " + ", ".join(
                f"{k} {v:.2e}" for k, v in witness.items()))

    def run(self) -> None:
        for name, fn in (("ref", self.phase_refs), ("b", self.phase_ddp),
                         ("c", self.phase_fsdp), ("d", self.phase_tp),
                         ("e", self.phase_sp), ("f", self.phase_ep),
                         ("g", self.phase_pp), ("h", self.phase_render),
                         ("i", self.phase_train)):
            t0 = time.time()
            fn()
            free(self.dev)
            dist.barrier(device_ids=[self.dev.index] if self.cuda else None)
            if self.rank == 0:
                log(name, f"phase done in {time.time() - t0:.1f} s")


def _rank_main(rank: int, world: int, device: str, port: int, t_start: float) -> None:
    global T_START
    T_START = t_start
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if rank:  # rank 0 writes to the run's output, the others to their logs
        fd = os.open(OUT / f"rank{rank}.log", os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
    if device == "cpu":
        torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False  # float32 convs in float32
    from .parallel.mesh import init_distributed

    init_distributed(device, timeout_s=GROUP_TIMEOUT_S)
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")
    r = Rank(rank, world, dev, sizes(device))
    try:
        r.run()
        if rank == 0:
            (OUT / "result.json").write_text(json.dumps(
                {"failures": r.failures, "results": r.results}, indent=1, default=str))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _smi(*args) -> str:
    try:
        return subprocess.run(["nvidia-smi", *args], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _run_ranks(world: int, device: str) -> Optional[str]:
    """Start the ranks and wait for them; stop every one when one fails
    or the run passes RUN_LIMIT_S. Returns what went wrong, or None."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(world, device, _free_port(), T_START),
                             nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1):
            if time.time() - T_START > RUN_LIMIT_S:
                return f"the run passed {RUN_LIMIT_S} s"
    except Exception as e:  # a rank raised or died: join stopped the others
        return f"{type(e).__name__}: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4,
                    help="ranks, one a card (default 4)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: NCCL over the cards; cpu: gloo at toy sizes")
    args = ap.parse_args(argv)
    world = args.world
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("multichip: torch.cuda.is_available() is false; pass --device cpu",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < world:
            print(f"multichip: --world {world} needs {world} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    summary = {"world": world, "device": args.device}
    if args.device == "cuda":
        for i, line in enumerate(_smi("--query-gpu=name,power.limit",
                                      "--format=csv,noheader").splitlines()):
            print(f"card {i}: {line}", flush=True)
        print(_smi("topo", "-m"), flush=True)
        summary["cards"] = [torch.cuda.get_device_name(i) for i in range(world)]
        from .kernels import build

        build.build_all(KERNELS)
        log("build", ", ".join(f"{n} {build.build_seconds.get(n, 0.0):.1f} s"
                               for n in KERNELS))
        summary["a"] = phase_a(world)
    problem = _run_ranks(world, args.device)
    result_path = OUT / "result.json"
    if problem is None and not result_path.exists():
        problem = "rank 0 wrote no result"
    if problem is not None:
        print(f"multichip: {problem}", flush=True)
        for p in sorted(OUT.glob("rank*.log")):
            print(f"--- the end of {p.name}:\n{p.read_text()[-3000:]}", flush=True)
        failures = [problem]
    else:
        res = json.loads(result_path.read_text())
        failures = res["failures"]
        summary["results"] = res["results"]
    if "a" in summary and not summary["a"]["ok"]:
        failures = ["a: a kernel failed on some card"] + failures
    summary.update(failures=failures, seconds=time.time() - T_START)
    (OUT / "summary.json").write_text(json.dumps(summary, indent=1, default=str))
    for f in failures:
        print(f"FAILED {f}", flush=True)
    print(json.dumps({"ok": not failures, "world": world, "device": args.device,
                      "failures": len(failures), "seconds": round(summary["seconds"], 1)}),
          flush=True)
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
