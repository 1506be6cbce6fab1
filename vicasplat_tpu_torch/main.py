"""Train and test CLI (port of vicasplat_tpu/main.py):

    python -m vicasplat_tpu_torch.main +experiment=synthetic_pose mode=train \
        checkpointing.load=outputs/synthetic_pose/ckpt_committed/weights_latest.npz
    python -m vicasplat_tpu_torch.main +experiment=synthetic_pose mode=test \
        checkpointing.load=outputs/synthetic_pose/ckpt_committed/weights_latest.npz \
        dataset.synthetic.n_scenes=4096 test.output_path=<dir>

Train (`train`, JAX `:61-293`): the train loader's batches through the train
step (bf16 compute over float32 parameters, AdamW), a log line and the
logger's scalars every `train.print_log_every_n_steps`, a checkpoint every
`checkpointing.every_n_train_steps` (weights only, or with
`save_weights_only: false` the full state), validation visuals every
`trainer.val_check_interval`, and a resume from the newest checkpoint with
`checkpointing.resume=true`. Under `torchrun --nproc_per_node=N` (the
environment's WORLD_SIZE > 1) the step is data-parallel by DDP, as JAX
shards the batch over its data mesh: every rank draws the same global
batch from the same seed and takes its slice (`parallel.shard_batch`), and
rank 0 alone prints, logs, checkpoints and renders the validation visuals.
With `train.distiller` set (the `distill`
experiment), a frozen DUSt3R teacher (`_maybe_distiller`) joins the step:
"distill_only" before `train.distill_only_steps`, "distill" up to
`train.distill_max_steps`, then "full" (`training.step.pick_phase`).

Test (`test`, JAX `:364-505`): per scene of the test split, encode the
context (bf16 over float32 weights), align the target poses, render and
score them (evaluation/nvs_eval.py), and save its outputs; then write
`scores_all_avg.json` (each score's nanmean, with `n_scenes` and each
score's `n_valid`), `benchmark.json` (seconds of the sections `encoder`,
`pose_align` and `decoder`) and `peak_memory.json` under
`test.output_path`.

Both run on the card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

import numpy as np
import torch


def build_all(cfg, device="cuda"):
    """(TrainConfig, model, AdamW) from the root config, as the JAX
    package's `build_all`: the optimizer's schedule length and clip come
    from `trainer`, the model's weights from the seed or from
    `checkpointing.load`."""
    from .models import init_vicasplat
    from .training import AdamW, TrainConfig
    from .utils.checkpointing import load_weights

    opt_cfg = dataclasses.replace(
        cfg.optimizer,
        cosine_annealing=cfg.train.lr_cosine_annealing or cfg.optimizer.cosine_annealing,
        max_steps=(cfg.trainer.max_steps if cfg.trainer.max_steps > 0
                   else cfg.optimizer.max_steps),
        gradient_clip_val=cfg.trainer.gradient_clip_val,
        new_param_keywords=tuple(cfg.train.new_param_keywords))
    train_cfg = TrainConfig(
        model=cfg.encoder, decoder=cfg.decoder, optimizer=opt_cfg,
        dtype="bfloat16" if cfg.trainer.precision == "bfloat16" else "float32",
        remat=cfg.train.gradient_checkpointing, remat_policy=cfg.train.remat_policy,
        distill_weight=cfg.train.distill_weight,
        distill_only_steps=cfg.train.distill_only_steps,
        distill_max_steps=cfg.train.distill_max_steps,
        accumulate_steps=cfg.train.accumulate_grad_batches)
    if cfg.loss.camera is None:
        raise NotImplementedError("a training config without loss.camera: the port's "
                                  "step always takes the camera loss")
    for name in ("mse", "camera", "lpips"):
        if getattr(cfg.loss, name) is not None:
            train_cfg = dataclasses.replace(train_cfg, **{name: getattr(cfg.loss, name)})
    model = init_vicasplat(cfg.encoder, torch.Generator(device).manual_seed(cfg.seed),
                           device)
    if cfg.checkpointing.load:
        print(f"loading weights from {cfg.checkpointing.load}")
        load_weights(cfg.checkpointing.load, model)
    return train_cfg, model, AdamW(model, opt_cfg)


def _maybe_lpips(cfg, device="cuda"):
    """The LPIPS function when the experiment asks for it and its weights
    are in the repository, else None (JAX `main.py:345-352`); its VGG
    weights are not in the repository."""
    if cfg.loss.lpips is None:
        return None
    from .loss.lpips import make_lpips_fn

    try:
        return make_lpips_fn(device=device)
    except FileNotFoundError as e:
        print(f"lpips unavailable ({e}); continuing without perceptual loss")
        return None


def teacher_config(cfg):
    """The teacher's widths: DUSt3R's ViT-L encoder and two 12 x 768
    decoders, at the student's image size (JAX `main.py:321`)."""
    from .models.dust3r import Dust3RConfig

    return Dust3RConfig(img_size=cfg.encoder.backbone.img_size)


def _maybe_distiller(cfg, device="cuda"):
    """The frozen teacher of the distillation stage (JAX `main.py:303-340`)
    when `train.distiller` names one, else None: the DUSt3R / MASt3R
    checkpoint at `$DISTILLER_CKPT` or `checkpoints/<distiller>.ckpt`
    through `utils/ckpt_convert`, or, when the file is missing, random
    weights from a generator seeded 1, with the JAX package's warning. The
    teacher computes in bf16 over float32 weights, as JAX's does."""
    if not cfg.train.distiller:
        return None
    import os

    from .models.dust3r import Dust3R, init_dust3r, make_teacher_fn
    from .utils.ckpt_convert import convert_dust3r_state_dict, read_torch_checkpoint

    path = pathlib.Path(os.environ.get("DISTILLER_CKPT",
                                       f"checkpoints/{cfg.train.distiller}.ckpt"))
    d_cfg = teacher_config(cfg)
    if path.exists():
        with torch.device(device):
            model = Dust3R(d_cfg)
        model.load_state_dict(convert_dust3r_state_dict(read_torch_checkpoint(path)),
                              strict=True)
        print(f"loaded distiller weights from {path}")
    else:
        print(f"WARNING: distiller checkpoint {path} missing — "
              "using random teacher weights (distillation will be meaningless)")
        model = init_dust3r(d_cfg, torch.Generator(device).manual_seed(1), device)
    return make_teacher_fn(model, dtype=torch.bfloat16)


def train(cfg, device="cuda"):
    """The train loop (JAX `main.train`); returns {"model", "optimizer",
    "step", "logs": [each logged step's scalars]}."""
    from .data.data_module import DataModule
    from .parallel.mesh import shard_batch
    from .training import make_train_step
    from .training.optimizer import make_schedule
    from .training.step import pick_phase
    from .utils.checkpointing import CheckpointManager, restore_train_state
    from .utils.loggers import make_logger
    from .utils.step_tracker import StepTracker

    ddp = _ddp_setup(device)
    if ddp is not None:
        device = ddp["device"]
    lead = ddp is None or ddp["rank"] == 0
    train_cfg, model, optimizer = build_all(cfg, device)
    step_tracker = StepTracker()
    dm = DataModule(cfg.dataset, cfg.data_loader, step_tracker, device=device)
    ckpt = CheckpointManager(cfg.checkpointing.output_dir,
                             every_n_steps=cfg.checkpointing.every_n_train_steps,
                             keep=cfg.checkpointing.save_top_k,
                             async_save=cfg.checkpointing.async_save)
    start_step = 0
    if cfg.checkpointing.resume:
        latest = ckpt.latest()
        if latest is not None:
            start_step = restore_train_state(latest, model, optimizer)
            print(f"resumed full train state from {latest} at step {start_step}")
    lpips_fn = _maybe_lpips(cfg, device)
    teacher_fn = _maybe_distiller(cfg, device)
    kw = {} if ddp is None else {"ddp_group": ddp["group"]}
    step_fn = make_train_step(train_cfg, model, optimizer, lpips_fn=lpips_fn,
                              teacher_fn=teacher_fn, **kw)
    writer = make_logger(cfg) if lead else None

    def save_ckpt(step):
        if lead:
            ckpt.save(step, model,
                      None if cfg.checkpointing.save_weights_only else optimizer)

    every = cfg.train.print_log_every_n_steps
    max_steps = cfg.trainer.max_steps if cfg.trainer.max_steps > 0 else 10**9
    global_step = start_step
    step_tracker.set_step(global_step)
    logged, prof = [], None
    t_last = time.perf_counter()
    while global_step < max_steps:
        loader = dm.train_dataloader()
        try:
            for batch in loader:
                batch = {k: v for k, v in batch.items() if k != "scene"}
                if ddp is not None:
                    batch = shard_batch(ddp["mesh"], batch)
                phase = pick_phase(train_cfg, global_step, teacher_fn is not None)
                if (cfg.trainer.profile_dir and prof is None
                        and global_step == cfg.trainer.profile_start):
                    prof = _start_profiler(device)
                logs = step_fn(batch, global_step, phase=phase)
                global_step += 1
                step_tracker.set_step(global_step)
                if (prof is not None and global_step
                        == cfg.trainer.profile_start + cfg.trainer.profile_steps):
                    _stop_profiler(prof, device, cfg.trainer.profile_dir,
                                   cfg.trainer.profile_steps)
                if global_step % every == 0 and lead:
                    logs = {k: float(v) for k, v in logs.items()}
                    dt, t_last = time.perf_counter() - t_last, time.perf_counter()
                    print(f"step {global_step} | loss {logs['loss']:.4f} | psnr "
                          f"{logs['psnr']:.2f} | {every / dt:.2f} it/s", flush=True)
                    logged.append(dict(logs, step=global_step))
                    if writer is not None:
                        for k, v in logs.items():
                            writer.add_scalar(f"train/{k}", v, global_step)
                        # the JAX loop logs its base config's schedule
                        writer.add_scalar("train/lr",
                                          make_schedule(cfg.optimizer)(global_step),
                                          global_step)
                if ckpt.should_save(global_step):
                    save_ckpt(global_step)
                if (cfg.trainer.val_check_interval > 0 and lead
                        and global_step % cfg.trainer.val_check_interval == 0):
                    _validation_visuals(cfg, model, dm, global_step, writer,
                                        train_cfg.dtype)
                if global_step >= max_steps:
                    break
        finally:
            # stop the prefetch threads a max_steps break leaves mid-epoch
            loader.close()
    save_ckpt(global_step)
    if lead:
        ckpt.finalize()
    if writer is not None:
        writer.close()
    if ddp is not None:
        import torch.distributed as dist

        dist.barrier(group=ddp["group"])
    if lead:
        print("training done")
    return {"model": model, "optimizer": optimizer, "step": global_step,
            "logs": logged}


def _ddp_setup(device):
    """Under torchrun (WORLD_SIZE > 1): join the group (NCCL on the card,
    gloo on the CPU), each rank on its LOCAL_RANK card. None otherwise."""
    import os

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    from .parallel.mesh import init_distributed, make_mesh

    rank, world = init_distributed(device)
    if torch.device(device).type == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    mesh = make_mesh()
    return {"rank": rank, "world": world, "device": device, "mesh": mesh,
            "group": mesh.get_group()}


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, device, out_dir, steps):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    print(f"profiler trace ({steps} steps) -> {out / 'trace.json'}")


@torch.no_grad()
def _validation_visuals(cfg, model, dm, global_step, writer, dtype="bfloat16"):
    """One val example through the forward and the render, and its
    comparison grid (context / target / rendered / depth) saved as
    `<output_dir>/val/step_<7 digits>/comparison.png` and logged; beside it
    the scene's near-orthographic projections (`projections.png`), the
    context cameras against the predicted ones (`cameras.png`) and a video
    along the predicted poses (`interpolation.mp4`, 15 fps, 6 steps a
    segment), each best-effort as in JAX `main.py:216-293`. Returns the
    grid, or None without a val split."""
    from .decoder.splatting import decoder_forward
    from .models import vicasplat_forward
    from .utils.image_io import save_image, save_video, vis_depth_map
    from .visualization.drawing import draw_cameras_figure
    from .visualization.layout import add_label, hcat, vcat
    from .visualization.validation_in_3d import render_projections
    from .visualization.video_render import render_video_interpolation

    batch = next(iter(dm.val_dataloader()), None)
    if batch is None:
        return None
    ctx, tgt = batch["context"], batch["target"]
    h, w = tgt["image"].shape[-3:-1]
    out = vicasplat_forward(model, dict(ctx, image=ctx["image"] * 2 - 1), global_step,
                            dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    rendered = decoder_forward(cfg.decoder, out["gaussians"], tgt["extrinsics"],
                               tgt["intrinsics"], tgt["near"], tgt["far"], (h, w))
    outdir = pathlib.Path(cfg.output_dir) / "val" / f"step_{global_step:07d}"

    def host(x):
        return x.float().cpu().numpy()

    n, nc = min(4, tgt["image"].shape[1]), min(4, ctx["image"].shape[1])
    grid = vcat(
        add_label(hcat(*[host(ctx["image"][0, i]) for i in range(nc)]), "context"),
        add_label(hcat(*[host(tgt["image"][0, i]) for i in range(n)]), "target (GT)"),
        add_label(hcat(*[host(rendered.color[0, i]) for i in range(n)]), "rendered"),
        add_label(hcat(*[vis_depth_map(host(rendered.depth[0, i])) for i in range(n)]),
                  "depth"))
    save_image(grid, outdir / "comparison.png")
    if writer is not None:
        writer.add_image("val/comparison", np.clip(grid, 0, 1).transpose(2, 0, 1),
                         global_step)

    # the visuals below are observability, best-effort as in JAX: a failure
    # is printed and the run goes on
    try:
        proj = render_projections(out["gaussians"], dec_cfg=cfg.decoder)
        save_image(hcat(*proj), outdir / "projections.png")
    except Exception as e:
        print(f"val projections skipped: {e}")
    try:
        save_image(draw_cameras_figure(host(ctx["extrinsics"][0]),
                                       host(out["gaussian_camera_extrins"][0])),
                   outdir / "cameras.png")
    except Exception as e:
        print(f"val camera figure skipped: {e}")
    try:
        frames = render_video_interpolation(
            out["gaussians"], out["gaussian_camera_extrins"][0],
            ctx["intrinsics"][0], (h, w), steps_per_segment=6, dec_cfg=cfg.decoder)
        save_video(frames, outdir / "interpolation.mp4", fps=15)
    except Exception as e:
        print(f"val video skipped: {e}")
    return grid


def _nan_summary(scored, key):
    """(nanmean, n_valid) of a per-scene score, skipping missing and NaN."""
    vals = np.asarray([x[key] for x in scored if key in x and x[key] is not None],
                      np.float64)
    vals = vals[np.isfinite(vals)]
    return (float(vals.mean()) if len(vals) else float("nan")), int(len(vals))


def build_model(cfg, device):
    """The model of `cfg.encoder` with float32 weights from the seed, or
    from `checkpointing.load`, in eval mode on `device`."""
    from .models import init_vicasplat
    from .utils.checkpointing import load_ema, load_weights

    model = init_vicasplat(cfg.encoder, torch.Generator(device).manual_seed(cfg.seed),
                           device)
    if cfg.checkpointing.load:
        print(f"loading weights from {cfg.checkpointing.load}")
        load_weights(cfg.checkpointing.load, model)
        # the EMA rides a full-state checkpoint (JAX main.py:379-396)
        if cfg.test.use_ema and not load_ema(cfg.checkpointing.load, model):
            print("WARNING: test.use_ema=true but the checkpoint has no EMA state "
                  "(weights-only, or trained with ema_decay=0); using raw weights")
    return model.eval()


def split_batch(batch: dict, i: int) -> dict:
    """Example i of a batch, as a batch of 1."""
    return {k: split_batch(v, i) if isinstance(v, dict) else v[i:i + 1]
            for k, v in batch.items()}


def test(cfg, device="cuda"):
    """Score the test split; returns (summary, per-scene results)."""
    from .data.data_module import DataModule
    from .evaluation.nvs_eval import (
        EvalConfig,
        evaluate_scene,
        make_pose_align_step,
        save_scene_outputs,
    )
    from .utils.benchmarker import Benchmarker

    model = build_model(cfg, device)
    eval_cfg = EvalConfig(
        output_path=cfg.test.output_path,
        align_pose=cfg.test.align_pose,
        pose_align_steps=cfg.test.pose_align_steps,
        rot_opt_lr=cfg.test.rot_opt_lr,
        trans_opt_lr=cfg.test.trans_opt_lr,
        compute_scores=cfg.test.compute_scores,
        save_image=cfg.test.save_image,
        save_video=cfg.test.save_video,
        save_compare=cfg.test.save_compare,
        save_gs=cfg.test.save_gs,
    )
    dm = DataModule(cfg.dataset, cfg.data_loader, None, device=device)
    bench = Benchmarker()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    h = w = cfg.encoder.backbone.img_size
    lpips_fn = _maybe_lpips(cfg, device)
    align_fn = (make_pose_align_step(cfg.encoder, cfg.decoder, eval_cfg, (h, w),
                                     loss_cfg=cfg.loss, lpips_fn=lpips_fn)
                if eval_cfg.align_pose and eval_cfg.pose_align_steps > 0 else None)
    results = []
    for full_batch in dm.test_dataloader():
        # score every example of the batch, one scene at a time
        for i in range(full_batch["context"]["image"].shape[0]):
            batch = split_batch(full_batch, i)
            r = evaluate_scene(model, cfg.encoder, cfg.decoder, eval_cfg, batch,
                               align_fn=align_fn, benchmarker=bench, lpips_fn=lpips_fn)
            save_scene_outputs(r, batch, eval_cfg, cfg.encoder)
            results.append({k: v for k, v in r.items() if not k.startswith("_")})
        scored = [x for x in results if "psnr" in x]
        if scored:
            print(f"[{len(results)}] {r['scene']}: " + " ".join(
                f"{k}={_nan_summary(scored, k)[0]:.3f}" for k in ("psnr", "ssim", "ate")
                if any(k in x for x in scored)), flush=True)

    out = pathlib.Path(eval_cfg.output_path)
    out.mkdir(parents=True, exist_ok=True)
    scored = [x for x in results if "psnr" in x]
    # nanmean and n_valid per score: a score skipped on a degenerate scene
    # must not poison the summary
    summary, n_valid = {}, {}
    for k in sorted({k for x in scored for k in x if isinstance(x[k], (int, float))}):
        mean, n = _nan_summary(scored, k)
        if n:
            summary[k] = mean
            n_valid[k] = n
    if summary:
        summary["n_scenes"] = len(scored)
        summary["n_valid"] = n_valid
    with open(out / "scores_all_avg.json", "w") as f:
        json.dump(summary, f, indent=2)
    bench.dump(out / "benchmark.json")
    bench.dump_memory(out / "peak_memory.json")
    print("summary:", summary)
    return summary, results


def main(argv=None, device="cuda"):
    from .utils.config import parse_cli

    cfg = parse_cli(sys.argv[1:] if argv is None else argv)
    np.random.seed(cfg.seed)
    if cfg.mode == "train":
        return train(cfg, device)
    if cfg.mode != "test":
        raise ValueError(cfg.mode)
    return test(cfg, device)


if __name__ == "__main__":
    main()
