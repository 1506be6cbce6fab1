"""Test-mode CLI (port of vicasplat_tpu/main.py:364-505):

    python -m vicasplat_tpu_torch.main +experiment=synthetic_pose mode=test \
        checkpointing.load=outputs/synthetic_pose/ckpt_committed/weights_latest.npz \
        dataset.synthetic.n_scenes=4096 test.output_path=<dir>

Per scene of the test split: encode the context (bf16 over float32
weights), align the target poses, render and score them
(evaluation/nvs_eval.py), and save its outputs; then write
`scores_all_avg.json` (each score's nanmean, with `n_scenes` and each
score's `n_valid`), `benchmark.json` (seconds of the sections `encoder`,
`pose_align` and `decoder`) and `peak_memory.json` under
`test.output_path`. It runs on the card unless the caller passes
`device="cpu"`. `mode=train` waits for the next slice.
"""
from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch


def _maybe_lpips(cfg):
    """LPIPS needs VGG weights that the repository does not hold, and its
    graph is not ported (ROADMAP.md §1 item 1): the test mode runs
    without it, as the JAX package's does without the weights."""
    if cfg.loss.lpips is not None:
        print("lpips unavailable (no VGG weights, graph not ported); continuing "
              "without perceptual loss")
    return None


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
    from .utils.checkpointing import load_weights

    model = init_vicasplat(cfg.encoder, torch.Generator(device).manual_seed(cfg.seed),
                           device)
    if cfg.checkpointing.load:
        if cfg.test.use_ema:
            print("WARNING: test.use_ema=true but the checkpoint has no EMA state "
                  "(a weights-only snapshot); using raw weights")
        print(f"loading weights from {cfg.checkpointing.load}")
        load_weights(cfg.checkpointing.load, model)
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
    lpips_fn = _maybe_lpips(cfg)
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
        raise NotImplementedError(
            "mode=train is not ported yet (ROADMAP.md §1 item 1: main.py's train "
            "mode, with distillation and LPIPS)")
    if cfg.mode != "test":
        raise ValueError(cfg.mode)
    return test(cfg, device)


if __name__ == "__main__":
    main()
