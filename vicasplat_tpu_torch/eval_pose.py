"""Pose-evaluation CLI (port of eval_pose.py:13-46):

    python -m vicasplat_tpu_torch.eval_pose +experiment=synthetic_pose \
        checkpointing.load=outputs/synthetic_pose/ckpt_committed/weights_latest.npz \
        dataset.synthetic.n_scenes=4096

Loads the weights, runs PoseEvaluator over the test loader and writes
`pose_metrics.json` (ATE, RPE, pose AUC) under `<test.output_path>_pose`.
It runs on the card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import sys


def main(argv=None, device="cuda"):
    from .data.data_module import DataModule
    from .evaluation.pose_evaluator import PoseEvalConfig, PoseEvaluator
    from .main import build_model
    from .utils.config import parse_cli

    cfg = parse_cli(sys.argv[1:] if argv is None else argv)
    model = build_model(cfg, device)
    evaluator = PoseEvaluator(model, cfg.encoder, cfg.decoder, PoseEvalConfig(
        output_path=str(cfg.test.output_path) + "_pose"))
    dm = DataModule(cfg.dataset, cfg.data_loader, None, device=device)
    for i, batch in enumerate(dm.test_dataloader()):
        r = evaluator.evaluate_batch(batch)
        print(f"[{i}] {r['scene']}: ate={r['ate']:.4f} rpe_r={r['rpe_rot']:.3f} "
              f"rpe_t={r['rpe_trans']:.4f}", flush=True)
    path = evaluator.dump()
    print("summary:", evaluator.summary())
    print("wrote", path)
    return evaluator


if __name__ == "__main__":
    main()
