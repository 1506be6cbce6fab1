"""Evaluation (port of vicasplat_tpu/evaluation/): image and trajectory
metrics, the novel-view-synthesis test harness and the pose evaluator."""
