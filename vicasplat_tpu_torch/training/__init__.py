"""Training: the optimizer and the train step (port of vicasplat_tpu/training)."""
from .optimizer import AdamW, OptimizerConfig
from .step import TrainConfig, compute_loss, make_train_step, pick_phase

__all__ = ["AdamW", "OptimizerConfig", "TrainConfig", "compute_loss",
           "make_train_step", "pick_phase"]
