"""Parity of the port's training step with gradient accumulation
(accumulate_steps=2 over a batch of 4) with the JAX package's
`make_train_step`, in float32 on the CPU; the tolerances and the checks are
those of tests/test_torch_training.py."""
import dataclasses

import torch
from test_torch_training import _check_steps
from test_training import tiny_train_cfg

torch.set_num_threads(1)


def test_accumulated_step_matches_jax():
    """accumulate_steps=2 over a batch of 4: averaged gradients, loss and
    logs, then one update."""
    _check_steps(dataclasses.replace(tiny_train_cfg(), accumulate_steps=2),
                 B=4, n=1)
