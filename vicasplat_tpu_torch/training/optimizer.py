"""AdamW with warm-up (+ cosine) and per-parameter learning-rate
multipliers (port of vicasplat_tpu/training/optimizer.py).

`AdamW.step` reproduces the JAX package's optax chain, in its order and with
its conventions:
  clip_by_global_norm   g <- g / |g| * clip, only when |g| >= clip;
  scale_by_adam         mu <- (1 - b1) g + b1 mu, nu <- (1 - b2) g^2 + b2 nu,
                        u = mu_hat / (sqrt(nu_hat) + 1e-8), with the bias
                        correction of the step count after the increment;
                        mu is kept in `moment_dtype` (cast after use, as
                        optax's mu_dtype);
  add_decayed_weights   u <- u + weight_decay * p, on every parameter;
  scale_by_learning_rate u <- -lr(count) u, count starting at 0, so the
                        first step of a warm-up from 0 changes nothing;
  the multiplier        u <- u * mult, 1.0 for parameters whose name holds
                        one of `new_param_keywords`, else
                        backbone_lr_multiplier;
then p <- p + u, and the EMA of the new parameters when ema_decay > 0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1.5e-4
    warm_up_steps: int = 2000
    backbone_lr_multiplier: float = 0.1
    weight_decay: float = 0.05
    betas: tuple = (0.9, 0.95)
    gradient_clip_val: float = 0.5
    cosine_annealing: bool = False
    max_steps: int = 100_000
    new_param_keywords: tuple = ("gaussian_param_head", "intrinsic_encoder")
    moment_dtype: str = "float32"  # of Adam's first moment: or "bfloat16"
    ema_decay: float = 0.0  # > 0 keeps an EMA of the parameters


EPS = 1e-8


def lr_multipliers(model: nn.Module, cfg: OptimizerConfig) -> dict:
    """{parameter name: lr multiplier}, matching the keywords against the
    names of `named_parameters` as JAX matches them against tree paths."""
    return {name: 1.0 if any(k in name for k in cfg.new_param_keywords)
            else cfg.backbone_lr_multiplier
            for name, _ in model.named_parameters()}


def make_schedule(cfg: OptimizerConfig):
    """count -> learning rate: optax's warmup_cosine_decay_schedule (from
    0, to 0) with cosine annealing, else its linear warm-up from lr / w."""
    w = max(cfg.warm_up_steps, 1)
    if cfg.cosine_annealing:
        decay = max(cfg.max_steps, cfg.warm_up_steps + 1) - w

        def schedule(count: int) -> float:
            if count < w:
                return cfg.lr * min(count, w) / w
            c = min(count - w, decay)
            return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return schedule

    init = cfg.lr / w

    def linear(count: int) -> float:
        c = min(max(count, 0), w)
        return (init - cfg.lr) * (1.0 - c / w) + cfg.lr
    return linear


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (FSDP2's sharded parameters and
    gradients), a plain tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


class AdamW:
    """The optimizer over a module's parameters, updated in place from their
    `.grad`. State: the step count, mu, nu and the optional EMA (JAX
    `_track_param_ema`: ema <- decay ema + (1 - decay) p of the new
    parameters, starting from the initial ones), keyed by parameter name.
    Parameters on the meta device (blocks of other pipeline stages) are left
    out; a DTensor parameter (FSDP2) is updated on its local shard, and then
    the clipping norm must come from the caller (`step(g_norm=...)`)."""

    def __init__(self, model: nn.Module, cfg: OptimizerConfig):
        self.cfg = cfg
        self.params = {n: p for n, p in model.named_parameters()
                       if not p.is_meta}
        self.mult = lr_multipliers(model, cfg)
        self.schedule = make_schedule(cfg)
        mu_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            cfg.moment_dtype]
        self.count = 0
        self.mu = {n: torch.zeros_like(local(p), dtype=mu_dtype)
                   for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(local(p)) for n, p in self.params.items()}
        self.ema = ({n: local(p).detach().clone() for n, p in self.params.items()}
                    if cfg.ema_decay > 0.0 else None)

    @torch.no_grad()
    def step(self, g_norm: Optional[torch.Tensor] = None) -> None:
        """One update from the parameters' `.grad`; g_norm is the gradients'
        global norm when they are spread over ranks (default: computed
        here from the local ones)."""
        cfg = self.cfg
        b1, b2 = cfg.betas
        grads = {n: torch.zeros_like(local(p)) if p.grad is None else local(p.grad)
                 for n, p in self.params.items()}
        if g_norm is None:
            g_norm = global_norm(grads.values())
        clip = bool(g_norm >= cfg.gradient_clip_val)
        count = self.count + 1
        one = torch.ones((), dtype=torch.float32)
        bc1 = (1 - (one * b1) ** count).item()  # float32, as optax's
        bc2 = (1 - (one * b2) ** count).item()
        lr = self.schedule(self.count)
        for n, param in self.params.items():
            p = local(param)
            g = grads[n]
            if clip:
                g = (g / g_norm) * cfg.gradient_clip_val
            mu = (1 - b1) * g + b1 * self.mu[n]
            nu = (1 - b2) * (g * g) + b2 * self.nu[n]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            u = (u + cfg.weight_decay * p) * (-lr) * self.mult[n]
            p.add_(u)
            self.mu[n] = mu.to(self.mu[n].dtype)
            self.nu[n] = nu
            if self.ema is not None:
                self.ema[n] = cfg.ema_decay * self.ema[n] + (1.0 - cfg.ema_decay) * p
        self.count = count


def get_ema_params(optimizer: AdamW):
    """{parameter name: EMA} of an optimizer built with ema_decay > 0, else
    None (JAX `get_ema_params`)."""
    return optimizer.ema
