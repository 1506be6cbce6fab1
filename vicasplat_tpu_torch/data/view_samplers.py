"""View samplers (port of vicasplat_tpu/data/view_samplers.py:20-277):
choose context and target frame indices per scene. The port has the
`sequential` sampler (N equally spaced context frames, the video sampler),
which every configuration of the synthetic dataset names. `bounded` and
`evaluation` are reached only through the chunk readers (re10k, acid), which
are not ported yet (ROADMAP.md §1 item 5), and come with them. Host numpy
with an explicit np.random.Generator; a copy of the JAX package's, which
imports no JAX. The step tracker is any object with `get_step()` (the train
loop's StepTracker, utils/step_tracker.py), or None.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class NotEnoughFramesError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class ViewSamplerSequentialConfig:
    name: str = "sequential"
    num_context_views: int = 8
    num_target_views: int = 12
    min_distance_between_context_views: int = 30
    max_distance_between_context_views: int = 90
    min_distance_to_context_views: int = 0
    warm_up_steps: int = 0
    initial_min_distance_between_context_views: int = 5
    initial_max_distance_between_context_views: int = 10
    p_inverse_order: float = 0.5


class ViewSamplerSequential:
    """N equally-spaced context frames with random gap and p=0.5 order
    reversal; the video sampler (reference view_sampler_sequential.py:25-139)."""

    def __init__(self, cfg, stage: str, step_tracker=None,
                 is_overfitting: bool = False, cameras_are_circular: bool = False):
        self.cfg = cfg
        self.stage = stage
        self.step_tracker = step_tracker
        self.is_overfitting = is_overfitting
        self.cameras_are_circular = cameras_are_circular

    @property
    def global_step(self) -> int:
        return 0 if self.step_tracker is None else self.step_tracker.get_step()

    def _schedule(self, initial: int, final: int) -> int:
        frac = self.global_step / self.cfg.warm_up_steps
        return min(initial + int((final - initial) * frac), final)

    def _gaps(self):
        cfg = self.cfg
        if self.stage == "test":
            return (cfg.max_distance_between_context_views,
                    cfg.max_distance_between_context_views)
        if cfg.warm_up_steps > 0:
            return (
                self._schedule(cfg.initial_min_distance_between_context_views,
                               cfg.min_distance_between_context_views),
                self._schedule(cfg.initial_max_distance_between_context_views,
                               cfg.max_distance_between_context_views),
            )
        return (cfg.min_distance_between_context_views,
                cfg.max_distance_between_context_views)

    @property
    def num_context_views(self):
        return self.cfg.num_context_views

    @property
    def num_target_views(self):
        return self.cfg.num_target_views

    def sample(self, scene: str, num_views: int, rng: np.random.Generator):
        cfg = self.cfg
        n_ctx = cfg.num_context_views
        min_gap, max_gap = self._gaps()
        if not self.cameras_are_circular:
            max_gap = min(num_views // n_ctx, max_gap)
        max_gap = min((num_views - 1) // (n_ctx - 1), max_gap)
        if max_gap < min_gap:
            raise NotEnoughFramesError(scene)
        gap = int(rng.integers(min_gap, max_gap + 1))

        span = gap * (n_ctx - 1)
        left = int(rng.integers(num_views if self.cameras_are_circular
                                else num_views - span))
        if self.stage == "test":
            left = 0
        right = left + span
        if self.is_overfitting:
            left, gap = 0, max_gap
            right = max_gap * (n_ctx - 1)

        if self.stage == "test":
            target = np.arange(left, right + 1)
        else:
            t_left = max(0, left - cfg.min_distance_to_context_views)
            t_right = min(num_views - 1, right + cfg.min_distance_to_context_views)
            target = rng.integers(t_left, t_right + 1, size=cfg.num_target_views)
        if self.cameras_are_circular:
            target = target % num_views
            right = right % num_views

        context = np.arange(left, right + 1, gap, dtype=np.int64)[:n_ctx]
        if self.stage == "train" and cfg.p_inverse_order > 0:
            if rng.random() < cfg.p_inverse_order:
                context = context[::-1].copy()
        return context, np.asarray(target, np.int64), 0.5


def make_view_sampler(cfg_dict_or_cfg, stage: str, step_tracker=None,
                      **kw) -> ViewSamplerSequential:
    if isinstance(cfg_dict_or_cfg, dict):
        d = dict(cfg_dict_or_cfg)
        name = d.pop("name", "bounded")
        _check_ported(name)
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        cfg = ViewSamplerSequentialConfig(name=name, **d)
    else:
        cfg = cfg_dict_or_cfg
        _check_ported(cfg.name)
    return ViewSamplerSequential(cfg, stage, step_tracker, **kw)


def _check_ported(name: str):
    if name in ("bounded", "evaluation"):
        raise NotImplementedError(
            f"view sampler {name!r} is not ported yet: it comes with the chunk "
            "readers that use it (ROADMAP.md §1 item 5); the port has 'sequential'")
    if name != "sequential":
        raise NotImplementedError(
            f"view sampler {name!r} is not ported: no configuration names it; "
            "the port has 'sequential'")
