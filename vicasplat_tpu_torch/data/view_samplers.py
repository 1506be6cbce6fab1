"""View samplers (port of vicasplat_tpu/data/view_samplers.py:20-277):
choose context and target frame indices per scene. `bounded` (2-view, gap
curriculum), `sequential` (N equally spaced context frames, the video
sampler), `evaluation` (a frozen JSON index), `arbitrary` and `all`. Host
numpy with an explicit np.random.Generator, drawing as the JAX package
does, so that the same seed gives the same frames. The step tracker is any
object with `get_step()` (the train loop's StepTracker,
utils/step_tracker.py), or None.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional

import numpy as np


class NotEnoughFramesError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class ViewSamplerBoundedConfig:
    name: str = "bounded"
    num_context_views: int = 2
    num_target_views: int = 4
    min_distance_between_context_views: int = 45
    max_distance_between_context_views: int = 45
    min_distance_to_context_views: int = 0
    warm_up_steps: int = 0
    initial_min_distance_between_context_views: int = 25
    initial_max_distance_between_context_views: int = 25


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


@dataclasses.dataclass(frozen=True)
class ViewSamplerEvaluationConfig:
    name: str = "evaluation"
    index_path: str = ""
    num_context_views: int = 2


@dataclasses.dataclass(frozen=True)
class ViewSamplerArbitraryConfig:
    name: str = "arbitrary"
    num_context_views: int = 2
    num_target_views: int = 4
    context_views: Optional[tuple] = None
    target_views: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class ViewSamplerAllConfig:
    name: str = "all"


class ViewSampler:
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
        return getattr(self.cfg, "num_context_views", 0)

    @property
    def num_target_views(self):
        return getattr(self.cfg, "num_target_views", 0)

    def sample(self, scene, num_views, rng):
        raise NotImplementedError


class ViewSamplerBounded(ViewSampler):
    """2-view gap-scheduled sampler (reference view_sampler_bounded.py:24-138)."""

    def sample(self, scene: str, num_views: int, rng: np.random.Generator):
        cfg = self.cfg
        min_gap, max_gap = self._gaps()
        if not self.cameras_are_circular:
            max_gap = min(num_views - 1, max_gap)
        min_gap = max(2 * cfg.min_distance_to_context_views, min_gap)
        if max_gap < min_gap:
            raise NotEnoughFramesError(scene)
        gap = int(rng.integers(min_gap, max_gap + 1))

        left = int(rng.integers(num_views if self.cameras_are_circular
                                else num_views - gap))
        if self.stage == "test":
            left = 0
        right = left + gap
        if self.is_overfitting:
            left, right = 0, max_gap

        if self.stage == "test":
            target = np.arange(left, right + 1)
        else:
            target = rng.integers(
                left + cfg.min_distance_to_context_views,
                right + 1 - cfg.min_distance_to_context_views,
                size=cfg.num_target_views,
            )
        if self.cameras_are_circular:
            target = target % num_views
            right = right % num_views

        extra = []
        if cfg.num_context_views > 2:
            n_extra = cfg.num_context_views - 2
            while len(set(extra)) != n_extra:
                extra = rng.integers(left + 1, right, size=n_extra).tolist()
        context = np.array([left, *extra, right], dtype=np.int64)
        return context, np.asarray(target, np.int64), 0.5


class ViewSamplerSequential(ViewSampler):
    """N equally-spaced context frames with random gap and p=0.5 order
    reversal; the video sampler (reference view_sampler_sequential.py:25-139)."""

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


def add_third_context_index(context: np.ndarray) -> np.ndarray:
    """Serve a 2-view index as 3 views by inserting the midpoint frame
    (reference view_sampler/three_view_hack.py)."""
    left, right = int(context[0]), int(context[-1])
    return np.asarray([left, (left + right) // 2, right], np.int64)


class ViewSamplerEvaluation(ViewSampler):
    """Frozen JSON index (reference view_sampler_evaluation.py:26-81)."""

    def __init__(self, cfg, stage, step_tracker=None, **kw):
        super().__init__(cfg, stage, step_tracker, **kw)
        with open(pathlib.Path(cfg.index_path)) as f:
            self.index = json.load(f)

    def sample(self, scene: str, num_views: int, rng: np.random.Generator):
        entry = self.index.get(scene)
        if entry is None:
            raise NotEnoughFramesError(f"No indices for scene {scene}")
        overlap = entry.get("overlap", 0.5)
        if isinstance(overlap, str):
            overlap = 0.75 if overlap == "large" else 0.25
        context = np.asarray(entry["context"], np.int64)
        if self.cfg.num_context_views == 3 and len(context) == 2:
            context = add_third_context_index(context)
        return (
            context,
            np.asarray(entry["target"], np.int64),
            float(overlap) if overlap is not None else 0.5,
        )

    @property
    def num_target_views(self):
        return 0


class ViewSamplerArbitrary(ViewSampler):
    def sample(self, scene: str, num_views: int, rng: np.random.Generator):
        cfg = self.cfg
        if cfg.context_views is not None:
            context = np.asarray(cfg.context_views, np.int64)
        else:
            context = rng.integers(0, num_views, size=cfg.num_context_views)
        if cfg.target_views is not None:
            target = np.asarray(cfg.target_views, np.int64)
        else:
            target = rng.integers(0, num_views, size=cfg.num_target_views)
        return np.asarray(context, np.int64), np.asarray(target, np.int64), 0.5


class ViewSamplerAll(ViewSampler):
    def sample(self, scene: str, num_views: int, rng: np.random.Generator):
        idx = np.arange(num_views, dtype=np.int64)
        return idx, idx, 0.5


_SAMPLERS = {
    "bounded": (ViewSamplerBounded, ViewSamplerBoundedConfig),
    "sequential": (ViewSamplerSequential, ViewSamplerSequentialConfig),
    "evaluation": (ViewSamplerEvaluation, ViewSamplerEvaluationConfig),
    "arbitrary": (ViewSamplerArbitrary, ViewSamplerArbitraryConfig),
    "all": (ViewSamplerAll, ViewSamplerAllConfig),
}


def make_view_sampler(cfg_dict_or_cfg, stage: str, step_tracker=None,
                      **kw) -> ViewSampler:
    if isinstance(cfg_dict_or_cfg, dict):
        d = dict(cfg_dict_or_cfg)
        name = d.pop("name", "bounded")
        if name not in _SAMPLERS:
            raise ValueError(f"unknown view sampler {name!r}; expected one of "
                             f"{sorted(_SAMPLERS)}")
        cls, cfg_cls = _SAMPLERS[name]
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        cfg = cfg_cls(name=name, **d)
    else:
        cfg = cfg_dict_or_cfg
        cls, _ = _SAMPLERS[cfg.name]
    return cls(cfg, stage, step_tracker, **kw)
