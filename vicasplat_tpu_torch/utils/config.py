"""Typed configuration (port of vicasplat_tpu/utils/config.py:36-233): the
YAML base, an experiment overlay and dotted CLI overrides, built into
frozen dataclasses that carry the JAX package's names and defaults.

    cfg = load_config("configs/main.yaml", experiment="synthetic_pose",
                      overrides=["mode=test", "checkpointing.load=w.npz"])

YAML is read by `yaml_subset.safe_load`, which gives `yaml.safe_load`'s
results on the subset `configs/` uses and raises outside it. An override's
value is YAML too, so it may be a flow mapping such as
`dataset.re10k.view_sampler='{name: evaluation, num_context_views: 8}'`.
"""
from __future__ import annotations

import copy
import dataclasses
import pathlib
import typing
from typing import Optional

from ..decoder.splatting import DecoderSplattingConfig
from ..loss.losses import (
    LossCameraConfig,
    LossDepthConfig,
    LossLpipsConfig,
    LossMseConfig,
)
from ..models.vicasplat import VicaSplatConfig
from ..training.optimizer import OptimizerConfig
from .yaml_subset import safe_load


@dataclasses.dataclass(frozen=True)
class CheckpointingConfig:
    load: Optional[str] = None
    every_n_train_steps: int = 5000
    save_top_k: int = 5
    save_weights_only: bool = True
    output_dir: str = "checkpoints"
    async_save: bool = True
    resume: bool = False


@dataclasses.dataclass(frozen=True)
class TrainSectionConfig:
    distiller: str = ""
    distill_max_steps: int = 0
    distill_only_steps: int = 0
    distill_weight: float = 1.0
    gradient_checkpointing: bool = True
    remat_policy: str = "none"
    accumulate_grad_batches: int = 1
    lr_cosine_annealing: bool = False
    new_param_keywords: tuple = ("gaussian_param_head", "intrinsic_encoder")
    print_log_every_n_steps: int = 10


@dataclasses.dataclass(frozen=True)
class TestSectionConfig:
    output_path: str = "outputs/eval_results"
    # evaluate the EMA weights of a full-state checkpoint
    use_ema: bool = False
    align_pose: bool = True
    pose_align_steps: int = 100
    rot_opt_lr: float = 0.005
    trans_opt_lr: float = 0.005
    compute_scores: bool = True
    save_image: bool = True
    save_video: bool = False
    save_compare: bool = True
    save_gs: bool = False


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    max_steps: int = -1
    val_check_interval: int = 250
    gradient_clip_val: float = 0.5
    num_nodes: int = 1
    precision: str = "bfloat16"
    profile_dir: Optional[str] = None
    profile_start: int = 5
    profile_steps: int = 3


@dataclasses.dataclass(frozen=True)
class LossWeightsConfig:
    mse: Optional[LossMseConfig] = LossMseConfig()
    lpips: Optional[LossLpipsConfig] = None
    camera: Optional[LossCameraConfig] = None
    depth: Optional[LossDepthConfig] = None


@dataclasses.dataclass(frozen=True)
class WandbConfig:
    mode: str = "disabled"  # disabled | online | offline
    project: str = "vicasplat"
    entity: Optional[str] = None
    name: str = "run"
    tags: tuple = ()


@dataclasses.dataclass(frozen=True)
class RootConfig:
    mode: str = "train"
    encoder: VicaSplatConfig = VicaSplatConfig()
    decoder: DecoderSplattingConfig = DecoderSplattingConfig()
    loss: LossWeightsConfig = LossWeightsConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    checkpointing: CheckpointingConfig = CheckpointingConfig()
    train: TrainSectionConfig = TrainSectionConfig()
    test: TestSectionConfig = TestSectionConfig()
    trainer: TrainerConfig = TrainerConfig()
    dataset: dict = dataclasses.field(default_factory=dict)
    data_loader: dict = dataclasses.field(default_factory=dict)
    seed: int = 250307
    output_dir: str = "outputs"
    wandb: WandbConfig = WandbConfig()


def _build(cls, data):
    """A mapping -> the dataclass `cls`, recursively; unknown keys raise."""
    if data is None:
        return None
    if not dataclasses.is_dataclass(cls):
        return data
    if not isinstance(data, dict):
        raise TypeError(f"expected mapping for {cls.__name__}, got {type(data)}")
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for key, value in data.items():
        if key not in hints:
            raise KeyError(f"unknown config key '{key}' for {cls.__name__}")
        kwargs[key] = _build_field(hints[key], value)
    return cls(**kwargs)


def _build_field(tp, value):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        if value is None:
            return None
        tp = next(a for a in typing.get_args(tp) if a is not type(None))
        origin = typing.get_origin(tp)
    if dataclasses.is_dataclass(tp):
        return _build(tp, value)
    if tp is tuple or origin is tuple:
        return tuple(value) if isinstance(value, (list, tuple)) else value
    if tp is dict or origin is dict:
        return dict(value)
    if tp is float:
        # YAML 1.1 reads "4e-5" (no dot) as a string
        return float(value)
    if tp is int and not isinstance(value, bool):
        return int(value)
    return value


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in (overlay or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _apply_override(cfg: dict, dotted: str):
    key, _, raw = dotted.partition("=")
    node = cfg
    parts = key.strip().lstrip("+").split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = safe_load(raw)


def load_config(main_yaml, experiment: Optional[str] = None,
                overrides: Optional[list] = None) -> RootConfig:
    main_yaml = pathlib.Path(main_yaml)
    data = safe_load(main_yaml.read_text()) or {}
    if experiment:
        exp = main_yaml.parent / "experiment" / f"{experiment}.yaml"
        data = _deep_merge(data, safe_load(exp.read_text()) or {})
    for ov in overrides or []:
        if not ov.startswith("+experiment="):
            _apply_override(data, ov)
    return _build(RootConfig, data)


def parse_cli(argv: list) -> RootConfig:
    """Hydra-style arguments: `+experiment=synthetic_pose mode=test
    checkpointing.load=...`, against the repository's configs/main.yaml."""
    experiment, overrides = None, []
    for a in argv:
        if a.startswith("+experiment="):
            experiment = a.split("=", 1)[1]
        elif "=" in a:
            overrides.append(a)
    root = pathlib.Path(__file__).resolve().parents[2] / "configs" / "main.yaml"
    return load_config(root, experiment=experiment, overrides=overrides)
