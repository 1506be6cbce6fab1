"""Batching and per-stage loaders (port of vicasplat_tpu/data/data_module.py:
24-299): `collate`, `_build_dataset` and `DataModule` with its strict loader
schema. Datasets yield numpy examples; a loader collates them and puts each
batch on the card through pinned memory and non-blocking copies
(`to_device`).

Ported datasets: `synthetic` (data/synthetic_scenes.py). The chunk readers
(RE10K, ACID, DL3DV, ScanNet++, MVImgNet, ScanNet) and the train loader's
threaded prefetch are not ported yet (ROADMAP.md §1 item 5): naming them
raises.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from .synthetic_scenes import DatasetSyntheticScenes, SyntheticScenesConfig
from .view_samplers import make_view_sampler


@dataclasses.dataclass(frozen=True)
class DataLoaderConfig:
    batch_size: int = 2
    seed: int = 1234
    prefetch: int = 2
    num_workers: int = 0


def collate(examples: list) -> dict:
    """Stack a list of example dicts into batched numpy arrays (strings
    become lists)."""
    def stack(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: stack([it[k] for it in items]) for k in first}
        if isinstance(first, str):
            return list(items)
        return np.stack(items)

    return stack(examples)


def to_device(batch, device):
    """Numpy leaves -> tensors on `device`; on a card through pinned host
    memory and non-blocking copies. Lists of strings stay."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, list):
        return batch
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


DATASETS = {"synthetic": (DatasetSyntheticScenes, SyntheticScenesConfig)}
NOT_PORTED = ("re10k", "acid", "dl3dv", "scannetpp", "mvimgnet", "scannet",
              "scannet_pose")


def _build_dataset(ds_dict: dict, stage: str, step_tracker, seed: int, device="cpu"):
    d = dict(ds_dict)
    sampler_cfg = d.pop("view_sampler", {"name": "bounded"})
    name = d.get("name", "re10k")
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r}: its reader is not ported yet (ROADMAP.md §1 item 5); "
            "the port reads the 'synthetic' dataset")
    cls, cfg_cls = DATASETS[name]
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    cfg = cfg_cls(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in d.items() if k in fields})
    sampler = make_view_sampler(
        sampler_cfg, stage, step_tracker,
        is_overfitting=cfg.overfit_to_scene is not None,
        cameras_are_circular=cfg.cameras_are_circular)
    return cls(cfg, stage, sampler, seed=seed, device=device)


class DataModule:
    """Per-stage loaders from the config's dataset dict (one or more named
    datasets, taken in turns). Scenes render, and batches land, on
    `device`."""

    def __init__(self, dataset_cfgs: dict, data_loader_cfg: dict,
                 step_tracker=None, device="cuda"):
        self.dataset_cfgs = dataset_cfgs
        self.loader_cfg = data_loader_cfg or {}
        self.step_tracker = step_tracker
        self.device = device

    def _loader_params(self, stage: str, ds_name: str) -> DataLoaderConfig:
        section = self.loader_cfg.get(stage, {})
        if ds_name in section:  # per-dataset override
            section = section[ds_name]
        fields = {f.name for f in dataclasses.fields(DataLoaderConfig)}
        # strict schema: a misspelt key must raise, not fall back to defaults
        unknown = [k for k in section
                   if k not in fields and k not in self.dataset_cfgs]
        if unknown:
            raise ValueError(
                f"unknown data_loader.{stage} key(s) {unknown}; expected one of "
                f"{sorted(fields)} or per-dataset overrides {sorted(self.dataset_cfgs)}")
        return DataLoaderConfig(**{k: v for k, v in section.items() if k in fields})

    def loader(self, stage: str) -> Iterator[dict]:
        """Batches of `batch_size` examples on the device, the datasets
        taken in turns; the last short batch is kept (val and test)."""
        if stage == "train":
            raise NotImplementedError(
                "the train loader (threaded prefetch) waits for main.py's train "
                "mode (ROADMAP.md §1 item 1)")
        lp = self._loader_params(stage, next(iter(self.dataset_cfgs), ""))
        iters = []
        for name, ds_dict in self.dataset_cfgs.items():
            seed = self._loader_params(stage, name).seed
            iters.append(iter(_build_dataset(
                dict(ds_dict, name=ds_dict.get("name", name)), stage,
                self.step_tracker, seed, self.device)))

        return self._batches(iters, lp.batch_size)

    def _batches(self, iters: list, batch_size: int) -> Iterator[dict]:
        live, batch = list(iters), []
        while live:
            for it in list(live):
                ex = next(it, None)
                if ex is None:
                    live.remove(it)
                    continue
                batch.append(ex)
                if len(batch) == batch_size:
                    yield to_device(collate(batch), self.device)
                    batch = []
        if batch:
            yield to_device(collate(batch), self.device)

    def test_dataloader(self):
        return self.loader("test")
