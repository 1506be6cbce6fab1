"""Batching and per-stage loaders (port of vicasplat_tpu/data/data_module.py:
24-299): `collate`, `PrefetchIterator`, `_build_dataset` and `DataModule`
with its strict loader schema. Datasets yield numpy examples; a loader
collates them and puts each batch on the card through pinned memory and
non-blocking copies (`to_device`).

The train loader collates on background threads (`PrefetchIterator`) and
copies each batch to the device on the consuming thread, in `__next__`: the
copy is queued on that thread's current stream, so it is ordered before the
step that uses it with no event. With `num_workers > 0` a chunk reader is
sharded (`iter_shard`), one producer thread a shard feeding a collator
thread, as the JAX loader does: the JPEG decode and the resize run in the
port's host library, which releases the GIL. The synthetic dataset renders
a scene's frames on the device from the producer thread; that render runs
on the device's default stream, as the train loop does, and comes back to
the host (a synchronizing copy) before it is collated, so no device tensor
crosses threads. Its rasterizer is the default matmul path, which launches
none of the port's kernels: the kernels' launch counts stay the train
loop's own.

Datasets: `synthetic` (data/synthetic_scenes.py); the chunk readers
`re10k`, `acid`, `dl3dv`, `scannetpp` and `mvimgnet`
(data/dataset_re10k.py); `scannet` and `scannet_pose`
(data/dataset_scannet.py).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from .dataset_re10k import DatasetRE10k, DatasetRE10kConfig
from .dataset_scannet import DatasetScannet, DatasetScannetConfig
from .synthetic_scenes import DatasetSyntheticScenes, SyntheticScenesConfig
from .view_samplers import make_view_sampler


@dataclasses.dataclass(frozen=True)
class DataLoaderConfig:
    batch_size: int = 2
    seed: int = 1234
    prefetch: int = 2
    # train only: shards of a chunk reader, each on its own producer thread
    # (the reference DataLoader's num_workers); 0 iterates on one thread
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


class PrefetchIterator:
    """Collates batches of `batch_size` examples on background threads (JAX
    `data_module.py:49-189`). One example iterator: one thread collates it.
    Several (a sharded reader's shards): one producer thread each feeds a
    shared example queue and one collator thread assembles the batches.
    `transfer`, if given, maps each collated batch on the consuming thread
    (the train loader puts it on the device there)."""

    def __init__(self, example_iters, batch_size: int, prefetch: int = 2,
                 drop_last: bool = True, transfer=None):
        if not isinstance(example_iters, (list, tuple)):
            example_iters = [example_iters]
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.transfer = transfer
        self._stop = threading.Event()
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._ex_q = None
        if len(example_iters) == 1:
            self._threads = [threading.Thread(target=self._single_worker,
                                              args=(example_iters[0],), daemon=True)]
        else:
            self._ex_q = queue.Queue(maxsize=max(2 * batch_size, 8))
            self._threads = [threading.Thread(target=self._producer, args=(it,), daemon=True)
                             for it in example_iters]
            self._threads.append(threading.Thread(
                target=self._collator, args=(len(example_iters),), daemon=True))
        for t in self._threads:
            t.start()

    def _put(self, q: queue.Queue, item) -> bool:
        """put() that gives up once the consumer has closed the iterator."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _single_worker(self, it):
        batch = []
        try:
            for ex in it:
                if self._stop.is_set():
                    return
                batch.append(ex)
                if len(batch) == self.batch_size:
                    if not self._put(self._q, collate(batch)):
                        return
                    batch = []
            if batch and not self.drop_last:
                self._put(self._q, collate(batch))
        except Exception as e:  # raised again on the consuming thread
            self._put(self._q, e)
        self._put(self._q, None)

    def _producer(self, it):
        try:
            for ex in it:
                if not self._put(self._ex_q, ex):
                    return
        except Exception as e:  # handed to the collator, which raises it
            self._put(self._ex_q, e)
        self._put(self._ex_q, StopIteration())

    def _collator(self, n_producers: int):
        batch, done = [], 0
        try:
            while done < n_producers and not self._stop.is_set():
                try:
                    item = self._ex_q.get(timeout=0.2)
                except queue.Empty:
                    continue
                if isinstance(item, StopIteration):
                    done += 1
                    continue
                if isinstance(item, Exception):
                    raise item
                batch.append(item)
                if len(batch) == self.batch_size:
                    if not self._put(self._q, collate(batch)):
                        return
                    batch = []
            if batch and not self.drop_last:
                self._put(self._q, collate(batch))
        except Exception as e:
            self._put(self._q, e)
        self._put(self._q, None)

    def close(self):
        """Stop the threads (safe after a partial iteration) and wait for
        them; a thread still inside one example's work finishes it first."""
        self._stop.set()
        for q in (self._q, self._ex_q):
            if q is None:
                continue
            try:
                while True:  # so that a thread blocked in put() sees the flag
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            t.join()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item if self.transfer is None else self.transfer(item)


DATASETS = {
    "re10k": (DatasetRE10k, DatasetRE10kConfig),
    "acid": (DatasetRE10k, DatasetRE10kConfig),
    "dl3dv": (DatasetRE10k, DatasetRE10kConfig),
    "scannetpp": (DatasetRE10k, DatasetRE10kConfig),
    "mvimgnet": (DatasetRE10k, DatasetRE10kConfig),
    "scannet": (DatasetScannet, DatasetScannetConfig),
    "scannet_pose": (DatasetScannet, DatasetScannetConfig),
    "synthetic": (DatasetSyntheticScenes, SyntheticScenesConfig),
}


def _build_dataset(ds_dict: dict, stage: str, step_tracker, seed: int, device="cpu"):
    d = dict(ds_dict)
    sampler_cfg = d.pop("view_sampler", {"name": "bounded"})
    name = d.get("name", "re10k")
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; expected one of {sorted(DATASETS)}")
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
    `device`. Each dataset's seed is its loader's plus `global_rank`."""

    def __init__(self, dataset_cfgs: dict, data_loader_cfg: dict,
                 step_tracker=None, device="cuda", global_rank: int = 0):
        self.dataset_cfgs = dataset_cfgs
        self.loader_cfg = data_loader_cfg or {}
        self.step_tracker = step_tracker
        self.device = device
        self.global_rank = global_rank

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

    def train_batch_size(self) -> int:
        """The train loader's batch size, from the typed loader config."""
        return self._loader_params("train", next(iter(self.dataset_cfgs), "")).batch_size

    def _iters(self, stage: str, num_workers: int = 0) -> list:
        iters = []
        for name, ds_dict in self.dataset_cfgs.items():
            seed = self._loader_params(stage, name).seed + self.global_rank
            ds = _build_dataset(dict(ds_dict, name=ds_dict.get("name", name)), stage,
                                self.step_tracker, seed, self.device)
            if num_workers > 0 and hasattr(ds, "iter_shard"):
                iters.extend(ds.iter_shard(w, num_workers) for w in range(num_workers))
            else:
                iters.append(iter(ds))
        return iters

    def loader(self, stage: str) -> Iterator[dict]:
        """Batches of `batch_size` examples on the device, the datasets
        taken in turns. Train: collated ahead on background threads
        (`PrefetchIterator`, `prefetch` batches; with `num_workers > 0` a
        chunk reader's shards each on a producer thread), the last short
        batch dropped; call `close()` when leaving it early. Val and test:
        made on the calling thread, the last short batch kept."""
        lp = self._loader_params(stage, next(iter(self.dataset_cfgs), ""))
        if stage != "train":
            return self._batches(self._iters(stage), lp.batch_size)
        iters = self._iters(stage, lp.num_workers)

        def transfer(b):
            return to_device(b, self.device)

        if lp.num_workers > 0:
            return PrefetchIterator(iters, batch_size=lp.batch_size, prefetch=lp.prefetch,
                                    drop_last=True, transfer=transfer)

        def round_robin():
            live = list(iters)
            while live:
                for it in list(live):
                    try:
                        yield next(it)
                    except StopIteration:
                        live.remove(it)

        return PrefetchIterator(round_robin(), batch_size=lp.batch_size,
                                prefetch=lp.prefetch, drop_last=True, transfer=transfer)

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

    def train_dataloader(self) -> PrefetchIterator:
        return self.loader("train")

    def val_dataloader(self, num_examples: int = 1) -> Iterator[dict]:
        """The first `num_examples` batches of the val split (the
        reference's ValidationWrapper)."""
        loader = self.loader("val")
        for i, batch in enumerate(loader):
            if i >= num_examples:
                break
            yield batch

    def test_dataloader(self):
        return self.loader("test")
