"""Experiment loggers (port of vicasplat_tpu/utils/loggers.py:25-157).

`make_logger(cfg)` follows the JAX package's choice: with `wandb.mode` other
than "disabled", a `WandbLogger` when the `wandb` package imports, else a
`WandbOfflineLogger` (a plain-files run directory with the same scalars,
config and media); with wandb disabled, TensorBoard's `SummaryWriter` when
`torch.utils.tensorboard` imports, else None. Every logger has the
SummaryWriter surface the train loop uses: `add_scalar`, `add_image`,
`close`.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import numpy as np

from .image_io import encode_png, to_uint8


def make_logger(cfg):
    """cfg: RootConfig. Returns a logger, or None when none is available."""
    wb = getattr(cfg, "wandb", None)
    if wb is not None and wb.mode != "disabled":
        try:
            import wandb  # noqa: F401
        except ImportError:
            print("wandb package not available - falling back to the offline "
                  f"run dir under {cfg.output_dir}/wandb_offline (same scalars, "
                  "config and media; see utils/loggers.py to replay it into a "
                  "wandb server)")
            return WandbOfflineLogger(cfg)
        return WandbLogger(cfg)
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=f"{cfg.output_dir}/tb")


def _config_dict(cfg):
    return dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else {
        "repr": repr(cfg)}


class WandbLogger:
    """The wandb adapter (needs the wandb package): project, entity, name,
    tags and the whole config, as the reference's init."""

    def __init__(self, cfg):
        import wandb

        self._wandb = wandb
        self.run = wandb.init(
            project=cfg.wandb.project, entity=cfg.wandb.entity,
            name=f"{cfg.wandb.name} ({cfg.output_dir})",
            tags=list(cfg.wandb.tags) or None, mode=cfg.wandb.mode,
            dir=cfg.output_dir, config=_config_dict(cfg))

    def add_scalar(self, tag, value, step):
        self._wandb.log({tag: float(value)}, step=int(step))

    def add_image(self, tag, img, step, dataformats="CHW"):
        arr = np.asarray(img)
        if dataformats == "CHW":
            arr = arr.transpose(1, 2, 0)
        self._wandb.log({tag: self._wandb.Image(arr)}, step=int(step))

    def close(self):
        if self.run is not None:
            self.run.finish()


class WandbOfflineLogger:
    """A wandb-shaped run directory without the wandb package, one run a
    process:

        <output_dir>/wandb_offline/run-<utc>/
            config.json     the whole RootConfig
            history.jsonl   one {"_step": n, "_timestamp": t, tag: v} a log
            summary.json    the last value of every tag (written on close)
            media/<tag>/<step>.png

    Replay into a wandb server:

        import json, wandb
        run = wandb.init(project=..., config=json.load(open("config.json")))
        for line in open("history.jsonl"):
            d = json.loads(line); run.log(d, step=d.pop("_step"))
    """

    def __init__(self, cfg):
        stamp = time.strftime("%Y%m%d_%H%M%S", time.gmtime())
        self.dir = pathlib.Path(cfg.output_dir) / "wandb_offline" / f"run-{stamp}"
        self.dir.mkdir(parents=True, exist_ok=True)
        (self.dir / "config.json").write_text(
            json.dumps(_config_dict(cfg), indent=2, default=str))
        self._history = open(self.dir / "history.jsonl", "a")
        self._summary = {}

    def _write(self, rec: dict):
        self._history.write(json.dumps(rec) + "\n")
        self._history.flush()

    def add_scalar(self, tag, value, step):
        self._write({"_step": int(step), "_timestamp": time.time(), tag: float(value)})
        self._summary[tag] = float(value)

    def add_image(self, tag, img, step, dataformats="CHW"):
        """img: float in [0, 1] or uint8, (C, H, W) or with dataformats
        "HWC" (H, W, C)."""
        arr = np.asarray(img)
        if dataformats == "CHW":
            arr = arr.transpose(1, 2, 0)
        if arr.dtype != np.uint8:
            arr = to_uint8(arr)
        d = self.dir / "media" / tag.replace("/", "_")
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"{int(step):08d}.png"
        path.write_bytes(encode_png(arr))
        self._write({"_step": int(step), "_timestamp": time.time(),
                     tag: {"_type": "image-file", "path": str(path)}})

    def close(self):
        (self.dir / "summary.json").write_text(json.dumps(self._summary, indent=2))
        self._history.close()
