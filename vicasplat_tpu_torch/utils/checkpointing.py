"""Checkpoints in the port's own format (the counterpart of the JAX
package's `utils/checkpointing.py`, which writes orbax directories; orbax
is not a dependency of the port).

Every checkpoint is one npz in the layout of the committed snapshot
`outputs/synthetic_pose/ckpt_committed/weights_latest.npz`: the JAX param
tree's leaves `arr_0`, `arr_1`, ... in `jax.tree_util.tree_leaves` order,
beside the scalar `_total_steps` (the committed file also has `_segment`;
tools/pose_segments.py:44-62). That order takes dict keys sorted at every
level, and the stacked `enc_blocks` / `dec_blocks` as one leaf each with a
leading depth axis. `jax_leaf_specs` rebuilds it from the port's module
without JAX, through the weight bridge's key mapping (`weights.torch_key`),
so the JAX side reads these files as it reads the committed one
(`tools/jax_eval_reference.load_npz_params`).

- A weights-only snapshot holds the float32 parameters and `_total_steps`.
- A full-state checkpoint adds the optimizer: `_count` (AdamW's step
  count, which is also the schedule's position), `_moment_dtype`, Adam's
  moments `mu_i` and `nu_i` and, with an EMA, `ema_i`, each in the
  parameters' leaf order and layout, in float32. A bfloat16 first moment
  widens to float32 exactly and narrows back exactly, so a restore is
  exact bit for bit.
`load_weights` reads the parameters of either kind, and of a PyTorch
checkpoint in the reference's layout (utils/ckpt_convert.py);
`restore_train_state` needs the full state, and takes any other file as
weights only.
"""
from __future__ import annotations

import os
import pathlib
import re
import threading
from typing import Optional

import numpy as np
import torch
from torch import nn

from .weights import (
    STACKED,
    jax_tree_from_state_dict,
    load_jax_params,
    state_dict_from_jax,
    torch_key,
)



def _jax_name(model: nn.Module, parent: list, name: str) -> str:
    """The JAX tree's name of parameter `name` of the module at `parent`:
    a layer norm's are `scale` and `bias`, a linear or conv layer's `w`
    and `b`."""
    norm = isinstance(model.get_submodule(".".join(parent)), nn.LayerNorm)
    if name == "weight":
        return "scale" if norm else "w"
    if name == "bias":
        return "bias" if norm else "b"
    return name


def jax_leaf_specs(model: nn.Module) -> list:
    """[(JAX tree path, JAX shape)] of `model`'s parameters, in the order of
    `jax.tree_util.tree_leaves` of the JAX package's `init_vicasplat` for
    the same config. Stacked blocks give one leaf per name, with the depth
    as the leading axis."""
    specs = {}
    for key, t in model.state_dict().items():
        *parent, name = key.split(".")
        jname = _jax_name(model, parent, name)
        path, stacked = list(parent), False
        for s in STACKED:
            if s in path:
                i = path.index(s)
                stacked = True
                path = path[:i + 1] + path[i + 2:]  # drop the block index
        full = tuple(path + [jname])
        # the bridge's mapping of this JAX path must give back this key
        tkey, perm = torch_key(parent + [jname], t.ndim)
        if tkey != key:
            raise ValueError(f"no JAX name for {key} (got {tkey})")
        shape = tuple(t.shape)
        if perm is not None:
            shape = tuple(shape[perm.index(j)] for j in range(len(shape)))
        specs[full] = (shape, specs.get(full, (None, 0))[1] + 1 if stacked else None)
    # JAX flattens each dict by its sorted keys: leaf paths compared
    # component by component
    return [(list(path), shape if n is None else (n,) + shape)
            for path, (shape, n) in sorted(specs.items())]


def _get(tree: dict, path: list):
    for p in path:
        tree = tree[p]
    return tree


def to_jax_leaves(model: nn.Module, tensors: dict) -> list:
    """{parameter name: tensor} -> float32 host copies in JAX leaf order and
    layout (the weight bridge backwards: stacked blocks stacked, kernels
    transposed)."""
    specs = jax_leaf_specs(model)
    template = {}
    for path, shape in specs:
        _nest(path, np.broadcast_to(np.float32(0), shape), template)
    tree = jax_tree_from_state_dict(tensors, template)
    return [np.array(_get(tree, path)) for path, _ in specs]


def from_jax_leaves(model: nn.Module, leaves: list, like: dict) -> dict:
    """Host arrays in JAX leaf order -> {parameter name: tensor} on the
    device and dtype of `like`'s tensors (the weight bridge)."""
    tree = {}
    for (path, _), a in zip(jax_leaf_specs(model), leaves):
        _nest(path, a, tree)
    out = state_dict_from_jax(tree)
    if set(out) != set(like):
        raise ValueError(f"leaves for {sorted(set(out) ^ set(like))[:4]} do not match "
                         "the model's parameters")
    return {k: t.to(device=like[k].device, dtype=like[k].dtype) for k, t in out.items()}


def snapshot(model: nn.Module, step: int, optimizer=None) -> dict:
    """The arrays of a checkpoint at `step`, copied to the host: weights
    only, or with `optimizer` (an `AdamW`) the full state."""
    params = dict(model.named_parameters())
    arrays = {f"arr_{i}": a for i, a in enumerate(to_jax_leaves(model, params))}
    arrays["_total_steps"] = np.asarray(step, np.int64)
    if optimizer is not None:
        arrays["_count"] = np.asarray(optimizer.count, np.int64)
        arrays["_moment_dtype"] = np.asarray(optimizer.cfg.moment_dtype)
        state = {"mu": optimizer.mu, "nu": optimizer.nu}
        if optimizer.ema is not None:
            state["ema"] = optimizer.ema
        for kind, tensors in state.items():
            for i, a in enumerate(to_jax_leaves(model, tensors)):
                arrays[f"{kind}_{i}"] = a
    return arrays


def write_npz(path, arrays: dict) -> None:
    """Write to a temporary name beside `path`, then rename: a reader never
    sees a partial file."""
    path = pathlib.Path(path)
    tmp = path.with_name(f".{path.name}.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


class CheckpointManager:
    """Step checkpoints `step_<8 digits>.npz` in `directory`, the newest
    `keep` kept (JAX `CheckpointManager`). With `async_save`, `save()`
    copies the state to the host, hands the write to a background thread
    and returns; the next `save()` first waits for it, and `finalize()`
    must be called once after the last save. A write goes to a hidden
    temporary name and is renamed when done, so `latest()` and pruning see
    only finished checkpoints."""

    def __init__(self, directory, every_n_steps: int = 5000, keep: int = 5,
                 async_save: bool = True):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.every_n_steps = every_n_steps
        self.keep = keep
        self.async_save = async_save
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _ckpt_path(self, step: int) -> pathlib.Path:
        return self.directory / f"step_{step:08d}.npz"

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every_n_steps == 0

    def _wait(self):
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("a checkpoint write failed") from err

    def save(self, step: int, model: nn.Module, optimizer=None) -> pathlib.Path:
        """Weights only, or the full state with `optimizer`."""
        self._wait()
        arrays = snapshot(model, step, optimizer)
        path = self._ckpt_path(step)

        def write():
            try:
                write_npz(path, arrays)
                self._prune()
            except BaseException as e:  # raised again by the next _wait
                self._error = e

        if self.async_save:
            self._writer = threading.Thread(target=write, daemon=False)
            self._writer.start()
        else:
            write()
            self._wait()
        return path

    def finalize(self):
        """Wait for an in-flight write (call once after the last save)."""
        self._wait()
        self._prune()

    def _completed(self) -> list:
        return sorted(p for p in self.directory.glob("step_*.npz")
                      if re.fullmatch(r"step_\d+\.npz", p.name))

    def _prune(self):
        for old in self._completed()[: -self.keep]:
            old.unlink(missing_ok=True)

    def latest(self) -> Optional[pathlib.Path]:
        ckpts = self._completed()
        return ckpts[-1] if ckpts else None


def _check_path(path) -> pathlib.Path:
    p = pathlib.Path(path)
    if p.is_dir():
        raise NotImplementedError(
            f"{path}: orbax checkpoint directories are not read by the port, which "
            "writes its own npz checkpoints (orbax is not one of its dependencies; "
            "ROADMAP.md §1 item 1); pass an .npz checkpoint")
    return p


def _is_npz(p: pathlib.Path) -> bool:
    """An npz of this module's layout; any other file is a PyTorch
    checkpoint of the reference's layout (utils/ckpt_convert.py)."""
    return p.suffix == ".npz"


def _read_leaves(z, prefix: str, specs: list, path) -> list:
    n = sum(1 for k in z.files if re.fullmatch(prefix + r"_\d+", k))
    if n != len(specs):
        raise ValueError(f"{path} has {n} {prefix} leaves, the model {len(specs)} "
                         "(another config than the one it was written under)")
    leaves = []
    for i, (jpath, shape) in enumerate(specs):
        a = np.asarray(z[f"{prefix}_{i}"])
        if a.shape != shape:
            raise ValueError(f"{prefix}_{i} ({'.'.join(jpath)}): shape {a.shape}, "
                             f"the model's {shape}")
        leaves.append(a)
    return leaves


def is_full_state(path) -> bool:
    p = _check_path(path)
    if not _is_npz(p):
        return False
    with np.load(p) as z:
        return "_count" in z.files


def restore_train_state(path, model: nn.Module, optimizer) -> int:
    """Load a full-state checkpoint into `model` and `optimizer` (an `AdamW`
    of the same config) bit for bit, and return its step. A weights-only
    snapshot loads its weights, leaves the optimizer as it is and returns 0,
    with a warning (JAX `restore_train_state`'s fallback); any other failure
    raises."""
    p = _check_path(path)
    if not is_full_state(p):
        print(f"WARNING: {path} is a weights-only snapshot; restoring its "
              "weights, optimizer state and step reset", flush=True)
        load_weights(p, model)
        return 0
    specs = jax_leaf_specs(model)
    params = dict(model.named_parameters())
    with np.load(p) as z:
        if str(z["_moment_dtype"]) != optimizer.cfg.moment_dtype:
            raise ValueError(f"{path}: moments in {z['_moment_dtype']}, the "
                             f"optimizer's in {optimizer.cfg.moment_dtype}")
        has_ema = any(k.startswith("ema_") for k in z.files)
        if has_ema != (optimizer.ema is not None):
            raise ValueError(f"{path}: EMA {'present' if has_ema else 'absent'}, "
                             f"the optimizer's ema_decay {optimizer.cfg.ema_decay}")
        weights = from_jax_leaves(model, _read_leaves(z, "arr", specs, path), params)
        mu = from_jax_leaves(model, _read_leaves(z, "mu", specs, path), optimizer.mu)
        nu = from_jax_leaves(model, _read_leaves(z, "nu", specs, path), optimizer.nu)
        ema = (from_jax_leaves(model, _read_leaves(z, "ema", specs, path), optimizer.ema)
               if has_ema else None)
        count, step = int(z["_count"]), int(z["_total_steps"])
    with torch.no_grad():
        for k, prm in params.items():
            prm.copy_(weights[k])
    optimizer.mu, optimizer.nu, optimizer.count = mu, nu, count
    if ema is not None:
        optimizer.ema = ema
    return step


def load_ema(path, model: nn.Module) -> bool:
    """Load the EMA of a full-state checkpoint into `model` as its weights;
    False (nothing loaded) when the file has none."""
    p = _check_path(path)
    if not _is_npz(p):
        return False
    with np.load(p) as z:
        if not any(k.startswith("ema_") for k in z.files):
            return False
        params = dict(model.named_parameters())
        ema = from_jax_leaves(model, _read_leaves(z, "ema", jax_leaf_specs(model), path),
                              params)
    with torch.no_grad():
        for k, prm in params.items():
            prm.copy_(ema[k])
    return True


def _nest(path: list, value, tree: dict):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def load_weights(path, model: nn.Module) -> dict:
    """Load the parameters of an npz checkpoint (the committed float16
    snapshot, or either kind this module writes) into `model` (strict:
    every leaf count, name and shape is checked) and return its metadata
    (`total_steps`, `segment`). Leaves are cast to float32; the load copies
    them to each parameter's device and dtype. Any other file is read as a
    PyTorch checkpoint of the reference's layout (a Lightning `.ckpt`, or a
    DUSt3R / MASt3R one) through `ckpt_convert.load_torch_checkpoint`,
    strictly, with no metadata, as the JAX package's `load_weights` reads
    it."""
    p = _check_path(path)
    if not _is_npz(p):
        from .ckpt_convert import load_torch_checkpoint

        model.load_state_dict(load_torch_checkpoint(p), strict=True)
        return {}
    specs = jax_leaf_specs(model)
    tree = {}
    with np.load(p) as z:
        for (jpath, _), a in zip(specs, _read_leaves(z, "arr", specs, path)):
            _nest(jpath, a.astype(np.float32), tree)
        meta = {k.lstrip("_"): int(z[k]) for k in ("_total_steps", "_segment")
                if k in z.files}
    load_jax_params(model, tree)
    return meta
