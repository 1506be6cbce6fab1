"""Loading trained weights (the counterpart of the JAX package's
`utils/checkpointing.load_weights` dispatch, `:167-195`, for the weights
the repository holds).

The committed snapshot `outputs/synthetic_pose/ckpt_committed/
weights_latest.npz` stores the JAX param tree as float16 leaves `arr_0`,
`arr_1`, ... in `jax.tree_util.tree_leaves` order, beside the scalars
`_total_steps` and `_segment` (written by tools/pose_segments.py:44-62).
That order takes dict keys sorted at every level, and the stacked
`enc_blocks` / `dec_blocks` as one leaf each with a leading depth axis.
`jax_leaf_specs` rebuilds it from the port's module without JAX, through
the weight bridge's key mapping (`weights.torch_key`).
"""
from __future__ import annotations

import pathlib

import numpy as np
from torch import nn

from .weights import STACKED, load_jax_params, torch_key



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


def _nest(path: list, value, tree: dict):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def load_weights(path, model: nn.Module) -> dict:
    """Load the committed float16 npz into `model` (strict: every leaf
    count, name and shape is checked) and return its metadata
    (`total_steps`, `segment`). Leaves are cast to float32; the load copies
    them to each parameter's device and dtype."""
    p = pathlib.Path(path)
    if p.is_dir():
        raise NotImplementedError(
            f"{path}: orbax checkpoint directories are not read by the port yet "
            "(ROADMAP.md §1 item 1, checkpointing); pass a float16 .npz snapshot")
    if p.suffix != ".npz":
        raise NotImplementedError(
            f"{path}: a torch .ckpt needs the JAX package's utils/ckpt_convert.py, "
            "not ported yet (ROADMAP.md §1 item 7); pass a float16 .npz snapshot")
    specs = jax_leaf_specs(model)
    tree = {}
    with np.load(p) as z:
        n = sum(1 for k in z.files if k.startswith("arr_"))
        if n != len(specs):
            raise ValueError(f"{path} has {n} leaves, the model {len(specs)} "
                             "(another config than the one it was written under)")
        for i, (jpath, shape) in enumerate(specs):
            a = np.asarray(z[f"arr_{i}"])
            if a.shape != shape:
                raise ValueError(f"arr_{i} ({'.'.join(jpath)}): shape {a.shape}, "
                                 f"the model's {shape}")
            _nest(jpath, a.astype(np.float32), tree)
        meta = {k.lstrip("_"): int(z[k]) for k in ("_total_steps", "_segment")
                if k in z.files}
    load_jax_params(model, tree)
    return meta
