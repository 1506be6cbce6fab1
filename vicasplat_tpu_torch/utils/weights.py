"""Weight bridge: the JAX package's param tree -> this port's state_dict.

The port's modules carry the JAX tree's names, so a key is the tree path
joined by dots, with three rules:
- stacked blocks (`enc_blocks`, `dec_blocks`, and the DUSt3R teacher's
  `dec_blocks2`; leading depth axis) become `ModuleList` entries:
  `enc_blocks.<i>.<...>`;
- a linear kernel `w` (in, out) becomes `weight` (out, in); a conv kernel
  `w` (kh, kw, in, out), and a transposed-conv kernel (kh, kw, out, in),
  become `weight` (out, in, kh, kw) and (in, out, kh, kw): one permutation;
- `b` becomes `bias` and a layer norm's `scale` becomes `weight`.
Other leaves (the camera tokens, the LayerScales `ls`) keep their names,
and so do an MoE layer's expert stacks (`mlp.experts.fc1.w` (E, d_in,
d_out), `.b` (E, d_out)), which the port keeps in JAX's layout; in a
stacked block they are (L, E, ...) and split along L like the rest.

Any tree of the params' structure crosses the same way, a JAX gradient tree
included (`state_dict_from_jax(grads)` gives the layout of `p.grad`).
`jax_tree_from_state_dict` is the inverse, for comparing parameters after
an optimizer step.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

STACKED = ("enc_blocks", "dec_blocks", "dec_blocks2")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def torch_key(path: list, ndim: int) -> tuple:
    """Path of a leaf in the JAX tree (block index included) -> (state_dict
    key, axis permutation of its array or None)."""
    *parent, name = path
    perm = None
    if "experts" in parent:  # MoE expert stacks keep JAX's (E, d_in, d_out)
        return ".".join(path), None
    if name == "w":
        name = "weight"
        perm = (1, 0) if ndim == 2 else (3, 2, 0, 1)
    elif name == "b":
        name = "bias"
    elif name == "scale":
        name = "weight"
    return ".".join(parent + [name]), perm


def _to_numpy(value) -> np.ndarray:
    a = np.asarray(value)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def state_dict_from_jax(params: dict) -> dict:
    """Nested dicts of numpy (or JAX) arrays -> {key: float tensor}."""
    out = {}

    def walk(node, path):
        if not isinstance(node, dict):
            a = _to_numpy(node)
            key, perm = torch_key(path, a.ndim)
            if perm is not None:
                a = a.transpose(perm)
            out[key] = torch.tensor(a)
            return
        for k, v in node.items():
            if k in STACKED:
                v = _map(_to_numpy, v)
                depth = len(next(iter(_leaves(v))))
                for i in range(depth):
                    walk(_map(lambda a: a[i], v), path + [k, str(i)])
            else:
                walk(v, path + [k])

    walk(params, [])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def jax_tree_from_state_dict(state: dict, template: dict) -> dict:
    """The port's {key: tensor} -> nested dicts of float32 numpy arrays shaped
    like `template` (a JAX param tree, or any tree of arrays with shapes):
    the bridge's mapping backwards, stacked blocks stacked again."""

    def leaf(path, shape):
        key, perm = torch_key(path, len(shape))
        a = state[key].detach().float().cpu().numpy()
        return a.transpose(np.argsort(perm)) if perm is not None else a

    def walk(node, path):
        if not isinstance(node, dict):
            return leaf(path, np.shape(node))
        out = {}
        for k, v in node.items():
            if k in STACKED:  # one block's shapes, then each block's leaves
                block = _map(lambda a: np.broadcast_to(0.0, np.shape(a)[1:]), v)
                depth = np.shape(next(iter(_leaves(v))))[0]
                out[k] = _stack([walk(block, path + [k, str(i)])
                                 for i in range(depth)])
            else:
                out[k] = walk(v, path + [k])
        return out

    return walk(template, [])


def _stack(blocks: list):
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Load the JAX param tree into `model` with strict key and shape checks;
    tensors are copied to each parameter's device and dtype."""
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model
