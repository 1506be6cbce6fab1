"""Constant tensors built from host data once per key and reused.

The forward and the render make a few small tensors from Python or numpy
data (input statistics, RoPE tables, the camera mask, the SH degree mask,
the background colour). Built on every call, each one is a pageable host to
device copy, which a CUDA graph capture refuses. `device_constant` builds
each one once per (arguments, device, dtype), at the first eager call, and
hands the same tensor back afterwards, so a captured program only reads it.

The tensors are made outside inference mode and autograd, so that a first
call under `torch.inference_mode()` leaves tensors a later training step may
save for its backward. Callers must not write into them.

Under a trace (`torch.export`) the function runs uncached: the tensors it
makes there are the trace's fake tensors, which the cache must never hand
to a later eager call; the trace records them as the program's constants.
"""
from __future__ import annotations

import functools

import torch


def device_constant(fn):
    """Decorator: `fn(*args)` with hashable args (a device among them) is
    built once per argument tuple and cached for the life of the process."""

    @functools.lru_cache(maxsize=None)
    def build(*args):
        with torch.inference_mode(False), torch.no_grad():
            return fn(*args)

    @functools.wraps(fn)
    def cached(*args):
        if torch.compiler.is_compiling():
            return fn(*args)
        return build(*args)

    return cached


def as_device(device) -> torch.device:
    """A hashable cache key for `device` (None is the CPU)."""
    return torch.device("cpu") if device is None else torch.device(device)
