"""Wall-clock timing by tag and device-memory reporting (port of
vicasplat_tpu/utils/benchmarker.py:19-94). `time_fn` synchronizes the card
before it stops the clock, as the JAX version blocks on its results, and
`dump` / `dump_memory` write the JAX version's JSON keys; peak memory is
`torch.cuda.max_memory_allocated`."""
from __future__ import annotations

import json
import pathlib
import time
from collections import defaultdict

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Benchmarker:
    def __init__(self):
        self.execution_times = defaultdict(list)

    def time_fn(self, tag: str, fn, *args, **kwargs):
        """Run fn and time it to completion on the card."""
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync()
        self.execution_times[tag].append(time.perf_counter() - start)
        return out

    def summarize(self) -> dict:
        """Per-tag stats. `mean_warm_s` drops call 0 when there is more than
        one (the first call builds kernels and warms caches); `calls_s`
        keeps every call."""
        out = {}
        for tag, v in self.execution_times.items():
            warm = v[1:] if len(v) > 1 else v
            out[tag] = {
                "count": len(v),
                "mean_s": sum(v) / len(v),
                "mean_warm_s": sum(warm) / len(warm),
                "total_s": sum(v),
                "calls_s": [round(t, 6) for t in v],
            }
        return out

    def dump(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        with open(path, "w") as f:
            json.dump(self.summarize(), f, indent=2)

    @staticmethod
    def memory_stats() -> dict:
        """{device_i: bytes_in_use, peak_bytes_in_use, bytes_limit} of each
        CUDA device (none without a card)."""
        if not torch.cuda.is_available():
            return {}
        return {f"device_{i}": {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        } for i in range(torch.cuda.device_count())}

    def dump_memory(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        with open(path, "w") as f:
            json.dump(self.memory_stats(), f, indent=2)
