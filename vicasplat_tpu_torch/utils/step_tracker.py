"""Step tracker (port of vicasplat_tpu/utils/step_tracker.py): publishes the
train loop's global step to the data pipeline, whose view sampler reads it
for its curriculum.

The train loader's producer runs on a thread of the same process, so a
lock-guarded int suffices; a `multiprocessing.Value` backend serves
process-based loaders.
"""
from __future__ import annotations

import multiprocessing
import threading


class StepTracker:
    def __init__(self, use_shared_memory: bool = False):
        if use_shared_memory:
            self._value = multiprocessing.Value("q", 0)
            self._lock = self._value.get_lock()
            self._shared = True
        else:
            self._step = 0
            self._lock = threading.Lock()
            self._shared = False

    def set_step(self, step: int) -> None:
        with self._lock:
            if self._shared:
                self._value.value = int(step)
            else:
                self._step = int(step)

    def get_step(self) -> int:
        with self._lock:
            return self._value.value if self._shared else self._step
