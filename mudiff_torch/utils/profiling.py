"""Profiling hooks of the training loop.

The port of ``mudiff_tpu/utils/profiling.py``:

* ``maybe_profile(step, out_dir)`` traces steps [start, start + num)
  with ``torch.profiler`` (CPU and, on a card, CUDA activity) and writes
  a Chrome trace ``trace_steps_<start>-<end>.json`` into ``out_dir``.
  The directory is an argument; no environment variable is read.
* ``device_memory_stats`` reads ``torch.cuda.memory_stats`` of each
  visible card (an empty dict without one).
* ``StepTimer`` splits a logging window into data wait and the rest.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

_ACTIVE: Dict[str, "torch.profiler.profile"] = {}


@contextlib.contextmanager
def maybe_profile(step: int, out_dir: Optional[str] = None, start: int = 10,
                  num: int = 5) -> Iterator[None]:
    """Trace steps [start, start + num) into ``out_dir`` when it is given."""
    active = bool(out_dir) and start <= step < start + num
    if active and step == start:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _ACTIVE[out_dir] = prof
    try:
        yield
    finally:
        if active and step == start + num - 1 and out_dir in _ACTIVE:
            prof = _ACTIVE.pop(out_dir)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(out_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(out_dir, f"trace_steps_{start}-{start + num - 1}.json"))


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-card memory in GiB: in use, peak, and the card's total."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gib": s.get("allocated_bytes.all.current", 0) / 2 ** 30,
            "peak_bytes_gib": s.get("allocated_bytes.all.peak", 0) / 2 ** 30,
            "bytes_limit_gib": torch.cuda.get_device_properties(i).total_memory / 2 ** 30,
        }
    return out


class StepTimer:
    """Accumulates data-wait vs total time over a logging window."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._window_start = time.time()
        self._mark = time.time()
        self.data_time = 0.0

    def mark_data_ready(self) -> None:
        self.data_time += time.time() - self._mark

    def mark_step_done(self) -> None:
        self._mark = time.time()

    def window(self) -> float:
        return time.time() - self._window_start
