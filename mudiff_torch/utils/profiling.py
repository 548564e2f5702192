"""Profiling hooks of the training loop.

The port of ``mudiff_tpu/utils/profiling.py``:

* ``maybe_profile(step, out_dir)`` traces steps [start, start + num)
  with ``torch.profiler`` (CPU and, on a card, CUDA activity) and writes
  a Chrome trace ``trace_steps_<start>-<end>.json`` into ``out_dir``.
  The directory is an argument; no environment variable is read.
* ``device_memory_stats`` reads ``torch.cuda.memory_stats`` of each
  visible card (an empty dict without one).
* ``StepTimer`` splits a logging window into data wait and the rest.
* ``span(name, args)`` is the port's own range ``mudiff.<name>`` around
  a part of the work (a sampler step, a generator, a region, a norm, the
  critic, K1's two gradients, a remat recompute, a part of a training
  step).  While a ``torch.profiler`` records, it is a
  ``record_function`` on the profiler's clock, the clock of the device
  kernels, so a kernel can be put down to the spans open where it was
  launched (``perfbench/attribution.py``); at every other time it is one
  shared no-op context and costs one flag read.  The profiler's own
  enabled flag is the switch: ``maybe_profile``'s traces and any other
  ``torch.profiler`` window get the spans.  The kernel wrappers' forwards
  carry none: at hundreds a training iteration they cost more under the
  profiler than they tell.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, ContextManager, Dict, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
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


def span(name: str, args: Optional[Dict[str, Any]] = None) -> ContextManager:
    """``mudiff.<name>`` as a profiler range while a profiler records (its
    ``args`` as the range's JSON arguments), else the shared no-op.
    Names are fixed strings; what varies (a step, a timestep) goes in
    ``args``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(
        f"mudiff.{name}", None if args is None else json.dumps(args, default=str))


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
