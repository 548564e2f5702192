"""The traced window: torch.profiler over the benchmark's own spans, and
what the per-layer readers read from it.

A traffic driver (``perfbench/drivers/``) runs its traced window inside
``traced(...)``; the benchmark's spans are
``torch.profiler.record_function`` ranges named ``perfbench.<what>``
around set-up, each request and each training iteration, and
``perfbench.window`` around the whole.  ``TraceView`` holds the
device's kernel intervals inside the window, the window's wall time,
the slices it completed and the model's work over it (``arith.Work``),
and gives the device's busy time (the union of kernel intervals) and
the breakdown (the kernels that took most time; the longest idle gaps
named by the span and the host op running in them).
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

WINDOW = "perfbench.window"


@contextlib.contextmanager
def span(name: str):
    """A benchmark span (a profiler range; free when no profiler runs)."""
    import torch

    with torch.profiler.record_function(f"perfbench.{name}"):
        yield


def families(root: Path) -> Dict[str, List[re.Pattern]]:
    """{family: compiled name patterns} from ``perfbench/kernels/*.json``."""
    out = {}
    for p in sorted((root / "perfbench" / "kernels").glob("*.json")):
        with open(p) as f:
            out[p.stem] = [re.compile(x) for x in json.load(f)["patterns"]]
    return out


class TraceView:
    """The traced window, as the readers see it."""

    def __init__(self, kind: str, kernels: List[Tuple[str, float, float]], window_s: float,
                 slices: int, work, peaks, fams: Dict[str, List[re.Pattern]],
                 gaps: Optional[List[Tuple[str, float]]] = None):
        self.kind = kind            # "sample" or "train": the metric's split
        self.kernels = kernels      # (name, start s, end s), clipped to the window
        self.window_s = window_s
        self.slices = slices
        self.work = work            # arith.Work over the window
        self.peaks = peaks          # peaks.Peaks of the card
        self.families = fams
        self.gaps = gaps or []
        self.busy_s = _union(kernels)

    def family_of(self, name: str) -> Optional[str]:
        low = name.lower()
        for fam, pats in self.families.items():
            if any(p.search(low) for p in pats):
                return fam
        return None

    def device_s(self, family: Optional[str]) -> float:
        """Device seconds of the kernels of ``family`` (None: of no family)."""
        return sum(e - s for n, s, e in self.kernels if self.family_of(n) == family)

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = {}
        for n, s, e in self.kernels:
            by_name[n[:120]] = by_name.get(n[:120], 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        by_gap: Dict[str, float] = {}
        for n, sec in self.gaps:
            by_gap[n] = by_gap.get(n, 0.0) + sec
        gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}


def _union(iv: List[Tuple[str, float, float]]) -> float:
    total, end = 0.0, -float("inf")
    for _, s, e in sorted(iv, key=lambda x: x[1]):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _gaps(kernels, lo, hi) -> List[Tuple[float, float]]:
    out, end = [], lo
    for _, s, e in sorted(kernels, key=lambda x: x[1]):
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if hi > end:
        out.append((end, hi))
    return out


def _name_gaps(gaps, spans, ops, keep: int = 400) -> List[Tuple[str, float]]:
    """Each of the ``keep`` longest gaps named ``<span>/<host op>``: the
    innermost benchmark span and the outermost host op at its middle."""
    spans = sorted(spans, key=lambda x: x[1])
    ops = sorted(ops, key=lambda x: x[1])
    op_starts = [o[1] for o in ops]
    named = []
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:keep]:
        mid = 0.5 * (lo + hi)
        inner = [s for s in spans if s[1] <= mid <= s[2] and s[0] != WINDOW]
        sp = min(inner, key=lambda s: s[2] - s[1])[0] if inner else "window"
        i = bisect.bisect_right(op_starts, mid)
        best = None
        for j in range(i - 1, max(-1, i - 4000), -1):
            n, s, e = ops[j]
            if e >= mid and (best is None or s < best[1]):
                best = ops[j]
        op = best[0] if best is not None else "python"
        named.append((f"{sp.replace('perfbench.', '')}/{op}", hi - lo))
    return named


@contextlib.contextmanager
def traced(holder: dict):
    """Profile the block (CPU and CUDA activity) under the window span;
    on exit ``holder`` gets ``kernels``, ``window_s`` and ``gaps``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            yield
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels, spans, ops = [], [], []
    for evt in prof.events():
        s, e = evt.time_range.start / 1e6, evt.time_range.end / 1e6
        if evt.device_type == DeviceType.CUDA:
            if getattr(evt, "is_user_annotation", False) or evt.name.startswith("Optimizer."):
                continue
            kernels.append((evt.name, s, e))
        elif evt.name.startswith("perfbench."):
            spans.append((evt.name, s, e))
        else:
            ops.append((evt.name, s, e))
    win = [x for x in spans if x[0] == WINDOW]
    lo, hi = (win[0][1], win[0][2]) if win else (0.0, wall)
    kernels = [(n, max(s, lo), min(e, hi)) for n, s, e in kernels if e > lo and s < hi]
    holder["kernels"] = kernels
    holder["window_s"] = hi - lo if win else wall
    holder["gaps"] = _name_gaps(_gaps(kernels, lo, hi), spans, ops)


def read_metric(root: Path, name: str, tv: TraceView) -> Optional[float]:
    """The reader ``perfbench/metrics/<name>.py`` on ``tv`` (None: it
    found nothing to read)."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(tv)
