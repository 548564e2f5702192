"""What the per-layer readers compute, once for every split of a metric
(``.sample``, ``.train``): each reader under ``perfbench/metrics/`` names
its quantity and its split and calls one of these.  Every function
returns None where the traced window holds nothing to read."""

from __future__ import annotations

from typing import Optional

from perfbench.trace import TraceView


def mfu(tv: TraceView, kind: str) -> Optional[float]:
    """The whole step's share of the card's peak, %: the model's bf16
    work at the bf16 peak plus its int8 work at the int8 peak, over the
    traced window's wall time."""
    if tv.kind != kind or tv.window_s <= 0 or tv.work is None:
        return None
    least = tv.work.ops_bf16 / tv.peaks.bf16 + tv.work.ops_int8 / tv.peaks.int8
    return 100.0 * least / tv.window_s


def glue_ms_per_slice(tv: TraceView, kind: str) -> Optional[float]:
    """Device ms a slice of the kernels no family file claims."""
    if tv.kind != kind or not tv.slices or not tv.kernels:
        return None
    return 1e3 * tv.device_s(None) / tv.slices


def conv_roofline(tv: TraceView, kind: str) -> Optional[float]:
    """The least time of the step's convs (each max(ops / peak, bytes /
    bandwidth), int8 convs at the int8 peak) over the device time of the
    kernels the ``conv`` family file matches, %."""
    if tv.kind != kind or tv.work is None:
        return None
    took = tv.device_s("conv")
    if took <= 0:
        return None
    least = sum(max(o / (tv.peaks.int8 if q else tv.peaks.bf16), b / tv.peaks.bandwidth)
                for o, b, q in tv.work.convs)
    return 100.0 * least / took


def idle_share(tv: TraceView, kind: str) -> Optional[float]:
    """1 - (union of kernel intervals) / the traced window's wall time, %."""
    if tv.kind != kind or tv.window_s <= 0 or not tv.kernels:
        return None
    return 100.0 * (1.0 - tv.busy_s / tv.window_s)
