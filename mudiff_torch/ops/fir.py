"""Factor-2 FIR resampling with a separable 4-tap kernel: kernels K2a/K2b.

Replace the Pallas FIR kernels of the JAX package:
* ``fir_down2`` <- ``mudiff_tpu/ops/pallas_fir.py:271``
  ``downsample_2d_pallas`` -> ``_down2_pallas`` (``pallas_call`` at
  ``:182``); same function as ``downsample_2d(x, k, 2)``;
* ``fir_up2`` <- ``pallas_fir.py:292`` ``upsample_2d_pallas`` ->
  ``_up2_pallas`` (``pallas_call`` at ``:248``); same function as
  ``upsample_2d(x, k, 2)`` (gain 4).

The CUDA kernels are ``csrc/fir_kernels.cu``.  The 4x4 correlation taps
(flipped normalized outer product, x4 for up) are computed here and
passed to the kernel as arguments.  Plain versions:
``ops/upfirdn2d.py``'s ``downsample_2d`` / ``upsample_2d``.  Dispatch by
device as in ``ops/_dispatch.py``; ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from mudiff_torch.ops import _build
from mudiff_torch.ops._dispatch import DTYPE_CODES, check_cuda_result, use_kernel
from mudiff_torch.ops.upfirdn2d import downsample_2d, setup_fir_kernel, upsample_2d

_FNS = {}


def _kernel_fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("fir"), name)
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def correlation_taps(k: Sequence[float], gain: float) -> np.ndarray:
    """The 4x4 weights the kernels correlate with: flip(normalized) * gain."""
    k2 = setup_fir_kernel(k)
    if k2.shape != (4, 4):
        raise ValueError(f"fir kernels take a 4-tap kernel, got {k!r}")
    return np.ascontiguousarray(np.flip(k2, (0, 1)) * gain, dtype=np.float32)


def _launch(name: str, x: torch.Tensor, out: torch.Tensor, taps: np.ndarray) -> None:
    if x.dim() != 4 or x.dtype not in DTYPE_CODES or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous (B,H,W,C) float32/bf16/fp16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    b, h, w, c = x.shape
    rc = _kernel_fn(name)(
        x.data_ptr(), out.data_ptr(), b, h, w, c,
        taps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_cuda_result(name, rc)


def fir_down2(x: torch.Tensor, k: Sequence[float] = (1, 3, 3, 1)) -> torch.Tensor:
    """FIR downsample by 2, pad (1,1): (B,H,W,C) -> (B,(H-2)//2+1,(W-2)//2+1,C)."""
    if not use_kernel("fir_down2", (tuple(x.shape), x.dtype), x):
        return downsample_2d(x, k, factor=2)
    b, h, w, c = x.shape
    out = torch.empty((b, (h - 2) // 2 + 1, (w - 2) // 2 + 1, c),
                      dtype=x.dtype, device=x.device)
    _launch("mudiff_fir_down2", x, out, correlation_taps(k, 1.0))
    fir_down2.launches += 1
    return out


def fir_up2(x: torch.Tensor, k: Sequence[float] = (1, 3, 3, 1)) -> torch.Tensor:
    """FIR upsample by 2, gain 4: (B,H,W,C) -> (B,2H,2W,C)."""
    if not use_kernel("fir_up2", (tuple(x.shape), x.dtype), x):
        return upsample_2d(x, k, factor=2)
    b, h, w, c = x.shape
    out = torch.empty((b, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    _launch("mudiff_fir_up2", x, out, correlation_taps(k, 4.0))
    fir_up2.launches += 1
    return out


fir_down2.launches = 0
fir_up2.launches = 0
