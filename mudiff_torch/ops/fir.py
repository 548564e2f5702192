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
passed to the kernel as arguments, and so is the choice between its
16-byte-vector and its one-channel path (``vector_path``).  Plain versions:
``ops/upfirdn2d.py``'s ``downsample_2d`` / ``upsample_2d``.  Dispatch by
device as in ``ops/_dispatch.py``; ``<wrapper>.launches`` counts kernel
launches, those of backward passes included (a backward of ``fir_down2``
launches ``fir_up2`` and is counted there).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from mudiff_torch.ops import _build
from mudiff_torch.ops._dispatch import (
    DTYPE_CODES,
    check_cuda_result,
    current_mode,
    restored,
    use_kernel,
)
from mudiff_torch.ops.upfirdn2d import downsample_2d, setup_fir_kernel, upsample_2d

_FNS = {}


def _kernel_fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("fir"), name)
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
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


VECTOR_BYTES = 16  # as csrc/fir_kernels.cu VECTOR_BYTES


def vector_path(x: torch.Tensor) -> bool:
    """Whether the kernels take 16-byte vectors along C for ``x``: C *
    itemsize a multiple of 16 and ``x`` 16-byte aligned (the output, from
    ``torch.empty``, always is; the kernels' entry points check both).
    Else they run one channel a thread (C = 1 or 3, a view at an odd
    offset)."""
    return (x.shape[-1] * x.element_size() % VECTOR_BYTES == 0
            and x.data_ptr() % VECTOR_BYTES == 0)


def _launch(name: str, x: torch.Tensor, out: torch.Tensor, taps: np.ndarray) -> None:
    if x.dim() != 4 or x.dtype not in DTYPE_CODES or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous (B,H,W,C) float32/bf16/fp16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    b, h, w, c = x.shape
    rc = _kernel_fn(name)(
        x.data_ptr(), out.data_ptr(), b, h, w, c,
        taps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        DTYPE_CODES[x.dtype], int(vector_path(x)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_cuda_result(name, rc)


def _down(x: torch.Tensor, k: Sequence[float], gain: float) -> torch.Tensor:
    """K2a or its plain version: FIR down with taps ``k`` x ``gain``."""
    if not use_kernel("fir_down2", (tuple(x.shape), x.dtype), x):
        return downsample_2d(x, k, factor=2, gain=gain)
    b, h, w, c = x.shape
    out = torch.empty((b, (h - 2) // 2 + 1, (w - 2) // 2 + 1, c),
                      dtype=x.dtype, device=x.device)
    _launch("mudiff_fir_down2", x, out, correlation_taps(k, gain))
    fir_down2.launches += 1
    return out


def _up(x: torch.Tensor, k: Sequence[float], gain: float) -> torch.Tensor:
    """K2b or its plain version: FIR up, taps ``k`` x 4 x ``gain``."""
    if not use_kernel("fir_up2", (tuple(x.shape), x.dtype), x):
        return upsample_2d(x, k, factor=2, gain=gain)
    b, h, w, c = x.shape
    out = torch.empty((b, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    _launch("mudiff_fir_up2", x, out, correlation_taps(k, 4.0 * gain))
    fir_up2.launches += 1
    return out


# The adjoints (pallas_fir.py:279-305), exact for a symmetric kernel:
# down at gain g is transposed by up at gain g/4 (up's taps carry the
# factor 4 of its zero-insert), up at gain g by down at gain 4g.  Each
# backward applies the other Function, so grad-of-grad runs the kernels
# too (R1's double backward through the critic's downsamples).
class _FirDown2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, gain):
        ctx.k, ctx.gain, ctx.mode = k, gain, current_mode()
        return _down(x, k, gain)

    @staticmethod
    def backward(ctx, g):
        with restored(ctx.mode):
            return _FirUp2.apply(g.contiguous(), ctx.k, ctx.gain / 4.0), None, None


class _FirUp2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, gain):
        ctx.k, ctx.gain, ctx.mode = k, gain, current_mode()
        return _up(x, k, gain)

    @staticmethod
    def backward(ctx, g):
        with restored(ctx.mode):
            return _FirDown2.apply(g.contiguous(), ctx.k, 4.0 * ctx.gain), None, None


def _symmetric(k: Sequence[float]) -> tuple:
    """``k`` as a tuple; raises unless it reads the same reversed: the
    adjoints above are exact only then, and the Pallas kernels correlate
    where ``upfirdn2d`` convolves (the two agree only then)."""
    k = tuple(float(v) for v in k)
    if k != k[::-1]:
        raise ValueError(f"fir_down2 / fir_up2 take a symmetric kernel, got {k!r}")
    return k


def fir_down2(x: torch.Tensor, k: Sequence[float] = (1, 3, 3, 1),
              gain: float = 1.0) -> torch.Tensor:
    """FIR downsample by 2, pad (1,1): (B,H,W,C) -> (B,(H-2)//2+1,(W-2)//2+1,C).
    Twice differentiable; ``k`` must be symmetric (else ValueError)."""
    return _FirDown2.apply(x, _symmetric(k), float(gain))


def fir_up2(x: torch.Tensor, k: Sequence[float] = (1, 3, 3, 1),
            gain: float = 1.0) -> torch.Tensor:
    """FIR upsample by 2, gain 4 x ``gain``: (B,H,W,C) -> (B,2H,2W,C).
    Twice differentiable; ``k`` must be symmetric (else ValueError)."""
    return _FirUp2.apply(x, _symmetric(k), float(gain))


fir_down2.launches = 0
fir_up2.launches = 0
