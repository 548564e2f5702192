"""3x3 stride-1 SAME convolution, NHWC x HWIO: kernel K1.

Replaces the Pallas implicit-GEMM conv of the JAX package
(``mudiff_tpu/ops/pallas_conv.py:375`` ``conv3x3_gemm`` ->
``_conv3x3_pallas``, ``pallas_call`` at ``:293``).  Same function:
fp32 accumulation, the fp32 bias added to the accumulator, output in
the input dtype.  The CUDA kernel is ``csrc/conv3x3_kernel.cu``; the
plain version is ``conv3x3_plain`` (``F.conv2d`` on float32 upcasts).

``conv3x3`` dispatches by device (``ops/_dispatch.py``): CPU tensors run
the plain version, CUDA tensors launch the kernel or raise.
``conv3x3.launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from mudiff_torch.ops import _build
from mudiff_torch.ops._dispatch import DTYPE_CODES, check_cuda_result, use_kernel


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: float32 ``F.conv2d`` plus bias, cast to x.dtype.

    On a GPU the caller decides TF32 (``torch.backends.cudnn.allow_tf32``).
    """
    y = F.conv2d(
        x.to(torch.float32).permute(0, 3, 1, 2),
        w.to(torch.float32).permute(3, 2, 0, 1),
        padding=1,
    ).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype).contiguous()


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("conv3x3").mudiff_conv3x3
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(
            f"conv3x3: need x (B,H,W,Cin) and w (3,3,Cin,Cout), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"conv3x3: x {x.dtype} and w {w.dtype} must be one "
                        "of float32, bfloat16, float16 and agree")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3: x and w must be contiguous")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (w.shape[-1],)
                             or not bias.is_contiguous()):
        raise ValueError("conv3x3: bias must be a contiguous float32 (Cout,)")


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv.  x (B,H,W,Cin), w (3,3,Cin,Cout), bias
    (Cout,) float32 or None.  Returns (B,H,W,Cout) in x.dtype."""
    key = (tuple(x.shape), w.shape[-1], x.dtype)
    if not use_kernel("conv3x3", key, x, w, bias):
        return conv3x3_plain(x, w, bias)
    _check(x, w, bias)
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    rc = _kernel_fn()(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        b, h, wd, cin, cout, DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_cuda_result("conv3x3", rc)
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
