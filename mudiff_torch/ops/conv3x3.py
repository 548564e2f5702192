"""3x3 stride-1 SAME convolution, NHWC x HWIO: kernel K1.

Replaces the Pallas implicit-GEMM conv of the JAX package
(``mudiff_tpu/ops/pallas_conv.py:375`` ``conv3x3_gemm`` ->
``_conv3x3_pallas``, ``pallas_call`` at ``:293``).  Same function:
fp32 accumulation, the fp32 bias added to the accumulator, output in
the input dtype.  The CUDA kernel is ``csrc/conv3x3_kernel.cu``; the
plain version is ``conv3x3_plain`` (``F.conv2d`` on float32 upcasts).

``conv3x3`` dispatches by device (``ops/_dispatch.py``): CPU tensors run
the plain version, CUDA tensors launch the kernel or raise.  Its
backward's input gradient is K1 again; ``conv3x3.launches`` counts
kernel launches, forward and backward, and nothing else, and
``conv3x3.path_launches`` the same launches by the kernel that took
them (``k1_path``): ``"wgmma"`` (bf16 / fp16 on Hopper's wgmma and TMA),
``"general"`` (bf16 / fp16 on ``mma.sync``) or ``"fma"`` (fp32).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from mudiff_torch.ops import _build
from mudiff_torch.ops._dispatch import (
    DTYPE_CODES,
    check_cuda_result,
    current_mode,
    restored,
    use_kernel,
)
from mudiff_torch.utils.profiling import span


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


_FNS = None


def _kernel_fns():
    """{path: entry point}: ``mudiff_conv3x3_wgmma`` for ``"wgmma"``,
    ``mudiff_conv3x3`` (which picks by dtype) for the other two."""
    global _FNS
    if _FNS is None:
        lib = _build.load("conv3x3")
        fns = {}
        for path, name in (("general", "mudiff_conv3x3"), ("wgmma", "mudiff_conv3x3_wgmma")):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[path] = fn
        fns["fma"] = fns["general"]
        _FNS = fns
    return _FNS


# The narrowest channels the wgmma path takes: a chunk of input channels
# is 64 wide, and the stems (Cin 4 / 5), the head (Cout 1) and the
# stem's dx (Cout 5) would leave most of a tile empty.
WGMMA_MIN_CHANNELS = 64


def k1_path_for(cin: int, cout: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """``k1_path`` from the shapes and dtype alone, with ``aligned`` saying
    whether x and w start on 16-byte boundaries."""
    if dtype == torch.float32:
        return "fma"
    if (cin >= WGMMA_MIN_CHANNELS and cout >= WGMMA_MIN_CHANNELS and cin % 8 == 0
            and cout % 8 == 0 and aligned):
        return "wgmma"
    return "general"


def k1_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which of K1's kernels takes a call on the contiguous NHWC ``x`` and
    HWIO ``w``: ``"fma"`` for float32; for bf16 / fp16 ``"wgmma"`` when
    Cin and Cout are at least 64 and multiples of 8 and x and w start on
    16-byte boundaries (the tensor maps' strides and addresses), else
    ``"general"``.  Decided before any launch, from shapes and addresses
    alone, on any device."""
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return k1_path_for(x.shape[-1], w.shape[-1], x.dtype, aligned)


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


def _conv(x: torch.Tensor, w: torch.Tensor,
          bias: Optional[torch.Tensor]) -> torch.Tensor:
    """K1, or its plain version for CPU tensors and under plain_kernels()."""
    key = (tuple(x.shape), w.shape[-1], x.dtype)
    if not use_kernel("conv3x3", key, x, w, bias):
        return conv3x3_plain(x, w, bias)
    _check(x, w, bias)
    path = k1_path(x, w)
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    rc = _kernel_fns()[path](
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        b, h, wd, cin, cout, DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_cuda_result(f"conv3x3 ({path})", rc)
    conv3x3.launches += 1
    conv3x3.path_launches[path] += 1
    return out


def conv3x3_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw (3,3,Cin,Cout) float32 of a SAME 3x3 conv: the batch-contraction
    conv of x with g, products of the inputs summed in float32
    (``pallas_conv.py:357-367``).  Plain PyTorch on every device."""
    dw = torch.nn.grad.conv2d_weight(
        x.to(torch.float32).permute(0, 3, 1, 2),
        (g.shape[-1], x.shape[-1], 3, 3),
        g.to(torch.float32).permute(0, 3, 1, 2),
        padding=1,
    )
    return dw.permute(2, 3, 1, 0)


class _Conv3x3(torch.autograd.Function):
    """K1 with the JAX package's backward (``pallas_conv.py:342-372``):
    dx is K1 on the spatially flipped, io-transposed weight; dw and db
    are plain PyTorch (XLA there), db in float32 for the float32 bias.
    Once differentiable."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.mode = current_mode()
        return _conv(x, w, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        with restored(ctx.mode):
            if ctx.needs_input_grad[0]:
                with span("ops.conv3x3.dx"):
                    w_flip = w.flip(0, 1).transpose(2, 3).contiguous()
                    dx = _conv(g, w_flip, None)
            if ctx.needs_input_grad[1]:
                with span("ops.conv3x3.dw"):
                    dw = conv3x3_weight_grad(x, g).to(w.dtype)
            if ctx.needs_input_grad[2]:
                db = g.to(torch.float32).sum(dim=(0, 1, 2))
        return dx, dw, db


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv.  x (B,H,W,Cin), w (3,3,Cin,Cout), bias
    (Cout,) float32 or None.  Returns (B,H,W,Cout) in x.dtype.
    Differentiable once; its input gradient runs K1 too."""
    return _Conv3x3.apply(x, w, bias)


conv3x3.launches = 0
# the launches of each path (k1_path): the main path's wide shapes take "wgmma"
conv3x3.path_launches = {"wgmma": 0, "general": 0, "fma": 0}
