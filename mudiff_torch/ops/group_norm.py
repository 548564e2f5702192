"""GroupNorm over an NHWC tensor with its affine or AdaGN modulation and an
optional SiLU: kernel K5 (``csrc/group_norm_kernel.cu``).

K5 replaces no Pallas kernel: the JAX package leaves GroupNorm to XLA.  It
does a whole norm and its activation in two passes over the input (the
statistics, then normalise, modulate, SiLU and store), where the plain
chain below makes an fp32 copy and a pass for each operation.

``group_norm_act(x, groups, out_dtype, weight, bias, style, silu)`` covers
every norm of the port:

* plain (``PlainGroupNorm``, the stems' norms): neither ``weight`` nor
  ``style``; groups may be ``n_stems * groups_per_stem`` (groups never
  cross a stem);
* affine (``AffineGroupNorm``): fp32 ``weight`` / ``bias`` of C;
* AdaGN (``AdaptiveGroupNorm``): ``style`` (B, 2C), the style dense's
  output, gamma then beta, in ``out_dtype``.

The plain version is ``group_norm_act_plain``: ``group_norm_plain`` (flax
semantics: statistics in float32, eps 1e-6, the fast variance
E[x^2] - E[x]^2), then the modulation and ``F.silu``.  The kernel rounds
each element as that chain does on the card; only the order of the
statistics' sums differs.  ``x`` may be a channel slice of a wider NHWC
tensor (pixel stride above C), which the kernel reads in place; the
output is contiguous.  Dispatch by device as in ``ops/_dispatch.py``;
``group_norm_act.launches`` counts kernel calls (two launches each) and
``path_launches`` splits them by the kernel's path (16-byte vectors or
one channel a thread).

The backward is plain PyTorch on every device: it recomputes the
normalised input from the saved ``x``, mean and rstd, and takes the
standard GroupNorm backward in float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from mudiff_torch.ops import _build
from mudiff_torch.ops._dispatch import (
    DTYPE_CODES,
    check_cuda_result,
    use_kernel,
)

VECTOR_BYTES = 16  # as csrc/group_norm_kernel.cu VECTOR_BYTES
MAX_CHUNKS = 128   # as MAX_CHUNKS there: the partials' scratch per example
EPS = 1e-6

_FN = []


def _kernel_fn():
    if not _FN:
        fn = _build.load("group_norm").mudiff_group_norm
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def _stats_plain(xf: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and rstd of ``xf`` (B, HW, G, C/G) over dims 1 and 3, kept."""
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def _grouped(x: torch.Tensor, groups: int) -> torch.Tensor:
    """``x`` in its accumulation dtype (float32, or float64 for float64) as
    (B, HW, G, C/G)."""
    b, h, w, c = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.to(acc).reshape(b, h * w, groups, c // groups)


def group_norm_plain(x: torch.Tensor, num_groups: int, out_dtype: torch.dtype,
                     weight: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     eps: float = EPS, stats: Optional[Tuple[torch.Tensor, ...]] = None
                     ) -> torch.Tensor:
    """GroupNorm over an NHWC tensor with float32 statistics and affine,
    output in ``out_dtype`` (flax ``nn.GroupNorm`` semantics).  ``stats``,
    (mean, rstd) each (B, G), replace the statistics: the card's check of
    K5's elementwise chain."""
    xf = _grouped(x, num_groups)
    if stats is None:
        mean, rstd = _stats_plain(xf, eps)
    else:
        mean, rstd = (t.to(xf.dtype)[:, None, :, None] for t in stats)
    y = ((xf - mean) * rstd).reshape(x.shape)
    if weight is not None:
        y = y * weight.to(xf.dtype)
    if bias is not None:
        y = y + bias.to(xf.dtype)
    return y.to(out_dtype)


def group_norm_act_plain(x: torch.Tensor, groups: int, out_dtype: torch.dtype,
                         weight: Optional[torch.Tensor] = None,
                         bias: Optional[torch.Tensor] = None,
                         style: Optional[torch.Tensor] = None, silu: bool = False,
                         eps: float = EPS, stats: Optional[Tuple[torch.Tensor, ...]] = None
                         ) -> torch.Tensor:
    """K5's plain version: ``group_norm_plain`` (``stats`` as there), then
    ``gamma * h + beta`` with ``style`` (B, 2C), then ``F.silu``.  The SiLU
    of an unmodulated channel slice of a wider tensor (the G2 stems') runs
    on a view of that layout, as the chain did when it normalised the
    whole tensor and activated each stem's slice: PyTorch's CPU SiLU
    rounds a strided view otherwise than a dense tensor."""
    y = group_norm_plain(x, groups, out_dtype, weight, bias, eps, stats)
    stride = pixel_stride(x)
    if silu and style is None and stride is not None and stride > x.shape[-1]:
        y = y.new_empty((*x.shape[:3], stride))[..., :x.shape[-1]].copy_(y)
    if style is not None:
        gamma, beta = style.chunk(2, dim=-1)
        y = gamma[:, None, None, :] * y + beta[:, None, None, :]
    return F.silu(y) if silu else y


def group_stats_plain(x: torch.Tensor, groups: int,
                      eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd), each (B, G), as ``group_norm_plain`` computes them."""
    mean, rstd = _stats_plain(_grouped(x, groups), eps)
    return mean[:, 0, :, 0], rstd[:, 0, :, 0]


def pixel_stride(x: torch.Tensor) -> Optional[int]:
    """S when ``x`` (B, H, W, C) has strides (H W S, W S, S, 1), S >= C:
    contiguous (S = C) or a channel slice of a wider NHWC tensor; else None."""
    b, h, w, c = x.shape
    s = x.stride(2)
    if x.stride(3) == 1 and s >= c and x.stride(1) == w * s and x.stride(0) == h * w * s:
        return s
    return None


def vector_path(x: torch.Tensor, stride: int) -> bool:
    """Whether K5 reads ``x`` in 16-byte vectors along C: C and the pixel
    stride whole vectors and ``x`` 16-byte aligned.  Else one channel a
    thread."""
    size = x.element_size()
    return (x.shape[-1] * size % VECTOR_BYTES == 0 and stride * size % VECTOR_BYTES == 0
            and x.data_ptr() % VECTOR_BYTES == 0)


def _kind(weight, bias, style) -> str:
    if style is not None:
        return "style"
    return "affine" if weight is not None or bias is not None else "plain"


def _launch(x: torch.Tensor, groups: int, out_dtype: torch.dtype,
            weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
            style: Optional[torch.Tensor], silu: bool, eps: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: (output, mean, rstd), mean and rstd (B, G) in float32."""
    if x.dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES:
        raise ValueError(f"group_norm_act: no kernel for {x.dtype} -> {out_dtype}")
    b, h, w, c = x.shape
    if style is not None:
        if style.shape != (b, 2 * c) or style.dtype != out_dtype:
            raise ValueError(f"group_norm_act: style must be ({b}, {2 * c}) {out_dtype}, "
                             f"got {tuple(style.shape)} {style.dtype}")
        style = style.contiguous()
    stride = pixel_stride(x)
    if stride is None:
        x = x.contiguous()
        stride = c
    weight = None if weight is None else weight.to(torch.float32).contiguous()
    bias = None if bias is None else bias.to(torch.float32).contiguous()
    out = torch.empty((b, h, w, c), dtype=out_dtype, device=x.device)
    partials = torch.empty((b * MAX_CHUNKS * groups * 2,), dtype=torch.float32, device=x.device)
    stats = torch.empty((b, groups, 2), dtype=torch.float32, device=x.device)
    vector = vector_path(x, stride)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _kernel_fn()(
        x.data_ptr(), out.data_ptr(), partials.data_ptr(), stats.data_ptr(),
        ptr(weight), ptr(bias), ptr(style), b, h * w, c, stride, groups,
        DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype], int(vector), int(silu), eps,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_cuda_result("group_norm_act", rc)
    group_norm_act.launches += 1
    group_norm_act.path_launches["vector" if vector else "scalar"] += 1
    return out, stats[..., 0], stats[..., 1]


def group_norm_backward(x, weight, bias, style, mean, rstd, groups: int, silu: bool, g,
                        needs: Tuple[bool, bool, bool, bool]):
    """Gradients of ``group_norm_act`` for (x, weight, bias, style), each
    None where ``needs`` is False, in float32 (float64 for float64): the
    pre-activation y = n * scale + shift recomputed from x, mean and rstd
    (n the normalised input), SiLU's derivative s (1 + y (1 - s)), then
    dn = dy * scale, dx = rstd (dn - mean_g(dn) - n mean_g(dn n)), the
    affine's dw = sum dy n, db = sum dy over pixels and the batch, AdaGN's
    dgamma, dbeta over pixels."""
    xf = _grouped(x, groups)
    acc = xf.dtype
    b, h, w, c = x.shape
    rs = rstd.to(acc)[:, None, :, None]
    n = ((xf - mean.to(acc)[:, None, :, None]) * rs).reshape(b, h * w, c)
    scale = shift = None
    if style is not None:
        gamma, beta = style.to(acc).chunk(2, dim=-1)
        scale, shift = gamma[:, None, :], beta[:, None, :]
    else:
        scale = None if weight is None else weight.to(acc)
        shift = None if bias is None else bias.to(acc)
    dy = g.to(acc).reshape(b, h * w, c)
    if silu:
        y = n if scale is None else n * scale
        if shift is not None:
            y = y + shift
        s = torch.sigmoid(y)
        dy = dy * (s * (1 + y * (1 - s)))
    dx = dw = db = dstyle = None
    if needs[1]:
        dw = (dy * n).sum(dim=(0, 1)).to(weight.dtype)
    if needs[2]:
        db = dy.sum(dim=(0, 1)).to(bias.dtype)
    if needs[3]:
        dstyle = torch.cat([(dy * n).sum(dim=1), dy.sum(dim=1)], dim=-1).to(style.dtype)
    if needs[0]:
        dn = (dy if scale is None else dy * scale).reshape(b, h * w, groups, c // groups)
        n = n.reshape(dn.shape)
        dx = (dn - dn.mean(dim=(1, 3), keepdim=True)
              - n * (dn * n).mean(dim=(1, 3), keepdim=True)) * rs
        dx = dx.reshape(b, h, w, c).to(x.dtype)
    return dx, dw, db, dstyle


class _GroupNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, style, groups, out_dtype, silu, eps):
        key = (tuple(x.shape), pixel_stride(x), groups, x.dtype, out_dtype,
               _kind(weight, bias, style), silu)
        needs = any(ctx.needs_input_grad[:4])
        if use_kernel("group_norm_act", key, x, weight, bias, style):
            out, mean, rstd = _launch(x, groups, out_dtype, weight, bias, style, silu, eps)
        else:
            out = group_norm_act_plain(x, groups, out_dtype, weight, bias, style, silu, eps)
            mean = rstd = None
            if needs:
                mean, rstd = group_stats_plain(x, groups, eps)
        if needs:
            ctx.save_for_backward(x, weight, bias, style, mean, rstd)
            ctx.groups, ctx.silu = groups, silu
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight, bias, style, mean, rstd = ctx.saved_tensors
        grads = group_norm_backward(x, weight, bias, style, mean, rstd, ctx.groups, ctx.silu,
                                    g, ctx.needs_input_grad[:4])
        return (*grads, None, None, None, None)


def group_norm_act(x: torch.Tensor, groups: int, out_dtype: torch.dtype,
                   weight: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   style: Optional[torch.Tensor] = None, silu: bool = False,
                   eps: float = EPS) -> torch.Tensor:
    """GroupNorm of ``x`` (B, H, W, C) over ``groups`` groups of C / groups
    contiguous channels, the affine (``weight``, ``bias``) or the AdaGN
    modulation (``style`` (B, 2C): gamma, beta), optionally SiLU; (B, H, W,
    C) in ``out_dtype``.  K5 on CUDA tensors, ``group_norm_act_plain`` on
    CPU ones; differentiable once."""
    if x.dim() != 4 or x.shape[-1] % groups:
        raise ValueError(f"group_norm_act: need (B,H,W,C) with C divisible by {groups}, "
                         f"got {tuple(x.shape)}")
    if style is not None and (weight is not None or bias is not None):
        raise ValueError("group_norm_act: style modulates a norm without an affine")
    return _GroupNormAct.apply(x, weight, bias, style, groups, out_dtype, silu, eps)


group_norm_act.launches = 0
group_norm_act.path_launches = {"vector": 0, "scalar": 0}
