"""upfirdn2d and the StyleGAN2 FIR resampling family, plain PyTorch, NHWC.

The port of ``mudiff_tpu/ops/upfirdn2d.py:35-215``.  Numerical
spec (reference utils/op/upfirdn2d.py:201-242):
  1. zero-insert upsample by ``up`` (each pixel followed by up-1 zeros),
  2. pad each spatial dim by (pad0, pad1); negative pads crop,
  3. 2-D *convolution* with ``kernel`` (correlation with the flipped
     kernel),
  4. subsample by ``down`` starting at index 0.

The JAX package lowers this to one dilated depthwise XLA conv, whose
lhs dilation yields (H-1)*up+1 samples and folds the trailing up-1
zeros into the high pad (``upfirdn2d.py:59-64``); here the zero-insert
writes all H*up samples, so the pads are the reference's as given.
Arithmetic is float32 whatever the input dtype; the result is cast back.

``downsample_2d`` and ``upsample_2d`` are the plain versions of the
``fir_down2`` / ``fir_up2`` CUDA kernels (``ops/fir.py``).
``conv_downsample_2d`` and ``upsample_conv_2d`` are ``FIRConv2d``'s down
and up variants and run as written here on every device, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

KernelLike = Union[Sequence[float], np.ndarray]


def setup_fir_kernel(k: KernelLike) -> np.ndarray:
    """Normalize a 1-D (separable) or 2-D FIR kernel to sum 1."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / np.sum(k)
    assert k.ndim == 2 and k.shape[0] == k.shape[1]
    return k


def _pad_or_crop(x: torch.Tensor, p0: int, p1: int, dim: int) -> torch.Tensor:
    if p0 < 0:
        x = x.narrow(dim, -p0, x.shape[dim] + p0)
        p0 = 0
    if p1 < 0:
        x = x.narrow(dim, 0, x.shape[dim] + p1)
        p1 = 0
    if p0 or p1:
        shape = list(x.shape)
        parts = []
        if p0:
            shape[dim] = p0
            parts.append(x.new_zeros(shape))
        parts.append(x)
        if p1:
            shape[dim] = p1
            parts.append(x.new_zeros(shape))
        x = torch.cat(parts, dim=dim)
    return x


def upfirdn2d(
    x: torch.Tensor,
    kernel: KernelLike,
    up: int = 1,
    down: int = 1,
    pad: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Upsample-FIR-downsample on NHWC images (reference
    utils/op/upfirdn2d.py:170-181, NCHW -> NHWC)."""
    n, h, w, c = x.shape
    k = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device)
    kh, kw = k.shape
    xf = x.to(torch.float32).permute(0, 3, 1, 2)  # NCHW
    if up > 1:
        xu = xf.new_zeros((n, c, h * up, w * up))
        xu[:, :, ::up, ::up] = xf
        xf = xu
    p0, p1 = int(pad[0]), int(pad[1])
    xf = _pad_or_crop(_pad_or_crop(xf, p0, p1, 2), p0, p1, 3)
    weight = torch.flip(k, (0, 1)).expand(c, 1, kh, kw)
    out = F.conv2d(xf, weight, stride=down, groups=c)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def upsample_2d(
    x: torch.Tensor,
    k: Optional[KernelLike] = None,
    factor: int = 2,
    gain: float = 1.0,
) -> torch.Tensor:
    """FIR upsample by ``factor`` (reference up_or_down_sampling.py:200-229)."""
    assert isinstance(factor, int) and factor >= 1
    if k is None:
        k = [1.0] * factor
    k = setup_fir_kernel(k) * (gain * (factor ** 2))
    p = k.shape[0] - factor
    return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(
    x: torch.Tensor,
    k: Optional[KernelLike] = None,
    factor: int = 2,
    gain: float = 1.0,
) -> torch.Tensor:
    """FIR downsample by ``factor`` (reference up_or_down_sampling.py:232-262)."""
    assert isinstance(factor, int) and factor >= 1
    if k is None:
        k = [1.0] * factor
    k = setup_fir_kernel(k) * gain
    p = k.shape[0] - factor
    return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def conv_downsample_2d(
    x: torch.Tensor,
    w: torch.Tensor,
    k: Optional[KernelLike] = None,
    factor: int = 2,
    gain: float = 1.0,
) -> torch.Tensor:
    """FIR filter, then a stride-``factor`` VALID conv with ``w``.

    ``x`` is NHWC, ``w`` HWIO (reference up_or_down_sampling.py:149-183).
    The conv runs in the input dtype, as the JAX package's does.
    """
    assert isinstance(factor, int) and factor >= 1
    kh, kw_, _, _ = w.shape
    assert kh == kw_
    if k is None:
        k = [1.0] * factor
    k = setup_fir_kernel(k) * gain
    p = (k.shape[0] - factor) + (kh - 1)
    x = upfirdn2d(x, k, pad=((p + 1) // 2, p // 2))
    out = F.conv2d(
        x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
        stride=factor,
    )
    return out.permute(0, 2, 3, 1).contiguous()


def upsample_conv_2d(
    x: torch.Tensor,
    w: torch.Tensor,
    k: Optional[KernelLike] = None,
    factor: int = 2,
    gain: float = 1.0,
) -> torch.Tensor:
    """A factor-``factor`` transposed conv with ``w``, then the FIR filter
    (gain x factor^2): (B,H,W,I) -> (B,2H,2W,O) for a 3x3 ``w`` at factor 2.

    ``x`` is NHWC, ``w`` HWIO (reference up_or_down_sampling.py:77-146).
    The reference feeds ``conv_transpose2d`` spatially pre-flipped weights
    and the transposed conv flips them again, so the net op is a
    correlation with the unflipped ``w`` over the zero-dilated input with
    full ``kh - 1`` padding (``mudiff_tpu/ops/upfirdn2d.py:161-166``):
    ``conv_transpose2d`` with the flipped ``w``.  Its output is
    ``factor * (H - 1) + kh`` wide (2H+1 for 3x3 at factor 2); the FIR
    pads it by ``((p+1)//2 + factor - 1, p//2 + 1)``.  The conv runs in the
    input dtype, as the JAX package's does.
    """
    assert isinstance(factor, int) and factor >= 1
    kh, kw_, _, _ = w.shape
    assert kh == kw_
    if k is None:
        k = [1.0] * factor
    k = setup_fir_kernel(k) * (gain * (factor ** 2))
    p = (k.shape[0] - factor) - (kh - 1)
    wt = torch.flip(w.to(x.dtype), (0, 1)).permute(2, 3, 0, 1)  # (I, O, kh, kw)
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=factor)
    out = out.permute(0, 2, 3, 1)
    return upfirdn2d(out, k, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))
