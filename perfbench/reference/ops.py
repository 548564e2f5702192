"""The reference's primitive ops, in plain PyTorch, and the precisions
they run in.

Every conv, dense layer and attention product of the reference models
goes through a ``Precision`` object passed down explicitly.  ``Exact``
computes in float32 (the caller turns TF32 off); ``Quantized`` runs the
convs that the serving rule routes to int8 as a symmetric integer conv
(static per-input-channel activation scales folded into per-output-
channel weight scales, or dynamic per-example scales while it records a
calibration), at 127 levels (W8A8) or 7 (W4A4, the W8A8 cell's control);
``Fp8`` rounds the inputs of every product to float8 e4m3 with a
per-tensor scale, straight through in the backward (the control of the
bf16 training cell); ``Counting`` records every product's shape, which is
how ``perfbench.arith`` counts operations and bytes on meta tensors.

Tensors are NHWC; 3x3 conv weights HWIO, dense weights (out, in).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d_hwio(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: int = 1) -> torch.Tensor:
    """NHWC x HWIO cross-correlation, no bias."""
    return _nhwc(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), stride=stride, padding=padding))


class Exact:
    """float32 everywhere."""

    def conv(self, x, w, b, site: Optional[str] = None, stride: int = 1,
             padding: int = 1, blocks: int = 1) -> torch.Tensor:
        """``blocks``: the kernel is block-diagonal over that many stems."""
        y = conv2d_hwio(x, w, stride, padding)
        return y if b is None else y + b

    def linear(self, x, w, b=None) -> torch.Tensor:
        return F.linear(x, w, b)

    def matmul(self, a, b) -> torch.Tensor:
        return torch.matmul(a, b)


def _round_codes(v: torch.Tensor, levels: int) -> torch.Tensor:
    return torch.clamp(torch.round(v), -levels, levels)


class Quantized(Exact):
    """Routed convs as symmetric integer convs with ``levels`` codes a
    side (127: W8A8, 7: W4A4).

    ``absmax`` maps a site to its calibrated per-input-channel absmax
    (static scales).  With ``record`` (a dict) every routed site runs
    with dynamic per-example scales and records the per-channel absmax
    of its input, maxed over calls: a calibration."""

    def __init__(self, levels: int = 127, absmax: Optional[Dict[str, torch.Tensor]] = None,
                 record: Optional[Dict[str, torch.Tensor]] = None):
        self.levels = levels
        self.absmax = absmax
        self.record = record

    def conv(self, x, w, b, site=None, stride=1, padding=1, blocks=1):
        if site is None:
            return super().conv(x, w, b, site, stride, padding)
        q = float(self.levels)
        if self.record is not None:
            seen = x.abs().amax(dim=(0, 1, 2))
            prev = self.record.get(site)
            self.record[site] = seen if prev is None else torch.maximum(prev, seen)
            a_scale = x.abs().amax(dim=(1, 2, 3), keepdim=True) / q + 1e-30
            xq = _round_codes(x / a_scale, self.levels)
            w_scale = w.abs().amax(dim=(0, 1, 2), keepdim=True) / q + 1e-30
            wq = torch.round(w / w_scale)
            y = conv2d_hwio(xq, wq) * (a_scale * w_scale.reshape(1, 1, 1, -1))
        else:
            a = self.absmax[site] / q + 1e-30
            w_eff = w * a[None, None, :, None]
            w_scale = w_eff.abs().amax(dim=(0, 1, 2), keepdim=True) / q + 1e-30
            wq = torch.round(w_eff / w_scale)
            xq = _round_codes(x / a, self.levels)
            y = conv2d_hwio(xq, wq) * w_scale.reshape(1, 1, 1, -1)
        return y if b is None else y + b


def fp8_round(v: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to float8 e4m3 under a per-tensor scale that maps its
    absmax to 448, straight through in the backward."""
    with torch.no_grad():
        scale = v.detach().abs().amax().clamp_min(1e-30) / 448.0
        r = (v.detach() / scale).to(torch.float8_e4m3fn).to(v.dtype) * scale
    return v + (r - v).detach()


class Fp8(Exact):
    """Every product's inputs rounded to float8 e4m3 (per-tensor scale)."""

    def conv(self, x, w, b, site=None, stride=1, padding=1, blocks=1):
        return super().conv(fp8_round(x), fp8_round(w), b, site, stride, padding)

    def linear(self, x, w, b=None):
        return F.linear(fp8_round(x), fp8_round(w), b)

    def matmul(self, a, b):
        return torch.matmul(fp8_round(a), fp8_round(b))


class Counting(Exact):
    """Exact, and records ``(kind, shape...)`` of every product:
    ``("conv", B, Hi, Wi, Ho, Wo, Cin, Cout, k, routed)``, ``("linear",
    rows, in, out)``, ``("matmul", batch, m, k, n)``.  A block-diagonal
    conv counts as its blocks, the zeros between them being no work of
    the model.  Run on meta tensors."""

    def __init__(self, routed_sites: bool = False):
        self.ops: List[Tuple] = []
        self.routed_sites = routed_sites

    def conv(self, x, w, b, site=None, stride=1, padding=1, blocks=1):
        y = super().conv(x, w, b, site, stride, padding)
        self.ops += [("conv", y.shape[0], x.shape[1], x.shape[2], y.shape[1], y.shape[2],
                      w.shape[2] // blocks, w.shape[3] // blocks, w.shape[0],
                      bool(site is not None and self.routed_sites))] * blocks
        return y

    def linear(self, x, w, b=None):
        rows = math.prod(x.shape[:-1])
        self.ops.append(("linear", rows, w.shape[1], w.shape[0]))
        return super().linear(x, w, b)

    def matmul(self, a, b):
        y = super().matmul(a, b)
        batch = math.prod(y.shape[:-2])
        self.ops.append(("matmul", batch, a.shape[-2], a.shape[-1], b.shape[-1]))
        return y


# ------------------------------------------------------------ plain layers

def group_norm(x: torch.Tensor, groups: int, weight=None, bias=None,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NHWC, biased variance, eps 1e-6."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h * w, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(b, h, w, c)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def num_groups(channels: int) -> int:
    return min(channels // 4, 32)


def fir_taps(k=(1, 3, 3, 1)) -> torch.Tensor:
    k = torch.tensor(k, dtype=torch.float64)
    k2 = torch.outer(k, k)
    return (k2 / k2.sum()).to(torch.float32)


def upfirdn(x: torch.Tensor, k2: torch.Tensor, up: int, down: int,
            pad: Tuple[int, int]) -> torch.Tensor:
    """Zero-insert by ``up``, pad both spatial dims by ``pad``, convolve
    with ``k2``, keep every ``down``-th sample; NHWC."""
    n, h, w, c = x.shape
    xc = _nchw(x)
    if up > 1:
        z = xc.new_zeros((n, c, h * up, w * up))
        z[:, :, ::up, ::up] = xc
        xc = z
    xc = F.pad(xc, (pad[0], pad[1], pad[0], pad[1]))
    kk = torch.flip(k2, (0, 1)).to(device=x.device, dtype=x.dtype)
    y = F.conv2d(xc, kk.expand(c, 1, *kk.shape).contiguous(), stride=down, groups=c)
    return _nhwc(y)


def fir_down2(x: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """StyleGAN2 FIR downsample by 2 with a 4-tap kernel."""
    return upfirdn(x, k2, 1, 2, (1, 1))


def fir_up2(x: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """StyleGAN2 FIR upsample by 2 with a 4-tap kernel, gain 4."""
    return upfirdn(x, k2 * 4.0, 2, 1, (2, 1))


def conv_down2(prec, x: torch.Tensor, w: torch.Tensor, b, k2: torch.Tensor) -> torch.Tensor:
    """FIR filter (pad 2 a side), then a stride-2 VALID 3x3 conv."""
    return prec.conv(upfirdn(x, k2, 1, 1, (2, 2)), w, b, None, stride=2, padding=0)


def timestep_embedding(t: torch.Tensor, dim: int, max_positions: int = 10000) -> torch.Tensor:
    half = dim // 2
    scale = math.log(max_positions) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -scale)
    e = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(e), torch.cos(e)], dim=1)
