"""NCSN++ building blocks of the main path: GroupNorms, attention, the
pyramid's FIR downsample conv and the BigGAN AdaGN resblock.

The port of ``mudiff_tpu/nn/blocks.py:48-120,178-238,241-354,376-435``.
NHWC; ``dtype`` is the compute dtype, parameters stay float32, GroupNorm
statistics are always float32 (eps 1e-6, flax's fast variance
E[x^2] - E[x]^2).  The resblock's factor-2 FIR resampling runs kernels
K2a/K2b and its 3x3 convs K1 on CUDA tensors.  Its dropout
(``dropout > 0``, training only) is flax's ``nn.Dropout`` at the same
point: after the second activation, before ``Conv_1``, as ``where(keep,
h / (1 - p), 0)``; the keep mask is given, or drawn from a seed
(``dropout_keep``), so a recomputed forward draws the same one.  On a
mesh the seed comes with the global batch and this rank's first row: the
mask is drawn for the global batch and the rank's rows are kept.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from mudiff_torch.nn.initializers import default_init, stylegan_dense_init
from mudiff_torch.nn.layers import NIN, Conv1x1, Conv3x3, Dense
from mudiff_torch.ops import conv_downsample_2d, fir_down2, fir_up2, flash_attn

_SQRT2 = math.sqrt(2.0)
ATTN_MODES = ("einsum", "bf16", "flash")


def dropout_keep(shape, p: float, seed: int, device,
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The keep mask of a dropout at rate ``p``: ``uniform < 1 - p`` (the
    form of flax's ``bernoulli(rng, 1 - p)``), drawn from a generator on
    ``device`` seeded with ``seed``.  With ``rows`` = (global batch, first
    row) it is drawn for the global batch and ``shape[0]`` rows from the
    first are kept."""
    g = torch.Generator(device).manual_seed(int(seed))
    if rows is None:
        return torch.rand(tuple(shape), generator=g, device=device) < 1.0 - p
    n, start = rows
    whole = torch.rand((n, *shape[1:]), generator=g, device=device) < 1.0 - p
    return whole[start:start + shape[0]]


def _num_groups(channels: int) -> int:
    return min(channels // 4, 32)


def group_norm(x: torch.Tensor, num_groups: int, out_dtype: torch.dtype,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over an NHWC tensor with float32 statistics and affine,
    output in ``out_dtype`` (flax ``nn.GroupNorm`` semantics)."""
    b, h, w, c = x.shape
    xf = x.to(torch.float32).reshape(b, h * w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    if weight is not None:
        y = y * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(out_dtype)


class AffineGroupNorm(nn.Module):
    """Affine GroupNorm (torch nn.GroupNorm default affine=True)."""

    def __init__(self, num_groups: int, channels: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.num_groups, self.dtype, self.weight, self.bias)


class AdaptiveGroupNorm(nn.Module):
    """GroupNorm modulated by a style vector: style -> (gamma, beta), the
    style bias initialized to gamma=1, beta=0 (reference layerspp.py:37-54)."""

    def __init__(self, channels: int, style_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.channels = channels
        self.dtype = dtype
        self.style = Dense(
            style_dim, 2 * channels, kernel_init=stylegan_dense_init(1.0),
            bias_init=torch.cat([torch.ones(channels), torch.zeros(channels)]),
            dtype=dtype, device=device,
        )

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.style(style).chunk(2, dim=-1)
        h = group_norm(x, _num_groups(self.channels), self.dtype)
        return gamma[:, None, None, :] * h + beta[:, None, None, :]


class AttnBlockpp(nn.Module):
    """Single-head spatial self-attention with NIN q/k/v and skip rescale
    (reference layerspp.py:98-137).

    ``attn`` is the score lowering (``mudiff_tpu/nn/blocks.py:215-233``):
    * ``"einsum"``: float32 scores and softmax (the exact path);
    * ``"bf16"``: scores rounded to bf16, scaled by bf16(C^-1/2), the
      softmax in float32 and its weights cast to the compute dtype;
    * ``"flash"``: q, k, v in the compute dtype through kernel K3
      (``ops.flash_attn``, scale C^-1/2 as a Python float), the output
      cast to the compute dtype (``blocks.py:206-214``).
    For ``einsum`` and ``bf16`` both products are ``torch.matmul`` (the
    JAX package leaves them to XLA).
    """

    def __init__(self, channels: int, skip_rescale: bool = False,
                 init_scale: float = 0.0, attn: str = "einsum",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if attn not in ATTN_MODES:
            raise ValueError(f"attn must be one of {ATTN_MODES}, got {attn!r}")
        self.skip_rescale = skip_rescale
        self.attn = attn
        self.dtype = dtype
        c = channels
        self.GroupNorm_0 = AffineGroupNorm(_num_groups(c), c, dtype=dtype, device=device)
        self.NIN_0 = NIN(c, c, dtype=dtype, device=device)
        self.NIN_1 = NIN(c, c, dtype=dtype, device=device)
        self.NIN_2 = NIN(c, c, dtype=dtype, device=device)
        self.NIN_3 = NIN(c, c, init_scale=init_scale, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = self.GroupNorm_0(x)
        q = self.NIN_0(h).reshape(b, hh * ww, c)
        k = self.NIN_1(h).reshape(b, hh * ww, c)
        v = self.NIN_2(h).reshape(b, hh * ww, c)
        scale = float(c) ** -0.5
        if self.attn == "flash":
            dt = self.dtype
            h = flash_attn(q.to(dt), k.to(dt), v.to(dt), scale).to(dt).reshape(b, hh, ww, c)
            return self._out(x, h)
        if self.attn == "bf16":
            bf = torch.bfloat16
            scores = torch.matmul(q.to(bf), k.to(bf).transpose(1, 2))
            scores = scores * torch.tensor(scale, dtype=bf, device=x.device)
            w = torch.softmax(scores.to(torch.float32), dim=-1).to(self.dtype)
        else:
            scores = torch.matmul(
                q.to(torch.float32), k.to(torch.float32).transpose(1, 2)
            ) * scale
            w = torch.softmax(scores, dim=-1).to(self.dtype)
        h = torch.matmul(w, v.to(self.dtype)).reshape(b, hh, ww, c)
        return self._out(x, h)

    def _out(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        h = self.NIN_3(h)
        if not self.skip_rescale:
            return x + h
        # bf16 + bf16, then divided by a float32 numpy scalar in the JAX
        # package: the result is float32 there too
        return (x + h).to(torch.float32) / _SQRT2


class FIRConv2d(nn.Module):
    """Conv2d with fused FIR downsampling (StyleGAN2; reference
    up_or_down_sampling.py:28-61), down only: FIR pad (2,2) with the 4x4
    kernel, then a stride-2 3x3 conv.  Weight HWIO.  Plain PyTorch on
    every device, as the JAX package leaves it to XLA."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 down: bool = True, resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if not down or kernel != 3:
            raise NotImplementedError(
                "FIRConv2d: only the 3x3 down variant is ported (ROADMAP.md)"
            )
        self.in_ch, self.out_ch = in_ch, out_ch
        self.resample_kernel = tuple(resample_kernel)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(3, 3, in_ch, out_ch, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        default_init()(self.weight, 9 * self.in_ch, 9 * self.out_ch, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = conv_downsample_2d(x, self.weight.to(dt), k=self.resample_kernel)
        return h + self.bias.to(dt)


class Downsample(nn.Module):
    """Resolution /2 with a FIR conv (reference layerspp.py:176-210),
    ``with_conv=True, fir=True`` only."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 with_conv: bool = True, fir: bool = True,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if not (with_conv and fir):
            raise NotImplementedError(
                "Downsample: only with_conv=True, fir=True is ported (ROADMAP.md)"
            )
        self.Conv2d_0 = FIRConv2d(in_ch, out_ch or in_ch, down=True,
                                  resample_kernel=fir_kernel, dtype=dtype,
                                  device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv2d_0(x)


class ResnetBlockBigGANppAdagn(nn.Module):
    """The BigGAN-style AdaGN resblock (reference layerspp.py:261-324),
    with FIR up/down resampling (``fir=True``)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 temb_dim: Optional[int] = None, zemb_dim: int = 256,
                 up: bool = False, down: bool = False,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1),
                 skip_rescale: bool = True, init_scale: float = 0.0,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        assert not (up and down)
        out_ch = out_ch or in_ch
        self.up, self.down = up, down
        self.dropout = dropout
        self.fir_kernel = tuple(fir_kernel)
        self.skip_rescale = skip_rescale
        self.dtype = dtype
        self.GroupNorm_0 = AdaptiveGroupNorm(in_ch, zemb_dim, dtype=dtype, device=device)
        self.Conv_0 = Conv3x3(in_ch, out_ch, dtype=dtype, device=device)
        self.Dense_0 = (
            Dense(temb_dim, out_ch, kernel_init=default_init(), dtype=dtype,
                  device=device)
            if temb_dim is not None else None
        )
        self.GroupNorm_1 = AdaptiveGroupNorm(out_ch, zemb_dim, dtype=dtype, device=device)
        self.Conv_1 = Conv3x3(out_ch, out_ch, init_scale=init_scale, dtype=dtype,
                              device=device)
        self.Conv_2 = (
            Conv1x1(in_ch, out_ch, dtype=dtype, device=device)
            if (in_ch != out_ch or up or down) else None
        )

    def fir_launches(self) -> dict:
        """FIR kernel launches per forward: h and x are both resampled."""
        return {"fir_up2": 2 * self.up, "fir_down2": 2 * self.down}

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                zemb: torch.Tensor,
                dropout: Optional[Union[int, Tuple[int, int, int], torch.Tensor]] = None
                ) -> torch.Tensor:
        """``dropout``, used when the block's rate is above 0: the keep
        mask (bool, the shape of ``Conv_1``'s input), the seed it is drawn
        from, or ``(seed, global batch, first row)``; None runs
        deterministically (flax's ``train=False``)."""
        h = F.silu(self.GroupNorm_0(x, zemb))
        if self.up:
            h = fir_up2(h.contiguous(), self.fir_kernel)
            x = fir_up2(x.contiguous(), self.fir_kernel)
        elif self.down:
            h = fir_down2(h.contiguous(), self.fir_kernel)
            x = fir_down2(x.contiguous(), self.fir_kernel)
        h = self.Conv_0(h)
        if self.Dense_0 is not None and temb is not None:
            h = h + self.Dense_0(F.silu(temb))[:, None, None, :]
        h = F.silu(self.GroupNorm_1(h, zemb))
        if self.dropout > 0 and dropout is not None:
            if torch.is_tensor(dropout):
                keep = dropout
            elif isinstance(dropout, tuple):
                keep = dropout_keep(h.shape, self.dropout, dropout[0], h.device, dropout[1:])
            else:
                keep = dropout_keep(h.shape, self.dropout, dropout, h.device)
            # flax divides in the input's dtype by the rate's weak scalar
            scale = torch.tensor(1.0 - self.dropout, dtype=h.dtype)
            h = torch.where(keep, h / scale, torch.zeros((), dtype=h.dtype))
        h = self.Conv_1(h)
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        if not self.skip_rescale:
            return x + h
        return ((x + h).to(torch.float32) / _SQRT2).to(h.dtype)
