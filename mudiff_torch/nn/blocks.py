"""NCSN++ building blocks: GroupNorms, the Fourier time embedding, the
pyramid combiner, attention, resampling and the three AdaGN resblocks.

The port of ``mudiff_tpu/nn/blocks.py:28-538``.  NHWC; ``dtype`` is the
compute dtype, parameters stay float32, GroupNorm statistics are always
float32 (eps 1e-6, flax's fast variance E[x^2] - E[x]^2).  Every norm, its
modulation and the SiLU after it run as kernel K5 (``ops.group_norm_act``)
on CUDA tensors; ``group_norm`` is its plain chain.  Factor-2 FIR
resampling without a conv runs kernels K2a/K2b (``ops.fir_down2`` /
``ops.fir_up2``) and the stride-1 3x3 convs K1 on CUDA tensors; the
naive resamples (nearest, box mean), the FIR convs (``FIRConv2d``:
``upsample_conv_2d`` / ``conv_downsample_2d``) and the stride-2 conv of
the naive ``Downsample`` are plain PyTorch, as the JAX package leaves
them to XLA.  A resblock's dropout (``dropout > 0``, training only) is
flax's ``nn.Dropout`` at the same point: after the second activation,
before ``Conv_1``, as ``where(keep, h / (1 - p), 0)``; the keep mask is
given, or drawn from a seed (``dropout_keep``), so a recomputed forward
draws the same one.  On a mesh the seed comes with the global batch and
this rank's first row: the mask is drawn for the global batch and the
rank's rows are kept.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from mudiff_torch.nn.initializers import default_init, stylegan_dense_init
from mudiff_torch.nn.layers import NIN, Conv1x1, Conv3x3, Dense
from mudiff_torch.utils.profiling import span
from mudiff_torch.ops import (
    conv_downsample_2d,
    fir_down2,
    fir_up2,
    flash_attn,
    group_norm_act,
    upsample_conv_2d,
)
from mudiff_torch.ops.group_norm import group_norm_plain as group_norm  # K5's plain chain

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


def naive_upsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample (reference up_or_down_sampling.py:64-68)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, 1, w, 1, c).expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)


def naive_downsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Box-mean downsample (reference up_or_down_sampling.py:71-74)."""
    n, h, w, c = x.shape
    return x.reshape(n, h // factor, factor, w // factor, factor, c).mean(dim=(2, 4))


class AffineGroupNorm(nn.Module):
    """Affine GroupNorm (torch nn.GroupNorm default affine=True), then
    SiLU with ``silu``."""

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

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        with span("nn.norm"):
            return group_norm_act(x, self.num_groups, self.dtype, self.weight, self.bias,
                                  silu=silu)


class AdaptiveGroupNorm(nn.Module):
    """GroupNorm modulated by a style vector: style -> (gamma, beta), the
    style bias initialized to gamma=1, beta=0 (reference layerspp.py:37-54);
    then SiLU with ``silu``.  The style dense's (B, 2C) output goes to K5
    whole."""

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

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                silu: bool = False) -> torch.Tensor:
        with span("nn.norm"):
            return group_norm_act(x, _num_groups(self.channels), self.dtype,
                                  style=self.style(style), silu=silu)


class PlainGroupNorm(nn.Module):
    """Non-affine GroupNorm, groups min(C // 4, 32), eps 1e-6, output in
    the input's dtype (reference layerspp.py:56-65); then SiLU with
    ``silu``."""

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        with span("nn.norm"):
            return group_norm_act(x, _num_groups(x.shape[-1]), x.dtype, silu=silu)


class GaussianFourierProjection(nn.Module):
    """Frozen random Fourier time embedding (reference layerspp.py:68-77):
    ``[sin(2 pi x W), cos(2 pi x W)]``, 2 * ``embedding_size`` wide, float32.

    ``W`` is a normal draw times ``scale`` and never trained: the forward
    reads it detached (the JAX package's ``stop_gradient``).  It stays a
    parameter, so the parameter tree and Adam's state are the JAX
    package's (its gradient is zero, so its Adam update is zero too).
    The generator feeds it ``log(t)``: at t = 0 every lane is NaN, in
    both packages and in the reference.
    """

    def __init__(self, embedding_size: int = 256, scale: float = 1.0, device=None):
        super().__init__()
        self.scale = scale
        self.W = nn.Parameter(torch.empty(embedding_size, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.W.copy_(torch.randn(self.W.shape, generator=generator) * self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.W.detach().to(torch.float32)
        x_proj = x.to(torch.float32)[:, None] * w[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class Combine(nn.Module):
    """The input pyramid's combiner: a 1x1 conv of the pyramid image, then
    concatenated with (``"cat"``) or added to (``"sum"``) the trunk
    (reference layerspp.py:80-95)."""

    def __init__(self, in_ch: int, features: int, method: str = "cat",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"Method {method} not recognized.")
        self.method = method
        self.Conv_0 = Conv1x1(in_ch, features, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(x)
        if self.method == "cat":
            return torch.cat([h, y], dim=-1)
        return h + y


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
    """3x3 conv with fused FIR resampling (StyleGAN2; reference
    up_or_down_sampling.py:28-61), the only size and form the JAX
    package's call sites build (bias on).  Weight HWIO, bias added in the
    compute dtype after the conv.  ``up``: ``upsample_conv_2d``; ``down``:
    ``conv_downsample_2d``; neither: a SAME conv (``F.conv2d`` in the
    compute dtype).  Plain PyTorch on every device, as the JAX package
    leaves all three to XLA."""

    def __init__(self, in_ch: int, out_ch: int, up: bool = False, down: bool = False,
                 resample_kernel: Sequence[int] = (1, 3, 3, 1),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        assert not (up and down)
        self.in_ch, self.out_ch = in_ch, out_ch
        self.up, self.down = up, down
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
        x, w = x.to(dt), self.weight.to(dt)
        if self.up:
            h = upsample_conv_2d(x, w, k=self.resample_kernel)
        elif self.down:
            h = conv_downsample_2d(x, w, k=self.resample_kernel)
        else:
            h = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                         padding=1).permute(0, 2, 3, 1)
        return h + self.bias.to(dt)


class Upsample(nn.Module):
    """Resolution x2 (reference layerspp.py:141-173), four variants
    (default: the FIR conv, as the generator's pyramids and resamples use):
    ``fir`` without a conv is K2b (``fir_up2``, gain 4); ``fir`` with a
    conv is ``FIRConv2d(up=True)`` (``Conv2d_0``); naive is nearest, then,
    ``with_conv``, a 3x3 SAME ``Conv3x3`` (``Conv_0``, K1)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 with_conv: bool = True, fir: bool = True,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.with_conv, self.fir = with_conv, fir
        self.fir_kernel = tuple(fir_kernel)
        if with_conv and fir:
            self.Conv2d_0 = FIRConv2d(in_ch, out_ch, up=True, resample_kernel=fir_kernel,
                                      dtype=dtype, device=device)
        elif with_conv:
            self.Conv_0 = Conv3x3(in_ch, out_ch, dtype=dtype, device=device)

    def fir_launches(self) -> dict:
        return {"fir_up2": int(self.fir and not self.with_conv)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fir:
            if not self.with_conv:
                return fir_up2(x.contiguous(), self.fir_kernel)
            return self.Conv2d_0(x)
        h = naive_upsample_2d(x, 2)
        return self.Conv_0(h) if self.with_conv else h


class Downsample(nn.Module):
    """Resolution /2 (reference layerspp.py:176-210), four variants
    (default: the FIR conv, as the generator's pyramids and resamples use):
    ``fir`` without a conv is K2a (``fir_down2``); ``fir`` with a conv is
    ``FIRConv2d(down=True)`` (``Conv2d_0``); naive is the 2x2 box mean, or,
    ``with_conv``, a (0, 1) pad and a stride-2 VALID ``Conv3x3``
    (``Conv_0``, ``F.conv2d`` rounded as flax ``nn.Conv``)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 with_conv: bool = True, fir: bool = True,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.with_conv, self.fir = with_conv, fir
        self.fir_kernel = tuple(fir_kernel)
        if with_conv and fir:
            self.Conv2d_0 = FIRConv2d(in_ch, out_ch, down=True, resample_kernel=fir_kernel,
                                      dtype=dtype, device=device)
        elif with_conv:
            self.Conv_0 = Conv3x3(in_ch, out_ch, stride=2, padding=0, dtype=dtype,
                                  device=device)

    def fir_launches(self) -> dict:
        return {"fir_down2": int(self.fir and not self.with_conv)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fir:
            if not self.with_conv:
                return fir_down2(x.contiguous(), self.fir_kernel)
            return self.Conv2d_0(x)
        if self.with_conv:
            return self.Conv_0(F.pad(x, (0, 0, 0, 1, 0, 1)))
        # flax nn.avg_pool: VALID 2x2 windows, an odd last row dropped
        return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _dropout(h: torch.Tensor, p: float,
             dropout: Optional[Union[int, Tuple[int, int, int], torch.Tensor]]
             ) -> torch.Tensor:
    """flax's ``nn.Dropout`` at rate ``p`` with a keep mask, a seed, or
    ``(seed, global batch, first row)``; None (or ``p == 0``) is the
    identity."""
    if p <= 0 or dropout is None:
        return h
    if torch.is_tensor(dropout):
        keep = dropout
    elif isinstance(dropout, tuple):
        keep = dropout_keep(h.shape, p, dropout[0], h.device, dropout[1:])
    else:
        keep = dropout_keep(h.shape, p, dropout, h.device)
    # flax divides in the input's dtype by the rate's weak scalar
    scale = torch.tensor(1.0 - p, dtype=h.dtype)
    return torch.where(keep, h / scale, torch.zeros((), dtype=h.dtype))


def _skip_out(x: torch.Tensor, h: torch.Tensor, skip_rescale: bool) -> torch.Tensor:
    if not skip_rescale:
        return x + h
    # bf16 + bf16, then divided by a float32 numpy scalar in the JAX package
    return ((x + h).to(torch.float32) / _SQRT2).to(h.dtype)


class ResnetBlockBigGANppAdagn(nn.Module):
    """The BigGAN-style AdaGN resblock (reference layerspp.py:261-324).
    ``up`` / ``down`` resample h and the skip: with ``fir`` by K2b / K2a,
    without by nearest / box mean."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 temb_dim: Optional[int] = None, zemb_dim: int = 256,
                 up: bool = False, down: bool = False, fir: bool = True,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1),
                 skip_rescale: bool = True, init_scale: float = 0.0,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        assert not (up and down)
        out_ch = out_ch or in_ch
        self.up, self.down, self.fir = up, down, fir
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
        self.GroupNorm_1 = self._second_norm(out_ch, zemb_dim, dtype, device)
        self.Conv_1 = Conv3x3(out_ch, out_ch, init_scale=init_scale, dtype=dtype,
                              device=device)
        self.Conv_2 = (
            Conv1x1(in_ch, out_ch, dtype=dtype, device=device)
            if (in_ch != out_ch or up or down) else None
        )

    @staticmethod
    def _second_norm(out_ch: int, zemb_dim: int, dtype, device) -> nn.Module:
        return AdaptiveGroupNorm(out_ch, zemb_dim, dtype=dtype, device=device)

    def _norm1(self, h: torch.Tensor, zemb: torch.Tensor) -> torch.Tensor:
        """The second norm and its SiLU."""
        return self.GroupNorm_1(h, zemb, silu=True)

    def fir_launches(self) -> dict:
        """FIR kernel launches per forward: h and x are both resampled."""
        return {"fir_up2": 2 * (self.up and self.fir),
                "fir_down2": 2 * (self.down and self.fir)}

    def _resample(self, t: torch.Tensor) -> torch.Tensor:
        if self.up:
            return (fir_up2(t.contiguous(), self.fir_kernel) if self.fir
                    else naive_upsample_2d(t, 2))
        if self.down:
            return (fir_down2(t.contiguous(), self.fir_kernel) if self.fir
                    else naive_downsample_2d(t, 2))
        return t

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                zemb: torch.Tensor,
                dropout: Optional[Union[int, Tuple[int, int, int], torch.Tensor]] = None
                ) -> torch.Tensor:
        """``dropout``, used when the block's rate is above 0: the keep
        mask (bool, the shape of ``Conv_1``'s input), the seed it is drawn
        from, or ``(seed, global batch, first row)``; None runs
        deterministically (flax's ``train=False``)."""
        h = self.GroupNorm_0(x, zemb, silu=True)
        h, x = self._resample(h), self._resample(x)
        h = self.Conv_0(h)
        if self.Dense_0 is not None and temb is not None:
            h = h + self.Dense_0(F.silu(temb))[:, None, None, :]
        h = self._norm1(h, zemb)
        h = self.Conv_1(_dropout(h, self.dropout, dropout))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return _skip_out(x, h, self.skip_rescale)


class ResnetBlockBigGANppAdagnOne(ResnetBlockBigGANppAdagn):
    """``resblock_type="biggan_oneadagn"``: the BigGAN AdaGN resblock whose
    second norm is an affine GroupNorm (reference layerspp.py:327-391)."""

    @staticmethod
    def _second_norm(out_ch: int, zemb_dim: int, dtype, device) -> nn.Module:
        return AffineGroupNorm(_num_groups(out_ch), out_ch, dtype=dtype, device=device)

    def _norm1(self, h: torch.Tensor, zemb: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_1(h, silu=True)


class ResnetBlockDDPMppAdagn(nn.Module):
    """``resblock_type="ddpm"``: the DDPM-style AdaGN resblock (reference
    layerspp.py:213-258): two AdaGNs, no resampling, and a ``NIN_0`` skip
    when the width changes (the JAX module's ``conv_shortcut`` 3x3 skip is
    never built: the generator passes False)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 temb_dim: Optional[int] = None, zemb_dim: int = 256,
                 skip_rescale: bool = False,
                 init_scale: float = 0.0, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.dropout = dropout
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
        self.NIN_0 = NIN(in_ch, out_ch, dtype=dtype, device=device) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                zemb: torch.Tensor,
                dropout: Optional[Union[int, Tuple[int, int, int], torch.Tensor]] = None
                ) -> torch.Tensor:
        """As ``ResnetBlockBigGANppAdagn.forward``."""
        h = self.Conv_0(self.GroupNorm_0(x, zemb, silu=True))
        if self.Dense_0 is not None and temb is not None:
            h = h + self.Dense_0(F.silu(temb))[:, None, None, :]
        h = self.GroupNorm_1(h, zemb, silu=True)
        h = self.Conv_1(_dropout(h, self.dropout, dropout))
        if self.NIN_0 is not None:
            x = self.NIN_0(x)
        return _skip_out(x, h, self.skip_rescale)


RESBLOCKS = (ResnetBlockBigGANppAdagn, ResnetBlockDDPMppAdagn)
