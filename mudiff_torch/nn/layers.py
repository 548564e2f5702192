"""Primitive layers: the activation registry, convs, dense, NIN, the
critic's StyleConv2d, time embedding, PixelNorm.

The port of ``mudiff_tpu/nn/layers.py:26-283``.  Tensors are NHWC.
Parameters are float32; each module casts them and its input to its
compute ``dtype`` at use, as flax does with ``param_dtype=float32``.

Weight layouts (``convert.py`` is where the flax ones are mapped):
* a 3x3 conv weight is HWIO ``(3, 3, Cin, Cout)``, the layout kernel K1
  reads;
* every 2-D weight (dense, 1x1 conv, NIN) is ``(out, in)`` for
  ``F.linear``.

Each parameterised module has ``reset_parameters(generator)``, which
draws the JAX package's initial distribution from a CPU
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mudiff_torch.nn.initializers import Init, default_init, stylegan_dense_init
from mudiff_torch.ops import conv3x3
from mudiff_torch.ops.int8_conv import (
    Int8WeightCache,
    int8_conv_routed,
    int8_enabled,
    routed_conv,
)


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry (reference backbones/layers.py:33-45)."""
    name = name.lower()
    if name == "elu":
        return F.elu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, 0.2)
    if name in ("swish", "silu"):
        return F.silu
    raise NotImplementedError(f"activation {name} does not exist")


class Conv3x3(nn.Module):
    """3x3 conv with DDPM init (reference layers.py:122-128).

    Runs kernel K1 on CUDA tensors (``ops/conv3x3.py``); the fp32 bias is
    added to the kernel's fp32 accumulator and the sum rounded once, as
    the JAX package's GEMM conv does (its default ``nn.Conv`` rounds the
    conv to the compute dtype before adding the bias).

    Inside an enabled ``int8_scope``, outside training mode, a conv that
    ``int8_conv_routed(in_ch, out_ch)`` admits runs K4 instead
    (``ops/int8_conv.py``, as ``mudiff_tpu/nn/layers.py:114-130``): the
    fp32 parameter is quantized (and cached), never its compute-dtype
    copy, and the input goes in as it arrives.  The parameters are the
    same in both modes, so any checkpoint serves quantized.

    ``stride`` / ``padding`` other than 1 / 1 (the naive ``Downsample``'s
    stride-2 VALID conv) take flax ``nn.Conv``'s path in the JAX package,
    not the Pallas conv: here ``F.conv2d`` in the compute dtype, its
    result rounded to it and a compute-dtype bias added, as ``nn.Conv``
    does.  Such a conv is neither K1 nor K4.
    """

    def __init__(self, in_ch: int, out_ch: int, init_scale: float = 1.0,
                 stride: int = 1, padding: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.stride, self.padding = stride, padding
        self.init_scale = init_scale
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(3, 3, in_ch, out_ch, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
        self._int8 = Int8WeightCache()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        default_init(self.init_scale)(
            self.weight, 9 * self.in_ch, 9 * self.out_ch, generator
        )
        with torch.no_grad():
            self.bias.zero_()

    @property
    def on_kernels(self) -> bool:
        """Whether the conv runs K1 (or K4): stride 1, SAME."""
        return self.stride == 1 and self.padding == 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.on_kernels:
            dt = self.dtype
            y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt).permute(3, 2, 0, 1),
                         stride=self.stride, padding=self.padding).permute(0, 2, 3, 1)
            return y + self.bias.to(dt)
        if (not self.training and int8_enabled()
                and int8_conv_routed(self.in_ch, self.out_ch)):
            return routed_conv(x, self.out_ch, lambda: self.weight, (self.weight,),
                               self.bias, self.dtype, self._int8)
        return conv3x3(
            x.to(self.dtype).contiguous(),
            self.weight.to(self.dtype).contiguous(),
            self.bias,
        )


class Dense(nn.Module):
    """Linear layer, weight (out, in).  ``kernel_init`` defaults to the
    sdeflow init of ``layers.Dense`` (reference dense_layer.py:67-71); the
    generator's temb denses pass ``default_init()``.  ``bias_init`` is a
    tensor of initial bias values (zeros if None)."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_init: Optional[Init] = None,
                 bias_init: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.kernel_init = kernel_init or stylegan_dense_init(1.0)
        self.bias_init = bias_init
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.kernel_init(self.weight, self.in_features, self.out_features, generator)
        with torch.no_grad():
            if self.bias_init is None:
                self.bias.zero_()
            else:
                self.bias.copy_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv1x1(Dense):
    """1x1 conv with DDPM init (reference layers.py:104-109), as a dense
    layer over the channel axis of an NHWC tensor."""

    def __init__(self, in_ch: int, out_ch: int, init_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_ch, out_ch, kernel_init=default_init(init_scale),
                         dtype=dtype, device=device)


class NIN(Dense):
    """1x1 'network-in-network' layer (reference layers.py:496-505);
    default init_scale 0.1 as in the reference."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_dim, num_units, kernel_init=default_init(init_scale),
                         dtype=dtype, device=device)


class StyleConv2d(nn.Module):
    """Plain conv with the sdeflow init (reference dense_layer.py:73-80),
    the critic's conv (``mudiff_tpu/nn/layers.py:208-235``).

    A k x k kernel is HWIO ``(k, k, Cin, Cout)``; a 1x1 kernel is
    ``(Cout, Cin)`` (``convert.py``'s layouts).  It runs as plain
    ``F.conv2d`` / ``F.linear`` in the compute dtype on every device, as
    the JAX package runs it as XLA ``nn.Conv`` and not through Pallas;
    so R1's double backward never needs K1's.  The bias is added after
    the conv, in the compute dtype, as flax does.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 padding: int = 1, use_bias: bool = True, init_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.kernel_size, self.padding = kernel_size, padding
        self.init_scale = init_scale
        self.dtype = dtype
        shape = ((out_ch, in_ch) if kernel_size == 1
                 else (kernel_size, kernel_size, in_ch, out_ch))
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device)) if use_bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        area = self.kernel_size ** 2
        stylegan_dense_init(self.init_scale)(
            self.weight, area * self.in_ch, area * self.out_ch, generator
        )
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        if self.kernel_size == 1 and self.padding == 0:
            y = F.linear(x, self.weight.to(dt))
        else:
            w = self.weight.to(dt)
            if self.kernel_size == 1:
                w = w.t()[None, None]
            y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                         padding=self.padding).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           max_positions: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, float32 (reference layers.py:465-479)."""
    assert timesteps.dim() == 1
    half_dim = embedding_dim // 2
    scale = math.log(max_positions) / (half_dim - 1)
    freqs = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -scale
    )
    emb = timesteps.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    """z-normalization of the latent mapping network
    (reference ncsnpp_generator_adagn_feat.py:44-49)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-8)
