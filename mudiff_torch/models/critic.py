"""The time-conditional critics: ``DiscriminatorLarge`` (the shipped
recipe's), ``DiscriminatorImgLarge`` and ``DiscriminatorSmall``.

The port of ``mudiff_tpu/models/critic.py`` (reference
backbones/discriminator.py:20-349).  NHWC; ``dtype`` is the compute
dtype, parameters stay float32.  ``DiscriminatorLarge`` returns
``(logit, mid_feat)``: the float32 logit per image and the activation
after ``conv3`` (32x downsampled, ngf*8 channels), from which the G step
builds its masks.  ``DiscriminatorImgLarge`` is the same trunk with the
logit alone (its start conv takes the 2 * nc channels of ``cat(x, x_t)``,
as the JAX package builds it: the reference's own constructor builds an
nc-channel one its forward cannot feed).  ``DiscriminatorSmall`` is the
CIFAR-scale critic: a non-downsampling ``conv1``, three downsampling
blocks, a ``final_conv`` initialised at scale 0, and a ``(B, 1)`` logit.

Every conv is a plain ``StyleConv2d`` (``nn/layers.py``), as in the JAX
package.  ``DownConvBlock``'s two FIR downsamples run kernel K2a
(``ops.fir_down2``), as the generator's resblocks do where the JAX
package runs XLA's ``upfirdn2d``; K2a is twice differentiable, so R1's
double backward runs the kernels too.

On a mesh (``mesh``, set by ``TrainState``) the minibatch-stddev feature
is the global batch's, as under the JAX package's SPMD critic
(``critic.py:91-95``): the feature map is gathered over the data group.
So every forward is a collective, made by every rank in the same order.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mudiff_torch.nn.layers import Dense, StyleConv2d, get_timestep_embedding
from mudiff_torch.ops import fir_down2
from mudiff_torch.parallel.mesh import Mesh, gather_rows, rows_of

_SQRT2 = math.sqrt(2.0)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class TimestepEmbedding(nn.Module):
    """sinusoidal -> dense -> act -> dense (reference discriminator.py:20-37)."""

    def __init__(self, embedding_dim: int, hidden_dim: int, output_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.dtype = dtype
        self.fc0 = Dense(embedding_dim, hidden_dim, dtype=dtype, device=device)
        self.fc1 = Dense(hidden_dim, output_dim, dtype=dtype, device=device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        temb = get_timestep_embedding(t, self.embedding_dim)
        return self.fc1(_lrelu(self.fc0(temb.to(self.dtype))))


class DownConvBlock(nn.Module):
    """act -> conv -> +t-bias -> act -> [FIR down both paths] -> conv
    (init 0) -> (out + skip) / sqrt(2) (reference discriminator.py:39-99)."""

    def __init__(self, in_ch: int, features: int, t_emb_dim: int,
                 downsample: bool = False, fir_kernel: Sequence[int] = (1, 3, 3, 1),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.downsample = downsample
        self.fir_kernel = tuple(fir_kernel)
        kw = dict(dtype=dtype, device=device)
        self.conv1 = StyleConv2d(in_ch, features, **kw)
        self.dense_t1 = Dense(t_emb_dim, features, **kw)
        self.conv2 = StyleConv2d(features, features, init_scale=0.0, **kw)
        self.skip = StyleConv2d(in_ch, features, kernel_size=1, padding=0,
                                use_bias=False, **kw)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        out = self.conv1(_lrelu(x))
        out = _lrelu(out + self.dense_t1(t_emb)[:, None, None, :])
        skip_in = x
        if self.downsample:
            out = fir_down2(out.contiguous(), self.fir_kernel)
            skip_in = fir_down2(x.contiguous(), self.fir_kernel)
        out = self.conv2(out)
        skip = self.skip(skip_in)
        # bf16 + bf16, then divided by a float scalar in float32 there too
        return ((out + skip).to(torch.float32) / _SQRT2).to(out.dtype)


def minibatch_stddev(out: torch.Tensor, stddev_group: int = 4,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    """StyleGAN2 minibatch-stddev feature with the reference's strided
    grouping (discriminator.py:246-254): the batch is viewed as
    (group, B // group, ...) with the group index slowest, the biased
    variance taken across groups, averaged over H, W, C per residual
    index, and tiled back group-major.  A batch that ``stddev_group``
    does not divide takes the largest divisor (``critic.py:83-105``).
    With a ``mesh`` the batch is the global one (``gather_rows``), and
    this rank's rows of the feature are kept."""
    whole = gather_rows(out, mesh)
    b, h, w, c = whole.shape
    group = min(b, stddev_group)
    while b % group:
        group -= 1
    x5 = whole.reshape(group, b // group, h, w, c).to(torch.float32)
    var = ((x5 - x5.mean(dim=0)) ** 2).mean(dim=0)
    s = torch.sqrt(var + 1e-8).mean(dim=(1, 2, 3)).repeat(group)[rows_of(b, mesh)]
    s = s[:, None, None, None] * torch.ones((out.shape[0], h, w, 1), dtype=torch.float32,
                                            device=out.device)
    return torch.cat([out, s.to(out.dtype)], dim=-1)


class _Critic(nn.Module):
    """The critics' common frame: the time embedding, the 1x1 start conv
    on ``cat(x, x_t)``, the ``DownConvBlock`` trunk ``conv1..convN`` (each
    ``(out channels, downsample)`` of ``blocks``), the stddev feature, the
    final conv and the linear logit.  ``num_channels`` is the channels of
    each image (flax infers the start conv's input)."""

    def __init__(self, ngf: int, t_emb_dim: int, fir_kernel: Sequence[int],
                 num_channels: int, blocks: Sequence[Tuple[int, bool]],
                 final_init_scale: float, dtype: torch.dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.dtype = dtype
        self.n_blocks = len(blocks)
        kw = dict(dtype=dtype, device=device)
        self.t_embed = TimestepEmbedding(t_emb_dim, t_emb_dim, t_emb_dim, **kw)
        self.start_conv = StyleConv2d(2 * num_channels, ngf * 2, kernel_size=1,
                                      padding=0, **kw)
        ch = ngf * 2
        for i, (out_ch, down) in enumerate(blocks):
            setattr(self, f"conv{i + 1}",
                    DownConvBlock(ch, out_ch, t_emb_dim, downsample=down,
                                  fir_kernel=fir_kernel, **kw))
            ch = out_ch
        self.final_conv = StyleConv2d(ch + 1, ngf * 8, init_scale=final_init_scale, **kw)
        self.end_linear = Dense(ngf * 8, 1, **kw)
        self.mesh: Optional[Mesh] = None
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw the JAX package's initial distributions (CPU generator)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def kernel_launches_per_forward(self) -> Dict[str, int]:
        """K2a launches of one forward: two per downsampling block."""
        return {"fir_down2": sum(2 for m in self.modules()
                                 if isinstance(m, DownConvBlock) and m.downsample)}

    def _trunk(self, x: torch.Tensor, t: torch.Tensor, x_t: torch.Tensor,
               tap: int = 0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the (B, 1) float32 logit, the activation after block ``tap``)."""
        dt = self.dtype
        t_embed = _lrelu(self.t_embed(t))
        h = self.start_conv(torch.cat([x.to(dt), x_t.to(dt)], dim=-1))
        feat = None
        for i in range(self.n_blocks):
            h = getattr(self, f"conv{i + 1}")(h, t_embed)
            if i + 1 == tap:
                feat = h
        h = _lrelu(self.final_conv(minibatch_stddev(h, mesh=self.mesh)))
        return self.end_linear(h.sum(dim=(1, 2))).to(torch.float32), feat


def _large_blocks(ngf: int) -> Tuple[Tuple[int, bool], ...]:
    return tuple((c, True) for c in (ngf * 4, ngf * 8, ngf * 8, ngf * 8, ngf * 8, ngf * 8))


class DiscriminatorLarge(_Critic):
    """256²-scale critic; ``forward(x, t, x_t)`` returns ``(logit,
    mid_feat)`` (reference discriminator.py:175-263)."""

    def __init__(self, ngf: int = 32, t_emb_dim: int = 128,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1), num_channels: int = 1,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(ngf, t_emb_dim, fir_kernel, num_channels, _large_blocks(ngf),
                         1.0, dtype, device, generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                x_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out, mid_feat = self._trunk(x, t, x_t, tap=3)
        return out.reshape(-1), mid_feat


class DiscriminatorImgLarge(_Critic):
    """The image-only large critic (reference discriminator.py:266-349,
    ``mudiff_tpu/models/critic.py:160``): ``DiscriminatorLarge``'s trunk,
    ``forward(x, t, x_t)`` returns the (B,) logit alone."""

    def __init__(self, ngf: int = 32, t_emb_dim: int = 128,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1), num_channels: int = 1,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(ngf, t_emb_dim, fir_kernel, num_channels, _large_blocks(ngf),
                         1.0, dtype, device, generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
        return self._trunk(x, t, x_t)[0].reshape(-1)


class DiscriminatorSmall(_Critic):
    """The CIFAR-scale critic (reference discriminator.py:101-172,
    ``mudiff_tpu/models/critic.py:207``): ``conv1`` keeps the resolution,
    ``conv2..conv4`` halve it, ``final_conv`` starts at scale 0;
    ``forward(x, t, x_t)`` returns the (B, 1) logit."""

    def __init__(self, ngf: int = 64, t_emb_dim: int = 128,
                 fir_kernel: Sequence[int] = (1, 3, 3, 1), num_channels: int = 3,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        blocks = ((ngf * 2, False), (ngf * 4, True), (ngf * 8, True), (ngf * 8, True))
        super().__init__(ngf, t_emb_dim, fir_kernel, num_channels, blocks, 0.0,
                         dtype, device, generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
        return self._trunk(x, t, x_t)[0]
