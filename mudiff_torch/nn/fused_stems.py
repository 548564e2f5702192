"""The condition-image stems of G1 and G2, fused and per stem.

The port of ``mudiff_tpu/nn/fused_stems.py:47-114,249-500`` in its dense
(``groups == 1``) form, and of the per-stem modules
``mudiff_tpu/nn/blocks.py:541-589`` (``ConvFeatBlock``, ``ConvBlock``,
``ConvBlockGAP``).  The generator encodes x_t and the condition
images through N two-conv stems; the N stems run as ONE conv with a
block-diagonal kernel (off-diagonal blocks are exact zeros, so every
output equals the per-stem computation), one stacked GroupNorm whose
groups never cross a stem, and a second block-diagonal conv.  Outputs
are stem-major: channels ``[i*F, (i+1)*F)`` belong to stem i.

The three stem modules hold the per-stem parameters under the JAX
package's names (``encoder_x``, ``encoder_c{i}``, ``pseudo_gap``; the
gates ``feat_att*`` and ``feat_weight_c*`` are plain ``Conv3x3``s).  With
one-channel images the generator runs them fused: the functions below
assemble the fused kernels from their parameters on every call.  With
more channels it calls each module's own ``forward`` (as the JAX
package does, ``mudiff_tpu/models/generator.py:304-318,358-379``); the
parameters are the same either way.  Every conv is a 3x3 stride-1 conv,
so it runs kernel K1 on CUDA tensors, fused or not.

Under int8 serving (``mudiff_tpu/nn/fused_stems.py:206-240``) a fused
conv given an ``Int8WeightCache`` runs K4 when the enclosing int8 scope
routes its shape: the stem conv2 when the generator's stems bit is on
(its cache is then passed), the G2 gate and weight convs always.  Stem
conv1, the pseudo-GAP branch and the head stay on K1.  K4 quantizes the
fp32 fused kernel, built only when its cache is stale.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from mudiff_torch.nn.blocks import AdaptiveGroupNorm, _num_groups, group_norm
from mudiff_torch.nn.layers import Conv3x3, Dense
from mudiff_torch.ops import conv3x3
from mudiff_torch.utils.profiling import span
from mudiff_torch.ops.int8_conv import (
    Int8WeightCache,
    int8_conv_routed,
    int8_enabled,
    routed_conv,
)

Act = Callable[[torch.Tensor], torch.Tensor]


class ConvFeatBlock(nn.Module):
    """Condition-image encoder: conv1 (in_ch -> F) - GroupNorm - act -
    conv2 (F -> F) (reference layerspp.py:394-423)."""

    def __init__(self, features: int, in_ch: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv1 = Conv3x3(in_ch, features, dtype=dtype, device=device)
        self.conv2 = Conv3x3(features, features, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, act: Act) -> torch.Tensor:
        h = self.conv1(x)
        with span("nn.norm"):
            h = group_norm(h, _num_groups(h.shape[-1]), h.dtype)
        return self.conv2(act(h))


class ConvBlock(nn.Module):
    """Style-modulated condition encoder: conv1 - AdaGN(style)
    (``group_norm.style``) - act - conv2 (reference layerspp.py:426-455)."""

    def __init__(self, features: int, style_dim: int = 256, in_ch: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv1 = Conv3x3(in_ch, features, dtype=dtype, device=device)
        self.group_norm = AdaptiveGroupNorm(features, style_dim, dtype=dtype, device=device)
        self.conv2 = Conv3x3(features, features, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, style: torch.Tensor, act: Act) -> torch.Tensor:
        return self.conv2(act(self.group_norm(self.conv1(x), style)))


class ConvBlockGAP(nn.Module):
    """Image -> style vector: conv1 - GroupNorm - act - conv2 - global
    mean - fc (F -> zemb_dim) (reference layerspp.py:458-501)."""

    def __init__(self, features: int, zemb_dim: int = 256, in_ch: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv1 = Conv3x3(in_ch, features, dtype=dtype, device=device)
        self.conv2 = Conv3x3(features, features, dtype=dtype, device=device)
        self.fc = Dense(features, zemb_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, act: Act) -> torch.Tensor:
        h = self.conv1(x)
        with span("nn.norm"):
            h = group_norm(h, _num_groups(h.shape[-1]), h.dtype)
        h = self.conv2(act(h))
        return self.fc(h.mean(dim=(1, 2)))


def block_diag_conv1(kernels: Sequence[torch.Tensor]) -> torch.Tensor:
    """N kernels (3,3,1,F) -> one (3,3,N,N*F) block-diagonal kernel."""
    n = len(kernels)
    f = kernels[0].shape[-1]
    out = kernels[0].new_zeros((3, 3, n, n * f))
    for i, k in enumerate(kernels):
        out[:, :, i, i * f:(i + 1) * f] = k[:, :, 0, :]
    return out


def block_diag_conv2(kernels: Sequence[torch.Tensor]) -> torch.Tensor:
    """N kernels (3,3,F,F) -> one (3,3,N*F,N*F) block-diagonal kernel."""
    n = len(kernels)
    f = kernels[0].shape[-2]
    out = kernels[0].new_zeros((3, 3, n * f, n * f))
    for i, k in enumerate(kernels):
        out[:, :, i * f:(i + 1) * f, i * f:(i + 1) * f] = k
    return out


def _conv(x: torch.Tensor, build: Callable[[Sequence[torch.Tensor]], torch.Tensor],
          sources: Sequence[torch.Tensor], bias: torch.Tensor, dtype: torch.dtype,
          int8_cache: Optional[Int8WeightCache] = None) -> torch.Tensor:
    """A fused 3x3 stride-1 conv in ``dtype`` with a float32 bias, its
    fp32 kernel ``build(sources)`` (whose Cout is the sources' summed):
    K1 on the kernel cast to ``dtype``, or K4 on the fp32 kernel when
    ``int8_cache`` is given and the int8 scope routes the shape."""
    x = x.to(dtype).contiguous()
    bias = bias.to(torch.float32).contiguous()
    cout = sum(w.shape[-1] for w in sources)
    if int8_cache is not None and int8_enabled() and int8_conv_routed(x.shape[-1], cout):
        return routed_conv(x, cout, lambda: build(sources), sources, bias, dtype, int8_cache)
    return conv3x3(x, build(sources).to(dtype).contiguous(), bias)


def _single(kernels: Sequence[torch.Tensor]) -> torch.Tensor:
    return kernels[0]


def _concat_cout(kernels: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(kernels), dim=-1)


def stacked_group_norm(h: torch.Tensor, n_stems: int,
                       groups_per_stem: int) -> torch.Tensor:
    """Non-affine GroupNorm over a stem-stacked tensor, groups inside stems."""
    with span("nn.norm"):
        return group_norm(h, n_stems * groups_per_stem, h.dtype)


def fused_convfeat_apply(stacked: torch.Tensor, params: List[ConvFeatBlock],
                         act: Act, dtype: torch.dtype,
                         stems_int8: Optional[Int8WeightCache] = None) -> torch.Tensor:
    """N ConvFeatBlocks in one pass.  stacked: (B,H,W,N) 1-channel inputs;
    returns (B,H,W,N*F), stem-major.  Two launches: conv1 on K1, conv2 on
    K1 or (``stems_int8``) K4."""
    n = len(params)
    f = params[0].conv1.out_ch
    w1 = [p.conv1.weight for p in params]
    w2 = [p.conv2.weight for p in params]
    b1 = torch.cat([p.conv1.bias for p in params])
    b2 = torch.cat([p.conv2.bias for p in params])
    h = _conv(stacked, block_diag_conv1, w1, b1, dtype)
    h = act(stacked_group_norm(h, n, _num_groups(f)))
    return _conv(h, block_diag_conv2, w2, b2, dtype, stems_int8)


def fused_adaptive_encode(
    x: torch.Tensor,
    conds: List[torch.Tensor],
    pseudo: torch.Tensor,
    px: ConvFeatBlock,
    pcs: List[ConvBlock],
    pgap: ConvBlockGAP,
    act: Act,
    dtype: torch.dtype,
    stems_int8: Optional[Int8WeightCache] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """G2 condition encoding, fused (three launches; the second conv of the
    four non-pseudo stems on K4 with ``stems_int8``).

    Equals pseudo_weight = ConvBlockGAP(pseudo), x_feat = ConvFeatBlock(x),
    feats[i] = ConvBlock(conds[i], pseudo_weight); all five Cin=1 first
    convs run as one block-diagonal conv, the five GroupNorms as one, the
    four non-pseudo second convs as one.  Returns (x_feat, feats,
    pseudo_weight).
    """
    n_c = len(conds)
    f = px.conv1.out_ch
    stems = [x] + list(conds) + [pseudo]
    n = len(stems)
    stacked = torch.cat(stems, dim=-1)

    w1 = [px.conv1.weight] + [p.conv1.weight for p in pcs] + [pgap.conv1.weight]
    b1 = torch.cat([px.conv1.bias] + [p.conv1.bias for p in pcs] + [pgap.conv1.bias])
    h = _conv(stacked, block_diag_conv1, w1, b1, dtype)
    h = stacked_group_norm(h, n, _num_groups(f))

    # pseudo branch first: the GAP style vector the condition blocks need
    hp = act(h[..., n_c * f + f:])
    hp = _conv(hp, _single, [pgap.conv2.weight], pgap.conv2.bias, dtype)
    pw = hp.mean(dim=(1, 2))
    pseudo_weight = pw @ pgap.fc.weight.to(pw.dtype).t() + pgap.fc.bias.to(pw.dtype)

    parts = [act(h[..., :f])]  # x stem: plain GN -> act
    for i, p in enumerate(pcs):
        style = p.group_norm.style
        gb = (pseudo_weight @ style.weight.to(pseudo_weight.dtype).t()
              + style.bias.to(pseudo_weight.dtype))
        gamma, beta = gb.chunk(2, dim=-1)
        hi = h[..., (i + 1) * f:(i + 2) * f]
        parts.append(act(gamma[:, None, None, :] * hi + beta[:, None, None, :]))

    h4 = torch.cat(parts, dim=-1)
    w2 = [px.conv2.weight] + [p.conv2.weight for p in pcs]
    b2 = torch.cat([px.conv2.bias] + [p.conv2.bias for p in pcs])
    out = _conv(h4, block_diag_conv2, w2, b2, dtype, stems_int8)
    x_feat = out[..., :f]
    feats = [out[..., (i + 1) * f:(i + 2) * f] for i in range(n_c)]
    return x_feat, feats, pseudo_weight


def fused_gate_convs(allc: torch.Tensor, gates: List[Conv3x3], dtype: torch.dtype,
                     int8_cache: Optional[Int8WeightCache] = None) -> List[torch.Tensor]:
    """N gate convs on one input: kernels concatenated along Cout, one K1
    (or K4) launch; returns the sigmoided per-gate outputs."""
    f = gates[0].out_ch
    ws = [g.weight for g in gates]
    b = torch.cat([g.bias for g in gates])
    g = torch.sigmoid(_conv(allc, _concat_cout, ws, b, dtype, int8_cache))
    return [g[..., i * f:(i + 1) * f] for i in range(len(gates))]


def fused_weight_convs(inputs: List[torch.Tensor], convs: List[Conv3x3],
                       dtype: torch.dtype,
                       int8_cache: Optional[Int8WeightCache] = None) -> List[torch.Tensor]:
    """N same-shape convs on N inputs as one block-diagonal K1 (or K4) launch."""
    f = convs[0].out_ch
    ws = [c.weight for c in convs]
    b = torch.cat([c.bias for c in convs])
    out = _conv(torch.cat(inputs, dim=-1), block_diag_conv2, ws, b, dtype, int8_cache)
    return [out[..., i * f:(i + 1) * f] for i in range(len(convs))]
