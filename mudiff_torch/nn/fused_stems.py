"""The fused condition-image stems of G1 and G2.

The port of ``mudiff_tpu/nn/fused_stems.py:47-114,249-500`` in its dense
(``groups == 1``) form.  The generator encodes x_t and the condition
images through N two-conv stems; the N stems run as ONE conv with a
block-diagonal kernel (off-diagonal blocks are exact zeros, so every
output equals the per-stem computation), one stacked GroupNorm whose
groups never cross a stem, and a second block-diagonal conv.  Outputs
are stem-major: channels ``[i*F, (i+1)*F)`` belong to stem i.

The ``*Params`` modules declare the per-stem parameters under the JAX
package's names (``encoder_x``, ``encoder_c{i}``, ``pseudo_gap``,
``feat_att*``, ``feat_weight_c*``) and compute nothing; the functions
below assemble the fused kernels from them on every call.  Every fused
conv is a 3x3 stride-1 conv, so it runs kernel K1 on CUDA tensors.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn as nn

from mudiff_torch.nn.blocks import AdaptiveGroupNorm, _num_groups, group_norm
from mudiff_torch.nn.layers import Conv3x3, Dense
from mudiff_torch.ops import conv3x3

Act = Callable[[torch.Tensor], torch.Tensor]


class ConvFeatParams(nn.Module):
    """Parameters of ConvFeatBlock: conv1 (in_ch -> F), conv2 (F -> F)."""

    def __init__(self, features: int, in_ch: int = 1, device=None):
        super().__init__()
        self.conv1 = Conv3x3(in_ch, features, device=device)
        self.conv2 = Conv3x3(features, features, device=device)


class ConvBlockParams(nn.Module):
    """Parameters of ConvBlock: conv1, the AdaGN style dense
    (``group_norm.style``), conv2."""

    def __init__(self, features: int, style_dim: int = 256, in_ch: int = 1,
                 device=None):
        super().__init__()
        self.conv1 = Conv3x3(in_ch, features, device=device)
        self.group_norm = AdaptiveGroupNorm(features, style_dim, device=device)
        self.conv2 = Conv3x3(features, features, device=device)


class ConvBlockGAPParams(nn.Module):
    """Parameters of ConvBlockGAP: conv1, conv2, fc (F -> zemb_dim)."""

    def __init__(self, features: int, zemb_dim: int = 256, in_ch: int = 1,
                 device=None):
        super().__init__()
        self.conv1 = Conv3x3(in_ch, features, device=device)
        self.conv2 = Conv3x3(features, features, device=device)
        self.fc = Dense(features, zemb_dim, device=device)


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


def _conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """A fused 3x3 stride-1 conv in ``dtype`` with a float32 bias (K1)."""
    return conv3x3(x.to(dtype).contiguous(), kernel.to(dtype).contiguous(),
                   bias.to(torch.float32).contiguous())


def stacked_group_norm(h: torch.Tensor, n_stems: int,
                       groups_per_stem: int) -> torch.Tensor:
    """Non-affine GroupNorm over a stem-stacked tensor, groups inside stems."""
    return group_norm(h, n_stems * groups_per_stem, h.dtype)


def fused_convfeat_apply(stacked: torch.Tensor, params: List[ConvFeatParams],
                         act: Act, dtype: torch.dtype) -> torch.Tensor:
    """N ConvFeatBlocks in one pass.  stacked: (B,H,W,N) 1-channel inputs;
    returns (B,H,W,N*F), stem-major.  Two K1 launches."""
    n = len(params)
    f = params[0].conv1.out_ch
    k1 = block_diag_conv1([p.conv1.weight for p in params])
    k2 = block_diag_conv2([p.conv2.weight for p in params])
    b1 = torch.cat([p.conv1.bias for p in params])
    b2 = torch.cat([p.conv2.bias for p in params])
    h = _conv(stacked, k1, b1, dtype)
    h = act(stacked_group_norm(h, n, _num_groups(f)))
    return _conv(h, k2, b2, dtype)


def fused_adaptive_encode(
    x: torch.Tensor,
    conds: List[torch.Tensor],
    pseudo: torch.Tensor,
    px: ConvFeatParams,
    pcs: List[ConvBlockParams],
    pgap: ConvBlockGAPParams,
    act: Act,
    dtype: torch.dtype,
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """G2 condition encoding, fused (three K1 launches).

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

    k1 = block_diag_conv1(
        [px.conv1.weight] + [p.conv1.weight for p in pcs] + [pgap.conv1.weight]
    )
    b1 = torch.cat([px.conv1.bias] + [p.conv1.bias for p in pcs] + [pgap.conv1.bias])
    h = _conv(stacked, k1, b1, dtype)
    h = stacked_group_norm(h, n, _num_groups(f))

    # pseudo branch first: the GAP style vector the condition blocks need
    hp = act(h[..., n_c * f + f:])
    hp = _conv(hp, pgap.conv2.weight, pgap.conv2.bias, dtype)
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
    k2 = block_diag_conv2([px.conv2.weight] + [p.conv2.weight for p in pcs])
    b2 = torch.cat([px.conv2.bias] + [p.conv2.bias for p in pcs])
    out = _conv(h4, k2, b2, dtype)
    x_feat = out[..., :f]
    feats = [out[..., (i + 1) * f:(i + 2) * f] for i in range(n_c)]
    return x_feat, feats, pseudo_weight


def fused_gate_convs(allc: torch.Tensor, gates: List[Conv3x3],
                     dtype: torch.dtype) -> List[torch.Tensor]:
    """N gate convs on one input: kernels concatenated along Cout, one K1
    launch; returns the sigmoided per-gate outputs."""
    f = gates[0].out_ch
    k = torch.cat([g.weight for g in gates], dim=-1)
    b = torch.cat([g.bias for g in gates])
    g = torch.sigmoid(_conv(allc, k, b, dtype))
    return [g[..., i * f:(i + 1) * f] for i in range(len(gates))]


def fused_weight_convs(inputs: List[torch.Tensor], convs: List[Conv3x3],
                       dtype: torch.dtype) -> List[torch.Tensor]:
    """N same-shape convs on N inputs as one block-diagonal K1 launch."""
    f = convs[0].out_ch
    k = block_diag_conv2([c.weight for c in convs])
    b = torch.cat([c.bias for c in convs])
    out = _conv(torch.cat(inputs, dim=-1), k, b, dtype)
    return [out[..., i * f:(i + 1) * f] for i in range(len(convs))]
