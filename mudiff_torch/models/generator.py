"""Conditional NCSN++ AdaGN generators: G1 (contrast-specific) and G2
(``adaptive=True``, contrast-aware).

The port of ``mudiff_tpu/models/generator.py:136-601`` along the
branches of ``config.brats_recipe``: BigGAN AdaGN resblocks with FIR
resampling, ``progressive="none"``, ``progressive_input="residual"``
(or ``"none"``), positional time embedding, one-channel images, three
conditions.  G1 encodes x_t and the three conditions with four fused
ConvFeatBlock stems; G2 embeds G1's prediction to a 256-d style (always
256, whatever ``z_emb_dim``: ``generator.py:333-336``), encodes the
conditions with style-modulated stems and fuses them with the cyclic
pairwise gates.  Then the same UNet: resblocks, the residual input
pyramid, Res-Attn-Res middle, skip-concat decoder, GroupNorm -> SiLU ->
conv3x3 -> float32 tanh head.

Submodules carry the JAX package's names, so ``convert.py`` maps a flax
tree onto ``state_dict`` keys by rule.  Branches the recipe does not
take raise ``NotImplementedError``; ROADMAP.md queues them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mudiff_torch.config import MuDiffConfig
from mudiff_torch.nn.blocks import (
    AffineGroupNorm,
    AttnBlockpp,
    Downsample,
    ResnetBlockBigGANppAdagn,
    _num_groups,
)
from mudiff_torch.nn.fused_stems import (
    ConvBlockGAPParams,
    ConvBlockParams,
    ConvFeatParams,
    fused_adaptive_encode,
    fused_convfeat_apply,
    fused_gate_convs,
    fused_weight_convs,
)
from mudiff_torch.nn.initializers import default_init
from mudiff_torch.nn.layers import Conv3x3, Dense, get_timestep_embedding, pixel_norm

_SQRT2 = math.sqrt(2.0)
_GATES = ("feat_att1_c12", "feat_att2_c12", "feat_att1_c23",
          "feat_att2_c23", "feat_att1_c31", "feat_att2_c31")


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; ROADMAP.md lists what comes in which slice"
    )


def _check_config(cfg: MuDiffConfig, num_conditions: int) -> None:
    if cfg.resblock_type.lower() != "biggan":
        raise _unsupported(f"resblock_type={cfg.resblock_type!r}")
    if cfg.progressive.lower() != "none":
        raise _unsupported(f"progressive={cfg.progressive!r}")
    if cfg.progressive_input.lower() not in ("none", "residual"):
        raise _unsupported(f"progressive_input={cfg.progressive_input!r}")
    if cfg.embedding_type.lower() != "positional":
        raise _unsupported(f"embedding_type={cfg.embedding_type!r}")
    if cfg.num_channels != 1:
        raise _unsupported("num_channels > 1")
    if num_conditions != 3:
        raise _unsupported("num_conditions=2")
    if cfg.use_int8:
        raise _unsupported("int8 serving")
    if not cfg.fir:
        raise _unsupported("fir=False resampling")


class _ZTransform(nn.Module):
    """Latent mapping: PixelNorm + (n_mlp+1) dense+SiLU
    (reference ncsnpp_generator_adagn_feat.py:271-277)."""

    def __init__(self, nz: int, z_emb_dim: int, n_mlp: int, dtype, device=None):
        super().__init__()
        self.fc0 = Dense(nz, z_emb_dim, dtype=dtype, device=device)
        for i in range(n_mlp):
            setattr(self, f"fc{i + 1}",
                    Dense(z_emb_dim, z_emb_dim, dtype=dtype, device=device))
        self.n_mlp = n_mlp

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.fc0(pixel_norm(z)))
        for i in range(self.n_mlp):
            h = F.silu(getattr(self, f"fc{i + 1}")(h))
        return h


class NCSNppGenerator(nn.Module):
    """NCSN++ with AdaGN; ``adaptive=True`` gives G2.

    ``attn`` is the attention score lowering (``"einsum"`` | ``"bf16"``),
    ``dtype`` the compute dtype (parameters stay float32).  Inputs are
    NHWC; ``forward(x, c1, c2, c3, t, z[, pseudo_target])`` returns the
    float32 prediction of x_0.
    """

    def __init__(self, config: MuDiffConfig, adaptive: bool = False,
                 num_conditions: int = 3, attn: str = "einsum",
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        _check_config(cfg, num_conditions)
        self.config = cfg
        self.adaptive = adaptive
        self.dtype = dtype
        nf = cfg.num_channels_dae
        ch_mult = cfg.ch_mult
        nrb = cfg.num_res_blocks
        self.all_resolutions = [cfg.image_size // (2 ** i) for i in range(len(ch_mult))]
        kw = dict(dtype=dtype, device=device)
        temb_dim = nf * 4 if cfg.conditional else None

        def resblock(in_ch, out_ch=None, up=False, down=False):
            return ResnetBlockBigGANppAdagn(
                in_ch, out_ch, temb_dim=temb_dim, zemb_dim=cfg.z_emb_dim,
                up=up, down=down, fir_kernel=cfg.fir_kernel,
                skip_rescale=cfg.skip_rescale, init_scale=0.0, **kw,
            )

        def attnblock(ch):
            return AttnBlockpp(ch, skip_rescale=cfg.skip_rescale, init_scale=0.0,
                               attn=attn, **kw)

        self.z_transform = _ZTransform(cfg.nz, cfg.z_emb_dim, cfg.n_mlp, **kw)
        if cfg.conditional:
            self.temb_dense0 = Dense(nf, nf * 4, kernel_init=default_init(), **kw)
            self.temb_dense1 = Dense(nf * 4, nf * 4, kernel_init=default_init(), **kw)

        # condition encoding (parameters only; the fused functions run them)
        self.encoder_x = ConvFeatParams(nf, device=device)
        for i in range(num_conditions):
            name = f"encoder_c{i + 1}"
            if adaptive:
                setattr(self, name, ConvBlockParams(nf, style_dim=256, device=device))
            else:
                setattr(self, name, ConvFeatParams(nf, device=device))
        if adaptive:
            self.pseudo_gap = ConvBlockGAPParams(nf, zemb_dim=256, device=device)
            for name in _GATES:
                setattr(self, name, Conv3x3(num_conditions * nf, nf, device=device))
            for i in range(num_conditions):
                setattr(self, f"feat_weight_c{i + 1}", Conv3x3(nf, nf, device=device))

        # encoder
        self._trunk: List[tuple] = []  # (kind, name) in forward order
        hs_c = [4 * nf]
        pyramid_ch = cfg.num_channels
        residual_input = cfg.progressive_input.lower() == "residual"
        for i_level, res in enumerate(self.all_resolutions):
            for i_block in range(nrb):
                out_ch = nf * ch_mult[i_level]
                self._add(f"down_{i_level}_{i_block}", resblock(hs_c[-1], out_ch))
                if res in cfg.attn_resolutions:
                    self._add(f"down_attn_{i_level}_{i_block}", attnblock(out_ch))
                hs_c.append(out_ch)
            if i_level != len(ch_mult) - 1:
                self._add(f"downsample_{i_level}", resblock(hs_c[-1], down=True),
                          kind="downsample")
                if residual_input:
                    self._add(
                        f"pyramid_downsample_{i_level}",
                        Downsample(pyramid_ch, hs_c[-1], fir_kernel=cfg.fir_kernel, **kw),
                        kind="pyramid",
                    )
                    pyramid_ch = hs_c[-1]
                hs_c.append(hs_c[-1])

        # middle
        ch = hs_c[-1]
        self._add("mid_block1", resblock(ch))
        self._add("mid_attn", attnblock(ch))
        self._add("mid_block2", resblock(ch))

        # decoder
        for i_level in reversed(range(len(ch_mult))):
            for i_block in range(nrb + 1):
                out_ch = nf * ch_mult[i_level]
                self._add(f"up_{i_level}_{i_block}",
                          resblock(ch + hs_c.pop(), out_ch), kind="skip")
                ch = out_ch
            if self.all_resolutions[i_level] in cfg.attn_resolutions:
                self._add(f"up_attn_{i_level}", attnblock(ch))
            if i_level != 0:
                self._add(f"upsample_{i_level}", resblock(ch, up=True))
        assert not hs_c

        self.final_norm = AffineGroupNorm(_num_groups(ch), ch, **kw)
        self.final_conv = Conv3x3(ch, cfg.num_channels, init_scale=0.0, **kw)
        self.reset_parameters(generator)

    def _add(self, name: str, module: nn.Module, kind: str = "block") -> None:
        setattr(self, name, module)
        self._trunk.append((kind, name))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw the JAX package's initial distributions (CPU generator)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def kernel_launches_per_forward(self) -> Dict[str, int]:
        """K1/K2a/K2b launches one forward makes, from the module structure:
        every Conv3x3 module runs once, except the stems' per-stem convs,
        which run fused (G1: 2 launches, G2: 5)."""
        counts = {"conv3x3": 0, "fir_down2": 0, "fir_up2": 0}
        stem_roots = ["encoder_x", "pseudo_gap", *_GATES] + [
            n for n, _ in self.named_children()
            if n.startswith(("encoder_c", "feat_weight_c"))
        ]
        for name, m in self.named_modules():
            if isinstance(m, Conv3x3) and name.split(".")[0] not in stem_roots:
                counts["conv3x3"] += 1
            if isinstance(m, ResnetBlockBigGANppAdagn):
                for k, v in m.fir_launches().items():
                    counts[k] += v
        counts["conv3x3"] += 5 if self.adaptive else 2
        return counts

    def forward(self, x: torch.Tensor, cond1: torch.Tensor, cond2: torch.Tensor,
                cond3: torch.Tensor, time_cond: torch.Tensor, z: torch.Tensor,
                pseudo_target: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            raise _unsupported("train=True (dropout, kernel backward)")
        cfg = self.config
        dt = self.dtype
        act = F.silu

        zemb = self.z_transform(z)
        temb = None
        if cfg.conditional:
            temb = get_timestep_embedding(time_cond, cfg.num_channels_dae)
            temb = self.temb_dense1(act(self.temb_dense0(temb.to(dt))))

        if not cfg.centered:
            x = 2 * x - 1.0
        x = x.to(dt)
        conds = [cond1.to(dt), cond2.to(dt), cond3.to(dt)]
        input_pyramid = x

        if not self.adaptive:
            stems = [self.encoder_x] + [getattr(self, f"encoder_c{i + 1}")
                                        for i in range(len(conds))]
            h = fused_convfeat_apply(torch.cat([x] + conds, dim=-1), stems, act, dt)
        else:
            if pseudo_target is None:
                raise ValueError("G2 needs pseudo_target (G1's prediction)")
            pcs = [getattr(self, f"encoder_c{i + 1}") for i in range(len(conds))]
            x_feat, feats, _ = fused_adaptive_encode(
                x, conds, pseudo_target.to(dt), self.encoder_x, pcs,
                self.pseudo_gap, act, dt,
            )
            allc = torch.cat(feats, dim=-1)
            a1_12, a2_12, a1_23, a2_23, a1_31, a2_31 = fused_gate_convs(
                allc, [getattr(self, n) for n in _GATES], dt
            )
            c1, c2, c3 = feats
            c1_att, c2_att, c3_att = fused_weight_convs(
                [a1_12 * c1, a1_23 * c2, a1_31 * c3],
                [getattr(self, f"feat_weight_c{i + 1}") for i in range(3)], dt,
            )
            fused12 = a2_12 * c1_att + (1 - a2_12) * c2
            fused23 = a2_23 * c2_att + (1 - a2_23) * c3
            fused31 = a2_31 * c3_att + (1 - a2_31) * c1
            h = torch.cat([x_feat, fused12, fused23, fused31], dim=-1)

        hs = [h]
        for kind, name in self._trunk:
            m = getattr(self, name)
            if kind == "pyramid":
                input_pyramid = m(input_pyramid)
                if cfg.skip_rescale:
                    input_pyramid = ((input_pyramid + h).to(torch.float32)
                                     / _SQRT2).to(h.dtype)
                else:
                    input_pyramid = input_pyramid + h
                h = input_pyramid
                hs[-1] = h
                continue
            if name.startswith("downsample_"):
                h = m(hs[-1], temb, zemb)
                hs.append(h)
            elif kind == "skip":
                h = m(torch.cat([h, hs.pop()], dim=-1), temb, zemb)
            elif isinstance(m, AttnBlockpp):
                h = m(h)
                if name.startswith("down_attn"):
                    hs[-1] = h
            elif name.startswith("down_"):
                h = m(hs[-1], temb, zemb)
                hs.append(h)
            else:  # middle blocks, upsample blocks
                h = m(h, temb, zemb)
        assert not hs

        h = act(self.final_norm(h))
        h = self.final_conv(h)
        if not cfg.not_use_tanh:
            return torch.tanh(h.to(torch.float32))
        return h.to(torch.float32)
