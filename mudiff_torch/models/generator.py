"""Conditional NCSN++ AdaGN generators: G1 (contrast-specific) and G2
(``adaptive=True``, contrast-aware).

The port of ``mudiff_tpu/models/generator.py:136-601``, every branch of
it: the three resblock types (``"biggan"``, ``"biggan_oneadagn"``,
``"ddpm"``: with ddpm the levels change resolution through
``Downsample`` / ``Upsample`` modules, ``resamp_with_conv`` choosing
their conv), the output pyramid (``progressive`` ``"none"`` |
``"output_skip"`` | ``"residual"``; with ``"output_skip"`` the pyramid is
the output and there is no ``final_norm`` / ``final_conv``), the input
pyramid (``progressive_input`` ``"none"`` | ``"input_skip"``, through
``Combine`` with ``progressive_combine`` ``"cat"`` or ``"sum"`` |
``"residual"``), the positional or Fourier time embedding (the Fourier
one embeds ``log(t)``: NaN in every lane at t = 0, as in the JAX package
and the reference), FIR or naive resampling (``fir``), any number of
image channels, and three or two conditions (``num_conditions=2``: the
two-condition variant with its single pairwise fusion ``fuse2``).

G1 encodes x_t and the conditions with ConvFeatBlock stems; G2 embeds
G1's prediction to a 256-d style (always 256, whatever ``z_emb_dim``:
``generator.py:333-336``), encodes the conditions with style-modulated
stems and fuses them with pairwise gates.  With one-channel images the
stems run fused (``nn/fused_stems.py``; G1 two conv launches and one K5
call, G2 three and three), else
one module each; the gates run fused at any channel count.  Then the
UNet: resblocks, the pyramids, Res-Attn-Res middle, skip-concat decoder,
and a float32 tanh head.

Submodules carry the JAX package's names, so ``convert.py`` maps a flax
tree onto ``state_dict`` keys by rule.

Under ``config.use_int8`` and outside training mode, the forward runs in
an ``int8_scope`` (``mudiff_tpu/models/generator.py:93-130``): every
stride-1 conv that ``int8_conv_routed`` admits at the generator's
threshold runs kernel K4 (W8A8), with dynamic per-example scales or,
given an ``Int8Calib``, the calibration's static scales, site by site in
forward order.

With ``config.use_grad_checkpoint`` (training) the forward recomputes
regions in the backward instead of keeping their activations
(``mudiff_tpu/models/generator.py:195-245``, ``nn/remat.py``): under
``grad_checkpoint_policy`` ``"blocks"`` (or any string that is not
``"hires..."``) every resblock and attention block; under ``"hiresN"``
those at resolution >= image_size / N (``"hires"``: N = 2).  The ddpm
resample modules and the pyramids are never rematted.  The
full-resolution regions outside the blocks are rematted under every
policy: the fused stems of G1 and G2 (one-channel images only) and G2's
gate fusion (``:297-303, :353-357, :415-441``).  ``remat_regions`` names
them.

Dropout (``config.dropout > 0``) runs in training mode when the forward
is given ``dropout_seeds``, one per resblock in forward order
(``resblock_count``), as the training steps do; otherwise the forward is
deterministic, as flax's ``train=False``.  On a mesh ``dropout_rows`` =
(global batch, this rank's first row) draws each mask for the global
batch (``nn/blocks.py`` ``dropout_keep``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mudiff_torch.config import MuDiffConfig
from mudiff_torch.nn.blocks import (
    RESBLOCKS,
    AdaptiveGroupNorm,
    AffineGroupNorm,
    AttnBlockpp,
    Combine,
    Downsample,
    GaussianFourierProjection,
    PlainGroupNorm,
    ResnetBlockBigGANppAdagn,
    ResnetBlockBigGANppAdagnOne,
    ResnetBlockDDPMppAdagn,
    Upsample,
    _num_groups,
)
from mudiff_torch.nn.fused_stems import (
    ConvBlock,
    ConvBlockGAP,
    ConvFeatBlock,
    fused_adaptive_encode,
    fused_convfeat_apply,
    fused_gate_convs,
    fused_weight_convs,
)
from mudiff_torch.nn import remat
from mudiff_torch.nn.initializers import default_init
from mudiff_torch.nn.layers import Conv3x3, Dense, get_timestep_embedding, pixel_norm
from mudiff_torch.ops import KERNEL_WRAPPERS
from mudiff_torch.ops.int8_conv import (
    Int8Calib,
    Int8WeightCache,
    int8_conv_routed,
    int8_scope,
    recording,
)
from mudiff_torch.utils.profiling import span

# the modules whose forward makes one K5 call: the norm modules, and the
# unfused stems with an inline norm
NORMS = (AffineGroupNorm, AdaptiveGroupNorm, PlainGroupNorm, ConvFeatBlock, ConvBlockGAP)

_SQRT2 = math.sqrt(2.0)
# the pairwise gates: three pairs with three conditions, one with two
_GATES = {3: ("feat_att1_c12", "feat_att2_c12", "feat_att1_c23",
              "feat_att2_c23", "feat_att1_c31", "feat_att2_c31"),
          2: ("feat_att1_c12", "feat_att2_c12")}

# Whether the fused stem conv2 runs int8 when neither a calibration nor
# the constructor says (``mudiff_tpu/nn/fused_stems.py:196-204``).
STEMS_INT8_DEFAULT = True


def _check_branches(cfg: MuDiffConfig, num_conditions: int) -> None:
    """The values the JAX generator asserts (``generator.py:157-159``)."""
    if cfg.progressive.lower() not in ("none", "output_skip", "residual"):
        raise ValueError(f"progressive={cfg.progressive!r}")
    if cfg.progressive_input.lower() not in ("none", "input_skip", "residual"):
        raise ValueError(f"progressive_input={cfg.progressive_input!r}")
    if cfg.embedding_type.lower() not in ("fourier", "positional"):
        raise ValueError(f"embedding_type={cfg.embedding_type!r}")
    if num_conditions not in (2, 3):
        raise ValueError(f"num_conditions={num_conditions}: 2 or 3")


def remat_cut(cfg: MuDiffConfig) -> Optional[int]:
    """The least resolution whose blocks are rematted (0: every block),
    or None without ``use_grad_checkpoint``
    (``mudiff_tpu/models/generator.py:195-207``)."""
    if not cfg.use_grad_checkpoint:
        return None
    policy = cfg.grad_checkpoint_policy
    if policy.startswith("hires"):
        return cfg.image_size // int(policy[5:] or "2")
    return 0


def resblock_count(cfg: MuDiffConfig) -> int:
    """Resblocks in one generator's forward: the dropout seeds it takes.
    The BigGAN types change resolution with resblocks too; ddpm does not."""
    levels, nrb = len(cfg.ch_mult), cfg.num_res_blocks
    resample = 0 if cfg.resblock_type.lower() == "ddpm" else 2 * (levels - 1)
    return levels * nrb + 2 + levels * (nrb + 1) + resample


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


def _skip_add(a: torch.Tensor, h: torch.Tensor, skip_rescale: bool) -> torch.Tensor:
    """A pyramid joining the trunk: ``(a + h) / sqrt(2)`` in float32 (a
    numpy float64 scalar in the JAX package), cast to h's dtype."""
    if skip_rescale:
        return ((a + h).to(torch.float32) / _SQRT2).to(h.dtype)
    return a + h


class NCSNppGenerator(nn.Module):
    """NCSN++ with AdaGN; ``adaptive=True`` gives G2.

    ``num_conditions`` is 3 (MU-Diff) or 2 (the two-condition variant:
    pass ``cond3=None``).  ``attn`` is the attention lowering
    (``"einsum"`` | ``"bf16"`` | ``"flash"``, ``nn/blocks.py``), ``dtype``
    the compute dtype (parameters stay float32).  Inputs are NHWC;
    ``forward(x, c1, c2, c3, t, z[, pseudo_target])`` returns the float32
    prediction of x_0.

    int8 serving (``config.use_int8``): ``int8_calib`` gives static
    scales (None: dynamic); ``int8_min_ch`` is the routing threshold
    (default ``max(64, 2 * nf)``; a calibration's own wins);
    ``int8_stems`` routes the fused stem conv2 (a calibration's recorded
    bit wins, then this argument, then ``STEMS_INT8_DEFAULT``).  All
    three are fixed here, so a calibration is recorded and served with
    the same routing.
    """

    def __init__(self, config: MuDiffConfig, adaptive: bool = False,
                 num_conditions: int = 3, attn: str = "einsum",
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None,
                 int8_calib: Optional[Int8Calib] = None,
                 int8_min_ch: Optional[int] = None,
                 int8_stems: Optional[bool] = None):
        super().__init__()
        cfg = config
        _check_branches(cfg, num_conditions)
        self.config = cfg
        self.adaptive = adaptive
        self.num_conditions = num_conditions
        self.dtype = dtype
        nf = cfg.num_channels_dae
        chans = cfg.num_channels
        self.resblock_type = cfg.resblock_type.lower()
        self.progressive = cfg.progressive.lower()
        self.progressive_input = cfg.progressive_input.lower()
        self.fourier = cfg.embedding_type.lower() == "fourier"
        self.fused_stems = chans == 1
        self.int8_calib = int8_calib
        if int8_calib is not None:
            self.int8_min_ch, self.int8_stems = int8_calib.min_ch, bool(int8_calib.stems)
        else:
            self.int8_min_ch = int8_min_ch or max(64, 2 * nf)
            self.int8_stems = STEMS_INT8_DEFAULT if int8_stems is None else bool(int8_stems)
        self._int8_caches = {"stems": Int8WeightCache() if self.int8_stems else None,
                             "gates": Int8WeightCache(), "weights": Int8WeightCache()}
        ch_mult = cfg.ch_mult
        nrb = cfg.num_res_blocks
        levels = len(ch_mult)
        self.all_resolutions = [cfg.image_size // (2 ** i) for i in range(levels)]
        kw = dict(dtype=dtype, device=device)
        temb_dim = nf * 4 if cfg.conditional else None
        fir = dict(fir=cfg.fir, fir_kernel=cfg.fir_kernel)

        def resblock(in_ch, out_ch=None, up=False, down=False):
            common = dict(temb_dim=temb_dim, zemb_dim=cfg.z_emb_dim,
                          skip_rescale=cfg.skip_rescale, init_scale=0.0,
                          dropout=cfg.dropout, **kw)
            if self.resblock_type == "ddpm":
                return ResnetBlockDDPMppAdagn(in_ch, out_ch, **common)
            cls = (ResnetBlockBigGANppAdagnOne if self.resblock_type == "biggan_oneadagn"
                   else ResnetBlockBigGANppAdagn)
            return cls(in_ch, out_ch, up=up, down=down, **fir, **common)

        def attnblock(ch):
            return AttnBlockpp(ch, skip_rescale=cfg.skip_rescale, init_scale=0.0,
                               attn=attn, **kw)

        self.z_transform = _ZTransform(cfg.nz, cfg.z_emb_dim, cfg.n_mlp, **kw)
        if self.fourier:
            self.fourier_emb = GaussianFourierProjection(nf, cfg.fourier_scale, device=device)
        if cfg.conditional:
            embed = 2 * nf if self.fourier else nf
            self.temb_dense0 = Dense(embed, nf * 4, kernel_init=default_init(), **kw)
            self.temb_dense1 = Dense(nf * 4, nf * 4, kernel_init=default_init(), **kw)

        # condition encoding
        self.encoder_x = ConvFeatBlock(nf, in_ch=chans, **kw)
        for i in range(num_conditions):
            stem = (ConvBlock(nf, style_dim=256, in_ch=chans, **kw) if adaptive
                    else ConvFeatBlock(nf, in_ch=chans, **kw))
            setattr(self, f"encoder_c{i + 1}", stem)
        if adaptive:
            self.pseudo_gap = ConvBlockGAP(nf, zemb_dim=256, in_ch=chans, **kw)
            self.gates = _GATES[num_conditions]
            for name in self.gates:
                setattr(self, name, Conv3x3(num_conditions * nf, nf, device=device))
            self.n_weights = 3 if num_conditions == 3 else 1
            for i in range(self.n_weights):
                setattr(self, f"feat_weight_c{i + 1}", Conv3x3(nf, nf, device=device))
            stem_ch = (num_conditions + 1) * nf if num_conditions == 3 else 2 * nf
        else:
            stem_ch = (num_conditions + 1) * nf

        # the UNet, built in forward order: _trunk lists (kind, name), kind
        # "block" for a resblock or attention block, "pyramid" for the
        # resample modules, the pyramids and their combiners; _res holds
        # each one's resolution, for the remat policy
        self._trunk: List[Tuple[str, str]] = []
        self._res: Dict[str, int] = {}
        hs_c = [stem_ch]
        pyr_ch = chans
        for i_level, res in enumerate(self.all_resolutions):
            for i_block in range(nrb):
                out_ch = nf * ch_mult[i_level]
                self._add(f"down_{i_level}_{i_block}", resblock(hs_c[-1], out_ch), res)
                if res in cfg.attn_resolutions:
                    self._add(f"down_attn_{i_level}_{i_block}", attnblock(out_ch), res)
                hs_c.append(out_ch)
            if i_level != levels - 1:
                ch = hs_c[-1]
                if self.resblock_type == "ddpm":
                    self._add(f"downsample_{i_level}",
                              Downsample(ch, with_conv=cfg.resamp_with_conv, **fir, **kw), res)
                else:
                    self._add(f"downsample_{i_level}", resblock(ch, down=True), res)
                if self.progressive_input == "input_skip":
                    self._add(f"pyramid_downsample_{i_level}",
                              Downsample(pyr_ch, with_conv=False, **fir, **kw), res)
                    self._add(f"combine_{i_level}",
                              Combine(pyr_ch, ch, method=cfg.progressive_combine.lower(),
                                      **kw), res)
                    if cfg.progressive_combine.lower() == "cat":
                        ch *= 2
                elif self.progressive_input == "residual":
                    self._add(f"pyramid_downsample_{i_level}",
                              Downsample(pyr_ch, ch, with_conv=True, **fir, **kw), res)
                    pyr_ch = ch
                hs_c.append(ch)

        ch = hs_c[-1]
        low = self.all_resolutions[-1]
        self._add("mid_block1", resblock(ch), low)
        self._add("mid_attn", attnblock(ch), low)
        self._add("mid_block2", resblock(ch), low)

        for i_level in reversed(range(levels)):
            res = self.all_resolutions[i_level]
            for i_block in range(nrb + 1):
                out_ch = nf * ch_mult[i_level]
                self._add(f"up_{i_level}_{i_block}", resblock(ch + hs_c.pop(), out_ch), res)
                ch = out_ch
            if res in cfg.attn_resolutions:
                self._add(f"up_attn_{i_level}", attnblock(ch), res)
            if self.progressive != "none":
                if i_level != levels - 1:
                    if self.progressive == "output_skip":
                        self._add(f"pyramid_upsample_nc_{i_level}",
                                  Upsample(pyr_ch, with_conv=False, **fir, **kw), res)
                    else:
                        self._add(f"pyramid_upsample_{i_level}",
                                  Upsample(pyr_ch, ch, with_conv=True, **fir, **kw), res)
                        pyr_ch = ch
                if self.progressive == "output_skip" or i_level == levels - 1:
                    self._add(f"pyramid_norm_{i_level}",
                              AffineGroupNorm(_num_groups(ch), ch, **kw), res)
                    skip = self.progressive == "output_skip"
                    self._add(f"pyramid_conv_{i_level}",
                              Conv3x3(ch, chans if skip else ch,
                                      init_scale=0.0 if skip else 1.0, **kw), res)
                    pyr_ch = chans if skip else ch
            if i_level != 0:
                if self.resblock_type == "ddpm":
                    self._add(f"upsample_{i_level}",
                              Upsample(ch, with_conv=cfg.resamp_with_conv, **fir, **kw), res)
                else:
                    self._add(f"upsample_{i_level}", resblock(ch, up=True), res)
        assert not hs_c

        if self.progressive != "output_skip":
            self.final_norm = AffineGroupNorm(_num_groups(ch), ch, **kw)
            self.final_conv = Conv3x3(ch, chans, init_scale=0.0, **kw)

        # remat: the resblocks and attention blocks the policy selects, and
        # the full-resolution regions outside the blocks
        self._resblocks = [n for _, n in self._trunk if isinstance(getattr(self, n), RESBLOCKS)]
        assert len(self._resblocks) == resblock_count(cfg)
        cut = remat_cut(cfg)
        self.remat_regions = set()
        if cut is not None:
            self.remat_regions = {n for kind, n in self._trunk
                                  if kind == "block" and self._res[n] >= cut}
            if self.fused_stems:
                self.remat_regions.add("encode" if adaptive else "stems")
            if adaptive:
                self.remat_regions.add("fuse")
        self.reset_parameters(generator)

    def _add(self, name: str, module: nn.Module, res: int) -> None:
        setattr(self, name, module)
        kind = "block" if isinstance(module, (*RESBLOCKS, AttnBlockpp)) else "pyramid"
        self._trunk.append((kind, name))
        self._res[name] = res

    def _region(self, name: str, fn, *args):
        """``fn(*args)`` under the span ``name``, rematted when ``name`` is
        in ``remat_regions``."""
        with span(name):
            if name in self.remat_regions:
                return remat.checkpointed(name, fn, *args)
            return fn(*args)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw the JAX package's initial distributions (CPU generator)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def int8_serving(self) -> bool:
        """Whether a forward now runs the routed convs on K4."""
        return self.config.use_int8 and not self.training

    def _stems(self) -> List[nn.Module]:
        """The stem modules in the order a forward runs them."""
        conds = [getattr(self, f"encoder_c{i + 1}") for i in range(self.num_conditions)]
        return ([self.pseudo_gap] if self.adaptive else []) + [self.encoder_x] + conds

    def int8_sites(self) -> List[Tuple[int, int]]:
        """The (cin, cout) of every conv a forward routes to K4, in forward
        order: the list a calibration must hold (empty unless serving int8)."""
        if not self.int8_serving():
            return []

        def routed(cin, cout):
            return [(cin, cout)] if int8_conv_routed(cin, cout, self.int8_min_ch) else []

        def convs(module):
            return [s for m in module.modules() if isinstance(m, Conv3x3) and m.on_kernels
                    for s in routed(m.in_ch, m.out_ch)]

        nf = self.config.num_channels_dae
        n = self.num_conditions
        sites = []
        if self.fused_stems:
            # x and the conditions (G2's pseudo-GAP stem stays on K1)
            sites += routed((n + 1) * nf, (n + 1) * nf) if self.int8_stems else []
        else:
            for m in self._stems():
                sites += convs(m)
        if self.adaptive:
            sites += routed(n * nf, len(self.gates) * nf)
            sites += routed(self.n_weights * nf, self.n_weights * nf)
        for _, name in self._trunk:
            sites += convs(getattr(self, name))
        return sites + (convs(self.final_conv) if hasattr(self, "final_conv") else [])

    def kernel_launches_per_forward(self) -> Dict[str, int]:
        """Kernel launches one forward makes, from the module structure:
        every stride-1 Conv3x3 module runs one conv, except those of the
        fused stems (G1: 2 launches, G2: 3) and G2's gates (2); the convs
        of ``int8_sites`` run K4 and the rest K1; every FIR resample
        without a conv (resblocks, pyramids, ddpm resamples) one K2a or
        K2b; every AttnBlockpp in ``flash`` mode K3 once; every norm
        module, and the inline norm of an unfused ``ConvFeatBlock`` or
        ``ConvBlockGAP``, K5 once (the fused stems G1 once, G2 thrice).
        Every wrapper of ``ops.KERNEL_WRAPPERS`` has a key (the backward
        kernels 0)."""
        counts = dict.fromkeys(KERNEL_WRAPPERS, 0)
        fused = [m for m in self._stems() if self.fused_stems]
        if self.adaptive:
            fused += [getattr(self, n) for n in self.gates]
            fused += [getattr(self, f"feat_weight_c{i + 1}") for i in range(self.n_weights)]
        skip = {id(c) for m in fused for c in m.modules()}
        for m in self.modules():
            if isinstance(m, Conv3x3) and m.on_kernels and id(m) not in skip:
                counts["conv3x3"] += 1
            if hasattr(m, "fir_launches"):
                for k, v in m.fir_launches().items():
                    counts[k] += v
            if isinstance(m, AttnBlockpp) and m.attn == "flash":
                counts["flash_attn"] += 1
            if isinstance(m, NORMS) and id(m) not in skip:
                counts["group_norm_act"] += 1
        if self.fused_stems:
            counts["conv3x3"] += 3 if self.adaptive else 2
            counts["group_norm_act"] += 3 if self.adaptive else 1
        if self.adaptive:
            counts["conv3x3"] += 2
        counts["int8_conv3x3"] = len(self.int8_sites())
        counts["conv3x3"] -= counts["int8_conv3x3"]
        return counts

    def launches_off_the_gradient(self) -> Dict[str, int]:
        """The launches of ``kernel_launches_per_forward`` whose input needs
        no gradient when x and the conditions need none (G2's
        ``pseudo_target`` does), so that a backward transposes none of
        them: the first stem convs of x and the conditions (G1's fused
        conv1 is one launch; G2's fused conv1 also takes the pseudo target),
        and the input_skip pyramid's K2a downsamples of x."""
        counts = dict.fromkeys(KERNEL_WRAPPERS, 0)
        if self.fused_stems:
            counts["conv3x3"] = 0 if self.adaptive else 1
        else:
            counts["conv3x3"] = 1 + self.num_conditions
        if self.progressive_input == "input_skip":
            counts["fir_down2"] = sum(getattr(self, n).fir_launches()["fir_down2"]
                                      for _, n in self._trunk
                                      if n.startswith("pyramid_downsample_"))
        return counts

    def forward(self, x: torch.Tensor, cond1: torch.Tensor, cond2: torch.Tensor,
                cond3: Optional[torch.Tensor], time_cond: torch.Tensor, z: torch.Tensor,
                pseudo_target: Optional[torch.Tensor] = None,
                dropout_seeds: Optional[Sequence[int]] = None,
                dropout_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if (cond3 is None) != (self.num_conditions == 2):
            raise ValueError("pass cond3 iff num_conditions == 3")
        seeds = {}
        if self.training and dropout_seeds is not None and self.config.dropout > 0:
            if len(dropout_seeds) != len(self._resblocks):
                raise ValueError(f"{len(dropout_seeds)} dropout seeds for "
                                 f"{len(self._resblocks)} resblocks")
            rows = tuple(dropout_rows) if dropout_rows is not None else ()
            seeds = dict(zip(self._resblocks,
                             ((int(s), *rows) if rows else int(s) for s in dropout_seeds)))
        # The scope covers the whole forward; in training mode it is off
        # (int8 is inference only: no straight-through estimator).
        with span("g2" if self.adaptive else "g1"), \
                int8_scope(self.int8_serving(), min_ch=self.int8_min_ch,
                           calib=self.int8_calib) as scope:
            out = self._forward(x, cond1, cond2, cond3, time_cond, z, pseudo_target, seeds)
        if scope.enabled and not recording():
            scope.check_consumed()
        return out

    def _encode(self, x, conds, pseudo_target, caches):
        """The condition encoding: the trunk's first activation."""
        dt = self.dtype
        if not self.adaptive:
            stems = self._stems()
            if not self.fused_stems:
                with span("stems"):
                    return torch.cat([m(img) for m, img in zip(stems, [x] + conds)], dim=-1)
            return self._region(
                "stems", lambda s: fused_convfeat_apply(s, stems, dt, caches["stems"]),
                torch.cat([x] + conds, dim=-1))
        if pseudo_target is None:
            raise ValueError("G2 needs pseudo_target (G1's prediction)")
        pcs = [getattr(self, f"encoder_c{i + 1}") for i in range(len(conds))]
        pseudo = pseudo_target.to(dt)
        if self.fused_stems:
            def encode(x_, pseudo_, *cs):
                x_feat, feats, _ = fused_adaptive_encode(
                    x_, list(cs), pseudo_, self.encoder_x, pcs, self.pseudo_gap,
                    dt, caches["stems"])
                return (x_feat, *feats)

            x_feat, *feats = self._region("encode", encode, x, pseudo, *conds)
        else:
            with span("encode"):
                style = self.pseudo_gap(pseudo)
                x_feat = self.encoder_x(x)
                feats = [m(c, style) for m, c in zip(pcs, conds)]
        allc = torch.cat(feats, dim=-1)
        gates = [getattr(self, n) for n in self.gates]
        weights = [getattr(self, f"feat_weight_c{i + 1}") for i in range(self.n_weights)]

        def fuse3(allc_, c1, c2, c3, x_feat_):
            a1_12, a2_12, a1_23, a2_23, a1_31, a2_31 = fused_gate_convs(
                allc_, gates, dt, caches["gates"])
            c1_att, c2_att, c3_att = fused_weight_convs(
                [a1_12 * c1, a1_23 * c2, a1_31 * c3], weights, dt, caches["weights"])
            fused12 = a2_12 * c1_att + (1 - a2_12) * c2
            fused23 = a2_23 * c2_att + (1 - a2_23) * c3
            fused31 = a2_31 * c3_att + (1 - a2_31) * c1
            return torch.cat([x_feat_, fused12, fused23, fused31], dim=-1)

        def fuse2(allc_, c1, c2, x_feat_):
            a1_12, a2_12 = fused_gate_convs(allc_, gates, dt, caches["gates"])
            (c1_att,) = fused_weight_convs([a1_12 * c1], weights, dt, caches["weights"])
            return torch.cat([x_feat_, a2_12 * c1_att + (1 - a2_12) * c2], dim=-1)

        fuse = fuse3 if self.num_conditions == 3 else fuse2
        return self._region("fuse", fuse, allc, *feats, x_feat)

    def _pyramid_head(self, i_level: int, h: torch.Tensor) -> torch.Tensor:
        norm = getattr(self, f"pyramid_norm_{i_level}")
        return getattr(self, f"pyramid_conv_{i_level}")(norm(h, silu=True))

    def _block(self, name, h, temb, zemb, seeds):
        return self._region(name, getattr(self, name), h, temb, zemb, seeds.get(name))

    def _forward(self, x, cond1, cond2, cond3, time_cond, z, pseudo_target, seeds):
        cfg = self.config
        dt = self.dtype
        act = F.silu
        levels = len(cfg.ch_mult)
        attn_res = cfg.attn_resolutions
        # the int8 weight caches are serving state: a training forward (and
        # its recompute) never reads or fills them
        caches = dict.fromkeys(self._int8_caches) if self.training else self._int8_caches

        with span("temb"):
            zemb = self.z_transform(z)
            temb = None
            if cfg.conditional:
                if self.fourier:
                    temb = self.fourier_emb(torch.log(time_cond.to(torch.float32)))
                else:
                    temb = get_timestep_embedding(time_cond, cfg.num_channels_dae)
                temb = self.temb_dense1(act(self.temb_dense0(temb.to(dt))))

        if not cfg.centered:
            x = 2 * x - 1.0
        x = x.to(dt)
        conds = [c.to(dt) for c in (cond1, cond2, cond3)[:self.num_conditions]]
        input_pyramid = x

        hs = [self._encode(x, conds, pseudo_target, caches)]
        for i_level in range(levels):
            res = self.all_resolutions[i_level]
            for i_block in range(cfg.num_res_blocks):
                h = self._block(f"down_{i_level}_{i_block}", hs[-1], temb, zemb, seeds)
                if res in attn_res:
                    name = f"down_attn_{i_level}_{i_block}"
                    h = self._region(name, getattr(self, name), h)
                hs.append(h)
            if i_level != levels - 1:
                name = f"downsample_{i_level}"
                if self.resblock_type == "ddpm":  # a pyramid-kind module: never rematted
                    h = self._region(name, getattr(self, name), hs[-1])
                else:
                    h = self._block(name, hs[-1], temb, zemb, seeds)
                if self.progressive_input != "none":
                    with span("pyramid"):
                        input_pyramid = getattr(self, f"pyramid_downsample_{i_level}")(
                            input_pyramid)
                        if self.progressive_input == "input_skip":
                            h = getattr(self, f"combine_{i_level}")(input_pyramid, h)
                        else:
                            input_pyramid = _skip_add(input_pyramid, h, cfg.skip_rescale)
                            h = input_pyramid
                hs.append(h)

        h = hs[-1]
        h = self._block("mid_block1", h, temb, zemb, seeds)
        h = self._region("mid_attn", self.mid_attn, h)
        h = self._block("mid_block2", h, temb, zemb, seeds)

        pyramid = None
        for i_level in reversed(range(levels)):
            for i_block in range(cfg.num_res_blocks + 1):
                h = self._block(f"up_{i_level}_{i_block}", torch.cat([h, hs.pop()], dim=-1),
                                temb, zemb, seeds)
            if self.all_resolutions[i_level] in attn_res:
                name = f"up_attn_{i_level}"
                h = self._region(name, getattr(self, name), h)
            if self.progressive != "none":
                with span("pyramid"):
                    if i_level == levels - 1:
                        pyramid = self._pyramid_head(i_level, h)
                    elif self.progressive == "output_skip":
                        pyramid = getattr(self, f"pyramid_upsample_nc_{i_level}")(pyramid)
                        pyramid = pyramid + self._pyramid_head(i_level, h)
                    else:
                        pyramid = getattr(self, f"pyramid_upsample_{i_level}")(pyramid)
                        pyramid = _skip_add(pyramid, h, cfg.skip_rescale)
                        h = pyramid
            if i_level != 0:
                name = f"upsample_{i_level}"
                if self.resblock_type == "ddpm":  # a pyramid-kind module: never rematted
                    h = self._region(name, getattr(self, name), h)
                else:
                    h = self._block(name, h, temb, zemb, seeds)
        assert not hs

        with span("head"):
            if self.progressive == "output_skip":
                h = pyramid
            else:
                h = self.final_conv(self.final_norm(h, silu=True))
            if not cfg.not_use_tanh:
                return torch.tanh(h.to(torch.float32))
            return h.to(torch.float32)
