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

Under ``config.use_int8`` and outside training mode, the forward runs in
an ``int8_scope`` (``mudiff_tpu/models/generator.py:93-130``): every
conv that ``int8_conv_routed`` admits at the generator's threshold runs
kernel K4 (W8A8), with dynamic per-example scales or, given an
``Int8Calib``, the calibration's static scales, site by site in forward
order.

With ``config.use_grad_checkpoint`` (training) the forward recomputes
regions in the backward instead of keeping their activations
(``mudiff_tpu/models/generator.py:195-245``, ``nn/remat.py``): under
``grad_checkpoint_policy`` ``"blocks"`` (or any string that is not
``"hires..."``) every resblock and attention block; under ``"hiresN"``
those at resolution >= image_size / N (``"hires"``: N = 2).  The
full-resolution regions outside the blocks are rematted under every
policy: G1's fused stems, G2's adaptive encode and its gate fusion
(``:299-303, :353-357, :415-419``).  ``remat_regions`` names them.

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

_SQRT2 = math.sqrt(2.0)
_GATES = ("feat_att1_c12", "feat_att2_c12", "feat_att1_c23",
          "feat_att2_c23", "feat_att1_c31", "feat_att2_c31")

# Whether the fused stem conv2 runs int8 when neither a calibration nor
# the constructor says (``mudiff_tpu/nn/fused_stems.py:196-204``).
STEMS_INT8_DEFAULT = True


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
    if not cfg.fir:
        raise _unsupported("fir=False resampling")


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
    """Resblocks in one generator's forward: the dropout seeds it takes."""
    levels, nrb = len(cfg.ch_mult), cfg.num_res_blocks
    return levels * nrb + (levels - 1) + 2 + levels * (nrb + 1) + (levels - 1)


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

    ``attn`` is the attention lowering (``"einsum"`` | ``"bf16"`` |
    ``"flash"``, ``nn/blocks.py``),
    ``dtype`` the compute dtype (parameters stay float32).  Inputs are
    NHWC; ``forward(x, c1, c2, c3, t, z[, pseudo_target])`` returns the
    float32 prediction of x_0.

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
        _check_config(cfg, num_conditions)
        self.config = cfg
        self.adaptive = adaptive
        self.dtype = dtype
        nf = cfg.num_channels_dae
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
        self.all_resolutions = [cfg.image_size // (2 ** i) for i in range(len(ch_mult))]
        kw = dict(dtype=dtype, device=device)
        temb_dim = nf * 4 if cfg.conditional else None

        def resblock(in_ch, out_ch=None, up=False, down=False):
            return ResnetBlockBigGANppAdagn(
                in_ch, out_ch, temb_dim=temb_dim, zemb_dim=cfg.z_emb_dim,
                up=up, down=down, fir_kernel=cfg.fir_kernel,
                skip_rescale=cfg.skip_rescale, init_scale=0.0, dropout=cfg.dropout, **kw,
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
        self._res: Dict[str, int] = {}  # a block's resolution, for the remat policy
        hs_c = [4 * nf]
        pyramid_ch = cfg.num_channels
        residual_input = cfg.progressive_input.lower() == "residual"
        for i_level, res in enumerate(self.all_resolutions):
            for i_block in range(nrb):
                out_ch = nf * ch_mult[i_level]
                self._add(f"down_{i_level}_{i_block}", resblock(hs_c[-1], out_ch), res=res)
                if res in cfg.attn_resolutions:
                    self._add(f"down_attn_{i_level}_{i_block}", attnblock(out_ch), res=res)
                hs_c.append(out_ch)
            if i_level != len(ch_mult) - 1:
                self._add(f"downsample_{i_level}", resblock(hs_c[-1], down=True),
                          kind="downsample", res=res)
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
                          resblock(ch + hs_c.pop(), out_ch), kind="skip",
                          res=self.all_resolutions[i_level])
                ch = out_ch
            if self.all_resolutions[i_level] in cfg.attn_resolutions:
                self._add(f"up_attn_{i_level}", attnblock(ch),
                          res=self.all_resolutions[i_level])
            if i_level != 0:
                self._add(f"upsample_{i_level}", resblock(ch, up=True),
                          res=self.all_resolutions[i_level])
        assert not hs_c

        # remat: the blocks the policy selects (the middle ones sit at the
        # lowest resolution; the pyramid convs are never rematted), and the
        # full-resolution regions outside the blocks
        cut = remat_cut(cfg)
        self.remat_regions = set()
        if cut is not None:
            self.remat_regions = {name for kind, name in self._trunk
                                  if kind != "pyramid" and self._res[name] >= cut}
            self.remat_regions |= {"encode", "fuse"} if adaptive else {"stems"}
        self._resblocks = [name for _, name in self._trunk
                           if isinstance(getattr(self, name), ResnetBlockBigGANppAdagn)]
        assert len(self._resblocks) == resblock_count(cfg)

        self.final_norm = AffineGroupNorm(_num_groups(ch), ch, **kw)
        self.final_conv = Conv3x3(ch, cfg.num_channels, init_scale=0.0, **kw)
        self.reset_parameters(generator)

    def _add(self, name: str, module: nn.Module, kind: str = "block",
             res: Optional[int] = None) -> None:
        setattr(self, name, module)
        self._trunk.append((kind, name))
        self._res[name] = self.all_resolutions[-1] if res is None else res

    def _region(self, name: str, fn, *args):
        """``fn(*args)``, rematted when ``name`` is in ``remat_regions``."""
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

    def int8_sites(self) -> List[Tuple[int, int]]:
        """The (cin, cout) of every conv a forward routes to K4, in forward
        order: the list a calibration must hold (empty unless serving int8)."""
        if not self.int8_serving():
            return []

        def routed(cin, cout):
            return [(cin, cout)] if int8_conv_routed(cin, cout, self.int8_min_ch) else []

        nf = self.config.num_channels_dae
        n_stems = 4  # x and three conditions (G2's pseudo-GAP stem stays on K1)
        sites = routed(n_stems * nf, n_stems * nf) if self.int8_stems else []
        if self.adaptive:
            sites += routed(3 * nf, len(_GATES) * nf) + routed(3 * nf, 3 * nf)
        for _, name in self._trunk:
            for m in getattr(self, name).modules():
                if isinstance(m, Conv3x3):
                    sites += routed(m.in_ch, m.out_ch)
        return sites + routed(self.final_conv.in_ch, self.final_conv.out_ch)

    def kernel_launches_per_forward(self) -> Dict[str, int]:
        """Kernel launches one forward makes, from the module structure:
        every Conv3x3 module runs one conv, except the stems' per-stem
        convs, which run fused (G1: 2 launches, G2: 5); the convs of
        ``int8_sites`` run K4 and the rest K1; every AttnBlockpp in
        ``flash`` mode runs K3 once.  Every wrapper of
        ``ops.KERNEL_WRAPPERS`` has a key (the backward kernels 0)."""
        counts = dict.fromkeys(KERNEL_WRAPPERS, 0)
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
            if isinstance(m, AttnBlockpp) and m.attn == "flash":
                counts["flash_attn"] += 1
        counts["conv3x3"] += 5 if self.adaptive else 2
        counts["int8_conv3x3"] = len(self.int8_sites())
        counts["conv3x3"] -= counts["int8_conv3x3"]
        return counts

    def forward(self, x: torch.Tensor, cond1: torch.Tensor, cond2: torch.Tensor,
                cond3: torch.Tensor, time_cond: torch.Tensor, z: torch.Tensor,
                pseudo_target: Optional[torch.Tensor] = None,
                dropout_seeds: Optional[Sequence[int]] = None,
                dropout_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
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
        with int8_scope(self.int8_serving(), min_ch=self.int8_min_ch,
                        calib=self.int8_calib) as scope:
            out = self._forward(x, cond1, cond2, cond3, time_cond, z, pseudo_target, seeds)
        if scope.enabled and not recording():
            scope.check_consumed()
        return out

    def _forward(self, x, cond1, cond2, cond3, time_cond, z, pseudo_target, seeds):
        cfg = self.config
        dt = self.dtype
        act = F.silu
        # the int8 weight caches are serving state: a training forward (and
        # its recompute) never reads or fills them
        caches = dict.fromkeys(self._int8_caches) if self.training else self._int8_caches

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
            h = self._region(
                "stems", lambda s: fused_convfeat_apply(s, stems, act, dt, caches["stems"]),
                torch.cat([x] + conds, dim=-1))
        else:
            if pseudo_target is None:
                raise ValueError("G2 needs pseudo_target (G1's prediction)")
            pcs = [getattr(self, f"encoder_c{i + 1}") for i in range(len(conds))]

            def encode(x_, c1, c2, c3, pseudo):
                x_feat, feats, _ = fused_adaptive_encode(
                    x_, [c1, c2, c3], pseudo, self.encoder_x, pcs, self.pseudo_gap,
                    act, dt, caches["stems"])
                return (x_feat, *feats)

            def fuse3(allc, c1, c2, c3, x_feat):
                a1_12, a2_12, a1_23, a2_23, a1_31, a2_31 = fused_gate_convs(
                    allc, [getattr(self, n) for n in _GATES], dt, caches["gates"])
                c1_att, c2_att, c3_att = fused_weight_convs(
                    [a1_12 * c1, a1_23 * c2, a1_31 * c3],
                    [getattr(self, f"feat_weight_c{i + 1}") for i in range(3)], dt,
                    caches["weights"])
                fused12 = a2_12 * c1_att + (1 - a2_12) * c2
                fused23 = a2_23 * c2_att + (1 - a2_23) * c3
                fused31 = a2_31 * c3_att + (1 - a2_31) * c1
                return torch.cat([x_feat, fused12, fused23, fused31], dim=-1)

            x_feat, *feats = self._region("encode", encode, x, *conds, pseudo_target.to(dt))
            allc = torch.cat(feats, dim=-1)
            h = self._region("fuse", fuse3, allc, *feats, x_feat)

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
            if isinstance(m, AttnBlockpp):
                h = self._region(name, m, h)
                if name.startswith("down_attn"):
                    hs[-1] = h
                continue
            if kind == "skip":
                x_in = torch.cat([h, hs.pop()], dim=-1)
            elif name.startswith("down"):  # down_* and downsample_*
                x_in = hs[-1]
            else:  # middle blocks, upsample blocks
                x_in = h
            h = self._region(name, m, x_in, temb, zemb, seeds.get(name))
            if name.startswith("down"):
                hs.append(h)
        assert not hs

        h = act(self.final_norm(h))
        h = self.final_conv(h)
        if not cfg.not_use_tanh:
            return torch.tanh(h.to(torch.float32))
        return h.to(torch.float32)
