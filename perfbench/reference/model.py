"""The MU-Diff networks written out in plain PyTorch: G1 and G2 (NCSN++
with AdaGN, the BigGAN resblock, a residual input pyramid, positional
time embedding, FIR resampling, one-channel images, three conditions)
and the large time-conditional critic.

Parameters are a flat dict of float32 tensors under the names that
``param_specs`` lists; the forward functions read them by name.  The
names are the ones the port's modules use for their ``state_dict``, so
the benchmark can load one set of seeded weights into both sides.  The
condition stems and G2's gates are written in their stacked form (one
conv over the concatenated stems, block-diagonal where the stems do not
mix): the same function as one conv a stem, and the form in which the
int8 serving rule sees them as one conv.

Only the recipe's branch is written out; ``check_config`` refuses any
other.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from perfbench.reference.ops import (
    conv_down2,
    fir_down2,
    fir_taps,
    fir_up2,
    group_norm,
    num_groups,
    timestep_embedding,
)

SQRT2 = math.sqrt(2.0)
Params = Dict[str, torch.Tensor]

_BRANCH = {"resblock_type": "biggan", "progressive": "none",
           "progressive_input": "residual", "embedding_type": "positional",
           "fir": True, "num_channels": 1, "conditional": True, "centered": True,
           "skip_rescale": True, "not_use_tanh": False, "resamp_with_conv": True,
           "dropout": 0.0}
_GATES = ("feat_att1_c12", "feat_att2_c12", "feat_att1_c23", "feat_att2_c23",
          "feat_att1_c31", "feat_att2_c31")


def check_config(cfg: dict) -> None:
    """Raise unless ``cfg`` is the recipe's branch, which is all the
    reference writes out."""
    for k, v in _BRANCH.items():
        if cfg[k] != v:
            raise ValueError(f"the reference covers {k}={v!r}, not {cfg[k]!r}")


def resolutions(cfg: dict) -> List[int]:
    return [cfg["image_size"] // (2 ** i) for i in range(len(cfg["ch_mult"]))]


# ------------------------------------------------------------ parameter specs

def _conv3(specs, name, cin, cout):
    specs[f"{name}.weight"] = (3, 3, cin, cout)
    specs[f"{name}.bias"] = (cout,)


def _dense(specs, name, cin, cout, bias=True):
    specs[f"{name}.weight"] = (cout, cin)
    if bias:
        specs[f"{name}.bias"] = (cout,)


def _resblock_specs(specs, name, cin, cout, temb_dim, zdim, resample):
    _dense(specs, f"{name}.GroupNorm_0.style", zdim, 2 * cin)
    _conv3(specs, f"{name}.Conv_0", cin, cout)
    _dense(specs, f"{name}.Dense_0", temb_dim, cout)
    _dense(specs, f"{name}.GroupNorm_1.style", zdim, 2 * cout)
    _conv3(specs, f"{name}.Conv_1", cout, cout)
    if cin != cout or resample:
        _dense(specs, f"{name}.Conv_2", cin, cout)


def _trunk(cfg: dict):
    """The UNet in forward order: (kind, name, cin, cout, res) with kind
    ``res`` (a resblock), ``down`` / ``up`` (a resampling resblock),
    ``pyr`` (the input pyramid's FIR conv), ``attn``."""
    nf, mult, nrb = cfg["num_channels_dae"], cfg["ch_mult"], cfg["num_res_blocks"]
    res_list = resolutions(cfg)
    levels = len(mult)
    out = []
    hs_c = [4 * nf]
    pyr_ch = 1
    for lvl, res in enumerate(res_list):
        for blk in range(nrb):
            oc = nf * mult[lvl]
            out.append(("res", f"down_{lvl}_{blk}", hs_c[-1], oc, res))
            if res in cfg["attn_resolutions"]:
                out.append(("attn", f"down_attn_{lvl}_{blk}", oc, oc, res))
            hs_c.append(oc)
        if lvl != levels - 1:
            ch = hs_c[-1]
            out.append(("down", f"downsample_{lvl}", ch, ch, res))
            out.append(("pyr", f"pyramid_downsample_{lvl}", pyr_ch, ch, res))
            pyr_ch = ch
            hs_c.append(ch)
    ch = hs_c[-1]
    low = res_list[-1]
    out += [("res", "mid_block1", ch, ch, low), ("attn", "mid_attn", ch, ch, low),
            ("res", "mid_block2", ch, ch, low)]
    for lvl in reversed(range(levels)):
        res = res_list[lvl]
        for blk in range(nrb + 1):
            oc = nf * mult[lvl]
            out.append(("res", f"up_{lvl}_{blk}", ch + hs_c.pop(), oc, res))
            ch = oc
        if res in cfg["attn_resolutions"]:
            out.append(("attn", f"up_attn_{lvl}", ch, ch, res))
        if lvl != 0:
            out.append(("up", f"upsample_{lvl}", ch, ch, res))
    assert not hs_c
    return out, ch


def generator_specs(cfg: dict, adaptive: bool) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of G1's (``adaptive=False``) or G2's parameters."""
    check_config(cfg)
    nf = cfg["num_channels_dae"]
    zdim, temb = cfg["z_emb_dim"], 4 * nf
    specs: Dict[str, Tuple[int, ...]] = {}
    _dense(specs, "z_transform.fc0", cfg["nz"], zdim)
    for i in range(cfg["n_mlp"]):
        _dense(specs, f"z_transform.fc{i + 1}", zdim, zdim)
    _dense(specs, "temb_dense0", nf, temb)
    _dense(specs, "temb_dense1", temb, temb)
    for stem in ["encoder_x"] + [f"encoder_c{i}" for i in (1, 2, 3)]:
        _conv3(specs, f"{stem}.conv1", 1, nf)
        if adaptive and stem != "encoder_x":
            _dense(specs, f"{stem}.group_norm.style", 256, 2 * nf)
        _conv3(specs, f"{stem}.conv2", nf, nf)
    if adaptive:
        _conv3(specs, "pseudo_gap.conv1", 1, nf)
        _conv3(specs, "pseudo_gap.conv2", nf, nf)
        _dense(specs, "pseudo_gap.fc", nf, 256)
        for g in _GATES:
            _conv3(specs, g, 3 * nf, nf)
        for i in (1, 2, 3):
            _conv3(specs, f"feat_weight_c{i}", nf, nf)
    trunk, ch = _trunk(cfg)
    for kind, name, cin, cout, _ in trunk:
        if kind in ("res", "down", "up"):
            _resblock_specs(specs, name, cin, cout, temb, zdim, kind != "res")
        elif kind == "pyr":
            _conv3(specs, f"{name}.Conv2d_0", cin, cout)
        else:
            specs[f"{name}.GroupNorm_0.weight"] = (cin,)
            specs[f"{name}.GroupNorm_0.bias"] = (cin,)
            for i in range(4):
                _dense(specs, f"{name}.NIN_{i}", cin, cin)
    specs["final_norm.weight"] = (ch,)
    specs["final_norm.bias"] = (ch,)
    _conv3(specs, "final_conv", ch, 1)
    return specs


def critic_blocks(ngf: int) -> List[int]:
    return [ngf * 4] + [ngf * 8] * 5


def critic_specs(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of the large critic's parameters (``DiscriminatorLarge``)."""
    ngf, td = cfg["ngf"], cfg["t_emb_dim"]
    specs: Dict[str, Tuple[int, ...]] = {}
    _dense(specs, "t_embed.fc0", td, td)
    _dense(specs, "t_embed.fc1", td, td)
    _dense(specs, "start_conv", 2, 2 * ngf)
    ch = 2 * ngf
    for i, oc in enumerate(critic_blocks(ngf)):
        _conv3(specs, f"conv{i + 1}.conv1", ch, oc)
        _dense(specs, f"conv{i + 1}.dense_t1", td, oc)
        _conv3(specs, f"conv{i + 1}.conv2", oc, oc)
        _dense(specs, f"conv{i + 1}.skip", ch, oc, bias=False)
        ch = oc
    _conv3(specs, "final_conv", ch + 1, 8 * ngf)
    _dense(specs, "end_linear", 8 * ngf, 1)
    return specs


def att_conv_specs(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """The G step's frozen 1x1 projection of the critic's features."""
    return {"weight": (1, 8 * cfg["ngf"]), "bias": (1,)}


# ------------------------------------------------------------------ routing

def int8_min_ch(cfg: dict) -> int:
    """The serving rule's threshold: max(64, 2 nf)."""
    return max(64, 2 * cfg["num_channels_dae"])


def routed(cfg: dict, cin: int, cout: int) -> bool:
    """Whether the int8 serving rule quantizes a stride-1 3x3 conv."""
    m = int8_min_ch(cfg)
    return cin >= m and cout >= max(2, m)


# ---------------------------------------------------------------- generators

def _silu(x):
    return F.silu(x)


def _adagn(prec, P, name, x, zemb):
    gb = prec.linear(zemb, P[f"{name}.style.weight"], P[f"{name}.style.bias"])
    gamma, beta = gb.chunk(2, dim=-1)
    h = group_norm(x, num_groups(x.shape[-1]))
    return gamma[:, None, None, :] * h + beta[:, None, None, :]


def _site(cfg, name, cin, cout, int8):
    return name if int8 and routed(cfg, cin, cout) else None


def _resblock(prec, cfg, P, name, x, temb, zemb, k2, up=False, down=False, int8=False):
    h = _silu(_adagn(prec, P, f"{name}.GroupNorm_0", x, zemb))
    if up:
        h, x = fir_up2(h, k2), fir_up2(x, k2)
    elif down:
        h, x = fir_down2(h, k2), fir_down2(x, k2)
    w0 = P[f"{name}.Conv_0.weight"]
    h = prec.conv(h, w0, P[f"{name}.Conv_0.bias"],
                  _site(cfg, f"{name}.Conv_0", w0.shape[2], w0.shape[3], int8))
    h = h + prec.linear(_silu(temb), P[f"{name}.Dense_0.weight"],
                        P[f"{name}.Dense_0.bias"])[:, None, None, :]
    h = _silu(_adagn(prec, P, f"{name}.GroupNorm_1", h, zemb))
    w1 = P[f"{name}.Conv_1.weight"]
    h = prec.conv(h, w1, P[f"{name}.Conv_1.bias"],
                  _site(cfg, f"{name}.Conv_1", w1.shape[2], w1.shape[3], int8))
    if f"{name}.Conv_2.weight" in P:
        x = prec.linear(x, P[f"{name}.Conv_2.weight"], P[f"{name}.Conv_2.bias"])
    return (x + h) / SQRT2


def _attn(prec, P, name, x):
    b, hh, ww, c = x.shape
    h = group_norm(x, num_groups(c), P[f"{name}.GroupNorm_0.weight"],
                   P[f"{name}.GroupNorm_0.bias"])
    q, k, v = (prec.linear(h, P[f"{name}.NIN_{i}.weight"], P[f"{name}.NIN_{i}.bias"])
               .reshape(b, hh * ww, c) for i in range(3))
    w = torch.softmax(prec.matmul(q, k.transpose(1, 2)) * (c ** -0.5), dim=-1)
    h = prec.matmul(w, v).reshape(b, hh, ww, c)
    h = prec.linear(h, P[f"{name}.NIN_3.weight"], P[f"{name}.NIN_3.bias"])
    return (x + h) / SQRT2


def _block_diag(kernels: List[torch.Tensor]) -> torch.Tensor:
    """N (3,3,I,F) kernels -> one (3,3,N*I,N*F) block-diagonal kernel."""
    n = len(kernels)
    i_, f = kernels[0].shape[2], kernels[0].shape[3]
    out = kernels[0].new_zeros((3, 3, n * i_, n * f))
    for j, k in enumerate(kernels):
        out[:, :, j * i_:(j + 1) * i_, j * f:(j + 1) * f] = k
    return out


def _cat_bias(P, names):
    return torch.cat([P[f"{n}.bias"] for n in names])


def _encode(prec, cfg, P, x, conds, pseudo, adaptive, int8):
    """The stems (and G2's gates): the trunk's first activation."""
    nf = cfg["num_channels_dae"]
    g = num_groups(nf)
    stems = ["encoder_x", "encoder_c1", "encoder_c2", "encoder_c3"]
    if not adaptive:
        w1 = _block_diag([P[f"{s}.conv1.weight"] for s in stems])
        h = prec.conv(torch.cat([x] + conds, dim=-1), w1,
                      _cat_bias(P, [f"{s}.conv1" for s in stems]), blocks=4)
        h = _silu(group_norm(h, 4 * g))
        w2 = _block_diag([P[f"{s}.conv2.weight"] for s in stems])
        return prec.conv(h, w2, _cat_bias(P, [f"{s}.conv2" for s in stems]),
                         _site(cfg, "stems", 4 * nf, 4 * nf, int8), blocks=4)
    all5 = stems + ["pseudo_gap"]
    w1 = _block_diag([P[f"{s}.conv1.weight"] for s in all5])
    h = prec.conv(torch.cat([x] + conds + [pseudo], dim=-1), w1,
                  _cat_bias(P, [f"{s}.conv1" for s in all5]), blocks=5)
    h = group_norm(h, 5 * g)
    hp = prec.conv(_silu(h[..., 4 * nf:]), P["pseudo_gap.conv2.weight"],
                   P["pseudo_gap.conv2.bias"])
    style = prec.linear(hp.mean(dim=(1, 2)), P["pseudo_gap.fc.weight"], P["pseudo_gap.fc.bias"])
    parts = [_silu(h[..., :nf])]
    for i in (1, 2, 3):
        gb = prec.linear(style, P[f"encoder_c{i}.group_norm.style.weight"],
                         P[f"encoder_c{i}.group_norm.style.bias"])
        gamma, beta = gb.chunk(2, dim=-1)
        parts.append(_silu(gamma[:, None, None, :] * h[..., i * nf:(i + 1) * nf]
                           + beta[:, None, None, :]))
    w2 = _block_diag([P[f"{s}.conv2.weight"] for s in stems])
    out = prec.conv(torch.cat(parts, dim=-1), w2, _cat_bias(P, [f"{s}.conv2" for s in stems]),
                    _site(cfg, "stems", 4 * nf, 4 * nf, int8), blocks=4)
    x_feat, c1, c2, c3 = (out[..., i * nf:(i + 1) * nf] for i in range(4))
    wg = torch.cat([P[f"{n}.weight"] for n in _GATES], dim=-1)
    gates = torch.sigmoid(prec.conv(torch.cat([c1, c2, c3], dim=-1), wg, _cat_bias(P, _GATES),
                                    _site(cfg, "gates", 3 * nf, 6 * nf, int8)))
    a1_12, a2_12, a1_23, a2_23, a1_31, a2_31 = (gates[..., i * nf:(i + 1) * nf]
                                                for i in range(6))
    wn = [f"feat_weight_c{i}" for i in (1, 2, 3)]
    ww = _block_diag([P[f"{n}.weight"] for n in wn])
    att = prec.conv(torch.cat([a1_12 * c1, a1_23 * c2, a1_31 * c3], dim=-1), ww,
                    _cat_bias(P, wn), _site(cfg, "weights", 3 * nf, 3 * nf, int8), blocks=3)
    c1_att, c2_att, c3_att = (att[..., i * nf:(i + 1) * nf] for i in range(3))
    return torch.cat([x_feat,
                      a2_12 * c1_att + (1 - a2_12) * c2,
                      a2_23 * c2_att + (1 - a2_23) * c3,
                      a2_31 * c3_att + (1 - a2_31) * c1], dim=-1)


class _Tagged:
    """``prec`` with each routed site's name prefixed by its generator
    (``g1.`` / ``g2.``): the two generators' sites are calibrated apart."""

    def __init__(self, prec, tag: str):
        self.prec, self.tag = prec, tag

    def conv(self, x, w, b, site=None, stride=1, padding=1, blocks=1):
        return self.prec.conv(x, w, b, None if site is None else f"{self.tag}.{site}",
                              stride, padding, blocks)

    def linear(self, x, w, b=None):
        return self.prec.linear(x, w, b)

    def matmul(self, a, b):
        return self.prec.matmul(a, b)


def generator(prec, cfg: dict, P: Params, x, c1, c2, c3, t, z,
              pseudo: Optional[torch.Tensor] = None, int8: bool = False,
              ckpt: bool = False) -> torch.Tensor:
    """x_0 (B,H,W,1) from x_t, the conditions, t (B,) int and z (B, nz);
    G2 when ``pseudo`` (G1's prediction) is given.  ``int8``: name the
    convs the serving rule routes, for a ``Quantized`` precision.
    ``ckpt``: recompute each block in the backward (the same values,
    less memory)."""
    prec = _Tagged(prec, "g2" if pseudo is not None else "g1")

    def blk(fn, *a, **kw):
        if not ckpt:
            return fn(*a, **kw)
        return torch.utils.checkpoint.checkpoint(lambda *aa: fn(*aa, **kw), *a,
                                                 use_reentrant=False)

    nf = cfg["num_channels_dae"]
    k2 = fir_taps(cfg["fir_kernel"]).to(x.device)
    zn = z * torch.rsqrt(torch.mean(z * z, dim=-1, keepdim=True) + 1e-8)
    zemb = _silu(prec.linear(zn, P["z_transform.fc0.weight"], P["z_transform.fc0.bias"]))
    for i in range(cfg["n_mlp"]):
        zemb = _silu(prec.linear(zemb, P[f"z_transform.fc{i + 1}.weight"],
                                 P[f"z_transform.fc{i + 1}.bias"]))
    temb = timestep_embedding(t, nf)
    temb = prec.linear(_silu(prec.linear(temb, P["temb_dense0.weight"], P["temb_dense0.bias"])),
                       P["temb_dense1.weight"], P["temb_dense1.bias"])
    hs = [blk(_encode, prec, cfg, P, x, [c1, c2, c3], pseudo, pseudo is not None, int8)]
    pyramid = x
    trunk, _ = _trunk(cfg)
    h = None
    it = iter(trunk)
    for kind, name, cin, cout, _res in it:
        if kind == "res" and name.startswith("down_"):
            h = blk(_resblock, prec, cfg, P, name, hs[-1], temb, zemb, k2, int8=int8)
            hs.append(h)
        elif kind == "attn" and name.startswith("down_attn"):
            hs[-1] = blk(_attn, prec, P, name, hs[-1])
        elif kind == "down":
            h = blk(_resblock, prec, cfg, P, name, hs[-1], temb, zemb, k2, down=True, int8=int8)
            _, pname, _, _, _ = next(it)
            pyramid = conv_down2(prec, pyramid, P[f"{pname}.Conv2d_0.weight"],
                                 P[f"{pname}.Conv2d_0.bias"], k2)
            pyramid = (pyramid + h) / SQRT2
            hs.append(pyramid)
        elif name == "mid_block1":
            h = blk(_resblock, prec, cfg, P, name, hs[-1], temb, zemb, k2, int8=int8)
        elif kind == "attn":
            h = blk(_attn, prec, P, name, h)
        elif name == "mid_block2":
            h = blk(_resblock, prec, cfg, P, name, h, temb, zemb, k2, int8=int8)
        elif kind == "res":
            h = blk(_resblock, prec, cfg, P, name, torch.cat([h, hs.pop()], dim=-1), temb, zemb,
                    k2, int8=int8)
        elif kind == "up":
            h = blk(_resblock, prec, cfg, P, name, h, temb, zemb, k2, up=True, int8=int8)
    assert not hs
    h = _silu(group_norm(h, num_groups(h.shape[-1]), P["final_norm.weight"],
                         P["final_norm.bias"]))
    return torch.tanh(prec.conv(h, P["final_conv.weight"], P["final_conv.bias"]))


# -------------------------------------------------------------------- critic

def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def minibatch_stddev(h: torch.Tensor, group_size: int = 4) -> torch.Tensor:
    """StyleGAN2's stddev feature with the batch viewed group-major."""
    b, hh, ww, c = h.shape
    group = min(b, group_size)
    while b % group:
        group -= 1
    x5 = h.reshape(group, b // group, hh, ww, c)
    var = ((x5 - x5.mean(dim=0)) ** 2).mean(dim=0)
    s = torch.sqrt(var + 1e-8).mean(dim=(1, 2, 3)).repeat(group)
    return torch.cat([h, s[:, None, None, None].expand(b, hh, ww, 1)], dim=-1)


def critic(prec, cfg: dict, P: Params, x, t, x_t) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logit (B,), the activation after the third block)."""
    k2 = fir_taps(cfg["fir_kernel"]).to(x.device)
    te = timestep_embedding(t, cfg["t_emb_dim"])
    te = prec.linear(_lrelu(prec.linear(te, P["t_embed.fc0.weight"], P["t_embed.fc0.bias"])),
                     P["t_embed.fc1.weight"], P["t_embed.fc1.bias"])
    te = _lrelu(te)
    h = prec.linear(torch.cat([x, x_t], dim=-1), P["start_conv.weight"], P["start_conv.bias"])
    feat = None
    for i in range(len(critic_blocks(cfg["ngf"]))):
        n = f"conv{i + 1}"
        out = prec.conv(_lrelu(h), P[f"{n}.conv1.weight"], P[f"{n}.conv1.bias"])
        out = _lrelu(out + prec.linear(te, P[f"{n}.dense_t1.weight"],
                                       P[f"{n}.dense_t1.bias"])[:, None, None, :])
        out = fir_down2(out, k2)
        out = prec.conv(out, P[f"{n}.conv2.weight"], P[f"{n}.conv2.bias"])
        skip = prec.linear(fir_down2(h, k2), P[f"{n}.skip.weight"])
        h = (out + skip) / SQRT2
        if i == 2:
            feat = h
    h = _lrelu(prec.conv(minibatch_stddev(h), P["final_conv.weight"], P["final_conv.bias"]))
    logit = prec.linear(h.sum(dim=(1, 2)), P["end_linear.weight"], P["end_linear.bias"])
    return logit.reshape(-1), feat
