"""mudiff_torch layers, blocks and fused stems vs their flax modules.

Each test builds the flax module with seeded non-trivial parameters
(``random_flax_params``: fresh inits put several convs at ~1e-10
scale, which would make a comparison vacuous), carries them into
the port with ``convert.params_from_flax`` and compares float32 outputs
on the CPU.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudiff_tpu.nn import blocks as jblocks
from mudiff_tpu.nn import fused_stems as jstems
from mudiff_tpu.nn import layers as jlayers
from mudiff_torch.convert import params_from_flax
from mudiff_torch.nn import blocks, fused_stems, initializers, layers
from test_torch_port_helpers import random_flax_params

ATOL, RTOL = 1e-4, 1e-4


def _flax(module, *args, seed=0):
    """Init ``module``, randomize its params, apply; -> (params, output)."""
    params = random_flax_params(module, *args, seed=seed)
    out = jax.jit(module.apply)({"params": params}, *args)
    return params, np.asarray(out, np.float32)


def _port(module, params):
    module.load_state_dict(params_from_flax(params), strict=True)
    return module.eval()


def _np(*shape, seed=1, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _run(module, *arrays):
    with torch.inference_mode():
        out = module(*[torch.from_numpy(a) for a in arrays])
    return out.float().numpy()


def _close(ours, ref, atol=ATOL, rtol=RTOL):
    assert np.std(ref) > 1e-2, "reference output is near constant"
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=rtol)


# --- layers ---------------------------------------------------------------


def test_conv3x3_dense_nin_match_flax():
    x = _np(2, 8, 8, 6)
    p, ref = _flax(jlayers.Conv3x3(5), jnp.asarray(x))
    _close(_run(_port(layers.Conv3x3(6, 5), p), x), ref)

    v = _np(3, 7, seed=2)
    p, ref = _flax(jlayers.Dense(9), jnp.asarray(v))
    _close(_run(_port(layers.Dense(7, 9), p), v), ref)

    p, ref = _flax(jlayers.NIN(4), jnp.asarray(x))
    _close(_run(_port(layers.NIN(6, 4), p), x), ref)

    p, ref = _flax(jlayers.Conv1x1(3), jnp.asarray(x))
    _close(_run(_port(layers.Conv1x1(6, 3), p), x), ref)


@pytest.mark.parametrize("dim", [16, 17])
def test_timestep_embedding_and_pixel_norm_match(dim):
    t = np.array([0, 1, 3, 999], np.int32)
    ref = np.asarray(jlayers.get_timestep_embedding(jnp.asarray(t), dim))
    ours = layers.get_timestep_embedding(torch.from_numpy(t.astype(np.int64)), dim)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-5)
    z = _np(4, 10)
    ref = np.asarray(jlayers.PixelNorm().apply({}, jnp.asarray(z)))
    np.testing.assert_allclose(layers.pixel_norm(torch.from_numpy(z)).numpy(), ref,
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize(
    "init,mode", [(initializers.default_init(2.0), "fan_avg"),
                  (initializers.stylegan_dense_init(1.0), "fan_out")],
)
def test_initializers_draw_the_jax_distribution(init, mode):
    """Uniform variance scaling; the dense init's fan_out quirk is kept."""
    fan_in, fan_out = 300, 700
    w = torch.empty(fan_out, fan_in)
    init(w, fan_in, fan_out, torch.Generator().manual_seed(0))
    scale = 2.0 if mode == "fan_avg" else 1.0
    denom = (fan_in + fan_out) / 2 if mode == "fan_avg" else fan_out
    limit = np.sqrt(3 * scale / denom)
    assert float(w.abs().max()) <= limit
    np.testing.assert_allclose(float(w.std()), limit / np.sqrt(3), rtol=0.02)
    # the same limit as the JAX initializer draws from
    jax_init = (jstems.default_init(2.0) if mode == "fan_avg"
                else jstems.stylegan_dense_init(1.0))
    jw = np.asarray(jax_init(jax.random.PRNGKey(0), (fan_in, fan_out)))
    np.testing.assert_allclose(np.abs(jw).max(), limit, rtol=0.01)
    zero = torch.empty(50, 50)
    initializers.default_init(0.0)(zero, 50, 50)
    assert float(zero.abs().max()) < 1e-4


# --- blocks ---------------------------------------------------------------


def test_adaptive_group_norm_matches_flax():
    x, style = _np(2, 6, 6, 32), _np(2, 12, seed=3)
    p, ref = _flax(jblocks.AdaptiveGroupNorm(), jnp.asarray(x), jnp.asarray(style))
    _close(_run(_port(blocks.AdaptiveGroupNorm(32, 12), p), x, style), ref)


def test_affine_group_norm_matches_flax():
    x = _np(2, 5, 7, 24, scale=3.0)
    p, ref = _flax(jblocks.AffineGroupNorm(6), jnp.asarray(x))
    _close(_run(_port(blocks.AffineGroupNorm(6, 24), p), x), ref)


def test_attention_einsum_matches_flax(monkeypatch):
    monkeypatch.delenv("MUDIFF_ATTN", raising=False)
    x = _np(2, 4, 4, 16)
    p, ref = _flax(jblocks.AttnBlockpp(skip_rescale=True), jnp.asarray(x))
    port = blocks.AttnBlockpp(16, skip_rescale=True, attn="einsum")
    _close(_run(_port(port, p), x), ref)


def test_attention_bf16_scores_match_flax(monkeypatch):
    """bf16 compute with bf16-rounded scores (MUDIFF_ATTN=bf16 in JAX)."""
    monkeypatch.setenv("MUDIFF_ATTN", "bf16")
    x = _np(2, 4, 4, 16)
    p, ref = _flax(jblocks.AttnBlockpp(skip_rescale=True, dtype=jnp.bfloat16),
                   jnp.asarray(x, jnp.bfloat16))
    port = _port(blocks.AttnBlockpp(16, skip_rescale=True, attn="bf16",
                                    dtype=torch.bfloat16), p)
    with torch.inference_mode():
        ours = port(torch.from_numpy(x).to(torch.bfloat16))
    assert ours.dtype == torch.float32  # bf16 + bf16, then / fp32 sqrt(2)
    # two frameworks round bf16 at different places: a few bf16 ulps
    _close(ours.numpy(), ref, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize(
    "in_ch,out_ch,up,down",
    [(16, 16, False, True), (16, 16, True, False), (8, 16, False, False)],
)
def test_biggan_resblock_matches_flax(in_ch, out_ch, up, down):
    x, temb, zemb = _np(2, 8, 8, in_ch), _np(2, 20, seed=4), _np(2, 12, seed=5)
    jm = jblocks.ResnetBlockBigGANppAdagn(
        act=jax.nn.silu, features=out_ch, up=up, down=down, dropout=0.0,
        fir=True, skip_rescale=True, init_scale=0.0)
    p, ref = _flax(jm, *map(jnp.asarray, (x, temb, zemb)))
    port = blocks.ResnetBlockBigGANppAdagn(in_ch, out_ch, temb_dim=20, zemb_dim=12,
                                           up=up, down=down)
    _close(_run(_port(port, p), x, temb, zemb), ref)


def test_fir_downsample_conv_matches_flax():
    x = _np(2, 16, 16, 3)
    p, ref = _flax(jblocks.Downsample(features=8, with_conv=True, fir=True),
                   jnp.asarray(x))
    _close(_run(_port(blocks.Downsample(3, 8), p), x), ref)


# --- fused stems ----------------------------------------------------------

NF = 8


class _G1Stems(fnn.Module):
    @fnn.compact
    def __call__(self, stacked):
        names = ["encoder_x", "encoder_c1", "encoder_c2", "encoder_c3"]
        ps = [jstems.ConvFeatParams(NF, name=n)() for n in names]
        return jstems.fused_convfeat_apply(stacked, ps, jax.nn.silu, jnp.float32)


class _G2Stems(fnn.Module):
    @fnn.compact
    def __call__(self, x, c1, c2, c3, pseudo):
        px = jstems.ConvFeatParams(NF, name="encoder_x")()
        pcs = [jstems.ConvBlockParams(NF, name=f"encoder_c{i + 1}")() for i in range(3)]
        pgap = jstems.ConvBlockGAPParams(NF, name="pseudo_gap")()
        x_feat, feats, pw = jstems.fused_adaptive_encode(
            x, [c1, c2, c3], pseudo, px, pcs, pgap, jax.nn.silu, jnp.float32)
        return jnp.concatenate([x_feat] + feats, axis=-1), pw


class _PortStems(torch.nn.Module):
    def __init__(self, adaptive):
        super().__init__()
        self.encoder_x = fused_stems.ConvFeatBlock(NF)
        for i in range(3):
            setattr(self, f"encoder_c{i + 1}",
                    fused_stems.ConvBlock(NF) if adaptive
                    else fused_stems.ConvFeatBlock(NF))
        if adaptive:
            self.pseudo_gap = fused_stems.ConvBlockGAP(NF)


def test_fused_convfeat_apply_matches_jax():
    stacked = _np(2, 8, 8, 4)
    p, ref = _flax(_G1Stems(), jnp.asarray(stacked))
    port = _port(_PortStems(adaptive=False), p)
    params = [port.encoder_x] + [getattr(port, f"encoder_c{i + 1}") for i in range(3)]
    with torch.inference_mode():
        ours = fused_stems.fused_convfeat_apply(torch.from_numpy(stacked), params,
                                                torch.float32)
    _close(ours.numpy(), ref)


def test_fused_adaptive_encode_matches_jax():
    imgs = [_np(2, 8, 8, 1, seed=s) for s in range(5)]
    module = _G2Stems()
    params = random_flax_params(module, *map(jnp.asarray, imgs))
    ref_feats, ref_pw = jax.jit(module.apply)({"params": params}, *map(jnp.asarray, imgs))
    port = _port(_PortStems(adaptive=True), params)
    x, c1, c2, c3, pseudo = map(torch.from_numpy, imgs)
    with torch.inference_mode():
        x_feat, feats, pw = fused_stems.fused_adaptive_encode(
            x, [c1, c2, c3], pseudo, port.encoder_x,
            [port.encoder_c1, port.encoder_c2, port.encoder_c3], port.pseudo_gap,
            torch.float32)
    _close(torch.cat([x_feat] + feats, dim=-1).numpy(), np.asarray(ref_feats))
    _close(pw.numpy(), np.asarray(ref_pw))


def _conv_modules(n, cin, cout, seed):
    rng = np.random.RandomState(seed)
    mods, jparams = [], []
    for _ in range(n):
        k = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
        b = (0.1 * rng.randn(cout)).astype(np.float32)
        m = layers.Conv3x3(cin, cout)
        m.load_state_dict({"weight": torch.from_numpy(k), "bias": torch.from_numpy(b)})
        mods.append(m)
        jparams.append((jnp.asarray(k), jnp.asarray(b)))
    return mods, jparams


def test_fused_gate_and_weight_convs_match_jax():
    allc = _np(2, 8, 8, 3 * NF)
    mods, jp = _conv_modules(6, 3 * NF, NF, seed=6)
    ref = jstems.fused_gate_convs(jnp.asarray(allc), jp, jnp.float32)
    with torch.inference_mode():
        ours = fused_stems.fused_gate_convs(torch.from_numpy(allc), mods, torch.float32)
    for o, r in zip(ours, ref):
        _close(o.numpy(), np.asarray(r))

    inputs = [_np(2, 8, 8, NF, seed=s) for s in (7, 8, 9)]
    mods, jp = _conv_modules(3, NF, NF, seed=10)
    ref = jstems.fused_weight_convs([jnp.asarray(a) for a in inputs], jp, jnp.float32)
    with torch.inference_mode():
        ours = fused_stems.fused_weight_convs(
            [torch.from_numpy(a) for a in inputs], mods, torch.float32)
    for o, r in zip(ours, ref):
        _close(o.numpy(), np.asarray(r))
