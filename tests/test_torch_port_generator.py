"""mudiff_torch G1/G2 vs the JAX generators, on the CPU.

A small recipe-shaped config (BigGAN AdaGN blocks, positional time
embedding, ``progressive_input="residual"``, attention active at 16²)
runs through both packages with the same seeded non-trivial weights,
carried across by ``convert.params_from_flax``.  Tolerances are those of
``tests/test_full_model_parity.py`` (atol 5e-4, rtol 1e-3).  Parameter
counts are checked at the served widths without JAX.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudiff_tpu import config as jconfig
from mudiff_tpu.models import NCSNppGenerator as JaxGenerator
from mudiff_torch import build_sampler, config, ops
from mudiff_torch.convert import params_from_flax
from mudiff_torch.models import NCSNppGenerator
from test_torch_port_helpers import random_flax_params

SMALL = dict(image_size=32, num_channels=1, num_channels_dae=16, ch_mult=(1, 2),
             num_res_blocks=1, attn_resolutions=(16,), z_emb_dim=32, nz=16, n_mlp=3)
B = 2


@functools.lru_cache(maxsize=None)
def _case(adaptive):
    """(numpy inputs, randomized flax params, JAX output) for G1 or G2."""
    rng = np.random.RandomState(10 + adaptive)
    x = rng.randn(B, 32, 32, 1).astype(np.float32)
    conds = [rng.randn(B, 32, 32, 1).astype(np.float32) for _ in range(3)]
    t = np.array([1, 3], np.int32)
    z = rng.randn(B, 16).astype(np.float32)
    pseudo = np.tanh(rng.randn(B, 32, 32, 1)).astype(np.float32)
    inputs = [x, *conds, t, z]
    kw = {"pseudo_target": jnp.asarray(pseudo)} if adaptive else {}
    m = JaxGenerator(config=jconfig.MuDiffConfig(**SMALL), adaptive=adaptive)
    params = random_flax_params(m, *map(jnp.asarray, inputs), seed=20 + adaptive, **kw)
    ref = np.asarray(jax.jit(m.apply)({"params": params}, *map(jnp.asarray, inputs), **kw))
    return inputs, pseudo, params, ref


def _port(adaptive, params):
    g = NCSNppGenerator(config.MuDiffConfig(**SMALL), adaptive=adaptive).eval()
    g.load_state_dict(params_from_flax(params), strict=True)
    return g


@pytest.mark.parametrize("adaptive", [False, True], ids=["G1", "G2"])
def test_generator_forward_matches_jax(adaptive):
    inputs, pseudo, params, ref = _case(adaptive)
    assert ref.std() > 1e-2, "reference output is near constant"
    g = _port(adaptive, params)
    x, c1, c2, c3, t, z = inputs
    args = [torch.from_numpy(a) for a in (x, c1, c2, c3, t.astype(np.int64), z)]
    kw = {"pseudo_target": torch.from_numpy(pseudo)} if adaptive else {}
    log = []
    with torch.inference_mode(), ops.record_calls(log):
        out = g(*args, **kw)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4, rtol=1e-3)
    # the wrappers the forward called are the ones the structure predicts
    called = {name: sum(1 for n, _ in log if n == name) for name in g.kernel_launches_per_forward()}
    assert called == g.kernel_launches_per_forward()


def test_converter_is_strict_both_ways():
    _, _, params, _ = _case(False)
    g = NCSNppGenerator(config.MuDiffConfig(**SMALL)).eval()
    state = params_from_flax(params)
    assert len(state) == len(jax.tree_util.tree_leaves(params))
    missing = dict(state)
    missing.pop("final_conv.bias")
    with pytest.raises(RuntimeError, match="Missing"):
        g.load_state_dict(missing, strict=True)
    extra = dict(params)
    extra["stray"] = {"conv": {"kernel": np.zeros((3, 3, 1, 1), np.float32)}}
    with pytest.raises(RuntimeError, match="Unexpected"):
        g.load_state_dict(params_from_flax(extra), strict=True)
    with pytest.raises(ValueError, match="unknown flax leaf"):
        params_from_flax({"m": {"gamma": np.zeros(3)}})


@pytest.mark.parametrize(
    "nf,g1,g2",
    [(64, 20_472_065, 21_399_681), (128, 72_759_809, 76_236_801)],
)
def test_param_counts_at_served_widths(nf, g1, g2):
    cfg = config.brats_recipe(num_channels_dae=nf)
    for adaptive, want in ((False, g1), (True, g2)):
        with torch.device("meta"):
            g = NCSNppGenerator(cfg, adaptive=adaptive, device="meta")
        assert sum(p.numel() for p in g.parameters()) == want


def test_kernel_launches_per_forward_at_nf64():
    """The counts chip_smoke.py holds the card's launches to."""
    cfg = config.brats_recipe(num_channels_dae=64)
    with torch.device("meta"):
        g1 = NCSNppGenerator(cfg, device="meta")
        g2 = NCSNppGenerator(cfg, adaptive=True, device="meta")
    # the default einsum attention launches no K3; K5 once a norm: 21
    # resblocks x 2, the middle attention's, final_norm, the fused stems
    # (G1 one call, G2 three)
    bwd = {"flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0}
    assert g1.kernel_launches_per_forward() == {"conv3x3": 45, "fir_down2": 4, "fir_up2": 4,
                                                "flash_attn": 0, **bwd, "int8_conv3x3": 0,
                                                "group_norm_act": 45}
    assert g2.kernel_launches_per_forward() == {"conv3x3": 48, "fir_down2": 4, "fir_up2": 4,
                                                "flash_attn": 0, **bwd, "int8_conv3x3": 0,
                                                "group_norm_act": 47}
    # int8 serving: the routed convs (30 / 32 sites) move from K1 to K4
    cfg8 = cfg.replace(use_int8=True)
    with torch.device("meta"):
        g1 = NCSNppGenerator(cfg8, device="meta").eval()
        g2 = NCSNppGenerator(cfg8, adaptive=True, device="meta").eval()
    assert g1.kernel_launches_per_forward() == {"conv3x3": 15, "fir_down2": 4, "fir_up2": 4,
                                                "flash_attn": 0, **bwd, "int8_conv3x3": 30,
                                                "group_norm_act": 45}
    assert g2.kernel_launches_per_forward() == {"conv3x3": 16, "fir_down2": 4, "fir_up2": 4,
                                                "flash_attn": 0, **bwd, "int8_conv3x3": 32,
                                                "group_norm_act": 47}


def test_config_copy_equals_jax_config():
    port_fields = [(f.name, f.default) for f in dataclasses.fields(config.MuDiffConfig)]
    jax_fields = [(f.name, f.default) for f in dataclasses.fields(jconfig.MuDiffConfig)]
    assert port_fields == jax_fields
    for kw in ({}, {"num_channels_dae": 64}, {"attn_resolutions": "16,8", "fir_kernel": "[1,3,3,1]"}):
        assert config.brats_recipe(**kw).to_dict() == jconfig.brats_recipe(**kw).to_dict()


def test_dropout_trains_only_with_seeds():
    cfg = config.MuDiffConfig(**SMALL)
    # dropout > 0 trains: the masks come from the step's seeds, one per
    # resblock (train/steps.py); without seeds the forward is deterministic
    g = NCSNppGenerator(cfg.replace(dropout=0.3)).train()
    x = torch.randn(1, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    t, z = torch.zeros(1, dtype=torch.int64), torch.zeros(1, 16)
    with torch.no_grad():
        plain = g(x, x, x, x, t, z)
        dropped = g(x, x, x, x, t, z, dropout_seeds=range(len(g._resblocks)))
        assert torch.equal(plain, g(x, x, x, x, t, z))
    assert not torch.equal(plain, dropped)
    with pytest.raises(ValueError, match="dropout seeds"):
        g(x, x, x, x, t, z, dropout_seeds=[0])


def test_build_sampler_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_sampler(config.MuDiffConfig(**SMALL))
