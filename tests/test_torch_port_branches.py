"""The generator's pyramid and embedding branches against the JAX package,
on the CPU, and the structure counts of the branch configurations.

G1 and G2 at ``BRANCH_SMALL`` (16², nf 8, ``ch_mult (1, 2)``, one
resblock a level) with the same seeded weights in both packages
(``random_flax_params`` through ``convert.params_from_flax``, loaded
strictly); tolerances are ``tests/test_full_model_parity.py``'s (atol
5e-4, rtol 1e-3, fp32).  The Fourier embedding reads ``log(t)``, so its
cases run at t >= 1; at t = 0 both packages give NaN (a fact of the
reference, kept).  ``kernel_launches_per_forward`` of the three full-width
branch configurations is counted from the structure on the meta device.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudiff_torch import config, ops
from mudiff_torch.models import NCSNppGenerator
from mudiff_torch.models.generator import resblock_count
from mudiff_tpu import config as jconfig
from mudiff_tpu.models import NCSNppGenerator as JaxGenerator
from test_torch_port_helpers import BRANCH_SMALL, branch_inputs, branch_pair

ATOL, RTOL = 5e-4, 1e-3

# tests/test_models.py:252-255's four, then the other pyramid branches
PYRAMIDS = {
    "output_skip+input_skip": dict(progressive="output_skip", progressive_input="input_skip"),
    "output_skip+residual": dict(progressive="output_skip", progressive_input="residual"),
    "none+input_skip": dict(progressive="none", progressive_input="input_skip"),
    "fourier": dict(progressive="none", progressive_input="residual",
                    embedding_type="fourier"),
    "residual": dict(progressive="residual"),
    "input_skip+cat": dict(progressive_input="input_skip", progressive_combine="cat"),
}

# the three configurations chip_smoke.py drives at full width
B1 = dict(resblock_type="biggan_oneadagn", progressive="output_skip",
          progressive_input="input_skip", progressive_combine="sum")
B2 = dict(resblock_type="ddpm", progressive="residual", progressive_input="residual")
B3 = dict(resblock_type="ddpm", fir=False, embedding_type="fourier", num_channels=3)


@pytest.mark.parametrize("adaptive", [False, True], ids=["G1", "G2"])
@pytest.mark.parametrize("case", sorted(PYRAMIDS))
def test_pyramid_and_embedding_branches_match_jax(case, adaptive):
    ref, out, _ = branch_pair(PYRAMIDS[case], adaptive, t=(1, 3))
    assert ref.shape == (2, 16, 16, 1) and ref.std() > 1e-2
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_fourier_embedding_is_nan_at_t0_in_both_packages():
    """``log(0) = -inf``: every lane of the embedding, and so the whole
    output, is NaN at t = 0 in both packages, finite at t = 1."""
    ref, out, g = branch_pair(PYRAMIDS["fourier"], False, t=(0, 1))
    assert np.isnan(ref[0]).all() and np.isnan(out[0]).all()
    np.testing.assert_allclose(out[1], ref[1], atol=ATOL, rtol=RTOL)
    emb = g.fourier_emb(torch.log(torch.tensor([0.0, 1.0])))
    assert torch.isnan(emb[0]).all()
    nf = BRANCH_SMALL["num_channels_dae"]
    assert torch.equal(emb[1], torch.cat([torch.zeros(nf), torch.ones(nf)]))


def test_generator_calls_what_the_structure_says_on_each_branch():
    """Every wrapper call of a forward is one ``kernel_launches_per_forward``
    counts, for B1-B3 at small size (G1 and G2, flash attention)."""
    for over in (B1, B2, B3):
        cfg = config.MuDiffConfig(**{**BRANCH_SMALL, **over})
        c = cfg.num_channels
        x, conds, t, z, pseudo = branch_inputs(c, 3)
        tt = torch.from_numpy
        for adaptive in (False, True):
            g = NCSNppGenerator(cfg, adaptive=adaptive, attn="flash").eval()
            log = []
            with torch.no_grad(), ops.record_calls(log):
                g(tt(x), *map(tt, conds), tt(t).long(), tt(z),
                  *([tt(pseudo)] if adaptive else []))
            called = {k: sum(1 for n, _ in log if n == k) for k in ops.KERNEL_WRAPPERS}
            assert called == g.kernel_launches_per_forward(), (over, adaptive)


def _meta(cfg, adaptive, **kw):
    with torch.device("meta"):
        return NCSNppGenerator(cfg, adaptive=adaptive, attn="flash", device="meta", **kw)


def _counts(conv, down, up, norms, int8=0):
    return {"conv3x3": conv, "fir_down2": down, "fir_up2": up, "flash_attn": 1,
            "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0, "int8_conv3x3": int8,
            "group_norm_act": norms}


def test_kernel_launches_per_forward_of_the_branches_at_nf64():
    """The counts chip_smoke.py holds the card's launches to, worked out by
    hand at ``brats_recipe(num_channels_dae=64)`` (levels 256/128/64, two
    resblocks a level, the middle attention on K3):

    * B1: 21 resblocks x 2 convs + 3 pyramid convs + the fused stems (G1 2,
      G2 5); K2a 2 x 2 in the down resblocks + 2 pyramid downsamples, K2b
      2 x 2 + 2 pyramid upsamples.  int8 (threshold 128): the stem conv2,
      G2's two gate convs, and 29 trunk convs.
    * B2: 17 resblocks x 2 + ``pyramid_conv_2`` + ``final_conv`` + stems;
      every resample is a FIR conv (plain), so no K2.  int8: the stem
      conv2, G2's gates, and 24 trunk convs.
    * B3: 17 x 2 + two nearest-then-conv upsamples + ``final_conv``, and
      the per-stem convs of three-channel images (G1 3 x 2 with two
      conditions; G2 pseudo-GAP, x and two conditions, 4 x 2, + 2 gates).

    K5, one a norm: two a resblock, the middle attention's, then B1 the
    three output_skip pyramid norms and the fused stems (G1 one, G2 three):
    42 + 1 + 3 + 1 / 3; B2 the residual pyramid's one norm and
    ``final_norm``: 34 + 1 + 2 + 1 / 3; B3 ``final_norm`` and one norm a
    stem (G1 three, G2 four): 34 + 1 + 1 + 3 / 4.  int8 leaves K5's count.
    """
    base = config.brats_recipe(num_channels_dae=64)
    want = {"B1": (_counts(47, 6, 6, 47), _counts(50, 6, 6, 49)),
            "B2": (_counts(38, 0, 0, 38), _counts(41, 0, 0, 40)),
            "B3": (_counts(43, 0, 0, 39), _counts(47, 0, 0, 40))}
    for name, over in (("B1", B1), ("B2", B2), ("B3", B3)):
        nc = 2 if name == "B3" else 3
        for adaptive, w in zip((False, True), want[name]):
            g = _meta(base.replace(**over), adaptive, num_conditions=nc)
            assert g.kernel_launches_per_forward() == w, (name, adaptive)
    want8 = {"B1": (_counts(17, 6, 6, 47, 30), _counts(18, 6, 6, 49, 32)),
             "B2": (_counts(13, 0, 0, 38, 25), _counts(14, 0, 0, 40, 27))}
    for name, over in (("B1", B1), ("B2", B2)):
        for adaptive, w in zip((False, True), want8[name]):
            g = _meta(base.replace(use_int8=True, **over), adaptive).eval()
            assert g.kernel_launches_per_forward() == w, (name, adaptive)


BRANCHES = {
    "ddpm": dict(resblock_type="ddpm"),
    "ddpm_naive": dict(resblock_type="ddpm", fir=False, resamp_with_conv=False),
    "oneadagn": dict(resblock_type="biggan_oneadagn"),
    "channels3": dict(num_channels=3, progressive="output_skip",
                      progressive_input="input_skip"),
    "two_conditions": dict(resblock_type="ddpm"),
}


def _jax_structure(over, adaptive, policy, num_conditions):
    """(resblocks, remat regions) of the JAX generator: the top-level
    modules with an AdaGN ``GroupNorm_0`` in its parameter tree, and the
    ``remat`` equations of its forward's jaxpr, named by the block their
    inner equations run in (the unnamed ones are the stem and fusion
    regions, named as the port names them)."""
    cfg = jconfig.MuDiffConfig(**{**BRANCH_SMALL, **over}, use_grad_checkpoint=True,
                               grad_checkpoint_policy=policy)
    g = JaxGenerator(config=cfg, adaptive=adaptive, num_conditions=num_conditions)
    s, c = cfg.image_size, cfg.num_channels
    x = jnp.zeros((1, s, s, c))
    conds = [x] * num_conditions + [None] * (3 - num_conditions)
    t, z = jnp.ones((1,), jnp.int32), jnp.zeros((1, cfg.nz))
    kw = dict(pseudo_target=x) if adaptive else {}
    params = jax.eval_shape(g.init, jax.random.PRNGKey(0), x, *conds, t, z, **kw)
    blocks = {k for k, v in params["params"].items()
              if "style" in v.get("GroupNorm_0", {}) and not k.startswith(("encoder", "pseudo"))}
    jaxpr = jax.make_jaxpr(lambda p: g.apply(p, x, *conds, t, z, **kw))(params).jaxpr
    block = re.compile(r"^(down|downsample|up|upsample|mid)_")
    names, unnamed = set(), 0
    for e in jaxpr.eqns:
        if "remat" not in e.primitive.name and "checkpoint" not in e.primitive.name:
            continue
        sub = e.params["jaxpr"]
        inner = {str(ee.source_info.name_stack).split("/")[0]
                 for ee in getattr(sub, "jaxpr", sub).eqns}
        named = {n for n in inner if block.match(n)}
        assert len(named) <= 1, named
        names |= named
        unnamed += not named
    outside = ["encode" if adaptive else "stems"] if c == 1 else []
    outside += ["fuse"] if adaptive else []
    assert unnamed == len(outside)
    return len(blocks), names | set(outside)


@pytest.mark.parametrize("policy", ["blocks", "hires"])
@pytest.mark.parametrize("case", sorted(BRANCHES))
def test_resblock_count_and_remat_regions_are_the_jax_ones(case, policy):
    over = BRANCHES[case]
    nc = 2 if case == "two_conditions" else 3
    cfg = config.MuDiffConfig(**{**BRANCH_SMALL, **over}, use_grad_checkpoint=True,
                              grad_checkpoint_policy=policy)
    for adaptive in (False, True):
        n, regions = _jax_structure(over, adaptive, policy, nc)
        with torch.device("meta"):
            g = NCSNppGenerator(cfg, adaptive=adaptive, num_conditions=nc, device="meta")
        assert resblock_count(cfg) == len(g._resblocks) == n
        assert g.remat_regions == regions, (case, adaptive)
