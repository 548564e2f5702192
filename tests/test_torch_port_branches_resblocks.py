"""The generator's resblock, resampling, channel and condition branches
against the JAX package, on the CPU.

G1 and G2 at ``BRANCH_SMALL`` with the same seeded weights in both
packages (``random_flax_params`` through ``convert.params_from_flax``,
loaded strictly), atol 5e-4 / rtol 1e-3 in fp32
(``tests/test_full_model_parity.py``'s): the ddpm and one-AdaGN resblocks
with FIR and naive resampling, naive BigGAN blocks, three-channel images
(the per-stem modules) and two conditions (the single pairwise fusion),
also all at once with the Fourier embedding.  The two-condition
generators' parameter counts are pinned at the JAX package's.
"""

import numpy as np
import pytest
import torch

from mudiff_torch import config
from mudiff_torch.models import NCSNppGenerator
from test_torch_port_helpers import branch_pair

ATOL, RTOL = 5e-4, 1e-3

CASES = {
    "ddpm": (dict(resblock_type="ddpm"), 3),
    "ddpm_naive": (dict(resblock_type="ddpm", fir=False), 3),
    "ddpm_naive_no_conv": (dict(resblock_type="ddpm", fir=False, resamp_with_conv=False), 3),
    "oneadagn": (dict(resblock_type="biggan_oneadagn"), 3),
    "oneadagn_naive": (dict(resblock_type="biggan_oneadagn", fir=False,
                            progressive="residual"), 3),
    "biggan_naive": (dict(fir=False), 3),
    "channels3": (dict(num_channels=3), 3),
    "two_conditions": (dict(), 2),
    "all_at_once": (dict(resblock_type="ddpm", fir=False, embedding_type="fourier",
                         num_channels=3), 2),
}


@pytest.mark.parametrize("adaptive", [False, True], ids=["G1", "G2"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_resblock_and_stem_branches_match_jax(case, adaptive):
    over, nc = CASES[case]
    ref, out, _ = branch_pair(over, adaptive, num_conditions=nc, t=(1, 3))
    assert ref.shape == (2, 16, 16, over.get("num_channels", 1)) and ref.std() > 1e-2
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_two_condition_parameter_counts_are_the_jax_ones():
    """G1 20,286,785 / G2 20,443,585 at nf=64 (``tests/test_models.py``,
    the reference's two-condition generators), on the meta device."""
    cfg = config.brats_recipe(image_size=32, attn_resolutions=(5,), num_channels_dae=64)
    with torch.device("meta"):
        g1 = NCSNppGenerator(cfg, num_conditions=2, device="meta")
        g2 = NCSNppGenerator(cfg, adaptive=True, num_conditions=2, device="meta")
    assert sum(p.numel() for p in g1.parameters()) == 20_286_785
    assert sum(p.numel() for p in g2.parameters()) == 20_443_585
    x = torch.zeros(1, 32, 32, 1)
    with pytest.raises(ValueError, match="cond3"):
        NCSNppGenerator(cfg.replace(image_size=32, num_channels_dae=8), num_conditions=2)(
            x, x, x, x, torch.ones(1, dtype=torch.int64), torch.zeros(1, cfg.nz))
