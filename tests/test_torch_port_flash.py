"""mudiff_torch kernel K3 (flash attention forward) and the ``flash``
attention lowering vs the JAX package, on the CPU.

On the CPU ``ops.flash_attn`` runs its plain version.  It is held to the
stock Pallas module's own reference (``mha_reference``), and
``AttnBlockpp(attn="flash")`` to the JAX ``AttnBlockpp`` under
``MUDIFF_ATTN=flash``, which on the CPU backend is the exact einsum
(``mudiff_tpu/nn/blocks.py:204-205``).  The CUDA kernel itself is held
to the plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

from mudiff_tpu.nn import blocks as jblocks
from mudiff_torch import build_sampler, config, ops
from mudiff_torch.convert import params_from_flax
from mudiff_torch.models import NCSNppGenerator
from mudiff_torch.nn import blocks
from mudiff_torch.ops.flash_attn import _check as check_kernel_args
from test_torch_port_helpers import random_flax_params


def _qkv(b, length, c, seed=0, q_scale=2.0):
    rng = np.random.RandomState(seed)
    q = (q_scale * rng.randn(b, length, c)).astype(np.float32)
    return q, rng.randn(b, length, c).astype(np.float32), rng.randn(b, length, c).astype(np.float32)


def test_plain_flash_attn_matches_the_stock_mha_reference():
    q, k, v = _qkv(2, 64, 32)
    scale = 32 ** -0.5
    ref = np.asarray(mha_reference(*(jnp.asarray(a)[:, None] for a in (q, k, v)), None,
                                   sm_scale=scale))[:, 0]
    log = []
    with ops.record_calls(log):
        ours = ops.flash_attn(*map(torch.from_numpy, (q, k, v)), scale)
    assert log == [("flash_attn", (2, 64, 32, torch.float32))]
    assert ours.dtype == torch.float32 and ref.std() > 1e-2
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_plain_flash_attn_rounds_the_weights_to_the_input_dtype():
    """bf16 in: fp32 scores and softmax, weights cast to bf16, w.v in
    fp32, output bf16 (the exact einsum of ``blocks.py:226-233``)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(2, 48, 16, seed=1))
    scale = 16 ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    w = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    want = torch.matmul(w, v.float()).to(torch.bfloat16)
    ops.reset_launch_counts()
    got = ops.flash_attn(q, k, v, scale)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ops.launch_counts()["flash_attn"] == 0  # the plain version launches nothing


@pytest.mark.parametrize("shapes,dtypes,match", [
    (((2, 8, 516),) * 3, (torch.float32,) * 3, "head dim"),
    (((2, 8, 30),) * 3, (torch.float32,) * 3, "head dim"),
    (((2, 8, 16), (2, 8, 16), (2, 9, 16)), (torch.float32,) * 3, "one shape"),
    (((2, 8, 16),) * 3, (torch.float32, torch.bfloat16, torch.float32), "agree"),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(shapes, dtypes, match):
    q, k, v = (torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes))
    with pytest.raises((ValueError, TypeError), match=match):
        check_kernel_args(q, k, v)
    check_kernel_args(*(torch.zeros(2, 8, 16) for _ in range(3)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_flash_matches_flax(monkeypatch, dtype):
    monkeypatch.setenv("MUDIFF_ATTN", "flash")
    x = np.random.RandomState(1).randn(2, 4, 4, 16).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    module = jblocks.AttnBlockpp(skip_rescale=True, dtype=jdt)
    params = random_flax_params(module, jnp.asarray(x, jdt))
    ref = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x, jdt)), np.float32)
    port = blocks.AttnBlockpp(16, skip_rescale=True, attn="flash", dtype=tdt)
    port.load_state_dict(params_from_flax(params), strict=True)
    log = []
    with torch.inference_mode(), ops.record_calls(log):
        ours = port.eval()(torch.from_numpy(x).to(tdt)).float().numpy()
    assert [name for name, _ in log] == ["group_norm_act", "flash_attn"]
    assert ref.std() > 1e-2
    # fp32: the same exact einsum; bf16: the two frameworks round at
    # different places, a few bf16 ulps (as the bf16-score test allows)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(ours, ref, atol=tol, rtol=tol)


def test_unknown_attention_mode_raises():
    with pytest.raises(ValueError, match="flash"):
        blocks.AttnBlockpp(16, attn="pallas")


SMALL = dict(image_size=32, num_channels=1, num_channels_dae=16, ch_mult=(1, 2),
             num_res_blocks=1, attn_resolutions=(8,), z_emb_dim=32, nz=16, n_mlp=3)


@pytest.mark.parametrize("adaptive", [False, True], ids=["G1", "G2"])
def test_flash_generator_runs_one_flash_attn_per_forward(adaptive):
    """attn_resolutions match no level, as at the recipe's 256²: only
    mid_attn attends, so one K3 call per forward."""
    g = NCSNppGenerator(config.MuDiffConfig(**SMALL), adaptive=adaptive, attn="flash",
                        generator=torch.Generator().manual_seed(0)).eval()
    counts = g.kernel_launches_per_forward()
    assert counts["flash_attn"] == 1
    rng = torch.Generator().manual_seed(1)
    x, c1, c2, c3 = (torch.randn(2, 32, 32, 1, generator=rng) for _ in range(4))
    kw = {"pseudo_target": torch.tanh(x)} if adaptive else {}
    log = []
    with torch.inference_mode(), ops.record_calls(log):
        out = g(x, c1, c2, c3, torch.tensor([0, 3]), torch.randn(2, 16, generator=rng), **kw)
    assert torch.isfinite(out).all()
    assert {name: sum(1 for n, _ in log if n == name) for name in counts} == counts
    assert [key for name, key in log if name == "flash_attn"] == [(2, 256, 32, torch.float32)]


def test_flash_launches_per_sample_at_the_recipe():
    """nf=64, 256²: one K3 launch per generator forward, 8 per 4-step
    sample (G1 + G2 x 4 steps), the count chip_smoke.py holds the card to."""
    cfg = config.brats_recipe(num_channels_dae=64)
    with torch.device("meta"):
        gens = [NCSNppGenerator(cfg, adaptive=a, attn="flash", device="meta")
                for a in (False, True)]
    assert gens[0].kernel_launches_per_forward() == {
        "conv3x3": 45, "fir_down2": 4, "fir_up2": 4, "flash_attn": 1,
        "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0, "int8_conv3x3": 0,
        "group_norm_act": 45}
    assert gens[1].kernel_launches_per_forward()["flash_attn"] == 1
    s = build_sampler(config.MuDiffConfig(**SMALL), device="cpu", attn="flash",
                      compute_dtype=torch.float32)
    assert s.kernel_launches_per_sample()["flash_attn"] == 2 * SMALL.get("num_timesteps", 4)
