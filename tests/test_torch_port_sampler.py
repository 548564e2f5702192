"""mudiff_torch diffusion tables and the 4-step sampler vs the JAX package.

The JAX sampler draws its noise inside ``lax.scan`` from per-step key
splits (``k, kz, kp = jax.random.split(k, 3)``); the test replays those
splits and injects the same ``z`` and posterior noise into the port, so
both samplers see identical numbers.  float32 compute on the CPU, and
bf16 for the serving mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudiff_tpu.config import MuDiffConfig as JaxConfig
from mudiff_tpu.diffusion import sampling as jsampling
from mudiff_tpu.diffusion import schedule as jschedule
from mudiff_tpu.models import NCSNppGenerator as JaxGenerator
from mudiff_torch import build_sampler
from mudiff_torch.config import MuDiffConfig
from mudiff_torch.convert import params_from_flax
from mudiff_torch.diffusion import sampling, schedule
from mudiff_torch.models import NCSNppGenerator
from test_torch_port_helpers import random_flax_params

SMALL = dict(image_size=16, num_channels=1, num_channels_dae=8, ch_mult=(1, 2),
             num_res_blocks=1, attn_resolutions=(8,), z_emb_dim=16, nz=8, n_mlp=2)
B, T = 2, 4


@pytest.mark.parametrize(
    "steps,bmin,bmax,geometric",
    [(4, 0.1, 20.0, False), (1, 0.1, 20.0, False), (10, 0.01, 0.5, True), (8, 0.5, 5.0, False)],
)
def test_schedule_tables_equal_bit_for_bit(steps, bmin, bmax, geometric):
    ours = schedule.PosteriorCoefficients.create(steps, bmin, bmax, geometric)
    ref = jschedule.PosteriorCoefficients.create(steps, bmin, bmax, geometric)
    for name in ref._fields:
        a, b = getattr(ours, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(schedule.get_sigma_schedule(steps, bmin, bmax, geometric),
                    jschedule.get_sigma_schedule(steps, bmin, bmax, geometric)):
        np.testing.assert_array_equal(a, b)


def test_posterior_combine_matches_jax():
    rng = np.random.RandomState(0)
    post_j = jschedule.PosteriorCoefficients.create(T, 0.1, 20.0)
    post_t = schedule.PosteriorCoefficients.create(T, 0.1, 20.0).as_tensors("cpu")
    x0a, x0b, xt = (rng.randn(3, 6, 6, 1).astype(np.float32) for _ in range(3))
    t = np.array([0, 2, 3], np.int32)
    key = jax.random.PRNGKey(5)
    ref = jsampling.sample_posterior_combine(
        post_j, *map(jnp.asarray, (x0a, x0b, xt, t)), key)
    noise = np.array(jax.random.normal(key, xt.shape, dtype=jnp.float32))
    ours = sampling.sample_posterior_combine(
        post_t, *map(torch.from_numpy, (x0a, x0b, xt, t.astype(np.int64), noise)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    # t == 0 adds no noise
    np.testing.assert_allclose(
        ours[0].numpy(),
        0.5 * (post_j.posterior_mean_coef1[0] * (x0a[0] + x0b[0])
               + 2 * post_j.posterior_mean_coef2[0] * xt[0]),
        atol=1e-6)


@functools.lru_cache(maxsize=None)
def _models():
    """Two JAX generators with randomized params, and the port's copies."""
    img = jnp.zeros((B, 16, 16, 1))
    t0, z0 = jnp.zeros((B,), jnp.int32), jnp.zeros((B, SMALL["nz"]))
    out = []
    for adaptive in (False, True):
        m = JaxGenerator(config=JaxConfig(**SMALL), adaptive=adaptive)
        kw = {"pseudo_target": img} if adaptive else {}
        params = random_flax_params(m, img, img, img, img, t0, z0, seed=3 + adaptive, **kw)
        port = NCSNppGenerator(MuDiffConfig(**SMALL), adaptive=adaptive).eval()
        port.load_state_dict(params_from_flax(params), strict=True)
        out.append((m, params, port))
    return out


_KEY = 11


def _sample_inputs():
    rng = np.random.RandomState(4)
    conds = [rng.randn(B, 16, 16, 1).astype(np.float32) for _ in range(3)]
    return conds, rng.randn(B, 16, 16, 1).astype(np.float32)


def _jax_sample(dtype):
    """The JAX package's 4-step sample, generators in ``dtype``."""
    (_, p1, _), (_, p2, _) = _models()
    m1, m2 = (JaxGenerator(config=JaxConfig(**SMALL), adaptive=a, dtype=dtype)
              for a in (False, True))
    conds, x_init = _sample_inputs()
    post_j = jschedule.PosteriorCoefficients.create(T, 0.1, 20.0)
    return np.asarray(jsampling.sample_from_model(
        post_j,
        lambda *a: m1.apply({"params": p1}, *a),
        lambda *a: m2.apply({"params": p2}, *a[:6], pseudo_target=a[6]),
        *map(jnp.asarray, conds), jnp.asarray(x_init), T, SMALL["nz"],
        jax.random.PRNGKey(_KEY), compute_dtype=dtype))


def _port_sample(g1, g2, dtype):
    """The port's 4-step sample with the JAX scan's noise replayed: its
    per-step splits ``k, kz, kp = jax.random.split(k, 3)``."""
    conds, x_init = _sample_inputs()
    noise, k = [], jax.random.PRNGKey(_KEY)
    for _ in range(T):
        k, kz, kp = jax.random.split(k, 3)
        z = jax.random.normal(kz, (B, SMALL["nz"]), dtype=jnp.float32)
        eps = jax.random.normal(kp, x_init.shape, dtype=jnp.float32)
        noise.append((torch.from_numpy(np.array(z)), torch.from_numpy(np.array(eps))))
    post_t = schedule.PosteriorCoefficients.create(T, 0.1, 20.0).as_tensors("cpu")
    with torch.inference_mode():
        return sampling.sample_from_model(
            post_t, g1, g2, *map(torch.from_numpy, conds), torch.from_numpy(x_init),
            T, SMALL["nz"], noise=noise, compute_dtype=dtype).numpy()


def test_four_step_sampler_matches_jax_with_replayed_noise():
    (_, _, g1), (_, _, g2) = _models()
    ref = _jax_sample(jnp.float32)
    ours = _port_sample(g1, g2, torch.float32)
    assert ref.std() > 1e-2
    np.testing.assert_allclose(ours, ref, atol=1e-3, rtol=1e-3)


def test_bf16_serving_sampler_is_as_close_to_fp32_as_jax_bf16(monkeypatch):
    """The serving mode: bf16 generators, bf16-score attention.  The two
    packages round to bf16 at different places, so neither sample equals
    the other; the port's must stay as close to the fp32 sample as the
    JAX package's own bf16 sample is (measured 0.83x of it; 1.5x
    allowed).  A wrong cast or score formula is off by far more."""
    ports = []
    for adaptive, (_, params, _) in zip((False, True), _models()):
        g = NCSNppGenerator(MuDiffConfig(**SMALL), adaptive=adaptive, attn="bf16",
                            dtype=torch.bfloat16).eval()
        g.load_state_dict(params_from_flax(params), strict=True)
        ports.append(g)
    monkeypatch.delenv("MUDIFF_ATTN", raising=False)
    ref32 = _jax_sample(jnp.float32)  # exact fp32 scores
    monkeypatch.setenv("MUDIFF_ATTN", "bf16")  # read while the JAX model traces
    jax_err = np.abs(_jax_sample(jnp.bfloat16) - ref32).max()
    port_err = np.abs(_port_sample(*ports, torch.bfloat16) - ref32).max()
    assert 1e-3 < jax_err < 0.2, jax_err  # bf16 rounding shows, and is small
    assert port_err <= 1.5 * jax_err, (port_err, jax_err)


def test_cpu_sampler_is_seeded_and_finite():
    """build_sampler on an explicit CPU device: the plain versions run,
    and the same torch.Generator seed gives the same sample."""
    cfg = MuDiffConfig(**SMALL)
    s = build_sampler(cfg, device="cpu", attn="einsum", compute_dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0))
    c = torch.randn(B, 16, 16, 1, generator=torch.Generator().manual_seed(1))
    a = s(c, c, c, generator=torch.Generator().manual_seed(2))
    b = s(c, c, c, generator=torch.Generator().manual_seed(2))
    assert a.shape == (B, 16, 16, 1) and a.dtype == torch.float32
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert s.kernel_launches_per_sample()["conv3x3"] == T * (
        s.g1.kernel_launches_per_forward()["conv3x3"]
        + s.g2.kernel_launches_per_forward()["conv3x3"])
    with pytest.raises(ValueError, match="pairs"):
        sampling.sample_from_model(s.post, s.g1, s.g2, c, c, c, c, T, SMALL["nz"], noise=[])
