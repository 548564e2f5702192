"""The layers and ops of the generator branches against the JAX package,
on the CPU: ``upsample_conv_2d``, ``FIRConv2d``'s up and plain variants,
the eight ``Upsample`` / ``Downsample`` variants, the stride-2
``Conv3x3``, the Fourier embedding, ``Combine``, the naive resamples, and
the four small public names (``fused_leaky_relu``, ``get_time_schedule``,
``uncer_loss``, ``get_act``).

Parameters are seeded and non-trivial (``random_flax_params``), carried by
``convert.params_from_flax`` and loaded strictly.  float32 within 1e-5;
bfloat16 within two bf16 ulps of the output's largest magnitude, except
where the port rounds exactly as flax does (the stride-2 conv: the conv
rounded to bf16, then a bf16 bias added).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudiff_torch import diffusion, nn as tnn, ops
from mudiff_torch.convert import params_from_flax
from mudiff_tpu import diffusion as jdiffusion
from mudiff_tpu import ops as jops
from mudiff_tpu.nn import blocks as jblocks
from mudiff_tpu.nn import layers as jlayers
from test_torch_port_helpers import random_flax_params

BF16_ULP = 2.0 ** -7  # relative spacing of bf16 at the top of a binade


def _np(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _flax(module, x, seed=0):
    params = random_flax_params(module, x, seed=seed)
    return params, np.asarray(jax.jit(module.apply)({"params": params}, x), np.float32)


def _port(module, params):
    module.load_state_dict(params_from_flax(params), strict=True)
    return module.eval()


def _run(module, x):
    with torch.inference_mode():
        return module(x).float().numpy()


def _close(got, want, bf16=False):
    assert np.std(want) > 1e-2, "reference output is near constant"
    if bf16:
        np.testing.assert_allclose(got, want, atol=2 * BF16_ULP * np.abs(want).max(), rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", [((2, 7, 7, 3), 5), ((2, 8, 6, 4), 6)],
                         ids=["odd", "even"])
def test_upsample_conv_2d_matches_jax(shape, cout, dtype):
    x, w = _np(*shape), _np(3, 3, shape[-1], cout, seed=2) / 3.0
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jops.upsample_conv_2d(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                            k=(1, 3, 3, 1)), np.float32)
    got = ops.upsample_conv_2d(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                               k=(1, 3, 3, 1))
    assert got.dtype == tdt and got.shape == (shape[0], 2 * shape[1], 2 * shape[2], cout)
    _close(got.float().numpy(), want, bf16=dtype == "bfloat16")


@pytest.mark.parametrize("variant", ["up", "plain"])
def test_fir_conv2d_up_and_plain_match_flax(variant):
    x = _np(2, 8, 8, 3)
    p, want = _flax(jblocks.FIRConv2d(5, up=variant == "up"), jnp.asarray(x))
    got = _run(_port(tnn.FIRConv2d(3, 5, up=variant == "up"), p), torch.from_numpy(x))
    assert got.shape == ((2, 16, 16, 5) if variant == "up" else (2, 8, 8, 5))
    _close(got, want)


@pytest.mark.parametrize("with_conv", [True, False], ids=["conv", "no_conv"])
@pytest.mark.parametrize("fir", [True, False], ids=["fir", "naive"])
@pytest.mark.parametrize("direction", ["up", "down"])
def test_resample_variants_match_flax(direction, fir, with_conv):
    """All eight: FIR without a conv on K2a/K2b's plain versions, FIR with
    one through ``FIRConv2d``, nearest / box mean, and nearest + 3x3 conv
    / (0, 1) pad + stride-2 conv."""
    x = _np(2, 8, 8, 3)
    jcls, tcls = ((jblocks.Upsample, tnn.Upsample) if direction == "up"
                  else (jblocks.Downsample, tnn.Downsample))
    m = jcls(features=5 if with_conv else None, with_conv=with_conv, fir=fir)
    if with_conv:
        p, want = _flax(m, jnp.asarray(x))
    else:
        p, want = {}, np.asarray(m.apply({}, jnp.asarray(x)), np.float32)
    port = _port(tcls(3, 5 if with_conv else None, with_conv=with_conv, fir=fir), p)
    log = []
    with ops.record_calls(log):
        got = _run(port, torch.from_numpy(x))
    side = 16 if direction == "up" else 4
    assert got.shape == (2, side, side, 5 if with_conv else 3)
    _close(got, want)
    want_calls = [k for k, v in port.fir_launches().items() for _ in range(v)]
    conv = getattr(port, "Conv_0", None)
    want_calls += ["conv3x3"] if conv is not None and conv.on_kernels else []  # nearest + K1
    assert [n for n, _ in log] == want_calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stride2_conv3x3_rounds_as_flax_nn_conv(dtype):
    x = _np(2, 9, 9, 6)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    m = jlayers.Conv3x3(8, stride=2, padding=0, dtype=jdt)
    p, want = _flax(m, jnp.asarray(x, jdt))
    port = _port(tnn.Conv3x3(6, 8, stride=2, padding=0, dtype=tdt), p)
    assert not port.on_kernels
    log = []
    with ops.record_calls(log):
        got = _run(port, torch.from_numpy(x).to(tdt))
    assert got.shape == want.shape == (2, 4, 4, 8) and not log  # neither K1 nor K4
    if dtype == "float32":
        _close(got, want)
    else:  # the conv rounded to bf16, a bf16 bias added: one rounding apart at most
        np.testing.assert_allclose(got, want, atol=BF16_ULP * np.abs(want).max(), rtol=0)


def test_fourier_projection_combine_and_naive_resamples_match_flax():
    t = np.array([1.0, 2.5, 7.0], np.float32)
    m = jblocks.GaussianFourierProjection(embedding_size=6, scale=16.0)
    p = random_flax_params(m, jnp.asarray(t), seed=3)
    want = np.asarray(m.apply({"params": p}, jnp.asarray(t)))
    port = _port(tnn.GaussianFourierProjection(6, 16.0), p)
    np.testing.assert_allclose(_run(port, torch.from_numpy(t)), want, atol=1e-4, rtol=1e-5)
    assert port.W.requires_grad and port(torch.from_numpy(t)).grad_fn is None  # read detached

    x, y = _np(2, 4, 4, 1), _np(2, 4, 4, 6, seed=2)
    for method in ("cat", "sum"):
        m = jblocks.Combine(features=6, method=method)
        p = random_flax_params(m, jnp.asarray(x), jnp.asarray(y), seed=4)
        want = np.asarray(m.apply({"params": p}, jnp.asarray(x), jnp.asarray(y)))
        port = _port(tnn.Combine(1, 6, method=method), p)
        with torch.inference_mode():
            got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        assert got.shape == ((2, 4, 4, 12) if method == "cat" else (2, 4, 4, 6))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="not recognized"):
        tnn.Combine(1, 6, method="mean")

    z = _np(2, 6, 4, 3)
    np.testing.assert_array_equal(
        tnn.naive_upsample_2d(torch.from_numpy(z)).numpy(),
        np.asarray(jblocks.naive_upsample_2d(jnp.asarray(z))))
    np.testing.assert_allclose(
        tnn.naive_downsample_2d(torch.from_numpy(z)).numpy(),
        np.asarray(jblocks.naive_downsample_2d(jnp.asarray(z))), atol=1e-6)
    np.testing.assert_allclose(
        tnn.PlainGroupNorm()(torch.from_numpy(_np(2, 4, 4, 8))).numpy(),
        np.asarray(jblocks.PlainGroupNorm().apply({}, jnp.asarray(_np(2, 4, 4, 8)))),
        atol=1e-5)


def test_fir_kernels_refuse_an_asymmetric_kernel():
    x = torch.from_numpy(_np(1, 8, 8, 2))
    for fn in (ops.fir_down2, ops.fir_up2):
        with pytest.raises(ValueError, match="symmetric"):
            fn(x, (1, 2, 3, 4))
    with pytest.raises(ValueError, match="symmetric"):
        tnn.Downsample(2, with_conv=False, fir=True, fir_kernel=(1, 2, 3, 4))(x)


@pytest.mark.parametrize("name", ["elu", "relu", "lrelu", "swish", "silu"])
def test_get_act_matches_jax(name):
    x = _np(3, 7) * 3
    np.testing.assert_allclose(tnn.get_act(name)(torch.from_numpy(x)).numpy(),
                               np.asarray(jlayers.get_act(name)(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


def test_get_act_refuses_an_unknown_name():
    with pytest.raises(NotImplementedError, match="gelu"):
        tnn.get_act("gelu")


@pytest.mark.parametrize("bias", [True, False])
def test_fused_leaky_relu_matches_jax(bias):
    x, b = _np(2, 3, 3, 4), _np(4, seed=2)
    want = jops.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b) if bias else None)
    got = ops.fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b) if bias else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_time_schedule_and_uncer_loss_match_jax():
    for n in (1, 4, 10):
        np.testing.assert_array_equal(diffusion.get_time_schedule(n),
                                      jdiffusion.get_time_schedule(n))
    mean, var, label = _np(2, 5, 5, 1), _np(2, 5, 5, 1, seed=2), _np(2, 5, 5, 1, seed=3)
    want = float(jdiffusion.uncer_loss(*map(jnp.asarray, (mean, var, label))))
    got = float(diffusion.uncer_loss(*map(torch.from_numpy, (mean, var, label))))
    np.testing.assert_allclose(got, want, rtol=1e-6)
