"""mudiff_torch ops vs the JAX package, on the CPU.

The port's conv and FIR wrappers take their plain PyTorch versions on
CPU tensors; these tests hold those plain versions against the JAX
package's Pallas kernels (interpret mode, which the JAX package picks by
itself on the CPU) and XLA lowerings, at the JAX tests' tolerances
(``test_pallas_conv.py``: 1e-4, ``test_pallas_fir.py``: 1e-5).  The CUDA
kernels themselves run only on the card; ``chip_smoke.py`` holds them
against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudiff_tpu import ops as jops
from mudiff_tpu.ops import pallas_fir
from mudiff_tpu.ops.pallas_conv import conv3x3_gemm, conv3x3_xla
from mudiff_torch import ops
from mudiff_torch.ops import _dispatch
from mudiff_torch.ops.fir import correlation_taps

K = (1, 3, 3, 1)

CONV_SHAPES = [
    # (N, H, W, Cin, Cout)
    (2, 16, 16, 32, 32),
    (1, 8, 8, 24, 8),
    (3, 8, 24, 8, 16),
    (1, 12, 10, 5, 7),
]


def _conv_data(shape, seed=0):
    n, h, w, ci, co = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, ci).astype(np.float32)
    k = (rng.randn(3, 3, ci, co) * 0.1).astype(np.float32)
    b = (rng.randn(co) * 0.1).astype(np.float32)
    return x, k, b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("mode", ["dxn", "dxk"])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv3x3_matches_pallas_gemm(shape, mode):
    x, k, b = _conv_data(shape)
    ref = np.asarray(conv3x3_gemm(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), mode=mode))
    ours = ops.conv3x3(_t(x), _t(k), _t(b)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize(
    "shape",
    [(2, 9, 11, 4, 64), (1, 8, 8, 5, 80), (2, 16, 16, 64, 1), (1, 7, 5, 3, 1)],
)
def test_conv3x3_odd_channels_match_xla(shape):
    """The stems' Cin = 4, 5 and the head's Cout = 1."""
    x, k, b = _conv_data(shape, seed=1)
    ref = np.asarray(conv3x3_xla(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    ours = ops.conv3x3(_t(x), _t(k), _t(b)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


def test_conv3x3_without_bias_and_in_bf16():
    x, k, _ = _conv_data((2, 8, 8, 16, 8), seed=2)
    ref = np.asarray(conv3x3_xla(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(ops.conv3x3(_t(x), _t(k)).numpy(), ref,
                               atol=1e-4, rtol=1e-4)
    xb, kb = _t(x).to(torch.bfloat16), _t(k).to(torch.bfloat16)
    out = ops.conv3x3(xb, kb)
    assert out.dtype == torch.bfloat16
    # fp32 accumulation of bf16 products, rounded once to bf16
    exact = ops.conv3x3(xb.float(), kb.float())
    np.testing.assert_allclose(out.float().numpy(), exact.numpy(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize(
    "shape", [(2, 16, 16, 128), (1, 64, 64, 16), (2, 30, 30, 32), (1, 10, 14, 3)]
)
def test_fir_down2_matches_pallas(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ref = np.asarray(pallas_fir.downsample_2d_pallas(jnp.asarray(x), K))
    np.testing.assert_allclose(ops.fir_down2(_t(x), K).numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 16, 128), (2, 30, 30, 32), (1, 7, 5, 3)])
def test_fir_up2_matches_pallas(shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    ref = np.asarray(pallas_fir.upsample_2d_pallas(jnp.asarray(x), K))
    np.testing.assert_allclose(ops.fir_up2(_t(x), K).numpy(), ref, atol=1e-5)


def _down2_as_kernel(x, taps):
    """The per-output reference order of K2a, in numpy: each output sums
    its in-image taps from 0, p outer and q inner, as every thread of
    csrc/fir_kernels.cu fir_down2_kernel does for each output it owns
    (test_torch_port_fir_tiling.py holds its replay to these bits)."""
    n, h, w, c = x.shape
    oh, ow = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    out = np.zeros((n, oh, ow, c), np.float32)
    for i in range(oh):
        for j in range(ow):
            for p in range(4):
                for q in range(4):
                    y, xx = 2 * i + p - 1, 2 * j + q - 1
                    if 0 <= y < h and 0 <= xx < w:
                        out[:, i, j] += taps[p, q] * x[:, y, xx]
    return out


def _up2_as_kernel(x, taps):
    """The per-output reference order of K2b, in numpy: each output of
    parity (py, px) sums its 2x2 in-image taps from 0, a outer and b
    inner, as every thread of csrc/fir_kernels.cu fir_up2_kernel does for
    each output of its quads (test_torch_port_fir_tiling.py holds its
    replay to these bits)."""
    n, h, w, c = x.shape
    out = np.zeros((n, 2 * h, 2 * w, c), np.float32)
    for oy in range(2 * h):
        for ox in range(2 * w):
            py, px = oy & 1, ox & 1
            y0, x0 = (oy >> 1) - 1 + py, (ox >> 1) - 1 + px
            for a in range(2):
                for b in range(2):
                    y, xx = y0 + a, x0 + b
                    if 0 <= y < h and 0 <= xx < w:
                        out[:, oy, ox] += taps[py + 2 * a, px + 2 * b] * x[:, y, xx]
    return out


@pytest.mark.parametrize("k", [(1, 3, 3, 1), (1, 2, 5, 1)])
def test_fir_kernel_index_math_matches_plain(k):
    """The taps the wrappers hand the CUDA kernels, summed in the
    kernels' per-output order, give the plain versions' results; an
    asymmetric kernel catches a missing flip."""
    x = np.random.RandomState(2).randn(2, 7, 10, 3).astype(np.float32)
    down = _down2_as_kernel(x, correlation_taps(k, 1.0))
    up = _up2_as_kernel(x, correlation_taps(k, 4.0))
    np.testing.assert_allclose(down, ops.downsample_2d(_t(x), k, 2).numpy(), atol=1e-5)
    np.testing.assert_allclose(up, ops.upsample_2d(_t(x), k, 2).numpy(), atol=1e-5)


@pytest.mark.parametrize(
    "up,down,pad",
    [(1, 1, (-1, -2)), (2, 1, (1, -1)), (1, 2, (-1, 2)), (3, 2, (2, 0)), (1, 1, (2, 2))],
)
def test_upfirdn2d_matches_jax(up, down, pad):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 11, 3).astype(np.float32)
    kern = rng.randn(4, 3).astype(np.float32)  # non-square, asymmetric
    ref = np.asarray(jops.upfirdn2d(jnp.asarray(x), kern, up=up, down=down, pad=pad))
    ours = ops.upfirdn2d(_t(x), kern, up=up, down=down, pad=pad).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("factor,k", [(2, (1, 3, 3, 1)), (2, None), (4, (1, 2, 3, 2, 1))])
def test_up_and_downsample_2d_match_jax(factor, k):
    x = np.random.RandomState(4).randn(1, 12, 8, 5).astype(np.float32)
    kk = None if k is None else list(k)
    np.testing.assert_allclose(
        ops.upsample_2d(_t(x), kk, factor).numpy(),
        np.asarray(jops.upsample_2d(jnp.asarray(x), kk, factor)), atol=1e-5)
    np.testing.assert_allclose(
        ops.downsample_2d(_t(x), kk, factor).numpy(),
        np.asarray(jops.downsample_2d(jnp.asarray(x), kk, factor)), atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 16, 1, 8), (1, 10, 14, 8, 16)])
def test_conv_downsample_2d_matches_jax(shape):
    """The pyramid's FIRConv2d(down=True): FIR pad (2,2), stride-2 conv."""
    n, h, w, ci, co = shape
    rng = np.random.RandomState(5)
    x = rng.randn(n, h, w, ci).astype(np.float32)
    wk = (rng.randn(3, 3, ci, co) * 0.2).astype(np.float32)
    ref = np.asarray(jops.conv_downsample_2d(jnp.asarray(x), jnp.asarray(wk), k=list(K)))
    ours = ops.conv_downsample_2d(_t(x), _t(wk), k=K).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_wrappers_count_only_kernel_launches_and_record_calls():
    ops.reset_launch_counts()
    x = torch.randn(1, 8, 8, 4)
    log = []
    with ops.record_calls(log):
        ops.conv3x3(x, torch.randn(3, 3, 4, 2))
        ops.fir_down2(x)
        ops.fir_up2(x)
        q = x.reshape(1, 64, 4)
        ops.flash_attn(q, q, q, 0.5)
        ops.int8_conv3x3(x, torch.randn(3, 3, 4, 2), None, compute_dtype=torch.float32)
        ops.group_norm_act(x, 2, x.dtype, silu=True)
    # CPU tensors take the plain versions: no kernel launched
    assert ops.launch_counts() == {"conv3x3": 0, "fir_down2": 0, "fir_up2": 0, "flash_attn": 0,
                                   "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0,
                                   "int8_conv3x3": 0, "group_norm_act": 0}
    assert [name for name, _ in log] == ["conv3x3", "fir_down2", "fir_up2", "flash_attn",
                                         "int8_conv3x3", "group_norm_act"]


def test_dispatch_refuses_devices_without_a_kernel():
    x = torch.empty(1, 4, 4, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        _dispatch.use_kernel("conv3x3", (), x)
    with pytest.raises(ValueError, match="mixed devices"):
        _dispatch.use_kernel("conv3x3", (), torch.zeros(1), x)
