"""The backward passes of the port's kernel wrappers vs the JAX package, on the CPU.

Every wrapper is a ``torch.autograd.Function``; on CPU tensors its
forward and backward take the plain versions, so these tests exercise
the backward wiring itself (the flipped weight of K1's dx, the gains of
the FIR adjoints, K3's recomputation from the row statistics) against
``jax.grad`` of the JAX package's functions (the Pallas conv in
interpret mode, as the JAX tests run it).  fp32; tolerances: K1 1e-4
(``test_pallas_conv.py``), K2 1e-4 (``test_pallas_fir.py``'s order),
K3 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudiff_tpu import ops as jops
from mudiff_tpu.ops.pallas_conv import conv3x3_gemm
from mudiff_torch import ops

K = (1, 3, 3, 1)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


@pytest.mark.parametrize("shape", [(2, 8, 8, 4, 5), (1, 6, 10, 3, 8)])
def test_conv3x3_grads_match_pallas_gemm(shape):
    n, h, w, ci, co = shape
    rng = np.random.RandomState(0)
    x, r = rng.randn(n, h, w, ci).astype(np.float32), rng.randn(n, h, w, co).astype(np.float32)
    k = (rng.randn(3, 3, ci, co) * 0.2).astype(np.float32)
    b = (rng.randn(co) * 0.1).astype(np.float32)
    loss = lambda x_, k_, b_: jnp.sum(conv3x3_gemm(x_, k_, b_) * r)  # noqa: E731
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, k, b)))
    xt, kt, bt = _t(x, True), _t(k, True), _t(b, True)
    log = []
    with ops.record_calls(log):
        (ops.conv3x3(xt, kt, bt) * _t(r)).sum().backward()
    for got, ref in zip((xt.grad, kt.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert bt.grad.dtype == torch.float32
    # the input gradient is K1 again, on (B, H, W, Cout) -> Cin
    assert log == [("conv3x3", ((n, h, w, ci), co, torch.float32)),
                   ("conv3x3", ((n, h, w, co), ci, torch.float32))]


@pytest.mark.parametrize("name", ["fir_down2", "fir_up2"])
def test_fir_first_grads_match_jax(name):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 10, 3).astype(np.float32)
    jfn = (lambda a: jops.downsample_2d(a, K, factor=2)) if name == "fir_down2" else (
        lambda a: jops.upsample_2d(a, K, factor=2))
    out_shape = jfn(jnp.asarray(x)).shape
    r = rng.randn(*out_shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jfn(a) * r))(jnp.asarray(x))
    xt = _t(x, True)
    log = []
    with ops.record_calls(log):
        (getattr(ops, name)(xt, K) * _t(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    other = "fir_up2" if name == "fir_down2" else "fir_down2"
    assert [n for n, _ in log] == [name, other]


@pytest.mark.parametrize("name", ["fir_down2", "fir_up2"])
def test_fir_grad_of_grad_matches_jax(name):
    """The R1 shape of computation: d/dx ||d/dx sum(tanh(f(x)) * r)||^2."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 2).astype(np.float32)
    jfn = (lambda a: jops.downsample_2d(a, K, factor=2)) if name == "fir_down2" else (
        lambda a: jops.upsample_2d(a, K, factor=2))
    r = rng.randn(*jfn(jnp.asarray(x)).shape).astype(np.float32)
    inner = lambda a: jnp.sum(jnp.tanh(jfn(a)) * r)  # noqa: E731
    want = jax.grad(lambda a: jnp.sum(jax.grad(inner)(a) ** 2))(jnp.asarray(x))
    xt = _t(x, True)
    log = []
    with ops.record_calls(log):
        (gx,) = torch.autograd.grad((torch.tanh(getattr(ops, name)(xt, K)) * _t(r)).sum(),
                                    xt, create_graph=True)
        (gxx,) = torch.autograd.grad((gx ** 2).sum(), xt)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3
    np.testing.assert_allclose(gxx.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    # forward, its adjoint, and both again in the second backward
    assert sorted(n for n, _ in log) == sorted([name, name] + ["fir_up2" if name ==
                                               "fir_down2" else "fir_down2"] * 2)


def _einsum_attention(q, k, v, scale):
    """``mudiff_tpu/nn/blocks.py:226-233`` in fp32."""
    s = jnp.einsum("bqc,bkc->bqk", q, k, preferred_element_type=jnp.float32) * scale
    w = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bqk,bkc->bqc", w, v, preferred_element_type=jnp.float32)


@pytest.mark.parametrize("shape", [(2, 64, 32), (2, 37, 16), (1, 24, 512)],
                         ids=["square", "ragged", "c512"])
def test_flash_attn_grads_match_jax_einsum(shape):
    rng = np.random.RandomState(3)
    q = (2.0 * rng.randn(*shape)).astype(np.float32)
    k, v, r = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    scale = shape[-1] ** -0.5
    want = jax.grad(lambda *a: jnp.sum(_einsum_attention(*a, scale) * r), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    # the plain backward on its own, from the plain forward's statistics
    qt, kt, vt = _t(q), _t(k), _t(v)
    o = ops.flash_attn_plain(qt, kt, vt, scale)
    plain = ops.flash_attn_bwd_plain(qt, kt, vt, o, ops.row_stats_plain(qt, kt, scale),
                                     _t(r), scale)
    # and the Function
    qg, kg, vg = _t(q, True), _t(k, True), _t(v, True)
    log = []
    with ops.record_calls(log):
        (ops.flash_attn(qg, kg, vg, scale) * _t(r)).sum().backward()
    for got_plain, got, ref in zip(plain, (qg.grad, kg.grad, vg.grad), want):
        ref = np.asarray(ref)
        assert float(np.abs(ref).max()) > 1e-2
        np.testing.assert_allclose(got_plain.numpy(), ref, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert [n for n, _ in log] == ["flash_attn", "flash_attn_bwd_dkv", "flash_attn_bwd_dq"]


def test_row_stats_are_the_softmax_normalisers():
    rng = np.random.RandomState(4)
    q, k = (_t(rng.randn(2, 20, 8).astype(np.float32)) for _ in range(2))
    stats = ops.row_stats_plain(q, k, 0.5)
    s = torch.matmul(q, k.transpose(1, 2)) * 0.5
    torch.testing.assert_close(stats[0], s.amax(-1))
    torch.testing.assert_close(torch.exp(s - stats[0][..., None]) / stats[1][..., None],
                               torch.softmax(s, -1))


def test_second_backward_raises_through_k1_and_k3_and_runs_through_k2():
    rng = np.random.RandomState(5)
    x = _t(rng.randn(1, 6, 6, 4).astype(np.float32), True)
    w = _t(rng.randn(3, 3, 4, 4).astype(np.float32))
    q = _t(rng.randn(1, 16, 8).astype(np.float32), True)
    for out, inp in ((ops.conv3x3(x, w), x), (ops.flash_attn(q, q, q, 0.5), q)):
        (g,) = torch.autograd.grad(torch.tanh(out).sum(), inp, create_graph=True)
        with pytest.raises(RuntimeError, match="once_differentiable"):
            g.square().sum().backward()
    (g,) = torch.autograd.grad(torch.tanh(ops.fir_down2(x)).sum(), x, create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), x)
    assert bool(torch.isfinite(gg).all()) and float(gg.abs().max()) > 0


def test_backward_keeps_the_mode_of_its_forward():
    """A backward records and runs plain as its forward did, even when
    it runs outside the block (the autograd engine runs a CUDA backward
    on another thread, where the block's context is not set)."""
    x = torch.randn(1, 8, 8, 2, requires_grad=True)
    log = []
    with ops.record_calls(log), ops.plain_kernels():
        y = ops.fir_up2(ops.fir_down2(x))
    y.sum().backward()
    assert [n for n, _ in log] == ["fir_down2", "fir_up2", "fir_down2", "fir_up2"]
