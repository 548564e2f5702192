"""``DiscriminatorSmall`` and ``DiscriminatorImgLarge`` against the JAX
package, on the CPU.

Seeded non-trivial weights (``random_flax_params``) carried by
``convert.params_from_flax`` and loaded strictly; the logits in fp32 within
1e-5, and the R1 penalty's gradient (a gradient of a gradient: through
K2a's plain version and its adjoint, twice) within 1e-4 of each tensor's
largest magnitude.  Parameter counts at DDGAN's widths against the JAX
modules', from ``jax.eval_shape`` and the meta device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudiff_torch import ops
from mudiff_torch.convert import params_from_flax
from mudiff_torch.models import DiscriminatorImgLarge, DiscriminatorSmall
from mudiff_tpu.models import critic as jcritic
from test_torch_port_helpers import random_flax_params

CASES = {  # name: (JAX class, port class, image side, channels, downsampling blocks)
    "small": (jcritic.DiscriminatorSmall, DiscriminatorSmall, 32, 3, 3),
    "img_large": (jcritic.DiscriminatorImgLarge, DiscriminatorImgLarge, 64, 1, 6),
}
B = 4


def _inputs(side, c):
    rng = np.random.RandomState(side)
    x, xt = (rng.randn(B, side, side, c).astype(np.float32) for _ in range(2))
    return x, np.array([0, 1, 2, 3], np.int32), xt


def _pair(name):
    jcls, tcls, side, c, _ = CASES[name]
    x, t, xt = _inputs(side, c)
    m = jcls(ngf=8, t_emb_dim=16)
    params = random_flax_params(m, jnp.asarray(x), jnp.asarray(t), jnp.asarray(xt), seed=5)
    port = tcls(ngf=8, t_emb_dim=16, num_channels=c)
    port.load_state_dict(params_from_flax(params), strict=True)
    return m, params, port, (x, t, xt)


@pytest.mark.parametrize("name", sorted(CASES))
def test_critic_forward_matches_jax(name):
    m, params, port, (x, t, xt) = _pair(name)
    want = np.asarray(jax.jit(m.apply)({"params": params}, *map(jnp.asarray, (x, t, xt))))
    log = []
    with torch.no_grad(), ops.record_calls(log):
        got = port(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(xt))
    assert got.shape == want.shape == ((B, 1) if name == "small" else (B,))
    assert want.std() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    n = 2 * CASES[name][4]
    assert port.kernel_launches_per_forward() == {"fir_down2": n}
    assert [k for k, _ in log] == ["fir_down2"] * n


@pytest.mark.parametrize("name", sorted(CASES))
def test_r1_penalty_gradient_matches_jax(name):
    """d/dparams of mean ||d sum D(x) / dx||^2, as the D step's R1."""
    m, params, port, (x, t, xt) = _pair(name)

    def penalty(p):
        gx = jax.grad(lambda xx: m.apply({"params": p}, xx, jnp.asarray(t),
                                         jnp.asarray(xt)).sum())(jnp.asarray(x))
        return jnp.mean(jnp.sum(gx.reshape(B, -1) ** 2, axis=1))

    want_val, want = jax.jit(jax.value_and_grad(penalty))(params)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, want))
    xs = torch.from_numpy(x).requires_grad_(True)
    log = []
    with ops.record_calls(log):
        (gx,) = torch.autograd.grad(port(xs, torch.from_numpy(t).long(),
                                         torch.from_numpy(xt)).sum(), xs, create_graph=True)
        val = gx.reshape(B, -1).square().sum(dim=1).mean()
        grads = dict(zip([n for n, _ in port.named_parameters()],
                         torch.autograd.grad(val, list(port.parameters()), allow_unused=True)))
    np.testing.assert_allclose(float(val.detach()), float(want_val), rtol=1e-5)
    # K2a forward; K2b in the backward to x; the second backward transposes
    # both again: K2a for those K2b, K2b for the forward's K2a
    n = 2 * CASES[name][4]
    assert sum(k == "fir_down2" for k, _ in log) == sum(k == "fir_up2" for k, _ in log) == 2 * n
    for k, w in want.items():
        g = grads[k]
        g = torch.zeros_like(w) if g is None else g
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4 * scale + 1e-9, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_critic_parameter_count_is_the_jax_one(name):
    """At DDGAN's CIFAR-10 width for the small critic (ngf 64, 32², three
    channels) and at the recipe's ngf 64 (256², one channel) for the
    image-only large one."""
    jcls, tcls, _, c, _ = CASES[name]
    side = 32 if name == "small" else 256
    x = jnp.zeros((1, side, side, c))
    t = jnp.zeros((1,), jnp.int32)
    shapes = jax.eval_shape(jcls(ngf=64, t_emb_dim=256).init, jax.random.PRNGKey(0), x, t, x)
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        port = tcls(ngf=64, t_emb_dim=256, num_channels=c, device="meta")
    assert sum(p.numel() for p in port.parameters()) == want
