"""The generator branches in the converter and the training program,
against the JAX package, on the CPU.

* The converter is strict both ways on every branch tree: each JAX
  generator's parameter tree (``jax.eval_shape``) maps onto the port's
  ``state_dict`` with no leaf left over and none missing.
* ``content_from_flax`` carries a Fourier generator's train state, the
  frozen ``fourier_emb/W`` and its zero Adam moments included, and the
  restored state takes the JAX state's next update.
* ``create_train_state`` and one D (R1) + G iteration on a branch
  configuration (ddpm resblocks with FIR resampling) give the JAX step's
  losses and gradients, at ``tests/test_torch_port_train.py``'s tolerances;
  on B1 and B3 every wrapper call of an iteration is one
  ``kernel_launches_per_iteration`` counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mudiff_torch import config, ops
from mudiff_torch.convert import content_from_flax, params_from_flax, train_state_from_flax
from mudiff_torch.models import NCSNppGenerator
from mudiff_torch.train import checkpoint as ckpt
from mudiff_torch.train import (
    create_train_state,
    d_loss_and_grads,
    g_loss_and_grads,
    make_train_step,
)
from mudiff_tpu import config as jconfig
from mudiff_tpu.diffusion import DiffusionCoefficients as JaxCoeff
from mudiff_tpu.diffusion import PosteriorCoefficients as JaxPost
from mudiff_tpu.models import NCSNppGenerator as JaxGenerator
from mudiff_tpu.models import critic as jcritic
from mudiff_tpu.train import state as jstate_mod
from mudiff_tpu.train import create_train_state as jax_create_train_state
from mudiff_tpu.train.steps import make_d_step as jax_make_d_step
from mudiff_tpu.train.steps import make_g_step as jax_make_g_step
from test_torch_port_helpers import BRANCH_SMALL, random_flax_params
from test_torch_port_train import (
    TINY,
    _batch,
    _check_grads,
    _check_losses,
    _grad_keeper,
    _jax_draws,
)

TREES = {
    "ddpm": (dict(resblock_type="ddpm"), 3),
    "ddpm_naive": (dict(resblock_type="ddpm", fir=False), 3),
    "oneadagn": (dict(resblock_type="biggan_oneadagn", fir=False), 3),
    "pyramids": (dict(progressive="output_skip", progressive_input="input_skip"), 3),
    "residual_cat": (dict(progressive="residual", progressive_input="input_skip",
                          progressive_combine="cat"), 3),
    "fourier": (dict(embedding_type="fourier"), 3),
    "channels3": (dict(num_channels=3), 3),
    "two_conditions": (dict(), 2),
}


@pytest.mark.parametrize("case", sorted(TREES))
def test_converter_is_strict_both_ways_on_each_branch_tree(case):
    over, nc = TREES[case]
    cfg = {**BRANCH_SMALL, **over}
    s, c = cfg["image_size"], cfg["num_channels"]
    x = jnp.zeros((1, s, s, c))
    conds = [x] * nc + [None] * (3 - nc)
    t, z = jnp.ones((1,), jnp.int32), jnp.zeros((1, cfg["nz"]))
    for adaptive in (False, True):
        m = JaxGenerator(config=jconfig.MuDiffConfig(**cfg), adaptive=adaptive,
                         num_conditions=nc)
        kw = dict(pseudo_target=x) if adaptive else {}
        shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), x, *conds, t, z, **kw)
        tree = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                      shapes["params"])
        state = params_from_flax(tree)
        port = NCSNppGenerator(config.MuDiffConfig(**cfg), adaptive=adaptive,
                               num_conditions=nc)
        want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in state.items()} == want
        port.load_state_dict(state, strict=True)


FOURIER = dict(TINY, embedding_type="fourier", resblock_type="ddpm", num_timesteps=2,
               num_epoch=3)


def test_content_from_flax_carries_a_fourier_train_state():
    """Two optax Adam updates of the JAX package's recipe (its cosine
    schedule; the frozen W's gradient is 0, as ``jax.grad`` gives under
    ``stop_gradient``), a content payload, then one more update in both
    packages on the same gradients."""
    cfg = jconfig.MuDiffConfig(**FOURIER)
    s = cfg.image_size
    x, t, z = jnp.zeros((1, s, s, 1)), jnp.ones((1,), jnp.int32), jnp.zeros((1, cfg.nz))
    params = {"g1": random_flax_params(JaxGenerator(config=cfg), x, x, x, x, t, z, seed=1),
              "g2": random_flax_params(JaxGenerator(config=cfg, adaptive=True), x, x, x, x,
                                       t, z, pseudo_target=x, seed=2),
              "d": random_flax_params(jcritic.DiscriminatorLarge(ngf=cfg.ngf,
                                                                 t_emb_dim=cfg.t_emb_dim),
                                      x, t, x, seed=3)}
    lr = {"g1": cfg.lr_g, "g2": cfg.lr_g, "d": cfg.lr_d}
    tx = {k: optax.adam(jstate_mod.cosine_epoch_schedule(lr[k], cfg.num_epoch, 2),
                        b1=cfg.beta1, b2=cfg.beta2) for k in params}
    opt = {k: tx[k].init(p) for k, p in params.items()}
    rng = np.random.RandomState(3)

    def draw(tree):
        def leaf(path, a):
            if str(getattr(path[-1], "key", "")) == "W" and a.ndim == 1:
                return np.zeros(a.shape, np.float32)
            return rng.randn(*a.shape).astype(np.float32)
        return jax.tree_util.tree_map_with_path(leaf, tree)

    def adam_step(k):
        def step(p, o, g):
            u, o = tx[k].update(g, o, p)
            return optax.apply_updates(p, u), o
        return jax.jit(step)

    steps = {k: adam_step(k) for k in params}

    def update(k, grads):
        params[k], opt[k] = steps[k](params[k], opt[k], grads)

    for _ in range(2):
        for k in params:
            update(k, draw(params[k]))
    c = cfg.ngf * 8
    payload = jax.tree_util.tree_map(np.asarray, {
        "epoch": 1, "global_step": 2, "step": 2, "ema_g1": None, "ema_g2": None,
        "att_conv": {"w": rng.randn(1, 1, c, 1).astype(np.float32), "b": np.zeros(1)},
        **{f"params_{k}": p for k, p in params.items()},
        **{f"opt_{k}": o for k, o in opt.items()}})
    content = content_from_flax(payload)
    w = content["opt_g1"]["state"]["fourier_emb.W"]
    assert not w["exp_avg"].any() and not w["exp_avg_sq"].any() and float(w["step"]) == 2.0

    port = create_train_state(config.MuDiffConfig(**FOURIER), seed=5, steps_per_epoch=2,
                              device="cpu")
    ckpt.load_payload(port, content)
    assert port.step == 2 and port.counts == {"g1": 2, "g2": 2, "d": 2}
    w_before = port.g1.fourier_emb.W.detach().clone()
    grads = {k: draw(p) for k, p in params.items()}
    for k in params:
        update(k, grads[k])
    as_list = {k: [params_from_flax(grads[k])[n] for n, _ in getattr(port, k).named_parameters()]
               for k in grads}
    port.apply_g_updates(as_list["g1"], as_list["g2"])
    port.apply_d_updates(as_list["d"])
    assert torch.equal(port.g1.fourier_emb.W, w_before)  # an update of 0 / (0 + eps)
    for k, tree in params.items():
        want = params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        for n, p in getattr(port, k).named_parameters():
            scale = max(float(want[n].abs().max()), 1.0)
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6 * scale,
                                       rtol=0, err_msg=f"{k}.{n}")


DDPM = dict(resblock_type="ddpm")


@pytest.fixture(scope="module")
def ddpm_ref():
    """The JAX D (R1) and G steps of a ddpm + FIR configuration from
    seeded non-trivial weights: losses and gradients."""
    cfg = jconfig.MuDiffConfig(**{**TINY, **DDPM})
    state, g1, g2, d = jax_create_train_state(cfg, jax.random.PRNGKey(0), steps_per_epoch=10)
    s = TINY["image_size"]
    x = jnp.zeros((1, s, s, 1), jnp.float32)
    t = jnp.zeros((1,), jnp.int32)
    z = jnp.zeros((1, cfg.nz), jnp.float32)
    keeper = _grad_keeper()
    state = state.replace(
        params_g1=random_flax_params(g1, x, x, x, x, t, z, seed=1),
        params_g2=random_flax_params(g2, x, x, x, x, t, z, pseudo_target=x, seed=2),
        params_d=random_flax_params(d, x, t, x, seed=3),
        tx_g1=keeper, tx_g2=keeper, tx_d=keeper)
    state = state.replace(opt_g1=keeper.init(state.params_g1),
                          opt_g2=keeper.init(state.params_g2),
                          opt_d=keeper.init(state.params_d))
    batch = tuple(map(jnp.asarray, _batch()))
    coeff, pos = JaxCoeff.from_config(cfg), JaxPost.from_config(cfg)
    d_step = jax_make_d_step(cfg, g1.apply, g2.apply, d.apply, coeff, pos)
    g_step = jax_make_g_step(cfg, g1.apply, g2.apply, d.apply, coeff, pos)
    kd, kg = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    out = {"state_np": jax.tree_util.tree_map(np.asarray, state),
           "draws": {"d": _jax_draws(kd, cfg), "g": _jax_draws(kg, cfg)}}
    s2, aux = d_step(state, batch, kd, with_r1=True)
    out["d"] = ({k: float(v) for k, v in aux.items()},
                params_from_flax(jax.tree_util.tree_map(np.asarray, s2.opt_d)))
    s2, aux = g_step(state, batch, kg)
    out["g"] = ({k: float(v) for k, v in aux.items()},
                [params_from_flax(jax.tree_util.tree_map(np.asarray, o))
                 for o in (s2.opt_g1, s2.opt_g2)])
    return out


def _ddpm_state(ref):
    state = create_train_state(config.MuDiffConfig(**{**TINY, **DDPM}), seed=0,
                               steps_per_epoch=10, device="cpu", attn="flash")
    state.load_flax(train_state_from_flax(ref["state_np"]))
    return state


def test_ddpm_d_step_matches_jax(ddpm_ref):
    state = _ddpm_state(ddpm_ref)
    grads, aux = d_loss_and_grads(state, [torch.from_numpy(a) for a in _batch()],
                                  ddpm_ref["draws"]["d"], True)
    want_aux, want_grads = ddpm_ref["d"]
    _check_losses(aux, want_aux)
    _check_grads(state.d, grads, want_grads)
    assert float(aux["R1"]) > 0.0


def test_ddpm_g_step_matches_jax(ddpm_ref):
    state = _ddpm_state(ddpm_ref)
    (grads_g1, grads_g2), aux = g_loss_and_grads(
        state, [torch.from_numpy(a) for a in _batch()], ddpm_ref["draws"]["g"])
    want_aux, (want_g1, want_g2) = ddpm_ref["g"]
    _check_losses(aux, want_aux)
    _check_grads(state.g1, grads_g1, want_g1)
    _check_grads(state.g2, grads_g2, want_g2)


ITERATION = {
    "B1": dict(resblock_type="biggan_oneadagn", progressive="output_skip",
               progressive_input="input_skip"),
    "B3": dict(resblock_type="ddpm", fir=False, num_channels=3),
}


@pytest.mark.parametrize("case", sorted(ITERATION))
def test_branch_iteration_calls_what_the_structure_says(case):
    """One D (R1) + G iteration: every wrapper call, forward and backward,
    is one the structure predicts (the input pyramid's K2a on x and the
    first stem convs of x and the conditions have no backward launch)."""
    cfg = config.MuDiffConfig(**{**TINY, **ITERATION[case]})
    state = create_train_state(cfg, seed=0, device="cpu", attn="flash")
    c = cfg.num_channels
    rng = np.random.RandomState(0)
    s = cfg.image_size
    batch = [torch.from_numpy((rng.randn(2, s, s, c) * 0.5).astype(np.float32))
             for _ in range(4)]
    log = []
    with ops.record_calls(log):
        metrics = make_train_step(cfg)(state, batch, generator=torch.Generator().manual_seed(5),
                                       with_r1=True)
    called = {k: sum(1 for n, _ in log if n == k) for k in ops.KERNEL_WRAPPERS}
    assert called == state.kernel_launches_per_iteration(True)
    assert all(np.isfinite(float(v)) for v in metrics.values())
