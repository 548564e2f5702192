"""mudiff_torch's training iteration vs the JAX package, on the CPU.

The ``TINY`` config of ``tests/test_train_steps.py`` (64², nf 16, ngf 8)
in fp32.  Both packages start from the same seeded non-trivial weights
(``random_flax_params``, carried across by ``convert.train_state_from_flax``)
and the same draws: the test rebuilds the JAX step's ``jax.random`` splits
and injects them into the port.  JAX's gradients are read by swapping the
state's optimizers for a transformation that keeps the gradient as its
state.  The port runs ``attn="flash"``, so its attention goes through the
K3 Function's forward and backward (plain versions on the CPU); the JAX
package runs the exact einsum, which is what its flash path computes on
the CPU.  Tolerances: losses 1e-5 relative, gradients 1e-4 of each
tensor's largest magnitude (fp32; only the order of sums differs), with
the two allowances ``_check_grads`` states.  The JAX references compile
in about 90 s on one core.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from mudiff_tpu import config as jconfig
from mudiff_tpu.models import critic as jcritic
from mudiff_tpu.train import create_train_state as jax_create_train_state
from mudiff_tpu.train.state import apply_att_conv
from mudiff_tpu.train.steps import _bce_with_logits as jax_bce_with_logits
from mudiff_tpu.train.steps import make_d_step as jax_make_d_step
from mudiff_tpu.train.steps import make_g_step as jax_make_g_step
from mudiff_tpu.diffusion import DiffusionCoefficients as JaxCoeff
from mudiff_tpu.diffusion import PosteriorCoefficients as JaxPost
from mudiff_torch import config, ops
from mudiff_torch.convert import params_from_flax, train_state_from_flax
from mudiff_torch.models import DiscriminatorLarge
from mudiff_torch.models.critic import minibatch_stddev
from mudiff_torch.train import (
    TrainDraws,
    create_train_state,
    d_loss_and_grads,
    g_loss_and_grads,
    make_train_step,
)
from mudiff_torch.train.steps import bilinear_resize, g_forward, mask_terms
from test_torch_port_helpers import random_flax_params

TINY = dict(image_size=64, num_channels=1, num_channels_dae=16, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(8,), z_emb_dim=32, t_emb_dim=32, nz=8,
            ngf=8, num_timesteps=4, r1_gamma=0.05, lazy_reg=2, use_bf16=False)
B = 2
S = 64


def _batch():
    rng = np.random.RandomState(0)
    return [(rng.randn(B, S, S, 1) * 0.5).astype(np.float32) for _ in range(4)]


def _grad_keeper():
    """An optax transformation whose state is the last gradient."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(
        init=zeros, update=lambda g, s, p=None: (zeros(g), g))


def _jax_draws(key, cfg):
    """The draws of one JAX D or G step (``steps.py:108-138, 246-253``)."""
    k_t, k_pair, k_z, k_p1, k_p2, _, _ = jax.random.split(key, 7)
    t = jax.random.randint(k_t, (B,), 0, cfg.num_timesteps)
    k1, k2 = jax.random.split(k_pair)
    shape = (B, S, S, 1)
    np_ = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return TrainDraws(
        t=np_(t).to(torch.int64),
        noise_t=np_(jax.random.normal(k2, shape, jnp.float32)),
        noise_tp1=np_(jax.random.normal(k1, shape, jnp.float32)),
        z=np_(jax.random.normal(k_z, (B, cfg.nz), jnp.float32)),
        noise_post1=np_(jax.random.normal(k_p1, shape, jnp.float32)),
        noise_post2=np_(jax.random.normal(k_p2, shape, jnp.float32)),
    )


@pytest.fixture(scope="module")
def ref():
    """The JAX references: one D step with and without R1, one G step,
    from seeded non-trivial weights; their losses and gradients."""
    cfg = jconfig.MuDiffConfig(**TINY)
    state, g1, g2, d = jax_create_train_state(cfg, jax.random.PRNGKey(0), steps_per_epoch=10)
    x = jnp.zeros((1, S, S, 1), jnp.float32)
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
    out = {"state_np": jax.tree_util.tree_map(np.asarray, state), "cfg": cfg,
           "draws": {"d": _jax_draws(kd, cfg), "g": _jax_draws(kg, cfg)}, "d_apply": d.apply}
    for r1 in (True, False):
        s2, aux = d_step(state, batch, kd, with_r1=r1)
        out[f"d{int(r1)}"] = ({k: float(v) for k, v in aux.items()},
                              params_from_flax(jax.tree_util.tree_map(np.asarray, s2.opt_d)))
    s2, aux = g_step(state, batch, kg)
    out["g"] = ({k: float(v) for k, v in aux.items()},
                [params_from_flax(jax.tree_util.tree_map(np.asarray, o))
                 for o in (s2.opt_g1, s2.opt_g2)])
    return out


def _port_state(ref, **over):
    cfg = config.MuDiffConfig(**{**TINY, **over})
    state = create_train_state(cfg, seed=0, steps_per_epoch=10, device="cpu", attn="flash")
    state.load_flax(train_state_from_flax(ref["state_np"]))
    return state


def _check_losses(ours, want):
    assert set(want) <= set(ours)
    for k, v in want.items():
        np.testing.assert_allclose(float(ours[k]), v, rtol=1e-5, atol=1e-7, err_msg=k)


def _check_grads(module, grads, want):
    """Each tensor within 1e-4 of its largest magnitude.  Two allowances,
    both far below what a wrong formula gives: a tensor whose exact
    gradient is 0 (the key projection's bias: softmax ignores a shift of
    a score row) holds noise, so the floor is 1e-6 of the module's
    largest gradient; and a leaky ReLU whose input lies within float32
    noise of 0 takes the other slope in one framework, so up to 0.2% of
    a tensor's elements may differ by up to 1e-3 of its largest."""
    names = [n for n, _ in module.named_parameters()]
    assert sorted(names) == sorted(want)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    nonzero = 0
    for name, g in zip(names, grads):
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        nonzero += scale > 1e-6 * top
        err = np.abs(g.numpy() - w)
        tol = 1e-4 * scale + 1e-6 * top
        assert err.max() <= 10 * tol and (err > tol).mean() <= 2e-3, (
            f"{name}: max err {err.max():.3g}, {(err > tol).sum()} of {err.size} "
            f"beyond {tol:.3g}")
    assert nonzero > 0.9 * len(names)


@pytest.mark.parametrize("with_r1", [True, False], ids=["r1", "no_r1"])
def test_d_step_matches_jax(ref, with_r1):
    state = _port_state(ref)
    grads, aux = d_loss_and_grads(state, [torch.from_numpy(a) for a in _batch()],
                                  ref["draws"]["d"], with_r1)
    want_aux, want_grads = ref[f"d{int(with_r1)}"]
    _check_losses(aux, want_aux)
    _check_grads(state.d, grads, want_grads)
    if with_r1:
        assert float(aux["R1"]) > 0.0


def test_g_step_matches_jax(ref):
    state = _port_state(ref)
    (grads_g1, grads_g2), aux = g_loss_and_grads(
        state, [torch.from_numpy(a) for a in _batch()], ref["draws"]["g"])
    want_aux, (want_g1, want_g2) = ref["g"]
    _check_losses(aux, want_aux)
    _check_grads(state.g1, grads_g1, want_g1)
    _check_grads(state.g2, grads_g2, want_g2)


def test_g_step_mask_factors_match_jax(ref):
    """The G step's mask-loss factors (``mask_terms`` on ``g_forward``)
    against the JAX package's on the same posterior samples: the critic's
    features, ``apply_att_conv`` of them (the attention logits), their
    sigmoid resized by ``jax.image.resize`` (the two maps) and the two
    BCE factors, ``steps.py:248-266``.  fp32, so only the order of sums
    differs: 1e-5 of each tensor's largest magnitude; the terms' sum is
    the JAX step's G_mask within 1e-5 relative."""
    state = _port_state(ref)
    with torch.no_grad():
        fwd = g_forward(state, [torch.from_numpy(a) for a in _batch()], ref["draws"]["g"])
        got = mask_terms(state.att_conv, fwd)
    jnp_ = {k: jnp.asarray(fwd[k].numpy()) for k in ("pos_g1", "pos_g2", "x_tp1")}
    t = jnp.asarray(ref["draws"]["g"].t.numpy(), jnp.int32)
    params_d, att_conv = ref["state_np"].params_d, ref["state_np"].att_conv
    want = {}
    for i in ("g1", "g2"):
        _, feat = ref["d_apply"]({"params": params_d}, jnp_[f"pos_{i}"], t, jnp_["x_tp1"])
        want[f"feat_{i}"] = feat
        want[f"att_logit_{i}"] = apply_att_conv(att_conv, feat)
        want[f"att_{i}"] = jax.image.resize(jax.nn.sigmoid(want[f"att_logit_{i}"]),
                                            (B, S, S, 1), method="bilinear")
    want["bce_1"] = jax_bce_with_logits(jnp_["pos_g1"], jax.nn.sigmoid(jnp_["pos_g2"]))
    want["bce_2"] = jax_bce_with_logits(jnp_["pos_g2"], jax.nn.sigmoid(jnp_["pos_g1"]))
    mine = {**got, "feat_g1": fwd["feat_g1"], "feat_g2": fwd["feat_g2"]}
    for name, w in want.items():
        w = np.asarray(w)
        assert mine[name].shape == w.shape, name
        np.testing.assert_allclose(mine[name].numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=name)
    assert float(np.abs(want["att_logit_g1"]).max()) > 0.1  # att_conv is not a no-op
    mask = float(got["term_1"] + got["term_2"])
    np.testing.assert_allclose(mask, ref["g"][0]["G_mask"], rtol=1e-5)


def test_r1_penalty_reaches_the_critic_grads(ref):
    """R1 is positive off the zero-init fixed point, and its gradient
    reaches D's parameters (as ``test_r1_penalty_fires``)."""
    state = _port_state(ref)
    batch = [torch.from_numpy(a) for a in _batch()]
    on, aux = d_loss_and_grads(state, batch, ref["draws"]["d"], with_r1=True)
    off, _ = d_loss_and_grads(state, batch, ref["draws"]["d"], with_r1=False)
    assert float(aux["R1"]) > 0.0
    assert max(float((a - b).abs().max()) for a, b in zip(on, off)) > 0.0


@pytest.mark.parametrize("with_r1", [True, False], ids=["r1", "no_r1"])
def test_iteration_calls_what_the_structure_says_and_updates(ref, with_r1):
    """One train step: every wrapper call (forward and backward) is one
    the structure predicts, D, G1 and G2 change, att_conv does not."""
    state = _port_state(ref)
    before = {n: {k: v.clone() for k, v in getattr(state, n).state_dict().items()}
              for n in ("g1", "g2", "d", "att_conv")}
    step = make_train_step(state.config)
    log = []
    with ops.record_calls(log):
        metrics = step(state, [torch.from_numpy(a) for a in _batch()],
                       generator=torch.Generator().manual_seed(5), with_r1=with_r1)
    called = {k: sum(1 for n, _ in log if n == k) for k in ops.KERNEL_WRAPPERS}
    assert called == state.kernel_launches_per_iteration(with_r1)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert state.step == 1
    for name in ("g1", "g2", "d"):
        after = getattr(state, name).state_dict()
        assert any(not torch.equal(before[name][k], after[k]) for k in after), name
    for k, v in state.att_conv.state_dict().items():
        assert torch.equal(v, before["att_conv"][k])
    opt_params = {id(p) for o in (state.opt_g1, state.opt_g2, state.opt_d)
                  for g in o.param_groups for p in g["params"]}
    assert not any(id(b) in opt_params for b in state.att_conv.buffers())


def test_adam_cosine_and_ema_match_optax(ref):
    """Three updates on the same given gradients, across an epoch
    boundary (2 steps per epoch), with EMA: the port's Adam + schedule +
    lerp against the JAX state's optax chain."""
    over = dict(use_ema=True, ema_decay=0.9, num_epoch=3)
    cfg = jconfig.MuDiffConfig(**{**TINY, **over})
    jstate, _, _, _ = jax_create_train_state(cfg, jax.random.PRNGKey(0), steps_per_epoch=2)
    sn = ref["state_np"]
    jstate = jstate.replace(params_g1=sn.params_g1, params_g2=sn.params_g2,
                            params_d=sn.params_d, ema_g1=sn.params_g1, ema_g2=sn.params_g2)
    jstate = jstate.replace(opt_g1=jstate.tx_g1.init(sn.params_g1),
                            opt_g2=jstate.tx_g2.init(sn.params_g2),
                            opt_d=jstate.tx_d.init(sn.params_d))
    port = create_train_state(config.MuDiffConfig(**{**TINY, **over}), seed=0,
                              steps_per_epoch=2, device="cpu")
    port.load_flax(train_state_from_flax(sn))
    rng = np.random.RandomState(3)
    draw = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: rng.randn(*a.shape).astype(np.float32), tree)
    for _ in range(3):
        grads = {k: draw(getattr(sn, f"params_{k}")) for k in ("g1", "g2", "d")}
        jstate = jstate.apply_g_updates(grads["g1"], grads["g2"]).apply_d_updates(grads["d"])
        as_list = {k: [params_from_flax(grads[k])[n] for n, _ in
                       getattr(port, k).named_parameters()] for k in grads}
        port.apply_g_updates(as_list["g1"], as_list["g2"])
        port.apply_d_updates(as_list["d"])
    assert port.step == 3 and port.counts == {"g1": 3, "g2": 3, "d": 3}
    trees = {"g1": jstate.params_g1, "g2": jstate.params_g2, "d": jstate.params_d}
    for k, tree in trees.items():
        want = params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        for n, p in getattr(port, k).named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{k}.{n}")
    for ema, tree in ((port.ema_g1, jstate.ema_g1), (port.ema_g2, jstate.ema_g2)):
        want = params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        for n, v in ema.items():
            np.testing.assert_allclose(v.numpy(), want[n].numpy(), rtol=0, atol=1e-6,
                                       err_msg=n)


def test_critic_matches_jax_after_convert():
    x, xt = (np.random.RandomState(s).randn(B, S, S, 1).astype(np.float32) for s in (1, 2))
    t = np.array([0, 3], np.int32)
    m = jcritic.DiscriminatorLarge(ngf=8, t_emb_dim=32)
    params = random_flax_params(m, jnp.asarray(x), jnp.asarray(t), jnp.asarray(xt), seed=4)
    logit, mid = jax.jit(m.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(xt))
    port = DiscriminatorLarge(ngf=8, t_emb_dim=32)
    port.load_state_dict(params_from_flax(params), strict=True)
    log = []
    with torch.no_grad(), ops.record_calls(log):
        got_logit, got_mid = port(torch.from_numpy(x), torch.from_numpy(t).long(),
                                  torch.from_numpy(xt))
    assert got_mid.shape == (B, S // 8, S // 8, 64) and np.asarray(logit).std() > 1e-3
    np.testing.assert_allclose(got_logit.numpy(), np.asarray(logit), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_mid.numpy(), np.asarray(mid), atol=1e-5, rtol=1e-5)
    assert [n for n, _ in log] == ["fir_down2"] * port.kernel_launches_per_forward()["fir_down2"]


def test_critic_parameter_count_at_ngf64():
    """27,736,705 at the recipe's ngf=64 (``tests/test_models.py``),
    counted on the meta device without a forward."""
    cfg = config.brats_recipe(num_channels_dae=64)
    with torch.device("meta"):
        d = DiscriminatorLarge(ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim, device="meta")
    assert sum(p.numel() for p in d.parameters()) == 27_736_705
    assert d.kernel_launches_per_forward() == {"fir_down2": 12}


@pytest.mark.parametrize("batch", [4, 6, 5])
def test_minibatch_stddev_matches_jax(batch):
    x = np.random.RandomState(batch).randn(batch, 4, 4, 3).astype(np.float32)
    want = np.asarray(jcritic._minibatch_stddev(jnp.asarray(x)))
    got = minibatch_stddev(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_bilinear_resize_matches_jax_image_resize():
    x = np.random.RandomState(0).rand(2, 32, 32, 1).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 256, 256, 1), method="bilinear"))
    got = bilinear_resize(torch.from_numpy(x), (256, 256)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_bilinear_resize_gradient_matches_jax_vjp():
    rng = np.random.RandomState(1)
    x = rng.rand(2, 32, 32, 1).astype(np.float32)
    cot = rng.randn(2, 256, 256, 1).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax.image.resize(a, (2, 256, 256, 1), method="bilinear"),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(bilinear_resize(xt, (256, 256)), xt, torch.from_numpy(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape,hw,dtype", [((2, 32, 32, 1), (256, 256), torch.float32),
                                            ((1, 7, 5, 3), (16, 11), torch.float32),
                                            ((2, 8, 8, 1), (64, 64), torch.bfloat16)])
def test_bilinear_resize_is_f_interpolate(shape, hw, dtype):
    """The matrix products give ``F.interpolate``'s values, forward and
    backward, at ragged ratios and in bf16 (one rounding of the fp32 sum)."""
    x = torch.from_numpy(np.random.RandomState(2).rand(*shape).astype(np.float32))
    x = x.to(dtype).requires_grad_(True)
    got = bilinear_resize(x, hw)
    want = F.interpolate(x.float().permute(0, 3, 1, 2), size=hw, mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    cot = torch.from_numpy(np.random.RandomState(3).randn(*got.shape).astype(np.float32))
    (g,) = torch.autograd.grad(got, x, cot.to(dtype))
    (w,) = torch.autograd.grad(want, x, cot)
    torch.testing.assert_close(g.float(), w.float(), atol=1e-5 if dtype == torch.float32
                               else 0.1, rtol=1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("over", [dict(use_grad_checkpoint=True, grad_checkpoint_policy="hires"),
                                  dict(dropout=0.1)])
def test_train_state_takes_remat_and_dropout(over):
    state = create_train_state(config.MuDiffConfig(**{**TINY, **over}), device="cpu")
    for g in (state.g1, state.g2):
        if "dropout" in over:
            assert g.remat_regions == set()
            assert all(getattr(g, n).dropout == 0.1 for n in g._resblocks)
        else:  # hires at 64^2, levels 64 and 32: every block, and the
            # full-resolution regions; never the input pyramid's convs
            blocks = {name for kind, name in g._trunk if kind != "pyramid"}
            assert g.remat_regions == blocks | ({"encode", "fuse"} if g.adaptive
                                                else {"stems"})


def test_create_train_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(config.MuDiffConfig(**TINY))
