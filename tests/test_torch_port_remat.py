"""Remat (``use_grad_checkpoint``) and dropout in the port's training, on the CPU.

Remat changes where activations live, never what is computed: one D (R1)
+ G iteration under ``blocks``, ``hires`` and ``hires4`` gives the losses
and gradients of the same iteration without remat (same weights, same
draws; fp32, within 1e-6), also with dropout on.  The regions rematted
per policy are the JAX package's: the blocks are read from the
``remat`` equations of the JAX generators' jaxprs (each names its block
in its inner name stack; the unnamed ones are G1's stems, G2's encode
and fusion), and the critic is rematted in the G step under ``blocks``
only (``mudiff_tpu/train/steps.py:182-185``).  The bytes saved for the
G step's backward, counted with ``saved_tensors_hooks``, fall strictly in
the order none > hires > hires4 > blocks, so a remat that recomputes
nothing would fail here.

Dropout: the port's resblock at rate 0.3 with flax's keep mask equals
the flax block.  The mask is read out of flax: ``nn.Dropout`` draws
``bernoulli(rng, 1 - p)`` from the ``dropout`` stream and returns
``select(keep, x / (1 - p), 0)``, so where its input is nonzero (all of
it here) the mask is where its output is nonzero; an interceptor reads
the Dropout's input and output.  In eval mode, or without seeds, a
generator with dropout equals one without.
"""

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudiff_tpu import config as jconfig
from mudiff_tpu.models import NCSNppGenerator as JaxGenerator
from mudiff_tpu.nn import blocks as jblocks
from mudiff_torch import config
from mudiff_torch.convert import params_from_flax
from mudiff_torch.models.generator import resblock_count
from mudiff_torch.nn import blocks, remat
from mudiff_torch.train import TrainDraws, create_train_state, d_loss_and_grads, g_loss_and_grads
from test_torch_port_helpers import random_flax_params

# four levels (64, 32, 16, 8), so that each policy rematts a distinct set
SMALL = dict(image_size=64, num_channels=1, num_channels_dae=8, ch_mult=(1, 1, 2, 2),
             num_res_blocks=1, attn_resolutions=(8,), z_emb_dim=16, t_emb_dim=16, nz=4,
             ngf=4, num_timesteps=4, r1_gamma=0.05, use_bf16=False)
POLICIES = ("hires", "hires4", "blocks")
B, S = 2, 64


def _cfg(policy=None, dropout=0.0):
    return config.MuDiffConfig(**SMALL, use_grad_checkpoint=policy is not None,
                               grad_checkpoint_policy=policy or "blocks", dropout=dropout)


def _state(policy=None, dropout=0.0):
    """A train state with seeded non-trivial weights (the same for every
    policy: remat changes no parameter)."""
    state = create_train_state(_cfg(policy, dropout), seed=3, device="cpu", attn="flash")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for m in (state.g1, state.g2, state.d):
            for p in m.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return state


def _batch():
    rng = np.random.RandomState(0)
    return [torch.from_numpy((rng.randn(B, S, S, 1) * 0.5).astype(np.float32)) for _ in range(4)]


def _iteration(state, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    draws = [TrainDraws.draw(state.config, batch[3], gen) for _ in range(2)]
    grads_d, aux_d = d_loss_and_grads(state, batch, draws[0], with_r1=True)
    (grads_g1, grads_g2), aux_g = g_loss_and_grads(state, batch, draws[1])
    return {**aux_d, **aux_g}, grads_d + grads_g1 + grads_g2


@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gives_the_gradients_of_no_remat(policy, dropout):
    batch = _batch()
    want_loss, want = _iteration(_state(None, dropout), batch, seed=11)
    got_loss, got = _iteration(_state(policy, dropout), batch, seed=11)
    assert want_loss.keys() == got_loss.keys()
    for k in want_loss:
        torch.testing.assert_close(got_loss[k], want_loss[k], atol=1e-6, rtol=0)
    assert len(got) == len(want)
    assert sum(float(g.abs().sum()) > 0 for g in want) > 0.9 * len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


def test_dropout_draws_a_seed_per_resblock_and_changes_the_step():
    batch = _batch()
    draws = TrainDraws.draw(_cfg(None, 0.3), batch[3], torch.Generator().manual_seed(0))
    n = resblock_count(_cfg())
    assert len(draws.dropout_g1) == len(draws.dropout_g2) == n == 20  # 4 + 3 + 2 + 8 + 3
    assert TrainDraws.draw(_cfg(), batch[3]).dropout_g1 is None
    with_dropout, _ = _iteration(_state(None, 0.3), batch, seed=11)
    without, _ = _iteration(_state(None, 0.0), batch, seed=11)
    assert float(with_dropout["G_total"]) != float(without["G_total"])


def _jax_regions(policy, adaptive):
    """The regions the JAX generator rematts: each ``remat`` equation of
    its forward's jaxpr, named by the block its inner equations run in."""
    cfg = jconfig.MuDiffConfig(**SMALL, use_grad_checkpoint=True,
                               grad_checkpoint_policy=policy)
    g = JaxGenerator(config=cfg, adaptive=adaptive)
    x = jnp.zeros((1, S, S, 1))
    t, z = jnp.zeros((1,), jnp.int32), jnp.zeros((1, cfg.nz))
    kw = dict(pseudo_target=x) if adaptive else {}
    params = jax.eval_shape(g.init, jax.random.PRNGKey(0), x, x, x, x, t, z, **kw)
    jaxpr = jax.make_jaxpr(lambda p: g.apply(p, x, x, x, x, t, z, **kw))(params).jaxpr
    block = re.compile(r"^(down|downsample|up|upsample|mid)_")
    names, unnamed = set(), []
    for e in jaxpr.eqns:
        if "remat" not in e.primitive.name and "checkpoint" not in e.primitive.name:
            continue
        sub = e.params["jaxpr"]
        inner = {str(ee.source_info.name_stack).split("/")[0]
                 for ee in getattr(sub, "jaxpr", sub).eqns}
        named = {n for n in inner if block.match(n)}
        assert len(named) <= 1, named
        if named:
            names |= named
        else:
            unnamed.append(e)
    outside = ["encode", "fuse"] if adaptive else ["stems"]
    assert len(unnamed) == len(outside)
    return names | set(outside)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_regions_are_the_jax_selection(policy, monkeypatch):
    seen = []
    original = remat.checkpointed

    def recording(name, fn, *args):
        seen.append(name)
        return original(name, fn, *args)

    monkeypatch.setattr(remat, "checkpointed", recording)
    state = _state(policy)
    batch = _batch()
    x = batch[3]
    t = torch.zeros(B, dtype=torch.int64)
    z = torch.zeros(B, state.config.nz)
    state.g1(x, *batch[:3], t, z)
    assert set(seen) == state.g1.remat_regions == _jax_regions(policy, adaptive=False)
    assert len(seen) == len(set(seen))
    seen.clear()
    state.g2(x, *batch[:3], t, z, pseudo_target=x)
    assert set(seen) == state.g2.remat_regions == _jax_regions(policy, adaptive=True)
    seen.clear()
    gen = torch.Generator().manual_seed(0)
    g_loss_and_grads(state, batch, TrainDraws.draw(state.config, x, gen))
    critic = seen.count("critic")
    assert critic == (2 if policy == "blocks" else 0)
    seen.clear()
    d_loss_and_grads(state, batch, TrainDraws.draw(state.config, x, gen), with_r1=True)
    assert "critic" not in seen  # R1's grad-of-grad runs on kept activations


def _saved_bytes(state, batch):
    """Bytes of the distinct storages the G step saves for its backward."""
    storages = {}

    def pack(t):
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
        return t

    gen = torch.Generator().manual_seed(0)
    draws = TrainDraws.draw(state.config, batch[3], gen)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        g_loss_and_grads(state, batch, draws)
    return sum(storages.values())


def test_remat_saves_fewer_bytes_policy_by_policy():
    batch = _batch()
    saved = [_saved_bytes(_state(policy), batch) for policy in (None, *POLICIES)]
    assert saved[0] > saved[1] > saved[2] > saved[3], saved


def test_dropout_block_matches_flax_with_its_mask():
    rng = np.random.RandomState(1)
    x, temb, zemb = (rng.randn(*s).astype(np.float32) for s in ((2, 8, 8, 16), (2, 20), (2, 12)))
    jm = jblocks.ResnetBlockBigGANppAdagn(act=jax.nn.silu, features=16, down=True,
                                          dropout=0.3, fir=True, skip_rescale=True,
                                          init_scale=0.0)
    args = tuple(map(jnp.asarray, (x, temb, zemb)))
    params = random_flax_params(jm, *args)
    seen = {}

    def intercept(next_fun, a, kw, context):
        out = next_fun(*a, **kw)
        if isinstance(context.module, fnn.Dropout):
            seen["in"], seen["out"] = np.asarray(a[0]), np.asarray(out)
        return out

    with fnn.intercept_methods(intercept):
        ref = jm.apply({"params": params}, *args, train=True,
                       rngs={"dropout": jax.random.PRNGKey(5)})
    assert np.all(seen["in"] != 0)
    keep = seen["out"] != 0
    assert 0.6 < keep.mean() < 0.8
    port = blocks.ResnetBlockBigGANppAdagn(16, 16, temb_dim=20, zemb_dim=12, down=True,
                                           dropout=0.3)
    port.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (x, temb, zemb)), dropout=torch.from_numpy(keep))
        plain = port(*map(torch.from_numpy, (x, temb, zemb)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert not np.allclose(plain.numpy(), np.asarray(ref), atol=1e-3)
    # a seed draws the mask on the block's device, the same each time
    a, b = (blocks.dropout_keep((2, 4, 4, 16), 0.3, 9, "cpu") for _ in range(2))
    assert torch.equal(a, b) and 0.5 < a.float().mean() < 0.9


def test_dropout_is_off_in_eval_and_without_seeds():
    state = _state(None, 0.3)
    plain = _state(None, 0.0)
    batch = _batch()
    x, t = batch[3], torch.zeros(B, dtype=torch.int64)
    z = torch.zeros(B, state.config.nz)
    seeds = list(range(resblock_count(state.config)))
    with torch.no_grad():
        want = plain.g1(x, *batch[:3], t, z)
        assert torch.equal(state.g1(x, *batch[:3], t, z), want)  # no seeds
        dropped = state.g1(x, *batch[:3], t, z, dropout_seeds=seeds)
        state.g1.eval()
        assert torch.equal(state.g1(x, *batch[:3], t, z, dropout_seeds=seeds), want)
    assert not torch.equal(dropped, want)
