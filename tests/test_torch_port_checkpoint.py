"""The port's checkpoints (``train/checkpoint.py``) and the carry-over of
a JAX content checkpoint (``convert.content_from_flax``), on the CPU.

``content.pt`` must give back everything the next step reads: the
modules, Adam's moments and step, the schedules' counts, ``step`` and the
EMA shadows, so a restored state takes the same next update as the one
saved.  A JAX ``save_content``, restored by a bare orbax ``restore``
(NamedTuples and tuples come back as dicts and lists), carried into
``content.pt`` and restored in the port, takes the same Adam update as
the JAX state on the same gradient: parameters within 1e-6 of each
tensor's largest magnitude, the same learning rate, the same EMA.
"""

import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from mudiff_tpu import config as jconfig
from mudiff_tpu.train import checkpoint as jckpt
from mudiff_tpu.train import create_train_state as jax_create_train_state
from mudiff_tpu.train.state import cosine_epoch_schedule as jax_schedule
from mudiff_torch import config
from mudiff_torch.convert import GENERATOR_FILES, content_from_flax, params_from_flax
from mudiff_torch.infer import load_generators
from mudiff_torch.train import checkpoint as ckpt
from mudiff_torch.train import create_train_state

TINY = dict(image_size=64, num_channels=1, num_channels_dae=16, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(8,), z_emb_dim=32, t_emb_dim=32, nz=8,
            ngf=8, num_timesteps=2, use_bf16=False, use_ema=True, ema_decay=0.9,
            num_epoch=3)
SPE = 2  # steps per epoch: the updates below cross an epoch boundary


def _port_state(seed=0):
    return create_train_state(config.MuDiffConfig(**TINY), seed=seed, steps_per_epoch=SPE,
                              device="cpu")


def _grads(state, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: [torch.randn(p.shape, generator=gen) for p in getattr(state, k).parameters()]
            for k in ("g1", "g2", "d")}


def _update(state, grads):
    state.apply_g_updates(grads["g1"], grads["g2"])
    state.apply_d_updates(grads["d"])


def _assert_tree_equal(a, b, path="content"):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b))[:4])
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}/{i}")
    else:
        assert a == b, (path, a, b)


def test_content_round_trip_is_exact_and_resumes_the_same_update(tmp_path):
    state = _port_state(seed=0)
    for s in range(3):
        _update(state, _grads(state, s))
    path = ckpt.save_content(str(tmp_path), state, epoch=1, global_step=3)
    assert os.path.basename(path) == "content.pt" and not list(tmp_path.glob("*.tmp"))
    saved = ckpt.load_content(str(tmp_path))

    other = _port_state(seed=1)  # other weights: everything must come back
    restored, epoch, global_step = ckpt.restore_content(str(tmp_path), other)
    assert restored is other and (epoch, global_step) == (1, 3)
    assert other.step == 3 and other.counts == {"g1": 3, "g2": 3, "d": 3}
    _assert_tree_equal(ckpt.content_payload(other, 1, 3), saved)
    for opt in (other.opt_g1, other.opt_g2, other.opt_d):
        for s in opt.state.values():
            assert s["step"].dtype == torch.float32 and s["step"].device.type == "cpu"
            assert float(s["step"]) == 3.0

    grads = _grads(state, 9)  # the next update: the same in both, bit for bit
    _update(state, grads)
    _update(other, grads)
    _assert_tree_equal(ckpt.content_payload(other, 2, 4), ckpt.content_payload(state, 2, 4))


def test_restore_refuses_a_mismatched_optimizer(tmp_path):
    state = _port_state()
    _update(state, _grads(state, 0))
    payload = ckpt.content_payload(state, 0, 1)
    payload["opt_d"]["state"]["not_a_parameter"] = payload["opt_d"]["state"].popitem()[1]
    payload["opt_d"]["param_groups"][0]["params"][-1] = "not_a_parameter"
    torch.save(payload, tmp_path / "content.pt")
    with pytest.raises(KeyError, match="not_a_parameter"):
        ckpt.restore_content(str(tmp_path), _port_state())


def test_content_is_written_under_a_temporary_name(tmp_path, monkeypatch):
    """A save that dies half-way leaves the previous content.pt whole."""
    state = _port_state()
    ckpt.save_content(str(tmp_path), state, epoch=0, global_step=1)
    before = (tmp_path / "content.pt").read_bytes()
    real_save = torch.save

    def dies_half_way(obj, f):
        real_save(obj, f)
        with open(f, "r+b") as fh:
            fh.truncate(100)
        raise KeyboardInterrupt("stopped mid-save")

    monkeypatch.setattr(torch, "save", dies_half_way)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_content(str(tmp_path), state, epoch=5, global_step=9)
    monkeypatch.setattr(torch, "save", real_save)
    assert (tmp_path / "content.pt").read_bytes() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["content.pt"]
    assert ckpt.load_content(str(tmp_path))["epoch"] == 0


def test_generator_files_with_ema_and_the_fallback_directory(tmp_path):
    state = _port_state()
    _update(state, _grads(state, 0))
    exp = tmp_path / "exp"
    paths = ckpt.save_generators(str(exp), state, epoch=4, use_ema_weights=True)
    assert [os.path.basename(p) for p in paths] == list(GENERATOR_FILES)
    assert (exp / "gen_diffusive_1_4.pt").is_file() and (exp / "gen_diffusive_2_4.pt").is_file()
    for name, module, ema in zip(GENERATOR_FILES, (state.g1, state.g2),
                                 (state.ema_g1, state.ema_g2)):
        sd = ckpt.load_generator_params(str(tmp_path / "missing"), name, fallback_dir=str(exp))
        assert set(sd) == set(module.state_dict())
        for n, v in ema.items():
            assert torch.equal(sd[n], v), n
        assert any(not torch.equal(sd[n], p) for n, p in module.named_parameters())
    raw = ckpt.generator_state_dicts(state, use_ema_weights=False)
    for sd, module in zip(raw, (state.g1, state.g2)):
        for n, p in module.named_parameters():
            assert torch.equal(sd[n], p.detach())
    with pytest.raises(FileNotFoundError, match="gen_diffusive_1.pt"):
        ckpt.load_generator_params(str(tmp_path / "a"), GENERATOR_FILES[0], str(tmp_path / "b"))
    cfg = config.MuDiffConfig(**{**TINY, "use_int8": False})
    g1, _ = load_generators(cfg, str(exp), device="cpu", attn="einsum")
    for n, p in g1.named_parameters():
        assert torch.equal(p, state.ema_g1[n]), n


@pytest.fixture(scope="module")
def jax_content(tmp_path_factory):
    """A JAX train state after three updates (across an epoch boundary),
    saved by ``save_content`` and restored by a bare orbax ``restore``."""
    cfg = jconfig.MuDiffConfig(**TINY)
    jstate, _, _, _ = jax_create_train_state(cfg, jax.random.PRNGKey(0), steps_per_epoch=SPE)
    rng = np.random.RandomState(3)

    def draw(tree):
        return jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), tree)

    for _ in range(3):
        jstate = jstate.apply_g_updates(draw(jstate.params_g1), draw(jstate.params_g2))
        jstate = jstate.apply_d_updates(draw(jstate.params_d))
    exp = tmp_path_factory.mktemp("jax_exp")
    jckpt.save_content(str(exp), jstate, epoch=1, global_step=3)
    restored = ocp.PyTreeCheckpointer().restore(str(exp / "content"))
    payload = jax.tree_util.tree_map(np.asarray, restored)
    return cfg, jstate, payload, {k: draw(getattr(jstate, f"params_{k}"))
                                  for k in ("g1", "g2", "d")}


def test_content_from_flax_takes_the_orbax_restore(jax_content):
    _, jstate, payload, _ = jax_content
    assert isinstance(payload["opt_g1"], (list, dict))  # what orbax gives, not NamedTuples
    content = content_from_flax(payload)
    assert (content["epoch"], content["global_step"], content["step"]) == (1, 3, 3)
    assert content["counts"] == {"g1": 3, "g2": 3, "d": 3}
    mu = params_from_flax(jax.tree_util.tree_map(np.asarray, jstate.opt_g1[0].mu))
    for n, s in content["opt_g1"]["state"].items():
        assert torch.equal(s["exp_avg"], mu[n]) and float(s["step"]) == 3.0
    # the NamedTuples themselves are taken too
    direct = content_from_flax({**payload, "opt_d": jax.tree_util.tree_map(np.asarray,
                                                                           jstate.opt_d)})
    _assert_tree_equal(direct["opt_d"], content["opt_d"])


def test_one_adam_update_after_content_from_flax_matches_jax(jax_content, tmp_path):
    cfg, jstate, payload, grads = jax_content
    torch.save(content_from_flax(payload), tmp_path / "content.pt")
    port = _port_state(seed=5)
    _, epoch, global_step = ckpt.restore_content(str(tmp_path), port)
    assert (epoch, global_step, port.step) == (1, 3, 3)

    sch = jax_schedule(cfg.lr_g, cfg.num_epoch, SPE)
    assert port.counts["g1"] == int(np.asarray(payload["opt_g1"][1]["count"]))
    np.testing.assert_allclose(port.schedule_g(port.counts["g1"]),
                               float(sch(jax.numpy.asarray(port.counts["g1"]))), rtol=1e-6)
    assert port.schedule_g(port.counts["g1"]) < cfg.lr_g  # not restarted: epoch 1 of 3

    jstate = jstate.apply_g_updates(grads["g1"], grads["g2"]).apply_d_updates(grads["d"])
    as_list = {k: [params_from_flax(grads[k])[n] for n, _ in getattr(port, k).named_parameters()]
               for k in grads}
    port.apply_g_updates(as_list["g1"], as_list["g2"])
    port.apply_d_updates(as_list["d"])
    trees = {"g1": jstate.params_g1, "g2": jstate.params_g2, "d": jstate.params_d,
             "ema_g1": jstate.ema_g1, "ema_g2": jstate.ema_g2}
    for k, tree in trees.items():
        want = params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        got = (getattr(port, k) if k.startswith("ema") else
               {n: p.detach() for n, p in getattr(port, k).named_parameters()})
        assert set(got) == set(want)
        for n, v in got.items():
            w = want[n].numpy()
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()), err_msg=f"{k}.{n}")
