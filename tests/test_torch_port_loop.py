"""The port's training program (``train/loop.py``, ``cli/train.py``)
against the JAX package's ``train()``, on the CPU.

The ``TINY`` config of ``tests/test_e2e.py`` (64², nf 16, ngf 8, T = 2,
lazy R1 every 4 steps, fp32) on 16 train and 8 val slices.  The JAX loop
runs data-parallel over the 8 virtual CPU devices of ``conftest.py``, so
its global batch is 8 x ``batch_size``; the port, on one device, takes
that global batch as its ``batch_size``.

The JAX loop trains two epochs in one call.  The port starts from the
same initial state (the JAX init, carried over by
``train_state_from_flax``), trains one epoch, and a second call resumes
from its ``content.pt`` to the second.  Both see the same numbers: the
test replays the JAX loop's key sequence (``rng, init_rng =
split(PRNGKey(seed))``; per iteration ``rng, kd, kg = split(rng, 3)`` and
the D and G steps' own splits; per preview and val batch ``rng, k_init,
k_s = split(rng, 3)`` and the sampler's per-step splits) and injects it
through the loop's ``draws`` seam, continuing across the resume.  So the
resumed run must take the updates an uninterrupted run takes: every
piece of state the next step reads comes back from ``content.pt``.

Agreement: the history's losses and ``val_l1`` / ``val_psnr`` within
1e-4 relative (losses with a 1e-7 absolute floor: R1 is ~1e-10 from the
critic's zero-initialised head); the ``.npy`` validation arrays of equal
shapes; the final
parameters within ``2 * lr * n_updates`` (Adam turns a gradient that is
zero up to rounding into a step of +-lr, in either direction).  The JAX
loop compiles for about three minutes on one core.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from mudiff_tpu.config import MuDiffConfig as JaxConfig
from mudiff_tpu.train import create_train_state as jax_create_train_state
from mudiff_tpu.train.loop import train as jax_train
from mudiff_torch.cli import train as train_cli
from mudiff_torch.config import MuDiffConfig
from mudiff_torch.convert import params_from_flax, train_state_from_flax
from mudiff_torch.train import TrainDraws, create_train_state
from mudiff_torch.train import checkpoint as ckpt
from mudiff_torch.train import loop
from mudiff_torch.utils.profiling import StepTimer, maybe_profile
from test_e2e import TINY

DEVICES = 8  # the JAX loop's data axis (conftest.py)
STEPS_PER_EPOCH = 2  # 16 train slices, global batch 8


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """As ``tests/test_e2e.py``: z-scored noise, 64², 16 / 8 / 8 slices."""
    root = tmp_path_factory.mktemp("brats")
    rng = np.random.RandomState(0)
    for split, n in (("train", 16), ("val", 8), ("test", 8)):
        (root / split).mkdir()
        for mod in ("T1", "T2", "FLAIR", "T1CE"):
            np.save(root / split / f"{mod}.npy", rng.randn(n, 64, 64).astype(np.float32))
    return str(root)


def _t(a):
    return torch.from_numpy(np.array(a))


def _step_draws(key, shape, nz, num_timesteps):
    """The draws of one JAX D or G step (``mudiff_tpu/train/steps.py``)."""
    k_t, k_pair, k_z, k_p1, k_p2, _, _ = jax.random.split(key, 7)
    k1, k2 = jax.random.split(k_pair)
    normal = lambda k, s: _t(jax.random.normal(k, s, jnp.float32))  # noqa: E731
    return TrainDraws(
        t=_t(jax.random.randint(k_t, (shape[0],), 0, num_timesteps)).to(torch.int64),
        noise_t=normal(k2, shape), noise_tp1=normal(k1, shape),
        z=normal(k_z, (shape[0], nz)), noise_post1=normal(k_p1, shape),
        noise_post2=normal(k_p2, shape))


class JaxDraws:
    """The JAX loop's key sequence, as the port's ``draws`` seam."""

    def __init__(self, rng, nz, num_timesteps):
        self.rng, self.nz, self.steps = rng, nz, num_timesteps

    def iteration(self, real):
        self.rng, kd, kg = jax.random.split(self.rng, 3)
        shape = tuple(real.shape)
        return (_step_draws(kd, shape, self.nz, self.steps),
                _step_draws(kg, shape, self.nz, self.steps))

    def sample(self, real):
        self.rng, k_init, k = jax.random.split(self.rng, 3)
        shape = tuple(real.shape)
        x_init = _t(jax.random.normal(k_init, shape, jnp.float32))
        noise = []
        for _ in range(self.steps):  # the sampler's scan
            k, kz, kp = jax.random.split(k, 3)
            noise.append((_t(jax.random.normal(kz, (shape[0], self.nz), jnp.float32)),
                          _t(jax.random.normal(kp, shape, jnp.float32))))
        return x_init, noise


def _jax_config(data_root, out, **over):
    return JaxConfig(input_path=data_root, output_path=str(out), exp="loop",
                     target_modality="T1CE", **{**TINY, **over})


def _port_config(data_root, out, **over):
    return MuDiffConfig(input_path=data_root, output_path=str(out), exp="loop",
                        target_modality="T1CE",
                        **{**TINY, "batch_size": DEVICES * TINY["batch_size"], **over})


def _names(exp_dir):
    return sorted(os.listdir(exp_dir))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, data_root):
    jout, pout = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jcfg = _jax_config(data_root, jout, num_epoch=2)
    jax_art = jax_train(jcfg, verbose=False)

    rng, init_rng = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    jstate, _, _, _ = jax_create_train_state(jcfg, init_rng, steps_per_epoch=STEPS_PER_EPOCH)
    start = train_state_from_flax(jax.tree_util.tree_map(np.asarray, jstate))
    draws = JaxDraws(rng, jcfg.nz, jcfg.num_timesteps)

    def port_state(cfg):
        state = create_train_state(cfg, steps_per_epoch=STEPS_PER_EPOCH, device="cpu",
                                   attn="flash")
        state.load_flax(start)
        return state

    cfg1 = _port_config(data_root, pout, num_epoch=1)
    first = loop.train(cfg1, verbose=False, device="cpu", attn="flash",
                       state=port_state(cfg1), draws=draws)
    first_names = _names(first["exp_dir"])
    cfg2 = cfg1.replace(num_epoch=2, resume=True)
    second = loop.train(cfg2, verbose=False, device="cpu", attn="flash",
                        state=port_state(cfg2), draws=draws)
    return {"jax": jax_art, "first": first, "first_names": first_names, "port": second,
            "jcfg": jcfg}


def _history(art):
    with open(art["history"]) as f:
        return json.load(f)


def test_history_matches_jax(runs):
    ours, ref = _history(runs["port"]), _history(runs["jax"])
    assert [h["epoch"] for h in ours] == [h["epoch"] for h in ref] == [0, 1]
    for o, r in zip(ours, ref):
        assert set(o["losses"]) == set(r["losses"]) == {
            "D_total", "D_real", "D_fake", "R1", "G_total", "G_adv", "G_L1", "G_mask"}
        for k, v in r["losses"].items():
            np.testing.assert_allclose(o["losses"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
        for k in ("val_l1", "val_psnr"):
            np.testing.assert_allclose(o[k], r[k], rtol=1e-4, err_msg=k)


def test_validation_arrays_have_the_jax_shapes(runs):
    for name in ("val_l1_loss.npy", "val_psnr_values.npy"):
        ours = np.load(os.path.join(runs["port"]["exp_dir"], name))
        ref = np.load(os.path.join(runs["jax"]["exp_dir"], name))
        assert ours.shape == ref.shape == (3, 1), name
        # the resumed run's own row; the JAX loop fills both of its rows
        np.testing.assert_allclose(ours[1], ref[1], rtol=1e-4)


def test_final_parameters_match_jax(runs):
    """Within 2 * lr * n_updates (4 updates of each optimizer): 1.2e-03
    for G1 and G2, 8.0e-04 for D.  Observed maxima on the CPU: G1 3.0e-08,
    G2 4.6e-08, D 2.1e-07 (no parameter took an Adam step of the other
    sign here)."""
    cfg = runs["jcfg"]
    jax_content = ocp.PyTreeCheckpointer().restore(
        os.path.join(runs["jax"]["exp_dir"], "content"))
    ours = ckpt.load_content(runs["port"]["exp_dir"])
    n_updates = cfg.num_epoch * STEPS_PER_EPOCH
    assert ours["global_step"] == int(jax_content["global_step"]) == n_updates
    assert ours["step"] == int(jax_content["step"]) == n_updates
    assert ours["counts"] == {"g1": n_updates, "g2": n_updates, "d": n_updates}
    for name, lr in (("g1", cfg.lr_g), ("g2", cfg.lr_g), ("d", cfg.lr_d)):
        want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                       jax_content[f"params_{name}"]))
        assert set(ours[name]) == set(want)
        err = max(float((ours[name][k] - want[k]).abs().max()) for k in want)
        assert err <= 2 * lr * n_updates, (name, err)


def test_artifacts_have_the_jax_names(runs):
    """The same files, with ``.pt`` for the orbax directories."""
    jdir = runs["jax"]["exp_dir"]
    want = sorted(n + ".pt" if os.path.isdir(os.path.join(jdir, n)) else n
                  for n in _names(jdir))
    assert _names(runs["port"]["exp_dir"]) == want
    assert {"content.pt", "gen_diffusive_1.pt", "gen_diffusive_2_1.pt", "sample_epoch_1.png",
            "collage_epoch_0.png", "train_config.json"} <= set(want)
    assert "content.pt" in runs["first_names"] and "preempted" not in runs["port"]
    assert runs["port"]["timings"]["restore_s"] is not None
    with open(os.path.join(runs["port"]["exp_dir"], "train_config.json")) as f:
        prov = json.load(f)
    assert prov["config"]["num_epoch"] == 2 and "git_commit" in prov


def test_sigterm_saves_content_and_resume_continues(data_root, tmp_path, monkeypatch):
    """SIGTERM during epoch 0's first iteration: the loop finishes it,
    writes content.pt, restores the old handler and returns preempted.
    The resumed run starts at epoch 1 and global step 1, so lazy R1 (every
    3 steps) falls on step 3, and it trains after a validation."""
    flags = []
    real_make_d_step = loop.make_d_step

    def recording_d_step():
        step = real_make_d_step()

        def d_step(state, batch, draws, with_r1):
            flags.append(with_r1)
            return step(state, batch, draws, with_r1)

        return d_step

    monkeypatch.setattr(loop, "make_d_step", recording_d_step)

    class Preempting(loop.SeededDraws):
        def iteration(self, real):
            signal.raise_signal(signal.SIGTERM)
            return super().iteration(real)

    cfg = _port_config(data_root, tmp_path, num_epoch=3, lazy_reg=3, use_ema=True)
    before = signal.getsignal(signal.SIGTERM)
    out = loop.train(cfg, verbose=False, device="cpu", draws=Preempting(cfg, "cpu"))
    assert out["preempted"] is True and signal.getsignal(signal.SIGTERM) is before
    content = ckpt.load_content(out["exp_dir"])
    assert (content["epoch"], content["global_step"], content["step"]) == (0, 1, 1)
    assert content["counts"] == {"g1": 1, "g2": 1, "d": 1} and content["ema_g1"] is not None
    assert flags == [True] and not os.path.exists(out["history"])

    out = train_cli.main([
        "--input_path", data_root, "--output_path", str(tmp_path), "--exp", "loop",
        "--image_size", "64", "--num_channels", "1", "--num_channels_dae", "16",
        "--ch_mult", "1", "2", "--num_res_blocks", "1", "--attn_resolutions", "8",
        "--z_emb_dim", "32", "--t_emb_dim", "32", "--nz", "8", "--ngf", "8",
        "--num_timesteps", "2", "--batch_size", "8", "--num_epoch", "3", "--lazy_reg", "3",
        "--log_every", "1", "--no_bf16", "--use_ema", "--resume", "--use_int8"],
        device="cpu")
    assert "preempted" not in out
    assert flags == [True, False, False, True, False]  # global steps 0 | 1, 2, 3, 4
    assert [h["epoch"] for h in _history(out)] == [1, 2]
    content = ckpt.load_content(out["exp_dir"])
    assert (content["epoch"], content["global_step"], content["step"]) == (2, 5, 5)
    assert all(np.isfinite(h["val_psnr"]) for h in _history(out))


def test_train_refuses_what_is_not_ported(data_root, tmp_path):
    # a mesh of more than one process is torchrun's (parallel.init_mesh)
    for over in (dict(dp=2), dict(fsdp=2)):
        with pytest.raises(ValueError, match="processes"):
            loop.train(_port_config(data_root, tmp_path, **over), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            loop.train(_port_config(data_root, tmp_path))


def test_maybe_profile_traces_the_steps_asked_for(tmp_path):
    """Steps 1-2 of 0-3 are traced into the directory given; none without
    one.  The trace holds the port's own spans (``utils/profiling.py``
    ``span``) of the D step traced, its norms among them; the untraced
    steps make none."""
    from mudiff_torch.train.steps import make_d_step

    cfg = MuDiffConfig(**{**TINY, "num_channels_dae": 8, "ngf": 2, "use_bf16": False})
    state = create_train_state(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = tuple(torch.randn(1, 64, 64, 1, generator=gen) for _ in range(4))
    d_step = make_d_step()
    timer = StepTimer()
    for step in range(4):
        with maybe_profile(step, str(tmp_path / "trace"), start=1, num=2):
            torch.ones(8).sum()
            if step == 2:
                d_step(state, batch, TrainDraws.draw(cfg, batch[3], gen), False)
        with maybe_profile(step, None, start=1, num=2):
            torch.ones(8).sum()
        timer.mark_step_done()
        timer.mark_data_ready()
    assert os.listdir(tmp_path) == ["trace"]
    trace = tmp_path / "trace" / "trace_steps_1-2.json"
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"mudiff.train.d_step", "mudiff.train.d_step.fake", "mudiff.g1",
            "mudiff.nn.norm", "mudiff.critic"} <= names
    assert 0.0 <= timer.data_time <= timer.window()
