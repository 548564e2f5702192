"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run at a tiny size on the CPU (the look
for a card skipped) with one fault planted in the port, once for each
fault the cell can have: a served answer altered where it is produced;
a training step that leaves its state unchanged; a training step that
leaves out half of its batch and takes its means over the rest.  The
sound run of the same cell comes out correct under the same limits."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench.tests.tiny import run_cell, tiny_config, tiny_traffic  # noqa: E402

SAMPLE_CELLS = ["nf128.sample.b8.bf16", "nf64.sample.b32.w8a8s", "nf64.sample.b32.bf16"]
TRAIN = "nf128.train.b2"


def _train_run(**kw):
    return run_cell(TRAIN, config=tiny_config("mudiff_nf128", image_size=64, lazy_reg=4),
                    traffic=tiny_traffic("train.b2", batch=2), **kw)


@pytest.mark.parametrize("cell", SAMPLE_CELLS)
def test_sound_sampling_run_is_correct(cell):
    rc, res, err = run_cell(cell)
    assert rc == 0 and res["correct"], err


@pytest.mark.parametrize("cell", SAMPLE_CELLS)
def test_altered_answer_is_caught(cell, monkeypatch):
    import mudiff_torch.sampler as sampler_mod

    real = sampler_mod.sample_from_model

    def altered(*a, **kw):
        x = real(*a, **kw)
        x[0] = torch.flip(x[0], dims=(0,))  # one slice of the answer, upside down
        return x

    monkeypatch.setattr(sampler_mod, "sample_from_model", altered)
    rc, res, err = run_cell(cell)
    assert rc == 0 and res["correct"] is False, err


def test_sound_training_run_is_correct():
    rc, res, err = _train_run()
    assert rc == 0 and res["correct"], err


def test_step_that_leaves_state_unchanged_is_caught(monkeypatch):
    from mudiff_torch.train.state import TrainState

    def no_d(self, grads):
        self.counts["d"] += 1

    def no_g(self, g1, g2):
        self.counts["g1"] += 1
        self.counts["g2"] += 1
        self.step += 1

    monkeypatch.setattr(TrainState, "apply_d_updates", no_d)
    monkeypatch.setattr(TrainState, "apply_g_updates", no_g)
    rc, res, err = _train_run()
    assert rc == 0 and res["correct"] is False, err
    assert res["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_step_on_half_the_batch_is_caught(monkeypatch):
    import mudiff_torch.train.steps as steps

    def halved(make):
        def made():
            step = make()

            def half(state, batch, draws, *rest):
                n = batch[0].shape[0] // 2
                draws = steps.TrainDraws(**{k: getattr(draws, k)[:n] for k in (
                    "t", "noise_t", "noise_tp1", "z", "noise_post1", "noise_post2")})
                return step(state, tuple(x[:n] for x in batch), draws, *rest)

            return half

        return made

    monkeypatch.setattr(steps, "make_d_step", halved(steps.make_d_step))
    monkeypatch.setattr(steps, "make_g_step", halved(steps.make_g_step))
    rc, res, err = _train_run()
    assert rc == 0 and res["correct"] is False, err
