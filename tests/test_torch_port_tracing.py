"""The port's spans (``mudiff_torch/utils/profiling.py`` ``span``) on the CPU.

Outside a profiler ``span`` is one shared no-op and never reaches
``record_function``; under ``torch.profiler`` the sampler, the
generators' regions, the norms, K1's two gradients, the critic, the
remat recomputes and the training steps' parts appear, nested as the
code nests them, and ``perfbench/attribution.py`` puts the backward's
kernels down to the forward spans through the autograd link.  The
outputs are the same bits with the profiler on and off.

On a card the autograd engine runs a backward on a thread of its own,
where the caller's spans are not open; on the CPU it runs on the
caller's thread.  ``_engine_thread`` moves what ran inside the engine's
``evaluate_function`` ranges to a thread of its own, as a card's trace
has it, and ``_kernels_for`` gives every innermost op one launch and one
kernel, so the attribution runs on the ops and sequence numbers the CPU
profiler really recorded.
"""

import bisect
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mudiff_torch.config import brats_recipe  # noqa: E402
from mudiff_torch.diffusion.sampling import sample_from_model  # noqa: E402
from mudiff_torch.diffusion.schedule import PosteriorCoefficients  # noqa: E402
from mudiff_torch.models.generator import NCSNppGenerator  # noqa: E402
from mudiff_torch.train import create_train_state  # noqa: E402
from mudiff_torch.train.steps import (  # noqa: E402
    TrainDraws,
    d_loss_and_grads,
    make_d_step,
    make_g_step,
)
from mudiff_torch.utils import profiling  # noqa: E402
from perfbench.attribution import Event, attribute, split_events  # noqa: E402

ENGINE = 10 ** 6   # the thread id given to the emulated autograd thread


def _config(**over):
    kw = dict(image_size=64, num_channels_dae=8, ch_mult=(1, 2), num_res_blocks=1,
              attn_resolutions=(32,), z_emb_dim=16, t_emb_dim=16, nz=4, ngf=2,
              use_bf16=False, lazy_reg=4, use_grad_checkpoint=True,
              grad_checkpoint_policy="hires")
    kw.update(over)
    return brats_recipe(**kw)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    res = prof.profiler.kineto_results
    return out, split_events(res.events(), res.trace_start_ns())


def _paths(events):
    """The span paths the window holds (the span table's first column)."""
    _, _, ops, spans = events
    return set(attribute([], [], ops, spans).host_s)


def _engine_thread(ops, spans):
    """What ran inside the outermost ``evaluate_function`` ranges, moved to
    the thread ``ENGINE``, and the backward nodes whose forward op moved
    pointed there."""
    evals = sorted((o.start, o.end) for o in ops
                   if o.name.startswith("autograd::engine::evaluate_function"))
    outer = []
    for s, e in evals:
        if outer and s <= outer[-1][1]:
            outer[-1] = (outer[-1][0], max(outer[-1][1], e))
        else:
            outer.append((s, e))

    starts = [s for s, _ in outer]

    def inside(x):
        i = bisect.bisect_right(starts, x.start) - 1
        return i >= 0 and x.start <= outer[i][1]

    # the forward ops a backward ran (create_graph); a node's own range
    # carries its node's number, not a forward op's
    moved = {(o.thread, o.seq) for o in ops if inside(o) and o.seq >= 0 and not o.fwd_thread}
    new_ops = []
    for o in ops:
        fwd = o.fwd_thread
        if fwd and (fwd, o.seq) in moved:
            fwd = ENGINE
        new_ops.append(o._replace(thread=ENGINE if inside(o) else o.thread, fwd_thread=fwd))
    new_spans = [s._replace(thread=ENGINE) if inside(s) else s for s in spans]
    return new_ops, new_spans


def _kernels_for(ops):
    """One launch call and one 1-us kernel for every op no other op of its
    thread nests inside (the op that would launch on a card)."""
    calls, kernels = [], []
    by_thread = {}
    for o in ops:
        by_thread.setdefault(o.thread, []).append(o)
    corr = 1
    for group in by_thread.values():
        group.sort(key=lambda x: (x.start, -x.end))
        for i, o in enumerate(group):
            nxt = group[i + 1] if i + 1 < len(group) else None
            if nxt is not None and nxt.start <= o.end:
                continue  # it has a child
            t = 0.5 * (o.start + o.end)
            calls.append(Event("cudaLaunchKernel", t, t, o.thread, corr, o.corr))
            kernels.append(Event(f"k:{o.name}", 1.0 + corr * 1e-6, 1.0 + (corr + 0.5) * 1e-6,
                                 o.thread, corr))
            corr += 1
    return kernels, calls


@pytest.fixture(scope="module")
def state():
    torch.manual_seed(0)
    return create_train_state(_config(), device="cpu")


def _draws(cfg, real, seed):
    return TrainDraws.draw(cfg, real, torch.Generator().manual_seed(seed))


def _batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(2, 64, 64, 1, generator=g) for _ in range(4))


def test_span_is_the_shared_no_op_outside_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("nn.norm") is profiling._OFF
    assert profiling.span("sample.step", {"t": 3}) is profiling._OFF
    with profiling.span("nn.norm"):
        pass
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("sample.step", {"t": 3}):
            with profiling.span("nn.norm"):
                torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert "mudiff.sample.step" in names and "mudiff.nn.norm" in names
    assert profiling.span("nn.norm") is profiling._OFF


def test_generator_forward_and_backward_spans_nest():
    cfg = _config(image_size=32, attn_resolutions=(16,))
    g = NCSNppGenerator(cfg, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(2)
    x, c1, c2, c3 = (torch.randn(2, 32, 32, 1, generator=gen) for _ in range(4))
    z = torch.randn(2, cfg.nz, generator=gen)
    t = torch.tensor([0, 3])

    def run():
        x0 = g(x, c1, c2, c3, t, z)
        x0.square().mean().backward()
        return x0

    _, events = _profiled(run)
    paths = _paths(events)
    for p in ("g1", "g1/temb", "g1/stems", "g1/stems/nn.norm", "g1/down_0_0",
              "g1/down_0_0/nn.norm", "g1/downsample_0", "g1/mid_block1", "g1/mid_attn/nn.norm",
              "g1/up_1_0", "g1/upsample_1", "g1/pyramid", "g1/head/nn.norm",
              # the backward: K1's two gradients, the regions' recomputes
              "ops.conv3x3.dx", "ops.conv3x3.dw", "remat.down_0_0",
              "remat.down_0_0/nn.norm", "remat.stems", "remat.mid_attn/nn.norm"):
        assert p in paths, (p, sorted(paths))
    assert not any(p.startswith("g1/") and "remat." in p for p in paths)
    # the kernel wrappers' forwards carry no span of their own (PERF.md: their cost)
    assert not any(p.split("/")[-1] in ("ops.conv3x3", "ops.fir_down2", "ops.fir_up2")
                   for p in paths)


def test_training_iteration_spans_and_the_autograd_link(state):
    cfg = state.config
    batch = _batch()
    d_step, g_step = make_d_step(), make_g_step()
    assert state.step % cfg.lazy_reg == 0  # an R1 iteration

    def iteration():
        d_step(state, batch, _draws(cfg, batch[3], 3), True)
        g_step(state, batch, _draws(cfg, batch[3], 4))

    _, (_, _, ops, spans) = _profiled(iteration)
    paths = _paths((None, None, ops, spans))
    for p in ("train.d_step", "train.d_step/train.d_step.real/critic",
              "train.d_step/train.d_step.r1",
              "train.d_step/train.d_step.fake/g1/down_0_0/nn.norm",
              "train.d_step/train.d_step.fake/g2/fuse", "train.d_step/train.d_step.fake/critic",
              "train.d_step/train.d_step.grads", "train.d_step/train.d_step.adam",
              "train.g_step/train.g_step.forward/g1/down_0_0/nn.norm",
              "train.g_step/train.g_step.forward/g2/encode/nn.norm",
              "train.g_step/train.g_step.forward/critic", "train.g_step/train.g_step.mask",
              "train.g_step/train.g_step.grads/remat.down_0_0/nn.norm",
              "train.g_step/train.g_step.grads/ops.conv3x3.dw",
              "train.g_step/train.g_step.adam"):
        assert p in paths, (p, sorted(paths))

    ops, spans = _engine_thread(ops, spans)
    kernels, calls = _kernels_for(ops)
    att = attribute(kernels, calls, ops, spans)
    by_path = {}
    for _, s, e, p, rule in att.kernels:
        by_path.setdefault(p, set()).add(rule)
    rules = {r for v in by_path.values() for r in v}
    assert {1, 2} <= rules
    # the norms' backward kernels reach nn.norm through the autograd link
    norm_bwd = [p for p, r in by_path.items() if 2 in r and p.endswith("nn.norm/backward")]
    assert any(p.startswith("train.g_step/train.g_step.forward/g1/") for p in norm_bwd)
    assert any(p.startswith("train.g_step/train.g_step.forward/g2/") for p in norm_bwd)
    # the critic's: its backward in the G step and the D step, R1's
    # double backward included (followed through the first backward)
    critic_bwd = {p for p, r in by_path.items() if 2 in r and "critic" in p.split("/")}
    assert any(p.startswith("train.g_step/train.g_step.forward/critic") for p in critic_bwd)
    assert any(p.startswith("train.d_step/train.d_step.real/critic") for p in critic_bwd)
    assert any(p.startswith("train.d_step/train.d_step.fake/critic") for p in critic_bwd)
    # the recompute and K1's dw stay on the engine thread's own spans
    assert any(p.startswith("remat.") and p.endswith("nn.norm") for p in by_path)
    assert "ops.conv3x3.dw" in by_path
    assert att.device_s("nn.norm") > 0 and att.device_s("critic") > 0
    share = att.rule_shares()
    assert share[4] < 0.05, share


def test_outputs_are_the_same_bits_with_the_profiler_on(state):
    cfg = state.config
    batch = _batch(5)
    draws = _draws(cfg, batch[3], 6)
    plain_grads, plain_aux = d_loss_and_grads(state, batch, draws, True)
    (grads, aux), _ = _profiled(lambda: d_loss_and_grads(state, batch, draws, True))
    for a, b in zip(plain_grads, grads):
        assert torch.equal(a, b)
    assert all(torch.equal(plain_aux[k], aux[k]) for k in aux)

    post = PosteriorCoefficients.from_config(cfg).as_tensors("cpu")
    g = torch.Generator().manual_seed(7)
    conds = [torch.randn(2, 64, 64, 1, generator=g) for _ in range(3)]
    x_init = torch.randn(2, 64, 64, 1, generator=g)
    noise = [(torch.randn(2, cfg.nz, generator=g), torch.randn(2, 64, 64, 1, generator=g))
             for _ in range(cfg.num_timesteps)]
    state.g1.eval()
    state.g2.eval()
    try:
        with torch.no_grad():
            def sample():
                return sample_from_model(post, state.g1, state.g2, *conds, x_init,
                                         cfg.num_timesteps, cfg.nz, noise=noise,
                                         compute_dtype=torch.float32)

            plain = sample()
            traced, events = _profiled(sample)
    finally:
        state.g1.train()
        state.g2.train()
    assert torch.equal(plain, traced)
    paths = _paths(events)
    assert {"sample.step", "sample.step/g1/down_0_0/nn.norm", "sample.step/g2/fuse",
            "sample.step/sample.posterior"} <= paths
