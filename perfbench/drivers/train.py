"""Training: the published iteration (D step with lazy R1, then G step)
driven back to back.

Set-up builds the port's training state (``mudiff_torch.train.
create_train_state``: G1, G2, the critic, three Adams, remat as the
configuration states) with the traffic's attention lowering, loads the
run's seeded weights, makes a pool of phantom slices on the device, and
drives ``make_d_step`` then ``make_g_step`` on ``make_train_step``'s
schedule (R1 when ``state.step % lazy_reg == 0``), each under a span of
its own, from step 0 until the step
before the next R1 iteration: the first ``compare_steps`` of these are
the ones the check holds against the reference.  Each iteration takes
the next ``batch`` slices of a seeded permutation of the pool and its D
and G draws (``TrainDraws``) from a seed of its own.

The window opens at an R1 iteration and runs iterations until
``--seconds`` have passed; it closes at the synchronise after the last
one.  ``train_slices_per_s`` is iterations x batch over the window's
wall time.  The traced run profiles ``trace_iterations`` iterations from
an R1 iteration instead.

The check: the reference trains the same weights on the same batches
and draws for ``compare_steps`` iterations in float32.  Compared: each
loss of each of those steps; each leaf's first gradient as the optimizer
got it (Adam's first moment after one step over 1 - beta1); each leaf's
change after the last of them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from perfbench.arith import train_work
from perfbench.core import Ctx, Outcome
from perfbench.drivers import common
from perfbench.inputs.phantom import condition_pool
from perfbench.reference import diffusion
from perfbench.reference.ops import Exact
from perfbench.trace import TraceView, families, span, traced

POOL, PERM, D_DRAW, G_DRAW = 11, 12, 13, 14
LOSSES = ("D_real", "D_fake", "G_adv", "G_L1", "G_mask")
MODULES = ("g1", "g2", "d")


class Inputs:
    """The run's seeded batches and draws."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.batch = int(tr["batch"])
        self.pool = condition_pool(common.sub_seed(seed, POOL), tr["pool_patients"],
                                   tr["pool_slices"], cfg["image_size"], cfg["target_modality"],
                                   device)
        g = torch.Generator().manual_seed(common.sub_seed(seed, PERM))
        self.perm = torch.randperm(self.pool.shape[1], generator=g).to(device)
        self.rows = torch.arange(self.batch, device=device)
        self.gen = torch.Generator(device)

    def batch_of(self, i: int) -> Tuple[torch.Tensor, ...]:
        idx = self.perm[torch.remainder(self.rows + i * self.batch, self.perm.numel())]
        return tuple(self.pool[k].index_select(0, idx) for k in range(4))

    def draws_of(self, i: int, tag: int) -> Dict[str, torch.Tensor]:
        cfg, b = self.cfg, self.batch
        self.gen.manual_seed(common.sub_seed(self.seed, tag, i))
        s = cfg["image_size"]

        def normal(*shape):
            return torch.randn(shape, generator=self.gen, device=self.device)

        t = torch.randint(0, cfg["num_timesteps"], (b,), generator=self.gen, device=self.device)
        return {"t": t, "noise_t": normal(b, s, s, 1), "noise_tp1": normal(b, s, s, 1),
                "z": normal(b, cfg["nz"]), "noise_post1": normal(b, s, s, 1),
                "noise_post2": normal(b, s, s, 1)}


def build(ctx: Ctx, W):
    """The port's training state with the run's weights, and its step."""
    from mudiff_torch.config import MuDiffConfig
    from mudiff_torch.train import create_train_state
    mcfg = MuDiffConfig.from_dict(ctx.config)
    state = create_train_state(mcfg, seed=0, steps_per_epoch=int(ctx.traffic["steps_per_epoch"]),
                               device=ctx.device, attn=ctx.traffic["attn"])
    for name, mod in (("g1", state.g1), ("g2", state.g2), ("d", state.d), ("att", state.att_conv)):
        mod.load_state_dict(W[name])
    return state, make_step(mcfg)


def make_step(config):
    """``make_train_step``'s iteration, its D and G steps under spans of
    their own: ``step(state, batch, draws=(d_draws, g_draws))``."""
    from mudiff_torch.train.steps import make_d_step, make_g_step

    d_step, g_step = make_d_step(), make_g_step()
    lazy = config.lazy_reg

    def step(state, batch, draws):
        with span("d_step"):
            d_aux = d_step(state, batch, draws[0], lazy is None or state.step % lazy == 0)
        with span("g_step"):
            g_aux = g_step(state, batch, draws[1])
        return {**d_aux, **g_aux}

    return step


def iterate(state, step, inputs: Inputs, i: int) -> Dict[str, torch.Tensor]:
    from mudiff_torch.train.steps import TrainDraws

    draws = (TrainDraws(**inputs.draws_of(i, D_DRAW)), TrainDraws(**inputs.draws_of(i, G_DRAW)))
    return step(state, inputs.batch_of(i), draws=draws)


def first_grads(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """Each module's first gradient, from Adam's state after one step."""
    out = {}
    for name, opt in (("g1", state.opt_g1), ("g2", state.opt_g2), ("d", state.opt_d)):
        mod = getattr(state, name)
        beta1 = opt.param_groups[0]["betas"][0]
        leaves = [n for n, _ in mod.named_parameters()]
        # a step that never reached the optimizer leaves no moment: no gradient
        out[name] = {n: (opt.state[t]["exp_avg"] / (1.0 - beta1)).detach().clone()
                     if "exp_avg" in opt.state.get(t, {}) else torch.zeros_like(t)
                     for n, t in zip(leaves, state.sharded[name].tensors)}
    return out


def norms(tree: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, float]]:
    return {m: {k: float(v.float().norm()) for k, v in leaves.items()}
            for m, leaves in tree.items()}


def changes(params: Dict[str, Dict[str, torch.Tensor]], W) -> Dict[str, Dict[str, float]]:
    return {m: {k: float((v.detach() - W[m][k]).norm()) for k, v in params[m].items()}
            for m in MODULES}


def leaf_gaps(prog: Dict[str, Dict[str, float]], ref: Dict[str, Dict[str, float]],
              ref_grads: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """Each leaf's |program norm - reference norm| over the larger of the
    reference leaf's norm and its module's median leaf norm; leaves whose
    reference first gradient is under a thousandth of the module's median
    leaf gradient (nought to rounding, as a key's bias under the softmax)
    are left out."""
    out = {}
    for m in ref:
        gmed = torch.tensor(list(ref_grads[m].values())).median().item()
        med = torch.tensor(list(ref[m].values())).median().item()
        out[m] = {k: abs(prog[m][k] - r) / max(r, med, 1e-30) for k, r in ref[m].items()
                  if ref_grads[m][k] >= 1e-3 * gmed}
    return out


def worst_leaf(gaps: Dict[str, Dict[str, float]]) -> float:
    return max(v for leaves in gaps.values() for v in leaves.values())


def median_leaf(gaps: Dict[str, Dict[str, float]]) -> float:
    """The largest over the modules of the median leaf's gap."""
    return max(torch.tensor(list(leaves.values())).median().item() for leaves in gaps.values())


def loss_gap(prog: List[Dict[str, float]], ref: List[Dict[str, float]], names) -> float:
    return max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30) for p, r in zip(prog, ref) for k in names)


# The losses of the first step that come from the initial weights alone:
# D's on the real and fake samples (before D's update) and G's L1 (G's
# output only).  The later losses ride on a critic that one Adam step has
# moved along the sign of every gradient, which bf16's rounding flips for
# the near-zero ones: their logits, and the losses on them, differ by
# amounts unrelated to the step's arithmetic (PERF.md).
FIRST_STEP = ("D_real", "D_fake", "G_L1")


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared, from the program's and the reference's
    losses, first-gradient norms and change norms."""
    g = leaf_gaps(prog["grads"], ref["grads"], ref["grads"])
    c = leaf_gaps(prog["changes"], ref["changes"], ref["grads"])
    return {"loss_gap_first": loss_gap(prog["losses"][:1], ref["losses"][:1], FIRST_STEP),
            "loss_gap_all": loss_gap(prog["losses"], ref["losses"], LOSSES),
            "r1_rel_gap": loss_gap(prog["losses"][:1], ref["losses"][:1], ("R1",)),
            "grad_norm_gap_median": median_leaf(g), "grad_norm_gap_worst": worst_leaf(g),
            "change_norm_gap": worst_leaf(c)}


def details(prog: dict, ref: dict, top: int = 6) -> dict:
    """Where the readings come from: each loss's gap by step, and the
    leaves with the widest norm gaps (program, reference, module median)."""
    out = {"losses": [{k: [p[k], r[k], abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)]
                       for k in LOSSES + ("R1",)} for p, r in zip(prog["losses"], ref["losses"])]}
    for what in ("grads", "changes"):
        rows = []
        for m in ref[what]:
            gmed = torch.tensor(list(ref["grads"][m].values())).median().item()
            med = torch.tensor(list(ref[what][m].values())).median().item()
            for k, r in ref[what][m].items():
                if ref["grads"][m][k] < 1e-3 * gmed:
                    continue
                rows.append([abs(prog[what][m][k] - r) / max(r, med, 1e-30), f"{m}/{k}",
                             prog[what][m][k], r, med])
        out[what] = sorted(rows, reverse=True)[:top]
    return out


def reference_run(ctx: Ctx, inputs: Inputs, prec=None) -> dict:
    """The reference's losses, first-gradient norms and change norms over
    the first ``compare_steps`` iterations."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    W = common.weights(cfg, ctx.seed, dev, ("g1", "g2", "d", "att"))
    P = {m: {k: v.clone() for k, v in W[m].items()} for m in MODULES}
    trainer = diffusion.Trainer(prec or Exact(), cfg, P["g1"], P["g2"], P["d"], W["att"],
                                int(tr["steps_per_epoch"]), ckpt=True)
    losses = []
    with common.exact_fp32():
        for i in range(int(tr["compare_steps"])):
            d, g = inputs.draws_of(i, D_DRAW), inputs.draws_of(i, G_DRAW)
            losses.append(trainer.iteration(inputs.batch_of(i), diffusion.Draws(**d),
                                            diffusion.Draws(**g)))
    out = {"losses": losses, "grads": norms(trainer.first_grads),
           "changes": changes({"g1": trainer.G1, "g2": trainer.G2, "d": trainer.D}, W)}
    del trainer, P, W
    common.free(dev)
    return out


def run(ctx: Ctx) -> Outcome:
    common.check_world()
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    out = Outcome()
    lazy = int(cfg["lazy_reg"])
    ph = out.phases
    ph["start"] = common.now() - ctx.t0
    with span("setup"):
        with common.phase(ph, "kernels"):
            common.build_kernels(dev)
        with common.phase(ph, "inputs"):
            W = common.weights(cfg, ctx.seed, dev, ("g1", "g2", "d", "att"))
            inputs = Inputs(cfg, tr, ctx.seed, dev)
            common.sync(dev)
        with common.phase(ph, "build"):
            state, step = build(ctx, W)
            common.sync(dev)
        t_warm = common.now()
        prog = {"losses": []}
        n_cmp = int(tr["compare_steps"])
        i = 0
        while i < n_cmp or state.step % lazy:
            losses = iterate(state, step, inputs, i)
            if i < n_cmp:
                prog["losses"].append({k: float(v) for k, v in losses.items()})
            if i == 0:
                prog["grads"] = norms(first_grads(state))
            if i == n_cmp - 1:
                prog["changes"] = changes({m: dict(getattr(state, m).named_parameters())
                                           for m in MODULES}, W)
            i += 1
        del W
        common.sync(dev)
        ph["warmup"] = common.now() - t_warm
    out.metrics["setup_s"] = common.now() - ctx.t0
    common.free(dev)
    common.reset_peak(dev)
    b = inputs.batch
    start = i
    if ctx.trace:
        holder: dict = {}
        with traced(holder):
            for _ in range(int(tr["trace_iterations"])):
                with span("iteration"):
                    iterate(state, step, inputs, i)
                i += 1
        from perfbench.peaks import peaks_for

        n = i - start
        work = train_work(cfg, b, True)
        if n > 1:
            work = work + train_work(cfg, b, False).scaled(n - 1)
        out.trace = TraceView("train", holder["kernels"], holder["window_s"], n * b, work,
                              peaks_for(torch.cuda.get_device_name(0)), families(ctx.root),
                              holder["gaps"])
    else:
        t = common.now()
        while True:
            iterate(state, step, inputs, i)
            i += 1
            if common.now() - t >= ctx.seconds:
                break
        common.sync(dev)
        out.metrics["train_slices_per_s"] = (i - start) * b / (common.now() - t)
    out.memory_peak_bytes = common.peak_bytes(dev)
    out.metrics["peak_mem_gib"] = out.memory_peak_bytes / common.GIB
    out.attempted = i - start
    del state, step
    common.free(dev)
    with common.phase(ph, "check"):
        out.readings = readings(prog, reference_run(ctx, inputs))
    return out
