#!/usr/bin/env python3
"""How far the bf16 volume and the main path's sample through the port's
kernels lie from the same through their plain versions, over seeds and
beside K1 and K3 faults of known size.  Needs one NVIDIA GPU.

    python3 volume_drift.py [--seeds 0 1 2] [--fp32 | --int8 | --branch B1|B2]
        [--iteration [--cudnn fixed|free]] [--out FILE.json]

For each seed, ``chip_smoke.py``'s volume phase is run in bf16 (in fp32,
``--no_bf16``, with ``--fp32``) with ``--attn flash``: the weights, the three synthetic contrasts and the
CLI's ``--seed`` are all made from the seed (seed 0 is the smoke's own
volume).  Each seed's volume is predicted

- with every plain version forced (the reference of the comparison);
- with every kernel (what the smoke holds to ``BF16_VOLUME_TOL``, or
  in fp32 to ``SAMPLE_TOL["fp32"]``);
- with K1 alone through its kernel (K2 and K3 plain), so the difference
  from the reference is K1's;
- with K5 (GroupNorm) alone replaced by its plain version (K1's path
  checks need K1 on its kernel), so the rest is K5's;
- with K3 alone replaced by its plain version, so the difference from
  the reference is K1's and K2's and the rest is K3's;
- with K3 given a scale off by a factor 1 + eps (``FAULTS``): the kernel
  as a K3 fault of that size would leave it;
- with K1 faulted in one conv of each generator, the head (``final_conv``,
  Cout = 1): its weight scaled by 1 + eps (``K1_FAULTS``), or its tap
  (0, 0) dropped.

Each prints the max abs difference from the reference over the volume
and the mean abs difference over the predicted slices, in the sampler's
[-1, 1] units.  For each seed the main path's sample (a batch-4 request
of the smoke's sampler, bf16-score attention, injected noise) is read
the same way: every kernel, K1 alone, K5 alone, and the K1 faults, each against
the plain versions (what the smoke holds to ``SAMPLE_TOL``).  For each
fault the script also prints whether the smoke's per-shape check
rejects it: K3's (``FLASH_TOL``) at (8, 4096, 256), K1's (``TOL``) at the
head's shape.  The last line is a summary.

With ``--int8`` only the int8 leg's samples are read, for each seed and
each mode (dynamic scales; static ones that ``calibrate_sampler``
records, as ``chip_smoke.int8_samplers`` makes them): the W8A8 sample
through every kernel, through K4 alone (the others plain, so the
difference is K4's), through K1 alone and through K5 alone, each against the same sample
with every plain version forced (what the smoke holds to
``INT8_SAMPLE_TOL``), and the int8 sample against the bf16 one.

With ``--branch B1`` or ``--branch B2`` (``chip_smoke.BRANCHES``: the
one-AdaGN generator with the output_skip and input_skip pyramids; the
ddpm one with the residual pyramids), the same recipe width with that
branch's flags, for each seed: the sample and the int8 samples as above,
each also with K1 through its kernel at the Cout = 1 convs alone and
everywhere but there (B1's Cout = 1 convs are its output pyramid's), the
int8 dynamic sample also under the K1 faults; and one D (R1) + G
iteration (batch 2, bf16, ``attn="flash"``) through every kernel, K1
alone, K2 alone, K3 alone (forward and backward), K5 alone and the plain versions
with TF32 allowed and with cuDNN's heuristic algorithms (controls with
no kernel), each against the iteration with every plain version forced
and against the fp32 one: the largest
relative gradient error over the tensors the smoke holds
(``chip_smoke.grad_errors``), the tensor nearest its limit in the smoke
and each stem conv's.  Their readings set ``BRANCH_TOL`` and ``SPREAD``
in ``chip_smoke.py``.

With ``--iteration`` (and ``--branch`` or not) only the mask loss of
phase 14's iteration is read, seed by seed on phase 14's own state, under
the smoke's fixed cuDNN choice or (``--cudnn free``) the timed one
(``mask_readings``).  Its readings set ``MASK_TOL``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import tempfile
import time

import chip_smoke as smoke

FAULTS = (0.005, 0.02, 0.08)
K1_FAULTS = (0.02, 0.08)
BRANCH_NAMES = {"B1": "B1 pyramid", "B2": "B2 ddpm"}


@contextlib.contextmanager
def attention_as(fn):
    """Run every ``AttnBlockpp`` flash attention through ``fn``."""
    from mudiff_torch.nn import blocks

    saved = blocks.flash_attn
    blocks.flash_attn = fn
    try:
        yield
    finally:
        blocks.flash_attn = saved


def head_weight_scaled(eps: float):
    return lambda w: (w.float() * (1.0 + eps)).to(w.dtype)


def head_tap_dropped(w):
    w = w.clone()
    w[0, 0] = 0
    return w


@contextlib.contextmanager
def k1_head_fault(fault):
    """K1 run with weight ``fault(w)`` in every conv with Cout = 1: each
    generator's ``final_conv``, the one such conv of the sampler.  The
    plain versions, where forced, keep the true weight."""
    from mudiff_torch.ops._dispatch import current_mode

    mod = sys.modules["mudiff_torch.ops.conv3x3"]
    real = mod._conv

    def faulty(x, w, bias):
        forced_plain = current_mode()[0]
        return real(x, fault(w) if w.shape[-1] == 1 and not forced_plain else w, bias)

    mod._conv = faulty
    try:
        yield
    finally:
        mod._conv = real


@contextlib.contextmanager
def k1_at_head(only: bool):
    """K1 through its kernel only in the convs with Cout = 1 (``only``;
    B1's three pyramid convs of each generator, else the head) or only
    in the others (not ``only``); every other kernel plain."""
    mod = sys.modules["mudiff_torch.ops.conv3x3"]
    real = mod._conv

    def routed(x, w, bias):
        if (w.shape[-1] == 1) == only:
            return real(x, w, bias)
        return mod.conv3x3_plain(x, w, bias)

    mod._conv = routed
    try:
        with smoke.kernels_only("conv3x3"):
            yield
    finally:
        mod._conv = real


def branch_variants() -> dict:
    """{label: context} read on a branch's samples beyond the recipe's:
    K1 at the Cout = 1 convs alone and everywhere but there."""
    return {"K1 at Cout = 1 alone": lambda: k1_at_head(True),
            "K1 except at Cout = 1": lambda: k1_at_head(False)}


def k1_faults() -> dict:
    """{label: fault} of the K1 faults read."""
    faults = {f"K1 head weight x (1 + {eps})": head_weight_scaled(eps) for eps in K1_FAULTS}
    faults["K1 head tap (0, 0) dropped"] = head_tap_dropped
    return faults


def scaled_kernel(eps: float):
    from mudiff_torch.ops import flash_attn

    return lambda q, k, v, scale: flash_attn(q, k, v, scale * (1.0 + eps))


def per_shape_check(eps: float, dtype: str) -> dict:
    """The smoke's K3 check at the volume's shape in ``dtype`` ("bf16" or
    "fp32"), on a kernel whose scale is off by 1 + eps: max abs error and
    whether it is rejected."""
    import torch

    from mudiff_torch.ops import flash_attn_plain

    b, length, c = smoke.VOLUME_BATCH, 4096, 256
    scale = float(c) ** -0.5
    g = torch.Generator(smoke.DEVICE).manual_seed(smoke.SEED + 3)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = (2.0 * torch.randn((b, length, c), generator=g, device=smoke.DEVICE)).to(dt)
    k, v = (torch.randn((b, length, c), generator=g, device=smoke.DEVICE).to(dt)
            for _ in range(2))
    got = scaled_kernel(eps)(q, k, v, scale).float()
    want = flash_attn_plain(q, k, v, scale).float()
    atol, rtol = smoke.FLASH_TOL[dtype]
    err = (got - want).abs()
    return {"max_abs_err": float(err.max()),
            "rejected": bool((err > atol + rtol * want.abs()).any())}


def k1_per_shape_check(fault, dtype: str) -> dict:
    """The smoke's K1 check at the head's shape (batch 4, 256^2, 64 ->
    1) in ``dtype``, on the kernel under ``fault`` against the plain
    version of the true weight: max abs error and whether it is
    rejected."""
    import torch

    from mudiff_torch.ops import conv3x3, conv3x3_plain

    g = torch.Generator(smoke.DEVICE).manual_seed(smoke.SEED + 1)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    x = torch.randn((smoke.BATCH, smoke.IMAGE, smoke.IMAGE, smoke.NF), generator=g,
                    device=smoke.DEVICE).to(dt)
    w = (torch.randn((3, 3, smoke.NF, 1), generator=g, device=smoke.DEVICE)
         / math.sqrt(9 * smoke.NF)).to(dt)
    bias = 0.1 * torch.randn((1,), generator=g, device=smoke.DEVICE)
    with k1_head_fault(fault):
        got = conv3x3(x, w, bias).float()
    want = conv3x3_plain(x, w, bias).float()
    atol, rtol = smoke.TOL[dtype]
    err = (got - want).abs()
    return {"max_abs_err": float(err.max()),
            "rejected": bool((err > atol + rtol * want.abs()).any())}


def sample_readings(cfg, sampler, seed: int, card: str, extra: dict | None = None) -> dict:
    """The main path's sample (chip_smoke's phase 8 on this seed's
    weights, conditions and noise) under each variant, against the same
    sample with every plain version forced: max abs difference."""
    import torch

    from mudiff_torch import ops

    g = torch.Generator(smoke.DEVICE).manual_seed(seed + 30)
    conds = smoke.conditions(g, smoke.DEVICE)
    shape = (smoke.BATCH, smoke.IMAGE, smoke.IMAGE, 1)
    x_init = torch.randn(shape, generator=g, device=smoke.DEVICE)
    noise = [(torch.randn((smoke.BATCH, cfg.nz), generator=g, device=smoke.DEVICE),
              torch.randn(shape, generator=g, device=smoke.DEVICE))
             for _ in range(cfg.num_timesteps)]
    with ops.plain_kernels():
        ref = sampler(*conds, x_init=x_init, noise=noise)
    variants = {"sample: kernels": contextlib.nullcontext,
                "sample: K1 alone": lambda: smoke.kernels_only("conv3x3"),
                "sample: K5 alone": lambda: smoke.kernels_only("group_norm_act"),
                **{f"sample: {label}": (lambda fault=fault: k1_head_fault(fault))
                   for label, fault in k1_faults().items()},
                **{f"sample: {label}": context for label, context in (extra or {}).items()}}
    out = {}
    for label, context in variants.items():
        ops.reset_launch_counts()
        with context():
            got = sampler(*conds, x_init=x_init, noise=noise)
        out[label] = {"max_abs": float((got - ref).abs().max()),
                      "launches": ops.launch_counts()}
        print(json.dumps({"card": card, "seed": seed, "variant": label, **out[label]}),
              flush=True)
    return out


def int8_sample_readings(cfg, sampler, seed: int, card: str,
                         extra: dict | None = None) -> dict:
    """The int8 leg's samples on this seed's weights, conditions and
    noise, in both modes, under each variant (and, with dynamic scales,
    each of ``extra``) against the same sample with every plain version
    forced: max abs difference; and the int8 sample against the bf16
    one."""
    import torch

    from mudiff_torch import ops

    g = torch.Generator(smoke.DEVICE).manual_seed(seed + 30)
    conds = smoke.conditions(g, smoke.DEVICE)
    shape = (smoke.BATCH, smoke.IMAGE, smoke.IMAGE, 1)
    x_init = torch.randn(shape, generator=g, device=smoke.DEVICE)
    noise = [(torch.randn((smoke.BATCH, cfg.nz), generator=g, device=smoke.DEVICE),
              torch.randn(shape, generator=g, device=smoke.DEVICE))
             for _ in range(cfg.num_timesteps)]
    bf16 = sampler(*conds, x_init=x_init, noise=noise)
    dynamic, static, _ = smoke.int8_samplers(cfg, sampler, seed)
    variants = {"kernels": contextlib.nullcontext,
                "K4 alone": lambda: smoke.kernels_only("int8_conv3x3"),
                "K1 alone": lambda: smoke.kernels_only("conv3x3"),
                "K5 alone": lambda: smoke.kernels_only("group_norm_act")}
    out = {}
    for mode, s in (("dynamic", dynamic), ("static", static)):
        with ops.plain_kernels():
            ref = s(*conds, x_init=x_init, noise=noise)
        more = (extra or {}) if mode == "dynamic" else {}
        for label, context in {**variants, **more}.items():
            ops.reset_launch_counts()
            with context():
                got = s(*conds, x_init=x_init, noise=noise)
            key = f"int8 {mode} sample: {label}"
            out[key] = {"max_abs": float((got - ref).abs().max()),
                        "launches": ops.launch_counts()}
            print(json.dumps({"card": card, "seed": seed, "variant": key, **out[key]}),
                  flush=True)
        key = f"int8 {mode} sample vs bf16 sample (kernels)"
        out[key] = {"max_abs": float((s(*conds, x_init=x_init, noise=noise) - bf16)
                                     .abs().max())}
        print(json.dumps({"card": card, "seed": seed, "variant": key, **out[key]}), flush=True)
    return out


def iteration_readings(cfg, seed: int, card: str) -> dict:
    """One D (R1) + G iteration on this seed's weights, batch and draws,
    in bf16 through every kernel, K1 alone, K2 alone, K3 alone and K5 alone, and
    through the plain versions with TF32 allowed and with cuDNN's
    heuristic algorithms (no kernel: the summation order moves, as K1's
    does), each against the bf16 iteration with every plain version
    forced and against the fp32 one (the plain versions, TF32 off): the
    largest relative gradient error over the tensors the smoke holds
    (``chip_smoke.grad_errors``), its tensor, the tensor nearest the limit
    ``chip_smoke.compare_iteration`` gives it, each stem conv's error (the
    generators' first, 1-channel convs) and every tensor's
    (``per_tensor``, in the ``--out`` file)."""
    import torch

    from mudiff_torch.train import TrainDraws, create_train_state

    state = create_train_state(cfg, seed=seed, device=smoke.DEVICE, attn="flash")
    g = torch.Generator(smoke.DEVICE).manual_seed(seed + 50)
    for module in (state.g1, state.g2, state.d):
        smoke.randomize_(module, g)
    shape = (smoke.TRAIN_BATCH, smoke.IMAGE, smoke.IMAGE, 1)
    batch = [torch.randn(shape, generator=g, device=smoke.DEVICE).tanh() for _ in range(4)]
    draws = tuple(TrainDraws.draw(cfg, batch[3], g) for _ in range(2))
    state32 = smoke.fp32_copy(cfg, state)
    _, exact, _ = smoke.iteration_grads(state32, batch, draws, plain=True)
    del state32
    _, ref, _ = smoke.iteration_grads(state, batch, draws, plain=True)
    held, _ = smoke.grad_errors(ref, ref, exact)
    rounding = {n: smoke.rel_err(ref[n], exact[n]) for n in held}
    limit = {n: max(smoke.TRAIN_TOL["bf16"][1], smoke.SPREAD * d) for n, d in rounding.items()}
    stems = [n for n in held if ".encoder_" in n and n.endswith(".conv1.weight")
             or n.endswith("pseudo_gap.conv1.weight")]

    def reading(grads, against_plain: bool) -> dict:
        out = {}
        for name, base in (("vs_plain", ref), ("vs_fp32_plain", exact)):
            if name == "vs_plain" and not against_plain:
                continue
            errors = {n: smoke.rel_err(grads[n], base[n]) for n in held}
            worst = max(errors, key=errors.get)
            out[name] = {"max_grad_rel_err": errors[worst], "worst_tensor": worst,
                         "median": sorted(errors.values())[len(errors) // 2],
                         "stems": {n: errors[n] for n in stems}, "per_tensor": errors}
            if name == "vs_plain":
                nearest = max(errors, key=lambda n: errors[n] / limit[n])
                out[name]["nearest_its_limit"] = {"tensor": nearest, "err": errors[nearest],
                                                  "limit": limit[nearest]}
        return out

    variants = {"kernels": contextlib.nullcontext,
                "K1 alone": lambda: smoke.kernels_only("conv3x3"),
                "K2 alone": lambda: smoke.kernels_only("fir_down2", "fir_up2"),
                "K3 alone": lambda: smoke.kernels_only("flash_attn", "flash_attn_bwd_dkv",
                                                       "flash_attn_bwd_dq"),
                "K5 alone": lambda: smoke.kernels_only("group_norm_act"),
                "plain, TF32 allowed": tf32_allowed,
                "plain, cuDNN's heuristic algorithms": cudnn_heuristics}
    out = {"iteration: plain": reading(ref, False)}
    out["iteration: plain"]["tensors_held"] = len(held)

    def show(key):
        brief = {k: ({kk: vv for kk, vv in v.items() if kk != "per_tensor"}
                     if isinstance(v, dict) and "per_tensor" in v else v)
                 for k, v in out[key].items()}
        print(json.dumps({"card": card, "seed": seed, "variant": key, **brief}), flush=True)

    show("iteration: plain")
    for label, context in variants.items():
        with context():
            _, grads, launches = smoke.iteration_grads(
                state, batch, draws, plain=label.startswith("plain"))
        key = f"iteration: {label}"
        out[key] = {**reading(grads, True), "launches": launches}
        out[key]["max_grad_rel_err"] = out[key]["vs_plain"]["max_grad_rel_err"]
        show(key)
    return out


@contextlib.contextmanager
def cudnn_heuristics():
    """cuDNN's heuristic choice of algorithm, not the timed one: another
    summation order at the same precision."""
    import torch

    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


@contextlib.contextmanager
def tf32_allowed():
    import torch

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def cudnn_free():
    """cuDNN as the smoke leaves it outside the training steps:
    ``benchmark`` on (its timed choice of algorithm, which may differ from
    one process to the next), any algorithm."""
    import torch

    saved = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved


CUDNN_MODES = {"free": cudnn_free, "fixed": smoke.fixed_cudnn}


def mask_readings(cfg, seed: int, card: str, mode: str) -> dict:
    """The mask loss of phase 14's D (R1) + G iteration on this seed
    (``chip_smoke.branch_training_inputs``, then one training step; seed
    0 is the smoke's), everything under the cuDNN ``mode``: the G step's
    forward (``chip_smoke.mask_factors``) through every kernel, each
    kernel alone and under the K1 faults, each against the same forward
    with every plain version forced and against the fp32 one
    (``chip_smoke.mask_distance``), and the plain forward against the
    fp32 one, with its wall seconds.  Under ``fixed`` also the smoke's
    check itself (``chip_smoke.iteration_verdict``) on the sound kernels
    and with K1's tap (0, 0) dropped at the Cout = 1 convs."""
    import torch

    from mudiff_torch.train import TrainDraws, make_train_step

    t_run = time.perf_counter()
    variants = {"kernels": contextlib.nullcontext,
                "K1 alone": lambda: smoke.kernels_only("conv3x3"),
                "K2 alone": lambda: smoke.kernels_only("fir_down2", "fir_up2"),
                "K3 alone": lambda: smoke.kernels_only("flash_attn", "flash_attn_bwd_dkv",
                                                       "flash_attn_bwd_dq"),
                "K5 alone": lambda: smoke.kernels_only("group_norm_act"),
                **{label: (lambda fault=fault: k1_head_fault(fault))
                   for label, fault in k1_faults().items()}}
    out = {}

    def show(label):
        print(json.dumps({"card": card, "seed": seed, "cudnn": mode, "variant": label,
                          **out[label]}), flush=True)

    with CUDNN_MODES[mode]():
        state, batch, tgen = smoke.branch_training_inputs(cfg, seed)
        make_train_step(cfg)(state, batch, generator=tgen, with_r1=True)
        draws = tuple(TrainDraws.draw(cfg, batch[3], tgen) for _ in range(2))
        state32 = smoke.fp32_copy(cfg, state)
        exact = smoke.mask_factors(state32, batch, draws, plain=True)
        ref = smoke.mask_factors(state, batch, draws, plain=True)
        out["plain"] = {"vs_fp32_plain": smoke.mask_distance(ref, exact),
                        "G_mask": float(ref["term_1"] + ref["term_2"])}
        show("plain")
        for label, context in variants.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            with context():
                got = smoke.mask_factors(state, batch, draws, plain=False)
            torch.cuda.synchronize()
            out[label] = {"vs_plain": smoke.mask_distance(got, ref),
                          "vs_fp32_plain": smoke.mask_distance(got, exact),
                          "forward_s": time.perf_counter() - t}
            show(label)
        if mode == "fixed":
            grads32 = smoke.iteration_grads(state32, batch, draws, plain=True)[1]
            checks = {"sound": contextlib.nullcontext,
                      "K1 head tap (0, 0) dropped": lambda: k1_head_fault(head_tap_dropped)}
            for label, context in checks.items():
                with context():
                    verdict = smoke.iteration_verdict("bf16", state, batch, draws, grads32,
                                                      exact)
                out[f"check: {label}"] = {k: verdict[k] for k in (
                    "failed", "max_loss_rel_err", "worst_loss", "G_mask_rel_err",
                    "nearest_its_limit", "mask_vs_plain", "mask_ratio")}
                out[f"check: {label}"]["G_mask_equals_forward"] = (
                    verdict["losses_plain"]["G_mask"] == out["plain"]["G_mask"])
                show(f"check: {label}")
    out["run_s"] = time.perf_counter() - t_run
    return out


def mask_summary(runs: list) -> dict:
    """Per variant, each reading over the runs (in order): G_mask's and
    the logits' distance from the plain and the fp32 plain forward, the
    BCE factors' and the features'; and the checks' failures."""
    keys = ("G_mask_rel_err", "logit_mean_abs_spacings", "logit_mean_signed_spacings",
            "logit_max_abs_spacings", "bce_rel_err", "feat_rel_err", "pos_max_abs")
    summary = {}
    for run in runs:
        for label, reading in run["readings"].items():
            if not isinstance(reading, dict):
                continue
            for against in ("vs_plain", "vs_fp32_plain", "mask_vs_plain"):
                if against in reading:
                    row = summary.setdefault(f"{label} | {against}", {})
                    for k in keys:
                        row.setdefault(k, []).append(reading[against][k])
            if "failed" in reading:
                summary.setdefault(f"{label} | failed", []).append(
                    reading["failed"])
    return summary


def branch_readings(cfg, seed: int, card: str) -> dict:
    """A branch configuration's sample, int8 samples and iteration."""
    import torch

    from mudiff_torch import build_sampler

    sampler = build_sampler(cfg, device=smoke.DEVICE,
                            generator=torch.Generator().manual_seed(seed))
    wgen = torch.Generator(smoke.DEVICE).manual_seed(seed)
    smoke.randomize_(sampler.g1, wgen)
    smoke.randomize_(sampler.g2, wgen)
    out = sample_readings(cfg, sampler, seed, card, branch_variants())
    faults = {label: (lambda fault=fault: k1_head_fault(fault))
              for label, fault in k1_faults().items()}
    out.update(int8_sample_readings(cfg, sampler, seed, card, {**branch_variants(), **faults}))
    del sampler
    out.update(iteration_readings(cfg, seed, card))
    return out


def seed_readings(cfg, seed: int, card: str, flags=(), int8: bool = False) -> dict:
    import numpy as np
    import torch

    from mudiff_torch import build_sampler
    from mudiff_torch.ops import KERNEL_WRAPPERS, flash_attn_plain

    sampler = build_sampler(cfg, device=smoke.DEVICE,
                            generator=torch.Generator().manual_seed(seed))
    wgen = torch.Generator(smoke.DEVICE).manual_seed(seed)
    smoke.randomize_(sampler.g1, wgen)
    smoke.randomize_(sampler.g2, wgen)
    if int8:
        return int8_sample_readings(cfg, sampler, seed, card)
    extra = ("--seed", str(cfg.seed + seed), *flags)
    mid = smoke.VOLUME_SHAPE[2] // 2
    band = slice(mid - smoke.VOLUME_HALF, mid + smoke.VOLUME_HALF + 1)
    variants = {"kernels": contextlib.nullcontext,
                "K1 alone": lambda: smoke.kernels_only("conv3x3"),
                "K5 plain": lambda: smoke.kernels_only(*(k for k in KERNEL_WRAPPERS
                                                         if k != "group_norm_act")),
                "K3 plain": lambda: attention_as(flash_attn_plain),
                **{f"K3 scale x (1 + {eps})": (lambda eps=eps: attention_as(scaled_kernel(eps)))
                   for eps in FAULTS},
                **{label: (lambda fault=fault: k1_head_fault(fault))
                   for label, fault in k1_faults().items()}}
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        smoke.write_volume_inputs(workdir, sampler, seed + 40)
        ref, _, _ = smoke.run_volume(cfg, workdir, "plain", extra, plain=True)
        for label, context in variants.items():
            with context():
                vol, seconds, launches = smoke.run_volume(cfg, workdir, label, extra)
            out[label] = {
                "max_abs": smoke.volume_distance(vol, ref),
                "mean_abs_slices": 2.0 * float(np.abs(vol - ref)[:, :, band].mean()),
                "launches": launches, "run_s": seconds,
            }
            print(json.dumps({"card": card, "seed": seed, "variant": label, **out[label]}),
                  flush=True)
    if not flags:  # the main path's sample is bf16 only
        out.update(sample_readings(cfg, sampler, seed, card))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    modes = parser.add_mutually_exclusive_group()
    modes.add_argument("--fp32", action="store_true",
                       help="serve in fp32 (--no_bf16) instead of bf16")
    modes.add_argument("--int8", action="store_true",
                       help="read the int8 leg's samples (W8A8, dynamic and static scales)")
    modes.add_argument("--branch", choices=sorted(BRANCH_NAMES),
                       help="read a branch configuration's samples and iteration")
    parser.add_argument("--iteration", action="store_true",
                        help="read only the mask loss of the recipe's or --branch's iteration")
    parser.add_argument("--cudnn", choices=sorted(CUDNN_MODES), default="fixed",
                        help="with --iteration: cuDNN's choice of algorithm, the smoke's "
                             "(fixed) or timed (free); one a process, since the first "
                             "choice made for a shape sticks")
    parser.add_argument("--out", help="also write every reading here")
    args = parser.parse_args(argv)
    if args.iteration and (args.fp32 or args.int8):
        parser.error("--iteration reads the recipe's or --branch's bf16 iteration")

    import torch

    if not torch.cuda.is_available():
        print("volume_drift: no CUDA device", file=sys.stderr)
        return 2
    from mudiff_torch import brats_recipe
    from mudiff_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    card = smoke.card_line()
    print(card, flush=True)
    _build.build()
    cfg = brats_recipe(num_channels_dae=smoke.NF, image_size=smoke.IMAGE)
    if args.branch:
        cfg = cfg.replace(**smoke.BRANCHES[BRANCH_NAMES[args.branch]])
    if args.iteration:
        runs = [{"cudnn": args.cudnn, "seed": seed,
                 "readings": mask_readings(cfg, seed, card, args.cudnn)}
                for seed in args.seeds]
        head = {"card": card, "dtype": "bf16", "branch": args.branch or "recipe",
                "mask_tolerance": smoke.MASK_TOL}
        if args.out:
            with open(args.out, "w") as f:
                json.dump({**head, "runs": runs}, f, indent=1)
        print(json.dumps({**head, "seeds": args.seeds, "by_variant": mask_summary(runs)}),
              flush=True)
        return 0
    if args.int8 or args.branch:
        if args.branch:
            readings = {seed: branch_readings(cfg, seed, card) for seed in args.seeds}
        else:
            readings = {seed: seed_readings(cfg, seed, card, int8=True) for seed in args.seeds}
        first = readings[args.seeds[0]]
        summary = {label: [readings[s][label].get("max_abs",
                                                  readings[s][label].get("max_grad_rel_err"))
                           for s in args.seeds]
                   for label in first if label != "iteration: plain"}
        summary.update({f"{label} vs fp32 plain": [
            readings[s][label]["vs_fp32_plain"]["max_grad_rel_err"] for s in args.seeds]
            for label in first if "vs_fp32_plain" in first[label]})
        head = {"card": card, "dtype": "bf16 and int8" if args.branch else "int8",
                "branch": args.branch}
        if args.out:
            with open(args.out, "w") as f:
                json.dump({**head, "readings": readings}, f, indent=1)
        print(json.dumps({**head, "seeds": args.seeds, "max_abs_by_variant": summary}),
              flush=True)
        return 0
    dtype = "fp32" if args.fp32 else "bf16"
    faults = {eps: per_shape_check(eps, dtype) for eps in (0.0, *FAULTS)}
    k1_checks = {label: k1_per_shape_check(fault, dtype)
                 for label, fault in {"none": lambda w: w, **k1_faults()}.items()}
    print(json.dumps({"card": card, "dtype": dtype,
                      "per_shape_check_at": [smoke.VOLUME_BATCH, 4096, 256],
                      "tolerance": smoke.FLASH_TOL[dtype], "by_eps": faults}), flush=True)
    print(json.dumps({"card": card, "dtype": dtype,
                      "k1_per_shape_check_at": [smoke.BATCH, smoke.IMAGE, smoke.IMAGE,
                                                smoke.NF, 1],
                      "tolerance": smoke.TOL[dtype], "by_fault": k1_checks}), flush=True)
    flags = ("--no_bf16",) if args.fp32 else ()
    readings = {seed: seed_readings(cfg, seed, card, flags) for seed in args.seeds}
    summary = {label: [readings[s][label]["max_abs"] for s in args.seeds]
               for label in readings[args.seeds[0]]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "dtype": dtype, "per_shape": faults,
                       "k1_per_shape": k1_checks, "readings": readings}, f, indent=1)
    print(json.dumps({"card": card, "dtype": dtype, "seeds": args.seeds,
                      "max_abs_by_variant": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
