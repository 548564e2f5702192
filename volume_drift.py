#!/usr/bin/env python3
"""How far the bf16 volume and the main path's sample through the port's
kernels lie from the same through their plain versions, over seeds and
beside K1 and K3 faults of known size.  Needs one NVIDIA GPU.

    python3 volume_drift.py [--seeds 0 1 2] [--fp32 | --int8] [--out FILE.json]

For each seed, ``chip_smoke.py``'s volume phase is run in bf16 (in fp32,
``--no_bf16``, with ``--fp32``) with ``--attn flash``: the weights, the three synthetic contrasts and the
CLI's ``--seed`` are all made from the seed (seed 0 is the smoke's own
volume).  Each seed's volume is predicted

- with every plain version forced (the reference of the comparison);
- with every kernel (what the smoke holds to ``BF16_VOLUME_TOL``, or
  in fp32 to ``SAMPLE_TOL["fp32"]``);
- with K1 alone through its kernel (K2 and K3 plain), so the difference
  from the reference is K1's;
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
the same way: every kernel, K1 alone, and the K1 faults, each against
the plain versions (what the smoke holds to ``SAMPLE_TOL``).  For each
fault the script also prints whether the smoke's per-shape check
rejects it: K3's (``FLASH_TOL``) at (8, 4096, 256), K1's (``TOL``) at the
head's shape.  The last line is a summary.

With ``--int8`` only the int8 leg's samples are read, for each seed and
each mode (dynamic scales; static ones that ``calibrate_sampler``
records, as ``chip_smoke.int8_samplers`` makes them): the W8A8 sample
through every kernel, through K4 alone (the others plain, so the
difference is K4's) and through K1 alone, each against the same sample
with every plain version forced (what the smoke holds to
``INT8_SAMPLE_TOL``), and the int8 sample against the bf16 one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import tempfile

import chip_smoke as smoke

FAULTS = (0.005, 0.02, 0.08)
K1_FAULTS = (0.02, 0.08)
KERNEL_MODULES = ("conv3x3", "fir", "flash_attn", "int8_conv")


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


@contextlib.contextmanager
def kernels_only(*names):
    """Every wrapper whose kernel is not in ``names`` runs its plain
    version, on CUDA tensors too."""
    saved = {m: m.use_kernel for m in (sys.modules[f"mudiff_torch.ops.{k}"]
                                        for k in KERNEL_MODULES)}
    for m, real in saved.items():
        m.use_kernel = (lambda name, key, *tensors, real=real:
                        real(name, key, *tensors) and name in names)
    try:
        yield
    finally:
        for m, real in saved.items():
            m.use_kernel = real


def head_weight_scaled(eps: float):
    return lambda w: (w.float() * (1.0 + eps)).to(w.dtype)


def head_tap_dropped(w):
    w = w.clone()
    w[0, 0] = 0
    return w


@contextlib.contextmanager
def k1_head_fault(fault):
    """K1 run with weight ``fault(w)`` in every conv with Cout = 1: each
    generator's ``final_conv``, the one such conv of the sampler."""
    mod = sys.modules["mudiff_torch.ops.conv3x3"]
    real = mod._conv

    def faulty(x, w, bias):
        return real(x, fault(w) if w.shape[-1] == 1 else w, bias)

    mod._conv = faulty
    try:
        yield
    finally:
        mod._conv = real


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


def sample_readings(cfg, sampler, seed: int, card: str) -> dict:
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
                "sample: K1 alone": lambda: kernels_only("conv3x3"),
                **{f"sample: {label}": (lambda fault=fault: k1_head_fault(fault))
                   for label, fault in k1_faults().items()}}
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


def int8_sample_readings(cfg, sampler, seed: int, card: str) -> dict:
    """The int8 leg's samples on this seed's weights, conditions and
    noise, in both modes, under each variant against the same sample with
    every plain version forced: max abs difference; and the int8 sample
    against the bf16 one."""
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
                "K4 alone": lambda: kernels_only("int8_conv3x3"),
                "K1 alone": lambda: kernels_only("conv3x3")}
    out = {}
    for mode, s in (("dynamic", dynamic), ("static", static)):
        with ops.plain_kernels():
            ref = s(*conds, x_init=x_init, noise=noise)
        for label, context in variants.items():
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


def seed_readings(cfg, seed: int, card: str, flags=(), int8: bool = False) -> dict:
    import numpy as np
    import torch

    from mudiff_torch import build_sampler
    from mudiff_torch.ops import flash_attn_plain

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
                "K1 alone": lambda: kernels_only("conv3x3"),
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
    parser.add_argument("--out", help="also write every reading here")
    args = parser.parse_args(argv)

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
    if args.int8:
        readings = {seed: seed_readings(cfg, seed, card, int8=True) for seed in args.seeds}
        summary = {label: [readings[s][label]["max_abs"] for s in args.seeds]
                   for label in readings[args.seeds[0]]}
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": card, "dtype": "int8", "readings": readings}, f, indent=1)
        print(json.dumps({"card": card, "dtype": "int8", "seeds": args.seeds,
                          "max_abs_by_variant": summary}), flush=True)
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
