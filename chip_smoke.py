#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json]

Run from the root of the repo.  Phases, each of which either succeeds or
ends the run with a non-zero exit code:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``mudiff_torch/csrc`` (one nvcc per
   source, all started together) and print the build time;
3. serve three requests through ``build_sampler``: G1 + G2 at
   ``brats_recipe(num_channels_dae=64, image_size=256)`` with seeded
   non-trivial weights, each request a batch of 4 slices through the
   4-step bf16 sampler with bf16-score attention.  The kernels' launch
   counts are zeroed just before and read just after; every kernel must
   have launched, exactly as often as the module structure says, and a
   kernel call that would record a graph must raise (no backward yet);
4. at every distinct shape that run gave each kernel, hold the kernel
   against its plain PyTorch version (bf16 and fp32), and time the
   kernel, the plain version and one library call computing the same
   function (cuDNN conv, depthwise conv, conv-transpose) with CUDA
   events; the bound is the larger of bytes / HBM rate and operations /
   peak rate of the card;
5. the whole sample with the plain versions forced, same weights and
   injected noise: bf16 and fp32 differences against stated tolerances;
6. best-of-N slices/s of one request, and one request under
   torch.profiler (device time by kernel, the device's idle share);
7. the ``kernels`` JSON line, then ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, when CUDA is unavailable or the
``mudiff_torch`` package is not beside the script.  ``--out`` also
writes every per-shape row and the nvcc log to a JSON file.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

SEED = 0
DEVICE = "cuda"
BATCH = 4
REQUESTS = 3
NF = 64
IMAGE = 256

# Tolerances, kernel vs plain version on the same inputs.  Both
# accumulate in fp32; in bf16 they round the same fp32 sum once, so a
# sum near a rounding boundary may land one bf16 ulp (2^-8 relative)
# apart.  In fp32 only the summation order differs.
TOL = {"bf16": (1e-2, 1e-2), "fp32": (1e-4, 1e-4)}
FIR_TOL_FP32 = (1e-5, 1e-5)
# A library call is held to the plain version only to show that it
# computes the same function (a wrong formula is off by O(1)).
LIB_TOL = (5e-2, 5e-2)
# Whole 4-step sample (x in about [-1, 1]), kernels vs plain versions:
# in bf16 one-ulp flips (0.0078 at 1.0) propagate through 8 generator
# forwards; in fp32 only summation order differs.
SAMPLE_TOL = {"bf16": 5e-2, "fp32": 1e-3}

# Published dense peaks of the card (NVIDIA data sheets): bf16 tensor-core
# FLOP/s, fp32 CUDA-core FLOP/s, device-memory bytes/s.
PEAKS = {
    "H100 SXM": (989e12, 67e12, 3.35e12),
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def peaks_for(name: str):
    variant = ("H100 PCIe" if "PCIe" in name else
               "H100 NVL" if "NVL" in name else "H100 SXM")
    return variant, PEAKS[variant]


def time_ms(fn, target_ms: float = 60.0) -> float:
    """Mean device time of one call, CUDA events around a run of calls."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(3, min(50, math.ceil(target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def randomize_(module, generator) -> None:
    """Seeded non-trivial weights: a fresh init puts every resblock's
    Conv_1, NIN_3 and final_conv at ~1e-10 scale, which would make the
    kernel-vs-plain comparison of the whole sample vacuous.  Kernels get
    normals / sqrt(fan_in); vectors their init value (1 for GroupNorm
    scales and the AdaGN gamma half, 0 else) plus 0.1 * normal."""
    import torch

    with torch.no_grad():
        for p in module.parameters():
            noise = torch.randn(p.shape, generator=generator, device=p.device)
            if p.dim() == 4:    # HWIO conv kernel
                p.copy_(noise / math.sqrt(p.shape[0] * p.shape[1] * p.shape[2]))
            elif p.dim() == 2:  # (out, in) dense / 1x1 weight
                p.copy_(noise / math.sqrt(p.shape[1]))
            else:
                p.add_(0.1 * noise)


def conditions(generator, device):
    import torch

    shape = (BATCH, IMAGE, IMAGE, 1)
    return [torch.randn(shape, generator=generator, device=device).tanh()
            for _ in range(3)]


def check_close(what: str, got, want, atol: float, rtol: float) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if not bool(torch.isfinite(got).all()) or bool((err > limit).any()):
        raise AssertionError(f"{what}: max abs err {float(err.max()):.3g} "
                             f"beyond atol {atol} + rtol {rtol} * |plain|")
    return float(err.max())


def conv_rows(shapes, peaks, card):
    """K1 at each main-path shape: checks, times, bound.  ``shapes`` maps
    (x shape, Cout, dtype) to the launches the main path's run made."""
    import torch
    import torch.nn.functional as F

    from mudiff_torch.ops import conv3x3, conv3x3_plain

    bf16_peak, fp32_peak, hbm = peaks
    g = torch.Generator(DEVICE).manual_seed(SEED + 1)
    rows = []
    for (xshape, cout, dtype), launches in sorted(shapes.items(), key=str):
        b, h, w, cin = xshape
        x = torch.randn(xshape, generator=g, device=DEVICE)
        wt = torch.randn((3, 3, cin, cout), generator=g, device=DEVICE) / math.sqrt(9 * cin)
        bias = 0.1 * torch.randn((cout,), generator=g, device=DEVICE)
        errs = {}
        for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            xd, wd = x.to(dt), wt.to(dt)
            errs[tag] = check_close(f"conv3x3 {xshape}->{cout} {tag}", conv3x3(xd, wd, bias),
                                    conv3x3_plain(xd, wd, bias), *TOL[tag])
        # timed in the dtype the main path gave this shape
        xd, wd = x.to(dtype), wt.to(dtype)
        x_nchw = xd.permute(0, 3, 1, 2)  # a channels_last view, no copy
        w_oihw = wd.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bias_d = bias.to(dtype)
        lib = F.conv2d(x_nchw, w_oihw, bias_d, padding=1)
        check_close(f"cuDNN conv {xshape}->{cout}", lib.permute(0, 2, 3, 1),
                    conv3x3_plain(xd, wd, bias), *LIB_TOL)
        size = xd.element_size()
        flops = 2.0 * b * h * w * 9 * cin * cout
        nbytes = size * (b * h * w * (cin + cout) + 9 * cin * cout) + 4.0 * cout
        rows.append({
            "kernel": "conv3x3", "x": list(xshape), "cout": cout, "dtype": str(dtype)[6:],
            "launches": launches, "err_bf16": errs["bf16"], "err_fp32": errs["fp32"],
            "ms": time_ms(lambda: conv3x3(xd, wd, bias)),
            "plain_ms": time_ms(lambda: conv3x3_plain(xd, wd, bias)),
            "library_ms": time_ms(lambda: F.conv2d(x_nchw, w_oihw, bias_d, padding=1)),
            "flop_ms": flops / (bf16_peak if size == 2 else fp32_peak) * 1e3,
            "byte_ms": nbytes / hbm * 1e3,
        })
        print(json.dumps({"card": card, **rows[-1]}), flush=True)
    return rows


def fir_rows(shapes, peaks, card):
    """K2a/K2b at each main-path shape: checks, times, bound."""
    import torch
    import torch.nn.functional as F

    from mudiff_torch.ops import downsample_2d, fir_down2, fir_up2, setup_fir_kernel, upsample_2d

    _, fp32_peak, hbm = peaks
    k = (1, 3, 3, 1)
    g = torch.Generator(DEVICE).manual_seed(SEED + 2)
    rows = []
    for (name, xshape, dtype), launches in sorted(shapes.items(), key=str):
        b, h, w, c = xshape
        x = torch.randn(xshape, generator=g, device=DEVICE)
        down = name == "fir_down2"
        kern, plain = (fir_down2, downsample_2d) if down else (fir_up2, upsample_2d)
        errs = {}
        for tag, dt, tol in (("bf16", torch.bfloat16, TOL["bf16"]),
                             ("fp32", torch.float32, FIR_TOL_FP32)):
            xd = x.to(dt)
            errs[tag] = check_close(f"{name} {xshape} {tag}", kern(xd, k), plain(xd, k, 2), *tol)
        # timed in the dtype the main path gave this shape
        xd = x.to(dtype)
        x_nchw = xd.permute(0, 3, 1, 2)
        taps = torch.tensor(setup_fir_kernel(k), device=DEVICE)
        if down:  # [1,3,3,1] is symmetric, so correlation == convolution
            wdw = taps.expand(c, 1, 4, 4).to(dtype).contiguous()
            library = lambda: F.conv2d(x_nchw, wdw, stride=2, padding=1, groups=c)
        else:
            wdw = (4.0 * taps).expand(c, 1, 4, 4).to(dtype).contiguous()
            library = lambda: F.conv_transpose2d(x_nchw, wdw, stride=2, padding=1, groups=c)
        check_close(f"library {name} {xshape}", library().permute(0, 2, 3, 1),
                    plain(xd, k, 2), *LIB_TOL)
        out_elems = b * c * (h * w // 4 if down else 4 * h * w)
        taps_per_out = 16 if down else 4
        nbytes = xd.element_size() * (b * h * w * c + out_elems)
        rows.append({
            "kernel": name, "x": list(xshape), "dtype": str(dtype)[6:],
            "launches": launches, "err_bf16": errs["bf16"], "err_fp32": errs["fp32"],
            "ms": time_ms(lambda: kern(xd, k)),
            "plain_ms": time_ms(lambda: plain(xd, k, 2)),
            "library_ms": time_ms(library),
            "flop_ms": 2.0 * out_elems * taps_per_out / fp32_peak * 1e3,
            "byte_ms": nbytes / hbm * 1e3,
        })
        print(json.dumps({"card": card, **rows[-1]}), flush=True)
    return rows


SOURCES = {
    "conv3x3": ("mudiff_torch/csrc/conv3x3_kernel.cu", "mudiff_tpu/ops/pallas_conv.py:375"),
    "fir_down2": ("mudiff_torch/csrc/fir_kernels.cu", "mudiff_tpu/ops/pallas_fir.py:271"),
    "fir_up2": ("mudiff_torch/csrc/fir_kernels.cu", "mudiff_tpu/ops/pallas_fir.py:292"),
}


def kernel_summary(name, rows, launches):
    """One kernel's entry of the ``kernels`` line.  Every time is summed
    over the launches the main path's run made (per-launch time at each
    shape x that shape's launches), so it covers the same work as
    ``launches``."""
    mine = [r for r in rows if r["kernel"] == name]
    if sum(r["launches"] for r in mine) != launches:
        raise AssertionError(f"{name}: per-shape launches do not add up to {launches}")

    def total(key):
        return sum(r["launches"] * r[key] for r in mine)

    compute = total("flop_ms")
    memory = total("byte_ms")
    bound = sum(r["launches"] * max(r["flop_ms"], r["byte_ms"]) for r in mine)
    return {
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": launches,
        "max_abs_err": max(r["err_bf16"] for r in mine),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": bound,
        "bound_by": "operations" if compute >= memory else "bytes",
        "library_ms": total("library_ms"),
        "per": f"the main path's run: {REQUESTS} requests, each a 4-step sample "
               f"of batch {BATCH}", "shapes": len(mine),
    }


def refuses_grad(device) -> None:
    """A kernel has no backward yet: a CUDA call that would record a
    graph must raise instead of returning a result with no gradient."""
    import torch

    from mudiff_torch.ops import conv3x3

    x = torch.randn((1, 4, 4, 8), device=device)
    w = torch.randn((3, 3, 8, 8), device=device, requires_grad=True)
    with torch.enable_grad():
        try:
            conv3x3(x, w)
        except RuntimeError:
            return
    raise AssertionError("conv3x3 launched on a tensor that requires grad")


# Device kernels of a request, grouped by the first group one of whose
# marks occurs in the kernel's lower-cased name.
PROFILE_GROUPS = (
    ("K1 conv3x3", ("conv3x3_kernel",)),
    ("K2a fir_down2", ("fir_down2_kernel",)),
    ("K2b fir_up2", ("fir_up2_kernel",)),
    ("copies and casts", ("copy", "memcpy", "memset")),
    ("reductions (GroupNorm statistics, means)", ("reduce_kernel",)),
    ("softmax", ("softmax",)),
    ("cuDNN / native conv (pyramid)", ("fprop", "conv", "cudnn")),
    ("matmul (attention, dense, 1x1)", ("gemm", "cutlass", "nvjet")),
    ("elementwise", ("elementwise",)),
)


def profile_request(sampler, conds, generator) -> dict:
    """One request under torch.profiler: device time by kernel and the
    device's idle share of the request's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        sampler(*conds, generator=generator)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            us = evt.time_range.end - evt.time_range.start
            by_name[evt.name] = by_name.get(evt.name, 0.0) + us / 1e3
    by_group = {}
    for kname, ms in by_name.items():
        group = next((g for g, marks in PROFILE_GROUPS
                      if any(m in kname.lower() for m in marks)), "other")
        by_group[group] = by_group.get(group, 0.0) + ms
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
            "device_ms_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
            "distinct_device_kernels": len(by_name),
            "top_device_ms": [[kname[:80], ms] for kname, ms in top]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write per-shape rows and the nvcc log here")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's serving path runs on the card",
              file=sys.stderr)
        return 2
    from mudiff_torch import brats_recipe, build_sampler, ops
    from mudiff_torch.ops import _build

    # The plain versions are the references: full fp32, no TF32.  cuDNN
    # picks its fastest algorithm per shape, so no library time or plain
    # time rests on a poor heuristic choice.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True

    card = card_line()
    name = torch.cuda.get_device_name(0)
    variant, peaks = peaks_for(name)
    print(card, flush=True)

    t0 = time.perf_counter()
    built = _build.build()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "per_library_s": {k: v["seconds"] for k, v in built.items()}}), flush=True)

    cfg = brats_recipe(num_channels_dae=NF, image_size=IMAGE)
    sampler = build_sampler(cfg, device=DEVICE, generator=torch.Generator().manual_seed(SEED))
    wgen = torch.Generator(DEVICE).manual_seed(SEED)
    randomize_(sampler.g1, wgen)
    randomize_(sampler.g2, wgen)

    # -- the main path: three requests, counted ------------------------------
    cgen = torch.Generator(DEVICE).manual_seed(SEED + 10)
    requests = [conditions(cgen, DEVICE) for _ in range(REQUESTS)]
    ngen = torch.Generator(DEVICE).manual_seed(SEED + 20)
    log, outs, seconds = [], [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with ops.record_calls(log):
        for conds in requests:
            t = time.perf_counter()
            outs.append(sampler(*conds, generator=ngen))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
    launches = ops.launch_counts()
    per_sample = sampler.kernel_launches_per_sample()
    expected = {k: REQUESTS * v for k, v in per_sample.items()}
    print(json.dumps({"launch_counts": launches, "expected": expected,
                      "request_s": seconds}), flush=True)
    if launches != expected or min(launches.values()) <= 0:
        raise AssertionError(f"launches {launches} != structure's {expected}")
    for out in outs:
        if out.shape != (BATCH, IMAGE, IMAGE, 1) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"bad sample: {tuple(out.shape)}")
        if float(out.std()) < 1e-2:
            raise AssertionError("sample is near constant")

    refuses_grad(DEVICE)

    conv_shapes, fir_shapes = {}, {}
    for kname, key in log:
        if kname == "conv3x3":
            conv_shapes[key] = conv_shapes.get(key, 0) + 1
        else:
            fir_shapes[(kname, *key)] = fir_shapes.get((kname, *key), 0) + 1

    # -- each kernel against its plain version, timed ------------------------
    rows = conv_rows(conv_shapes, peaks, card) + fir_rows(fir_shapes, peaks, card)

    # -- the whole sample, kernels vs plain versions -------------------------
    zgen = torch.Generator(DEVICE).manual_seed(SEED + 30)
    x_init = torch.randn((BATCH, IMAGE, IMAGE, 1), generator=zgen, device=DEVICE)
    noise = [(torch.randn((BATCH, cfg.nz), generator=zgen, device=DEVICE),
              torch.randn((BATCH, IMAGE, IMAGE, 1), generator=zgen, device=DEVICE))
             for _ in range(cfg.num_timesteps)]
    sampler32 = build_sampler(cfg, device=DEVICE, attn="einsum", compute_dtype=torch.float32)
    sampler32.g1.load_state_dict(sampler.g1.state_dict())
    sampler32.g2.load_state_dict(sampler.g2.state_dict())
    diffs, runs = {}, {}
    for tag, s in (("bf16", sampler), ("fp32", sampler32)):
        # each side's launch counts show which path it took
        ops.reset_launch_counts()
        got = s(*requests[0], x_init=x_init, noise=noise)
        with_kernels = ops.launch_counts()
        ops.reset_launch_counts()
        with ops.plain_kernels():
            want = s(*requests[0], x_init=x_init, noise=noise)
        plain = ops.launch_counts()
        if with_kernels != per_sample or any(plain.values()):
            raise AssertionError(f"{tag} sample: launches {with_kernels} with kernels, "
                                 f"{plain} with plain versions forced")
        diffs[tag] = float((got - want).abs().max())
        runs[tag] = {"launches_kernels": with_kernels, "launches_plain": plain,
                     "max_abs_sample": float(want.abs().max())}
        if not diffs[tag] <= SAMPLE_TOL[tag]:
            raise AssertionError(f"{tag} sample, kernels vs plain: max abs diff "
                                 f"{diffs[tag]:.3g} > {SAMPLE_TOL[tag]}")
    print(json.dumps({"sample_kernel_vs_plain_max_abs": diffs, "tolerance": SAMPLE_TOL,
                      "runs": runs}), flush=True)

    # -- throughput ------------------------------------------------------------
    best = math.inf
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sampler(*requests[0], generator=ngen)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t)
    plain_best = math.inf
    with ops.plain_kernels():
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            sampler(*requests[0], generator=ngen)
            torch.cuda.synchronize()
            plain_best = min(plain_best, time.perf_counter() - t)
    print(json.dumps({"card": card, "peaks_of": variant, "nf": NF, "image": IMAGE,
                      "batch": BATCH, "steps": cfg.num_timesteps, "dtype": "bf16",
                      "attn": "bf16", "best_request_s": best, "slices_per_s": BATCH / best,
                      "plain_slices_per_s": BATCH / plain_best}), flush=True)
    print(json.dumps({"card": card, "profile_one_request":
                      profile_request(sampler, requests[0], ngen)}), flush=True)

    kernels = [kernel_summary(k, rows, launches[k]) for k in ("conv3x3", "fir_down2", "fir_up2")]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows, "kernels": kernels,
                       "nvcc": {k: v["log"] for k, v in built.items()}}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
