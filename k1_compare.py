#!/usr/bin/env python3
"""K1 (the 3x3 conv) by path on one NVIDIA GPU: its wgmma path beside the
mma.sync kernel it replaced at the wide shapes, cuDNN and the plain
version; and the main path's throughput with a given checkout of the port.

    python3 k1_compare.py shapes [--out FILE.json]
    python3 k1_compare.py main-path [--tree DIR] [--out FILE.json]

``shapes`` builds K1 and prints the wgmma kernel's ``ptxas -v`` lines,
then records (under ``plain_kernels``, on the card, at 32^2 and 64^2 and
scaled to 256^2) every K1 call of: the nf=64 sampler at batch 4 (the main
path), an nf=64 D + G training iteration at batch 2, and at nf=128 the
iteration at batch 2 and the sampler at batch 8 (the test at nf=128).  At
each distinct shape it holds the kernel that ``k1_path`` picks against
``conv3x3_plain`` in bf16 and fp16 (``chip_smoke.TOL``) and times it
(CUDA events behind a device spin, ``chip_smoke.time_ms``) beside the
general path (the ``mma.sync`` kernel, called through its entry point,
also at the wide shapes), cuDNN's conv on channels_last views and the
plain version (the smoke's settings: no TF32, cuDNN's timed algorithms),
with the bound (max of operations over the bf16 peak and
bytes over the memory rate); then each run's totals, launches times ms;
and the host time of one wrapper call and of each path's entry point
alone (``chip_smoke.host_ms``).

``main-path`` runs ``chip_smoke.py``'s main path with the ``mudiff_torch``
and ``chip_smoke`` of DIR (default: this checkout), so that two checkouts
compare on one card: the nf=64 256^2 sampler with the smoke's seeded
weights, batch-4 requests, best of 3 (slices/s), one profiled request
(device busy ms, idle share, K1's device ms) and the host time of one K1
call at two main-path shapes.  Exits non-zero when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def load_tree(tree: str):
    """``chip_smoke`` of ``tree``, with that tree's ``mudiff_torch`` first
    on the path."""
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke

    if not os.path.abspath(chip_smoke.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"chip_smoke came from {chip_smoke.__file__}, not {tree}")
    return chip_smoke


def record_runs(cs):
    """{run: {(x shape, Cout, dtype): launches}} of K1 at 256^2, recorded
    at 32^2 (sampler) and 64^2 (training) with the plain versions forced,
    then scaled."""
    import numpy as np
    import torch

    from mudiff_torch import brats_recipe, build_sampler, ops
    from mudiff_torch.train.state import create_train_state
    from mudiff_torch.train.steps import make_train_step

    def calls(log, factor, batch):
        out = {}
        for name, key in log:
            if name == "conv3x3":
                (_, h, w, cin), cout, dtype = key
                k = ((batch, factor * h, factor * w, cin), cout, dtype)
                out[k] = out.get(k, 0) + 1
        return out

    runs = {}
    for nf, batch in ((64, 4), (128, 8)):
        cfg = brats_recipe(num_channels_dae=nf, image_size=32)
        sampler = build_sampler(cfg, device="cuda")
        g = torch.Generator("cuda").manual_seed(0)
        conds = [torch.randn((1, 32, 32, 1), generator=g, device="cuda") for _ in range(3)]
        log = []
        with torch.no_grad(), ops.record_calls(log), ops.plain_kernels():
            sampler(*conds, generator=g)
        runs[f"sample nf={nf} batch {batch}"] = calls(log, 8, batch)
    for nf in (64, 128):
        cfg = brats_recipe(num_channels_dae=nf, image_size=64)
        state = create_train_state(cfg, seed=0, device="cuda", attn="flash")
        rng = np.random.RandomState(0)
        batch = [torch.from_numpy((rng.randn(1, 64, 64, 1) * 0.5).astype(np.float32)).cuda()
                 for _ in range(4)]
        log = []
        with ops.record_calls(log), ops.plain_kernels():
            make_train_step(cfg)(state, batch, with_r1=True,
                                 generator=torch.Generator("cuda").manual_seed(5))
        runs[f"training nf={nf} batch 2"] = calls(log, 4, 2)
    return runs


def entry_call(x, w, bias, path: str = "general"):
    """K1's kernel of ``path`` through its entry point, without the
    wrapper: the general path (the mma.sync kernel) also at wide shapes."""
    import importlib

    import torch

    conv = importlib.import_module("mudiff_torch.ops.conv3x3")
    out = torch.empty((*x.shape[:3], w.shape[-1]), dtype=x.dtype, device=x.device)
    rc = conv._kernel_fns()[path](
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        *x.shape, w.shape[-1], 1 if x.dtype == torch.bfloat16 else 2,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{path} path: CUDA error {rc}")
    return out


def shapes(cs, out_path):
    import torch
    import torch.nn.functional as F

    from mudiff_torch.ops import _build, conv3x3, conv3x3_plain
    from mudiff_torch.ops.conv3x3 import k1_path

    card = cs.card_line()
    print(card, flush=True)
    # chip_smoke's settings: the plain version in full fp32, cuDNN's timed
    # algorithms for the library call
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    built = _build.build(["conv3x3"])
    log = built.get("conv3x3", {}).get("log", "")
    lines = log.splitlines()
    ptxas = [ln for i, ln in enumerate(lines)
             if "wgmma" in ln or (i and "wgmma" in lines[i - 1])]
    print(json.dumps({"ptxas": ptxas[:40],
                      "gmma": cs.sass_count(_build.library_path("conv3x3"), "GMMA")}),
          flush=True)
    runs = record_runs(cs)
    bf16_peak, _, hbm = cs.peaks_for(torch.cuda.get_device_name(0))[1]
    keys = sorted({k for r in runs.values() for k in r}, key=str)
    g = torch.Generator("cuda").manual_seed(1)
    rows = {}
    for xshape, cout, dtype in keys:
        b, h, w, cin = xshape
        x = torch.randn(xshape, generator=g, device="cuda")
        wt = torch.randn((3, 3, cin, cout), generator=g, device="cuda") / math.sqrt(9 * cin)
        bias = 0.1 * torch.randn((cout,), generator=g, device="cuda")
        errs = {}
        for tag, dt in (("bf16", torch.bfloat16), ("fp16", torch.float16)):
            xd, wd = x.to(dt), wt.to(dt)
            errs[tag] = cs.check_close(f"conv3x3 {xshape}->{cout} {tag}", conv3x3(xd, wd, bias),
                                       conv3x3_plain(xd, wd, bias), *cs.TOL["bf16"])
        xd, wd = x.to(dtype), wt.to(dtype)
        path = k1_path(xd, wd)
        x_nchw = xd.permute(0, 3, 1, 2)
        w_oihw = wd.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bias_d = bias.to(dtype)
        flops = 2.0 * b * h * w * 9 * cin * cout
        nbytes = 2.0 * (b * h * w * (cin + cout) + 9 * cin * cout) + 4.0 * cout
        row = {"x": list(xshape), "cout": cout, "path": path, "err": errs,
               "ms": cs.time_ms(lambda: conv3x3(xd, wd, bias)),
               "general_ms": cs.time_ms(lambda: entry_call(xd, wd, bias)),
               "library_ms": cs.time_ms(lambda: F.conv2d(x_nchw, w_oihw, bias_d, padding=1)),
               "plain_ms": cs.time_ms(lambda: conv3x3_plain(xd, wd, bias)),
               "bound_ms": max(flops / bf16_peak, nbytes / hbm) * 1e3}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["general_bound_share"] = row["bound_ms"] / row["general_ms"]
        rows[(xshape, cout, dtype)] = row
        print(json.dumps({"card": card, **row}), flush=True)
    totals = {}
    for run, counts in runs.items():
        tot = {"launches": sum(counts.values())}
        for key in ("ms", "general_ms", "library_ms", "plain_ms", "bound_ms"):
            tot[key] = sum(n * rows[k][key] for k, n in counts.items())
        wide = {k: n for k, n in counts.items() if rows[k]["path"] == "wgmma"}
        tot["wgmma_launches"] = sum(wide.values())
        for key in ("ms", "general_ms", "library_ms", "bound_ms"):
            tot["wide_" + key] = sum(n * rows[k][key] for k, n in wide.items())
        tot["bound_share"] = tot["bound_ms"] / tot["ms"]
        tot["wide_bound_share"] = tot["wide_bound_ms"] / tot["wide_ms"]
        tot["wide_general_bound_share"] = tot["wide_bound_ms"] / tot["wide_general_ms"]
        totals[run] = tot
    print(json.dumps({"card": card, "totals": totals}), flush=True)
    host = {}
    for xshape, cout in (((4, 64, 64, 256), 256), ((4, 256, 256, 64), 64)):
        x = torch.randn(xshape, device="cuda", dtype=torch.bfloat16)
        wt = torch.randn((3, 3, xshape[-1], cout), device="cuda", dtype=torch.bfloat16)
        bias = torch.randn((cout,), device="cuda")
        host[f"{xshape}->{cout}"] = {
            "wrapper_us": 1e3 * cs.host_ms(lambda: conv3x3(x, wt, bias), reps=200),
            "general_entry_us": 1e3 * cs.host_ms(lambda: entry_call(x, wt, bias), reps=200),
            "wgmma_entry_us": 1e3 * cs.host_ms(lambda: entry_call(x, wt, bias, "wgmma"),
                                               reps=200)}
    print(json.dumps({"card": card, "host_us_per_call": host}), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": card, "rows": [{"dtype": str(k[2]), **v} for k, v in rows.items()],
                       "runs": {r: [[list(k[0]), k[1], n] for k, n in c.items()]
                                for r, c in runs.items()},
                       "totals": totals, "host_us_per_call": host, "ptxas": ptxas}, f,
                      indent=1)


def main_path(cs, tree, out_path):
    import torch

    from mudiff_torch import brats_recipe, build_sampler, ops

    card = cs.card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    cfg = brats_recipe(num_channels_dae=cs.NF, image_size=cs.IMAGE)
    sampler = build_sampler(cfg, device="cuda",
                            generator=torch.Generator().manual_seed(cs.SEED))
    wgen = torch.Generator("cuda").manual_seed(cs.SEED)
    cs.randomize_(sampler.g1, wgen)
    cs.randomize_(sampler.g2, wgen)
    cgen = torch.Generator("cuda").manual_seed(cs.SEED + 10)
    requests = [cs.conditions(cgen, "cuda") for _ in range(cs.REQUESTS)]
    ngen = torch.Generator("cuda").manual_seed(cs.SEED + 20)
    for conds in requests:  # warm: builds, cuDNN's choices
        sampler(*conds, generator=ngen)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    best = cs.best_of(lambda: sampler(*requests[0], generator=ngen), 3)
    launches = ops.launch_counts()
    profile = cs.profile_request(sampler, requests[0], ngen)
    host = {}
    for xshape, cout in (((4, 64, 64, 256), 256), ((4, 256, 256, 64), 64)):
        x = torch.randn(xshape, device="cuda", dtype=torch.bfloat16)
        wt = torch.randn((3, 3, xshape[-1], cout), device="cuda", dtype=torch.bfloat16)
        bias = torch.randn((cout,), device="cuda")
        host[f"{xshape}->{cout}"] = 1e3 * cs.host_ms(lambda: ops.conv3x3(x, wt, bias), reps=200)
    result = {"card": card, "tree": os.path.abspath(tree), "nf": cs.NF, "image": cs.IMAGE,
              "batch": cs.BATCH, "best_request_s": best, "slices_per_s": cs.BATCH / best,
              "launches_of_3": launches,
              "k1_path_launches_of_3": dict(getattr(ops.conv3x3, "path_launches", {})),
              "device_busy_ms": profile["device_busy_ms"],
              "idle_share": profile["idle_share"],
              "idle_share_of_best_request": 1.0 - profile["device_busy_ms"] / (1e3 * best),
              "k1_device_ms": profile["device_ms_by_group"].get("K1 conv3x3"),
              "device_ms_by_group": profile["device_ms_by_group"],
              "k1_wrapper_host_us": host}
    print(json.dumps(result), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("shapes", "main-path"))
    parser.add_argument("--tree", default=HERE, help="checkout whose port runs (main-path)")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k1_compare: no CUDA device", file=sys.stderr)
        return 2
    cs = load_tree(args.tree if args.what == "main-path" else HERE)
    if args.what == "shapes":
        shapes(cs, args.out)
    else:
        main_path(cs, args.tree, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
