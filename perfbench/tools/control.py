"""Readings that the limits of a cell are set from, at the cell's own
size, many seeds in one process: the program's (sound runs), the
control's, and for training the half-batch fault's.

    python3 perfbench/tools/control.py --cell nf128.sample.b8.bf16 \\
        --seeds 1 2 3 ... --control-seeds 1 2 3 --out out/control.json

Controls (the step below the configuration's precision that would tempt
a later change):
* a bf16 sampling cell: the program's own W8A8 path (dynamic scales)
  serving the same requests, against the same float32 reference;
* the W8A8 sampling cell: the reference's W4A4 (the same calibration,
  7 codes a side) in the program's place, against the reference's W8A8;
* the bf16 training cell: the reference with every product's inputs in
  float8 e4m3 in the program's place, against the float32 reference.
A development tool: the benchmark never runs it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def sample_cell(ctx, seeds, control_seeds):
    import torch

    from perfbench.drivers import common
    from perfbench.drivers import sample as S
    from perfbench.reference.ops import Quantized

    tr = ctx.traffic
    mode = tr["mode"]
    k = int(tr["compare_requests"])
    rows = []
    sampler = None
    for seed in seeds:
        ctx.seed = seed
        W = common.weights(ctx.config, seed, ctx.device)
        inputs = S.Inputs(ctx.config, tr, seed, ctx.device)
        if sampler is None or mode == "w8a8s":
            sampler = S.build(ctx, inputs, W, mode)
        else:
            S._load(sampler, W)
        outs = {i: S.serve(sampler, inputs, i) for i in range(k)}
        common.sync(ctx.device)
        row = {"seed": seed, "sound": S.check(ctx, inputs, W, outs, mode)}
        if seed in control_seeds:
            if mode == "bf16":
                ctl = S.build(ctx, inputs, W, "w8a8d")
                couts = {i: S.serve(ctl, inputs, i) for i in range(k)}
                del ctl
                row["control"] = S.check(ctx, inputs, W, couts, "bf16")
            else:
                rec = S.reference_calibration(ctx.config, tr, inputs, W)
                w4 = {i: S.reference_sample(ctx.config, Quantized(7, absmax=rec), inputs, W, i,
                                            int(tr["ref_rows"]), True) for i in range(k)}
                row["control"] = S.check(ctx, inputs, W, w4, mode,
                                         ref_prec=Quantized(127, absmax=rec))
        print(json.dumps(row), flush=True)
        rows.append(row)
        common.free(ctx.device)
        torch.cuda.empty_cache()
    return rows


def train_cell(ctx, seeds, control_seeds):
    import torch

    from perfbench.drivers import common
    from perfbench.drivers import train as T
    from perfbench.reference.ops import Fp8

    tr = ctx.traffic
    n = int(tr["compare_steps"])
    rows = []
    for seed in seeds:
        ctx.seed = seed
        inputs = T.Inputs(ctx.config, tr, seed, ctx.device)
        row = {"seed": seed}
        for tag, half in (("sound", False), ("half_batch", True)):
            if half and seed not in control_seeds:
                continue
            W = common.weights(ctx.config, seed, ctx.device, ("g1", "g2", "d", "att"))
            state, step = T.build(ctx, W)
            prog = {"losses": []}
            for i in range(n):
                if half:
                    from mudiff_torch.train.steps import TrainDraws

                    full = (inputs.draws_of(i, T.D_DRAW), inputs.draws_of(i, T.G_DRAW))
                    dr = tuple(TrainDraws(**{k: v[:1] for k, v in d.items()}) for d in full)
                    losses = step(state, tuple(x[:1] for x in inputs.batch_of(i)), draws=dr)
                else:
                    losses = T.iterate(state, step, inputs, i)
                prog["losses"].append({k: float(v) for k, v in losses.items()})
                if i == 0:
                    prog["grads"] = T.norms(T.first_grads(state))
            prog["changes"] = T.changes({m: dict(getattr(state, m).named_parameters())
                                         for m in T.MODULES}, W)
            del state, step, W
            common.free(ctx.device)
            row[f"{tag}_prog"] = prog
        ref = T.reference_run(ctx, inputs)
        sound = row.pop("sound_prog")
        row["sound"] = T.readings(sound, ref)
        row["sound_details"] = T.details(sound, ref)
        if "half_batch_prog" in row:
            row["half_batch"] = T.readings(row.pop("half_batch_prog"), ref)
        if seed in control_seeds:
            fp8 = T.reference_run(ctx, inputs, Fp8())
            row["control"] = T.readings(fp8, ref)
            row["control_details"] = T.details(fp8, ref)
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    from pathlib import Path

    from perfbench import core

    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    root = Path(ROOT)
    core.set_cache_dirs(root)
    manifest, c, cfg, tr, lim = core.find_cell(root, args.cell)
    ctx = core.Ctx(root, c, cfg, tr, lim, args.seeds[0], 0.0, False, "cuda", time.perf_counter())
    from perfbench.drivers import common

    common.build_kernels("cuda")
    fn = train_cell if tr["driver"] == "train" else sample_cell
    t = time.perf_counter()
    rows = fn(ctx, args.seeds, set(args.control_seeds))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"cell": args.cell, "rows": rows, "seconds": time.perf_counter() - t}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
