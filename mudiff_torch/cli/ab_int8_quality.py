"""``python -m mudiff_torch.cli.ab_int8_quality``: A/B the serving modes on
one trained checkpoint (the counterpart of ``tools/ab_int8_quality.py``).

    python -m mudiff_torch.cli.ab_int8_quality -c experiments/phantom_flagship.yaml \\
        -e flagship64 [--out OUT] [--modes bf16,int8,int8-static] \\
        [--attn einsum[,bf16,flash]] [--lpips_rand]      # or -e all

Drives the test path of the ``run`` CLI (``sample_and_test`` +
``evaluate_pair_dirs``) over the checkpoint in
``<output_root>/<exp_name>/<target>`` once per mode and attention
lowering, each into ``<out>/<exp_name>/<mode>`` (``<mode>-<attn>`` for
an ``--attn`` other than ``einsum``, the exact lowering), and prints a
row per leg (the metrics and ``sample_and_test_s``), then one JSON line
``{"experiment", "target", "ab": {leg: row}}``.  The modes are the JAX
tool's: ``bf16`` (exact), ``int8`` (W8A8, dynamic scales) and
``int8-static`` (the ``calibrate_int8`` sidecars, which must exist: a
missing sidecar raises).  ``--attn`` takes a list, where the JAX tool
read ``MUDIFF_ATTN``.  ``--lpips_rand`` adds ``metric_calc``'s
random-feature proxy to each row.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

MODES = ("bf16", "int8", "int8-static")
ATTNS = ("einsum", "bf16", "flash")


def _choices(text: str, allowed, what: str):
    picked = tuple(p.strip() for p in text.split(",") if p.strip())
    bad = sorted(set(picked) - set(allowed))
    if bad or not picked:
        raise SystemExit(f"unknown {what}: {bad or text!r} (from {', '.join(allowed)})")
    return picked


def leg_name(mode: str, attn: str) -> str:
    """A leg's key and directory: the mode, with the lowering beside it
    unless it is the exact one."""
    return mode if attn == "einsum" else f"{mode}-{attn}"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("mudiff_torch ab_int8_quality")
    ap.add_argument("-c", "--config", default="experiments/phantom_flagship.yaml")
    ap.add_argument("-e", "--experiment", default="flagship128")
    ap.add_argument("--out", default="./int8_ab")
    ap.add_argument("--modes", default=",".join(MODES),
                    help=f"comma list from {{{','.join(MODES)}}}")
    ap.add_argument("--attn", default="einsum",
                    help=f"comma list of attention lowerings from {{{','.join(ATTNS)}}}")
    ap.add_argument("--lpips_rand", action="store_true",
                    help="add the random-feature LPIPS proxy (key lpips_rand)")
    return ap


def main(argv=None, device=None) -> Dict[str, Any]:
    """Run the CLI; ``device`` (default the card) is for the tests only.
    Returns {experiment: the printed JSON object, with each leg's
    ``pred_dir`` / ``gt_dir`` under ``dirs``}."""
    from mudiff_torch.cli.metric_calc import scorer
    from mudiff_torch.config import _config_from_yaml
    from mudiff_torch.infer import sample_and_test
    from mudiff_torch.metrics import evaluate_pair_dirs
    from mudiff_torch.sampler import serving_device
    from mudiff_torch.utils import yaml_lite

    args = build_parser().parse_args(argv)
    modes = _choices(args.modes, MODES, "modes")
    attns = _choices(args.attn, ATTNS, "attention lowerings")
    device = serving_device(device, "ab_int8_quality")
    doc = yaml_lite.load(args.config)
    exps = doc["experiments"] if args.experiment == "all" else [
        e for e in doc["experiments"] if e["exp_name"] == args.experiment]
    if not exps:
        raise SystemExit(f"no experiment {args.experiment!r}")
    lpips_fn = scorer(None, None, True, device) if args.lpips_rand else None

    results = {}
    for exp in exps:
        name = exp["exp_name"]
        target = exp.get("target", "T1CE")
        ckpt_dir = os.path.join(doc["output_root"], name, target)
        rows, dirs = {}, {}
        for mode in modes:
            cfg = _config_from_yaml(
                dict(exp["test_args"], use_int8=mode.startswith("int8"),
                     int8_static=(mode == "int8-static")),
                doc.get("data_path", "/data/BRATS"), doc["output_root"], name, target)
            for attn in attns:
                leg = leg_name(mode, attn)
                t0 = time.time()
                out = sample_and_test(cfg, ckpt_dir=ckpt_dir,
                                      output_dir=os.path.join(args.out, name, leg),
                                      device=device, attn=attn)
                wall = time.time() - t0
                metrics = evaluate_pair_dirs(out["pred_dir"], out["gt_dir"], lpips_fn=lpips_fn)
                rows[leg] = {**metrics, "sample_and_test_s": round(wall, 1)}
                dirs[leg] = {"pred_dir": out["pred_dir"], "gt_dir": out["gt_dir"]}
                print(name, leg, json.dumps(rows[leg]), flush=True)
        line = {"experiment": name, "target": target, "ab": rows}
        print(json.dumps(line), flush=True)
        results[name] = {**line, "dirs": dirs}
    return results


if __name__ == "__main__":
    main()
