"""``python -m mudiff_torch.cli.calibrate_int8``: record a static int8
activation calibration for a trained checkpoint (the counterpart of
``tools/calibrate_int8.py``).

    python -m mudiff_torch.cli.calibrate_int8 -c experiments/phantom_flagship.yaml \\
        -e flagship128 [--batches 4] [--batch-size 4] [--margin 1.0] [--min-ch 128] \\
        [--seed 0] [--attn bf16]

Runs the reverse sampler over ``--batches`` validation batches (slices
picked by a ``RandomState(seed)`` permutation, as the JAX tool picks
them) with the experiment's ``test_args`` generators serving W8A8 with
dynamic scales, records every routed conv's per-channel input absmax
(``infer/calibrate.py``), and writes the JSON v2 sidecars
``int8_calib_g{1,2}.json`` beside the checkpoints in
``<output_root>/<exp_name>/<target>``, where ``load_generators`` (and
the JAX package) pick them up.  ``--min-ch`` overrides the routing
threshold (default ``max(64, 2 * nf)``).  The sampler's draws come from
a ``torch.Generator`` seeded with ``--seed`` on the card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mudiff_torch.config import _config_from_yaml, load_experiment


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("mudiff_torch calibrate_int8")
    ap.add_argument("-c", "--config", default="experiments/phantom_flagship.yaml")
    ap.add_argument("-e", "--experiment", default="flagship128")
    ap.add_argument("--batches", type=int, default=4,
                    help="number of val batches to record over")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--margin", type=float, default=1.0,
                    help="absmax headroom multiplier")
    ap.add_argument("--min-ch", type=int, default=None,
                    help="routing threshold override (default: the width-aware "
                         "max(64, 2*nf))")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn", choices=("bf16", "einsum", "flash"), default="bf16")
    return ap


def main(argv=None, device=None) -> dict:
    """Run the CLI; ``device`` (default the card) is for the tests only.
    Returns the sidecars' paths, the two calibrations and the batches'
    slice indices."""
    from mudiff_torch.data import BRATS_ORDERS, ISLES_ORDERS, SliceDataset
    from mudiff_torch.infer.calibrate import calib_sidecar_paths, calibrate_sampler, save_calib
    from mudiff_torch.infer.generators import compute_dtype_of, load_generators
    from mudiff_torch.models import NCSNppGenerator
    from mudiff_torch.sampler import Sampler, serving_device

    args = build_parser().parse_args(argv)
    device = serving_device(device, "calibrate_int8")
    doc, exp = load_experiment(args.config, args.experiment)
    target = exp.get("target", "T1CE")
    ckpt_dir = os.path.join(doc["output_root"], exp["exp_name"], target)
    cfg = _config_from_yaml(dict(exp["test_args"], use_int8=True, int8_static=False),
                            doc.get("data_path", "/data/BRATS"), doc["output_root"],
                            exp["exp_name"], target)
    dtype = compute_dtype_of(cfg)
    # dynamic-mode generators record while they compute
    g1, g2 = load_generators(cfg, ckpt_dir, device=device, attn=args.attn)
    if args.min_ch is not None:
        gens = []
        for g in (g1, g2):
            h = NCSNppGenerator(cfg, adaptive=g.adaptive, attn=args.attn, dtype=dtype,
                                int8_min_ch=args.min_ch)
            h.load_state_dict(g.state_dict())
            gens.append(h.requires_grad_(False).eval().to(device))
        g1, g2 = gens

    orders = ISLES_ORDERS if cfg.dataset == "isles" else BRATS_ORDERS
    ds = SliceDataset("val", cfg.input_path, cfg.target_modality, orders=orders)
    sel = np.random.RandomState(args.seed).permutation(len(ds))
    batches, picked = [], []
    for i in range(args.batches):
        idx = np.sort(sel[i * args.batch_size:(i + 1) * args.batch_size])
        if len(idx) == 0:
            break
        c1, c2, c3, _ = ds.gather_batch(idx)
        batches.append(tuple(torch.from_numpy(c).to(device) for c in (c1, c2, c3)))
        picked.append(idx.tolist())

    post = Sampler(cfg, g1, g2, device, dtype).post
    calib1, calib2 = calibrate_sampler(
        g1, g2, post, batches, cfg.num_timesteps, cfg.nz, compute_dtype=dtype,
        margin=args.margin, generator=torch.Generator(device).manual_seed(args.seed))
    p1, p2 = calib_sidecar_paths(ckpt_dir)
    save_calib(p1, calib1)
    save_calib(p2, calib2)
    print(f"wrote {p1} ({len(calib1.sites)} sites, min_ch={calib1.min_ch})")
    print(f"wrote {p2} ({len(calib2.sites)} sites, min_ch={calib2.min_ch})")
    return {"paths": (p1, p2), "calibs": (calib1, calib2), "indices": picked}


if __name__ == "__main__":
    main()
