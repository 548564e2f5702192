"""Tiny cells for the CPU tests: the recipe's branch at small widths,
run through the harness with the port's plain versions on the CPU."""

from __future__ import annotations

import copy
import time
import io
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_config(name: str = "mudiff_nf128", **over) -> dict:
    with open(ROOT / "perfbench" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg.update(image_size=32, num_channels_dae=32, ch_mult=[1, 2], num_res_blocks=1, nz=8,
               z_emb_dim=32, t_emb_dim=32, ngf=8, attn_resolutions=[16])
    cfg.update(over)
    return cfg


def tiny_traffic(name: str, **over) -> dict:
    with open(ROOT / "perfbench" / "traffic" / f"{name}.json") as f:
        tr = json.load(f)
    tr.update(pool_patients=2, pool_slices=4, warmup_requests=1, trace_requests=1,
              compare_requests=1, ref_rows=2, batch=3,
              calib_batches=min(tr.get("calib_batches", 0), 1))
    tr.update(over)
    return tr


def run_cell(cell: str, seed: int = 1234567, config=None, traffic=None, limits=None,
             seconds: float = 0.0):
    """(exit code, result line dict, stderr text) of one run of ``cell``
    at a tiny size on the CPU (the look for a card is skipped)."""
    from perfbench import core

    manifest, c, cfg, tr, lim = core.find_cell(ROOT, cell)
    ctx = core.Ctx(ROOT, c, config or tiny_config(c["config"]),
                   traffic or tiny_traffic(c["traffic"]),
                   copy.deepcopy(limits if limits is not None else lim), seed, seconds, False,
                   "cpu", time.perf_counter())
    out, err = io.StringIO(), io.StringIO()
    rc = core.report(ctx, manifest, "cpu", 1, out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
