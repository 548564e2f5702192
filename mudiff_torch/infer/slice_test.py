"""Slice-level test over a preprocessed test split.

The port of ``mudiff_tpu/infer/slice_test.py`` (parity source:
engine/test.py: checkpoint load with fallback dir :202-232, test-split
loader :291-300, 4-step sampling :180-199, then one global min/max over
all slices before writing ``pred/pred_%05d.png`` and ``gt/gt_%05d.png``
uint8 pairs :370-391 for tools/metric_calc.py).

The slices go through one ``Sampler`` in batches of ``batch_size``; the
tail batch is padded by repeating its last slice and trimmed after, so
every batch has one shape.  The generators come from
``infer.generators.load_generators``: W8A8 int8 under ``config.use_int8``
(the test CLI's default; static scales when the sidecars exist), else
exact.  Each batch's ``x_init`` and per-step noise come from one
``torch.Generator`` seeded with ``seed`` on the device, in the sampler's
order; ``draws`` replaces them with given ``(x_init, noise)`` pairs, one
per batch (how a test replays the JAX key splits).  The PNGs are written
by the port's own codec (``utils/png.py``).

On a ``mesh`` (``parallel.init_mesh(dp=-1, fsdp=1)``: every rank on the
data axis, the JAX package's ``use_mesh`` path) each batch is spread over
the ranks: ``batch_size`` is rounded up to a multiple of ``mesh.dp`` (the
global batch), every rank reads the global batch and samples its rows of
it (``rows_of``) on ``mesh.device``, with the global batch's draws sliced
(``sampler_draws``), and the fakes are gathered in rank order
(``gather_rows``).  Nothing in the sampler couples the rows of a batch
(GroupNorm, the dynamic int8 scales and the static ones are per example
or per channel), so world size N gives world size 1's predictions, up
to the order of fp32 sums (a dense layer's GEMM over fewer rows).  The
lead rank alone writes the PNGs and grids.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mudiff_torch.config import MuDiffConfig
from mudiff_torch.data import BRATS_ORDERS, ISLES_ORDERS, SliceDataset
from mudiff_torch.diffusion.sampling import sampler_draws
from mudiff_torch.infer.generators import compute_dtype_of, load_generators
from mudiff_torch.parallel.mesh import Mesh, gather_rows, rows_of
from mudiff_torch.sampler import Sampler, serving_device
from mudiff_torch.utils.png import write_gray8
from mudiff_torch.utils.reports import save_image_grid


def export_png_pairs(pred: np.ndarray, gt: np.ndarray, pred_dir: str,
                     gt_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Write (N, H, W) predictions and targets as ``pred_%05d.png`` /
    ``gt_%05d.png`` uint8 pairs scaled with ONE shared min / max over pred
    AND gt (the reference stacks both sets before scaling): separate
    ranges would normalise away a global intensity error of the
    predictions.  Returns the codes written."""
    lo = min(float(pred.min()), float(gt.min()))
    hi = max(float(pred.max()), float(gt.max()))
    scale = (hi - lo) or 1.0
    pred8, gt8 = (np.clip((x - lo) / scale * 255.0, 0, 255).astype(np.uint8)
                  for x in (pred, gt))
    for i in range(pred.shape[0]):
        write_gray8(os.path.join(pred_dir, f"pred_{i:05d}.png"), pred8[i])
        write_gray8(os.path.join(gt_dir, f"gt_{i:05d}.png"), gt8[i])
    return pred8, gt8


def sample_and_test(
    config: MuDiffConfig,
    ckpt_dir: Optional[str] = None,
    output_dir: Optional[str] = None,
    batch_size: int = 8,
    save_grids: bool = False,
    seed: int = 42,
    generators=None,
    *,
    device=None,
    attn: str = "bf16",
    draws: Optional[Sequence] = None,
    mesh: Optional[Mesh] = None,
) -> Dict:
    """Sample the test split; write the pred/ and gt/ PNG dirs.

    ``generators`` may give loaded ``(g1, g2)`` instead of reading the
    checkpoints of ``ckpt_dir`` (default the experiment's directory).
    ``draws`` holds each batch's ``(x_init, noise)``, of the global batch
    on a ``mesh``, whose device replaces ``device``.
    Returns the predictions and targets (``pred``, ``gt``: (N, H, W)
    float32 in [-1, 1]), ``n_slices``, the global ``batch_size`` and
    ``seconds``: host time to load the generators, to sample
    (synchronised per batch by the copy to the host) and to write the
    PNGs.  On the lead rank (or without a mesh) also the two directories
    and the codes written (``pred_u8``, ``gt_u8``: (N, H, W) uint8).
    """
    if mesh is None:
        device = serving_device(device, "sample_and_test")
    else:
        device = mesh.device
        batch_size = -(-batch_size // mesh.dp) * mesh.dp
    lead = mesh is None or mesh.lead
    rows = rows_of(batch_size, mesh)
    exp_dir = ckpt_dir or os.path.join(config.output_path, config.exp, config.target_modality)
    output_dir = output_dir or os.path.join(exp_dir, "generated_samples")
    pred_dir = os.path.join(output_dir, "pred")
    gt_dir = os.path.join(output_dir, "gt")
    if lead:
        os.makedirs(pred_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)

    orders = ISLES_ORDERS if config.dataset == "isles" else BRATS_ORDERS
    ds = SliceDataset("test", config.input_path, config.target_modality, orders=orders)
    t0 = time.perf_counter()
    if generators is None:
        g1, g2 = load_generators(config, exp_dir, device=device, attn=attn)
    else:
        g1, g2 = generators
    sampler = Sampler(config, g1, g2, device, compute_dtype_of(config))
    gen = torch.Generator(device).manual_seed(seed)
    t1 = time.perf_counter()

    all_pred, all_gt = [], []
    n = len(ds)
    for b, start in enumerate(range(0, n, batch_size)):
        idx = np.arange(start, min(start + batch_size, n))
        c1, c2, c3, target = ds.gather_batch(idx)
        pad = batch_size - len(idx)
        if pad:  # one shape for every batch: pad the tail, trim after
            c1, c2, c3, target = (np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                                  for a in (c1, c2, c3, target))
        conds = [torch.from_numpy(c[rows]).to(device) for c in (c1, c2, c3)]
        if draws is None and mesh is None:
            fake = sampler(*conds, generator=gen)
        else:
            if draws is None:
                x_init, noise = sampler_draws(gen, c1.shape, config.nz,
                                              config.num_timesteps, rows)
            else:
                x_init, noise = draws[b]
                x_init, noise = x_init[rows], [(z[rows], e[rows]) for z, e in noise]
            fake = sampler(*conds, x_init=x_init.to(device),
                           noise=[(z.to(device), e.to(device)) for z, e in noise])
        fake = gather_rows(fake, mesh).cpu().numpy()
        if pad:
            fake, target = fake[:-pad], target[:-pad]
        all_pred.append(fake)
        all_gt.append(target[..., :fake.shape[-1]])
        if save_grids and lead:
            save_image_grid((fake + 1.0) / 2.0, os.path.join(output_dir, f"grid_{start:05d}.png"))

    pred = np.concatenate(all_pred, axis=0)[..., 0]
    gt = np.concatenate(all_gt, axis=0)[..., 0]
    t2 = time.perf_counter()
    out = {"n_slices": pred.shape[0], "batch_size": batch_size, "pred": pred, "gt": gt}
    if lead:
        pred8, gt8 = export_png_pairs(pred, gt, pred_dir, gt_dir)
        out.update(pred_dir=pred_dir, gt_dir=gt_dir, pred_u8=pred8, gt_u8=gt8)
    out["seconds"] = {"load_s": t1 - t0, "sample_s": t2 - t1,
                      "export_s": time.perf_counter() - t2}
    return out
