"""Synthetic multi-contrast MRI phantoms: the quality protocol's dataset.

The port's copy of ``tools/make_phantom_dataset.py`` (``make_patient``
:45, ``zscore`` :97, ``main`` :106).  Per patient a shared random anatomy
(skull ellipse, smooth tissue field, ventricles, a lesion) is rendered
into four contrasts by contrast-specific transforms, bias fields and
noise, so synthesising one contrast needs the other three.  Splits are
by patient (held-out val / test patients).

For the same arguments it writes the same bits as the tool: the same
``np.random.RandomState`` stream drawn in the same order, the same
``scipy.ndimage.zoom`` upsampling and the same float32 arithmetic.  The
layout is the preprocessed one the train / test CLIs read:
``{output_dir}/{split}/{MOD}.npy``, float32 (N, H, W), z-scored per
patient over its nonzero voxels.  Host code only.

    python -m mudiff_torch.data.phantom --output_dir NPY \\
        [--n_patients 60] [--image_size 256] [--slices 8] [--seed 0] \\
        [--train_ratio 0.7] [--val_ratio 0.15]

At the defaults the split is 42 / 9 / 9 patients: 336 / 72 / 72 slices.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

import numpy as np
from scipy.ndimage import zoom

MODS = ["T1", "T1CE", "T2", "FLAIR"]
SPLITS = ("train", "val", "test")


def _smooth_noise(rng: np.random.RandomState, shape, scale: int) -> np.ndarray:
    """Low-frequency random field: coarse noise upsampled linearly."""
    coarse = rng.randn(*[max(2, s // scale) for s in shape]).astype(np.float32)
    factors = [s / c for s, c in zip(shape, coarse.shape)]
    return zoom(coarse, factors, order=1).astype(np.float32)


def make_patient(rng: np.random.RandomState, size: int, slices: int) -> Dict[str, np.ndarray]:
    """Return {contrast: (slices, size, size) float32 raw intensities}."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy, cx = size / 2 + rng.randn() * size * 0.02, size / 2 + rng.randn() * size * 0.02
    ry, rx = size * (0.38 + 0.04 * rng.rand()), size * (0.30 + 0.04 * rng.rand())

    # the anatomy shared through depth: tissue field, ventricles, lesion
    tissue3 = _smooth_noise(rng, (slices, size, size), 32)
    detail3 = _smooth_noise(rng, (slices, size, size), 8)
    lcy = cy + rng.randn() * size * 0.12
    lcx = cx + rng.randn() * size * 0.12
    lr = size * (0.03 + 0.05 * rng.rand())
    vent_w = size * (0.05 + 0.02 * rng.rand())

    out = {m: np.zeros((slices, size, size), np.float32) for m in MODS}
    for z in range(slices):
        zfac = 1.0 - 0.3 * abs(z - slices / 2) / max(1, slices / 2)
        brain = (((yy - cy) / (ry * zfac)) ** 2
                 + ((xx - cx) / (rx * zfac)) ** 2) < 1.0
        tissue = 0.5 + 0.25 * np.tanh(tissue3[z]) + 0.08 * detail3[z]
        vent = ((np.abs(xx - cx) < vent_w)
                & (np.abs(yy - cy) < size * 0.12 * zfac))
        lesion_soft = np.exp(
            -(((yy - lcy) ** 2 + (xx - lcx) ** 2) / (2 * (lr * zfac) ** 2))
        )

        # each contrast's response to the same tissue map
        t1 = 0.9 - 0.5 * tissue
        t1[vent] *= 0.35
        t1c = t1.copy()
        t1c += 0.9 * lesion_soft  # the enhancing lesion on T1CE
        t2 = 0.25 + 0.6 * tissue
        t2[vent] = 0.95
        t2 += 0.35 * lesion_soft
        fl = 0.3 + 0.55 * tissue
        fl[vent] *= 0.25  # CSF suppressed on FLAIR
        fl += 0.8 * lesion_soft

        for name, img in (("T1", t1), ("T1CE", t1c), ("T2", t2), ("FLAIR", fl)):
            bias = 1.0 + 0.15 * np.tanh(_smooth_noise(rng, (size, size), 64))
            noisy = np.clip(img, 0, None) * bias \
                + 0.015 * rng.randn(size, size).astype(np.float32)
            noisy = np.where(brain, np.clip(noisy, 0.01, None), 0.0)
            out[name][z] = noisy.astype(np.float32)
    return out


def zscore(stack: np.ndarray) -> np.ndarray:
    """Per-patient z-score over the nonzero voxels (preprocess semantics)."""
    mask = stack != 0
    vals = stack[mask]
    mean = float(vals.mean()) if vals.size else 0.0
    std = (float(vals.std()) or 1.0) if vals.size else 1.0
    return ((stack - mean) / std).astype(np.float32)


def split_of_patients(n_patients: int, train_ratio: float, val_ratio: float) -> List[str]:
    """Each patient's split, in generation order: train, then val, then test."""
    if n_patients < 3:
        raise ValueError(f"need at least one patient per split, got {n_patients}")
    n_train = max(1, int(n_patients * train_ratio))
    n_val = max(1, int(n_patients * val_ratio))
    while n_train + n_val >= n_patients:
        n_train -= 1
    return ["train"] * n_train + ["val"] * n_val + ["test"] * (n_patients - n_train - n_val)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("mudiff_torch phantom dataset")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--n_patients", type=int, default=60)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--slices", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train_ratio", type=float, default=0.7)
    ap.add_argument("--val_ratio", type=float, default=0.15)
    return ap


def main(argv=None) -> Dict[str, int]:
    """Write the set; returns the slices of each split."""
    args = build_parser().parse_args(argv)
    rng = np.random.RandomState(args.seed)
    splits = split_of_patients(args.n_patients, args.train_ratio, args.val_ratio)
    data = {s: {m: [] for m in MODS} for s in SPLITS}
    for split in splits:
        patient = make_patient(rng, args.image_size, args.slices)
        for m in MODS:
            data[split][m].append(zscore(patient[m]))
    counts = {}
    for split in SPLITS:
        d = os.path.join(args.output_dir, split)
        os.makedirs(d, exist_ok=True)
        for m in MODS:
            np.save(os.path.join(d, f"{m}.npy"), np.concatenate(data[split][m], axis=0))
        patients = len(data[split][MODS[0]])
        counts[split] = patients * args.slices
        print(f"[phantom] {split}: {counts[split]} slices ({patients} patients)")
    return counts


if __name__ == "__main__":
    main()
