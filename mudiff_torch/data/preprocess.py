"""NIfTI -> normalized axial-slice .npy converter.

Parity source: tools/pre_process.py — z-score over nonzero (brain)
voxels (:46-67), center +-half_range axial slices (:70-97), seeded
shuffle patient split (:189-218), modality filename map
t1n/t1c/t2w/t2f -> T1/T1CE/T2/FLAIR (:232), two-pass streaming write
into float32 (N, H, W) memmaps per split/modality (:238-398).

The port's copy of ``mudiff_tpu/data/preprocess.py``, reading through
the port's own NIfTI reader (``mudiff_torch.utils.nifti``); the .npy
stacks it writes are the JAX package's, bit for bit.  Host code only.

    python -m mudiff_torch.data.preprocess --input_dir RAW --output_dir NPY \\
        [--slice_half_range 80] [--train_ratio 0.7] [--val_ratio 0.2]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from numpy.lib.format import open_memmap

from mudiff_torch.utils import nifti

BRATS_MODALITY_MAP = {"t1n": "T1", "t1c": "T1CE", "t2w": "T2", "t2f": "FLAIR"}
ISLES_MODALITY_MAP = {"t1": "T1", "t2": "T2", "dwi": "DWI", "flair": "FLAIR"}


def normalize_volume(
    volume: np.ndarray, mask: Optional[np.ndarray] = None
) -> np.ndarray:
    """z-score a volume by the mean/std of its nonzero (brain) voxels
    (reference pre_process.py:46-67)."""
    data = volume.astype(np.float32, copy=False)
    if mask is None:
        mask = data != 0
    vals = data[mask]
    if vals.size == 0:
        mean, std = 0.0, 1.0
    else:
        mean = float(vals.mean())
        std = float(vals.std()) or 1.0
    return (data - mean) / std


def slice_bounds(depth: int, half_range: int) -> Tuple[int, int]:
    center = depth // 2
    return max(0, center - half_range), min(depth - 1, center + half_range)


def extract_center_slices(
    volume: np.ndarray, half_range: int
) -> List[np.ndarray]:
    """Axial slices around the center index (reference pre_process.py:70-97)."""
    if volume.ndim != 3:
        raise ValueError(f"Expected 3D volume, got {volume.ndim}D")
    start, end = slice_bounds(volume.shape[2], half_range)
    return [volume[:, :, i] for i in range(start, end + 1)]


def split_patients(
    patients: Sequence[str],
    seed: int,
    train_ratio: float,
    val_ratio: float,
    num_patients: Optional[int] = None,
) -> Dict[str, List[str]]:
    """Seeded shuffle split (reference pre_process.py:189-218)."""
    patients = list(patients)
    rng = np.random.RandomState(seed)
    rng.shuffle(patients)
    if num_patients is not None and num_patients < len(patients):
        patients = patients[:num_patients]
    total = len(patients)
    n_train = int(total * train_ratio)
    n_val = min(int(total * val_ratio), total - n_train)
    return {
        "train": patients[:n_train],
        "val": patients[n_train:n_train + n_val],
        "test": patients[n_train + n_val:],
    }


def load_split_lists(split_dir: str) -> Dict[str, List[str]]:
    """Load explicit patient split lists (reference data/{brats,isles}/
    {train,val,test}.list: one patient ID per line)."""
    splits: Dict[str, List[str]] = {}
    for split in ("train", "val", "test"):
        path = os.path.join(split_dir, f"{split}.list")
        if os.path.isfile(path):
            with open(path) as f:
                splits[split] = [ln.strip() for ln in f if ln.strip()]
    if not splits:
        raise FileNotFoundError(f"no *.list files under {split_dir}")
    return splits


def find_modality_file(
    patient_dir: str, keyword: str
) -> Optional[str]:
    for name in sorted(os.listdir(patient_dir)):
        low = name.lower()
        if keyword in low and (low.endswith(".nii") or low.endswith(".nii.gz")):
            return os.path.join(patient_dir, name)
    return None


def preprocess(
    input_dir: str,
    output_dir: str,
    half_range: int = 80,
    seed: int = 42,
    train_ratio: float = 0.7,
    val_ratio: float = 0.2,
    num_patients: Optional[int] = None,
    modality_map: Dict[str, str] = None,
    splits: Optional[Dict[str, List[str]]] = None,
) -> Dict[str, Dict[str, str]]:
    """Two-pass conversion: count + shape-infer, then stream-write
    normalized slices into per-split/per-modality memmaps.

    ``splits`` may supply explicit patient lists (e.g. the reference's
    data/brats/*.list files) instead of the seeded shuffle.
    Returns {split: {MOD: npy_path}}.
    """
    modality_map = modality_map or BRATS_MODALITY_MAP
    patients = sorted(
        d for d in os.listdir(input_dir)
        if os.path.isdir(os.path.join(input_dir, d))
    )
    if not patients:
        raise FileNotFoundError(f"no patient dirs under {input_dir}")
    if splits is None:
        splits = split_patients(
            patients, seed, train_ratio, val_ratio, num_patients
        )

    mods = list(modality_map.values())

    # pass 1: count slices and infer H, W
    counts = {s: 0 for s in splits}
    hw: Optional[Tuple[int, int]] = None
    per_patient_slices: Dict[str, int] = {}
    for split, plist in splits.items():
        for p in plist:
            pdir = os.path.join(input_dir, p)
            f = None
            for kw in modality_map:
                f = find_modality_file(pdir, kw)
                if f:
                    break
            if f is None:
                continue
            img = nifti.load(f)
            shp = img.shape
            start, end = slice_bounds(shp[2], half_range)
            n = end - start + 1
            per_patient_slices[p] = n
            counts[split] += n
            if hw is None:
                hw = (shp[0], shp[1])

    assert hw is not None, "no readable volumes found"

    # pass 2: stream-write
    out_paths: Dict[str, Dict[str, str]] = {}
    for split, plist in splits.items():
        os.makedirs(os.path.join(output_dir, split), exist_ok=True)
        mmaps = {}
        out_paths[split] = {}
        for mod in mods:
            path = os.path.join(output_dir, split, f"{mod}.npy")
            mmaps[mod] = open_memmap(
                path, mode="w+", dtype=np.float32,
                shape=(counts[split], hw[0], hw[1]),
            )
            out_paths[split][mod] = path
        cursor = 0
        for p in plist:
            if p not in per_patient_slices:
                continue
            pdir = os.path.join(input_dir, p)
            n = per_patient_slices[p]
            for kw, mod in modality_map.items():
                f = find_modality_file(pdir, kw)
                if f is None:
                    mmaps[mod][cursor:cursor + n] = 0.0
                    continue
                vol = normalize_volume(nifti.load(f).get_fdata())
                slices = extract_center_slices(vol, half_range)
                arr = np.stack(slices[:n], axis=0)
                mmaps[mod][cursor:cursor + arr.shape[0]] = arr
            cursor += n
        for m in mmaps.values():
            m.flush()
    return out_paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("mudiff_torch pre_process")
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--slice_half_range", type=int, default=80)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--train_ratio", type=float, default=0.7)
    ap.add_argument("--val_ratio", type=float, default=0.2)
    ap.add_argument("--num_patients", type=int, default=None)
    ap.add_argument(
        "--dataset", choices=("brats", "isles"), default="brats"
    )
    ap.add_argument(
        "--split_dir", default=None,
        help="dir with train.list/val.list/test.list patient IDs "
             "(overrides the seeded shuffle split)",
    )
    args = ap.parse_args(argv)
    mm = BRATS_MODALITY_MAP if args.dataset == "brats" else ISLES_MODALITY_MAP
    splits = load_split_lists(args.split_dir) if args.split_dir else None
    out = preprocess(
        args.input_dir, args.output_dir,
        half_range=args.slice_half_range, seed=args.seed,
        train_ratio=args.train_ratio, val_ratio=args.val_ratio,
        num_patients=args.num_patients, modality_map=mm, splits=splits,
    )
    for split, mods in out.items():
        for mod, path in mods.items():
            print(f"{split}/{mod}: {path}")


if __name__ == "__main__":
    main()
