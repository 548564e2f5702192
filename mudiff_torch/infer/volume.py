"""Whole-volume prediction from three NIfTI inputs.

The port of ``mudiff_tpu/infer/volume.py`` (parity source:
engine/test_volume.py): robust 1-99 percentile min-max to [-1, 1] over
nonzero voxels (:135-157), the center +-slice_half_range axial slices
(:159-168), per-slice bilinear resize to image_size (:269-276), the
4-step sampler in fixed-size batches, [0, 1] mapping, zero-padded volume
reassembly and NIfTI save with the original affine/header (:170-181,
:292-300), condition modality orders (:232-237).

The batches go through one ``Sampler`` on the card.  The tail batch is
padded by repeating its last slice and trimmed after, so every batch has
one shape.  Each batch's ``x_init`` and per-step noise come from one
``torch.Generator`` seeded with ``seed`` on the sampler's device, in the
sampler's order; ``draws`` replaces them with given ``(x_init, noise)``
pairs, one per batch, which is how a test replays the JAX package's key
splits.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mudiff_torch.config import MuDiffConfig
from mudiff_torch.infer.generators import compute_dtype_of, load_generators
from mudiff_torch.sampler import Sampler, serving_device
from mudiff_torch.utils import nifti

VOLUME_ORDERS: Dict[str, List[str]] = {
    "T1CE": ["FLAIR", "T2", "T1"],
    "FLAIR": ["T1CE", "T1", "T2"],
    "T2": ["T1CE", "T1", "FLAIR"],
    "T1": ["FLAIR", "T1CE", "T2"],
}

Draw = Tuple[torch.Tensor, Sequence[Tuple[torch.Tensor, torch.Tensor]]]


def robust_minmax_to_minus1_1(
    vol: np.ndarray,
    mask: Optional[np.ndarray] = None,
    pmin: float = 1.0,
    pmax: float = 99.0,
) -> np.ndarray:
    """Reference engine/test_volume.py:135-157."""
    data = vol.astype(np.float32, copy=False)
    m = (data != 0) if mask is None else (mask.astype(bool) & (data == data))
    if not np.any(m):
        return np.zeros_like(data, dtype=np.float32)
    vals = data[m]
    lo = np.percentile(vals, pmin)
    hi = np.percentile(vals, pmax)
    if not np.isfinite(lo) or not np.isfinite(hi) or hi <= lo:
        lo, hi = float(vals.min()), float(vals.max())
        if hi <= lo:
            return np.zeros_like(data, dtype=np.float32)
    x01 = np.clip((data - lo) / (hi - lo), 0.0, 1.0)
    return x01 * 2.0 - 1.0


def _slice_bounds(depth: int, half_range: int) -> Tuple[int, int]:
    c = depth // 2
    return max(0, c - half_range), min(depth - 1, c + half_range)


def _bilinear_resize(img: np.ndarray, size) -> np.ndarray:
    """The reference's own resize (engine/test_volume.py:275):
    ``F.interpolate(mode='bilinear', align_corners=False)``, which never
    low-pass-filters on downsampling.  ``size`` is an int or (H, W)."""
    size = (size, size) if isinstance(size, int) else tuple(size)
    if img.shape == size:
        return img.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))[None, None]
    out = F.interpolate(t, size=size, mode="bilinear", align_corners=False, antialias=False)
    return out[0, 0].numpy()


def reconstruct_volume_from_slices(
    predicted: List[np.ndarray], ref_shape, s0: int, s1: int
) -> np.ndarray:
    """Zero-padded reassembly (reference test_volume.py:170-181)."""
    vol = np.zeros(ref_shape, dtype=np.float32)
    for i, sl in enumerate(predicted):
        z = s0 + i
        if z > s1:
            break
        if sl.shape != tuple(ref_shape[:2]):
            sl = _bilinear_resize(sl, ref_shape[:2])
        vol[:, :, z] = sl
    return vol


def predict_volume(
    config: MuDiffConfig,
    inputs: Dict[str, str],
    output_dir: str,
    ckpt_dir: Optional[str] = None,
    slice_half_range: int = 80,
    batch_size: int = 8,
    seed: int = 42,
    generators=None,
    *,
    device=None,
    attn: str = "bf16",
    draws: Optional[Iterable[Draw]] = None,
) -> str:
    """Synthesize the target modality volume from 3 input NIfTIs.

    ``inputs`` maps modality name -> NIfTI path for the three condition
    modalities of config.target_modality (VOLUME_ORDERS).  ``generators``
    may supply loaded ``(g1, g2)``; otherwise they are loaded from
    ``ckpt_dir`` (default ``output_path/exp/target_modality``) with
    attention lowering ``attn``.  Runs on ``device`` (default
    ``"cuda"``; raises without a card).  Returns the output NIfTI path.
    """
    order = VOLUME_ORDERS[config.target_modality]
    for m in order:
        if m not in inputs:
            raise ValueError(f"Missing required input for {m}")
    device = serving_device(device, "predict_volume")
    # the generators first: a missing checkpoint or an unported mode
    # raises before the volumes are read
    if generators is None:
        generators = load_generators(
            config,
            ckpt_dir or os.path.join(config.output_path, config.exp,
                                     config.target_modality),
            device=device, attn=attn,
        )
    g1, g2 = generators

    ref_shape = None
    ref_affine = None
    ref_header = None
    slices_by_mod: Dict[str, List[np.ndarray]] = {}
    s0 = s1 = 0
    for m in order:
        img = nifti.load(inputs[m])
        vol = robust_minmax_to_minus1_1(img.get_fdata())
        s0, s1 = _slice_bounds(vol.shape[2], slice_half_range)
        slices_by_mod[m] = [vol[:, :, z] for z in range(s0, s1 + 1)]
        if ref_shape is None:
            ref_shape, ref_affine, ref_header = (
                img.shape, img.affine, img.header_bytes
            )
        elif img.shape != ref_shape:
            raise ValueError(
                f"All input volumes must share shape. Got {img.shape} vs "
                f"{ref_shape} for {m}"
            )

    sampler = Sampler(config, g1, g2, device, compute_dtype_of(config))
    rng = torch.Generator(device).manual_seed(seed)
    draws = iter(draws) if draws is not None else None

    n = len(slices_by_mod[order[0]])
    size = config.image_size
    predicted: List[np.ndarray] = []
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        pad = batch_size - len(idx)
        conds = []
        for m in order:
            batch = np.stack([_bilinear_resize(slices_by_mod[m][i], size) for i in idx])
            if pad:
                batch = np.concatenate([batch, np.repeat(batch[-1:], pad, 0)], 0)
            conds.append(torch.from_numpy(batch[..., None]).to(device))
        if draws is None:
            fake = sampler(*conds, generator=rng)
        else:
            x_init, noise = next(draws)
            fake = sampler(*conds, x_init=x_init, noise=noise)
        fake = fake.cpu().numpy()
        if pad:
            fake = fake[:-pad]
        # map to [0, 1] (reference test_volume.py:287)
        fake01 = np.clip((fake + 1.0) / 2.0, 0.0, 1.0)[..., 0]
        predicted.extend(list(fake01))

    vol_pred = reconstruct_volume_from_slices(predicted, ref_shape, s0, s1)
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(
        output_dir, f"predicted_{config.target_modality.lower()}.nii.gz"
    )
    nifti.save(vol_pred, ref_affine, out_path, header=ref_header)
    return out_path
