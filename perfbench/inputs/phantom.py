"""Brain-like multi-contrast phantom slices, made on the device from a seed.

The formulas of the repo's phantom generator (``tools/make_phantom_dataset.py``,
copied into ``mudiff_torch/data/phantom.py``), vectorised over patients
and drawn with a torch generator, so a pool of hundreds of slices costs
milliseconds of set-up: per patient a skull ellipse, a smooth tissue
field, ventricles and a lesion shared by four contrasts, each with its
own response, bias field and noise; then the preprocessing the
datasets apply (a per-patient z-score over the nonzero voxels, then
clip to 3 sigma and divide by 3, giving [-1, 1]).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

MODS = ("T1", "T1CE", "T2", "FLAIR")
# conditions then target, for each target contrast (the BraTS orders)
ORDERS = {"T1CE": ("FLAIR", "T2", "T1", "T1CE"), "FLAIR": ("T1CE", "T1", "T2", "FLAIR"),
          "T2": ("T1CE", "T1", "FLAIR", "T2"), "T1": ("FLAIR", "T1CE", "T2", "T1")}


def _smooth(gen, lead, shape, scale, device):
    """Coarse normal noise upsampled linearly (corners aligned) to ``shape``."""
    coarse = [max(2, s // scale) for s in shape]
    c = torch.randn((lead, 1, *coarse), generator=gen, device=device)
    mode = "trilinear" if len(shape) == 3 else "bilinear"
    return F.interpolate(c, size=tuple(shape), mode=mode, align_corners=True)[:, 0]


def phantom_slices(seed: int, patients: int, slices: int, size: int,
                   device) -> Dict[str, torch.Tensor]:
    """{contrast: (patients * slices, size, size, 1) float32 in [-1, 1]}."""
    gen = torch.Generator(device).manual_seed(int(seed) % (2 ** 63))
    P, S = patients, slices

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def n(*shape):
        return torch.randn(shape, generator=gen, device=device)

    col = (P, 1, 1, 1)
    cy = (size / 2 + n(P) * size * 0.02).reshape(col)
    cx = (size / 2 + n(P) * size * 0.02).reshape(col)
    ry = (size * (0.38 + 0.04 * u(P))).reshape(col)
    rx = (size * (0.30 + 0.04 * u(P))).reshape(col)
    tissue3 = _smooth(gen, P, (S, size, size), 32, device)
    detail3 = _smooth(gen, P, (S, size, size), 8, device)
    lcy = cy + n(P).reshape(col) * size * 0.12
    lcx = cx + n(P).reshape(col) * size * 0.12
    lr = (size * (0.03 + 0.05 * u(P))).reshape(col)
    vent_w = (size * (0.05 + 0.02 * u(P))).reshape(col)

    yy, xx = torch.meshgrid(torch.arange(size, device=device, dtype=torch.float32),
                            torch.arange(size, device=device, dtype=torch.float32),
                            indexing="ij")
    z = torch.arange(S, device=device, dtype=torch.float32)
    zfac = (1.0 - 0.3 * (z - S / 2).abs() / max(1, S / 2)).reshape(1, S, 1, 1)
    brain = (((yy - cy) / (ry * zfac)) ** 2 + ((xx - cx) / (rx * zfac)) ** 2) < 1.0
    tissue = 0.5 + 0.25 * torch.tanh(tissue3) + 0.08 * detail3
    vent = ((xx - cx).abs() < vent_w) & ((yy - cy).abs() < size * 0.12 * zfac)
    lesion = torch.exp(-(((yy - lcy) ** 2 + (xx - lcx) ** 2) / (2 * (lr * zfac) ** 2)))

    t1 = torch.where(vent, (0.9 - 0.5 * tissue) * 0.35, 0.9 - 0.5 * tissue)
    raw = {"T1": t1, "T1CE": t1 + 0.9 * lesion,
           "T2": torch.where(vent, torch.full_like(tissue, 0.95), 0.25 + 0.6 * tissue)
           + 0.35 * lesion,
           "FLAIR": torch.where(vent, (0.3 + 0.55 * tissue) * 0.25, 0.3 + 0.55 * tissue)
           + 0.8 * lesion}
    out = {}
    for m in MODS:
        bias = 1.0 + 0.15 * torch.tanh(_smooth(gen, P * S, (size, size), 64, device))
        noisy = raw[m].clamp_min(0) * bias.reshape(P, S, size, size) + 0.015 * n(P, S, size, size)
        img = torch.where(brain, noisy.clamp_min(0.01), torch.zeros_like(noisy))
        nz = (img != 0).to(torch.float32)
        cnt = nz.sum(dim=(1, 2, 3), keepdim=True).clamp_min(1.0)
        mean = (img * nz).sum(dim=(1, 2, 3), keepdim=True) / cnt
        std = torch.sqrt((((img - mean) * nz) ** 2).sum(dim=(1, 2, 3), keepdim=True) / cnt)
        std = torch.where(std > 0, std, torch.ones_like(std))
        zs = (img - mean) / std
        out[m] = (zs.clamp(-3.0, 3.0) / 3.0).reshape(P * S, size, size, 1).contiguous()
    return out


def condition_pool(seed: int, patients: int, slices: int, size: int, target: str,
                   device) -> torch.Tensor:
    """(4, N, size, size, 1): the three conditions and the target of
    ``target``'s order, N = patients * slices."""
    imgs = phantom_slices(seed, patients, slices, size, device)
    return torch.stack([imgs[m] for m in ORDERS[target]])
