"""Image quality metrics: PSNR, SSIM, MAE, and ``evaluate_pair_dirs``.

The port's copy of ``mudiff_tpu/metrics/image_metrics.py`` (parity
source: tools/metric_calc.py:39-64, skimage's peak_signal_noise_ratio
and structural_similarity with data_range=1 on [0, 1] grayscale).  SSIM
follows skimage's default spec: 7x7 uniform filter (scipy's
``uniform_filter``, reflect padding), K1=0.01, K2=0.03, sample
covariance (N/(N-1)), cropped to the valid region.

``evaluate_pair_dirs`` reads the PNG pairs through the port's own codec
(``utils/png.py``).  LPIPS (``metrics/lpips.py``) is passed as
``lpips_fn``, and nothing reads an environment variable for one; its
values go under the scorer's ``key`` (``lpips`` or ``lpips_rand``,
``mudiff_tpu/metrics/image_metrics.py:93-99``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np

from mudiff_torch.utils.png import read_gray8


def mae(gt: np.ndarray, pred: np.ndarray) -> float:
    return float(np.mean(np.abs(gt.astype(np.float64) - pred.astype(np.float64))))


def psnr(gt: np.ndarray, pred: np.ndarray, data_range: float = 1.0) -> float:
    err = np.mean(
        (gt.astype(np.float64) - pred.astype(np.float64)) ** 2
    )
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range ** 2) / err))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Separable box filter with 'reflect' padding (scipy/skimage default)."""
    from scipy.ndimage import uniform_filter

    return uniform_filter(x, size=size, mode="reflect")


def ssim(
    gt: np.ndarray,
    pred: np.ndarray,
    data_range: float = 1.0,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """skimage.metrics.structural_similarity with default settings."""
    x = gt.astype(np.float64)
    y = pred.astype(np.float64)
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {x.shape} vs {y.shape}")

    NP = win_size ** x.ndim
    cov_norm = NP / (NP - 1)  # sample covariance

    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    R = data_range
    C1 = (k1 * R) ** 2
    C2 = (k2 * R) ** 2
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    crop = tuple(slice(pad, s - pad) for s in S.shape)
    return float(S[crop].mean())


def evaluate_pair_dirs(
    pred_dir: str,
    gt_dir: str,
    lpips_fn: Optional[Callable[[np.ndarray, np.ndarray], float]] = None,
) -> Dict[str, float]:
    """Offline eval of matching PNG file pairs in two directories
    (reference tools/metric_calc.py:39-64): per-pair PSNR/SSIM/MAE
    (+LPIPS when ``lpips_fn`` is given) on [0,1] grayscale, averaged."""
    preds = sorted(f for f in os.listdir(pred_dir) if f.endswith(".png"))
    gts = sorted(f for f in os.listdir(gt_dir) if f.endswith(".png"))
    assert len(preds) == len(gts) and preds, (
        f"mismatched dirs: {len(preds)} preds vs {len(gts)} gts"
    )
    lpips_key = getattr(lpips_fn, "key", "lpips")
    acc = {"psnr": [], "ssim": [], "mae": [], lpips_key: []}
    for pf, gf in zip(preds, gts):
        p = read_gray8(os.path.join(pred_dir, pf)).astype(np.float32) / 255.0
        g = read_gray8(os.path.join(gt_dir, gf)).astype(np.float32) / 255.0
        acc["psnr"].append(psnr(g, p))
        acc["ssim"].append(ssim(g, p))
        acc["mae"].append(mae(g, p))
        if lpips_fn is not None:
            acc[lpips_key].append(lpips_fn(g, p))
    out = {
        k: float(np.mean(v)) for k, v in acc.items() if v
    }
    out.update({
        f"{k}_std": float(np.std(v)) for k, v in acc.items() if v
    })
    return out
