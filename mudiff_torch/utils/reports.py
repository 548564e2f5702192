"""Training observability: image grids, history JSON, evolution plots.

Parity source: utils/train_utils.py — labeled real/fake collages (:22-73),
training_history.json appends (:75-85), loss/PSNR + time evolution plots
(:87-113), orchestrated per epoch by epoch_visual_report (:115-166).

The port's copy of ``mudiff_tpu/utils/reports.py``: the grids and
collages are written by the port's own PNG codec (``utils/png.py``), and
matplotlib is imported only inside ``plot_evolution``; a machine without
it skips the plot (``epoch_visual_report`` swallows the failure, as the
JAX package does) and still writes the history.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from mudiff_torch.utils.png import write_gray8


def save_image_grid(
    images: np.ndarray, path: str, ncol: int = 4, pad: int = 2
) -> None:
    """Tile (B, H, W, 1) or (B, H, W) images in [0, 1] into a PNG grid."""
    imgs = np.asarray(images)
    if imgs.ndim == 4:
        imgs = imgs[..., 0]
    b, h, w = imgs.shape
    ncol = min(ncol, b)
    nrow = -(-b // ncol)
    grid = np.ones(
        (nrow * h + (nrow + 1) * pad, ncol * w + (ncol + 1) * pad),
        np.float32,
    )
    for i in range(b):
        r, c = divmod(i, ncol)
        y = pad + r * (h + pad)
        x = pad + c * (w + pad)
        grid[y:y + h, x:x + w] = np.clip(imgs[i], 0.0, 1.0)
    write_gray8(path, (grid * 255).astype(np.uint8))


def append_history(history_path: str, record: Dict) -> None:
    """Append one epoch record to training_history.json
    (reference utils/train_utils.py:75-85)."""
    history = []
    if os.path.isfile(history_path):
        try:
            with open(history_path) as f:
                history = json.load(f)
        except (json.JSONDecodeError, OSError):
            history = []
    history.append(record)
    with open(history_path, "w") as f:
        json.dump(history, f, indent=2)


def plot_evolution(history_path: str, out_dir: str) -> None:
    """Loss / PSNR / epoch-time evolution plots
    (reference utils/train_utils.py:87-113)."""
    if not os.path.isfile(history_path):
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(history_path) as f:
        history = json.load(f)
    if not history:
        return
    epochs = [h["epoch"] for h in history]

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for key in ("G_total", "D_total"):
        vals = [h.get("losses", {}).get(key) for h in history]
        if any(v is not None for v in vals):
            axes[0].plot(epochs, vals, label=key)
    axes[0].set_title("losses")
    axes[0].set_xlabel("epoch")
    if axes[0].get_legend_handles_labels()[1]:
        # epoch-0 histories hold only the pre-training val row — no
        # loss curves yet, and a bare legend() warns on every epoch.
        axes[0].legend()

    axes[1].plot(epochs, [h.get("val_psnr") for h in history], label="val PSNR")
    ax1b = axes[1].twinx()
    ax1b.plot(
        epochs, [h.get("val_l1") for h in history], "r--", label="val L1"
    )
    axes[1].set_title("validation")
    axes[1].set_xlabel("epoch")

    axes[2].plot(epochs, [h.get("epoch_time") for h in history])
    axes[2].set_title("epoch wall time (s)")
    axes[2].set_xlabel("epoch")

    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "training_evolution.png"), dpi=100)
    plt.close(fig)


def save_collage(
    reals: np.ndarray, fakes: np.ndarray, path: str
) -> None:
    """Labeled real-vs-fake collage (reference utils/train_utils.py:22-73):
    top row reals, bottom row fakes."""
    r = np.asarray(reals)
    f = np.asarray(fakes)
    if r.ndim == 4:
        r = r[..., 0]
    if f.ndim == 4:
        f = f[..., 0]
    n = min(len(r), len(f), 8)
    h, w = r.shape[1:3]
    pad = 2
    grid = np.ones((2 * h + 3 * pad, n * w + (n + 1) * pad), np.float32)
    for i in range(n):
        x = pad + i * (w + pad)
        grid[pad:pad + h, x:x + w] = np.clip((r[i] + 1) / 2, 0, 1)
        grid[2 * pad + h:2 * pad + 2 * h, x:x + w] = np.clip(
            (f[i] + 1) / 2, 0, 1
        )
    write_gray8(path, (grid * 255).astype(np.uint8))


def epoch_visual_report(
    exp_dir: str,
    epoch: int,
    losses: Dict[str, float],
    val_l1: float,
    val_psnr: float,
    epoch_time: float,
    samples: Optional[np.ndarray] = None,
    reals: Optional[np.ndarray] = None,
    history_path: Optional[str] = None,
) -> None:
    """Per-epoch observability bundle (reference train_utils.py:115-166)."""
    history_path = history_path or os.path.join(
        exp_dir, "training_history.json"
    )
    append_history(
        history_path,
        {
            "epoch": epoch,
            "losses": {k: float(v) for k, v in losses.items()},
            "val_l1": float(val_l1) if np.isfinite(val_l1) else None,
            "val_psnr": float(val_psnr) if np.isfinite(val_psnr) else None,
            "epoch_time": float(epoch_time),
        },
    )
    try:
        plot_evolution(history_path, exp_dir)
    except Exception:
        pass
    if samples is not None and reals is not None:
        try:
            save_collage(
                reals, samples,
                os.path.join(exp_dir, f"collage_epoch_{epoch}.png"),
            )
        except Exception:
            pass
