"""``python -m mudiff_torch.demo``: synthesize one missing MRI contrast
from three observed ones (the counterpart of ``demo/demo.py``; reference
demo/demo.ipynb).

    python -m mudiff_torch.demo --synthetic [--out demo_output.png]
    python -m mudiff_torch.demo --sample_dir DIR [--ckpt_dir CKPT] [--target_modality T1CE]

Each condition image goes through the notebook's robust 1-99 percentile
min-max and (x - 0.5) / 0.5 to [-1, 1] (``irm_minmax``), then the 4-step
mutual sampler runs on the card (bf16), with random-initialised
generators (a structure demo) or those of ``--ckpt_dir``
(``gen_diffusive_{1,2}.pt``).  The three conditions and the synthesized
contrast are written side by side as an 8-bit grayscale PNG by the
port's own codec (``utils/png.py``; the card's machine has no PIL).

Differences from the JAX demo, both for want of PIL: ``--sample_dir``
takes 8-bit grayscale PNGs (``flair.png``, ``t2.png``, ...), not JPEGs,
and resizes them to ``--image_size`` bilinearly (the volume path's
resize) where PIL's default filter is bicubic.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

_CONDITIONS = {
    "T1CE": ("flair", "t2", "t1"),
    "FLAIR": ("t1ce", "t1", "t2"),
    "T2": ("t1ce", "t1", "flair"),
    "T1": ("flair", "t1ce", "t2"),
}


def irm_minmax(img: np.ndarray) -> np.ndarray:
    """Percentile min-max to [0, 1], then centred to [-1, 1]
    (reference demo.ipynb cell 4)."""
    img = img.astype(np.float32)
    nz = img[img != 0]
    if nz.size == 0:
        return np.zeros_like(img)
    lo, hi = np.percentile(nz, 1.0), np.percentile(nz, 99.0)
    if hi <= lo:
        lo, hi = float(img.min()), float(img.max() or 1.0)
    x = np.clip((img - lo) / (hi - lo), 0.0, 1.0)
    return (x - 0.5) / 0.5


def synthetic_conditions(size: int):
    """Three concentric phantoms, one per "contrast" (the JAX demo's)."""
    yy, xx = np.mgrid[0:size, 0:size]
    r = np.sqrt((yy - size / 2) ** 2 + (xx - size / 2) ** 2) / (size / 2)
    return [irm_minmax(np.clip(1 - r, 0, 1) * (i + 1) * 50.0) for i in range(3)]


def load_conditions(sample_dir: str, target: str, size: int):
    from mudiff_torch.infer.volume import _bilinear_resize
    from mudiff_torch.utils.png import read_gray8

    conds = []
    for name in _CONDITIONS[target.upper()]:
        path = os.path.join(sample_dir, name + ".png")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{name}.png in {sample_dir} (8-bit grayscale PNG)")
        img = read_gray8(path).astype(np.float32)
        conds.append(irm_minmax(_bilinear_resize(img, size)))
    return conds


def output_path(out: str) -> str:
    """``--out`` as a file: a directory gets ``demo_output.png``, a name
    without an extension gets ``.png``."""
    if out.endswith(os.sep) or os.path.isdir(out):
        return os.path.join(out, "demo_output.png")
    if not os.path.splitext(out)[1]:
        return out + ".png"
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("mudiff_torch demo")
    ap.add_argument("--sample_dir", default=None,
                    help="dir with flair/t2/t1[/t1ce] 8-bit grayscale .png images")
    ap.add_argument("--synthetic", action="store_true", help="use synthetic phantom inputs")
    ap.add_argument("--ckpt_dir", default=None,
                    help="trained checkpoint dir (gen_diffusive_1.pt, gen_diffusive_2.pt)")
    ap.add_argument("--target_modality", default="T1CE")
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--num_channels_dae", type=int, default=64)
    ap.add_argument("--attn", choices=("bf16", "einsum", "flash"), default="bf16")
    ap.add_argument("--out", default="demo_output.png")
    return ap


def main(argv=None, device=None) -> str:
    """Run the demo; ``device`` (default the card) is for the tests only.
    Returns the PNG's path."""
    from mudiff_torch import brats_recipe, build_sampler
    from mudiff_torch.infer.generators import load_generators
    from mudiff_torch.sampler import Sampler, serving_device
    from mudiff_torch.utils.png import write_gray8

    args = build_parser().parse_args(argv)
    device = serving_device(device, "demo")
    cfg = brats_recipe(image_size=args.image_size, num_channels_dae=args.num_channels_dae,
                       target_modality=args.target_modality.upper())
    s = cfg.image_size
    if args.synthetic or not args.sample_dir:
        conds = synthetic_conditions(s)
        print("[demo] using synthetic phantom inputs")
    else:
        conds = load_conditions(args.sample_dir, args.target_modality, s)

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.ckpt_dir:
        g1, g2 = load_generators(cfg, args.ckpt_dir, device=device, attn=args.attn,
                                 compute_dtype=dtype)
        sampler = Sampler(cfg, g1, g2, device, dtype)
        print(f"[demo] loaded weights from {args.ckpt_dir}")
    else:
        sampler = build_sampler(cfg, device=device, attn=args.attn, compute_dtype=dtype,
                                generator=torch.Generator().manual_seed(0))
        print("[demo] random-initialized generators (structure demo)")

    c = [torch.from_numpy(np.ascontiguousarray(ci[None, ..., None])).to(device) for ci in conds]
    gen = torch.Generator(device).manual_seed(2)
    fake = sampler(*c, generator=gen).cpu().numpy()
    panel = np.concatenate([np.clip((ci + 1) / 2, 0, 1) for ci in conds]
                           + [np.clip((fake[0, ..., 0] + 1) / 2, 0, 1)], axis=1)
    out = output_path(args.out)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    write_gray8(out, (panel * 255).astype(np.uint8))
    print(f"[demo] wrote {out} (3 conditions | synthesized {args.target_modality})")
    return out


if __name__ == "__main__":
    main()
