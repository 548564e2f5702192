"""``python -m mudiff_torch.cli.predict_volume_wrapper``: find the NIfTI
inputs in a patient directory by their names and predict the volume
(the counterpart of ``mudiff_tpu/cli/predict_volume_wrapper.py:22-104``;
reference tools/predict_volume_wrapper.py).

    python -m mudiff_torch.cli.predict_volume_wrapper \\
        --patient_dir /data/patient001 --target_modality T1CE \\
        --config experiments/brats.yaml --experiment synthesize_T1CE \\
        --ckpt_dir results/synthesize_T1CE/T1CE --output_dir ./out [--attn flash]

The modality file patterns are the JAX package's (t1ce / t1c / t1gd...,
BraTS-2023's t1n / t2w / t2f); the architecture comes from the YAML's
``test_args`` (read by ``utils/yaml_lite.py``), else ``brats_recipe``.
The port's ``predict_volume`` runs in-process, on the card.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Dict

# modality -> filename patterns, checked in order (reference :125-138)
_PATTERNS = {
    "T1CE": [r"t1ce", r"t1c(?![a-z])", r"t1gd", r"t1n?[-_]?contrast"],
    "T1": [r"t1n(?![a-z])", r"t1(?![cg0-9])", r"t1w"],
    # note: t2f / t2flair are FLAIR acquisitions (BraTS-2023 naming),
    # never plain T2
    "T2": [r"t2w", r"t2(?![a-z0-9])"],
    "FLAIR": [r"flair", r"t2f(?![a-z])"],
    "DWI": [r"dwi", r"diff"],
}


def find_modality_files(patient_dir: str) -> Dict[str, str]:
    files = [
        f for f in sorted(os.listdir(patient_dir))
        if f.lower().endswith((".nii", ".nii.gz"))
    ]
    found: Dict[str, str] = {}
    for mod, patterns in _PATTERNS.items():
        for pat in patterns:
            for f in files:
                if re.search(pat, f.lower()):
                    found[mod] = os.path.join(patient_dir, f)
                    break
            if mod in found:
                break
    return found


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("mudiff_torch predict_volume_wrapper")
    ap.add_argument("--patient_dir", required=True)
    ap.add_argument("--target_modality", default="T1CE")
    ap.add_argument("--config", default=None, help="experiment YAML supplying test_args")
    ap.add_argument("--experiment", default=None)
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--output_dir", default="./volume_out")
    ap.add_argument("--slice_half_range", type=int, default=80)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--attn", choices=("bf16", "einsum", "flash"), default="bf16")
    return ap


def main(argv=None, device=None) -> str:
    """Run the CLI; ``device`` (default the card) is for the tests only.
    Returns the output NIfTI path."""
    from mudiff_torch.config import _config_from_yaml, brats_recipe, load_experiment
    from mudiff_torch.infer import predict_volume
    from mudiff_torch.infer.volume import VOLUME_ORDERS

    args = build_parser().parse_args(argv)
    if args.config and args.experiment:
        doc, exp = load_experiment(args.config, args.experiment)
        cfg = _config_from_yaml(exp.get("test_args"), doc.get("data_path", ""),
                                doc.get("output_root", "."), args.experiment,
                                args.target_modality)
    else:
        cfg = brats_recipe(target_modality=args.target_modality)
    cfg = cfg.replace(target_modality=args.target_modality)

    found = find_modality_files(args.patient_dir)
    needed = VOLUME_ORDERS[cfg.target_modality]
    missing = [m for m in needed if m not in found]
    if missing:
        raise FileNotFoundError(f"could not locate {missing} in {args.patient_dir}; "
                                f"found {found}")
    inputs = {m: found[m] for m in needed}
    print(f"[wrapper] inputs: {inputs}")
    out = predict_volume(cfg, inputs, args.output_dir, ckpt_dir=args.ckpt_dir,
                         slice_half_range=args.slice_half_range,
                         batch_size=args.batch_size, device=device, attn=args.attn)
    print(f"[done] saved: {out}")
    return out


if __name__ == "__main__":
    main()
