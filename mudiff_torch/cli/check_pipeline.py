"""``python -m mudiff_torch.cli.check_pipeline``: static pre-flight checks
of an experiment setup on the card's machine (the counterpart of
``mudiff_tpu/cli/check_pipeline.py``; reference check_pipeline.py:24-271).

    python -m mudiff_torch.cli.check_pipeline -c experiments/brats.yaml [--require-data]

The same YAML, key and flag-surface checks as the JAX package, with the
card's facts in place of the TPU's:

* the card's dependencies import: torch, numpy, scipy (the port needs no
  yaml, PIL or matplotlib; ``utils/yaml_lite.py`` reads the YAML);
* a CUDA device is visible, and ``nvcc`` is found for the kernels'
  first-use build (``ops/_build.py``);
* the YAML: experiments present, names unique, ``train_args`` complete,
  ``test_args`` present (whether ``dp`` x ``fsdp`` fits the world is
  checked at run time, by ``parallel.init_mesh``);
* LPIPS: ``metrics/lpips.py``'s weight loaders and ``metric_calc``'s
  flags for them are in place;
* the flag surface: every ``python -m mudiff_torch...`` command of the
  README's port quick start resolves, and each flag it passes is one its
  parser declares;
* the data splits under ``data_path`` (required with ``--require-data``).
"""

from __future__ import annotations

import argparse
import importlib
import os
import re
import sys
from typing import Any, Dict, List, Optional

REQUIRED_TRAIN_KEYS = (
    "image_size", "num_channels", "num_channels_dae", "ch_mult",
    "num_res_blocks", "num_timesteps", "batch_size", "num_epoch",
    "lr_g", "lr_d", "target_modality",
)
CARD_DEPS = ("torch", "numpy", "scipy")
README_SECTION = "### Quick start of the port"


def check_experiments(doc: Any, ok) -> List[str]:
    """The YAML's structure (``mudiff_tpu/cli/check_pipeline.py:61-81``,
    the same messages)."""
    errors: List[str] = []
    exps = (doc.get("experiments") if isinstance(doc, dict) else None) or []
    if not exps:
        errors.append("no experiments in config")
    names = [e.get("exp_name") for e in exps]
    if len(set(names)) != len(names):
        errors.append(f"duplicate experiment names: {names}")
    for e in exps:
        name = e.get("exp_name", "<unnamed>")
        ta = e.get("train_args") or {}
        # the runner injects target_modality from the experiment's target
        missing = [k for k in REQUIRED_TRAIN_KEYS
                   if k not in ta and not (k == "target_modality" and e.get("target"))]
        if missing:
            errors.append(f"{name}: train_args missing {missing}")
        else:
            ok(f"experiment {name}: train_args complete")
        if "test_args" not in e:
            errors.append(f"{name}: no test_args")
    return errors


def check_device(ok, device=None) -> List[str]:
    """A CUDA device and nvcc; on ``device="cpu"`` (the tests) neither."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        ok("device cpu: the kernels' plain PyTorch versions, no build")
        return []
    errors: List[str] = []
    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        ok(f"{torch.cuda.device_count()} CUDA device(s) visible: "
           f"{torch.cuda.get_device_name(0)}")
    else:
        errors.append("no CUDA device visible (torch.cuda.is_available() is false)")
    from mudiff_torch.ops import _build

    try:
        ok(f"nvcc found: {_build.nvcc_path()}")
    except RuntimeError as e:
        errors.append(f"{e} (the kernels are built at first use)")
    return errors


def check_lpips(ok) -> List[str]:
    """LPIPS stays wired: the weight loaders and metric_calc's flags."""
    errors: List[str] = []
    try:
        from mudiff_torch.cli import metric_calc
        from mudiff_torch.metrics import lpips

        for fn in ("load_torch_weights", "random_params"):
            if not callable(getattr(lpips, fn, None)):
                errors.append(f"metrics/lpips.py lost {fn}")
        flags = metric_calc.build_parser()._option_string_actions
        for flag in ("--lpips_alexnet", "--lpips_lin", "--lpips_rand"):
            if flag not in flags:
                errors.append(f"metric_calc no longer declares {flag}")
        if not errors:
            ok("LPIPS wired (metric_calc --lpips_alexnet/--lpips_lin/--lpips_rand)")
    except Exception as e:  # an import failure is the drift this watches for
        errors.append(f"LPIPS check failed: {e}")
    return errors


def runbook_commands(readme_path: str) -> Optional[List[tuple]]:
    """(module, flags) of every ``python -m mudiff_torch...`` command in
    the README's port quick start; None if the section is gone."""
    with open(readme_path) as f:
        txt = f.read()
    m = re.search(re.escape(README_SECTION) + r".*?```bash\n(.*?)```", txt, re.S)
    if not m:
        return None
    block = re.sub(r"\\\s*\n", " ", m.group(1))
    cmds = []
    for line in block.splitlines():
        line = line.split("#")[0].strip()
        mm = re.search(r"python -m (mudiff_torch[\w.]*)(.*)", line)
        if mm:
            cmds.append((mm.group(1), re.findall(r"(?<!\S)(--?[\w-]+)", mm.group(2))))
    return cmds


def check_runbook(ok, readme_path: Optional[str] = None) -> List[str]:
    """Every quick-start command resolves and passes only declared flags
    (each port CLI's ``build_parser()``; no subprocess, no card)."""
    if readme_path is None:
        readme_path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "README.md")
    if not os.path.isfile(readme_path):
        return [f"README.md not found at {readme_path}"]
    cmds = runbook_commands(readme_path)
    if cmds is None:
        return [f"README.md lost the {README_SECTION!r} section"]
    if not cmds:
        return ["the port's quick start holds no python -m mudiff_torch command"]
    errors: List[str] = []
    for module, flags in cmds:
        try:
            mod = importlib.import_module(module)
        except ImportError as e:
            errors.append(f"runbook module {module} does not resolve: {e}")
            continue
        if not hasattr(mod, "build_parser"):
            errors.append(f"runbook module {module} has no build_parser()")
            continue
        declared = mod.build_parser()._option_string_actions
        missing = [fl for fl in flags if fl not in declared]
        if missing:
            errors.append(f"runbook drift: {module} no longer declares {missing}")
        else:
            ok(f"runbook command valid: python -m {module} ({len(flags)} flags)")
    return errors


def check(cfg_path: str, data_required: bool = False, device=None) -> List[str]:
    """Every check; returns the errors (printing an ``[OK]`` line per pass)."""
    errors: List[str] = []
    ok = lambda msg: print(f"  [OK] {msg}")  # noqa: E731

    for dep in CARD_DEPS:
        try:
            importlib.import_module(dep)
            ok(f"import {dep}")
        except ImportError as e:
            errors.append(f"missing dependency {dep}: {e}")
    errors += check_device(ok, device)

    if not os.path.isfile(cfg_path):
        errors.append(f"config file not found: {cfg_path}")
        return errors
    from mudiff_torch.utils import yaml_lite

    try:
        doc: Dict[str, Any] = yaml_lite.load(cfg_path)
    except yaml_lite.YamlError as e:
        errors.append(f"{cfg_path}: {e}")
        return errors
    errors += check_experiments(doc, ok)
    errors += check_lpips(ok)
    errors += check_runbook(ok)

    data_path = doc.get("data_path") if isinstance(doc, dict) else None
    if data_path and os.path.isdir(data_path):
        for split in ("train", "val", "test"):
            d = os.path.join(data_path, split)
            if os.path.isdir(d):
                ok(f"data split present: {d}")
            else:
                errors.append(f"missing data split dir: {d}")
    elif data_required:
        errors.append(f"data_path not found: {data_path}")
    else:
        print(f"  [SKIP] data_path not present locally: {data_path}")
    return errors


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("mudiff_torch pipeline pre-flight check")
    ap.add_argument("-c", "--config", default="experiments/brats.yaml")
    ap.add_argument("--require-data", action="store_true")
    return ap


def main(argv=None, device=None) -> None:
    """Run the checks; exits 1 on any failure.  ``device`` (default the
    card) is for the tests only."""
    args = build_parser().parse_args(argv)
    print(f"Checking {args.config} ...")
    errors = check(args.config, data_required=args.require_data, device=device)
    if errors:
        print("\nFAILURES:")
        for e in errors:
            print(f"  [FAIL] {e}")
        sys.exit(1)
    print("\nAll checks passed.")


if __name__ == "__main__":
    main()
