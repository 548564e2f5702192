"""``python -m mudiff_torch.cli.run``: the YAML-driven experiment runner
(the counterpart of ``mudiff_tpu/cli/run.py:75-141``; reference
experiments/run.py).

    python -m mudiff_torch.cli.run -c experiments/brats.yaml -e synthesize_T1CE \\
        [--train-only | --test-only] [--attn flash]
    torchrun --nproc_per_node=N -m mudiff_torch.cli.run -c ... -e ...

The YAML has top-level ``data_path`` / ``output_root`` and a list of
``experiments`` ({exp_name, target, train_args, test_args}); it is read
by ``utils/yaml_lite.py`` (the card's machine has no PyYAML), and each
args block becomes a config with the runner's defaults
(``config._config_from_yaml``).  In ``<output_root>/<exp_name>/<target>``
the runner writes ``session_metadata.json`` (the torch and CUDA versions
and the device names where the JAX package records ``jax_version`` and
``devices``), trains (``train/loop.py``), then samples the test split
(``sample_and_test``: ``pred/`` and ``gt/`` PNGs under
``generated_samples/``) and writes ``test_metrics.json``, all in one
process.  ``--attn`` is the attention lowering (else ``einsum`` for
training and ``bf16`` for the test), in place of ``MUDIFF_ATTN``.

Under torchrun every process joins the mesh of the experiment's
``train_args`` ``dp`` x ``fsdp`` (``parallel.init_mesh``; with
``--test-only`` the mesh of all ranks on the data axis) and trains on
it.  The test then runs on every rank over the same process group, all
ranks on the data axis (``parallel.data_mesh``), each sampling its rows
of every batch, after a barrier that waits for the lead's checkpoints;
the lead rank alone writes ``session_metadata.json``, the PNGs and
``test_metrics.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import time
from typing import Any, Dict, Optional

import torch

from mudiff_torch.config import _config_from_yaml, load_experiment
from mudiff_torch.parallel import data_mesh, init_mesh


def _session_metadata(device: torch.device) -> Dict[str, Any]:
    meta: Dict[str, Any] = {
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "platform": platform.platform(),
        "python": platform.python_version(),
    }
    try:
        meta["git_commit"] = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=5,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    meta["torch_version"] = torch.__version__
    meta["cuda_version"] = torch.version.cuda
    if device.type == "cuda":
        meta["devices"] = [torch.cuda.get_device_name(i)
                           for i in range(torch.cuda.device_count())]
    else:
        meta["devices"] = [str(device)]
    return meta


def run_experiment(cfg_path: str, exp_name: str, train_only: bool = False,
                   test_only: bool = False, verbose: bool = True, *, device=None,
                   attn: Optional[str] = None) -> Dict[str, Any]:
    """Train and / or test one experiment of the YAML at ``cfg_path`` on
    ``device`` (default the card; under torchrun each rank's, on the
    mesh of the experiment's ``dp`` / ``fsdp``, and all ranks on the data
    axis for the test).  Returns ``exp_dir``, and ``train`` (``train``'s
    artifacts) and ``test`` (``sample_and_test``'s result with its
    ``metrics``, on the lead rank) for the phases that ran."""
    from mudiff_torch.sampler import serving_device

    device = serving_device(device, "run_experiment")
    doc, exp = load_experiment(cfg_path, exp_name)
    data_path = doc.get("data_path", "/data/BRATS")
    output_root = doc.get("output_root", "./results")
    target = exp.get("target", "T1CE")
    train_cfg = _config_from_yaml(exp.get("train_args"), data_path, output_root, exp_name,
                                  target)
    mesh = (init_mesh(-1, 1, device) if test_only
            else init_mesh(train_cfg.dp, train_cfg.fsdp, device))
    device = mesh.device if mesh is not None else device
    lead = mesh is None or mesh.lead
    out_dir = os.path.join(output_root, exp_name, target)
    results: Dict[str, Any] = {"exp_dir": out_dir}
    try:
        if lead:
            os.makedirs(out_dir, exist_ok=True)
            meta = _session_metadata(device)
            meta.update({"experiment": exp_name, "target": target,
                         "config_file": os.path.abspath(cfg_path)})
            with open(os.path.join(out_dir, "session_metadata.json"), "w") as f:
                json.dump(meta, f, indent=2)
        if not test_only:
            from mudiff_torch.train.loop import train

            results["train"] = train(train_cfg, verbose=verbose, device=device,
                                     attn=attn or "einsum", mesh=mesh)
        if not train_only:
            from mudiff_torch.infer import sample_and_test
            from mudiff_torch.metrics import evaluate_pair_dirs

            if mesh is not None:
                mesh.barrier()  # the lead's checkpoints are on disk
            test_cfg = _config_from_yaml(exp.get("test_args"), data_path, output_root,
                                         exp_name, target)
            out = sample_and_test(test_cfg, ckpt_dir=out_dir, device=device,
                                  attn=attn or "bf16", mesh=data_mesh(mesh))
            if lead:
                metrics = evaluate_pair_dirs(out["pred_dir"], out["gt_dir"])
                results["test"] = {**out, "metrics": metrics}
                with open(os.path.join(out_dir, "test_metrics.json"), "w") as f:
                    json.dump(metrics, f, indent=2)
                if verbose:
                    print(json.dumps(metrics, indent=2))
    finally:
        if mesh is not None:
            mesh.close()
    return results


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("mudiff_torch experiment runner")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-e", "--experiment", required=True)
    ap.add_argument("--train-only", action="store_true")
    ap.add_argument("--test-only", action="store_true")
    ap.add_argument("--attn", choices=("bf16", "einsum", "flash"), default=None)
    return ap


def main(argv=None, device=None) -> Dict[str, Any]:
    """Run the CLI; ``device`` (default the card) is for the tests only."""
    args = build_parser().parse_args(argv)
    return run_experiment(args.config, args.experiment, train_only=args.train_only,
                          test_only=args.test_only, device=device, attn=args.attn)


if __name__ == "__main__":
    main()
