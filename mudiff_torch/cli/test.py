"""``python -m mudiff_torch.cli.test --...``: the slice-level test on the
card (the counterpart of ``mudiff_tpu/cli/test.py``; reference
engine/test.py:400-492).

    python -m mudiff_torch.cli.test --input_path NPY --output_path RESULTS \\
        --exp EXP --target_modality T1CE [--ckpt_dir CKPT] [--test_batch_size 8] \\
        [--bf16] [--attn flash] [architecture flags]
    torchrun --nproc_per_node=N -m mudiff_torch.cli.test ...

Samples the test split with the generators of ``CKPT`` (default the
experiment's directory; W8A8 int8 unless ``--bf16``), writes the
``pred/`` and ``gt/`` PNG pairs and prints their PSNR / SSIM / MAE as JSON.

Under torchrun every process joins the mesh of all ranks on the data
axis (``parallel.init_mesh(dp=-1, fsdp=1)``, the JAX CLI's
``make_mesh(dp=-1, fsdp=1)``) on its own GPU and samples its rows of
each batch (``sample_and_test``); the lead rank alone writes the PNGs
and prints the metrics.  Without torchrun it runs on one device.
"""

import json
import time

from mudiff_torch.cli.args import build_parser as _mode_parser
from mudiff_torch.cli.args import parse_config
from mudiff_torch.infer.slice_test import sample_and_test
from mudiff_torch.metrics import evaluate_pair_dirs
from mudiff_torch.parallel import init_mesh


def build_parser():
    """The CLI's parser (``check_pipeline`` reads its flags)."""
    return _mode_parser("test")


def main(argv=None, device=None) -> dict:
    """Run the CLI; ``device`` (default the card) is for the tests only.
    Returns the printed summary, and beside it the codes written
    (``pred_u8``, ``gt_u8``) and the host ``seconds`` of each part; None
    on a rank other than the lead."""
    cfg, args = parse_config(argv, mode="test")
    mesh = init_mesh(-1, 1, device)
    try:
        out = sample_and_test(cfg, ckpt_dir=args.ckpt_dir, batch_size=args.test_batch_size,
                              seed=cfg.seed, device=device, attn=args.attn, mesh=mesh)
    finally:
        if mesh is not None:
            mesh.close()
    if mesh is not None and not mesh.lead:
        return None
    t0 = time.perf_counter()
    metrics = evaluate_pair_dirs(out["pred_dir"], out["gt_dir"])
    seconds = {**out["seconds"], "metrics_s": time.perf_counter() - t0}
    summary = {**{k: out[k] for k in ("pred_dir", "gt_dir")}, "n_slices": out["n_slices"],
               **metrics}
    print(json.dumps(summary, indent=2))
    return {**summary, "pred_u8": out["pred_u8"], "gt_u8": out["gt_u8"], "seconds": seconds}


if __name__ == "__main__":
    main()
