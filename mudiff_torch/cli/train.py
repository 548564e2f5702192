"""``python -m mudiff_torch.cli.train --...``: training on the card (the
counterpart of ``mudiff_tpu/cli/train.py``; reference engine/train.py:
1313-1472).

    python -m mudiff_torch.cli.train --input_path NPY --output_path RESULTS \\
        --exp EXP --target_modality T1CE --attn flash [architecture flags]
    python -m mudiff_torch.cli.train ... --resume --num_epoch N
    torchrun --nproc_per_node=N -m mudiff_torch.cli.train ... [--dp D] [--fsdp F]

Without torchrun it trains on one device.  Under torchrun every process
joins the mesh of ``--dp`` x ``--fsdp`` ranks (``D * F = N``; ``--dp -1``
takes ``N / F``) on its own GPU, from torchrun's rendezvous environment
(``parallel.init_mesh``; the counterpart of the JAX CLI's
``jax.distributed.initialize``, with no single-process fallback).  What
it writes is listed in ``mudiff_torch/train/loop.py``.
"""

from mudiff_torch.cli.args import build_parser as _mode_parser
from mudiff_torch.cli.args import parse_config
from mudiff_torch.parallel import init_mesh
from mudiff_torch.train.loop import train


def build_parser():
    """The CLI's parser (``check_pipeline`` reads its flags)."""
    return _mode_parser("train")


def main(argv=None, device=None) -> dict:
    """Run the CLI; ``device`` (default the card) is for the tests only.
    Returns ``train``'s artifacts."""
    cfg, args = parse_config(argv, mode="train")
    mesh = init_mesh(cfg.dp, cfg.fsdp, device)
    try:
        return train(cfg, device=device, attn=args.attn, mesh=mesh)
    finally:
        if mesh is not None:
            mesh.close()


if __name__ == "__main__":
    main()
