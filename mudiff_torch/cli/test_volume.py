"""``python -m mudiff_torch.cli.test_volume --...``: whole-volume
prediction on the card (the counterpart of
``mudiff_tpu/cli/test_volume.py``; reference engine/test_volume.py:302-373).

    python -m mudiff_torch.cli.test_volume --attn flash \\
        --ckpt_dir CKPT --input_flair F.nii.gz --input_t2 T2.nii.gz \\
        --input_t1 T1.nii.gz --output_dir OUT [architecture flags]

``CKPT`` holds ``gen_diffusive_{1,2}.pt`` (``mudiff_torch.convert.
export_generators`` writes them from a JAX checkpoint).  The generators
serve W8A8 int8 by default, with the static scales of the sidecars
``CKPT/int8_calib_g{1,2}.json`` when both exist (``--int8_static``
requires them, ``--int8_dynamic`` ignores them); ``--bf16`` serves
exactly in bf16.
"""

from mudiff_torch.cli.args import build_parser as _mode_parser
from mudiff_torch.cli.args import parse_config
from mudiff_torch.infer.volume import VOLUME_ORDERS, predict_volume


def build_parser():
    """The CLI's parser (``check_pipeline`` reads its flags)."""
    return _mode_parser("test_volume")


def main(argv=None, device=None) -> str:
    """Run the CLI; ``device`` (default the card) is for the tests only.
    Returns the output NIfTI path."""
    cfg, args = parse_config(argv, mode="test_volume")
    provided = {
        "T1CE": args.input_t1ce,
        "T1": args.input_t1,
        "T2": args.input_t2,
        "FLAIR": args.input_flair,
    }
    if cfg.target_modality not in VOLUME_ORDERS:
        raise SystemExit(
            f"Unsupported target modality: {cfg.target_modality!r}; "
            f"choose from {sorted(VOLUME_ORDERS)}"
        )
    needed = VOLUME_ORDERS[cfg.target_modality]
    inputs = {}
    for m in needed:
        if not provided.get(m):
            raise ValueError(
                f"Missing required input for {m}. Provide --input_{m.lower()}"
            )
        inputs[m] = provided[m]
    out = predict_volume(
        cfg, inputs, args.output_dir, ckpt_dir=args.ckpt_dir,
        slice_half_range=args.slice_half_range,
        batch_size=args.test_batch_size, seed=cfg.seed,
        device=device, attn=args.attn,
    )
    print(f"[done] saved: {out}")
    return out


if __name__ == "__main__":
    main()
