"""The port's ``test_volume`` CLI against the JAX package's, on the CPU.

Same option strings, defaults and ``--attn`` choices as
``mudiff_tpu.cli.args.build_parser("test_volume")``, with the port's one
documented difference: ``MUDIFF_ATTN`` is not read.  int8 serving is
the default and ``--bf16`` serves exactly (``test_torch_port_int8.py``
holds the int8 path).
"""

import numpy as np
import pytest
import torch

from mudiff_tpu.cli import args as jargs
from mudiff_torch.cli import args, test_volume
from mudiff_torch.infer import save_generators
from mudiff_torch.models import NCSNppGenerator
from mudiff_torch.utils import nifti

ARCH = ["--image_size", "16", "--num_channels", "1", "--num_channels_dae", "8",
        "--ch_mult", "1", "2", "--num_res_blocks", "1", "--attn_resolutions", "8",
        "--z_emb_dim", "16", "--nz", "8", "--n_mlp", "2"]


def _options(parser):
    return {s: a.dest for a in parser._actions for s in a.option_strings}


def test_parser_has_the_jax_option_strings_and_defaults():
    ours, ref = args.build_parser(), jargs.build_parser("test_volume")
    assert _options(ours) == _options(ref)
    assert vars(ours.parse_args([])) == vars(ref.parse_args([]))
    choices = {a.dest: a.choices for a in ours._actions}
    assert choices["attn"] == {a.dest: a.choices for a in ref._actions}["attn"]
    assert set(choices["attn"]) == {"bf16", "einsum", "flash"}


def test_attn_resolves_without_the_environment(monkeypatch):
    monkeypatch.setenv("MUDIFF_ATTN", "einsum")
    cfg, a = args.parse_config(["--bf16"])
    assert a.attn == "bf16" and not cfg.use_int8
    cfg, a = args.parse_config(["--attn", "flash", "--attn_resolutions", "16,8"])
    assert a.attn == "flash" and cfg.use_int8 and cfg.attn_resolutions == (16, 8)


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    inputs = []
    for m in ("flair", "t2", "t1"):
        path = str(d / f"{m}.nii.gz")
        nifti.save(np.abs(rng.randn(24, 24, 9)).astype(np.float32), np.eye(4), path)
        inputs += [f"--input_{m}", path]
    cfg = args.parse_config(ARCH + ["--bf16"])[0]
    gens = [NCSNppGenerator(cfg, adaptive=a, generator=torch.Generator().manual_seed(int(a)))
            for a in (False, True)]
    save_generators(str(d / "ckpt"), *gens)
    return d, inputs


def test_int8_serving_raises_until_ported(volumes):
    """int8 serving is ported: the CLI's default (no --bf16) serves it."""
    d, inputs = volumes
    out = test_volume.main(ARCH + inputs + [
        "--ckpt_dir", str(d / "ckpt"), "--output_dir", str(d / "int8"),
        "--slice_half_range", "1", "--test_batch_size", "2"], device="cpu")
    v = nifti.load(out).get_fdata()
    assert v.shape == (24, 24, 9) and np.isfinite(v).all() and v[:, :, 3:6].std() > 0


def test_missing_input_and_target_are_refused(volumes):
    d, inputs = volumes
    with pytest.raises(ValueError, match="Missing required input for T1. Provide --input_t1"):
        test_volume.main(ARCH + inputs[:4] + ["--bf16"], device="cpu")
    with pytest.raises(SystemExit, match="Unsupported target modality"):
        test_volume.main(ARCH + inputs + ["--bf16", "--target_modality", "PD"], device="cpu")


def test_main_writes_the_predicted_volume(volumes, capsys):
    d, inputs = volumes
    out = test_volume.main(ARCH + inputs + [
        "--bf16", "--attn", "flash", "--ckpt_dir", str(d / "ckpt"), "--output_dir",
        str(d / "out"), "--slice_half_range", "1", "--test_batch_size", "2"], device="cpu")
    assert "[done] saved:" in capsys.readouterr().out
    img = nifti.load(out)
    v = img.get_fdata()
    assert img.shape == (24, 24, 9) and np.isfinite(v).all()
    assert not v[:, :, :3].any() and not v[:, :, 6:].any()  # slices 3..5 predicted
    assert v[:, :, 3:6].std() > 0
