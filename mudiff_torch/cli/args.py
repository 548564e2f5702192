"""The argparse surface of the port's CLIs.

The port's own copy of ``mudiff_tpu/cli/args.py`` in its three modes,
``train``, ``test`` and ``test_volume`` (reference engine/train.py:
1318-1446, engine/test.py:401-485, engine/test_volume.py:302-359): every
flag name and default of each mode is kept, backed by the port's
``MuDiffConfig``.  ``--use_int8`` is on by default in the serving modes
(``test``, ``test_volume``), as in the JAX package: the generators serve
W8A8 (kernel K4) with the static calibration sidecars beside the
checkpoints when they exist, else with dynamic scales; ``--int8_static``
requires the sidecars, ``--int8_dynamic`` ignores them, and ``--bf16``
serves exactly in bf16.  Training parses ``--use_int8`` and ignores it.

One difference, deliberate: ``--attn`` (bf16 | einsum | flash) is
accepted in every mode, ``train`` included, in place of the
``MUDIFF_ATTN`` variable, which the port does not read (it has no
environment knobs, ROADMAP.md).  It resolves as the flag, else ``einsum``
for ``train`` (what JAX training uses) and ``bf16`` for the serving
modes.  Flags with no meaning here (the legacy DDP flags, whose place
torchrun's environment takes, and ``--gpu_chose``) are accepted and
ignored; ``--dp`` / ``--fsdp`` shape the mesh of a run launched by
torchrun (``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from mudiff_torch.config import MuDiffConfig, _as_int_list

MODES = ("train", "test", "test_volume")


def build_parser(mode: str = "test_volume") -> argparse.ArgumentParser:
    """The parser of ``mode`` (``train``, ``test`` or ``test_volume``)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    p = argparse.ArgumentParser(f"mudiff_torch {mode} parameters")
    d = MuDiffConfig()  # argparse defaults = dataclass defaults

    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--resume", action="store_true", default=False)

    # image / data
    p.add_argument("--image_size", type=int, default=d.image_size)
    p.add_argument("--num_channels", type=int, default=3)
    p.add_argument("--centered", action="store_false", default=True)
    p.add_argument("--use_geometric", action="store_true", default=False)
    p.add_argument("--beta_min", type=float, default=d.beta_min)
    p.add_argument("--beta_max", type=float, default=d.beta_max)

    # architecture
    p.add_argument("--num_channels_dae", type=int, default=d.num_channels_dae)
    p.add_argument("--n_mlp", type=int, default=d.n_mlp)
    p.add_argument("--ch_mult", nargs="+", type=int, default=None)
    p.add_argument("--num_res_blocks", type=int, default=d.num_res_blocks)
    p.add_argument("--attn_resolutions", default=(16,))
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--resamp_with_conv", action="store_false", default=True)
    p.add_argument("--conditional", action="store_false", default=True)
    p.add_argument("--fir", action="store_false", default=True)
    p.add_argument("--fir_kernel", default=[1, 3, 3, 1])
    p.add_argument("--skip_rescale", action="store_false", default=True)
    p.add_argument("--resblock_type", default="biggan")
    p.add_argument(
        "--progressive", type=str, default="none",
        choices=["none", "output_skip", "residual"],
    )
    p.add_argument(
        "--progressive_input", type=str, default="residual",
        choices=["none", "input_skip", "residual"],
    )
    p.add_argument(
        "--progressive_combine", type=str, default="sum",
        choices=["sum", "cat"],
    )
    p.add_argument(
        "--embedding_type", type=str, default="positional",
        choices=["positional", "fourier"],
    )
    p.add_argument("--fourier_scale", type=float, default=16.0)
    p.add_argument("--not_use_tanh", action="store_true", default=False)

    # experiment / training
    p.add_argument("--exp", default="ixi_synth")
    p.add_argument("--input_path", default="/data/BRATS/")
    p.add_argument("--output_path", default="/results")
    p.add_argument("--dataset", default="brats", choices=["brats", "isles"])
    p.add_argument("--nz", type=int, default=d.nz)
    p.add_argument("--num_timesteps", type=int, default=d.num_timesteps)
    p.add_argument("--z_emb_dim", type=int, default=d.z_emb_dim)
    p.add_argument("--t_emb_dim", type=int, default=d.t_emb_dim)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_epoch", type=int, default=1200)
    p.add_argument("--ngf", type=int, default=d.ngf)
    p.add_argument("--lr_g", type=float, default=1.5e-4)
    p.add_argument("--lr_d", type=float, default=1e-4)
    p.add_argument("--beta1", type=float, default=d.beta1)
    p.add_argument("--beta2", type=float, default=d.beta2)
    p.add_argument("--no_lr_decay", action="store_true", default=False)
    p.add_argument("--use_ema", action="store_true", default=False)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--r1_gamma", type=float, default=0.05)
    p.add_argument("--lazy_reg", type=int, default=None)
    p.add_argument("--save_content", action="store_true", default=True)
    p.add_argument("--save_content_every", type=int, default=1)
    p.add_argument("--save_ckpt_every", type=int, default=10)
    p.add_argument("--lambda_l1_loss", type=float, default=0.5)
    p.add_argument("--lambda_mask_loss", type=float, default=0.1)
    p.add_argument("--lambda_adv", type=float, default=1.0)
    p.add_argument("--pretrained_dir", type=str, default=None)

    # legacy DDP flags — accepted, ignored (torchrun's environment)
    p.add_argument("--num_proc_node", type=int, default=1)
    p.add_argument("--num_process_per_node", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--master_address", type=str, default="127.0.0.1")
    p.add_argument("--port_num", type=str, default="6021")

    # the (data, fsdp) mesh of a torchrun launch (parallel/mesh.py)
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel axis size (-1 = all processes / fsdp)")
    p.add_argument("--fsdp", type=int, default=1,
                   help="parameter-sharding axis size")

    p.add_argument("--contrast1", type=str, default="T1")
    p.add_argument("--contrast2", type=str, default="T2")
    p.add_argument("--target_modality", type=str, default="T1CE")

    p.add_argument("--use_grad_checkpoint", action="store_true", default=False)
    p.add_argument("--grad_checkpoint_policy", type=str, default="blocks",
                   choices=["blocks", "hires", "hires4", "hires8"],
                   help="remat scope: every block, or only levels at "
                        "resolution >= image_size/N (less recompute)")
    # bf16 compute is the default; --no_bf16 forces fp32 compute.
    p.add_argument("--use_bf16", action="store_true", default=True)
    p.add_argument("--no_bf16", dest="use_bf16", action="store_false")
    # W8A8 int8 serving (kernel K4): default on for the serving CLIs, as
    # in the JAX package; --bf16 serves exactly in bf16.  Training parses
    # it and ignores it.
    p.add_argument("--use_int8", action="store_true",
                   default=(mode in ("test", "test_volume")))
    p.add_argument("--bf16", dest="use_int8", action="store_false",
                   help="exact bf16 serving (disable the int8 path)")
    # static activation scales from the int8_calib_g{1,2}.json sidecars
    # (required with --int8_static, used when present by default) or
    # dynamic per-example scales (--int8_dynamic)
    p.add_argument("--int8_static", dest="int8_static",
                   action="store_true", default=None)
    p.add_argument("--int8_dynamic", dest="int8_static",
                   action="store_false")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--log_mem_after_update", action="store_true", default=False)
    p.add_argument("--debug_verbose", action="store_true", default=False)

    # attention lowering: bf16 scores, the exact fp32 einsum, or flash
    # (kernel K3; in training with its backward).  The flag, else einsum
    # for train and bf16 for the serving modes (parse_config).
    p.add_argument("--attn", choices=("bf16", "einsum", "flash"), default=None)
    if mode in ("test", "test_volume"):
        p.add_argument("--ckpt_dir", type=str, default=None)
        p.add_argument("--test_batch_size", type=int, default=8)
        # reference test flags with no meaning here; accepted and ignored
        p.add_argument("--gpu_chose", type=int, default=0)
        p.add_argument("--compute_fid", action="store_true", default=False)
    if mode == "test_volume":
        p.add_argument("--input_t1", type=str, default=None)
        p.add_argument("--input_t2", type=str, default=None)
        p.add_argument("--input_t1ce", type=str, default=None)
        p.add_argument("--input_flair", type=str, default=None)
        p.add_argument("--output_dir", type=str, default="./volume_out")
        p.add_argument("--slice_half_range", type=int, default=80)
    return p


def parse_config(argv: Optional[Sequence[str]] = None, mode: str = "test_volume"):
    """Parse argv into (MuDiffConfig, argparse.Namespace)."""
    args = build_parser(mode).parse_args(argv)
    args.attn_resolutions = tuple(_as_int_list(args.attn_resolutions))
    args.fir_kernel = tuple(_as_int_list(args.fir_kernel))
    args.attn = args.attn or ("einsum" if mode == "train" else "bf16")
    cfg = MuDiffConfig.from_dict(vars(args))
    return cfg, args
