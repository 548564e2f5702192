"""Load and save the serving generators G1 and G2.

The counterpart of ``mudiff_tpu/infer/slice_test.py:54-98``
(``load_generators``) with the checkpoint search of
``mudiff_tpu/train/checkpoint.py:198-212``: each of
``gen_diffusive_1.pt`` and ``gen_diffusive_2.pt`` is looked up under
``ckpt_dir``, then under ``fallback_dir``.  A file is a ``state_dict``
written by ``torch.save`` (``save_generators`` here, or
``convert.export_generators`` from a JAX checkpoint), loaded with
``weights_only=True`` and ``strict=True``.

Under ``config.use_int8`` (the serving CLI's default) the generators
serve W8A8 through kernel K4, with the static calibration sidecars
``int8_calib_g{1,2}.json`` under ``ckpt_dir`` when ``config.int8_static``
allows them (``mudiff_tpu/infer/slice_test.py:54-98``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from mudiff_torch.config import MuDiffConfig
from mudiff_torch.convert import GENERATOR_FILES
from mudiff_torch.infer.calibrate import calib_sidecar_paths, load_calib
from mudiff_torch.models.generator import NCSNppGenerator
from mudiff_torch.sampler import serving_device


def compute_dtype_of(config: MuDiffConfig) -> torch.dtype:
    """bf16 compute unless the config asks for fp32 (``--no_bf16``)."""
    return torch.bfloat16 if config.use_bf16 else torch.float32


def checkpoint_path(ckpt_dir: Optional[str], name: str,
                    fallback_dir: Optional[str] = None) -> str:
    for base in filter(None, [ckpt_dir, fallback_dir]):
        path = os.path.join(os.path.abspath(base), name)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no checkpoint {name} under {ckpt_dir} or {fallback_dir}")


def load_generators(config: MuDiffConfig, ckpt_dir: Optional[str],
                    fallback_dir: Optional[str] = None, *, device=None,
                    attn: str = "bf16", compute_dtype: Optional[torch.dtype] = None,
                    ) -> Tuple[NCSNppGenerator, NCSNppGenerator]:
    """G1 and G2 with their trained weights, in inference mode on
    ``device`` (default ``"cuda"``; raises without a card).  ``attn`` is
    the attention lowering; ``compute_dtype`` defaults to bf16, or fp32
    when ``config.use_bf16`` is off.

    int8 (``config.use_int8``): ``config.int8_static`` None serves the
    sidecars' static scales when both exist under ``ckpt_dir``, else
    dynamic scales; True requires the sidecars (``FileNotFoundError``);
    False serves dynamic scales whatever exists."""
    device = serving_device(device, "load_generators")
    dtype = compute_dtype or compute_dtype_of(config)
    calibs = (None, None)
    if config.use_int8 and config.int8_static is not False:
        paths = calib_sidecar_paths(ckpt_dir) if ckpt_dir else ("", "")
        if all(os.path.isfile(p) for p in paths):
            calibs = tuple(load_calib(p) for p in paths)
        elif config.int8_static:
            raise FileNotFoundError(
                f"int8_static requires the calibration sidecars {paths[0]} / {paths[1]} "
                "(mudiff_torch.infer.calibrate: calibrate_sampler, save_calib)")
    gens = []
    for adaptive, name, calib in zip((False, True), GENERATOR_FILES, calibs):
        path = checkpoint_path(ckpt_dir, name, fallback_dir)
        g = NCSNppGenerator(config, adaptive=adaptive, attn=attn, dtype=dtype,
                            int8_calib=calib)
        g.load_state_dict(torch.load(path, map_location="cpu", weights_only=True),
                          strict=True)
        g.requires_grad_(False)
        g.eval()
        gens.append(g.to(device))
    return gens[0], gens[1]


def save_generators(out_dir: str, g1: NCSNppGenerator,
                    g2: NCSNppGenerator) -> Tuple[str, str]:
    """Write G1's and G2's state_dicts where ``load_generators`` finds them."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for g, name in zip((g1, g2), GENERATOR_FILES):
        path = os.path.join(out_dir, name)
        torch.save({k: t.detach().cpu() for k, t in g.state_dict().items()}, path)
        paths.append(path)
    return tuple(paths)
