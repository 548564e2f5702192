"""Typed configuration for mudiff_torch.

A copy of ``mudiff_tpu/config.py`` (``MuDiffConfig``, ``_as_int_list``,
``brats_recipe``): the port imports nothing of the JAX package, so it
keeps its own.  Field names, defaults and the recipe must stay equal to
the JAX copy; ``tests/test_torch_port_generator.py`` checks that.  The
YAML experiment layer (``_IGNORED_KEYS``, ``_config_from_yaml``,
``load_experiment``) is the port's copy of ``mudiff_tpu/cli/run.py:34-72``;
the files are read by ``utils/yaml_lite.py``.

One dataclass backs every public flag of the reference CLIs
(reference: engine/train.py:1318-1446, engine/test.py:401-485,
engine/test_volume.py:302-359).  Flag *names and semantics* match the
reference; defaults follow the reference argparse defaults (the
reference YAML overrides some of them, e.g. lr_g 1.6e-4 vs argparse
1.5e-4).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclass
class MuDiffConfig:
    # -- reproducibility ---------------------------------------------------
    seed: int = 1024

    # -- data / image ------------------------------------------------------
    image_size: int = 32
    num_channels: int = 3          # channels of each image fed to the nets
    centered: bool = True          # data already in [-1, 1]
    input_path: str = "/data/BRATS/"
    output_path: str = "/results"
    target_modality: str = "T1CE"  # T1 | T2 | FLAIR | T1CE
    dataset: str = "brats"         # brats | isles (reference lacks dataset_isles.py; we ship it)
    contrast1: str = "T1"
    contrast2: str = "T2"

    # -- diffusion ---------------------------------------------------------
    use_geometric: bool = False
    beta_min: float = 0.1
    beta_max: float = 20.0
    num_timesteps: int = 4

    # -- generator architecture (NCSN++ AdaGN) -----------------------------
    num_channels_dae: int = 128    # base width nf
    n_mlp: int = 3                 # z-mapping MLP depth
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    dropout: float = 0.0
    resamp_with_conv: bool = True
    conditional: bool = True       # time-conditional
    fir: bool = True
    fir_kernel: Tuple[int, ...] = (1, 3, 3, 1)
    skip_rescale: bool = True
    resblock_type: str = "biggan"  # biggan | ddpm | biggan_oneadagn
    progressive: str = "none"      # none | output_skip | residual
    progressive_input: str = "residual"
    progressive_combine: str = "sum"
    embedding_type: str = "positional"  # positional | fourier
    fourier_scale: float = 16.0
    not_use_tanh: bool = False
    nz: int = 100
    z_emb_dim: int = 256
    t_emb_dim: int = 256
    ngf: int = 64                  # critic base width

    # -- training ----------------------------------------------------------
    exp: str = "ixi_synth"
    batch_size: int = 1            # per-host batch size
    num_epoch: int = 1200
    lr_g: float = 1.5e-4
    lr_d: float = 1.0e-4
    beta1: float = 0.5
    beta2: float = 0.9
    no_lr_decay: bool = False
    use_ema: bool = False
    ema_decay: float = 0.9999
    r1_gamma: float = 0.05
    lazy_reg: Optional[int] = None  # run R1 every N steps (None = every step)
    lambda_l1_loss: float = 0.5
    lambda_mask_loss: float = 0.1
    # parsed + printed but never applied in the reference loss
    # (engine/train.py:1006 vs :1409) — kept for flag parity.
    lambda_adv: float = 1.0
    # remat scope when use_grad_checkpoint (models/generator.py): "blocks"
    # (every block, and the critic in the G step) or "hires" / "hiresN"
    # (the blocks at resolution >= image_size / N, N = 2 for "hires");
    # the full-resolution stems, encode and fusion are rematted under
    # either.  use_int8 and int8_static select W8A8 serving and its
    # static scales (models/generator.py, infer/generators.py).
    use_grad_checkpoint: bool = False
    grad_checkpoint_policy: str = "blocks"
    use_bf16: bool = True          # bf16 compute
    use_int8: bool = False         # W8A8 int8 serving
    int8_static: Optional[bool] = None
    resume: bool = False
    pretrained_dir: Optional[str] = None

    # -- checkpointing -----------------------------------------------------
    save_content: bool = True
    save_content_every: int = 1
    save_ckpt_every: int = 10

    # -- logging -----------------------------------------------------------
    log_every: int = 100
    log_mem_after_update: bool = False
    debug_verbose: bool = False

    # -- parallelism -------------------------------------------------------
    dp: int = -1                   # data-parallel size; <=0: all devices
    fsdp: int = 1                  # parameter-sharding size
    # legacy reference DDP flags, accepted and ignored (parity):
    num_proc_node: int = 1
    num_process_per_node: int = 1
    node_rank: int = 0
    local_rank: int = 0
    master_address: str = "127.0.0.1"
    port_num: str = "6021"

    # ----------------------------------------------------------------------
    def __post_init__(self) -> None:
        self.ch_mult = tuple(self.ch_mult) if self.ch_mult else (1, 2, 4)
        self.attn_resolutions = tuple(_as_int_list(self.attn_resolutions))
        self.fir_kernel = tuple(_as_int_list(self.fir_kernel))

    @property
    def all_resolutions(self) -> List[int]:
        return [self.image_size // (2 ** i) for i in range(len(self.ch_mult))]

    def replace(self, **kw: Any) -> "MuDiffConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MuDiffConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# Reference flags with no meaning on one card, accepted in a YAML for
# parity and dropped (``mudiff_tpu/cli/run.py:34-37``).
_IGNORED_KEYS = {
    "gpu_chose", "compute_fid", "num_proc_node", "num_process_per_node",
    "node_rank", "local_rank", "master_address", "port_num",
}


def _config_from_yaml(args_dict: Optional[Dict[str, Any]], data_path: str,
                      output_root: str, exp_name: str, target: str) -> MuDiffConfig:
    """An experiment's ``train_args`` or ``test_args`` as a config, with
    the runner's defaults: ``input_path`` (the file's ``data_path``),
    ``output_path`` (``output_root``), ``exp`` and ``target_modality``."""
    d = {k: v for k, v in (args_dict or {}).items() if k not in _IGNORED_KEYS}
    d.setdefault("input_path", data_path)
    d.setdefault("output_path", output_root)
    d.setdefault("exp", exp_name)
    d.setdefault("target_modality", target)
    return MuDiffConfig.from_dict(d)


def load_experiment(cfg_path: str, exp_name: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the YAML document, its experiment named ``exp_name``); raises
    ``ValueError`` naming the experiments the file has."""
    from mudiff_torch.utils import yaml_lite

    doc = yaml_lite.load(cfg_path)
    experiments = doc.get("experiments", []) if isinstance(doc, dict) else []
    match = [e for e in experiments if e.get("exp_name") == exp_name]
    if not match:
        names = [e.get("exp_name") for e in experiments]
        raise ValueError(f"experiment {exp_name!r} not found; have {names}")
    return doc, match[0]


def _as_int_list(v: Any) -> List[int]:
    """Coerce '16,8' / '(16,)' / [16] / 16 into a list of ints.

    Mirrors the reference coercion helper (engine/train.py:1303-1310) so
    flags can arrive as strings from YAML/CLI.
    """
    if v is None:
        return []
    if isinstance(v, int):
        return [v]
    if isinstance(v, str):
        s = v.strip().strip("()[]")
        return [int(p) for p in s.replace(",", " ").split() if p]
    if isinstance(v, Sequence):
        return [int(x) for x in v]
    raise TypeError(f"cannot coerce {v!r} to int list")


# The canonical BraTS recipe from the reference YAML
# (experiments/cfg/local.yaml:5-513): 256x256, nf=128, ch_mult [1,2,4],
# 4 timesteps, 30 epochs, lr_g 1.6e-4.
def brats_recipe(**overrides: Any) -> MuDiffConfig:
    base = dict(
        image_size=256,
        num_channels=1,
        num_channels_dae=128,
        ch_mult=(1, 2, 4),
        num_res_blocks=2,
        attn_resolutions=(16,),
        num_timesteps=4,
        batch_size=2,
        num_epoch=30,
        lr_g=1.6e-4,
        lr_d=1.0e-4,
        r1_gamma=0.05,
        lazy_reg=16,
        lambda_l1_loss=0.5,
        lambda_mask_loss=0.1,
        z_emb_dim=256,
        t_emb_dim=256,
        nz=100,
        ngf=64,
    )
    base.update(overrides)
    return MuDiffConfig(**base)
