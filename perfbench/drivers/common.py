"""What both drivers share: seeds, the seeded weights of each module,
the device's clocks and memory, and the reference's float32 setting."""

from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Dict

import torch

from perfbench.inputs.weights import make_weights, module_seed
from perfbench.reference import model

GIB = float(2 ** 30)


def check_world() -> None:
    """The drivers here run one process on one card."""
    if int(os.environ.get("WORLD_SIZE", "1")) != 1:
        raise SystemExit("perfbench: no driver here runs more than one rank yet")


def sub_seed(seed: int, tag: int, i: int = 0) -> int:
    """A seed for stream ``tag``, item ``i`` of a run (any integer ``i``)."""
    return (int(seed) * 1_000_003 + tag * 10_007 + i) % (2 ** 63)


def weights(cfg: dict, seed: int, device,
            modules=("g1", "g2")) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module: {name: tensor}}: the run's seeded weights of ``modules``."""
    specs = {"g1": lambda: model.generator_specs(cfg, False),
             "g2": lambda: model.generator_specs(cfg, True),
             "d": lambda: model.critic_specs(cfg), "att": lambda: model.att_conv_specs(cfg)}
    return {m: make_weights(specs[m](), module_seed(seed, m), device) for m in modules}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def build_kernels(device) -> None:
    """Build every kernel library of the port now (in parallel; a
    checkout's first run compiles, later runs find them built)."""
    if torch.device(device).type == "cuda":
        from mudiff_torch.ops import _build

        _build.build()


@contextlib.contextmanager
def exact_fp32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def now() -> float:
    return time.perf_counter()


@contextlib.contextmanager
def phase(phases: Dict[str, float], name: str):
    """Add the block's host seconds to ``phases[name]``."""
    t = time.perf_counter()
    try:
        yield
    finally:
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t
