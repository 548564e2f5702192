"""Seeded weights, made on the device in one draw.

Every leaf of a module comes from one ``torch.randn`` on the device's
generator, split in the order of the sorted leaf names and scaled by a
rule of the leaf's name and shape: a conv or dense weight by
1/sqrt(fan-in), a GroupNorm scale as 1 + 0.1 n, an AdaGN style bias as
(1, 0) + 0.1 n, every other bias as 0.1 n.  No leaf starts at zero, so
every layer, the zero-initialised ones of the recipe included, carries
signal into the output the check compares.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _scaled(name: str, shape: Tuple[int, ...], n: torch.Tensor) -> torch.Tensor:
    n = n.reshape(shape)
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias" or name == "bias":
        if name.endswith("style.bias"):
            c = shape[0] // 2
            base = torch.cat([torch.ones(c, device=n.device), torch.zeros(c, device=n.device)])
            return base + 0.1 * n
        return 0.1 * n
    if len(shape) == 1:
        return 1.0 + 0.1 * n
    fan_in = math.prod(shape[:-1]) if len(shape) == 4 else shape[1]
    return n / math.sqrt(fan_in)


def make_weights(specs: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for ``specs`` ({name: shape}), drawn from
    ``seed`` on ``device``."""
    names = sorted(specs)
    sizes = [math.prod(specs[k]) for k in names]
    gen = torch.Generator(device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, size in zip(names, sizes):
        out[k] = _scaled(k, specs[k], flat[at:at + size]).contiguous()
        at += size
    return out


def module_seed(seed: int, module: str) -> int:
    """The weight seed of one module (``g1``, ``g2``, ``d``, ``att``) of a run."""
    tags = {"g1": 1, "g2": 2, "d": 3, "att": 4}
    return (int(seed) * 8 + tags[module]) % (2 ** 63)
