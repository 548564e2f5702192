"""Weight initializers (the port of ``mudiff_tpu/nn/initializers.py``).

* ``default_init`` -- DDPM/JAX variance scaling, fan_avg + uniform
  (reference backbones/layers.py:58-95).  All generator convs and NINs.
* ``stylegan_dense_init`` -- the sdeflow dense init.  It *claims*
  fan_avg, but its ``_calculate_correct_fan`` returns fan_out for any
  mode other than 'fan_in' (reference dense_layer.py:22-32), so the
  shipped behaviour is fan_out + uniform, variance scale/fan_out.  The
  quirk is kept.  The z-mapping MLP, the AdaGN style layers and
  ConvBlockGAP's fc.

Scale 0 means 1e-10 in both (a near-zero init).  An initializer is a
callable ``init(tensor, fan_in, fan_out, generator=None)`` that fills
``tensor`` in place from a CPU ``torch.Generator``.  The fans are given
explicitly because the port's layouts differ from flax's (a dense weight
is (out, in) here, (in, out) there); they are the fans JAX computes
from the flax shape.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

Init = Callable[..., torch.Tensor]


def variance_scaling(scale: float, mode: str) -> Init:
    def init(tensor: torch.Tensor, fan_in: int, fan_out: int,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        denom = {"fan_in": fan_in, "fan_out": fan_out,
                 "fan_avg": (fan_in + fan_out) / 2.0}[mode]
        limit = math.sqrt(3.0 * scale / max(1.0, denom))
        values = torch.empty(tuple(tensor.shape), dtype=torch.float32)
        values.uniform_(-limit, limit, generator=generator)
        with torch.no_grad():
            tensor.copy_(values)
        return tensor

    return init


def default_init(scale: float = 1.0) -> Init:
    """fan_avg uniform variance scaling; scale 0 means 1e-10."""
    return variance_scaling(1e-10 if scale == 0 else scale, "fan_avg")


def stylegan_dense_init(scale: float = 1.0) -> Init:
    """fan_out uniform variance scaling (the shipped quirk); scale 0 means 1e-10."""
    return variance_scaling(1e-10 if scale == 0 else scale, "fan_out")
