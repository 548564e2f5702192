"""Fused bias + leaky-ReLU, plain PyTorch.

The port of ``mudiff_tpu/ops/fused_act.py:20``.  The reference ships a
CUDA kernel for it (utils/op/fused_bias_act_kernel.cu) and no model
calls it (SURVEY.md §2.1), so it needs no kernel here; autograd gives
every order of gradient.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2,
                     scale: float = math.sqrt(2.0)) -> torch.Tensor:
    """``leaky_relu(x + bias) * scale``, the (C,) bias broadcast over the
    trailing channel axis (NHWC), the scale in x's dtype."""
    if bias is not None:
        x = x + bias.reshape((1,) * (x.dim() - 1) + (-1,)).to(x.dtype)
    return F.leaky_relu(x, negative_slope) * torch.tensor(scale, dtype=x.dtype)
