"""Rematerialisation (``use_grad_checkpoint``) of a region of the forward.

The port of the JAX package's ``nn.remat`` / ``jax.checkpoint`` wraps
(``mudiff_tpu/models/generator.py:195-245, 299-303, 353-357, 415-440``,
``mudiff_tpu/train/steps.py:172-192``): a region's activations are not
kept for the backward; the backward runs the region's forward again.

``torch.utils.checkpoint`` in its non-reentrant form, which
``torch.autograd.grad`` (the training steps) needs.  Two things of the
port ride along:

* the kernel mode.  The recompute runs inside the backward, on the
  autograd engine's device thread, where the caller's context variables
  (``ops.plain_kernels()``, ``ops.record_calls``) are not set; the
  region's forward mode is captured here and re-entered for the
  recompute, so a region recomputes through the kernels exactly when
  its forward ran through them.
* randomness.  The regions draw nothing from torch's default
  generators: dropout masks come from seeds drawn before the forward
  (``nn/blocks.py``), so the recompute draws the same masks.
  ``preserve_rng_state`` is therefore off.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch
import torch.utils.checkpoint

from mudiff_torch.ops._dispatch import current_mode, restored


def checkpointed(name: str, fn: Callable[..., Any], *args: Any) -> Any:
    """``fn(*args)`` with its activations recomputed in the backward.
    ``name`` names the region (the tests record which regions ran)."""
    mode = current_mode()
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), restored(mode)))
