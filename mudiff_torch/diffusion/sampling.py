"""Posterior sampling and the T-step reverse sampler.

The port of ``mudiff_tpu/diffusion/sampling.py:25-186``.  The JAX
sampler is one ``lax.scan``; here it is a Python loop over
``t = T-1 ... 0``.  Randomness comes from an explicit
``torch.Generator`` in the JAX order (per step: first ``z`` of shape
``(B, nz)``, then the posterior noise), or is injected by the caller as
one ``(z, noise)`` pair per step, which is how the parity test replays
the JAX key splits.  Noise is float32; the generators run in
``compute_dtype`` and the posterior update in float32.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from mudiff_torch.diffusion.schedule import PosteriorCoefficients


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather table[t] and reshape to broadcast over an ndim-rank batch."""
    out = table[t]
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))


def _posterior_mean(post, x_0, x_t, t):
    nd = x_t.ndim
    return (
        extract(post.posterior_mean_coef1, t, nd) * x_0
        + extract(post.posterior_mean_coef2, t, nd) * x_t
    )


def _add_posterior_noise(post, mean, x_t, t, noise):
    nd = x_t.ndim
    log_var = extract(post.posterior_log_variance_clipped, t, nd)
    nonzero = (1.0 - (t == 0).to(torch.float32)).reshape(
        t.shape[0], *([1] * (nd - 1))
    )
    return mean + nonzero * torch.exp(0.5 * log_var) * noise


def sample_posterior_combine(
    post: PosteriorCoefficients,
    x_0_1: torch.Tensor,
    x_0_2: torch.Tensor,
    x_t: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """MU-Diff's mutual posterior: the mean of the two generators'
    posterior means, one variance (reference engine/train.py:334-360).
    ``post`` holds tensors (``PosteriorCoefficients.as_tensors``)."""
    mean = 0.5 * (
        _posterior_mean(post, x_0_1, x_t, t) + _posterior_mean(post, x_0_2, x_t, t)
    )
    return _add_posterior_noise(post, mean, x_t, t, noise)


def sample_from_model(
    post: PosteriorCoefficients,
    generator1: Callable[..., torch.Tensor],
    generator2: Callable[..., torch.Tensor],
    cond1: torch.Tensor,
    cond2: torch.Tensor,
    cond3: torch.Tensor,
    x_init: torch.Tensor,
    num_timesteps: int,
    nz: int,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The T-step reverse sampler (reference engine/train.py:363-375).

    Per step i = T-1..0: draw z and the posterior noise (or take
    ``noise[step]``), x0_1 = G1(x, c1, c2, c3, t, z),
    x0_2 = G2(x, c1, c2, c3, t, z, x0_1), then the combined posterior
    sample.  ``post`` holds tensors on the device of ``x_init``.
    """
    if noise is not None and len(noise) != num_timesteps:
        raise ValueError(f"need {num_timesteps} (z, noise) pairs, got {len(noise)}")
    batch = x_init.shape[0]
    device = x_init.device
    conds = [c.to(compute_dtype) for c in (cond1, cond2, cond3)]
    x = x_init.to(torch.float32)
    for step, i in enumerate(range(num_timesteps - 1, -1, -1)):
        t = torch.full((batch,), i, dtype=torch.int64, device=device)
        if noise is not None:
            z, eps = noise[step]
        else:
            z = torch.randn((batch, nz), generator=generator, device=device,
                            dtype=torch.float32)
            eps = torch.randn(x.shape, generator=generator, device=device,
                              dtype=torch.float32)
        xc = x.to(compute_dtype)
        x0_1 = generator1(xc, *conds, t, z)
        x0_2 = generator2(xc, *conds, t, z, x0_1)
        x = sample_posterior_combine(
            post, x0_1.to(torch.float32), x0_2.to(torch.float32), x, t, eps
        )
    return x
