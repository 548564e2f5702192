"""Forward diffusion, posterior sampling and the T-step reverse sampler.

The port of ``mudiff_tpu/diffusion/sampling.py:25-197`` (with ``uncer_loss``).  The training
helpers ``q_sample``, ``q_sample_pairs`` and ``sample_posterior`` take
their noise as arguments (``train/steps.py`` draws it from a
``torch.Generator`` or injects it).  The JAX
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

from mudiff_torch.diffusion.schedule import DiffusionCoefficients, PosteriorCoefficients
from mudiff_torch.utils.profiling import span


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather table[t] and reshape to broadcast over an ndim-rank batch."""
    out = table[t]
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))


def q_sample(coeff: DiffusionCoefficients, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Diffuse x_0 -> x_t, t == 0 meaning one step applied (reference
    engine/train.py:256-266).  ``coeff`` holds tensors (``as_tensors``)."""
    nd = x_start.ndim
    return (extract(coeff.a_s_cum, t, nd) * x_start
            + extract(coeff.sigmas_cum, t, nd) * noise)


def q_sample_pairs(coeff: DiffusionCoefficients, x_start: torch.Tensor, t: torch.Tensor,
                   noise_t: torch.Tensor, noise_tp1: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training pair (x_t, x_{t+1}) (reference engine/train.py:269-281):
    x_t from its own draw ``noise_t``, x_{t+1} = a_s[t+1] x_t +
    sigmas[t+1] ``noise_tp1``.  The JAX package draws ``noise_tp1`` from
    the first and ``noise_t`` from the second half of its split key."""
    nd = x_start.ndim
    x_t = q_sample(coeff, x_start, t, noise_t)
    x_tp1 = extract(coeff.a_s, t + 1, nd) * x_t + extract(coeff.sigmas, t + 1, nd) * noise_tp1
    return x_t, x_tp1


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


def sample_posterior(post: PosteriorCoefficients, x_0: torch.Tensor, x_t: torch.Tensor,
                     t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One sample of q(x_{t-1} | x_0, x_t) (reference engine/train.py:310-331)."""
    return _add_posterior_noise(post, _posterior_mean(post, x_0, x_t, t), x_t, t, noise)


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
        with span("sample.step", {"t": i}):
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
            with span("sample.posterior"):
                x = sample_posterior_combine(
                    post, x0_1.to(torch.float32), x0_2.to(torch.float32), x, t, eps
                )
    return x


def sampler_draws(generator: torch.Generator, shape: Sequence[int], nz: int,
                  num_timesteps: int, rows: slice = slice(None)
                  ) -> Tuple[torch.Tensor, list]:
    """``x_init`` and each step's ``(z, posterior noise)`` for a batch of
    ``shape`` (B, H, W, C), drawn from ``generator`` on its device in the
    order and shapes that ``Sampler.__call__`` and ``sample_from_model``
    draw them, so ``sample_from_model(..., x_init, noise=...)`` gives the
    bits of a call that draws from ``generator`` itself.  ``rows`` of each
    draw are kept: a rank's rows of the global batch on a mesh."""
    def normal(*size):
        return torch.randn(size, generator=generator, device=generator.device,
                           dtype=torch.float32)[rows]

    x_init = normal(*shape)
    return x_init, [(normal(shape[0], nz), normal(*shape)) for _ in range(num_timesteps)]


def uncer_loss(mean: torch.Tensor, var: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Gaussian-NLL-style uncertainty loss, ``mean(0.5 * (exp(-var) *
    (mean - label)^2 + var))`` (defined and never called in the reference,
    engine/train.py:378-382; ``mudiff_tpu/diffusion/sampling.py:189``)."""
    loss1 = torch.exp(-var) * (mean - label) ** 2
    return torch.mean(0.5 * (loss1 + var))
