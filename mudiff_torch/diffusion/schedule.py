"""Diffusion schedules and coefficient tables (numpy, as in the JAX package).

The port of ``mudiff_tpu/diffusion/schedule.py``: the time grid and
variances are computed in float64, betas are cast to float32 and every
derived table is computed in float32 from the cast betas
(reference: engine/train.py:221-243).  The tables stay numpy arrays so
that they equal the JAX package's bit for bit; ``as_tensors`` moves them
to a device once for the sampler.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


def var_func_vp(t: np.ndarray, beta_min: float, beta_max: float) -> np.ndarray:
    """VP-SDE variance (reference engine/train.py:194-197)."""
    log_mean_coeff = -0.25 * t ** 2 * (beta_max - beta_min) - 0.5 * t * beta_min
    return 1.0 - np.exp(2.0 * log_mean_coeff)


def var_func_geometric(t: np.ndarray, beta_min: float, beta_max: float) -> np.ndarray:
    """Geometric variance (reference engine/train.py:200-201)."""
    return beta_min * ((beta_max / beta_min) ** t)


def _time_grid(n_timestep: int) -> np.ndarray:
    eps_small = 1e-3
    t = np.arange(0, n_timestep + 1, dtype=np.float64) / n_timestep
    return t * (1.0 - eps_small) + eps_small


def get_sigma_schedule(
    num_timesteps: int,
    beta_min: float,
    beta_max: float,
    use_geometric: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-step (sigmas, a_s, betas), each of length T+1 with betas[0]=1e-8."""
    t = _time_grid(num_timesteps)
    if use_geometric:
        var = var_func_geometric(t, beta_min, beta_max)
    else:
        var = var_func_vp(t, beta_min, beta_max)
    alpha_bars = 1.0 - var
    betas = 1.0 - alpha_bars[1:] / alpha_bars[:-1]
    betas = np.concatenate([[1e-8], betas]).astype(np.float32)
    sigmas = betas ** 0.5
    a_s = np.sqrt(1.0 - betas)
    return sigmas, a_s, betas


class PosteriorCoefficients(NamedTuple):
    """Reverse (DDPM posterior) tables of length T (reference
    engine/train.py:285-307)."""

    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    posterior_variance: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    posterior_log_variance_clipped: np.ndarray

    @classmethod
    def create(
        cls,
        num_timesteps: int,
        beta_min: float,
        beta_max: float,
        use_geometric: bool = False,
    ) -> "PosteriorCoefficients":
        _, _, betas_full = get_sigma_schedule(
            num_timesteps, beta_min, beta_max, use_geometric
        )
        betas = betas_full[1:].astype(np.float32)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.concatenate(
            [np.ones(1, dtype=np.float32), alphas_cumprod[:-1]]
        )
        posterior_variance = (
            betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        )
        return cls(
            betas=betas,
            alphas=alphas,
            alphas_cumprod=alphas_cumprod,
            alphas_cumprod_prev=alphas_cumprod_prev,
            posterior_variance=posterior_variance,
            sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
            sqrt_recip_alphas_cumprod=1.0 / np.sqrt(alphas_cumprod),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1.0),
            posterior_mean_coef1=(
                betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
            ),
            posterior_mean_coef2=(
                (1.0 - alphas_cumprod_prev)
                * np.sqrt(alphas)
                / (1.0 - alphas_cumprod)
            ),
            posterior_log_variance_clipped=np.log(
                np.maximum(posterior_variance, 1e-20)
            ),
        )

    @classmethod
    def from_config(cls, config) -> "PosteriorCoefficients":
        return cls.create(
            config.num_timesteps, config.beta_min, config.beta_max,
            config.use_geometric,
        )

    def as_tensors(self, device) -> "PosteriorCoefficients":
        """The same tables as float32 tensors on ``device``."""
        return PosteriorCoefficients(
            *(torch.as_tensor(np.asarray(a, np.float32), device=device)
              for a in self)
        )
