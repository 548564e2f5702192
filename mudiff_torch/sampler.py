"""The serving entry point: ``build_sampler`` and ``Sampler``.

``build_sampler(cfg)`` builds G1 and G2 on the card (``device`` defaults
to ``"cuda"`` and raises without one; pass ``"cpu"`` explicitly to run
the plain versions), in inference mode with the bf16 compute dtype and
bf16-score attention by default, the exact-bf16 serving mode of the JAX
package's ``bench.py --bf16``.  A ``Sampler`` call runs the T-step
reverse sampler (``diffusion/sampling.py``) on NHWC condition images.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from mudiff_torch.config import MuDiffConfig
from mudiff_torch.diffusion.sampling import sample_from_model
from mudiff_torch.diffusion.schedule import PosteriorCoefficients
from mudiff_torch.models.generator import NCSNppGenerator


class Sampler:
    """G1, G2 and the posterior tables on one device."""

    def __init__(self, config: MuDiffConfig, g1: NCSNppGenerator,
                 g2: NCSNppGenerator, device: torch.device,
                 compute_dtype: torch.dtype):
        self.config = config
        self.g1, self.g2 = g1, g2
        self.device = device
        self.compute_dtype = compute_dtype
        self.post = PosteriorCoefficients.from_config(config).as_tensors(device)

    def kernel_launches_per_sample(self) -> dict:
        """Kernel launches of one sampler call, from the module structure."""
        per_step = [self.g1.kernel_launches_per_forward(),
                    self.g2.kernel_launches_per_forward()]
        return {k: self.config.num_timesteps * sum(c[k] for c in per_step)
                for k in per_step[0]}

    @torch.inference_mode()
    def __call__(self, cond1: torch.Tensor, cond2: torch.Tensor, cond3: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 x_init: Optional[torch.Tensor] = None,
                 noise: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
                 ) -> torch.Tensor:
        """Sample x_0 (B,H,W,C) float32 from the three conditions.

        ``x_init`` defaults to a standard normal draw from ``generator``
        (made before the per-step draws); ``noise`` injects the per-step
        ``(z, posterior noise)`` pairs instead of drawing them.
        """
        if x_init is None:
            x_init = torch.randn(cond1.shape, generator=generator,
                                 device=self.device, dtype=torch.float32)
        return sample_from_model(
            self.post, self.g1, self.g2, cond1, cond2, cond3, x_init,
            self.config.num_timesteps, self.config.nz, generator=generator,
            noise=noise, compute_dtype=self.compute_dtype,
        )


def build_sampler(config: MuDiffConfig, device=None, attn: str = "bf16",
                  compute_dtype: torch.dtype = torch.bfloat16,
                  generator: Optional[torch.Generator] = None) -> Sampler:
    """G1 + G2 + posterior tables on ``device`` (default ``"cuda"``).

    Weights are drawn from the JAX package's initial distributions with
    ``generator`` (a CPU ``torch.Generator``; load trained weights with
    ``sampler.g1.load_state_dict``, e.g. from ``convert.params_from_flax``).
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "build_sampler: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU"
        )
    gens = [
        NCSNppGenerator(config, adaptive=adaptive, attn=attn,
                        dtype=compute_dtype, generator=generator)
        for adaptive in (False, True)
    ]
    for g in gens:
        g.requires_grad_(False)
        g.eval()
        g.to(device)
    return Sampler(config, gens[0], gens[1], device, compute_dtype)
