"""The serving entry point: ``build_sampler`` and ``Sampler``.

``build_sampler(cfg)`` builds G1 and G2 on the card (``device`` defaults
to ``"cuda"`` and raises without one; pass ``"cpu"`` explicitly to run
the plain versions), in inference mode with the bf16 compute dtype and
bf16-score attention by default, the exact-bf16 serving mode of the JAX
package's ``bench.py --bf16``; with ``config.use_int8`` they serve W8A8
through kernel K4, with dynamic or static scales (``bench.py:50-83``).
A ``Sampler`` call runs the T-step reverse sampler
(``diffusion/sampling.py``) on NHWC condition images.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from mudiff_torch.config import MuDiffConfig
from mudiff_torch.diffusion.sampling import sample_from_model
from mudiff_torch.diffusion.schedule import PosteriorCoefficients
from mudiff_torch.models.generator import NCSNppGenerator
from mudiff_torch.ops.int8_conv import Int8Calib


def serving_device(device=None, what: str = "build_sampler") -> torch.device:
    """``device`` as a torch.device, ``"cuda"`` by default; raises when
    that is CUDA and no card is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return device


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
                  generator: Optional[torch.Generator] = None,
                  int8_calibs: Optional[Tuple[Int8Calib, Int8Calib]] = None,
                  int8_static: bool = False) -> Sampler:
    """G1 + G2 + posterior tables on ``device`` (default ``"cuda"``).

    ``attn`` is the attention lowering of both generators: ``"bf16"``
    (the default), ``"einsum"`` or ``"flash"`` (kernel K3).

    With ``config.use_int8`` the routed convs run W8A8: with the static
    scales of ``int8_calibs`` (G1's, G2's) when given; else, with
    ``int8_static``, with unit-scale calibrations of the real site lists
    (``calibrate.synthetic_calib``: the static mode's compute, for
    throughput only); else with dynamic scales.

    Weights are drawn from the JAX package's initial distributions with
    ``generator`` (a CPU ``torch.Generator``; load trained weights with
    ``sampler.g1.load_state_dict``, e.g. from ``convert.params_from_flax``).
    """
    from mudiff_torch.infer.calibrate import synthetic_calib

    device = serving_device(device)
    if (int8_calibs is not None or int8_static) and not config.use_int8:
        raise ValueError("int8 calibrations need config.use_int8")

    def build(calibs):
        gens = [NCSNppGenerator(config, adaptive=adaptive, attn=attn, dtype=compute_dtype,
                                generator=generator, int8_calib=calib)
                for adaptive, calib in zip((False, True), calibs)]
        for g in gens:
            g.requires_grad_(False)
            g.eval()
            g.to(device)
        return gens

    gens = build(int8_calibs or (None, None))
    if int8_calibs is None and int8_static:
        calibrated = build([synthetic_calib(g) for g in gens])
        for g, c in zip(gens, calibrated):
            c.load_state_dict(g.state_dict())
        gens = calibrated
    return Sampler(config, gens[0], gens[1], device, compute_dtype)
