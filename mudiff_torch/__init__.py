"""mudiff_torch: the PyTorch / CUDA (H100) port of mudiff_tpu.

The serving path of the 4-step sampler: ``build_sampler(cfg)`` builds G1
and G2 on the card; their 3x3 stride-1 convs and factor-2 FIR resamplers
run hand-written CUDA kernels (``mudiff_torch/csrc``), the rest is plain
PyTorch.  The package imports nothing of JAX or of ``mudiff_tpu``.
"""

from mudiff_torch.config import MuDiffConfig, brats_recipe
from mudiff_torch.sampler import Sampler, build_sampler

__all__ = ["MuDiffConfig", "brats_recipe", "Sampler", "build_sampler"]
