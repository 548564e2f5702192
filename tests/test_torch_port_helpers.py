"""Shared helpers of the ``test_torch_port_*`` files (no tests here).

``random_flax_params`` gives a flax module seeded, non-trivial float32
parameters without running its initializers: a fresh init puts every
resblock's ``Conv_1``, ``NIN_3`` and ``final_conv`` at ~1e-10 scale, so
a parity check on fresh weights would compare two near-constant outputs.
Shapes come from ``jax.eval_shape`` (no compile); values are numpy
normals scaled by 1/sqrt(fan_in) for kernels, and perturbations of the
init value (1 for GroupNorm scales and the AdaGN gamma half of a style
bias, 0 elsewhere) for vectors.
"""

import jax
import numpy as np


def _key_name(k):
    return str(getattr(k, "key", k))


def random_flax_params(module, *args, seed=0, **kwargs):
    """Nested dict of numpy float32 params for ``module.init(key, *args)``."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)["params"]
    rng = np.random.RandomState(seed)

    def draw(path, s):
        names = [_key_name(k) for k in path]
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = np.zeros(s.shape, np.float32)
        if names[-1] == "scale":
            base[:] = 1.0
        elif names[-2:] == ["style", "bias"]:
            base[: s.shape[0] // 2] = 1.0  # AdaGN (gamma=1, beta=0)
        return (base + 0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)
