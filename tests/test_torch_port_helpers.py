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


# -- the generator branches (tests/test_torch_port_branches*.py) ------------

BRANCH_SMALL = dict(image_size=16, num_channels=1, num_channels_dae=8, ch_mult=(1, 2),
                    num_res_blocks=1, attn_resolutions=(8,), z_emb_dim=32, nz=8, n_mlp=1)


def branch_inputs(channels, num_conditions, t=(1, 3), seed=0, batch=2):
    """Seeded numpy inputs of a BRANCH_SMALL generator: x, the conditions
    (``None`` for a missing third), t, z and a pseudo target."""
    rng = np.random.RandomState(seed)
    s = BRANCH_SMALL["image_size"]
    x = rng.randn(batch, s, s, channels).astype(np.float32)
    conds = [rng.randn(batch, s, s, channels).astype(np.float32)
             for _ in range(num_conditions)]
    conds += [None] * (3 - num_conditions)
    z = rng.randn(batch, BRANCH_SMALL["nz"]).astype(np.float32)
    pseudo = np.tanh(rng.randn(batch, s, s, channels)).astype(np.float32)
    return x, conds, np.asarray(t, np.int32), z, pseudo


def branch_pair(over, adaptive, num_conditions=3, t=(1, 3), seed=0):
    """(JAX output, port output, port generator) of one branch
    configuration, G1 or G2, on the same inputs and the same seeded
    weights (``random_flax_params``, carried by ``params_from_flax`` and
    loaded strictly)."""
    import jax.numpy as jnp
    import torch

    from mudiff_torch import config
    from mudiff_torch.convert import params_from_flax
    from mudiff_torch.models import NCSNppGenerator
    from mudiff_tpu import config as jconfig
    from mudiff_tpu.models import NCSNppGenerator as JaxGenerator

    cfg = {**BRANCH_SMALL, **over}
    x, conds, t, z, pseudo = branch_inputs(cfg["num_channels"], num_conditions, t, seed)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    args = [j(x), *map(j, conds), j(t), j(z)]
    kw = {"pseudo_target": j(pseudo)} if adaptive else {}
    m = JaxGenerator(config=jconfig.MuDiffConfig(**cfg), adaptive=adaptive,
                     num_conditions=num_conditions)
    params = random_flax_params(m, *args, seed=seed + 7, **kw)
    ref = np.asarray(m.apply({"params": params}, *args, **kw))
    g = NCSNppGenerator(config.MuDiffConfig(**cfg), adaptive=adaptive,
                        num_conditions=num_conditions).eval()
    g.load_state_dict(params_from_flax(params), strict=True)
    tt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        out = g(tt(x), *map(tt, conds), tt(t).long(), tt(z),
                *([tt(pseudo)] if adaptive else [])).numpy()
    return ref, out, g
