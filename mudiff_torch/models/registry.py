"""Model registry: the JAX package's five names, ``ncsnpp``,
``ncsnpp_adaptive`` and the three critics
(``mudiff_tpu/models/registry.py:29-45``; reference backbones/utils.py:10-30).
"""

from __future__ import annotations

from typing import Callable, Dict

_MODELS: Dict[str, Callable] = {}


def register_model(cls=None, *, name: str = None):
    def _register(c):
        local_name = name if name is not None else c.__name__
        if local_name in _MODELS:
            raise ValueError(f"Already registered model with name: {local_name}")
        _MODELS[local_name] = c
        return c

    if cls is None:
        return _register
    return _register(cls)


def get_model(name: str):
    return _MODELS[name]


def _register_builtins() -> None:
    from mudiff_torch.models.critic import (
        DiscriminatorImgLarge,
        DiscriminatorLarge,
        DiscriminatorSmall,
    )
    from mudiff_torch.models.generator import NCSNppGenerator

    if "ncsnpp" not in _MODELS:
        _MODELS["ncsnpp"] = NCSNppGenerator
        _MODELS["ncsnpp_adaptive"] = lambda config, **kw: NCSNppGenerator(
            config=config, adaptive=True, **kw)
        _MODELS["discriminator_large"] = DiscriminatorLarge
        _MODELS["discriminator_small"] = DiscriminatorSmall
        _MODELS["discriminator_img_large"] = DiscriminatorImgLarge


_register_builtins()
