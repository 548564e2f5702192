"""Model registry: the JAX package's five names
(``mudiff_tpu/models/registry.py:29-45``; reference backbones/utils.py:10-30).

``discriminator_small`` and ``discriminator_img_large`` are not ported
(ROADMAP.md queue 1, item 8): looking either up raises
``NotImplementedError``; neither is replaced by another critic.
"""

from __future__ import annotations

from typing import Callable, Dict

_MODELS: Dict[str, Callable] = {}
_NOT_PORTED = ("discriminator_small", "discriminator_img_large")


def register_model(cls=None, *, name: str = None):
    def _register(c):
        local_name = name if name is not None else c.__name__
        if local_name in _MODELS or local_name in _NOT_PORTED:
            raise ValueError(f"Already registered model with name: {local_name}")
        _MODELS[local_name] = c
        return c

    if cls is None:
        return _register
    return _register(cls)


def get_model(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet; ROADMAP.md queue 1, item 8 (the model branches)")
    return _MODELS[name]


def _register_builtins() -> None:
    from mudiff_torch.models.critic import DiscriminatorLarge
    from mudiff_torch.models.generator import NCSNppGenerator

    if "ncsnpp" not in _MODELS:
        _MODELS["ncsnpp"] = NCSNppGenerator
        _MODELS["ncsnpp_adaptive"] = lambda config, **kw: NCSNppGenerator(
            config=config, adaptive=True, **kw)
        _MODELS["discriminator_large"] = DiscriminatorLarge


_register_builtins()
