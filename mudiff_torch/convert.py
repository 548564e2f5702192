"""Convert the JAX package's generator parameters to the port's state_dict.

``params_from_flax(tree)`` takes the flax ``params`` tree of an
``NCSNppGenerator`` as nested dicts of numpy arrays (what
``jax.tree_util.tree_map(np.asarray, params)`` gives) and returns a
``state_dict`` for ``mudiff_torch.models.NCSNppGenerator``.  This is the
one place where the two packages' weight layouts are written down:

=====================================  =======================  ==============
flax leaf                              port key                 layout change
=====================================  =======================  ==============
``<m>/conv/kernel`` (3, 3, I, O)       ``<m>.weight``           none (HWIO)
``<m>/conv/kernel`` (1, 1, I, O)       ``<m>.weight``           [0, 0].T -> (O, I)
``<m>/dense/kernel``, ``<m>/kernel``   ``<m>.weight``           .T -> (O, I)
``<nin>/W`` (I, O)                     ``<nin>.weight``         .T -> (O, I)
``<m>/GroupNorm_0/scale``              ``<m>.weight``           none
``<fir>/Conv2d_0/weight`` (3,3,I,O)    same path                none (HWIO)
``.../bias``, ``<nin>/b``              ``.../bias``             none
=====================================  =======================  ==============

The flax wrapper scopes ``conv`` (nn.Conv inside Conv3x3/Conv1x1),
``dense`` (nn.Dense inside Dense/_TembBias) and an AffineGroupNorm's
inner ``GroupNorm_0`` have no module of their own in the port.  Strict
both ways: every flax leaf is used exactly once (a collision raises),
and the result loads with ``load_state_dict(state, strict=True)``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _convert_leaf(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *scope, leaf = path
    if scope and scope[-1] in ("conv", "dense"):
        scope = scope[:-1]
    elif scope and scope[-1] == "GroupNorm_0" and leaf in ("scale", "bias"):
        scope = scope[:-1]
    if leaf in ("kernel", "W"):
        if arr.ndim == 4 and arr.shape[:2] == (1, 1):
            arr = arr[0, 0].T
        elif arr.ndim == 2:
            arr = arr.T
        elif not (arr.ndim == 4 and arr.shape[:2] == (3, 3)):
            raise ValueError(f"unexpected kernel shape {arr.shape} at {'/'.join(path)}")
        name = "weight"
    elif leaf in ("scale", "weight"):
        name = "weight"
    elif leaf in ("bias", "b"):
        name = "bias"
    else:
        raise ValueError(f"unknown flax leaf {'/'.join(path)}")
    return ".".join([*scope, name]), np.ascontiguousarray(arr, dtype=np.float32)


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax generator params (nested dicts of arrays) -> port state_dict."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree):
        key, value = _convert_leaf(path, arr)
        if key in state:
            raise ValueError(f"two flax leaves map to {key}")
        state[key] = torch.from_numpy(value)
    return state
