"""Convert the JAX package's parameters to the port's state_dicts.

``params_from_flax(tree)`` takes the flax ``params`` tree of an
``NCSNppGenerator`` (any branch) or of one of the three critics as nested
dicts of numpy arrays (what ``jax.tree_util.tree_map(np.asarray,
params)`` gives) and returns a ``state_dict`` for the port's module of
the same name (the critics' ``StyleConv2d``s take the same ``conv``
rules).
``train_state_from_flax`` does G1, G2, the critic and the frozen
``att_conv`` of a whole JAX train state.  This is the
one place where the two packages' weight layouts are written down:

=====================================  =======================  ==============
flax leaf                              port key                 layout change
=====================================  =======================  ==============
``<m>/conv/kernel`` (3, 3, I, O)       ``<m>.weight``           none (HWIO)
``<m>/conv/kernel`` (1, 1, I, O)       ``<m>.weight``           [0, 0].T -> (O, I)
``<m>/dense/kernel``, ``<m>/kernel``   ``<m>.weight``           .T -> (O, I)
``<nin>/W`` (I, O)                     ``<nin>.weight``         .T -> (O, I)
``fourier_emb/W`` (nf,)                ``fourier_emb.W``        none
``<m>/GroupNorm_0/scale``              ``<m>.weight``           none
``<fir>/Conv2d_0/weight`` (3,3,I,O)    same path                none (HWIO)
``.../bias``, ``<nin>/b``              ``.../bias``             none
=====================================  =======================  ==============

``content_from_flax(payload)`` carries a whole JAX content checkpoint
(``mudiff_tpu/train/checkpoint.py`` ``save_content``) into the port's
``content.pt`` dict (``train/checkpoint.py``): the parameters by the
rules above, ``att_conv``, the EMA shadows, and optax's Adam state.
``optax.adam`` is ``chain(scale_by_adam, scale_by_learning_rate)``, so
each optimizer state is ``(ScaleByAdamState(count, mu, nu),
ScaleByScheduleState(count))``: ``mu`` / ``nu`` follow the parameters'
leaf rules and become torch Adam's ``exp_avg`` / ``exp_avg_sq``, keyed
by parameter name; the Adam count becomes its ``step``, and the
schedule's count the ``counts`` entry the cosine schedule reads.  It
takes what a bare orbax ``restore`` gives as numpy, which turns
NamedTuples into dicts keyed by field and tuples into lists (or dicts
keyed by index), as well as the NamedTuples themselves.

``export_generators(params_g1, params_g2, out_dir)`` writes the two
generators' state_dicts as ``gen_diffusive_{1,2}.pt``, the files that
``infer.generators.load_generators`` reads.  Its inputs are what an orbax
restore of a JAX checkpoint's ``gen_diffusive_{1,2}`` gives as numpy; the
port itself never imports orbax (``README.md`` shows the few lines that
run in an environment with JAX).

The flax wrapper scopes ``conv`` (nn.Conv inside Conv3x3/Conv1x1),
``dense`` (nn.Dense inside Dense/_TembBias) and an AffineGroupNorm's
inner ``GroupNorm_0`` have no module of their own in the port.  Strict
both ways: every flax leaf is used exactly once (a collision raises),
and the result loads with ``load_state_dict(state, strict=True)``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

GENERATOR_FILES = ("gen_diffusive_1.pt", "gen_diffusive_2.pt")


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
    if leaf == "W" and arr.ndim == 1:
        name = "W"  # GaussianFourierProjection's frozen frequencies
    elif leaf in ("kernel", "W"):
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
    return ".".join([*scope, name]), np.array(arr, dtype=np.float32, order="C")


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


def att_conv_from_flax(att_conv: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX state's frozen ``att_conv`` ({w: (1,1,C,1), b: (1,)}) ->
    the ``AttConv`` buffers (weight (1, C), bias (1,))."""
    w = np.asarray(att_conv["w"], np.float32)
    if w.ndim != 4 or w.shape[:2] != (1, 1) or w.shape[-1] != 1:
        raise ValueError(f"att_conv w must be (1, 1, C, 1), got {w.shape}")
    return {"weight": torch.from_numpy(np.array(w[0, 0].T, order="C")),
            "bias": torch.from_numpy(np.array(att_conv["b"], np.float32).reshape(1))}


def train_state_from_flax(state_np: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX ``MutualTrainState`` turned to numpy (its fields as
    attributes or keys) -> ``{"g1", "g2", "d", "att_conv"}`` state_dicts
    for ``TrainState.load_flax``.  The critic's params follow the same
    leaf rules as the generators'.  The optax moments are not carried."""

    def field(name):
        return state_np[name] if isinstance(state_np, Mapping) else getattr(state_np, name)

    return {"g1": params_from_flax(field("params_g1")),
            "g2": params_from_flax(field("params_g2")),
            "d": params_from_flax(field("params_d")),
            "att_conv": att_conv_from_flax(field("att_conv"))}


def _fields(node: Any) -> Dict[str, Any]:
    """A container as {field or index: value}: dicts, NamedTuples, and
    tuples or lists (keys "0", "1", ...)."""
    if isinstance(node, Mapping):
        return {str(k): v for k, v in node.items()}
    if hasattr(node, "_asdict"):
        return dict(node._asdict())
    if isinstance(node, (list, tuple)):
        return {str(i): v for i, v in enumerate(node)}
    raise TypeError(f"not a container: {type(node).__name__}")


def adam_state_from_flax(opt_state: Any) -> Tuple[Dict[str, Any], int]:
    """An ``optax.adam`` state -> (the port's name-keyed torch Adam
    state_dict, the learning-rate schedule's count)."""
    parts = list(_fields(opt_state).values())
    adam = [_fields(p) for p in parts if isinstance(p, (Mapping, tuple, list))
            and {"count", "mu", "nu"} <= set(_fields(p))]
    sched = [_fields(p) for p in parts if isinstance(p, (Mapping, tuple, list))
             and set(_fields(p)) == {"count"}]
    if len(adam) != 1 or len(sched) != 1:
        raise ValueError("expected (ScaleByAdamState, ScaleByScheduleState) in an "
                         f"optax.adam state, got fields {[sorted(_fields(p)) for p in parts]}")
    adam, count = adam[0], int(np.asarray(sched[0]["count"]))
    mu, nu = params_from_flax(adam["mu"]), params_from_flax(adam["nu"])
    if set(mu) != set(nu):
        raise ValueError("Adam's mu and nu name different parameters")
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    state = {name: {"step": step.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
             for name in mu}
    return {"state": state, "param_groups": [{"params": list(mu)}]}, count


def content_from_flax(payload: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX content checkpoint (as an orbax ``restore`` gives it, turned
    to numpy) -> the port's ``content.pt`` dict."""
    out = {"epoch": int(np.asarray(payload["epoch"])),
           "global_step": int(np.asarray(payload["global_step"])),
           "step": int(np.asarray(payload["step"])),
           "att_conv": att_conv_from_flax(payload["att_conv"]), "counts": {}}
    for name in ("g1", "g2", "d"):
        out[name] = params_from_flax(payload[f"params_{name}"])
        out[f"opt_{name}"], out["counts"][name] = adam_state_from_flax(payload[f"opt_{name}"])
        if set(out[f"opt_{name}"]["state"]) != set(out[name]):
            raise ValueError(f"opt_{name}: the moments name other parameters than params_{name}")
    for name in ("ema_g1", "ema_g2"):
        ema = payload.get(name)
        out[name] = params_from_flax(ema) if ema is not None else None
    return out


def export_generators(params_g1: Mapping[str, Any], params_g2: Mapping[str, Any],
                      out_dir: str) -> Tuple[str, str]:
    """flax params of G1 and G2 (nested dicts of arrays) -> the port's
    ``gen_diffusive_{1,2}.pt`` under ``out_dir``; returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for params, name in zip((params_g1, params_g2), GENERATOR_FILES):
        path = os.path.join(out_dir, name)
        torch.save(params_from_flax(params), path)
        paths.append(path)
    return tuple(paths)


def lpips_from_flax(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX package's LPIPS parameters (``mudiff_tpu/metrics/lpips.py``:
    ``conv<i>/kernel`` HWIO, ``conv<i>/bias``, ``lin<i>``) in the port's
    layout (``metrics/lpips.py``: ``conv<i>`` weight OIHW)."""
    out: Dict[str, Any] = {}
    for name, value in params.items():
        if name.startswith("conv"):
            kernel = np.asarray(value["kernel"], np.float32)
            out[name] = {"weight": torch.from_numpy(np.ascontiguousarray(
                             kernel.transpose(3, 2, 0, 1))),
                         "bias": torch.from_numpy(np.array(value["bias"], np.float32))}
        else:
            out[name] = torch.from_numpy(np.array(value, np.float32).reshape(-1))
    return out
