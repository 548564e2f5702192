"""Checkpoints: the full training state ("content") and the generators.

The port of ``mudiff_tpu/train/checkpoint.py`` (reference artifact kinds,
engine/train.py:1107-1140).  The JAX package writes orbax directories;
the port writes single ``torch.save`` files, each written under a
temporary name and then ``os.replace``d over the old one, so a run
stopped mid-save leaves the previous file whole.  Files are read with
``weights_only=True``.

* ``content.pt``: the resume state, a dict of
  - ``epoch``, ``global_step`` (sets the lazy-R1 schedule) and ``step``
    (the G updates);
  - ``counts``: each optimizer's update count, which its cosine schedule
    reads (``TrainState.counts``);
  - ``g1``, ``g2``, ``d``, ``att_conv``: the modules' state_dicts;
  - ``opt_g1``, ``opt_g2``, ``opt_d``: the Adam state_dicts, keyed by
    parameter name (``{"state": {name: {step, exp_avg, exp_avg_sq}},
    "param_groups": [{..., "params": [names]}]}``), so a file carried
    over from the JAX package (``convert.content_from_flax``) needs no
    module to order it;
  - ``ema_g1``, ``ema_g2``: the EMA shadows ({name: tensor}) or None.
* ``gen_diffusive_{1,2}.pt``: the generators' state_dicts, EMA-swapped
  when EMA is on, and the epoch-tagged ``gen_diffusive_{1,2}_{epoch}.pt``;
  ``infer.generators.load_generators`` reads them.

On a mesh (``state.mesh``) every rank calls ``save_content``,
``save_generators`` and ``restore_content``, as every process calls
them in the JAX package (``checkpoint.py:14-21``): the sharded parameters
and Adam moments are gathered (a collective), the lead rank writes, and
all wait at a barrier.  The file holds whole tensors keyed by name
whatever the mesh, so a file written at one world size restores at any
other; each rank takes its slices on restore.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from mudiff_torch.convert import GENERATOR_FILES
from mudiff_torch.infer.generators import checkpoint_path
from mudiff_torch.parallel.mesh import shard
from mudiff_torch.train.state import MODULES, ShardedParams, TrainState

CONTENT_FILE = "content.pt"
MOMENTS = ("exp_avg", "exp_avg_sq")


def _lead_writes(state: TrainState, write) -> Any:
    """``write()`` on the lead rank (or without a mesh), then a barrier."""
    mesh = state.mesh
    out = write() if mesh is None or mesh.lead else None
    if mesh is not None:
        mesh.barrier()
    return out


def atomic_save(obj: Any, path: str) -> str:
    """``torch.save`` to a temporary name beside ``path``, then rename."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _cpu(tree: Any) -> Any:
    """A copy of ``tree`` on the CPU (a copy on the CPU too, so a payload
    never aliases the live state)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def optimizer_by_name(opt: torch.optim.Optimizer, module: nn.Module,
                      sharded: Optional[ShardedParams] = None) -> Dict[str, Any]:
    """``opt.state_dict()`` with parameter names in place of indices;
    with ``sharded`` (fsdp) the moments gathered whole."""
    names = [n for n, _ in module.named_parameters()]
    sd = opt.state_dict()
    groups = [{**g, "params": [names[i] for i in g["params"]]} for g in sd["param_groups"]]
    state = {names[i]: dict(s) for i, s in sd["state"].items()}
    if sharded is not None and sharded.sharded and state:
        for key in MOMENTS:
            whole = sharded.whole_tensors([sd["state"][i][key] for i in range(len(names))])
            for n, t in zip(names, whole):
                state[n][key] = t
    return _cpu({"state": state, "param_groups": groups})


def load_optimizer_by_name(opt: torch.optim.Optimizer, module: nn.Module,
                           saved: Dict[str, Any],
                           sharded: Optional[ShardedParams] = None) -> None:
    """Load a name-keyed optimizer state into ``opt`` (strict: the saved
    names are exactly the module's).  Saved hyperparameters replace the
    live ones; a group that carries none (``convert.content_from_flax``)
    keeps the live optimizer's, the config's (the learning rate is set
    from the schedule before each update anyway).  With ``sharded``
    (fsdp) each rank keeps its slices of the whole moments."""
    names = [n for n, _ in module.named_parameters()]
    saved_names = [n for g in saved["param_groups"] for n in g["params"]]
    if sorted(saved_names) != sorted(names) or not set(saved["state"]) <= set(names):
        missing = sorted(set(names) - set(saved_names))[:4]
        extra = sorted(set(saved_names) - set(names))[:4]
        raise KeyError(f"optimizer state does not match the module: missing {missing}, "
                       f"unexpected {extra}")
    index = {n: i for i, n in enumerate(names)}
    state = {index[n]: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
             for n, s in saved["state"].items()}
    if sharded is not None and sharded.sharded:
        for i, s in state.items():
            for key in MOMENTS:
                if key in s:
                    s[key] = shard(s[key], sharded.axes[i], sharded.mesh)
    live = opt.state_dict()["param_groups"]
    if len(live) != 1 or len(saved["param_groups"]) != 1:
        raise ValueError("expected one parameter group")
    group = {**live[0], **{k: v for k, v in saved["param_groups"][0].items() if k != "params"}}
    opt.load_state_dict({"state": state, "param_groups": [group]})


def content_payload(state: TrainState, epoch: int, global_step: int) -> Dict[str, Any]:
    """The ``content.pt`` dict of ``state``, on the CPU (whole tensors;
    on a mesh a collective)."""
    state.materialize()
    payload = {"epoch": int(epoch), "global_step": int(global_step), "step": int(state.step),
               "counts": dict(state.counts)}
    for name in (*MODULES, "att_conv"):
        payload[name] = _cpu(getattr(state, name).state_dict())
    for name in MODULES:
        payload[f"opt_{name}"] = optimizer_by_name(getattr(state, f"opt_{name}"),
                                                   getattr(state, name), state.sharded[name])
    for name in ("ema_g1", "ema_g2"):
        ema = getattr(state, name)
        payload[name] = _cpu(ema) if ema is not None else None
    return payload


def save_content(exp_dir: str, state: TrainState, epoch: int, global_step: int) -> str:
    """Write the full training state for resume; returns the path (on
    the lead rank; None on the others)."""
    payload = content_payload(state, epoch, global_step)

    def write():
        os.makedirs(exp_dir, exist_ok=True)
        return atomic_save(payload, os.path.join(os.path.abspath(exp_dir), CONTENT_FILE))

    return _lead_writes(state, write)


def load_content(exp_dir: str) -> Dict[str, Any]:
    return torch.load(os.path.join(os.path.abspath(exp_dir), CONTENT_FILE),
                      map_location="cpu", weights_only=True)


def load_payload(state: TrainState, payload: Dict[str, Any]) -> None:
    """Load a ``content.pt`` dict into ``state`` (strict; on a mesh each
    rank keeps its slices)."""
    state.materialize()
    for name in (*MODULES, "att_conv"):
        getattr(state, name).load_state_dict(payload[name], strict=True)
    for name in MODULES:
        state.sharded[name].reshard()
        load_optimizer_by_name(getattr(state, f"opt_{name}"), getattr(state, name),
                               payload[f"opt_{name}"], state.sharded[name])
    state.step = int(payload["step"])
    state.counts = {k: int(payload["counts"][k]) for k in state.counts}
    for name in ("ema_g1", "ema_g2"):
        shadow, saved = getattr(state, name), payload.get(name)
        if shadow is None or saved is None:
            continue  # as the JAX restore: no saved shadow keeps the template's
        if set(saved) != set(shadow):
            raise KeyError(f"{name}: saved names differ from the generator's")
        with torch.no_grad():
            for n, v in saved.items():
                shadow[n].copy_(v)


def restore_content(exp_dir: str, state: TrainState) -> Tuple[TrainState, int, int]:
    """Restore ``content.pt`` into ``state`` in place; returns
    ``(state, epoch, global_step)``."""
    payload = load_content(exp_dir)
    load_payload(state, payload)
    return state, int(payload["epoch"]), int(payload["global_step"])


def generator_state_dicts(state: TrainState, use_ema_weights: bool = False):
    """G1's and G2's state_dicts, the EMA shadows swapped in when asked
    and EMA is on (the reference's swap_parameters_with_ema)."""
    state.materialize(("g1", "g2"))
    out = []
    for module, ema in ((state.g1, state.ema_g1), (state.g2, state.ema_g2)):
        sd = module.state_dict()
        if use_ema_weights and state.use_ema:
            sd.update(ema)
        out.append(_cpu(sd))
    return tuple(out)


def save_generators(exp_dir: str, state: TrainState, epoch: Optional[int] = None,
                    use_ema_weights: bool = True) -> Tuple[str, str]:
    """Write ``gen_diffusive_{1,2}.pt`` (and the ``_{epoch}`` copies);
    returns the paths (on the lead rank; None on the others)."""
    sds = generator_state_dicts(state, use_ema_weights)

    def write():
        base = os.path.abspath(exp_dir)
        os.makedirs(base, exist_ok=True)
        paths = []
        for sd, fname in zip(sds, GENERATOR_FILES):
            paths.append(atomic_save(sd, os.path.join(base, fname)))
            if epoch is not None:
                stem, ext = os.path.splitext(fname)
                atomic_save(sd, os.path.join(base, f"{stem}_{epoch}{ext}"))
        return tuple(paths)

    return _lead_writes(state, write)


def load_generator_params(ckpt_dir: Optional[str], name: str,
                          fallback_dir: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """A generator's state_dict, ``name`` (e.g. ``gen_diffusive_1.pt``)
    under ``ckpt_dir``, else under ``fallback_dir`` (reference
    test.py:215-232)."""
    return torch.load(checkpoint_path(ckpt_dir, name, fallback_dir), map_location="cpu",
                      weights_only=True)
