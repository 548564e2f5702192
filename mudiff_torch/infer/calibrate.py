"""Static int8 calibration for the sampler: record, build, save, load.

The port of ``mudiff_tpu/infer/calibrate.py``.  ``calibrate_sampler``
runs the reverse sampler over calibration batches and records, at every
int8-routed conv of G1 and G2, the per-input-channel absmax of its
input, maxed over batches x steps and scaled by ``margin``: one
``Int8Calib`` per generator.  Serving with it replaces the per-example
absmax reduction of every routed conv by constant per-channel scales
folded into the weights.  The JSON sidecars are the JAX package's
(version 2), so one sidecar serves both packages.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional, Sequence, Tuple

import torch

from mudiff_torch.diffusion.sampling import sample_posterior_combine
from mudiff_torch.ops.int8_conv import Int8Calib, record_scope

Draw = Tuple[torch.Tensor, Sequence[Tuple[torch.Tensor, torch.Tensor]]]


def _check_recordable(*gens) -> None:
    for g in gens:
        if not g.config.use_int8 or g.int8_calib is not None or g.training:
            raise ValueError("calibration records with int8 generators (config.use_int8) "
                             "in inference mode and without a calibration")


def _build(sites, store, min_ch: int, stems: bool, margin: float) -> Int8Calib:
    assert len(sites) == len(store), (len(sites), len(store))
    return Int8Calib(
        min_ch=int(min_ch), stems=bool(stems),
        sites=tuple((ci, co, tuple(float(v) * margin for v in a.tolist()))
                    for (ci, co), a in zip(sites, store)))


@torch.inference_mode()
def calibrate_sampler(
    g1, g2, post, cond_batches: Iterable[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    num_timesteps: int, nz: int, *, compute_dtype: torch.dtype = torch.bfloat16,
    margin: float = 1.0, generator: Optional[torch.Generator] = None,
    draws: Optional[Iterable[Draw]] = None,
) -> Tuple[Int8Calib, Int8Calib]:
    """Record the per-site activation ranges of both generators over the
    4-step sampler (``mudiff_tpu/infer/calibrate.py:39-143``).

    ``g1`` / ``g2`` serve int8 with dynamic scales (``config.use_int8``,
    no calibration); ``post`` holds the posterior tables as tensors on
    their device.  Each batch of ``cond_batches`` is three NHWC condition
    tensors.  The initial sample and the per-step ``(z, posterior
    noise)`` come from ``draws`` (one ``(x_init, noise)`` per batch, as
    ``Sampler.__call__`` takes them), else from ``generator``.  The
    result carries the generators' routing threshold and stems bit, read
    before the first batch (both are fixed when a generator is built).
    """
    _check_recordable(g1, g2)
    min_ch, stems = g1.int8_min_ch, g1.int8_stems
    if (g2.int8_min_ch, g2.int8_stems) != (min_ch, stems):
        raise ValueError("G1 and G2 route differently: "
                         f"{(min_ch, stems)} vs {(g2.int8_min_ch, g2.int8_stems)}")
    draws = iter(draws) if draws is not None else None
    sites = {"g1": None, "g2": None}
    store = {"g1": [], "g2": []}

    def accumulate(name, recs):
        sites[name] = [(ci, co) for ci, co, _ in recs]
        vals = [a.detach().to("cpu", torch.float32) for _, _, a in recs]
        if not store[name]:
            store[name].extend(vals)
        else:
            for acc, v in zip(store[name], vals):
                torch.maximum(acc, v, out=acc)

    n_batches = 0
    for c1, c2, c3 in cond_batches:
        n_batches += 1
        device = c1.device
        batch = c1.shape[0]
        if draws is None:
            x = torch.randn(c1.shape, generator=generator, device=device, dtype=torch.float32)
            noise = None
        else:
            x, noise = next(draws)
            x = x.to(torch.float32)
        conds = [c.to(compute_dtype) for c in (c1, c2, c3)]
        for step, i in enumerate(range(num_timesteps - 1, -1, -1)):
            t = torch.full((batch,), i, dtype=torch.int64, device=device)
            if noise is None:
                z = torch.randn((batch, nz), generator=generator, device=device,
                                dtype=torch.float32)
                eps = torch.randn(x.shape, generator=generator, device=device,
                                  dtype=torch.float32)
            else:
                z, eps = noise[step]
            xc = x.to(compute_dtype)
            rec1, rec2 = [], []
            with record_scope(rec1):
                x0_1 = g1(xc, *conds, t, z)
            with record_scope(rec2):
                x0_2 = g2(xc, *conds, t, z, x0_1)
            x = sample_posterior_combine(post, x0_1.to(torch.float32),
                                         x0_2.to(torch.float32), x, t, eps)
            accumulate("g1", rec1)
            accumulate("g2", rec2)
    if n_batches == 0:
        raise ValueError("calibration needs at least one batch")
    return (_build(sites["g1"], store["g1"], min_ch, stems, margin),
            _build(sites["g2"], store["g2"], min_ch, stems, margin))


@torch.inference_mode()
def synthetic_calib(model) -> Int8Calib:
    """A unit-scale calibration with the model's real site list
    (``mudiff_tpu/infer/calibrate.py:146-170``): one batch-1 forward on
    zeros at the config's image size, on the model's device, recorded.
    Every absmax is 1.0: the compute is that of a real calibration, which
    is what a throughput measurement needs; never use it for quality."""
    _check_recordable(model)
    cfg = model.config
    p = next(model.parameters())
    x = torch.zeros((1, cfg.image_size, cfg.image_size, cfg.num_channels),
                    dtype=torch.float32, device=p.device)
    t = torch.zeros((1,), dtype=torch.int64, device=p.device)
    z = torch.zeros((1, cfg.nz), dtype=torch.float32, device=p.device)
    sink: list = []
    with record_scope(sink):
        model(x, x, x, x if model.num_conditions == 3 else None, t, z,
              *([x] if model.adaptive else []))
    return Int8Calib(min_ch=int(model.int8_min_ch), stems=bool(model.int8_stems),
                     sites=tuple((ci, co, (1.0,) * ci) for ci, co, _ in sink))


def save_calib(path: str, calib: Int8Calib) -> str:
    with open(path, "w") as f:
        json.dump(calib.to_json_dict(), f)
    return path


def load_calib(path: str) -> Int8Calib:
    with open(path) as f:
        return Int8Calib.from_json_dict(json.load(f))


def calib_sidecar_paths(ckpt_dir: str) -> Tuple[str, str]:
    """The sidecars' places beside the generator checkpoints."""
    base = os.path.abspath(ckpt_dir)
    return (os.path.join(base, "int8_calib_g1.json"),
            os.path.join(base, "int8_calib_g2.json"))
