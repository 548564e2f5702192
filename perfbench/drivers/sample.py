"""Serving: a closed loop of batched sampler calls, one client.

Set-up builds the port's sampler (``mudiff_torch.build_sampler``) with the
traffic's attention lowering and serving mode, loads the run's seeded
weights into G1 and G2, makes a pool of phantom slices on the device,
calibrates static int8 scales where the mode asks (``calibrate_sampler``
over seeded batches, as ``--int8_static`` users do), and serves
``warmup_requests`` requests.  The window then sends request after
request: each takes the next ``batch`` slices of a seeded permutation of
the pool and draws its ``x_init`` and per-step noise on the device from
a seed of its own, and the client waits for its x_0 before it sends the
next.  The window closes at the synchronise after the last request that
started before ``--seconds`` ran out.

``sample_slices_per_s`` is the slices completed over the window's wall
time; ``peak_mem_gib`` the device's allocation peak over the window.
The traced run profiles ``trace_requests`` requests instead.

The check: ``compare_requests`` requests drawn from the seed among those
the window finished are sampled again by the plain reference from the
same inputs (in float32, or, in the int8 modes, with the reference's own
calibration over the same calibration batches), and the served x_0 is
compared with it slice by slice.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.arith import sample_work
from perfbench.core import Ctx, Outcome
from perfbench.drivers import common
from perfbench.inputs.phantom import condition_pool
from perfbench.reference import diffusion
from perfbench.reference.ops import Exact, Quantized
from perfbench.trace import TraceView, families, span, traced

POOL, PERM, REQUEST, CALIB = 1, 2, 3, 4


class Inputs:
    """The run's seeded inputs: the slice pool, its order, and each
    request's draws."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device):
        self.cfg, self.tr, self.seed, self.device = cfg, tr, seed, device
        self.batch = int(tr["batch"])
        size = cfg["image_size"]
        self.pool = condition_pool(common.sub_seed(seed, POOL), tr["pool_patients"],
                                   tr["pool_slices"], size, cfg["target_modality"], device)
        n = self.pool.shape[1]
        g = torch.Generator().manual_seed(common.sub_seed(seed, PERM))
        self.perm = torch.randperm(n, generator=g).to(device)
        self.rows = torch.arange(self.batch, device=device)
        self.gen = torch.Generator(device)

    def request(self, i: int, tag: int = REQUEST):
        """(c1, c2, c3), x_init, [(z, noise)] * T of request ``i``."""
        cfg, b = self.cfg, self.batch
        idx = self.perm[torch.remainder(self.rows + i * b, self.perm.numel())]
        conds = tuple(self.pool[k].index_select(0, idx) for k in range(3))
        self.gen.manual_seed(common.sub_seed(self.seed, tag, i))
        shape = (b, cfg["image_size"], cfg["image_size"], 1)

        def normal(*s):
            return torch.randn(s, generator=self.gen, device=self.device, dtype=torch.float32)

        x_init = normal(*shape)
        noise = [(normal(b, cfg["nz"]), normal(*shape)) for _ in range(cfg["num_timesteps"])]
        return conds, x_init, noise


def _port_config(cfg: dict, int8: bool):
    from mudiff_torch.config import MuDiffConfig

    return MuDiffConfig.from_dict({**cfg, "use_int8": int8})


def _load(sampler, W) -> None:
    sampler.g1.load_state_dict(W["g1"])
    sampler.g2.load_state_dict(W["g2"])


def build(ctx: Ctx, inputs: Inputs, W, mode: str):
    """The port's sampler for ``mode`` (``bf16``, ``w8a8d``: dynamic int8,
    ``w8a8s``: static int8 calibrated here) with the run's weights."""
    from mudiff_torch.infer.calibrate import calibrate_sampler
    from mudiff_torch.sampler import build_sampler

    tr = ctx.traffic
    int8 = mode != "bf16"
    mcfg = _port_config(ctx.config, int8)
    kw = dict(device=ctx.device, attn=tr["attn"], compute_dtype=torch.bfloat16)
    sampler = build_sampler(mcfg, **kw)
    _load(sampler, W)
    if mode == "w8a8s":
        batches = [inputs.request(k, CALIB) for k in range(tr["calib_batches"])]
        calibs = calibrate_sampler(sampler.g1, sampler.g2, sampler.post,
                                   [c for c, _, _ in batches], mcfg.num_timesteps, mcfg.nz,
                                   compute_dtype=torch.bfloat16,
                                   draws=[(x, n) for _, x, n in batches])
        sampler = build_sampler(mcfg, int8_calibs=calibs, **kw)
        _load(sampler, W)
    return sampler


def serve(sampler, inputs: Inputs, i: int) -> torch.Tensor:
    conds, x_init, noise = inputs.request(i)
    return sampler(*conds, x_init=x_init, noise=noise)


def reference_calibration(cfg: dict, tr: dict, inputs: Inputs, W, levels: int = 127
                          ) -> Dict[str, torch.Tensor]:
    """The reference's own static scales: per-channel absmax at every
    routed conv over the calibration batches, under dynamic scales."""
    record: Dict[str, torch.Tensor] = {}
    prec = Quantized(levels, record=record)
    with torch.no_grad(), common.exact_fp32():
        for k in range(tr["calib_batches"]):
            conds, x, noise = inputs.request(k, CALIB)
            diffusion.sample(prec, cfg, W["g1"], W["g2"], conds, x, noise, int8=True)
    return record


def reference_sample(cfg: dict, prec, inputs: Inputs, W, i: int, rows: int,
                     int8: bool) -> torch.Tensor:
    """The reference's x_0 of request ``i``, ``rows`` rows at a time."""
    conds, x, noise = inputs.request(i)
    outs = []
    with torch.no_grad(), common.exact_fp32():
        for r in range(0, x.shape[0], rows):
            sl = slice(r, r + rows)
            outs.append(diffusion.sample(prec, cfg, W["g1"], W["g2"], [c[sl] for c in conds],
                                         x[sl], [(z[sl], e[sl]) for z, e in noise], int8=int8))
    return torch.cat(outs)


def compare(served: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """The served x_0 against the reference's: the mean squared
    difference (what the bf16 cells compare: in [-1, 1] units, it
    separates bf16 from W8A8 by the square of their RMS ratio), the mean
    |difference| (the W8A8 cell's), the largest, and the worst slice's
    root-mean-square difference over its own root mean square."""
    d = (served.float() - ref).reshape(ref.shape[0], -1)
    r = ref.reshape(ref.shape[0], -1)
    rel = d.norm(dim=1) / r.norm(dim=1).clamp_min(1e-12)
    return {"x0_max_abs": float(d.abs().max()), "x0_rel_rms": float(rel.max()),
            "x0_mean_abs": float(d.abs().mean()), "x0_mse": float(d.square().mean())}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    keys = readings[0].keys()
    return {k: max(r[k] for r in readings) for k in keys}


def check(ctx: Ctx, inputs: Inputs, W, outs: Dict[int, torch.Tensor], mode: str,
          ref_prec=None) -> Dict[str, float]:
    """Readings of ``compare_requests`` seeded picks among ``outs``."""
    tr, cfg = ctx.traffic, ctx.config
    done = sorted(outs)
    g = torch.Generator().manual_seed(common.sub_seed(ctx.seed, 9))
    k = min(int(tr["compare_requests"]), len(done))
    picks = [done[j] for j in torch.randperm(len(done), generator=g)[:k].tolist()]
    int8 = mode != "bf16"
    if ref_prec is None:
        ref_prec = (Quantized(127, absmax=reference_calibration(cfg, tr, inputs, W))
                    if mode == "w8a8s" else Exact())
    readings = [compare(outs[i], reference_sample(cfg, ref_prec, inputs, W, i,
                                                  int(tr["ref_rows"]), int8)) for i in picks]
    return worst(readings)


def run(ctx: Ctx) -> Outcome:
    common.check_world()
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    mode = tr["mode"]
    out = Outcome()
    ph = out.phases
    ph["start"] = common.now() - ctx.t0
    with span("setup"):
        with common.phase(ph, "kernels"):
            common.build_kernels(dev)
        with common.phase(ph, "inputs"):
            W = common.weights(cfg, ctx.seed, dev)
            inputs = Inputs(cfg, tr, ctx.seed, dev)
            common.sync(dev)
        with common.phase(ph, "build"):
            sampler = build(ctx, inputs, W, mode)
            common.sync(dev)
        with common.phase(ph, "warmup"):
            for k in range(int(tr["warmup_requests"])):
                serve(sampler, inputs, -1 - k)
            common.sync(dev)
    out.metrics["setup_s"] = common.now() - ctx.t0
    common.reset_peak(dev)
    outs: Dict[int, torch.Tensor] = {}
    b = inputs.batch
    if ctx.trace:
        holder: dict = {}
        with traced(holder):
            for i in range(int(tr["trace_requests"])):
                with span("request"):
                    outs[i] = serve(sampler, inputs, i)
                    common.sync(dev)
        from perfbench.peaks import peaks_for

        slices = len(outs) * b
        out.trace = TraceView("sample", holder["kernels"], holder["window_s"], slices,
                              sample_work(cfg, mode != "bf16").scaled(slices),
                              peaks_for(torch.cuda.get_device_name(0)), families(ctx.root),
                              holder["gaps"])
    else:
        t = common.now()
        i = 0
        while True:
            outs[i] = serve(sampler, inputs, i)
            common.sync(dev)
            i += 1
            if common.now() - t >= ctx.seconds:
                break
        elapsed = common.now() - t
        out.metrics["sample_slices_per_s"] = len(outs) * b / elapsed
    out.memory_peak_bytes = common.peak_bytes(dev)
    out.metrics["peak_mem_gib"] = out.memory_peak_bytes / common.GIB
    out.attempted = len(outs)
    del sampler
    common.free(dev)
    with common.phase(ph, "check"):
        out.readings = check(ctx, inputs, W, outs, mode)
    return out
