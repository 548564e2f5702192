"""Operations and bytes of the model's work, from the configuration's
shapes alone.

The reference forward runs on meta tensors under ``ops.Counting``, which
records every conv, dense layer and attention product; nothing of the
program is read, so a PR that moves a conv between kernels cannot make
the count stale.  Conventions:

* an operation is a multiply or an add: a product of (m, k) by (k, n) is
  2 m k n;
* a backward counts twice its forward, except a pass whose gradient
  only flows through to the input (the critic's in the G step: once);
  R1's double backward adds three times the critic's real-pass forward
  (the gradient to the input, then its backward to both);
* a remat recompute is not counted;
* bytes are those of one pass through memory: each input read once,
  the weights read once, the output written once, at the widths the
  cell computes in (bf16 activations and weights, int8 weights at the
  int8-routed convs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from perfbench.reference import model
from perfbench.reference.ops import Counting


@dataclass
class Work:
    """Operations split by the peak they run at, and the convs' bounds."""

    ops_bf16: float = 0.0
    ops_int8: float = 0.0
    # per conv launch: (operations, bytes, int8?)
    convs: List[Tuple[float, float, bool]] = field(default_factory=list)

    def scaled(self, k: float) -> "Work":
        return Work(self.ops_bf16 * k, self.ops_int8 * k,
                    [(o * k, b * k, q) for o, b, q in self.convs])

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops_bf16 + other.ops_bf16, self.ops_int8 + other.ops_int8,
                    self.convs + other.convs)


def _work(ops: List[Tuple], act_bytes: int = 2) -> Work:
    w = Work()
    for op in ops:
        if op[0] == "conv":
            _, b, hi, wi, ho, wo, cin, cout, k, routed = op
            n = 2.0 * b * ho * wo * cin * cout * k * k
            w_bytes = 1 if routed else act_bytes
            byts = (b * hi * wi * cin * act_bytes + k * k * cin * cout * w_bytes
                    + b * ho * wo * cout * act_bytes)
            w.convs.append((n, float(byts), routed))
            if routed:
                w.ops_int8 += n
            else:
                w.ops_bf16 += n
        elif op[0] == "linear":
            _, rows, i, o = op
            w.ops_bf16 += 2.0 * rows * i * o
        else:
            _, batch, m, k, n = op
            w.ops_bf16 += 2.0 * batch * m * k * n
    return w


def _meta(*shape):
    return torch.zeros(shape, device="meta")


def _params(specs: Dict[str, Tuple[int, ...]]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s, device="meta") for k, s in specs.items()}


def generator_ops(cfg: dict, batch: int, adaptive: bool, int8: bool) -> List[Tuple]:
    """The recorded products of one G1 (or G2) forward at ``batch``."""
    s = cfg["image_size"]
    prec = Counting(routed_sites=int8)
    x = _meta(batch, s, s, 1)
    t = torch.zeros(batch, dtype=torch.int64, device="meta")
    z = _meta(batch, cfg["nz"])
    P = _params(model.generator_specs(cfg, adaptive))
    model.generator(prec, cfg, P, x, x, x, x, t, z, pseudo=x if adaptive else None, int8=int8)
    return prec.ops


def critic_ops(cfg: dict, batch: int) -> List[Tuple]:
    s = cfg["image_size"]
    prec = Counting()
    x = _meta(batch, s, s, 1)
    t = torch.zeros(batch, dtype=torch.int64, device="meta")
    model.critic(prec, cfg, _params(model.critic_specs(cfg)), x, t, x)
    return prec.ops


def sample_work(cfg: dict, int8: bool) -> Work:
    """The work of one sampled slice: T steps of G1 then G2."""
    g = _work(generator_ops(cfg, 1, False, int8)) + _work(generator_ops(cfg, 1, True, int8))
    return g.scaled(cfg["num_timesteps"])


def train_work(cfg: dict, batch: int, with_r1: bool) -> Work:
    """The work of one training iteration (D step then G step) at ``batch``."""
    gens = _work(generator_ops(cfg, batch, False, False)) + _work(
        generator_ops(cfg, batch, True, False))
    crit = _work(critic_ops(cfg, batch))
    d_step = gens + crit.scaled(3 * 3)          # G1+G2 forward; 3 critic passes fwd + bwd
    if with_r1:
        d_step = d_step + crit.scaled(3)
    g_step = gens.scaled(3) + crit.scaled(2 * 2)  # 2 critic passes fwd + input gradient
    return d_step + g_step
