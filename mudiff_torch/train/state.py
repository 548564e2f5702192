"""Training state: G1, G2 and the critic, three Adam optimizers, EMA, and
the frozen attention projection.

The port of ``mudiff_tpu/train/state.py``.  The JAX package keeps one
immutable pytree; here ``TrainState`` holds the modules and updates them
in place (``torch.optim.Adam``), which keeps one copy of each parameter
and moment on the card.  The parity decisions are the JAX package's:

* ``att_conv``, the 1x1 conv (ngf*8 -> 1) of the critic's mid features
  into an attention logit, is drawn once from the seed and never trained
  (reference engine/train.py:466): a float32 buffer in no optimizer.
* EMA is a lerp ``decay * shadow + (1 - decay) * params`` after each
  generator update (``state.py:84-91``).
* The learning rate is torch's CosineAnnealingLR stepped once per epoch
  with eta_min 1e-5 (``state.py:44-59``), set before each update from
  that optimizer's own count of updates, as optax's schedule reads its
  count.  Adam has betas (beta1, beta2) and eps 1e-8, as ``optax.adam``.

On a mesh (``parallel/mesh.py``) with fsdp > 1, each parameter that
``param_spec`` shards is kept at rest as this rank's slice, and Adam
updates the slice and its moments (the JAX loop shards ``params_*`` and
``opt_*``, ``loop.py:145-153``).  ``materialize`` all-gathers the whole
parameters into the modules before a forward; an update leaves the
module's whole copy stale and frees it.  The EMA shadows stay whole on
every rank, as ``ema_g*`` stay unsharded there.  With fsdp 1 nothing is
sharded and the modules hold their parameters throughout.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mudiff_torch.config import MuDiffConfig
from mudiff_torch.diffusion.schedule import DiffusionCoefficients, PosteriorCoefficients
from mudiff_torch.models import DiscriminatorLarge, NCSNppGenerator
from mudiff_torch.nn.initializers import stylegan_dense_init
from mudiff_torch.parallel.mesh import (Mesh, average_grads, gather_shards, param_spec,
                                        reduce_scatter_grads, shard)
from mudiff_torch.sampler import serving_device

MODULES = ("g1", "g2", "d")


def cosine_epoch_schedule(base_lr: float, num_epoch: int, steps_per_epoch: int,
                          eta_min: float = 1e-5,
                          enabled: bool = True) -> Callable[[int], float]:
    """torch CosineAnnealingLR(T_max=num_epoch) stepped per epoch."""

    def schedule(step: int) -> float:
        if not enabled:
            return base_lr
        epoch = min(step // steps_per_epoch, num_epoch)
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * epoch / num_epoch))

    return schedule


class AttConv(nn.Module):
    """The frozen random 1x1 projection (reference engine/train.py:466:
    conv2d(64*8, 1, 1), sdeflow init, never trained).  Its weight is
    ``(1, C)`` and its bias ``(1,)``, float32 buffers."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.channels = channels
        self.register_buffer("weight", torch.zeros(1, channels, device=device))
        self.register_buffer("bias", torch.zeros(1, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        stylegan_dense_init(1.0)(self.weight, self.channels, 1, generator)
        self.bias.zero_()

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """(B, h, w, C) -> (B, h, w, 1) float32."""
        return F.linear(feat.to(torch.float32), self.weight) + self.bias


class ShardedParams:
    """One module's parameters on the fsdp axis: ``axes`` (each one's
    ``param_spec``, None: replicated) and ``tensors``, what Adam updates
    (this rank's slice of a sharded parameter, the parameter itself
    otherwise); ``whole`` says whether the module holds them all now."""

    def __init__(self, module: nn.Module, mesh: Optional[Mesh]):
        self.params = list(module.parameters())
        self.shapes = [p.shape for p in self.params]
        fsdp = mesh.fsdp if mesh is not None else 1
        self.axes = [param_spec(p.shape, fsdp) for p in self.params]
        self.mesh = mesh
        self.tensors = [shard(p.detach(), a, mesh) for p, a in zip(self.params, self.axes)]
        self.sharded = any(a is not None for a in self.axes)
        self.whole = True

    def materialize(self) -> None:
        """All-gather the whole parameters into the module (a collective
        over the fsdp group when it is stale)."""
        if self.whole:
            return
        for p, a, t in zip(self.params, self.axes, gather_shards(self.tensors, self.axes,
                                                                  self.mesh)):
            if a is not None:
                p.data = t
        self.whole = True

    def release(self) -> None:
        """Free the module's whole copy of each sharded parameter."""
        if not self.sharded:
            return
        for p, a in zip(self.params, self.axes):
            if a is not None:
                p.data = p.data.new_empty(0)
        self.whole = False

    def reshard(self) -> None:
        """Take this rank's slices from the module's whole parameters."""
        with torch.no_grad():
            for p, a, t in zip(self.params, self.axes, self.tensors):
                if a is not None:
                    t.copy_(shard(p.detach(), a, self.mesh))

    def whole_tensors(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors of per-parameter ``tensors`` laid out like
        ``self.tensors`` (Adam's moments), gathered over the fsdp group."""
        return gather_shards(tensors, self.axes, self.mesh)


class TrainState:
    """G1, G2, the critic D, their optimizers and EMA shadows, the frozen
    ``att_conv`` and the diffusion tables, on one device.  ``step`` counts
    G updates, as the JAX state's ``step``.  ``mesh`` (default None, one
    process) is the process mesh the steps sync over."""

    def __init__(self, config: MuDiffConfig, g1: NCSNppGenerator, g2: NCSNppGenerator,
                 d: DiscriminatorLarge, att_conv: AttConv, steps_per_epoch: int,
                 device: torch.device, mesh: Optional[Mesh] = None):
        self.config = config
        self.device = device
        self.mesh = mesh
        self.g1, self.g2, self.d, self.att_conv = g1, g2, d, att_conv
        d.mesh = mesh
        self.step = 0
        self.sharded = {name: ShardedParams(getattr(self, name), mesh) for name in MODULES}

        def adam(module, lr):
            return torch.optim.Adam(self.sharded[module].tensors, lr=lr,
                                    betas=(config.beta1, config.beta2), eps=1e-8)

        self.opt_g1, self.opt_g2 = adam("g1", config.lr_g), adam("g2", config.lr_g)
        self.opt_d = adam("d", config.lr_d)
        enabled = not config.no_lr_decay
        self.schedule_g = cosine_epoch_schedule(config.lr_g, config.num_epoch,
                                                steps_per_epoch, enabled=enabled)
        self.schedule_d = cosine_epoch_schedule(config.lr_d, config.num_epoch,
                                                steps_per_epoch, enabled=enabled)
        self.counts = {"g1": 0, "g2": 0, "d": 0}
        self.use_ema, self.ema_decay = config.use_ema, config.ema_decay
        self.ema_g1 = self._shadow(g1) if config.use_ema else None
        self.ema_g2 = self._shadow(g2) if config.use_ema else None
        self.coeff = DiffusionCoefficients.from_config(config).as_tensors(device)
        self.pos_coeff = PosteriorCoefficients.from_config(config).as_tensors(device)
        self.release()

    @staticmethod
    def _shadow(module: nn.Module) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in module.named_parameters()}

    def materialize(self, names: Sequence[str] = MODULES) -> None:
        """The modules ``names`` hold their whole parameters (with fsdp a
        collective: every rank calls it at the same point)."""
        for name in names:
            self.sharded[name].materialize()

    def release(self) -> None:
        """Back to rest: each sharded parameter as this rank's slice."""
        for name in MODULES:
            self.sharded[name].release()

    def param_count(self, name: str) -> int:
        """Elements of a module's parameters (whole, whatever is held)."""
        return sum(math.prod(s) for s in self.sharded[name].shapes)

    def sync_grads(self, name: str, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """A module's per-rank gradients (``parameters()`` order) made the
        global batch's: reduce-scattered over the fsdp group to this rank's
        slices, then averaged over the data group.  Without a mesh they
        come back as they are."""
        return average_grads(reduce_scatter_grads(grads, self.sharded[name].axes, self.mesh),
                             self.mesh)

    def _adam(self, name: str, opt: torch.optim.Optimizer,
              schedule: Callable[[int], float], grads: List[torch.Tensor]) -> None:
        lr = schedule(self.counts[name])
        for group in opt.param_groups:
            group["lr"] = lr
        sharded = self.sharded[name]
        params = sharded.tensors
        if len(grads) != len(params):
            raise ValueError(f"{name}: {len(grads)} gradients for {len(params)} parameters")
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        for p in params:
            p.grad = None
        sharded.release()  # the whole copy is stale
        self.counts[name] += 1

    def apply_g_updates(self, grads_g1: List[torch.Tensor],
                        grads_g2: List[torch.Tensor]) -> None:
        """Adam on G1 and G2 (gradients in ``parameters()`` order, synced),
        then the EMA lerp; advances ``step``.  The state is then at rest."""
        self._adam("g1", self.opt_g1, self.schedule_g, grads_g1)
        self._adam("g2", self.opt_g2, self.schedule_g, grads_g2)
        if self.use_ema:
            self.materialize(("g1", "g2"))
            d = self.ema_decay
            with torch.no_grad():
                for ema, module in ((self.ema_g1, self.g1), (self.ema_g2, self.g2)):
                    for n, p in module.named_parameters():
                        ema[n].mul_(d).add_(p, alpha=1.0 - d)
        self.release()
        self.step += 1

    def apply_d_updates(self, grads_d: List[torch.Tensor]) -> None:
        """Adam on D (gradients in ``parameters()`` order, synced)."""
        self._adam("d", self.opt_d, self.schedule_d, grads_d)

    def load_flax(self, converted: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Load ``convert.train_state_from_flax``'s output (strict)."""
        self.materialize()
        for name in ("g1", "g2", "d", "att_conv"):
            getattr(self, name).load_state_dict(converted[name], strict=True)
        for name in MODULES:
            self.sharded[name].reshard()
        if self.use_ema:
            self.ema_g1, self.ema_g2 = self._shadow(self.g1), self._shadow(self.g2)

    def kernel_launches_per_iteration(self, with_r1: bool = True) -> Dict[str, int]:
        """Kernel launches of one D step + G step, from the module structure.

        D step: G1 and G2 forward without a graph, three critic forwards
        (x_t, both fakes), and their backward to D's parameters: each
        critic FIR down is transposed by one FIR up.  With R1, the first
        backward (to x_t) runs one FIR up per FIR down of the real pass,
        and the second backward one FIR down per such FIR up.  G step: G1
        and G2 forward, two critic forwards, and the backward to G1's and
        G2's parameters: every K1 forward has its ``dx`` K1 launch and every
        FIR resample is transposed by the other one, except the launches
        whose inputs (x_{t+1}, conditions) need no gradient
        (``launches_off_the_gradient``: G1's first stem conv, with
        one-channel images); every K3 forward has one dkv and one dq launch;
        K5 runs in the forwards only (its backward is plain PyTorch).
        """
        gens = (self.g1, self.g2)
        fwd = [g.kernel_launches_per_forward() for g in gens]
        off = [g.launches_off_the_gradient() for g in gens]
        f = {k: fwd[0][k] + fwd[1][k] for k in fwd[0]}
        b = {k: f[k] - off[0][k] - off[1][k] for k in f}  # transposed in the G step
        cd = self.d.kernel_launches_per_forward()["fir_down2"]
        r1 = cd if with_r1 else 0
        counts = dict.fromkeys(f, 0)
        counts["conv3x3"] = 2 * f["conv3x3"] + b["conv3x3"]
        counts["fir_down2"] = 2 * f["fir_down2"] + b["fir_up2"] + 5 * cd + r1
        counts["fir_up2"] = 2 * f["fir_up2"] + b["fir_down2"] + 5 * cd + r1
        counts["flash_attn"] = 2 * f["flash_attn"]
        counts["flash_attn_bwd_dkv"] = counts["flash_attn_bwd_dq"] = f["flash_attn"]
        counts["group_norm_act"] = 2 * f["group_norm_act"]
        return counts


def create_train_state(config: MuDiffConfig, seed: int = 0, steps_per_epoch: int = 1,
                       device=None, attn: str = "einsum",
                       mesh: Optional[Mesh] = None) -> TrainState:
    """G1, G2, the critic and ``att_conv`` drawn from the JAX package's
    initial distributions with ``seed`` (a CPU generator, in that order),
    on ``device`` (default ``"cuda"``, or the ``mesh``'s; raises without
    a card).  Compute in bf16 when ``config.use_bf16``, else fp32;
    parameters fp32.  ``attn`` is the generators' attention lowering
    (``"flash"``: K3).  Every rank draws the same weights."""
    device = mesh.device if mesh is not None else serving_device(device, "create_train_state")
    dtype = torch.bfloat16 if config.use_bf16 else torch.float32
    gen = torch.Generator().manual_seed(seed)
    g1 = NCSNppGenerator(config, attn=attn, dtype=dtype, generator=gen)
    g2 = NCSNppGenerator(config, adaptive=True, attn=attn, dtype=dtype, generator=gen)
    d = DiscriminatorLarge(ngf=config.ngf, t_emb_dim=config.t_emb_dim,
                           fir_kernel=config.fir_kernel, num_channels=config.num_channels,
                           dtype=dtype, generator=gen)
    att_conv = AttConv(config.ngf * 8)
    att_conv.reset_parameters(gen)
    modules = [m.to(device).train() for m in (g1, g2, d, att_conv)]
    return TrainState(config, *modules, steps_per_epoch=steps_per_epoch, device=device,
                      mesh=mesh)
