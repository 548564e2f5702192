"""The adversarial training steps: D step (with lazy R1) and G step.

The port of ``mudiff_tpu/train/steps.py:65-323``; the loss wiring is the
reference's (engine/train.py:765-1037):

D step:
  t ~ U[0, T);  (x_t, x_{t+1}) = q_sample_pairs(real)
  errD_real  = softplus(-D(x_t, t, x_{t+1})).mean()
  R1         = (r1_gamma / 2) E[ ||d sum D(x_t) / d x_t||^2 ]  (create_graph,
               so the penalty's gradient reaches D's parameters)
  fakes: x0_i from G1 / G2 without a graph, posterior-sampled;
  errD_fake  = softplus(D(fake_1)).mean() + softplus(D(fake_2)).mean()
G step (fresh draws):
  x0_1 = G1(x_{t+1}, c1, c2, c3, t, z); x0_2 = G2(..., pseudo=x0_1);
  pos_i = sample_posterior(x0_i, x_{t+1}, t);
  (logit_i, feat_i) = D(pos_i, t, x_{t+1});
  att_i = bilinear_resize(sigmoid(att_conv(feat_i)));
  mask = mean(att_2 * BCE(pos_1, sigmoid(pos_2))) + mean(att_1 * BCE(pos_2, sigmoid(pos_1)))
  errG = adv + lambda_l1 * L1 + lambda_mask * mask
  (lambda_adv is parsed but never applied, as in the reference.)

As in the JAX package, each step is a loss-and-grad function
(``d_loss_and_grads``, ``g_loss_and_grads``; gradients in
``parameters()`` order) plus the update, so a test can read the
gradients.  Two quirks of the JAX package are kept:
* R1's "fp32 re-run" (``steps.py:96-103``) casts x_t to fp32, but the
  critic casts its inputs back to its compute dtype, so under bf16 the
  R1 pass is the real pass.  The port takes the penalty's gradient from
  the real pass itself: the same values, one critic forward less.
* ``jax.image.resize(method="bilinear")`` upsampling 32 -> 256 is
  ``F.interpolate(mode="bilinear", align_corners=False)``'s weights
  (half-pixel centres, the edge value repeated), applied as two matrix
  products so the backward is deterministic (``bilinear_resize``).

The D and G steps compute their gradients with cuDNN restricted to its
deterministic algorithms (``deterministic_cudnn``), and the resize is
two matrix products, so a step repeats its bits on the card, as the JAX
package's compiled step does.

The random draws of each step (``TrainDraws``) come from a
``torch.Generator`` on the device or are injected.  With dropout they
hold one seed per resblock of each generator, drawn before the forward,
so a rematted region recomputes the masks it drew (``nn/remat.py``).

On a mesh (``state.mesh``, ``parallel/mesh.py``) each rank runs its
rows of the global batch.  The draws are made for the global batch on
every rank from the same generator and sliced to the rank's rows
(``TrainDraws.draw``), so any world size draws what one process draws on
the whole batch, as ``jax.random`` does over a sharded array.  The
losses are per-rank means; between ``*_loss_and_grads`` and the update
the gradients go through ``TrainState.sync_grads`` (the mean over the
data group, the reduce-scatter over the fsdp group), and the losses the
steps return are data-group means.  The critic's stddev feature couples
the ranks' rows; its gather's backward sums each rank's gradient of its
rows over the group, so the synced gradient is the global batch's, R1's
``grad_x`` included (every rank's logits reach it, as ``jax.grad`` of the
global sum does, ``steps.py:96-109``).

Remat (``use_grad_checkpoint``): the generators remat their own regions
(``models/generator.py``); under the ``"blocks"`` policy the G step
also remats each critic forward (``mudiff_tpu/train/steps.py:172-192``).
The D step's critic passes never are: R1's grad-of-grad runs on the
kept activations, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mudiff_torch.config import MuDiffConfig
from mudiff_torch.diffusion.sampling import q_sample_pairs, sample_posterior
from mudiff_torch.models.generator import resblock_count
from mudiff_torch.nn import remat
from mudiff_torch.parallel.mesh import Mesh, average_scalars, rows_of
from mudiff_torch.train.state import TrainState
from mudiff_torch.utils.profiling import span

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass
class TrainDraws:
    """The random numbers of one D or G step: ``t`` (B,) int64, the
    pair's two noises (``noise_t`` for x_t, ``noise_tp1`` for x_{t+1}),
    ``z`` (B, nz) and the two posterior noises, all float32; with
    ``config.dropout > 0`` the dropout seeds of G1's and G2's resblocks
    (``resblock_count`` each, drawn after the rest), else None; on a mesh
    ``dropout_rows`` = (global batch, this rank's first row)."""

    t: torch.Tensor
    noise_t: torch.Tensor
    noise_tp1: torch.Tensor
    z: torch.Tensor
    noise_post1: torch.Tensor
    noise_post2: torch.Tensor
    dropout_g1: Optional[Sequence[int]] = None
    dropout_g2: Optional[Sequence[int]] = None
    dropout_rows: Optional[Tuple[int, int]] = None

    @classmethod
    def draw(cls, config: MuDiffConfig, real: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             mesh: Optional[Mesh] = None) -> "TrainDraws":
        """The draws of a step on ``real``, this rank's rows; with a
        ``mesh`` drawn for the global batch (``real``'s rows x dp)."""
        dev = real.device
        n = real.shape[0] * (mesh.dp if mesh is not None else 1)
        rows = rows_of(n, mesh)
        shape = (n, *real.shape[1:])

        def normal(shape):
            return torch.randn(shape, generator=generator, device=dev,
                               dtype=torch.float32)[rows]

        t = torch.randint(0, config.num_timesteps, (n,), generator=generator, device=dev)[rows]
        out = cls(t, normal(shape), normal(shape), normal((n, config.nz)), normal(shape),
                  normal(shape))
        if config.dropout > 0:
            seeds = torch.randint(0, 2**62, (2, resblock_count(config)), generator=generator,
                                  device=dev).tolist()
            out.dropout_g1, out.dropout_g2 = seeds
            if mesh is not None:
                out.dropout_rows = (n, rows.start)
        return out


def _softplus_mean(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x).mean()


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCEWithLogitsLoss(reduction='none') in its stable form."""
    return F.softplus(logits) - logits * targets


@functools.lru_cache(maxsize=16)
def _interpolation_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_out, n_in) float32 weights of 1-D half-pixel linear
    interpolation, as ``F.interpolate(align_corners=False)`` computes them:
    source ``(i + 0.5) * n_in / n_out - 0.5`` clamped at 0, the edge sample
    repeated."""
    scale = np.float32(n_in / n_out)
    src = np.maximum((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * scale
                     - np.float32(0.5), np.float32(0.0))
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    lam = src - i0.astype(np.float32)
    rows = np.arange(n_out)
    m = np.zeros((n_out, n_in), np.float32)
    np.add.at(m, (rows, i0), np.float32(1.0) - lam)
    np.add.at(m, (rows, np.minimum(i0 + 1, n_in - 1)), lam)
    return torch.from_numpy(m).to(device)


def bilinear_resize(x: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    """(B, h, w, C) -> (B, H, W, C), half-pixel bilinear (upsampling), in
    fp32 and rounded once to ``x``'s dtype.

    Two fixed interpolation-matrix products, H then W, so the forward and
    the backward are matmuls and repeat their bits; the backward of
    ``F.interpolate`` on the card accumulates with atomics."""
    a_h = _interpolation_matrix(x.shape[1], int(hw[0]), x.device)
    a_w = _interpolation_matrix(x.shape[2], int(hw[1]), x.device)
    y = torch.matmul(torch.matmul(a_h, x.permute(0, 3, 1, 2).float()), a_w.t())
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _grads(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d params; a parameter the loss does not reach gets zeros
    (as ``jax.grad`` gives), so Adam still decays its moments."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def critic_remat(config: MuDiffConfig) -> bool:
    """Whether the G step remats the critic: under the ``"blocks"``
    policy only (``mudiff_tpu/train/steps.py:182-185``)."""
    return config.use_grad_checkpoint and config.grad_checkpoint_policy == "blocks"


def d_loss_and_grads(state: TrainState, batch: Batch, draws: TrainDraws,
                     with_r1: bool) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The D step's gradients (``state.d.parameters()`` order) and losses."""
    cfg = state.config
    state.materialize()
    c1, c2, c3, real = batch
    b, t = real.shape[0], draws.t
    with span("train.d_step.real"):
        x_t, x_tp1 = q_sample_pairs(state.coeff, real, t, draws.noise_t, draws.noise_tp1)
        if with_r1:
            x_t.requires_grad_(True)
        logit_real, _ = state.d(x_t, t, x_tp1)
        err_real = _softplus_mean(-logit_real)
    if with_r1:
        with span("train.d_step.r1"):
            (grad_x,) = torch.autograd.grad(logit_real.sum(), x_t, create_graph=True)
            per_sample = grad_x.reshape(b, -1).square().sum(dim=1)
            penalty = (cfg.r1_gamma / 2.0) * per_sample.mean()
    else:
        penalty = torch.zeros((), dtype=torch.float32, device=real.device)

    with span("train.d_step.fake"):
        with torch.no_grad():  # dropout active, as the JAX D step's train=True
            x0_g1 = state.g1(x_tp1, c1, c2, c3, t, draws.z, dropout_seeds=draws.dropout_g1,
                             dropout_rows=draws.dropout_rows)
            x0_g2 = state.g2(x_tp1, c1, c2, c3, t, draws.z, pseudo_target=x0_g1,
                             dropout_seeds=draws.dropout_g2, dropout_rows=draws.dropout_rows)
        pos_g1 = sample_posterior(state.pos_coeff, x0_g1, x_tp1, t, draws.noise_post1)
        pos_g2 = sample_posterior(state.pos_coeff, x0_g2, x_tp1, t, draws.noise_post2)
        logit_f1, _ = state.d(pos_g1, t, x_tp1)
        logit_f2, _ = state.d(pos_g2, t, x_tp1)
        err_fake = _softplus_mean(logit_f1) + _softplus_mean(logit_f2)

    with span("train.d_step.grads"):
        total = err_real + penalty + err_fake
        grads = _grads(total, list(state.d.parameters()))
    aux = {"D_total": total, "D_real": err_real, "D_fake": err_fake, "R1": penalty}
    return grads, {k: v.detach() for k, v in aux.items()}


def g_forward(state: TrainState, batch: Batch, draws: TrainDraws) -> Dict[str, torch.Tensor]:
    """The G step's forward up to the losses: ``x0_g1`` / ``x0_g2`` (the
    generators' outputs), ``x_tp1``, the posterior samples ``pos_g1`` /
    ``pos_g2`` and the critic's ``logit_g*`` and mid features ``feat_g*``
    on each (``mudiff_tpu/train/steps.py:221-246``)."""
    state.materialize()
    c1, c2, c3, real = batch
    t = draws.t
    _, x_tp1 = q_sample_pairs(state.coeff, real, t, draws.noise_t, draws.noise_tp1)
    x0_g1 = state.g1(x_tp1, c1, c2, c3, t, draws.z, dropout_seeds=draws.dropout_g1,
                     dropout_rows=draws.dropout_rows)
    x0_g2 = state.g2(x_tp1, c1, c2, c3, t, draws.z, pseudo_target=x0_g1,
                     dropout_seeds=draws.dropout_g2, dropout_rows=draws.dropout_rows)
    pos_g1 = sample_posterior(state.pos_coeff, x0_g1, x_tp1, t, draws.noise_post1)
    pos_g2 = sample_posterior(state.pos_coeff, x0_g2, x_tp1, t, draws.noise_post2)
    if critic_remat(state.config):
        logit_g1, feat_g1 = remat.checkpointed("critic", state.d, pos_g1, t, x_tp1)
        logit_g2, feat_g2 = remat.checkpointed("critic", state.d, pos_g2, t, x_tp1)
    else:
        logit_g1, feat_g1 = state.d(pos_g1, t, x_tp1)
        logit_g2, feat_g2 = state.d(pos_g2, t, x_tp1)
    return {"x0_g1": x0_g1, "x0_g2": x0_g2, "x_tp1": x_tp1, "pos_g1": pos_g1,
            "pos_g2": pos_g2, "logit_g1": logit_g1, "logit_g2": logit_g2,
            "feat_g1": feat_g1, "feat_g2": feat_g2}


def mask_terms(att_conv: torch.nn.Module, fwd: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """The mask loss's factors on ``g_forward``'s outputs
    (``mudiff_tpu/train/steps.py:248-266``): the attention logits
    ``att_logit_g*`` (``att_conv`` of the critic's features, before the
    sigmoid), the maps ``att_g*`` (their sigmoid resized to the image),
    the BCE factors ``bce_1`` = BCE(pos_g1, sigmoid(pos_g2)) and ``bce_2``
    (the other way) and the two terms, mask = ``term_1`` + ``term_2`` with
    ``term_1`` = mean(att_g2 * bce_1)."""
    pos_g1, pos_g2 = fwd["pos_g1"], fwd["pos_g2"]
    hw = pos_g1.shape[1:3]
    out = {"att_logit_g1": att_conv(fwd["feat_g1"]), "att_logit_g2": att_conv(fwd["feat_g2"]),
           "bce_1": _bce_with_logits(pos_g1, torch.sigmoid(pos_g2)),
           "bce_2": _bce_with_logits(pos_g2, torch.sigmoid(pos_g1))}
    for i in ("g1", "g2"):
        out[f"att_{i}"] = bilinear_resize(torch.sigmoid(out[f"att_logit_{i}"]), hw)
    out["term_1"] = torch.mean(out["att_g2"] * out["bce_1"])
    out["term_2"] = torch.mean(out["att_g1"] * out["bce_2"])
    return out


def g_loss_and_grads(state: TrainState, batch: Batch, draws: TrainDraws
                     ) -> Tuple[Tuple[List[torch.Tensor], List[torch.Tensor]],
                                Dict[str, torch.Tensor]]:
    """The G step's gradients (G1's and G2's, ``parameters()`` order) and
    losses.  D's parameters get no gradient."""
    cfg = state.config
    real = batch[3]
    with span("train.g_step.forward"):
        fwd = g_forward(state, batch, draws)
    with span("train.g_step.mask"):
        mask = mask_terms(state.att_conv, fwd)
        mask_loss = mask["term_1"] + mask["term_2"]
        err_adv = _softplus_mean(-fwd["logit_g1"]) + _softplus_mean(-fwd["logit_g2"])
        err_l1 = (torch.mean(torch.abs(fwd["x0_g1"] - real))
                  + torch.mean(torch.abs(fwd["x0_g2"] - real)))
        total = err_adv + cfg.lambda_l1_loss * err_l1 + cfg.lambda_mask_loss * mask_loss

    p1, p2 = list(state.g1.parameters()), list(state.g2.parameters())
    with span("train.g_step.grads"):
        grads = _grads(total, p1 + p2)
    aux = {"G_total": total, "G_adv": err_adv, "G_L1": err_l1, "G_mask": mask_loss}
    return (grads[:len(p1)], grads[len(p1):]), {k: v.detach() for k, v in aux.items()}


@contextlib.contextmanager
def deterministic_cudnn():
    """While open, cuDNN picks among its deterministic algorithms only;
    the previous setting comes back after.  cuDNN's heuristic
    weight-gradient algorithm for some of the step's convs sums in a
    varying order, so without it two runs of one bf16 step differ in a
    few bits."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def make_d_step() -> Callable:
    """``d_step(state, batch, draws, with_r1) -> losses``: gradients
    (under ``deterministic_cudnn``), synced over the mesh, then Adam on D."""

    def d_step(state: TrainState, batch: Batch, draws: TrainDraws,
               with_r1: bool) -> Dict[str, torch.Tensor]:
        with span("train.d_step", {"step": state.step, "r1": bool(with_r1)}):
            with deterministic_cudnn():
                grads, aux = d_loss_and_grads(state, batch, draws, with_r1)
            with span("train.d_step.adam"):
                state.apply_d_updates(state.sync_grads("d", grads))
            return average_scalars(aux, state.mesh)

    return d_step


def make_g_step() -> Callable:
    """``g_step(state, batch, draws) -> losses``: gradients (under
    ``deterministic_cudnn``), synced over the mesh, then Adam on G1 and G2
    and the EMA."""

    def g_step(state: TrainState, batch: Batch, draws: TrainDraws) -> Dict[str, torch.Tensor]:
        with span("train.g_step", {"step": state.step}):
            with deterministic_cudnn():
                (grads_g1, grads_g2), aux = g_loss_and_grads(state, batch, draws)
            with span("train.g_step.adam"):
                state.apply_g_updates(state.sync_grads("g1", grads_g1),
                                      state.sync_grads("g2", grads_g2))
            return average_scalars(aux, state.mesh)

    return g_step


def make_train_step(config: MuDiffConfig) -> Callable:
    """One call = one D step + one G step, the reference's iteration.

    ``train_step(state, batch, generator=None, draws=None, with_r1=None)``
    updates ``state`` in place and returns the losses.  ``with_r1``
    defaults to the lazy schedule: R1 when ``lazy_reg`` is None or
    ``state.step % lazy_reg == 0``.  ``draws`` is a (D step, G step) pair
    of ``TrainDraws``; without it both are drawn from ``generator`` (for
    the global batch on a mesh).
    """
    d_step, g_step = make_d_step(), make_g_step()

    def train_step(state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Tuple[TrainDraws, TrainDraws]] = None,
                   with_r1: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        if with_r1 is None:
            with_r1 = config.lazy_reg is None or state.step % config.lazy_reg == 0
        if draws is None:
            real = batch[3]
            draws = (TrainDraws.draw(config, real, generator, state.mesh),
                     TrainDraws.draw(config, real, generator, state.mesh))
        d_aux = d_step(state, batch, draws[0], with_r1)
        g_aux = g_step(state, batch, draws[1])
        return {**d_aux, **g_aux}

    return train_step
