"""The diffusion tables, the 4-step mutual posterior sampler, and one
training iteration (D step with lazy R1, G step with the masks, Adam),
in plain float32 PyTorch on the reference models.

The tables follow the MU-Diff reference (engine/train.py): a VP-SDE
variance on a T-step grid, betas rounded to float32, every derived table
in float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import model


def tables(cfg: dict, device) -> Dict[str, torch.Tensor]:
    """The forward-process and posterior tables as float32 tensors."""
    T = cfg["num_timesteps"]
    t = np.arange(0, T + 1, dtype=np.float64) / T * (1.0 - 1e-3) + 1e-3
    bmin, bmax = cfg["beta_min"], cfg["beta_max"]
    var = 1.0 - np.exp(2.0 * (-0.25 * t ** 2 * (bmax - bmin) - 0.5 * t * bmin))
    alpha_bars = 1.0 - var
    betas_full = np.concatenate([[1e-8], 1.0 - alpha_bars[1:] / alpha_bars[:-1]]).astype(np.float32)
    sigmas = betas_full ** 0.5
    a_s = np.sqrt(1.0 - betas_full)
    a_s_cum = np.cumprod(a_s)
    sigmas_cum = np.sqrt(1.0 - a_s_cum ** 2)
    betas = betas_full[1:]
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.concatenate([np.ones(1, np.float32), ac[:-1]])
    post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
    out = {"sigmas": sigmas, "a_s": a_s, "a_s_cum": a_s_cum, "sigmas_cum": sigmas_cum,
           "coef1": betas * np.sqrt(ac_prev) / (1.0 - ac),
           "coef2": (1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
           "log_var": np.log(np.maximum(post_var, 1e-20))}
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in out.items()}


def _at(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return table[t].reshape(-1, 1, 1, 1)


def _post_mean(tb, x0, x_t, t):
    return _at(tb["coef1"], t) * x0 + _at(tb["coef2"], t) * x_t


def _post_noise(tb, mean, t, noise):
    nonzero = (t != 0).to(torch.float32).reshape(-1, 1, 1, 1)
    return mean + nonzero * torch.exp(0.5 * _at(tb["log_var"], t)) * noise


def sample(prec, cfg: dict, g1: model.Params, g2: model.Params, conds: Sequence[torch.Tensor],
           x_init: torch.Tensor, noise: Sequence[Tuple[torch.Tensor, torch.Tensor]],
           int8: bool = False) -> torch.Tensor:
    """x_0 of the T-step sampler: per step G1, then G2 on G1's
    prediction, then the mean of both posterior means plus one noise."""
    tb = tables(cfg, x_init.device)
    x = x_init
    b = x.shape[0]
    for step, i in enumerate(range(cfg["num_timesteps"] - 1, -1, -1)):
        t = torch.full((b,), i, dtype=torch.int64, device=x.device)
        z, eps = noise[step]
        x0_1 = model.generator(prec, cfg, g1, x, *conds, t, z, int8=int8)
        x0_2 = model.generator(prec, cfg, g2, x, *conds, t, z, pseudo=x0_1, int8=int8)
        mean = 0.5 * (_post_mean(tb, x0_1, x, t) + _post_mean(tb, x0_2, x, t))
        x = _post_noise(tb, mean, t, eps)
    return x


# ------------------------------------------------------------------ training

class Draws:
    """One D or G step's random numbers (t, the pair's two noises, z, the
    two posterior noises)."""

    def __init__(self, t, noise_t, noise_tp1, z, noise_post1, noise_post2):
        self.t, self.noise_t, self.noise_tp1 = t, noise_t, noise_tp1
        self.z, self.noise_post1, self.noise_post2 = z, noise_post1, noise_post2


def _pair(tb, real, t, noise_t, noise_tp1):
    x_t = _at(tb["a_s_cum"], t) * real + _at(tb["sigmas_cum"], t) * noise_t
    x_tp1 = _at(tb["a_s"], t + 1) * x_t + _at(tb["sigmas"], t + 1) * noise_tp1
    return x_t, x_tp1


def _post_sample(tb, x0, x_tp1, t, noise):
    return _post_noise(tb, _post_mean(tb, x0, x_tp1, t), t, noise)


def d_loss(prec, cfg, G1, G2, D, batch, dr: Draws, with_r1: bool) -> Dict[str, torch.Tensor]:
    """The D step's losses; ``total`` carries the graph to D's parameters."""
    c1, c2, c3, real = batch
    tb = tables(cfg, real.device)
    t = dr.t
    x_t, x_tp1 = _pair(tb, real, t, dr.noise_t, dr.noise_tp1)
    x_t = x_t.detach().requires_grad_(with_r1)
    logit_real, _ = model.critic(prec, cfg, D, x_t, t, x_tp1)
    err_real = F.softplus(-logit_real).mean()
    if with_r1:
        (gx,) = torch.autograd.grad(logit_real.sum(), x_t, create_graph=True)
        r1 = cfg["r1_gamma"] / 2.0 * gx.reshape(gx.shape[0], -1).square().sum(dim=1).mean()
    else:
        r1 = torch.zeros((), device=real.device)
    with torch.no_grad():
        x0_1 = model.generator(prec, cfg, G1, x_tp1, c1, c2, c3, t, dr.z)
        x0_2 = model.generator(prec, cfg, G2, x_tp1, c1, c2, c3, t, dr.z, pseudo=x0_1)
    f1, _ = model.critic(prec, cfg, D, _post_sample(tb, x0_1, x_tp1, t, dr.noise_post1), t, x_tp1)
    f2, _ = model.critic(prec, cfg, D, _post_sample(tb, x0_2, x_tp1, t, dr.noise_post2), t, x_tp1)
    err_fake = F.softplus(f1).mean() + F.softplus(f2).mean()
    return {"D_total": err_real + r1 + err_fake, "D_real": err_real, "D_fake": err_fake,
            "R1": r1}


def _bce(logits, targets):
    return F.softplus(logits) - logits * targets


def g_loss(prec, cfg, G1, G2, D, att, batch, dr: Draws, ckpt: bool = False
           ) -> Dict[str, torch.Tensor]:
    """The G step's losses; ``total`` carries the graph to G1's and G2's
    parameters (``ckpt``: the generators' blocks recomputed in the
    backward)."""
    c1, c2, c3, real = batch
    tb = tables(cfg, real.device)
    t = dr.t
    _, x_tp1 = _pair(tb, real, t, dr.noise_t, dr.noise_tp1)
    x0_1 = model.generator(prec, cfg, G1, x_tp1, c1, c2, c3, t, dr.z, ckpt=ckpt)
    x0_2 = model.generator(prec, cfg, G2, x_tp1, c1, c2, c3, t, dr.z, pseudo=x0_1, ckpt=ckpt)
    p1 = _post_sample(tb, x0_1, x_tp1, t, dr.noise_post1)
    p2 = _post_sample(tb, x0_2, x_tp1, t, dr.noise_post2)
    l1, feat1 = model.critic(prec, cfg, D, p1, t, x_tp1)
    l2, feat2 = model.critic(prec, cfg, D, p2, t, x_tp1)
    hw = p1.shape[1:3]

    def att_map(feat):
        a = torch.sigmoid(F.linear(feat, att["weight"], att["bias"]))
        a = F.interpolate(a.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                          align_corners=False)
        return a.permute(0, 2, 3, 1)

    mask = (torch.mean(att_map(feat2) * _bce(p1, torch.sigmoid(p2)))
            + torch.mean(att_map(feat1) * _bce(p2, torch.sigmoid(p1))))
    adv = F.softplus(-l1).mean() + F.softplus(-l2).mean()
    l1_loss = torch.mean(torch.abs(x0_1 - real)) + torch.mean(torch.abs(x0_2 - real))
    total = adv + cfg["lambda_l1_loss"] * l1_loss + cfg["lambda_mask_loss"] * mask
    return {"G_total": total, "G_adv": adv, "G_L1": l1_loss, "G_mask": mask}


def lr_at(base: float, count: int, cfg: dict, steps_per_epoch: int) -> float:
    """CosineAnnealingLR(T_max=num_epoch, eta_min=1e-5) stepped per epoch."""
    epoch = min(count // steps_per_epoch, cfg["num_epoch"])
    return 1e-5 + (base - 1e-5) * 0.5 * (1.0 + math.cos(math.pi * epoch / cfg["num_epoch"]))


class Adam:
    """Adam (no weight decay) over a dict of leaves, updated in place."""

    def __init__(self, params: model.Params, beta1: float, beta2: float, eps: float = 1e-8):
        self.params = params
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)


def _grads(total: torch.Tensor, params: model.Params) -> Dict[str, torch.Tensor]:
    names = list(params)
    gs = torch.autograd.grad(total, [params[n] for n in names], allow_unused=True)
    return {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, gs)}


class Trainer:
    """G1, G2, the critic, the frozen projection and three Adams: one
    ``iteration`` is the D step then the G step, with R1 when ``step %
    lazy_reg == 0``.  ``first_grads`` keeps each module's gradients of
    the first step."""

    def __init__(self, prec, cfg: dict, G1, G2, D, att, steps_per_epoch: int,
                 ckpt: bool = False):
        self.prec, self.cfg, self.ckpt = prec, cfg, ckpt
        self.G1, self.G2, self.D, self.att = G1, G2, D, att
        for p in (*G1.values(), *G2.values(), *D.values()):
            p.requires_grad_(True)
        b1, b2 = cfg["beta1"], cfg["beta2"]
        self.opt = {"g1": Adam(G1, b1, b2), "g2": Adam(G2, b1, b2), "d": Adam(D, b1, b2)}
        self.steps_per_epoch = steps_per_epoch
        self.step = 0
        self.first_grads: Optional[Dict[str, Dict[str, torch.Tensor]]] = None

    def iteration(self, batch, d_draws: Draws, g_draws: Draws) -> Dict[str, float]:
        cfg = self.cfg
        with_r1 = self.step % cfg["lazy_reg"] == 0
        dl = d_loss(self.prec, cfg, self.G1, self.G2, self.D, batch, d_draws, with_r1)
        gd = _grads(dl["D_total"], self.D)
        self.opt["d"].step(gd, lr_at(cfg["lr_d"], self.opt["d"].count, cfg, self.steps_per_epoch))
        gl = g_loss(self.prec, cfg, self.G1, self.G2, self.D, self.att, batch, g_draws,
                    self.ckpt)
        gg = _grads(gl["G_total"], {**{f"g1/{k}": v for k, v in self.G1.items()},
                                    **{f"g2/{k}": v for k, v in self.G2.items()}})
        g1 = {k[3:]: v for k, v in gg.items() if k.startswith("g1/")}
        g2 = {k[3:]: v for k, v in gg.items() if k.startswith("g2/")}
        lr_g = lr_at(cfg["lr_g"], self.opt["g1"].count, cfg, self.steps_per_epoch)
        self.opt["g1"].step(g1, lr_g)
        self.opt["g2"].step(g2, lr_g)
        if self.first_grads is None:
            self.first_grads = {"d": gd, "g1": g1, "g2": g2}
        self.step += 1
        return {k: float(v.detach()) for k, v in {**dl, **gl}.items()}
