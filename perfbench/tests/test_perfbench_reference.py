"""The plain reference against the port's plain CPU path, at a tiny size:
the 4-step sampler (float32, and W8A8 with the same static scales), and
training iterations with R1, remat and Adam (float32)."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench.inputs.weights import make_weights, module_seed  # noqa: E402
from perfbench.reference import diffusion, model  # noqa: E402
from perfbench.reference.ops import Exact, Quantized  # noqa: E402
from perfbench.tests.tiny import tiny_config  # noqa: E402


def _port_cfg(d):
    from mudiff_torch.config import MuDiffConfig

    return MuDiffConfig.from_dict(d)


def _draws(cfg, b, gen):
    s = cfg["image_size"]
    conds = [torch.randn(b, s, s, 1, generator=gen).clamp(-1, 1) for _ in range(3)]
    x0 = torch.randn(b, s, s, 1, generator=gen)
    noise = [(torch.randn(b, cfg["nz"], generator=gen), torch.randn(b, s, s, 1, generator=gen))
             for _ in range(cfg["num_timesteps"])]
    return conds, x0, noise


def test_specs_are_the_ports_state_dict_names_and_shapes():
    from mudiff_torch.models.critic import DiscriminatorLarge
    from mudiff_torch.models.generator import NCSNppGenerator

    cfg = tiny_config(image_size=64)
    pc = _port_cfg(cfg)
    for adaptive in (False, True):
        sd = NCSNppGenerator(pc, adaptive=adaptive).state_dict()
        specs = model.generator_specs(cfg, adaptive)
        assert {k: tuple(v.shape) for k, v in sd.items()} == specs
    sd = DiscriminatorLarge(ngf=cfg["ngf"], t_emb_dim=cfg["t_emb_dim"]).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == model.critic_specs(cfg)


def test_sampler_matches_the_port():
    from mudiff_torch.sampler import build_sampler

    cfg = tiny_config()
    W = {m: make_weights(model.generator_specs(cfg, m == "g2"), module_seed(11, m), "cpu")
         for m in ("g1", "g2")}
    conds, x0, noise = _draws(cfg, 2, torch.Generator().manual_seed(3))
    s = build_sampler(_port_cfg(cfg), device="cpu", compute_dtype=torch.float32, attn="einsum")
    s.g1.load_state_dict(W["g1"])
    s.g2.load_state_dict(W["g2"])
    out = s(*conds, x_init=x0, noise=noise)
    ref = diffusion.sample(Exact(), cfg, W["g1"], W["g2"], conds, x0, noise)
    assert (out - ref).abs().max() < 2e-5


@pytest.mark.parametrize("static", [True, False])
def test_integer_conv_matches_the_ports(static):
    """One routed conv: the reference's W8A8 against K4's plain version,
    static scales (serving) and dynamic ones (calibration)."""
    from mudiff_torch.ops.int8_conv import int8_conv3x3_plain, quantize_conv_weight

    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 8, 8, 64, generator=g)
    w = torch.randn(3, 3, 64, 32, generator=g) / 24.0
    b = torch.randn(32, generator=g)
    absmax = x.abs().amax(dim=(0, 1, 2)) * 0.9  # some inputs clip
    qw = quantize_conv_weight(w, absmax.tolist() if static else None)
    y = int8_conv3x3_plain(x, qw, b, torch.float32)
    prec = Quantized(127, absmax={"s": absmax}) if static else Quantized(127, record={})
    r = prec.conv(x, w, b, "s")
    d = (y - r).abs()
    # codes agree but where x / a and x * (1 / a) round to either side of
    # a half: a few in 10^4, one code step each
    assert d.max() < 0.05 * y.abs().max() and d.mean() < 1e-3 * y.abs().mean()


def test_calibration_sites_are_the_ports():
    """The reference calibrates the convs the port routes, in its order,
    and records their ranges (within what the dynamic int8 forward's code
    flips move them)."""
    from mudiff_torch.infer.calibrate import calibrate_sampler
    from mudiff_torch.sampler import build_sampler

    cfg = tiny_config()
    W = {m: make_weights(model.generator_specs(cfg, m == "g2"), module_seed(11, m), "cpu")
         for m in ("g1", "g2")}
    conds, x0, noise = _draws(cfg, 2, torch.Generator().manual_seed(3))
    s = build_sampler(_port_cfg({**cfg, "use_int8": True}), device="cpu",
                      compute_dtype=torch.float32, attn="einsum")
    s.g1.load_state_dict(W["g1"])
    s.g2.load_state_dict(W["g2"])
    calibs = calibrate_sampler(s.g1, s.g2, s.post, [conds], 4, cfg["nz"],
                               compute_dtype=torch.float32, draws=[(x0, noise)])
    record = {}
    diffusion.sample(Quantized(127, record=record), cfg, W["g1"], W["g2"], conds, x0, noise,
                     int8=True)
    for tag, calib in zip(("g1", "g2"), calibs):
        keys = [k for k in record if k.startswith(tag + ".")]
        assert [ci for ci, _, _ in calib.sites] == [record[k].numel() for k in keys]
        for (_, _, a), k in zip(calib.sites, keys):
            a = torch.tensor(a)
            assert (a - record[k]).abs().max() <= 0.1 * record[k].abs().max()


def test_training_iterations_match_the_port():
    from mudiff_torch.train.state import create_train_state
    from mudiff_torch.train.steps import TrainDraws, make_train_step

    cfg = tiny_config(image_size=64, lazy_reg=2, use_bf16=False)
    pc = _port_cfg(cfg)
    st = create_train_state(pc, seed=0, steps_per_epoch=100, device="cpu")
    specs = {"g1": model.generator_specs(cfg, False), "g2": model.generator_specs(cfg, True),
             "d": model.critic_specs(cfg), "att": model.att_conv_specs(cfg)}
    W = {m: make_weights(specs[m], module_seed(7, m), "cpu") for m in specs}
    for m, mod in (("g1", st.g1), ("g2", st.g2), ("d", st.d), ("att", st.att_conv)):
        mod.load_state_dict(W[m])
    step = make_train_step(pc)
    gen = torch.Generator().manual_seed(1)
    b, s = 2, 64

    def draws():
        n = lambda *sh: torch.randn(sh, generator=gen)  # noqa: E731
        return dict(t=torch.randint(0, 4, (b,), generator=gen), noise_t=n(b, s, s, 1),
                    noise_tp1=n(b, s, s, 1), z=n(b, cfg["nz"]), noise_post1=n(b, s, s, 1),
                    noise_post2=n(b, s, s, 1))

    ref = diffusion.Trainer(Exact(), cfg, *({k: v.clone() for k, v in W[m].items()}
                                            for m in ("g1", "g2", "d")), W["att"], 100, ckpt=True)
    for _ in range(2):  # R1, then none
        batch = tuple(torch.randn(b, s, s, 1, generator=gen).clamp(-1, 1) for _ in range(4))
        d, g = draws(), draws()
        lp = step(st, batch, draws=(TrainDraws(**d), TrainDraws(**g)))
        lr = ref.iteration(batch, diffusion.Draws(**d), diffusion.Draws(**g))
        for k in lr:
            assert abs(float(lp[k]) - lr[k]) <= 1e-4 * abs(lr[k]) + 1e-9, k
    # Adam's first steps move each element by about lr * sign(gradient),
    # so an element whose gradient is near 0 may move either way: compare
    # each leaf's change by its norm, leaving out the leaves whose gradient
    # is nought to rounding (a key's bias under the softmax)
    for m, P in (("g1", ref.G1), ("g2", ref.G2), ("d", ref.D)):
        sd = getattr(st, m).state_dict()
        gn = {k: float(v.norm()) for k, v in ref.first_grads[m].items()}
        med = torch.tensor(list(gn.values())).median().item()
        for k in P:
            if gn[k] < 1e-3 * med:
                continue
            r = (P[k] - W[m][k]).norm()
            assert abs((sd[k] - W[m][k]).norm() - r) <= 2e-2 * r + 1e-9, (m, k)
