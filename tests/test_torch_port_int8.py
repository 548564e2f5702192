"""mudiff_torch int8 serving (W8A8, kernel K4's plain version) vs the JAX
package's ``ops/int8_conv.py``, ``infer/calibrate.py`` and int8
generators, on the CPU.

The quantizers give the JAX codes and scales bit for bit; the conv's
codes and s32 accumulator are exact and its output within one fp32 ulp.

A whole int8 generator cannot be held to the JAX one output for output:
each routed conv rounds its input to 127 levels, and a value within an
fp32 rounding of a .5 boundary takes the other code in the other
package.  Such flips cascade through the later sites and the attention
(on the CPU with ``tiny_cfg_pair`` weights, G1's dynamic int8 output
moved by 0.030 when its input moved by 1e-6 relative, in the port alone).
So the model tests force the port's routed convs onto the JAX run's
inputs, site by site ("teacher forcing"): the port's own input at each
site must match the JAX one (which pins the forward order, not only the
shapes), each site's output within one fp32 ulp, and the generator's
output within 2e-3 of the JAX output.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudiff_tpu.config import brats_recipe as jax_recipe
from mudiff_tpu.diffusion import PosteriorCoefficients as JaxPosterior
from mudiff_tpu.infer import calibrate as jcal
from mudiff_tpu.models import NCSNppGenerator as JaxGenerator
from mudiff_tpu.ops import int8_conv as jint8
from mudiff_torch import build_sampler, ops
from mudiff_torch.config import MuDiffConfig, brats_recipe
from mudiff_torch.convert import params_from_flax
from mudiff_torch.diffusion import PosteriorCoefficients
from mudiff_torch.infer import calibrate, load_generators, save_generators
from mudiff_torch.models import NCSNppGenerator
from mudiff_torch.nn import fused_stems, layers
from mudiff_torch.ops import int8_conv
from test_torch_port_helpers import random_flax_params

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _skewed(rng, shape):
    """Normals with per-channel ranges over three decades."""
    return (rng.randn(*shape) * np.logspace(-2, 1, shape[-1])).astype(np.float32)


def _jax_static(absmax_c):
    """The static path's quantizers of ``_static_int8_conv3x3``, jitted
    with the calibration as a constant of the trace, as the package runs
    them: (x -> codes, w -> (codes, scale))."""
    def scales():
        return jnp.asarray(absmax_c, jnp.float32) / 127.0 + 1e-30

    def codes(x):
        return jnp.clip(jnp.round(x.astype(jnp.float32) * (1.0 / scales())),
                        -127.0, 127.0).astype(jnp.int8)

    def weight(w):
        return jint8.quantize_weight(w.astype(jnp.float32) * scales()[None, None, :, None])

    return jax.jit(codes), jax.jit(weight)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantizers_give_the_jax_codes_and_scales(dtype):
    """Against the JAX quantizers as the package runs them, jitted (the
    scales' division by 127 compiles to a multiply, ``RECIP_127``)."""
    jd, td = DTYPES[dtype]
    rng = np.random.RandomState(0)
    w = (0.05 * rng.randn(3, 3, 48, 40)).astype(np.float32)
    x = _skewed(rng, (3, 9, 7, 48))
    x[1] *= 30.0  # an outlier example
    xj, xt = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    for got, want in zip(int8_conv.quantize_weight(torch.from_numpy(w).to(td)),
                         jax.jit(jint8.quantize_weight)(jnp.asarray(w).astype(jd))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(int8_conv.quantize_activation(xt),
                         jax.jit(jint8.quantize_activation)(xj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # static: absmax below the data's, so codes clip, and channel 0 at
    # unit scale with values on .5 boundaries (half to even)
    absmax = np.abs(x).max(axis=(0, 1, 2)) * 0.7
    absmax[0] = 127.0
    x[0, 0, :6, 0] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    xj, xt = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    absmax_c = tuple(float(v) for v in absmax)
    codes, weight = _jax_static(absmax_c)
    qw = int8_conv.quantize_conv_weight(torch.from_numpy(w), absmax_c)
    got_q = int8_conv.quantize_activation_static(xt, qw.inv_a)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(codes(xj)))
    assert got_q[0, 0, :6, 0].tolist() == [0, 2, 2, 0, -2, -2]
    wq, w_scale = map(np.asarray, weight(jnp.asarray(w)))
    np.testing.assert_array_equal(qw.wq.numpy(), wq)
    np.testing.assert_array_equal(qw.w_scale.numpy(), w_scale.reshape(-1))
    np.testing.assert_array_equal(qw.wq_nk.numpy(), wq.transpose(3, 0, 1, 2).reshape(40, -1))


def _jax_acc(xq, wq):
    return np.asarray(jax.lax.conv_general_dilated(
        xq, wq, (1, 1), [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("cin", [64, 192, 512])
def test_int8_conv_matches_jax(cin, mode):
    """Against the jitted JAX conv: codes, the s32 accumulator and the
    output (fused multiply-add epilogue) bit for bit."""
    rng = np.random.RandomState(cin)
    x = _skewed(rng, (2, 6, 5, cin))
    w = (rng.randn(3, 3, cin, 24) / math.sqrt(9 * cin)).astype(np.float32)
    b = (0.1 * rng.randn(24)).astype(np.float32)
    xj, wj, bj = map(jnp.asarray, (x, w, b))
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    absmax_c = None
    if mode == "static":
        absmax_c = tuple(float(v) for v in np.abs(x).max(axis=(0, 1, 2)) * 0.9)
        calib = jint8.Int8Calib(min_ch=64, sites=((cin, 24, absmax_c),))

        def conv(x, w, b):
            with jint8.int8_scope(True, calib=calib):
                return jint8.int8_conv3x3(x, w, b, compute_dtype=jnp.float32)

        codes, weight = _jax_static(absmax_c)
        xq_j, wq_j = codes(xj), weight(wj)[0]
    else:
        def conv(x, w, b):
            return jint8.int8_conv3x3(x, w, b, compute_dtype=jnp.float32)

        xq_j = jax.jit(jint8.quantize_activation)(xj)[0]
        wq_j = jax.jit(jint8.quantize_weight)(wj)[0]
    want = np.asarray(jax.jit(conv)(xj, wj, bj))
    qw = int8_conv.quantize_conv_weight(wt, absmax_c)
    xq_t = (int8_conv.quantize_activation(xt)[0] if absmax_c is None
            else int8_conv.quantize_activation_static(xt, qw.inv_a))
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    acc = int8_conv.conv_acc_plain(xq_t, qw.wq)
    np.testing.assert_array_equal(acc.numpy(), _jax_acc(xq_j, wq_j).astype(np.float64))
    got = int8_conv.int8_conv3x3(xt, wt, bt, absmax_c=absmax_c, compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    got16 = int8_conv.int8_conv3x3(xt, wt, bt, absmax_c=absmax_c, compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got16.float().numpy(), got.to(torch.bfloat16).float().numpy())


def test_float64_oracle_is_exact_where_float32_is_not():
    """Cin = 512, every code +-127: |acc| reaches 9 * 512 * 127^2 ~ 7.4e7
    > 2^24, where a float32 sum rounds; the float64 conv of the plain
    version equals the int64 sum."""
    rng = np.random.RandomState(5)
    xq = (127 * rng.choice([-1, 1], size=(1, 5, 5, 512))).astype(np.int8)
    wq = (127 * rng.choice([-1, 1], size=(3, 3, 512, 8))).astype(np.int8)
    xq[..., :384] = 127
    wq[..., :384, :] = 127
    exact = np.zeros((1, 5, 5, 8), np.int64)
    padded = np.pad(xq.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    for dy in range(3):
        for dx in range(3):
            exact += padded[:, dy:dy + 5, dx:dx + 5, :] @ wq[dy, dx].astype(np.int64)
    assert np.abs(exact).max() > 2 ** 24
    acc = int8_conv.conv_acc_plain(torch.from_numpy(xq), torch.from_numpy(wq))
    np.testing.assert_array_equal(acc.numpy(), exact.astype(np.float64))
    f32 = torch.nn.functional.conv2d(torch.from_numpy(xq).float().permute(0, 3, 1, 2),
                                     torch.from_numpy(wq).float().permute(3, 2, 0, 1),
                                     padding=1).permute(0, 2, 3, 1)
    assert not np.array_equal(f32.double().numpy(), exact.astype(np.float64))


def test_routing_rule_matches_jax(monkeypatch):
    monkeypatch.delenv("MUDIFF_INT8_MIN_CH", raising=False)
    monkeypatch.delenv("MUDIFF_INT8_COUT_MIN", raising=False)
    widths = [1, 2, 4, 63, 64, 65, 96, 127, 128, 192, 255, 256, 384, 512, 1024]
    for min_ch in (None, 1, 64, 128, 256):
        with jint8.int8_scope(True, min_ch=min_ch), int8_conv.int8_scope(True, min_ch=min_ch):
            for cin in widths:
                for cout in widths:
                    want = jint8.int8_conv_routed(cin, cout)
                    assert int8_conv.int8_conv_routed(cin, cout) == want, (min_ch, cin, cout)
                    assert int8_conv.int8_conv_routed(cin, cout, min_ch or 64) == want


@pytest.mark.parametrize("version", [1, 2])
def test_one_sidecar_serves_both_packages(tmp_path, version):
    calib = jint8.Int8Calib(min_ch=128, stems=True,
                            sites=((128, 256, (1.0, 2.5) * 64), (256, 128, (0.25,) * 256)))
    d = calib.to_json_dict()
    if version == 1:  # written before the stems bit: recorded with the stems in bf16
        del d["stems"]
        d["version"] = 1
    path = tmp_path / "jax.json"
    path.write_text(json.dumps(d))
    ours = calibrate.load_calib(str(path))
    want = jcal.load_calib(str(path))
    assert tuple(ours) == tuple(want) and ours.stems is (version == 2)
    back = calibrate.save_calib(str(tmp_path / "port.json"), ours)
    assert json.loads(open(back).read()) == want.to_json_dict()
    assert jcal.load_calib(back) == want


# ---------------------------------------------------------------- generators

TINY = dict(num_channels_dae=64, image_size=16, ch_mult=(1, 2), attn_resolutions=(8,),
            num_res_blocks=1, use_bf16=False, use_int8=True)  # test_int8.py tiny_cfg_pair
B = 2


@functools.lru_cache(maxsize=None)
def _tiny(adaptive):
    """(numpy inputs, randomized flax params) of G1 or G2 at TINY."""
    rng = np.random.RandomState(40 + adaptive)
    x = (0.3 * rng.randn(B, 16, 16, 1)).astype(np.float32)
    conds = [np.tanh(rng.randn(B, 16, 16, 1)).astype(np.float32) for _ in range(3)]
    t = np.array([0, 2], np.int32)
    z = rng.randn(B, 100).astype(np.float32)
    pseudo = np.tanh(rng.randn(B, 16, 16, 1)).astype(np.float32)
    kw = {"pseudo_target": jnp.asarray(pseudo)} if adaptive else {}
    m = JaxGenerator(config=jax_recipe(**TINY), adaptive=adaptive)
    params = random_flax_params(m, *map(jnp.asarray, (x, *conds, t, z)), seed=50 + adaptive,
                                **kw)
    return (x, *conds, t, z), pseudo, params


@contextlib.contextmanager
def jax_site_spy(monkeypatch):
    """Every JAX int8 conv run in the block (also under jit) appends its
    input and output, in order, to the yielded lists."""
    xs, ys = [], []
    real = jint8.int8_conv3x3

    def spy(x, w, bias, compute_dtype=jnp.bfloat16):
        jax.debug.callback(lambda v: xs.append(np.array(v)), x, ordered=True)
        y = real(x, w, bias, compute_dtype)
        jax.debug.callback(lambda v: ys.append(np.array(v)), y, ordered=True)
        return y

    with monkeypatch.context() as mp:
        mp.setattr(jint8, "int8_conv3x3", spy)
        yield xs, ys
        jax.effects_barrier()


@contextlib.contextmanager
def teacher_forcing(monkeypatch, xs):
    """The port's routed convs take the JAX run's inputs ``xs`` in order;
    yields the (own input, output) of each."""
    seen = []
    real = int8_conv.routed_conv

    def routed(x, *args):
        y = real(torch.from_numpy(xs[len(seen)]).to(x.dtype), *args)
        seen.append((x.float().clone(), y.clone()))
        return y

    with monkeypatch.context() as mp:
        mp.setattr(layers, "routed_conv", routed)
        mp.setattr(fused_stems, "routed_conv", routed)
        yield seen


def check_sites(seen, xs, ys):
    """Each site's own input close to the JAX one (per-channel absmax within
    1e-5 relative: the record a calibration keeps), its output on the JAX
    input equal to the JAX output."""
    assert len(seen) == len(xs) == len(ys)
    for i, ((x, y), xj, yj) in enumerate(zip(seen, xs, ys)):
        assert x.shape == xj.shape, i
        mine, theirs = x.abs().amax(dim=(0, 1, 2)).numpy(), np.abs(xj).max(axis=(0, 1, 2))
        np.testing.assert_allclose(mine, theirs, rtol=1e-5, atol=1e-5 * theirs.max(),
                                   err_msg=f"site {i}")
        np.testing.assert_array_equal(y.numpy(), yj, err_msg=f"site {i}")


@functools.lru_cache(maxsize=None)
def _jax_int8(adaptive, static):
    """The jitted JAX int8 forward of the TINY G1 or G2: (output, site
    inputs, site outputs, calibration).  Static: the calibration is the
    dynamic run's per-site input absmax x 0.8, so that codes clip."""
    inputs, pseudo, params = _tiny(adaptive)
    calib = None
    if static:
        _, xs, ys, _ = _jax_int8(adaptive, False)
        calib = jint8.Int8Calib(min_ch=128, stems=True, sites=tuple(
            (x.shape[-1], y.shape[-1], tuple(float(v) * 0.8 for v in np.abs(x).max((0, 1, 2))))
            for x, y in zip(xs, ys)))
    m = JaxGenerator(config=jax_recipe(**TINY), adaptive=adaptive, int8_calib=calib)
    kw = {"pseudo_target": jnp.asarray(pseudo)} if adaptive else {}
    with pytest.MonkeyPatch.context() as mp, jax_site_spy(mp) as (xs, ys):
        out = np.asarray(jax.jit(functools.partial(m.apply, **kw))(
            {"params": params}, *map(jnp.asarray, inputs)))
    return out, xs, ys, calib


def _port_generator(adaptive, params, calib=None, **kw):
    if calib is not None:
        calib = int8_conv.Int8Calib.from_json_dict(calib.to_json_dict())
    g = NCSNppGenerator(brats_recipe(**{**TINY, **kw}), adaptive=adaptive,
                        int8_calib=calib).eval()
    g.load_state_dict(params_from_flax(params), strict=True)
    return g.requires_grad_(False)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["G1", "G2"])
def test_int8_generator_matches_jax_site_by_site(monkeypatch, adaptive, mode):
    inputs, pseudo, params = _tiny(adaptive)
    want, xs, ys, calib = _jax_int8(adaptive, mode == "static")
    g = _port_generator(adaptive, params, calib)
    args = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
            for a in inputs]
    log = []
    with teacher_forcing(monkeypatch, xs) as seen, ops.record_calls(log), \
            torch.inference_mode():
        got = g(*args, *([torch.from_numpy(pseudo)] if adaptive else []))
    check_sites(seen, xs, ys)
    assert len(seen) == len(g.int8_sites()) == (14 if adaptive else 12)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)
    called = {k: sum(1 for n, _ in log if n == k) for k in g.kernel_launches_per_forward()}
    assert called == g.kernel_launches_per_forward()


def test_training_mode_serves_the_bf16_model_bit_for_bit():
    """use_int8 is ignored in training mode (no straight-through estimator):
    the output equals the non-int8 model's."""
    inputs, _, params = _tiny(False)
    args = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
            for a in inputs]
    g8 = _port_generator(False, params).train()
    g0 = _port_generator(False, params, use_int8=False).train()
    log = []
    with torch.no_grad(), ops.record_calls(log):
        y8 = g8(*args)
    with torch.no_grad():
        y0 = g0(*args)
    assert torch.equal(y8, y0) and "int8_conv3x3" not in {n for n, _ in log}
    assert g8.int8_sites() == [] and g8.kernel_launches_per_forward()["int8_conv3x3"] == 0


@pytest.mark.parametrize("stems", [True, False], ids=["stems", "no_stems"])
def test_flagship_site_list_equals_jax(monkeypatch, stems):
    """flagship64 routing: 30 G1 / 32 G2 sites with the stems on, 29 / 31
    off, (cin, cout) in the JAX trace order.  The site list depends on the
    widths only, so both run at 32^2 (test_int8.py:517)."""
    kw = dict(num_channels_dae=64, image_size=32, use_bf16=True, use_int8=True)
    if stems:
        monkeypatch.delenv("MUDIFF_INT8_STEMS", raising=False)
    else:
        monkeypatch.setenv("MUDIFF_INT8_STEMS", "0")
    x = jnp.zeros((1, 32, 32, 1), jnp.float32)
    t, z = jnp.zeros((1,), jnp.int32), jnp.zeros((1, 100), jnp.float32)
    lists = []
    for adaptive in (False, True):
        extra = {"pseudo_target": x} if adaptive else {}
        m = JaxGenerator(config=jax_recipe(**kw), adaptive=adaptive, dtype=jnp.bfloat16)
        p = jax.eval_shape(lambda k: m.init(k, x, x, x, x, t, z, **extra),
                           jax.random.PRNGKey(0))["params"]
        want = jcal.synthetic_calib(m, p, (x, x, x, x, t, z), **extra)
        g = NCSNppGenerator(brats_recipe(**kw), adaptive=adaptive,
                            int8_stems=stems).eval().requires_grad_(False)
        ours = calibrate.synthetic_calib(g)
        assert (ours.min_ch, ours.stems) == (want.min_ch, want.stems) == (128, stems)
        assert [s[:2] for s in ours.sites] == [s[:2] for s in want.sites] == g.int8_sites()
        assert all(a == (1.0,) * ci for ci, _, a in ours.sites)
        lists.append(len(ours.sites))
    assert tuple(lists) == ((30, 32) if stems else (29, 31))


def test_calibrate_sampler_matches_jax_on_the_same_draws(monkeypatch):
    """Both packages calibrate G1 + G2 over two batches x 4 steps; the port
    takes the JAX key splits' draws and its routed convs the JAX inputs
    (teacher forcing), so the calibrations agree and each site's own input
    shows that the port's loop reached the same states."""
    cfg = jax_recipe(**TINY)
    (_, *conds, _, _), _, p1 = _tiny(False)
    _, _, p2 = _tiny(True)
    batches = [tuple(conds), tuple(np.flip(c, axis=1).copy() for c in conds)]
    key = jax.random.PRNGKey(7)
    g1j = JaxGenerator(config=cfg)
    g2j = JaxGenerator(config=cfg, adaptive=True)
    with jax_site_spy(monkeypatch) as (xs, ys):
        want = jcal.calibrate_sampler(g1j, g2j, p1, p2, JaxPosterior.from_config(cfg), batches,
                                      key, cfg.num_timesteps, cfg.nz,
                                      compute_dtype=jnp.float32, margin=1.25)
    draws, k = [], key
    for c1, _, _ in batches:
        k, k_init = jax.random.split(k)
        x_init = np.array(jax.random.normal(k_init, c1.shape, jnp.float32))
        noise = []
        for _ in range(cfg.num_timesteps):
            k, kz, kp = jax.random.split(k, 3)
            noise.append((torch.from_numpy(np.array(jax.random.normal(kz, (B, cfg.nz)))),
                          torch.from_numpy(np.array(jax.random.normal(kp, c1.shape)))))
        draws.append((torch.from_numpy(x_init), noise))
    g1, g2 = _port_generator(False, p1), _port_generator(True, p2)
    post = PosteriorCoefficients.from_config(brats_recipe(**TINY)).as_tensors("cpu")
    with teacher_forcing(monkeypatch, xs) as seen:
        ours = calibrate.calibrate_sampler(
            g1, g2, post, [tuple(map(torch.from_numpy, b)) for b in batches],
            cfg.num_timesteps, cfg.nz, compute_dtype=torch.float32, margin=1.25, draws=draws)
    check_sites(seen, xs, ys)
    for o, w in zip(ours, want):
        assert (o.min_ch, o.stems) == (w.min_ch, w.stems) == (128, True)
        assert [s[:2] for s in o.sites] == [s[:2] for s in w.sites]
        for (_, _, a), (_, _, b) in zip(o.sites, w.sites):
            np.testing.assert_array_equal(np.array(a), np.array(b))


def test_calibration_must_match_the_forward_site_for_site():
    """A calibration with a site too many fails at the end of the forward
    (the check the JAX package lacks); one too few, or a site of another
    shape, fails at that site."""
    inputs, _, params = _tiny(False)
    args = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
            for a in inputs]
    g = _port_generator(False, params)
    real = calibrate.synthetic_calib(g)
    extra = real._replace(sites=real.sites + ((128, 128, (1.0,) * 128),))
    short = real._replace(sites=real.sites[:-1])
    swapped = real._replace(sites=(real.sites[1],) + real.sites[:1] + real.sites[2:])
    with torch.inference_mode():
        _port_generator(False, params, real)(*args)  # consumes every site
        for calib, match in ((extra, "consumed 12"), (short, "reached site #11"),
                             (swapped, "drift")):
            with pytest.raises(ValueError, match=match):
                _port_generator(False, params, calib)(*args)


def test_int8_conv_counts_calls_not_cpu_launches_and_has_no_backward():
    x = torch.randn(2, 5, 4, 64)
    w = torch.randn(3, 3, 64, 64, requires_grad=True)
    ops.reset_launch_counts()
    log = []
    with ops.record_calls(log), torch.no_grad():
        ops.int8_conv3x3(x, w, None, compute_dtype=torch.float32)
    assert [n for n, _ in log] == ["int8_conv3x3"] and ops.launch_counts()["int8_conv3x3"] == 0
    with pytest.raises(RuntimeError, match="no backward"):
        ops.int8_conv3x3(x, w, None, compute_dtype=torch.float32)


def test_weight_cache_follows_load_state_dict():
    """The quantized weights are cached per module; a load_state_dict
    after a forward is served, never the stale codes."""
    inputs, _, params = _tiny(False)
    args = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
            for a in inputs]
    g = _port_generator(False, params)
    fresh = NCSNppGenerator(brats_recipe(**TINY)).eval().requires_grad_(False)
    state = dict(fresh.state_dict())
    with torch.inference_mode():
        before = g(*args)
        again = g(*args)
        g.load_state_dict(state)
        after = g(*args)
        want = fresh(*args)
    assert torch.equal(before, again) and not torch.equal(before, after)
    assert torch.equal(after, want)


# -------------------------------------------------------------- serving entry points

SERVE = dict(image_size=16, num_channels=1, num_channels_dae=32, ch_mult=(1, 2),
             num_res_blocks=1, attn_resolutions=(8,), z_emb_dim=16, nz=8, n_mlp=2)
SERVE_ARGV = ["--image_size", "16", "--num_channels", "1", "--num_channels_dae", "32",
              "--ch_mult", "1", "2", "--num_res_blocks", "1", "--attn_resolutions", "8",
              "--z_emb_dim", "16", "--nz", "8", "--n_mlp", "2"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Saved nf=32 generators (routed at min_ch 64), the three input
    volumes, and a directory holding the generators and their sidecars."""
    from mudiff_torch.utils import nifti

    d = tmp_path_factory.mktemp("int8")
    cfg = MuDiffConfig(**SERVE, use_int8=True)
    gens = [NCSNppGenerator(cfg, adaptive=a, generator=torch.Generator().manual_seed(int(a)))
            for a in (False, True)]
    save_generators(str(d / "plain"), *gens)
    save_generators(str(d / "calibrated"), *gens)
    for g, path in zip(gens, calibrate.calib_sidecar_paths(str(d / "calibrated"))):
        calibrate.save_calib(path, calibrate.synthetic_calib(g.eval()))
    rng = np.random.RandomState(1)
    inputs = []
    for name in ("flair", "t2", "t1"):
        path = str(d / f"{name}.nii.gz")
        nifti.save(np.abs(rng.randn(20, 20, 7)).astype(np.float32), np.eye(4), path)
        inputs += [f"--input_{name}", path]
    return d, inputs


@pytest.mark.parametrize("static,where,calibrated", [
    (None, "calibrated", True), (None, "plain", False),
    (False, "calibrated", False), (True, "calibrated", True)])
def test_load_generators_finds_the_sidecars(served, static, where, calibrated):
    d, _ = served
    cfg = MuDiffConfig(**SERVE, use_int8=True, int8_static=static)
    g1, g2 = load_generators(cfg, str(d / where), device="cpu")
    assert (g1.int8_calib is not None) is calibrated and (g2.int8_calib is not None) is calibrated
    assert g1.int8_sites() and g1.kernel_launches_per_forward()["int8_conv3x3"] == 12


def test_int8_static_without_sidecars_raises(served):
    d, _ = served
    cfg = MuDiffConfig(**SERVE, use_int8=True, int8_static=True)
    with pytest.raises(FileNotFoundError, match="int8_calib_g1.json"):
        load_generators(cfg, str(d / "plain"), device="cpu")


@pytest.mark.parametrize("flags,static", [([], True), (["--int8_dynamic"], False)])
def test_volume_cli_serves_int8_by_default(served, flags, static, monkeypatch):
    """No --bf16: the CLI serves int8, with the sidecars' static scales
    when they exist, dynamic ones under --int8_dynamic."""
    from mudiff_torch.cli import test_volume
    from mudiff_torch.infer import volume

    d, inputs = served
    built = []
    real = volume.load_generators

    def spy(*a, **k):
        built.append(real(*a, **k))
        return built[-1]

    monkeypatch.setattr(volume, "load_generators", spy)
    log = []
    with ops.record_calls(log):
        out = test_volume.main(SERVE_ARGV + inputs + flags + [
            "--ckpt_dir", str(d / "calibrated"), "--output_dir", str(d / f"out{static}"),
            "--slice_half_range", "1", "--test_batch_size", "2"], device="cpu")
    g1, g2 = built[0]
    assert (g1.int8_calib is not None) is static and g1.config.use_int8
    n = 2 * 4 * (len(g1.int8_sites()) + len(g2.int8_sites()))  # 2 batches x 4 steps
    assert sum(1 for k, _ in log if k == "int8_conv3x3") == n > 0
    from mudiff_torch.utils import nifti

    v = nifti.load(out).get_fdata()
    assert v.shape == (20, 20, 7) and np.isfinite(v).all() and v[:, :, 2:5].std() > 0


def test_build_sampler_serves_static_unit_scales_on_the_cpu():
    cfg = MuDiffConfig(**SERVE, use_int8=True)
    dyn = build_sampler(cfg, device="cpu", compute_dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
    stat = build_sampler(cfg, device="cpu", compute_dtype=torch.float32, int8_static=True,
                         generator=torch.Generator().manual_seed(0))
    assert dyn.g1.int8_calib is None and len(stat.g1.int8_calib.sites) == 12
    for a, b in zip(dyn.g1.state_dict().values(), stat.g1.state_dict().values()):
        assert torch.equal(a, b)
    c = torch.tanh(torch.randn(1, 16, 16, 1, generator=torch.Generator().manual_seed(3)))
    out = stat(c, c, c, generator=torch.Generator().manual_seed(4))
    assert out.shape == c.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="use_int8"):
        build_sampler(MuDiffConfig(**SERVE), device="cpu", int8_static=True)
