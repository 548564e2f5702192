"""The port's slice-level test (``infer/slice_test.py``, ``cli/test.py``),
its PNG codec, its metrics and its CLI parsers, against the JAX package
and PIL, on the CPU.

* The PNG codec against PIL both ways: PIL reads what the port writes,
  the port reads what PIL writes, and both read files made with each of
  the five filter types (None, Sub, Up, Average, Paeth).
* ``export_png_pairs`` writes the JAX package's codes; ``mae``, ``psnr``,
  ``ssim`` and ``evaluate_pair_dirs`` give the JAX package's numbers
  within 1e-12.
* ``sample_and_test`` in fp32 (``--bf16 --no_bf16``, einsum attention)
  at the ``TINY`` widths of ``tests/test_e2e.py`` with seeded non-trivial
  weights and the JAX run's draws replayed (its per-batch splits and the
  sampler's per-step splits): predictions within the sampler test's
  1e-3, PNG codes within one level.
* The ``train`` and ``test`` parsers against the JAX ones, flag for flag
  and default for default, with the port's difference: ``--attn`` in
  every mode, resolved without the environment.
"""

import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mudiff_tpu.cli import args as jargs
from mudiff_tpu.config import MuDiffConfig as JaxConfig
from mudiff_tpu.diffusion import PosteriorCoefficients as JaxPost
from mudiff_tpu.infer import slice_test as jslice
from mudiff_tpu.metrics import image_metrics as jmetrics
from mudiff_tpu.models import NCSNppGenerator as JaxGenerator
from mudiff_torch.cli import args
from mudiff_torch.cli import test as test_cli
from mudiff_torch.config import MuDiffConfig
from mudiff_torch.convert import export_generators
from mudiff_torch.infer import export_png_pairs, sample_and_test
from mudiff_torch.metrics import image_metrics
from mudiff_torch.utils import png
from test_torch_port_helpers import random_flax_params

TINY = dict(image_size=64, num_channels=1, num_channels_dae=16, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(8,), z_emb_dim=32, t_emb_dim=32, nz=8,
            ngf=8, num_timesteps=2, use_bf16=False, seed=3)
ARCH = ["--image_size", "64", "--num_channels", "1", "--num_channels_dae", "16",
        "--ch_mult", "1", "2", "--num_res_blocks", "1", "--attn_resolutions", "8",
        "--z_emb_dim", "32", "--t_emb_dim", "32", "--nz", "8", "--ngf", "8",
        "--num_timesteps", "2", "--seed", "3"]
BATCH = 4  # 10 test slices: the last batch is padded by 2


def _image(h, w, seed=0):
    rng = np.random.RandomState(seed)
    smooth = np.add.outer(np.arange(h), np.arange(w)) * 3 % 256
    return ((smooth + rng.randint(0, 40, (h, w))) % 256).astype(np.uint8)


def _encode(image, filters):
    """An 8-bit grayscale PNG whose row y uses ``filters[y % len(filters)]``."""
    h, w = image.shape
    img = image.astype(np.int64)
    out = bytearray()
    for y in range(h):
        kind = filters[y % len(filters)]
        prior = img[y - 1] if y else np.zeros(w, np.int64)
        left = np.concatenate([[0], img[y, :-1]])
        upleft = np.concatenate([[0], prior[:-1]])
        if kind == 0:
            pred = np.zeros(w, np.int64)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(kind)
        out += ((img[y] - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"tEXt", b"Comment\x00filters")
            + chunk(b"IDAT", zlib.compress(bytes(out))[:40])
            + chunk(b"IDAT", zlib.compress(bytes(out))[40:]) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (64, 64), (33, 200)])
def test_png_written_by_the_port_reads_in_pil_and_back(tmp_path, shape):
    img = _image(*shape)
    path = str(tmp_path / "a.png")
    png.write_gray8(path, img)
    with Image.open(path) as im:
        assert im.mode == "L" and im.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.read_gray8(path), img)


@pytest.mark.parametrize("shape", [(5, 9), (64, 64), (40, 257)])
def test_png_written_by_pil_reads_in_the_port(tmp_path, shape):
    img = _image(*shape, seed=1)
    for kw in ({}, {"optimize": True}, {"compress_level": 0}):
        path = str(tmp_path / "pil.png")
        Image.fromarray(img, mode="L").save(path, **kw)
        np.testing.assert_array_equal(png.read_gray8(path), img)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_filter_types_read_as_pil_reads_them(tmp_path, filters):
    img = _image(37, 29, seed=2)
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, filters))
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)  # the encoder is right
    np.testing.assert_array_equal(png.read_gray8(str(path)), img)


def test_png_reader_refuses_other_formats(tmp_path):
    for mode, arr in (("RGB", np.zeros((4, 4, 3), np.uint8)),
                      ("I;16", np.zeros((4, 4), np.uint16)), ("1", np.zeros((4, 4), bool))):
        path = str(tmp_path / f"{mode.replace(';', '')}.png")
        Image.fromarray(arr).convert(mode).save(path)
        with pytest.raises(ValueError, match="only 8-bit grayscale"):
            png.read_gray8(path)
    path = tmp_path / "bad.png"
    png.write_gray8(str(path), _image(4, 4))
    data = bytearray(path.read_bytes())
    data[40] ^= 0xFF  # inside the IDAT chunk
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC mismatch"):
        png.read_gray8(str(path))
    with pytest.raises(ValueError, match="2-D uint8"):
        png.write_gray8(str(path), np.zeros((2, 2), np.float32))


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """pred / gt in [-1, 1] with a global offset, exported by both packages."""
    rng = np.random.RandomState(4)
    gt = np.tanh(rng.randn(5, 48, 40)).astype(np.float32)
    pred = (0.8 * gt + 0.2 * rng.randn(5, 48, 40) + 0.1).astype(np.float32)
    root = tmp_path_factory.mktemp("pairs")
    dirs = {}
    for name in ("ours", "ref"):
        dirs[name] = (root / name / "pred", root / name / "gt")
        for d in dirs[name]:
            d.mkdir(parents=True)
    codes = export_png_pairs(pred, gt, *map(str, dirs["ours"]))
    jslice.export_png_pairs(pred, gt, *map(str, dirs["ref"]))
    return pred, gt, dirs, codes


def test_export_png_pairs_matches_jax(pairs):
    _, _, dirs, (pred8, gt8) = pairs
    for kind, codes in (("pred", pred8), ("gt", gt8)):
        ours = sorted(os.listdir(dirs["ours"][kind == "gt"]))
        assert ours == sorted(os.listdir(dirs["ref"][kind == "gt"]))
        assert ours == [f"{kind}_{i:05d}.png" for i in range(5)]
        for i, name in enumerate(ours):
            got = png.read_gray8(str(dirs["ours"][kind == "gt"] / name))
            with Image.open(dirs["ref"][kind == "gt"] / name) as im:
                np.testing.assert_array_equal(got, np.asarray(im))
            np.testing.assert_array_equal(got, codes[i])
    assert pred8.max() == 255 or gt8.max() == 255  # one shared range
    assert pred8.min() == 0 or gt8.min() == 0


def test_metrics_match_jax(pairs, monkeypatch):
    pred, gt, dirs, _ = pairs
    for i in range(len(pred)):
        p01, g01 = (pred[i] + 1) / 2, (gt[i] + 1) / 2
        for name in ("mae", "psnr", "ssim"):
            got = getattr(image_metrics, name)(g01, p01)
            want = getattr(jmetrics, name)(g01, p01)
            assert np.isfinite(want) and abs(got - want) <= 1e-12 * max(1.0, abs(want)), name
    assert image_metrics.psnr(g01, g01) == float("inf")
    for k in [k for k in os.environ if k.startswith("MUDIFF_LPIPS")]:
        monkeypatch.delenv(k)
    got = image_metrics.evaluate_pair_dirs(*map(str, dirs["ours"]))
    want = jmetrics.evaluate_pair_dirs(*map(str, dirs["ref"]))
    assert set(got) == set(want) == {"psnr", "ssim", "mae", "psnr_std", "ssim_std",
                                     "mae_std"}
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-12 * max(1.0, abs(v)), k
    scored = image_metrics.evaluate_pair_dirs(*map(str, dirs["ours"]),
                                              lpips_fn=lambda g, p: float(np.abs(g - p).max()))
    assert scored["lpips"] > 0 and "lpips_std" in scored


@pytest.fixture(scope="module")
def test_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("npy")
    rng = np.random.RandomState(5)
    (root / "test").mkdir()
    for mod in ("T1", "T2", "FLAIR", "T1CE"):
        np.save(root / "test" / f"{mod}.npy", rng.randn(10, 64, 64).astype(np.float32))
    return str(root)


@pytest.fixture(scope="module")
def generators(tmp_path_factory):
    """Seeded non-trivial JAX generator params, and the port's checkpoint."""
    cfg = JaxConfig(**TINY)
    x = jnp.zeros((1, 64, 64, 1))
    t, z = jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8))
    g1, g2 = JaxGenerator(config=cfg), JaxGenerator(config=cfg, adaptive=True)
    p1 = random_flax_params(g1, x, x, x, x, t, z, seed=6)
    p2 = random_flax_params(g2, x, x, x, x, t, z, pseudo_target=x, seed=7)
    ckpt = tmp_path_factory.mktemp("ckpt")
    export_generators(p1, p2, str(ckpt))
    return (g1, g2, p1, p2), str(ckpt)


def _jax_predictions(gens, test_split, seed):
    """The JAX harness's samples (``sample_and_test``'s loop: padded tail,
    its jitted sampler, its key splits), and the same draws as torch
    tensors for the port."""
    cfg = JaxConfig(input_path=test_split, **TINY)
    g1, g2, p1, p2 = gens
    sample_fn = jslice._build_sampler(cfg, g1, g2, JaxPost.from_config(cfg))
    ds = jslice.SliceDataset("test", test_split, "T1CE")
    key, preds, draws = jax.random.PRNGKey(seed), [], []
    for start in range(0, len(ds), BATCH):
        idx = np.arange(start, min(start + BATCH, len(ds)))
        c = [np.concatenate([a, np.repeat(a[-1:], BATCH - len(idx), axis=0)])
             for a in ds.gather_batch(idx)]
        key, k_init, k_s = jax.random.split(key, 3)
        x_init = jax.random.normal(k_init, c[3].shape, jnp.float32)
        preds.append(np.asarray(sample_fn(p1, p2, *map(jnp.asarray, c[:3]), x_init, k_s))
                     [:len(idx), ..., 0])
        noise, k = [], k_s
        for _ in range(cfg.num_timesteps):
            k, kz, kp = jax.random.split(k, 3)
            noise.append((torch.from_numpy(np.array(jax.random.normal(kz, (BATCH, 8)))),
                          torch.from_numpy(np.array(jax.random.normal(kp, c[3].shape)))))
        draws.append((torch.from_numpy(np.array(x_init)), noise))
    return np.concatenate(preds), draws


def test_sample_and_test_matches_jax_fp32(generators, test_split, tmp_path):
    gens, ckpt = generators
    want, draws = _jax_predictions(gens, test_split, seed=3)
    gt = jslice.SliceDataset("test", test_split, "T1CE").gather_batch(np.arange(10))[3][..., 0]
    for kind in ("pred", "gt"):
        (tmp_path / "ref" / kind).mkdir(parents=True)
    jslice.export_png_pairs(want, gt, str(tmp_path / "ref" / "pred"), str(tmp_path / "ref" / "gt"))
    cfg, a = args.parse_config(ARCH + ["--bf16", "--no_bf16", "--attn", "einsum",
                                       "--input_path", test_split], mode="test")
    out = sample_and_test(cfg, ckpt_dir=ckpt, output_dir=str(tmp_path / "ours"),
                          batch_size=BATCH, seed=3, device="cpu", attn=a.attn, draws=draws)
    assert out["n_slices"] == 10 and out["pred"].shape == (10, 64, 64)
    assert want.std() > 1e-2
    np.testing.assert_allclose(out["pred"], want, atol=1e-3, rtol=1e-3)
    for kind in ("pred", "gt"):
        for i in range(10):
            got = png.read_gray8(os.path.join(out[f"{kind}_dir"], f"{kind}_{i:05d}.png"))
            with Image.open(tmp_path / "ref" / kind / f"{kind}_{i:05d}.png") as im:
                ref = np.asarray(im).astype(int)
            assert np.abs(got.astype(int) - ref).max() <= 1, (kind, i)
            np.testing.assert_array_equal(got, out[f"{kind}_u8"][i])


@pytest.mark.parametrize("extra", [["--bf16", "--no_bf16"], []], ids=["fp32", "int8"])
def test_test_cli_prints_the_metrics(generators, test_split, tmp_path, capsys, extra):
    """The CLI end to end (int8 by default: dynamic scales, no sidecars)."""
    _, ckpt = generators
    out = test_cli.main(ARCH + extra + ["--input_path", test_split, "--ckpt_dir", ckpt,
                                        "--test_batch_size", str(BATCH)], device="cpu")
    printed = json.loads(capsys.readouterr().out)
    assert printed == {k: v for k, v in out.items() if k not in ("pred_u8", "gt_u8", "seconds")}
    assert printed["n_slices"] == 10 and printed["pred_dir"].startswith(ckpt)
    assert all(np.isfinite(printed[k]) for k in ("psnr", "ssim", "mae"))
    names = sorted(os.listdir(printed["pred_dir"]))
    assert len(names) == 10
    np.testing.assert_array_equal(
        png.read_gray8(os.path.join(printed["pred_dir"], names[9])), out["pred_u8"][9])


def _options(parser):
    return {s: a.dest for a in parser._actions for s in a.option_strings}


@pytest.mark.parametrize("mode", ["train", "test", "test_volume"])
def test_parsers_match_jax_flag_for_flag(mode, monkeypatch):
    ours, ref = args.build_parser(mode), jargs.build_parser(mode)
    extra = {"--attn": "attn"} if mode == "train" else {}
    assert _options(ours) == {**_options(ref), **extra}
    got, want = vars(ours.parse_args([])), vars(ref.parse_args([]))
    assert got == {**want, **({"attn": None} if mode == "train" else {})}
    monkeypatch.setenv("MUDIFF_ATTN", "flash")  # not read
    cfg, a = args.parse_config([], mode=mode)
    assert a.attn == ("einsum" if mode == "train" else "bf16")
    assert cfg.use_int8 == (mode != "train")
    cfg, a = args.parse_config(["--attn", "flash", "--bf16"], mode=mode)
    assert a.attn == "flash" and not cfg.use_int8
    with pytest.raises(ValueError, match="unknown mode"):
        args.build_parser("run")
