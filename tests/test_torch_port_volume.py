"""mudiff_torch whole-volume prediction vs the JAX package, on the CPU.

The volume helpers (normalisation, slice bounds, resize, reassembly) and
the NIfTI reader/writer are held to the JAX package's own.  Then the
whole ``predict_volume`` runs in both packages at a tiny fp32 config on
32x32x10 volumes (5 slices through a batch of 4, so the tail batch is
padded): the JAX side gets its generators' params directly; the port
gets the same weights through ``convert.export_generators`` ->
``load_generators``, and the JAX package's per-batch key splits
(``infer/volume.py:173-176``, ``diffusion/sampling.py:168-170``) replayed
through ``draws``.  Tolerance as the sampler test: atol = rtol = 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudiff_tpu.config import MuDiffConfig as JaxConfig
from mudiff_tpu.infer import volume as jvolume
from mudiff_tpu.models import NCSNppGenerator as JaxGenerator
from mudiff_tpu.utils import nifti as jnifti
from mudiff_torch.config import MuDiffConfig
from mudiff_torch.convert import export_generators
from mudiff_torch.infer import load_generators, predict_volume, save_generators, volume
from mudiff_torch.utils import nifti
from test_torch_port_helpers import random_flax_params

TINY = dict(image_size=16, num_channels=1, num_channels_dae=8, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(8,), z_emb_dim=16, nz=8, n_mlp=2,
            use_bf16=False, target_modality="T1CE")
SHAPE = (32, 32, 10)
HALF, BATCH, SEED = 2, 4, 7


def _volume(seed, shape=SHAPE):
    """A brain-like blob: positive inside an ellipsoid, zero outside."""
    rng = np.random.RandomState(seed)
    grid = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape], indexing="ij")
    inside = sum(g * g for g in grid) < 0.8
    return (inside * (1.0 + np.abs(rng.randn(*shape)))).astype(np.float32)


def test_normalisation_matches_jax():
    vol = _volume(0) * 300.0
    np.testing.assert_allclose(volume.robust_minmax_to_minus1_1(vol),
                               jvolume.robust_minmax_to_minus1_1(vol), atol=1e-6, rtol=1e-6)
    mask = vol > 400.0
    np.testing.assert_allclose(volume.robust_minmax_to_minus1_1(vol, mask, 5.0, 95.0),
                               jvolume.robust_minmax_to_minus1_1(vol, mask, 5.0, 95.0),
                               atol=1e-6, rtol=1e-6)
    for flat in (np.zeros(SHAPE, np.float32), np.full(SHAPE, 3.0, np.float32)):
        np.testing.assert_array_equal(volume.robust_minmax_to_minus1_1(flat),
                                      jvolume.robust_minmax_to_minus1_1(flat))


@pytest.mark.parametrize("depth,half", [(155, 80), (155, 12), (10, 2), (1, 3), (8, 0)])
def test_slice_bounds_match_jax(depth, half):
    assert volume._slice_bounds(depth, half) == jvolume._slice_bounds(depth, half)


@pytest.mark.parametrize("hw,size", [((32, 32), 16), ((37, 29), 48), ((240, 240), 256),
                                     ((16, 16), 16)])
def test_resize_matches_jax(hw, size):
    img = np.random.RandomState(3).rand(*hw).astype(np.float32) * 2 - 1
    ours = volume._bilinear_resize(img, size)
    assert ours.dtype == np.float32 and ours.shape == (size, size)
    np.testing.assert_allclose(ours, jvolume._bilinear_resize(img, size), atol=1e-5, rtol=1e-5)


def test_reassembly_matches_jax():
    shape = (21, 23, 15)
    s0, s1 = volume._slice_bounds(shape[2], 4)
    rng = np.random.RandomState(2)
    predicted = [rng.rand(16, 16).astype(np.float32) for _ in range(s1 - s0 + 1)]
    ours = volume.reconstruct_volume_from_slices(list(predicted), shape, s0, s1)
    np.testing.assert_allclose(
        ours, jvolume.reconstruct_volume_from_slices(list(predicted), shape, s0, s1),
        atol=1e-5, rtol=1e-5)
    assert not ours[:, :, :s0].any() and not ours[:, :, s1 + 1:].any()


@pytest.mark.parametrize("suffix", [".nii.gz", ".nii"])
@pytest.mark.parametrize("writer,reader", [(jnifti, nifti), (nifti, jnifti)],
                         ids=["jax-to-port", "port-to-jax"])
def test_nifti_round_trip_between_packages(tmp_path, suffix, writer, reader):
    vol = _volume(1)
    affine = np.array([[0, -1.5, 0, 10], [1.5, 0, 0, -4], [0, 0, 2.0, 7], [0, 0, 0, 1]])
    path = str(tmp_path / f"v{suffix}")
    writer.save(vol, affine, path)
    img = reader.load(path)
    np.testing.assert_array_equal(img.get_fdata(), vol)
    np.testing.assert_allclose(img.affine, affine, rtol=1e-6)
    again = str(tmp_path / f"w{suffix}")
    reader.save(img.get_fdata() * 2, img.affine, again, header=img.header_bytes)
    back = writer.load(again)
    np.testing.assert_array_equal(back.get_fdata(), 2 * vol)
    assert back.header_bytes == img.header_bytes


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("vol_in")
    affine = np.diag([1.0, 1.0, 2.0, 1.0])
    paths = {}
    for i, m in enumerate(("FLAIR", "T2", "T1")):
        paths[m] = str(d / f"{m}.nii.gz")
        nifti.save(_volume(10 + i) * (100.0 + 50 * i), affine, paths[m])
    return paths


@functools.lru_cache(maxsize=None)
def _jax_params():
    img = jnp.zeros((BATCH, 16, 16, 1))
    t0, z0 = jnp.zeros((BATCH,), jnp.int32), jnp.zeros((BATCH, TINY["nz"]))
    out = []
    for adaptive in (False, True):
        m = JaxGenerator(config=JaxConfig(**TINY), adaptive=adaptive)
        kw = {"pseudo_target": img} if adaptive else {}
        out.append((m, random_flax_params(m, img, img, img, img, t0, z0,
                                          seed=30 + adaptive, **kw)))
    return out


def _jax_draws(n_batches, steps=4):
    """The JAX package's x_init and per-step (z, noise), as torch tensors."""
    key = jax.random.PRNGKey(SEED)
    shape = (BATCH, 16, 16, 1)
    for _ in range(n_batches):
        key, k_init, k = jax.random.split(key, 3)
        x_init = torch.from_numpy(np.array(jax.random.normal(k_init, shape, jnp.float32)))
        noise = []
        for _ in range(steps):
            k, kz, kp = jax.random.split(k, 3)
            noise.append((torch.from_numpy(np.array(jax.random.normal(kz, (BATCH, TINY["nz"])))),
                          torch.from_numpy(np.array(jax.random.normal(kp, shape)))))
        yield x_init, noise


@pytest.fixture(scope="module")
def jax_volume(inputs, tmp_path_factory):
    (m1, p1), (m2, p2) = _jax_params()
    out = jvolume.predict_volume(
        JaxConfig(**TINY), inputs, str(tmp_path_factory.mktemp("jax_out")),
        slice_half_range=HALF, batch_size=BATCH, seed=SEED, generators=(m1, m2, p1, p2))
    return jnifti.load(out)


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_predict_volume_matches_jax(inputs, jax_volume, tmp_path, attn):
    """The JAX side runs the exact einsum (``flash`` is the einsum on the
    CPU backend); the port's ``flash`` runs K3's plain version."""
    (_, p1), (_, p2) = _jax_params()
    ckpt = str(tmp_path / "ckpt")
    export_generators(p1, p2, ckpt)
    out = predict_volume(MuDiffConfig(**TINY), inputs, str(tmp_path / "out"), ckpt_dir=ckpt,
                         slice_half_range=HALF, batch_size=BATCH, device="cpu", attn=attn,
                         draws=_jax_draws(2))
    ours, ref = nifti.load(out), jax_volume
    assert ours.shape == ref.shape == SHAPE
    np.testing.assert_allclose(ours.affine, ref.affine)
    band = ref.get_fdata()[:, :, SHAPE[2] // 2 - HALF:SHAPE[2] // 2 + HALF + 1]
    assert band.std() > 1e-2 and not ref.get_fdata()[:, :, 0].any()
    np.testing.assert_allclose(ours.get_fdata(), ref.get_fdata(), atol=1e-3, rtol=1e-3)


def test_predict_volume_is_seeded_and_checks_its_inputs(inputs, tmp_path):
    cfg = MuDiffConfig(**TINY)
    (_, p1), (_, p2) = _jax_params()
    with pytest.raises(FileNotFoundError, match="gen_diffusive_1.pt"):
        load_generators(cfg, str(tmp_path / "none"), str(tmp_path / "also_none"), device="cpu")
    export_generators(p1, p2, str(tmp_path / "ckpt"))
    gens = load_generators(cfg, str(tmp_path / "elsewhere"), str(tmp_path / "ckpt"),
                           device="cpu", attn="flash")
    save_generators(str(tmp_path / "again"), *gens)
    runs = [nifti.load(predict_volume(cfg, inputs, str(tmp_path / f"o{i}"), generators=g,
                                      slice_half_range=HALF, batch_size=BATCH, seed=5,
                                      device="cpu")).get_fdata()
            for i, g in enumerate((gens, load_generators(cfg, str(tmp_path / "again"),
                                                         device="cpu", attn="flash")))]
    np.testing.assert_array_equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="Missing required input for T2"):
        predict_volume(cfg, {"FLAIR": inputs["FLAIR"], "T1": inputs["T1"]}, str(tmp_path),
                       generators=gens, device="cpu")
    # int8 serving: dynamic scales without sidecars, which --int8_static requires
    g1, _ = load_generators(cfg.replace(use_int8=True), str(tmp_path / "ckpt"), device="cpu")
    assert g1.config.use_int8 and g1.int8_calib is None
    with pytest.raises(FileNotFoundError, match="int8_calib_g1.json"):
        load_generators(cfg.replace(use_int8=True, int8_static=True), str(tmp_path / "ckpt"),
                        device="cpu")


def test_export_generators_from_an_orbax_checkpoint(tmp_path):
    """README's recipe: orbax restore -> numpy -> export_generators ->
    load_generators gives the same weights."""
    import orbax.checkpoint as ocp

    (_, p1), (_, p2) = _jax_params()
    for name, params in (("gen_diffusive_1", p1), ("gen_diffusive_2", p2)):
        ocp.PyTreeCheckpointer().save(str(tmp_path / name), params)
    restore = lambda name: jax.tree_util.tree_map(  # noqa: E731
        np.asarray, ocp.PyTreeCheckpointer().restore(str(tmp_path / name)))
    export_generators(restore("gen_diffusive_1"), restore("gen_diffusive_2"),
                      str(tmp_path / "ckpt"))
    g1, _ = load_generators(MuDiffConfig(**TINY), str(tmp_path / "ckpt"), device="cpu")
    np.testing.assert_array_equal(g1.final_conv.weight.numpy(),
                                  p1["final_conv"]["conv"]["kernel"])


def test_predict_volume_defaults_to_the_card(inputs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_volume(MuDiffConfig(**TINY), inputs, str(tmp_path), ckpt_dir=str(tmp_path))
