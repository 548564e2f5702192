"""The port's LPIPS against the JAX package's, on the CPU.

``random_params(0)``, the weights behind the ``lpips_rand`` key, are
drawn again in numpy (``jax.random``'s threefry, split and normal as JAX
0.9 computes them, ``jax_threefry_partitionable`` on): the split keys
are JAX's bits, the weights within 1e-6 of JAX's (XLA's float32 erfinv is
an approximation the port follows to within an ulp).  The metric on the
same (converted) weights equals JAX's at 64² within 1e-5, and the real
weights load from torch state dicts in both of their layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudiff_tpu.metrics import lpips as jlpips
from mudiff_torch.convert import lpips_from_flax
from mudiff_torch.metrics import lpips


@pytest.fixture(scope="module")
def jax_rand():
    return jlpips.random_params(0)


@pytest.mark.parametrize("seed,num", [(0, 2), (7, 3), (123456789, 4)])
def test_threefry_split_is_jax_bit_for_bit(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    np.testing.assert_array_equal(lpips.split(lpips.prng_key(seed), num), want)


def test_normal_is_jax_within_an_ulp():
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (4096,), jnp.float32))
    got = lpips.normal(lpips.prng_key(3), (4096,))
    np.testing.assert_allclose(got, want, rtol=2e-7 * 4, atol=1e-6)
    assert np.mean(got == want) > 0.98


def test_random_params_equal_jax(jax_rand):
    got, want = lpips.random_params(0), lpips_from_flax(jax_rand)
    assert got.keys() == want.keys()
    for name in got:
        if name.startswith("conv"):
            for part in ("weight", "bias"):
                torch.testing.assert_close(got[name][part], want[name][part], atol=1e-6,
                                           rtol=0)
        else:
            torch.testing.assert_close(got[name], want[name], atol=1e-6, rtol=0)


def test_distance_equals_jax_on_converted_weights(jax_rand):
    rng = np.random.RandomState(0)
    a, b = (rng.rand(2, 64, 64, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    want = np.asarray(jlpips._distance(jax_rand, jnp.asarray(a), jnp.asarray(b)))
    got = lpips.distance(lpips_from_flax(jax_rand), torch.from_numpy(a),
                         torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert want.min() > 0
    gt, pred = rng.rand(64, 64).astype(np.float32), rng.rand(64, 64).astype(np.float32)
    port = lpips.LPIPS(lpips_from_flax(jax_rand), is_random=True)
    assert port.key == "lpips_rand"
    np.testing.assert_allclose(port(gt, pred), jlpips.LPIPS(jax_rand, is_random=True)(gt, pred),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("layout", ["torchvision + lin", "lpips combined"])
def test_load_torch_weights_reads_both_layouts(layout, tmp_path, jax_rand):
    params = lpips_from_flax(jax_rand)
    tv = [0, 3, 6, 8, 10]
    lin = {f"lin{i}.model.1.weight": params[f"lin{i + 1}"].reshape(1, -1, 1, 1)
           for i in range(5)}
    if layout == "lpips combined":
        sd = {f"net.slice{i + 1}.{tv[i]}.{p}": params[f"conv{i + 1}"][p]
              for i in range(5) for p in ("weight", "bias")}
        torch.save({**sd, **lin}, tmp_path / "all.pth")
        got = lpips.load_torch_weights(str(tmp_path / "all.pth"))
        jgot = jlpips.load_torch_weights(str(tmp_path / "all.pth"))
    else:
        sd = {f"features.{tv[i]}.{p}": params[f"conv{i + 1}"][p]
              for i in range(5) for p in ("weight", "bias")}
        torch.save(sd, tmp_path / "alex.pth")
        torch.save(lin, tmp_path / "lin.pth")
        got = lpips.load_torch_weights(str(tmp_path / "alex.pth"), str(tmp_path / "lin.pth"))
        jgot = jlpips.load_torch_weights(str(tmp_path / "alex.pth"), str(tmp_path / "lin.pth"))
    want = lpips_from_flax(jax.tree_util.tree_map(np.asarray, jgot))
    for name in want:
        if name.startswith("conv"):
            assert torch.equal(got[name]["weight"], want[name]["weight"])
        else:
            assert torch.equal(got[name], want[name])
    with pytest.raises(KeyError, match="conv1"):
        torch.save({}, tmp_path / "empty.pth")
        lpips.load_torch_weights(str(tmp_path / "empty.pth"))
