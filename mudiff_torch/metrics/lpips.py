"""LPIPS (AlexNet backbone) in PyTorch.

The port of ``mudiff_tpu/metrics/lpips.py`` (parity source:
tools/metric_calc.py:23-46 of the reference, ``lpips.LPIPS(net='alex')``
on 3-channel [-1, 1] tensors built from [0, 1] grayscale): AlexNet conv
features tapped after each of the five ReLUs, unit-normalised over
channels, squared difference, a non-negative 1x1 "lin" weight per tap,
spatial mean, summed.  Plain ``F.conv2d``: the JAX package computes
these convs with ``lax.conv``, outside any Pallas kernel.

Parameters are a dict ``{"conv<i>": {"weight": (O, I, kh, kw), "bias":
(O,)}, "lin<i>": (C,)}`` of float32 tensors (torch's layout;
``convert.lpips_from_flax`` maps the JAX package's dict onto it).

* **Real LPIPS**: ``load_torch_weights(alexnet, lin)`` reads a
  torchvision ``alexnet-*.pth`` state dict and the lpips package's
  ``alex.pth`` lin checkpoint (or one combined ``lpips.LPIPS`` state
  dict) from the paths the caller gives; the values are then the
  reference metric's, under the key ``lpips``.
* **Random-feature proxy**: ``random_params(seed)`` is the JAX package's
  ``random_params(seed)``, drawn again here in numpy (the port cannot
  call JAX): ``jax.random.PRNGKey``, ``split`` and ``normal`` as JAX 0.9
  computes them with ``jax_threefry_partitionable`` on (its default),
  the normal as sqrt(2) erfinv(uniform(-1, 1)) with XLA's float32 erfinv
  approximation (``erfinv_f32``): the split keys and the uniforms are
  JAX's bits, the weights within about 1e-7 of JAX's.
  Reported under the distinct key ``lpips_rand``, as in the JAX package:
  these values are not LPIPS.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet feature stack (torchvision layout): (out_ch, kernel, stride, pad)
_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
# max-pool (3x3 stride 2) after taps 1 and 2
_POOL_AFTER = {0, 1}
# lpips ScalingLayer constants (input is [-1, 1] RGB)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_TV_INDEX = [0, 3, 6, 8, 10]  # conv module indices in torchvision's `features`


# -- jax.random's threefry, in numpy ----------------------------------------
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key`` (2,) uint32, as ``jax._src.prng``'s lowering computes it."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _iota_2x32(n: int):
    counts = np.arange(n, dtype=np.uint64)
    return (counts >> np.uint64(32)).astype(np.uint32), (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32): (0, seed)
    (a 32-bit seed padded with zeros; wider seeds depend on x64 in JAX)."""
    if not 0 <= seed < 2**32:
        raise ValueError("seed must be in [0, 2**32)")
    return np.array([0, seed], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` (the partitionable form): key i is
    the hash of the counter (0, i)."""
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key, *_iota_2x32(num))
    return np.stack([b1, b2], axis=1)


# XLA's float32 erfinv (Giles' approximation, as the stablehlo legalisation
# of chlo.erf_inv writes it): polynomials in w = -log1p(-x^2) for w < 5 and
# in sqrt(w) beyond.
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                        1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                        2.83297682], np.float32)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """``lax.erf_inv`` on float32 as XLA's CPU backend computes it: its
    Horner steps as fused multiply-adds (emulated in float64) and log1p
    rounded from float64.  Within one float32 ulp of XLA's values (XLA's
    own log1p is not reproduced); scipy's correctly rounded erfinv is up to
    1e-5 away in the tails, where the approximation itself is off."""
    x = x.astype(np.float32)
    w = (-np.log1p((x * -x).astype(np.float64))).astype(np.float32)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float64)
    p = np.where(small, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float64)
    for lt5, ge5 in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = (np.where(small, lt5, ge5).astype(np.float64) + p * w).astype(np.float32)
        p = p.astype(np.float64)
    out = p.astype(np.float32) * x
    return np.where(np.abs(x) == 1.0, x * np.float32(np.inf), out)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``: 32 random bits per
    element (the two hash words xor-ed), a uniform in [-1, 1) from the
    mantissa, then sqrt(2) erfinv."""
    n = int(np.prod(shape))
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key, *_iota_2x32(n))
    bits = b1 ^ b2
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    hi = np.float32(1.0)
    u = np.maximum(lo, floats * (hi - lo) + lo)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).reshape(shape)


def random_params(seed: int = 0) -> Dict:
    """The JAX package's fixed random AlexNet and uniform lin weights
    (``lpips_rand``), in the port's layout."""
    key = prng_key(seed)
    params: Dict = {}
    in_ch = 3
    for i, (out_ch, ksz, _, _) in enumerate(_CONVS):
        key, k = split(key)
        fan_in = ksz * ksz * in_ch
        hwio = normal(k, (ksz, ksz, in_ch, out_ch)) * np.float32(np.sqrt(2.0 / fan_in))
        params[f"conv{i + 1}"] = {
            "weight": torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 2, 0, 1))),
            "bias": torch.zeros(out_ch),
        }
        params[f"lin{i + 1}"] = torch.full((out_ch,), 1.0 / out_ch)
        in_ch = out_ch
    return params


def load_torch_weights(alexnet_path: str, lin_path: Optional[str] = None) -> Dict:
    """Read the real weights: a torchvision AlexNet state dict
    (``features.N.weight``) and the lpips package's lin checkpoint
    (``linN.model.1.weight``), or one combined ``lpips.LPIPS`` state dict
    (``net.sliceS.N.weight`` + ``linN.model.1.weight``)."""
    sd = torch.load(alexnet_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = dict(sd)
    if lin_path:
        sd.update(torch.load(lin_path, map_location="cpu", weights_only=True))
    params: Dict = {}
    for i in range(5):
        w = sd.get(f"features.{_TV_INDEX[i]}.weight")
        b = sd.get(f"features.{_TV_INDEX[i]}.bias")
        if w is None:
            w = sd.get(f"net.slice{i + 1}.{_TV_INDEX[i]}.weight")
            b = sd.get(f"net.slice{i + 1}.{_TV_INDEX[i]}.bias")
        if w is None:
            raise KeyError(f"conv{i + 1} weights not found in {alexnet_path}"
                           + (f" + {lin_path}" if lin_path else ""))
        params[f"conv{i + 1}"] = {"weight": w.to(torch.float32).contiguous(),
                                  "bias": b.to(torch.float32).contiguous()}
        lw = sd.get(f"lin{i}.model.1.weight")
        if lw is None:
            raise KeyError(f"lin{i}.model.1.weight not found")
        params[f"lin{i + 1}"] = lw.to(torch.float32).reshape(-1).contiguous()
    return params


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    # lpips normalize_tensor: eps is added to the norm, not under the sqrt
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


def distance(params: Dict, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, H, W, 3) in [-1, 1].  Returns the (B,) LPIPS distances."""
    shift = a.new_tensor(_SHIFT)
    scale = a.new_tensor(_SCALE)
    ha = ((a - shift) / scale).permute(0, 3, 1, 2)
    hb = ((b - shift) / scale).permute(0, 3, 1, 2)
    total = torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
    for i, (_, _, stride, pad) in enumerate(_CONVS):
        conv = params[f"conv{i + 1}"]
        ha = F.relu(F.conv2d(ha, conv["weight"], conv["bias"], stride, pad))
        hb = F.relu(F.conv2d(hb, conv["weight"], conv["bias"], stride, pad))
        d = (_unit_normalize(ha) - _unit_normalize(hb)) ** 2
        total = total + (d * params[f"lin{i + 1}"][None, :, None, None]).sum(dim=1).mean(
            dim=(1, 2))
        if i in _POOL_AFTER:
            ha, hb = F.max_pool2d(ha, 3, 2), F.max_pool2d(hb, 3, 2)
    return total


class LPIPS:
    """Pairwise LPIPS on [0, 1] grayscale arrays (reference
    tools/metric_calc.py:44-46: grayscale repeated to 3 channels, mapped
    to [-1, 1]), on ``device``.  ``key`` is ``lpips`` or, for the random
    proxy, ``lpips_rand``."""

    def __init__(self, params: Dict, is_random: bool = False, device="cpu"):
        self.device = torch.device(device)
        self.params = {k: ({n: t.to(self.device) for n, t in v.items()}
                           if isinstance(v, dict) else v.to(self.device))
                       for k, v in params.items()}
        self.is_random = is_random
        self.key = "lpips_rand" if is_random else "lpips"

    @torch.no_grad()
    def __call__(self, gt: np.ndarray, pred: np.ndarray) -> float:
        def rgb(img):
            t = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
            return (t[None, ..., None] * 2.0 - 1.0).repeat(1, 1, 1, 3)

        return float(distance(self.params, rgb(gt), rgb(pred))[0])
