"""The JAX package's dynamic W8A8 conv and the port's on one routed site's
input, on the CPU.

``witness`` takes what ``int8_sites.py --capture SITE`` saved on the card
(one example's input to a routed conv, with its weight and bias) and runs
``mudiff_tpu/ops/int8_conv.py``'s ``int8_conv3x3`` (dynamic per-example
scales, jitted) and the port's (its plain version) on it.  It reports
each one's relative error from the port's bf16 conv and how far apart the
two outputs lie.  The same large error in both says the JAX package gives
that site the same loss.  The test holds this on a small input whose
channel ranges are skewed, so that one per-example scale is coarse.  On a
capture:

    PYTHONPATH=. JAX_PLATFORMS=cpu OMP_NUM_THREADS=4 \\
        python tests/test_torch_port_int8_witness.py int8_site_g2_0.pt
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mudiff_tpu.ops import int8_conv as jint8
from mudiff_torch.ops import int8_conv
from mudiff_torch.ops.conv3x3 import conv3x3


def witness(cap: dict) -> dict:
    """Both packages' dynamic int8 conv of ``cap["x"]`` against the bf16
    conv, and the readings ``int8_sites.py`` took on the card beside them."""
    x, w, bias = cap["x"], cap["w"], cap["bias"]
    dtype = torch.bfloat16 if cap["dtype"] == "torch.bfloat16" else torch.float32
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = conv3x3(x.to(dtype), w.to(dtype), bias).float()
    port = int8_conv.int8_conv3x3(x, w, bias, compute_dtype=dtype).float()
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if x.dtype == torch.bfloat16
                                                 else jnp.float32)
    bj = None if bias is None else jnp.asarray(bias.numpy())
    out = jax.jit(lambda x, w, b: jint8.int8_conv3x3(x, w, b, compute_dtype=jdtype))(
        xj, jnp.asarray(w.numpy()), bj)
    jx = torch.from_numpy(np.array(out.astype(jnp.float32)))
    den = float(ref.norm())
    return {"site": cap["site"], "shape": list(x.shape), "cout": int(w.shape[-1]),
            "port_dyn_err": float((port - ref).norm()) / den,
            "jax_dyn_err": float((jx - ref).norm()) / den,
            "port_vs_jax_max_abs": float((port - jx).abs().max()),
            "port_vs_jax_same_bits": float((port == jx).double().mean()),
            "card": {k: cap[k] for k in ("call", "example", "dyn_call", "dyn_example",
                                         "dyn_mean")}}


def test_jax_and_port_lose_the_same_on_a_coarse_per_example_scale(tmp_path):
    """One channel 30x the others: a per-example scale leaves the rest a
    few levels, and both packages give the same bits and error."""
    rng = np.random.RandomState(7)
    x = rng.randn(1, 10, 9, 64).astype(np.float32)
    x[..., 5] *= 30.0
    w = (rng.randn(3, 3, 64, 32) / np.sqrt(9 * 64)).astype(np.float32)
    b = (0.1 * rng.randn(32)).astype(np.float32)
    cap = {"site": "g2#0", "x": torch.from_numpy(x).to(torch.bfloat16),
           "w": torch.from_numpy(w), "bias": torch.from_numpy(b), "dtype": "torch.bfloat16",
           "call": 0, "example": 0, "dyn_call": 0.1, "dyn_example": 0.1, "dyn_mean": 0.1}
    torch.save(cap, tmp_path / "cap.pt")
    got = witness(torch.load(tmp_path / "cap.pt"))
    assert got["port_vs_jax_same_bits"] == 1.0 and got["port_vs_jax_max_abs"] == 0.0
    assert got["port_dyn_err"] == got["jax_dyn_err"] > 0.04
    x[..., 5] /= 30.0
    fine = witness({**cap, "x": torch.from_numpy(x).to(torch.bfloat16)})
    assert fine["jax_dyn_err"] < got["jax_dyn_err"] / 3


if __name__ == "__main__":
    print(json.dumps(witness(torch.load(sys.argv[1]))))
