"""The thread mapping of K2a / K2b (``csrc/fir_kernels.cu``), replayed in
PyTorch on the CPU and held against the plain versions and the JAX
package's Pallas kernels.

The replay follows the kernels' code: the 3-D grid (``blockIdx.z`` the
image, ``blockIdx.y`` a strip of DOWN_ROWS outputs or UP_ROWS input rows,
``blockIdx.x * THREADS + threadIdx.x`` split by one division into a
column and a channel vector of VECTOR_BYTES, or one channel on the
scalar path); each thread's rolling window of input rows, loaded one
step ahead and zero outside the image; and each output's order of
products (fp32 from 0, taps p outer and q inner), which it shares bit
for bit with the per-output reference order of ``test_torch_port_ops``.
The constants are read from the kernel source, so the replay follows
them.  The kernels themselves are held against the plain versions on
the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mudiff_torch import ops
from mudiff_torch.ops import _build
from mudiff_torch.ops.fir import VECTOR_BYTES as WRAPPER_VECTOR_BYTES
from mudiff_torch.ops.fir import correlation_taps, vector_path
from mudiff_tpu import ops as jops
from mudiff_tpu.ops import pallas_fir
from test_torch_port_ops import _down2_as_kernel, _up2_as_kernel

_SRC = (_build.CSRC / "fir_kernels.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


THREADS = _constant("THREADS")
VECTOR_BYTES = _constant("VECTOR_BYTES")
DOWN_ROWS = _constant("DOWN_ROWS")
UP_ROWS = _constant("UP_ROWS")


def geometry(down: bool, shape, itemsize: int, vector: bool):
    """(channels a thread, vectors a pixel, grid x, y, z) as
    ``launch_down`` / ``launch_up`` compute them."""
    b, h, w, c = shape
    n = VECTOR_BYTES // itemsize if vector else 1
    vecs = c // n
    cols = (w - 2) // 2 + 1 if down else w
    rows = (h - 2) // 2 + 1 if down else h
    strip = DOWN_ROWS if down else UP_ROWS
    return n, vecs, math.ceil(cols * vecs / THREADS), math.ceil(rows / strip), b


class Replay:
    """One launch of a K2 kernel, every thread at once: tensors are
    (image, strip, thread, channel of the thread's vector)."""

    def __init__(self, down: bool, x: torch.Tensor, taps: np.ndarray, vector: bool):
        b, self.h, self.w, self.c = x.shape
        n, vecs, gx, gy, _ = geometry(down, x.shape, x.element_size(), vector)
        t = torch.arange(gx * THREADS)
        col = t // vecs                      # the thread's one division
        cv = t - col * vecs
        limit = (self.w - 2) // 2 + 1 if down else self.w
        active = col < limit                 # the others return at once
        self.col = col[active][None, None, :, None]
        self.chan = (cv[active][:, None] * n + torch.arange(n))[None, None]
        self.z = torch.arange(b)[:, None, None, None]
        self.strip0 = (torch.arange(gy) * (DOWN_ROWS if down else UP_ROWS))[None, :, None, None]
        self.flat = x.float().reshape(-1)
        self.taps = torch.from_numpy(taps)   # float32: products round as the kernel's
        self.loads = []                      # (row, done): each load_row of a thread

    def value(self, y, xx):
        """The thread's vector at input (y, xx), zero outside the image."""
        ok = (y >= 0) & (y < self.h) & (xx >= 0) & (xx < self.w)
        idx = ((self.z * self.h + y.clamp(0, self.h - 1)) * self.w
               + xx.clamp(0, self.w - 1)) * self.c + self.chan
        return torch.where(ok, self.flat[idx], torch.zeros(()))

    def load_row(self, y, x0: torch.Tensor, cols: int, done):
        self.loads.append((y, done))
        return [self.value(y, x0 + q) for q in range(cols)]

    def fma(self, acc, p: int, q: int, v):
        return acc + self.taps[p, q] * v


def replay_down(x: torch.Tensor, taps: np.ndarray, vector: bool, owners=None):
    """fir_down2_kernel: each thread DOWN_ROWS outputs down one column,
    input rows 2i+1, 2i+2 of each step loaded a step ahead."""
    r = Replay(True, x, taps, vector)
    b, h, w, c = x.shape
    out_h, out_w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    out = torch.zeros((b, out_h, out_w, c), dtype=torch.float32)
    i0, j = r.strip0, r.col
    rows = (out_h - i0).clamp(max=DOWN_ROWS)
    x0 = 2 * j - 1
    every = torch.ones_like(i0, dtype=torch.bool)
    cur = [r.load_row(2 * i0 - 1, x0, 4, every), r.load_row(2 * i0, x0, 4, every)]
    ahead = [r.load_row(2 * i0 + 1, x0, 4, every), r.load_row(2 * i0 + 2, x0, 4, every)]

    def taps_row(acc, v, p):
        for q in range(4):
            acc = r.fma(acc, p, q, v[q])
        return acc

    acc = taps_row(taps_row(torch.zeros(()), cur[0], 0), cur[1], 1)
    for s in range(DOWN_ROWS):
        live = s < rows
        more = s + 1 < rows
        y = 2 * (i0 + s) + 1
        cur = ahead
        ahead = [r.load_row(y + 2, x0, 4, more), r.load_row(y + 3, x0, 4, more)]
        nxt = taps_row(taps_row(torch.zeros(()), cur[0], 0), cur[1], 1)
        acc = taps_row(taps_row(acc, cur[0], 2), cur[1], 3)
        _store(out, r, i0 + s, j, acc, live, owners)
        acc = nxt
    return out.to(x.dtype), r.loads


def replay_up(x: torch.Tensor, taps: np.ndarray, vector: bool, owners=None):
    """fir_up2_kernel: each thread UP_ROWS 2x2 quads down one column,
    input row m+1 of each step loaded a step ahead."""
    r = Replay(False, x, taps, vector)
    b, h, w, c = x.shape
    out = torch.zeros((b, 2 * h, 2 * w, c), dtype=torch.float32)
    m0, n = r.strip0, r.col
    rows = (h - m0).clamp(max=UP_ROWS)
    every = torch.ones_like(m0, dtype=torch.bool)
    below = r.load_row(m0, n - 1, 3, every)
    ahead = r.load_row(m0 + 1, n - 1, 3, every)

    def taps_row(acc, v, p):   # both column parities, b = 0, 1 in order
        return [r.fma(r.fma(acc[px], p, px, v[px]), p, px + 2, v[px + 1]) for px in range(2)]

    zero = [torch.zeros(()), torch.zeros(())]
    even = taps_row(zero, r.load_row(m0 - 1, n - 1, 3, every), 0)
    for s in range(UP_ROWS):
        live = s < rows
        more = s + 1 < rows
        cur, below = below, ahead
        ahead = r.load_row(m0 + s + 2, n - 1, 3, more)
        even = taps_row(even, cur, 2)
        odd = taps_row(taps_row(zero, cur, 1), below, 3)
        for px in range(2):
            _store(out, r, 2 * (m0 + s), 2 * n + px, even[px], live, owners)
            _store(out, r, 2 * (m0 + s) + 1, 2 * n + px, odd[px], live, owners)
        even = taps_row(zero, cur, 0)
    return out.to(x.dtype), r.loads


def _store(out, r: Replay, row, col, acc, live, owners):
    """out[z, row, col, chan] = acc where the thread's step is live; each
    store counted in ``owners``."""
    z, row, col, chan, acc, live = torch.broadcast_tensors(r.z, row, col, r.chan, acc, live)
    sel = (z[live], row[live], col[live], chan[live])
    out[sel] = acc[live]
    if owners is not None:
        owners.index_put_(sel, torch.ones(len(sel[0]), dtype=owners.dtype), accumulate=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _data(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (B, H, W, C): even and odd H and W, C on the scalar path (1, 3) and on
# the vector path in fp32 and bf16 (8, 64); strips that end early.  The
# even sizes are held against the Pallas kernels (down takes no other),
# the odd ones against the JAX package's XLA lowering.
FIR_CASES = [
    (2, 8, 8, 8),
    (1, 6, 10, 3),
    (1, 9, 7, 1),
    (2, 7, 10, 3),
    (1, 11, 6, 64),
    (1, 19, 5, 8),
    (1, 2, 3, 3),
]
KERNELS = [(1, 3, 3, 1), (1, 2, 5, 1)]   # the second is asymmetric: catches a missing flip


def _pallas_taps(k):
    """The JAX package's Pallas kernels correlate with ``k`` where
    upfirdn2d (and so the port) convolves with it: the same function for
    the model's symmetric kernel, the reversed kernel for another."""
    return tuple(reversed(k))


def _jax_reference(down: bool, x: np.ndarray, k) -> np.ndarray:
    """The JAX package's result: its Pallas kernel (interpret mode on the
    CPU) at even sizes, its XLA lowering at odd ones."""
    if x.shape[1] % 2 or x.shape[2] % 2:
        fn = jops.downsample_2d if down else jops.upsample_2d
        return np.asarray(fn(jnp.asarray(x), list(k), 2))
    fn = pallas_fir.downsample_2d_pallas if down else pallas_fir.upsample_2d_pallas
    return np.asarray(fn(jnp.asarray(x), _pallas_taps(k)))


@pytest.mark.parametrize("k", KERNELS)
@pytest.mark.parametrize("shape", FIR_CASES)
def test_k2a_replay_matches_plain_and_pallas(shape, k):
    x = _data(shape, seed=sum(shape))
    xt = _t(x)
    got, _ = replay_down(xt, correlation_taps(k, 1.0), vector_path(xt))
    torch.testing.assert_close(got, ops.downsample_2d(xt, k, 2), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), _jax_reference(True, x, k), atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", KERNELS)
@pytest.mark.parametrize("shape", FIR_CASES)
def test_k2b_replay_matches_plain_and_pallas(shape, k):
    x = _data(shape, seed=2 * sum(shape))
    xt = _t(x)
    got, _ = replay_up(xt, correlation_taps(k, 4.0), vector_path(xt))
    torch.testing.assert_close(got, ops.upsample_2d(xt, k, 2), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), _jax_reference(False, x, k), atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", KERNELS)
@pytest.mark.parametrize("shape", FIR_CASES[:4])
def test_replay_keeps_the_per_output_order_bit_for_bit(shape, k):
    """The rolling windows and zero halos change no rounding: each output
    sums the same products in the same order as the one-output-per-thread
    reference, so the fp32 bits agree exactly."""
    x = _data(shape, seed=3 + sum(shape))
    xt = _t(x)
    down, _ = replay_down(xt, correlation_taps(k, 1.0), vector_path(xt))
    up, _ = replay_up(xt, correlation_taps(k, 4.0), vector_path(xt))
    want_down = _down2_as_kernel(x, correlation_taps(k, 1.0))
    want_up = _up2_as_kernel(x, correlation_taps(k, 4.0))
    np.testing.assert_array_equal(down.numpy().view(np.int32), want_down.view(np.int32))
    np.testing.assert_array_equal(up.numpy().view(np.int32), want_up.view(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FIR_CASES)
def test_every_output_has_one_owner(shape, dtype):
    x = _t(_data(shape, seed=5)).to(dtype)
    vector = vector_path(x)
    b, h, w, c = shape
    owners = torch.zeros((b, (h - 2) // 2 + 1, (w - 2) // 2 + 1, c), dtype=torch.int32)
    replay_down(x, correlation_taps(KERNELS[0], 1.0), vector, owners)
    assert bool((owners == 1).all())
    owners = torch.zeros((b, 2 * h, 2 * w, c), dtype=torch.int32)
    replay_up(x, correlation_taps(KERNELS[0], 4.0), vector, owners)
    assert bool((owners == 1).all())


@pytest.mark.parametrize("shape", [(2, 9, 7, 8), (1, 11, 6, 64), (2, 8, 8, 3)])
def test_bf16_replay_within_the_kernels_tolerance(shape):
    """bf16 on the vector path (8 channels a thread): fp32 sums rounded
    once, within chip_smoke's TOL["bf16"] of the plain versions."""
    x = _t(_data(shape, seed=7)).to(torch.bfloat16)
    assert vector_path(x) == (shape[-1] % 8 == 0)
    down, _ = replay_down(x, correlation_taps(KERNELS[0], 1.0), vector_path(x))
    up, _ = replay_up(x, correlation_taps(KERNELS[0], 4.0), vector_path(x))
    assert down.dtype == up.dtype == torch.bfloat16
    torch.testing.assert_close(down.float(), ops.downsample_2d(x, KERNELS[0], 2).float(),
                               atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(up.float(), ops.upsample_2d(x, KERNELS[0], 2).float(),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("down", [True, False])
@pytest.mark.parametrize("shape", [(1, 19, 5, 8), (2, 8, 8, 3)])
def test_each_thread_loads_each_input_row_once(shape, down):
    """The rolling windows: a strip of r outputs loads 2r + 2 input rows
    (down) or r quads r + 2 rows (up), none twice."""
    x = _t(_data(shape, seed=9))
    replay = replay_down if down else replay_up
    _, loads = replay(x, correlation_taps(KERNELS[0], 4.0), vector_path(x))
    h = shape[1]
    out_h = (h - 2) // 2 + 1 if down else h
    strip = DOWN_ROWS if down else UP_ROWS
    for by in range(math.ceil(out_h / strip)):
        r = min(strip, out_h - by * strip)
        rows = [int(y.reshape(-1)[by]) for y, done in loads if bool(done.reshape(-1)[by])]
        assert len(rows) == len(set(rows)) == (2 * r + 2 if down else r + 2)


def test_vector_path_choice():
    """16-byte vectors along C when C * itemsize is a multiple of 16 and
    the tensor is 16-byte aligned; the wrapper's width is the source's."""
    assert WRAPPER_VECTOR_BYTES == VECTOR_BYTES == 16
    assert vector_path(torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16))
    assert vector_path(torch.zeros(1, 4, 4, 4))
    assert not vector_path(torch.zeros(1, 4, 4, 4, dtype=torch.bfloat16))
    assert not vector_path(torch.zeros(1, 4, 4, 3))
    assert not vector_path(torch.zeros(1, 4, 4, 1, dtype=torch.float16))
    buf = torch.zeros(2 + 4 * 4 * 64, dtype=torch.bfloat16)
    view = buf[2:].view(1, 4, 4, 64)        # contiguous, 4 bytes off alignment
    assert view.is_contiguous() and not vector_path(view)
    assert geometry(True, (1, 4, 4, 64), 2, True)[:2] == (8, 8)
    assert geometry(True, (1, 4, 4, 64), 2, False)[:2] == (1, 64)


@pytest.mark.parametrize("down,shape", [(True, (4, 256, 256, 64)), (True, (4, 128, 128, 128)),
                                        (False, (4, 64, 64, 256)), (False, (4, 128, 128, 128))])
def test_main_path_shapes_launch_enough_threads(down, shape):
    """The strip lengths leave the main path's batch-4 shapes at least 64K
    threads on the vector path, about 500 a streaming multiprocessor."""
    n, vecs, gx, gy, gz = geometry(down, shape, 2, True)
    assert n == 8 and vecs * n == shape[-1]
    cols = (shape[2] - 2) // 2 + 1 if down else shape[2]
    active = cols * vecs * gy * gz
    assert active >= 65536
    assert gx * THREADS >= cols * vecs > (gx - 1) * THREADS
