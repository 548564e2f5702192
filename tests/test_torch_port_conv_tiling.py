"""The index math of the tensor-core kernels, emulated in PyTorch on the
CPU and held against the plain versions.

* K1 (``csrc/conv3x3_kernel.cu``, ``conv3x3_kernel_tc``): the implicit
  GEMM's order. M = B*H*W pixels in NHWC order, N = Cout, K = 9*Cin
  tap-major; BM x BN block tiles with masked tails; K steps of BK, padded
  per tap when Cin % 8 == 0 and packed across taps (scalar loads) when not;
  zero-filled halos and channel tails; the fp32 bias added to the fp32
  sum, one rounding.
* K3 (``csrc/flash_attn_kernel.cu``, ``flash_attn_kernel_tc``): the
  per-warp online softmax. Query tiles of BQ, key tiles of BK; with
  C > 256 two warps split each tile's keys and the output's columns,
  share the row maximum and add their partial row sums at the end; p
  rounded to the input dtype per tile; one division by l.

The tile constants are read from the kernel sources, so the emulation
follows them. The kernels themselves are held against the plain versions
on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import math
import re

import numpy as np
import pytest
import torch

from mudiff_torch.ops import _build, conv3x3_plain, flash_attn_plain, row_stats_plain


def _constants(source: str, namespace: str) -> str:
    text = (_build.CSRC / source).read_text()
    return text[text.index(f"namespace {namespace} {{"):]


_CONV = _constants("conv3x3_kernel.cu", "tcconv")
# (BM, BN, BK) of each block tile
TILES = {name: tuple(int(v) for v in re.search(
    rf"using {name} = Tile<(\d+), (\d+), \d+, \d+, (\d+), \d+>;", _CONV).groups())
    for name in ("TileN128", "TileN64")}
_ATTN = _constants("flash_attn_kernel.cu", "tcattn")
BQ_ATTN = int(re.search(r"constexpr int BQ = (\d+);", _ATTN).group(1))
BK_ATTN = int(re.search(r"constexpr int BK = (\d+);", _ATTN).group(1))


def k1_tile(cout: int):
    """(BM, BN, BK) of the launch: as ``tcconv::launch`` picks it."""
    return TILES["TileN64"] if cout <= 64 else TILES["TileN128"]


def k1_steps(cin: int, bk: int):
    """(wide path, K steps): as ``tcconv::launch_tile`` counts them."""
    wide = cin % 8 == 0
    chunks = math.ceil(cin / bk)
    return wide, (9 * chunks if wide else math.ceil(9 * cin / bk))


def k1_emulate(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K1's implicit GEMM, one K step at a time over all block tiles."""
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    bm, bn, bk = k1_tile(cout)
    wide, steps = k1_steps(cin, bk)
    chunks = math.ceil(cin / bk)
    m_total = b * h * wd
    m_pad = math.ceil(m_total / bm) * bm
    n_pad = math.ceil(cout / bn) * bn
    xf = x.float().reshape(-1)
    wf = w.float().reshape(9 * cin, cout)
    m = torch.arange(m_pad)
    in_m = m < m_total
    rem = m % (h * wd)
    ph = torch.where(in_m, rem // wd, torch.full_like(rem, -4))
    pw = rem % wd
    kk = torch.arange(bk)
    co = torch.arange(n_pad)
    acc = torch.zeros(m_pad, n_pad)
    for s in range(steps):
        if wide:  # one tap, a BK-channel chunk
            tap = s // chunks
            ci0 = (s - tap * chunks) * bk
            wrow0, klimit = tap * cin + ci0, cin - ci0
            dy, dx = tap // 3 - 1, tap % 3 - 1
            ci = ci0 + kk
            hh, ww = ph + dy, pw + dx
            ok = (((hh >= 0) & (hh < h) & (ww >= 0) & (ww < wd))[:, None]
                  & (ci < cin)[None, :])
            idx = m[:, None] * cin + (dy * wd + dx) * cin + ci[None, :]
        else:  # packed: k = tap * cin + ci
            wrow0 = s * bk
            klimit = 9 * cin - wrow0
            k = wrow0 + kk
            t, ci = k // cin, k % cin
            n, r = m // (h * wd), m % (h * wd)
            hh = (r // wd)[:, None] + (t // 3 - 1)[None, :]
            ww = (r % wd)[:, None] + (t % 3 - 1)[None, :]
            ok = (in_m[:, None] & (k < 9 * cin)[None, :]
                  & (hh >= 0) & (hh < h) & (ww >= 0) & (ww < wd))
            idx = ((n[:, None] * h + hh) * wd + ww) * cin + ci[None, :]
        a = torch.where(ok, xf[idx.clamp(0, xf.numel() - 1)], torch.zeros(()))
        rows = (wrow0 + kk).clamp(max=9 * cin - 1)
        b_ok = (kk < klimit)[:, None] & (co < cout)[None, :]
        b_tile = torch.where(b_ok, wf[rows][:, co.clamp(max=cout - 1)], torch.zeros(()))
        acc += a @ b_tile
    acc += torch.nn.functional.pad(bias.float(), (0, n_pad - cout))
    return acc[:m_total, :cout].to(x.dtype).reshape(b, h, wd, cout)


# (x shape, Cout): the narrow stems and head, Cin / Cout not multiples of
# 32 or 128, H and W not multiples of anything, a pixel count past one tile
CONV_CASES = [
    ((2, 5, 7, 1), 64),     # the head's dx: Cin 1, packed K
    ((1, 9, 6, 4), 256),    # stem, G1
    ((1, 6, 9, 5), 320),    # stem, G2
    ((2, 7, 5, 64), 1),     # the head: Cout 1
    ((1, 6, 7, 320), 5),    # the stem's dx: Cout 5
    ((1, 5, 9, 192), 384),  # Cin 192: whole chunks a tap; Cout 384: 3 N tiles
    ((2, 17, 19, 24), 40),  # Cin 24: one padded chunk a tap; M past one tile
]


@pytest.mark.parametrize("xshape,cout", CONV_CASES)
def test_k1_emulation_matches_plain_fp32(xshape, cout):
    rng = np.random.RandomState(sum(xshape) + cout)
    x = torch.from_numpy(rng.randn(*xshape).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, xshape[-1], cout) / math.sqrt(9 * xshape[-1]))
                         .astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.randn(cout).astype(np.float32))
    got = k1_emulate(x, w, bias)
    torch.testing.assert_close(got, conv3x3_plain(x, w, bias), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("xshape,cout", CONV_CASES[:5])
def test_k1_emulation_matches_plain_bf16(xshape, cout):
    """The kernel's tolerance in bf16 (chip_smoke TOL): both sum the bf16
    operands in fp32 and round once, in different orders."""
    rng = np.random.RandomState(7 + cout)
    x = torch.from_numpy(rng.randn(*xshape).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.randn(3, 3, xshape[-1], cout) / math.sqrt(9 * xshape[-1]))
                         .astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(0.1 * rng.randn(cout).astype(np.float32))
    got = k1_emulate(x, w, bias)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), conv3x3_plain(x, w, bias).float(),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("cin,steps", [(1, (1, 1)), (4, (2, 1)), (5, (2, 1)), (64, (18, 9)),
                                       (192, (54, 27)), (320, (90, 45)), (24, (9, 9))])
def test_k1_k_steps(cin, steps):
    """K padded per tap for Cin % 8 == 0, packed across taps otherwise;
    (steps at BK = 32, steps at BK = 64)."""
    assert (k1_steps(cin, 32)[1], k1_steps(cin, 64)[1]) == steps


def test_k1_tiles_cover_every_block():
    """Each launch is one grid of BM x BN tiles: both tiles hold 8 warps
    of 64 x 32, and the narrow-Cout tile takes Cout <= 64."""
    assert k1_tile(64)[:2] == (256, 64) and k1_tile(65)[:2] == (128, 128)
    for bm, bn, bk in TILES.values():
        assert (bm // 64) * (bn // 32) == 8 and bk % 16 == 0


def k3_emulate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """K3's per-warp online softmax: (output in q.dtype, (2, B, L) stats)."""
    b, length, c = q.shape
    split = 2 if c > 256 else 1
    kw = BK_ATTN // split
    out = torch.empty_like(q)
    stats = torch.empty(2, b, length)

    def rows(t, r0, n):
        block = torch.zeros(n, c)
        block[:max(0, min(n, length - r0))] = t[r0:r0 + n].float()
        return block

    for bi in range(b):
        for q0 in range(0, length, BQ_ATTN):
            qt = rows(q[bi], q0, BQ_ATTN)
            m = torch.full((BQ_ATTN,), -math.inf)
            l_part = torch.zeros(BQ_ATTN, split)   # each warp of a row group
            o = torch.zeros(BQ_ATTN, c)
            for k0 in range(0, length, BK_ATTN):
                s = (qt @ rows(k[bi], k0, BK_ATTN).T) * scale
                s[:, (torch.arange(BK_ATTN) + k0) >= length] = -math.inf
                # each warp's maximum over its keys, shared across the group
                mx = torch.stack([s[:, j * kw:(j + 1) * kw].amax(1) for j in range(split)])
                m_new = torch.maximum(m, mx.amax(0))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[:, None])
                l_part = l_part * alpha[:, None] + torch.stack(
                    [p[:, j * kw:(j + 1) * kw].sum(1) for j in range(split)], dim=1)
                o = o * alpha[:, None] + p.to(q.dtype).float() @ rows(v[bi], k0, BK_ATTN)
                m = m_new
            l_tot = l_part.sum(1)
            n = min(BQ_ATTN, length - q0)
            out[bi, q0:q0 + n] = (o / l_tot[:, None])[:n].to(q.dtype)
            stats[0, bi, q0:q0 + n] = m[:n]
            stats[1, bi, q0:q0 + n] = l_tot[:n]
    return out, stats


# (B, L, C): the path's head dim with a ragged length, the nf=128 width
# (two warps a row group), a head dim that is not a multiple of 8
ATTN_CASES = [(1, 1000, 256), (1, 1000, 512), (2, 200, 132), (1, 70, 8)]


@pytest.mark.parametrize("shape", ATTN_CASES)
def test_k3_emulation_matches_plain_fp32(shape):
    rng = np.random.RandomState(shape[1] + shape[2])
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32)) for _ in range(3))
    q = 2.0 * q
    scale = float(shape[2]) ** -0.5
    got, stats = k3_emulate(q, k, v, scale)
    torch.testing.assert_close(got, flash_attn_plain(q, k, v, scale), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(stats, row_stats_plain(q, k, scale), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", ATTN_CASES)
def test_k3_emulation_matches_plain_bf16(shape):
    """The kernel's bf16 tolerance (chip_smoke FLASH_TOL): p is rounded
    per tile before p.v, the plain version rounds the normalised weights."""
    rng = np.random.RandomState(3 * shape[1] + shape[2])
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    scale = float(shape[2]) ** -0.5
    got, stats = k3_emulate(q, k, v, scale)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), flash_attn_plain(q, k, v, scale).float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(stats, row_stats_plain(q, k, scale), atol=1e-5, rtol=1e-5)


def test_k3_tile_constants():
    """Four row groups of 16 queries a block, key tiles that split evenly
    across two warps."""
    assert BQ_ATTN == 64 and BK_ATTN % 32 == 0
