"""The index math of kernel K4's s8 implicit GEMM
(``csrc/int8_conv_kernel.cu``, ``s8conv::conv_kernel``), emulated in
PyTorch on the CPU and held against the plain version's exact
accumulator.

K4 differs from K1 where bytes differ from 16-bit elements: the
``mma.sync.m16n8k32`` s8 fragments (A 16 x 32, B 32 x 8, four bytes a
register), a weight stored (Cout, 9 * Cin) with K contiguous so that both
operand tiles load with a non-transposed ``ldmatrix``, 16-channel
``cp.async`` chunks, and an epilogue that stores from the fragments.
The constants are read from the kernel source (keep their
``constexpr int NAME = N;`` lines in one-line form); the kernel itself is
held against the plain version on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import math
import re

import numpy as np
import pytest
import torch

from mudiff_torch.ops import _build
from mudiff_torch.ops.int8_conv import conv_acc_plain

_SRC = (_build.CSRC / "int8_conv_kernel.cu").read_text()
_NS = _SRC[_SRC.index("namespace s8conv {"):]


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _NS).group(1))


THREADS, BM, BN, BK = _const("THREADS"), _const("BM"), _const("BN"), _const("BK")
WM, WN, PAD = _const("WM"), _const("WN"), _const("PAD")
TM, TN = BM // WM, BN // WN
MT, NT = TM // 16, TN // 8
LDS = BK + PAD


def ldsm_x4(smem: torch.Tensor, addr) -> torch.Tensor:
    """``ldmatrix.x4`` (b16) on a byte tile: lane l gives ``addr(l)`` =
    (row, byte) of row l % 8 of matrix l // 8; lane t receives, from each
    matrix, the 4 bytes at row t // 4, bytes 4 * (t % 4) ...  Returns
    (32 lanes, 4 registers, 4 bytes)."""
    rows = [smem[r, b:b + 16] for r, b in (addr(lane) for lane in range(32))]
    regs = torch.empty(32, 4, 4, dtype=smem.dtype)
    for t in range(32):
        for j in range(4):
            word = t % 4
            regs[t, j] = rows[8 * j + t // 4][4 * word:4 * word + 4]
    return regs


def mma_a(regs: torch.Tensor) -> torch.Tensor:
    """The 16 x 32 A the m16n8k32 s8 mma reads from the lanes' a0..a3."""
    a = torch.empty(16, 32, dtype=regs.dtype)
    for t in range(32):
        g, c = t // 4, t % 4
        a[g, 4 * c:4 * c + 4] = regs[t, 0]
        a[g + 8, 4 * c:4 * c + 4] = regs[t, 1]
        a[g, 16 + 4 * c:20 + 4 * c] = regs[t, 2]
        a[g + 8, 16 + 4 * c:20 + 4 * c] = regs[t, 3]
    return a


def mma_b(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """The 32 x 8 B (k x n) the mma reads from the lanes' b0, b1."""
    b = torch.empty(32, 8, dtype=b0.dtype)
    for t in range(32):
        g, c = t // 4, t % 4
        b[4 * c:4 * c + 4, g] = b0[t]
        b[16 + 4 * c:20 + 4 * c, g] = b1[t]
    return b


def d_positions(t: int):
    """(row, col) of d0..d3 of lane t in the 16 x 8 s32 tile."""
    g, c = t // 4, t % 4
    return [(g, 2 * c), (g, 2 * c + 1), (g + 8, 2 * c), (g + 8, 2 * c + 1)]


def warp_product(a_s: torch.Tensor, b_s: torch.Tensor, warp: int) -> torch.Tensor:
    """One K step of one warp, as the kernel loads and multiplies: its TM x TN
    s32 sums from the shared A rows (BM x LDS bytes) and B rows (BN x LDS)."""
    warp_m, warp_n = warp // WN, warp % WN
    acc = torch.zeros(TM, TN, dtype=torch.int64)
    for kk in range(0, BK, 32):
        af = [ldsm_x4(a_s, lambda lane, i=i: (warp_m * TM + i * 16 + (lane & 15),
                                              kk + (lane >> 4) * 16)) for i in range(MT)]
        bf = {}
        for j in range(0, NT, 2):
            r = ldsm_x4(b_s, lambda lane, j=j: (warp_n * TN + j * 8 + (lane & 7) + (lane >> 4) * 8,
                                                kk + ((lane >> 3) & 1) * 16))
            bf[j], bf[j + 1] = (r[:, 0], r[:, 1]), (r[:, 2], r[:, 3])
        for i in range(MT):
            a = mma_a(af[i]).long()
            for j in range(NT):
                d = a @ mma_b(*bf[j]).long()
                for t in range(32):  # the accumulator fragments, as the epilogue reads them
                    for (row, col) in d_positions(t):
                        acc[i * 16 + row, j * 8 + col] += d[row, col]
    return acc


def test_fragments_give_the_tile_product():
    """Every warp's fragments, as ldmatrix loads them from the padded shared
    rows and m16n8k32 reads them, multiply to A_tile . B_tile^T."""
    g = torch.Generator().manual_seed(0)
    a_s = torch.randint(-127, 128, (BM, LDS), generator=g, dtype=torch.int8)
    b_s = torch.randint(-127, 128, (BN, LDS), generator=g, dtype=torch.int8)
    want = a_s[:, :BK].long() @ b_s[:, :BK].long().T
    for warp in (0, WN - 1, THREADS // 32 - 1):
        wm, wn = warp // WN, warp % WN
        got = warp_product(a_s, b_s, warp)
        assert torch.equal(got, want[wm * TM:(wm + 1) * TM, wn * TN:(wn + 1) * TN]), warp


def test_epilogue_writes_every_output_of_a_block_once():
    seen = torch.zeros(BM, BN, dtype=torch.int64)
    for warp in range(THREADS // 32):
        wm, wn = warp // WN, warp % WN
        for lane in range(32):
            for i in range(MT):
                for half in range(2):
                    row = wm * TM + i * 16 + (lane >> 2) + half * 8
                    for j in range(NT):
                        col = wn * TN + j * 8 + (lane & 3) * 2
                        seen[row, col] += 1
                        seen[row, col + 1] += 1
    assert torch.equal(seen, torch.ones_like(seen))


def k_steps(cin: int):
    """(16-byte path, K steps), as ``launch_paths`` counts them."""
    wide = cin % 16 == 0
    return wide, (9 * math.ceil(cin / BK) if wide else math.ceil(9 * cin / BK))


def emulate(xq: torch.Tensor, wq_nk: torch.Tensor) -> torch.Tensor:
    """K4's implicit GEMM on int8 codes, one K step at a time over every
    block tile: the A rows (pixels, a tap, a BK-channel chunk; zero-filled
    halos and tails) and the B rows of the (Cout, 9 * Cin) weight."""
    b, h, wd, cin = xq.shape
    cout = wq_nk.shape[0]
    wide, steps = k_steps(cin)
    chunks = math.ceil(cin / BK)
    m_total = b * h * wd
    m_pad = math.ceil(m_total / BM) * BM
    n_pad = math.ceil(cout / BN) * BN
    xf = xq.long().reshape(-1)
    m = torch.arange(m_pad)
    in_m = m < m_total
    rem = m % (h * wd)
    ph = torch.where(in_m, rem // wd, torch.full_like(rem, -4))
    pw = rem % wd
    kk = torch.arange(BK)
    n = torch.arange(n_pad)
    acc = torch.zeros(m_pad, n_pad, dtype=torch.int64)
    for s in range(steps):
        if wide:
            tap = s // chunks
            ci = (s - tap * chunks) * BK + kk
            dy, dx = tap // 3 - 1, tap % 3 - 1
            hh, ww = ph + dy, pw + dx
            ok = ((hh >= 0) & (hh < h) & (ww >= 0) & (ww < wd))[:, None] & (ci < cin)[None, :]
            idx = m[:, None] * cin + (dy * wd + dx) * cin + ci[None, :]
            k = tap * cin + ci
            k_ok = ci < cin
        else:
            k = s * BK + kk
            t, ci = k // cin, k % cin
            bi, r = m // (h * wd), m % (h * wd)
            hh = (r // wd)[:, None] + (t // 3 - 1)[None, :]
            ww = (r % wd)[:, None] + (t % 3 - 1)[None, :]
            ok = (in_m[:, None] & (k < 9 * cin)[None, :]
                  & (hh >= 0) & (hh < h) & (ww >= 0) & (ww < wd))
            idx = ((bi[:, None] * h + hh) * wd + ww) * cin + ci[None, :]
            k_ok = k < 9 * cin
        a = torch.where(ok, xf[idx.clamp(0, xf.numel() - 1)], torch.zeros((), dtype=torch.long))
        b_ok = (n < cout)[:, None] & k_ok[None, :]
        b_rows = wq_nk.long()[n.clamp(max=cout - 1)][:, k.clamp(max=9 * cin - 1)]
        acc += a @ torch.where(b_ok, b_rows, torch.zeros((), dtype=torch.long)).T
    return acc[:m_total, :cout].reshape(b, h, wd, cout)


# (x shape, Cout): the routed widths, a chunk that spans part of a tap
# (Cin 192 at BK 64 is whole chunks; 200 is not a multiple of 16: packed
# K), Cout past one N tile and not a multiple of 8, M past one tile
CASES = [
    ((1, 5, 7, 128), 128),
    ((2, 9, 6, 192), 384),
    ((1, 6, 5, 256), 136),
    ((1, 4, 5, 200), 24),
    ((2, 3, 17, 24), 7),
]


@pytest.mark.parametrize("xshape,cout", CASES)
def test_emulation_matches_the_exact_accumulator(xshape, cout):
    g = torch.Generator().manual_seed(sum(xshape) + cout)
    xq = torch.randint(-127, 128, xshape, generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, xshape[-1], cout), generator=g, dtype=torch.int8)
    wq_nk = wq.permute(3, 0, 1, 2).reshape(cout, -1).contiguous()
    got = emulate(xq, wq_nk)
    assert torch.equal(got.double(), conv_acc_plain(xq, wq))


@pytest.mark.parametrize("cin,steps", [(128, 18), (192, 27), (256, 36), (512, 72), (200, 29),
                                       (24, 4), (16, 9)])
def test_k_steps(cin, steps):
    """K padded per tap for Cin % 16 == 0 (BK = 64 channels a step), packed
    across taps otherwise."""
    assert k_steps(cin)[1] == steps


def test_tile_constants():
    """Eight warps of 64 x 32; K steps of two k32 mma steps; shared rows
    16-byte aligned with a pad that makes ldmatrix conflict-free (80 bytes:
    the 8 rows of a matrix start in 8 distinct 4-bank groups)."""
    assert WM * WN * 32 == THREADS == 256 and (TM, TN) == (64, 32)
    assert BK % 32 == 0 and LDS % 16 == 0
    groups = {(r * LDS // 4) % 32 // 4 for r in range(8)}
    assert len(groups) == 8
    assert np.prod([BM, BN]) % THREADS == 0
