"""The index math of kernel K1's wgmma path (``csrc/conv3x3_kernel.cu``,
namespace ``wgmma``), replayed in numpy on the CPU and held against the
plain version.

A block owns 128 output pixels (8 rows x 16 columns, or 128 / W rows x W
where W < 16) and 128 output channels (64 where Cout % 128 != 0, or where
128-channel tiles would give the grid fewer blocks than the card has
SMs).  Per
chunk of 64 input channels TMA brings the halo patch of x, zero-filled
outside the image and past Cin, one 128-byte row a pixel with the
128-byte swizzle; the nine taps are nine row shifts into that patch, read
by ``ldmatrix`` into wgmma's register A operand, four k16 steps a tap.
The weight tiles (64 K-rows of the (9 Cin, Cout) HWIO matrix, as 64-channel
atoms) arrive by TMA with the 128-byte swizzle and are read as an MN-major
B through wgmma descriptors; the fp32 accumulator, plus the fp32 bias, is
rounded once and stored to NHWC.  The constants are read from the kernel
source (keep their ``constexpr int NAME = N;`` lines in one-line form);
the kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

import math
import re

import numpy as np
import pytest
import torch

from mudiff_torch.ops import _build, conv3x3_plain
from mudiff_torch.ops.conv3x3 import k1_path, k1_path_for

_SRC = (_build.CSRC / "conv3x3_kernel.cu").read_text()
_NS = _SRC[_SRC.index("namespace wgmma {"):]


def _const(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", _NS)
    assert len(found) == 1, name
    return int(found[0])


THREADS, CONSUMER_THREADS = _const("THREADS"), _const("CONSUMER_THREADS")
BLOCKS = {128: _const("BLOCKS_N128"), 64: _const("BLOCKS_N64")}
TILE_M, TILE_W, BK = _const("TILE_M"), _const("TILE_W"), _const("BK")
TAPS, KSTEPS, B_STAGES, A_SETS = (_const("TAPS"), _const("KSTEPS"), _const("B_STAGES"),
                                  _const("A_SETS"))
PATCH_TAP, ATOM_N = _const("PATCH_TAP"), _const("ATOM_N")
PATCH_PIX, MIN_PATCH_PIX = _const("PATCH_PIX"), _const("MIN_PATCH_PIX")
ROW_BYTES, SMEM_LIMIT = _const("ROW_BYTES"), _const("SMEM_LIMIT")
SM_SMEM = 233472  # shared memory of an H100 SM, 1 KB of it reserved a block
SMS = 132         # an H100 SXM's SMs
ES = 2            # bytes of a bf16 / fp16 element


def geometry(xshape, cout: int, sms: int = SMS):
    """(tw, rows, tiles_w, tiles_h, tiles_n, bn), as ``wgmma::conv`` sets
    them: 128-channel tiles where Cout allows and the grid still has a
    block for each of the card's ``sms`` SMs, else 64."""
    batch, h, w, _ = xshape
    tw = min(w, TILE_W)
    rows = TILE_M // tw
    tiles_w, tiles_h = math.ceil(w / tw), math.ceil(h / rows)
    wide = cout % 128 == 0 and batch * tiles_h * tiles_w * (cout // 128) >= sms
    bn = 128 if wide else 64
    return tw, rows, tiles_w, tiles_h, math.ceil(cout / bn), bn


def patch_stride(pix: int) -> int:
    return math.ceil(pix * ROW_BYTES / 1024) * 1024


def smem_bytes(bn: int, pix: int) -> int:
    """``wgmma::smem_bytes``: alignment slack, the weight ring, two patches,
    the barriers."""
    return 1024 + B_STAGES * BK * bn * ES + 2 * patch_stride(pix) + (2 * B_STAGES + 4) * 8


# ------------------------------------------------------------ the constants


def test_constants_fit_the_card_and_the_roles():
    """Two consumer warpgroups of m64 and one producer warp; a chunk is one
    128-byte swizzle row a pixel, four k16 steps a tap; the patch of every
    tile geometry (tw = 1 .. 16) and the ring fit the 227 KB of a block,
    the blocks the launch bound plans for share an SM at 8 x 16 tiles,
    and the staged output tile fits the two patch buffers of the smallest
    patch; the launch bound leaves a consumer room for its accumulators
    and A sets."""
    assert THREADS == CONSUMER_THREADS + 32 and CONSUMER_THREADS == 2 * 128
    assert TILE_M == 2 * 64 and TILE_M % TILE_W == 0
    assert BK * ES == ROW_BYTES == ATOM_N * ES == 128 and KSTEPS * 16 == BK
    pix = {tw: (TILE_M // tw + 2) * (tw + 2) for tw in range(1, TILE_W + 1)}
    assert max(pix.values()) == PATCH_PIX and min(pix.values()) == MIN_PATCH_PIX
    assert TILE_M + 2 <= 256  # a TMA box dimension
    for bn in (64, 128):
        assert all(smem_bytes(bn, p) <= SMEM_LIMIT for p in pix.values()), bn
        assert TILE_M * (bn + 8) * ES <= 2 * patch_stride(MIN_PATCH_PIX)
        assert BLOCKS[bn] * (smem_bytes(bn, pix[TILE_W]) + 1024) <= SM_SMEM
        regs = min(255, 65536 // (THREADS * BLOCKS[bn]) // 8 * 8)
        assert regs >= bn // 2 + 4 * A_SETS + 24  # accumulators, A sets, addresses
    assert 2 <= A_SETS <= KSTEPS and (TAPS * KSTEPS) % A_SETS == 0
    assert B_STAGES <= PATCH_TAP < TAPS


# --------------------------------------------------------- the tile schedule

# K1's calls (x shape at batch 1, Cout) of a 4-step sample at 256^2 and
# their launches, nf = 64: what a 32^2 sample records, scaled by 8
# (checked below); nf = 128 doubles every channel count but the stems'
# inputs (4, 5) and the head's output (1).
SAMPLE_64 = {
    ((1, 64, 64, 128), 128): 16, ((1, 64, 64, 128), 256): 8, ((1, 64, 64, 256), 256): 80,
    ((1, 64, 64, 384), 256): 8, ((1, 64, 64, 512), 256): 16, ((1, 128, 128, 64), 64): 16,
    ((1, 128, 128, 64), 128): 8, ((1, 128, 128, 128), 128): 48,
    ((1, 128, 128, 192), 128): 8, ((1, 128, 128, 256), 128): 8,
    ((1, 128, 128, 256), 256): 16, ((1, 128, 128, 384), 128): 8,
    ((1, 256, 256, 4), 256): 4, ((1, 256, 256, 5), 320): 4, ((1, 256, 256, 64), 1): 8,
    ((1, 256, 256, 64), 64): 52, ((1, 256, 256, 128), 64): 8,
    ((1, 256, 256, 128), 128): 16, ((1, 256, 256, 192), 64): 8,
    ((1, 256, 256, 192), 192): 4, ((1, 256, 256, 192), 384): 4,
    ((1, 256, 256, 256), 64): 8, ((1, 256, 256, 256), 256): 8,
    ((1, 256, 256, 320), 64): 8,
}
NARROW_CHANNELS = (1, 4, 5)


def widen(sites: dict, factor: int) -> dict:
    scale = (lambda c: c if c in NARROW_CHANNELS else factor * c)
    return {((b, h, w, scale(cin)), scale(cout)): n
            for ((b, h, w, cin), cout), n in sites.items()}


SAMPLE = {64: SAMPLE_64, 128: widen(SAMPLE_64, 2)}
# Ragged edges: W and H not multiples of the tile's, W below 16 that does
# not divide 128, Cout tails of a 64-channel tile, Cin tails of a chunk.
RAGGED = [((2, 5, 300, 64), 136), ((1, 9, 64, 72), 64), ((3, 7, 20, 64), 200),
          ((1, 3, 100, 80), 256), ((2, 130, 2, 64), 64), ((1, 13, 5, 128), 72)]


def block_origins(xshape, cout: int):
    """(b, h0, w0, n0) of every block, as ``conv3x3_kernel_wgmma`` decodes
    blockIdx.x (output-channel tiles fastest)."""
    tw, rows, tiles_w, tiles_h, tiles_n, bn = geometry(xshape, cout)
    bid = np.arange(xshape[0] * tiles_h * tiles_w * tiles_n)
    nt = bid % tiles_n
    bid = bid // tiles_n
    twi = bid % tiles_w
    bid = bid // tiles_w
    thi = bid % tiles_h
    b = bid // tiles_h
    return b, thi * rows, twi * tw, nt * bn


def _assert_covered_once(xshape, cout):
    batch, h, w, _ = xshape
    tw, rows, *_, bn = geometry(xshape, cout)
    assert rows * tw <= TILE_M and tw + 2 <= 256 and rows + 2 <= 256  # TMA box limits
    assert (rows + 2) * (tw + 2) <= PATCH_PIX
    b, h0, w0, n0 = block_origins(xshape, cout)
    m = np.arange(TILE_M)
    r, c = m // tw, m % tw
    hh = h0[:, None] + r[None, :]
    ww = w0[:, None] + c[None, :]
    ok = (m[None, :] < rows * tw) & (hh < h) & (ww < w)
    count = np.zeros((math.ceil(cout / bn), batch, h, w), np.int64)
    bb = np.broadcast_to(b[:, None], ok.shape)
    nn = np.broadcast_to((n0 // bn)[:, None], ok.shape)
    np.add.at(count, (nn[ok], bb[ok], hh[ok], ww[ok]), 1)
    assert (count == 1).all(), (xshape, cout)
    assert sorted(set(n0.tolist())) == list(range(0, cout, bn))


@pytest.mark.parametrize("nf", [64, 128])
@pytest.mark.parametrize("batch", [2, 4, 8])
def test_schedule_writes_every_output_once_at_the_path_shapes(nf, batch):
    for (xshape, cout) in SAMPLE[nf]:
        if k1_path_for(xshape[-1], cout, torch.bfloat16) == "wgmma":
            _assert_covered_once((batch, *xshape[1:]), cout)


@pytest.mark.parametrize("xshape,cout", RAGGED)
def test_schedule_writes_every_output_once_at_ragged_edges(xshape, cout):
    _assert_covered_once(xshape, cout)


def test_small_grids_take_64_channel_tiles():
    """128-channel tiles where the grid still has a block an SM, else 64:
    the training batch's 64^2 convs (64 pixel tiles: 64 or 128 blocks)
    and the sampler's (4, 64, 64, 128) -> 128 (128 blocks) take 64,
    (4, 64, 64, 256) -> 256 (256 blocks) and the training batch's 128^2
    convs 128; Cout % 128 != 0 always 64."""
    assert geometry((2, 64, 64, 256), 128)[-1] == 64
    assert geometry((2, 64, 64, 128), 256)[-1] == 64
    assert geometry((2, 128, 128, 128), 128)[-1] == 128
    assert geometry((4, 64, 64, 128), 128)[-1] == 64
    assert geometry((4, 64, 64, 256), 256)[-1] == 128
    assert geometry((8, 256, 256, 64), 192)[-1] == 64
    _assert_covered_once((2, 64, 64, 256), 128)


# ----------------------------------------- the 128-byte swizzle and the reads


def swizzle128(addr: int) -> int:
    """Where TMA's 128-byte swizzle puts the byte at offset ``addr`` from a
    1024-byte aligned base (and where wgmma and the lanes' address math
    read it): 16-byte chunk bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def b_desc(addr: int) -> int:
    """``wgmma::b_desc``, with its fields read from the kernel source."""
    body = _NS[_NS.index("uint64_t b_desc("):]
    body = body[:body.index("}")]
    lbo = int(re.search(r"\(uint64_t\)\((\d+) >> 4\) << 16", body).group(1))
    sbo = int(re.search(r"\(uint64_t\)\((\d+) >> 4\) << 32", body).group(1))
    layout = int(re.search(r"\(uint64_t\)(\d+) << 62", body).group(1))
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32) | (layout << 62)


def desc_read(desc: int, k: int, n: int) -> int:
    """The shared-memory byte offset wgmma reads for element (k, n) (k < 16)
    of an MN-major B operand of 16-bit type from a 128-byte swizzled
    descriptor: the canonical layout ((8, 8, n / 64), (8, k / 8)) :
    ((2 B, 16 B, LBO), (128 B, SBO)) from the start address, then the
    swizzle on the address bits."""
    assert desc >> 62 == 1  # the 128-byte swizzle
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    addr = (start + (n // 64) * lbo + (n % 64) * ES + (k % 8) * ROW_BYTES + (k // 8) * sbo)
    return swizzle128(addr)


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("stage", [0, B_STAGES - 1])
def test_descriptor_reads_the_elements_tma_wrote(bn, stage):
    """The producer's TMA boxes (64 channels x 64 K-rows, one a 64-channel
    atom, ``BK * ROW_BYTES`` apart) and the consumer's descriptors (start +
    2048 k bytes for k16 step k): every (k, n) that step k's product needs
    is weight row 16 k + k, channel n of the tile."""
    b_tile = BK * bn * ES
    base = 1024 * 3 + stage * b_tile  # a 1024-byte aligned stage of the ring
    tile = np.arange(BK * bn, dtype=np.int64).reshape(BK, bn)  # distinct elements
    smem = np.full((base + b_tile) // ES, -1, np.int64)
    for atom in range(bn // ATOM_N):
        for kr in range(BK):
            for c in range(ATOM_N):
                off = atom * BK * ROW_BYTES + kr * ROW_BYTES + c * ES
                smem[(base + swizzle128(off)) // ES] = tile[kr, atom * ATOM_N + c]
    desc0 = b_desc(base)
    for ks in range(KSTEPS):
        desc = desc0 + ks * (16 * ROW_BYTES >> 4)
        got = np.array([[smem[desc_read(desc, k, n) // ES] for n in range(bn)]
                        for k in range(16)])
        assert np.array_equal(got, tile[16 * ks:16 * ks + 16]), ks


def test_weight_tile_coordinates_cover_k_once():
    """The producer loads, for chunk c and tap t, K-rows t * Cin + 64 c ..
    + 64 of the (9 Cin, Cout) weight: each K-row of a tap is fetched once
    for the channels below Cin (the rows past Cin of a chunk meet the
    patch's zero-filled channel tail)."""
    for cin in (64, 72, 128, 192, 1024):
        chunks = math.ceil(cin / BK)
        seen = np.zeros(9 * cin + BK, np.int64)
        for c in range(chunks):
            for t in range(TAPS):
                for ch in range(BK):
                    if c * BK + ch < cin:
                        seen[t * cin + c * BK + ch] += 1
        assert (seen[:9 * cin] == 1).all() and not seen[9 * cin:].any()


# ---------------------------------- the register A fragments and the output map


def ldsm_x4(mem: np.ndarray, addrs) -> np.ndarray:
    """``ldmatrix.x4`` (b16) on 16-bit elements: lane l gives the byte
    address of row l % 8 of matrix l // 8; lane t receives, from each
    matrix, the two elements at row t // 4, elements 2 (t % 4) ..
    Returns (32 lanes, 4 registers, 2 elements)."""
    rows = [mem[a // ES:a // ES + 8] for a in addrs]
    regs = np.empty((32, 4, 2), mem.dtype)
    for t in range(32):
        for j in range(4):
            regs[t, j] = rows[8 * j + t // 4][2 * (t % 4):2 * (t % 4) + 2]
    return regs


def mma_a(regs: np.ndarray) -> np.ndarray:
    """The 16 x 16 A block of one warp that wgmma reads from a0..a3 (the
    m16n8k16 A fragment: a0 row g, elements 2c..; a1 row g + 8; a2 row g,
    elements 8 + 2c..; a3 row g + 8, elements 8 + 2c..)."""
    a = np.empty((16, 16), regs.dtype)
    for t in range(32):
        g, c = t // 4, t % 4
        a[g, 2 * c:2 * c + 2] = regs[t, 0]
        a[g + 8, 2 * c:2 * c + 2] = regs[t, 1]
        a[g, 8 + 2 * c:10 + 2 * c] = regs[t, 2]
        a[g + 8, 8 + 2 * c:10 + 2 * c] = regs[t, 3]
    return a


def lane_rows(tw: int, rows: int, row_base: int):
    """(prow, hi) of each lane of a consumer warp: the patch pixel of its
    tile row (0 past the tile) and its half of a k16 step."""
    pw = tw + 2
    out = []
    for lane in range(32):
        m = row_base + (lane & 15)
        r = m // tw
        out.append((r * pw + (m - r * tw) if m < rows * tw else 0, lane >> 4))
    return out


@pytest.mark.parametrize("h,w", [(9, 256), (3, 64), (5, 20), (10, 8), (130, 1), (11, 13)])
def test_register_a_fragments_are_the_shifted_patch_rows(h, w):
    """For every consumer warp, tap and k16 step, the lanes' ldmatrix
    addresses into the swizzled patch (pixel px = prow + dy pw + dx, chunk
    (2 k) ^ ((px & 7) ^ hi) of its row) give wgmma the elements of patch
    pixel (r + dy, c + dx), channels 16 k .. 16 k + 15."""
    tw, rows, *_ = geometry((1, h, w, 64), 128)
    pw = tw + 2
    pix = (rows + 2) * pw
    rng = np.random.default_rng(h * w)
    patch = rng.integers(-2**15, 2**15, (pix, BK))
    mem = np.zeros(patch_stride(pix) // ES, np.int64)
    for p in range(pix):
        for c in range(BK):
            mem[swizzle128(p * ROW_BYTES + c * ES) // ES] = patch[p, c]
    for ctid in range(0, CONSUMER_THREADS, 32):  # one lane set a warp
        row_base = (ctid >> 7) * 64 + ((ctid >> 5) & 3) * 16
        lanes = lane_rows(tw, rows, row_base)
        for t in range(TAPS):
            dy, dx = t // 3, t % 3
            for ks in range(KSTEPS):
                addrs = []
                for prow, hi in lanes:
                    px = prow + dy * pw + dx
                    sw = (px & 7) ^ hi
                    addrs.append(px * ROW_BYTES + (((2 * ks) ^ sw) << 4))
                a = mma_a(ldsm_x4(mem, addrs))
                for i in range(16):
                    m = row_base + i
                    if m >= rows * tw:
                        continue
                    p = (m // tw + dy) * pw + m % tw + dx
                    assert np.array_equal(a[i], patch[p, 16 * ks:16 * ks + 16]), (ctid, t, i)


def test_patch_rows_of_an_ldmatrix_are_conflict_free():
    """The eight rows of one ldmatrix matrix (eight consecutive pixels of a
    tile row, tw >= 8) start in eight distinct 16-byte bank groups."""
    for px0 in range(64):
        for k in range(KSTEPS):
            groups = {(swizzle128((px0 + i) * ROW_BYTES + 32 * k) % 128) // 16
                      for i in range(8)}
            assert len(groups) == 8


def store_rows_cols(bn: int):
    """(ctid, idx, m, n) of every accumulator of the two consumer
    warpgroups, as the epilogue maps them: acc[4 j + 2 h + e] of consumer
    thread ctid is tile row row_base + lane / 4 + 8 h, column 8 j + 2
    (lane % 4) + e."""
    out = []
    for ctid in range(CONSUMER_THREADS):
        lane = ctid & 31
        row_base = (ctid >> 7) * 64 + ((ctid >> 5) & 3) * 16
        for j in range(bn // 8):
            for half in range(2):
                for e in range(2):
                    out.append((ctid, 4 * j + 2 * half + e, row_base + (lane >> 2) + 8 * half,
                                8 * j + 2 * (lane & 3) + e))
    return out


def wgmma_d_position(ctid: int, idx: int):
    """(row, column) of accumulator ``idx`` of consumer thread ``ctid`` in
    its warpgroup's m64nN fp32 result (PTX's wgmma D fragment), offset by
    the warpgroup's 64 rows."""
    lane, warp, wg = ctid & 31, (ctid >> 5) & 3, ctid >> 7
    j, rest = divmod(idx, 4)
    half, e = divmod(rest, 2)
    return wg * 64 + 16 * warp + (lane >> 2) + 8 * half, 8 * j + 2 * (lane & 3) + e


@pytest.mark.parametrize("bn", [64, 128])
def test_accumulator_output_map_is_the_wgmma_layout_and_covers_the_tile(bn):
    seen = np.zeros((TILE_M, bn), np.int64)
    for ctid, idx, m, n in store_rows_cols(bn):
        assert (m, n) == wgmma_d_position(ctid, idx)
        seen[m, n] += 1
    assert (seen == 1).all()


# ------------------------------------ the halo patch and the taps: the whole conv


def emulate(x: np.ndarray, w: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """K1's wgmma path in float64, block by block in the kernel's order:
    per chunk the TMA box of x from (64 c, w0 - 1, h0 - 1, b), zero-filled
    outside the tensor; per tap and k16 step the 128 A rows at the shifted
    patch pixels times 16 K-rows of the weight tile (K-rows t * Cin + 64 c
    + 16 k .., channels n0 .. n0 + BN, zero past the matrix), summed into
    the accumulator in that order; the bias added last; stored by the
    output map."""
    batch, h, wd, cin = x.shape
    cout = w.shape[-1]
    tw, rows, *_, bn = geometry(x.shape, cout)
    pw = tw + 2
    wmat = w.reshape(9 * cin, cout)
    chunks = math.ceil(cin / BK)
    out = np.full((batch, h, wd, cout), np.nan)
    m = np.arange(TILE_M)
    prow = np.where(m < rows * tw, (m // tw) * pw + m % tw, 0)
    for b, h0, w0, n0 in zip(*block_origins(x.shape, cout)):
        acc = np.zeros((TILE_M, bn))
        n = n0 + np.arange(bn)
        for ch in range(chunks):
            hh = h0 - 1 + np.arange(rows + 2)[:, None]
            ww = w0 - 1 + np.arange(tw + 2)[None, :]
            cc = ch * BK + np.arange(BK)
            inside = ((hh >= 0) & (hh < h) & (ww >= 0) & (ww < wd))[..., None] & (cc < cin)
            patch = np.where(inside, x[b, hh.clip(0, h - 1), ww.clip(0, wd - 1)][
                ..., cc.clip(0, cin - 1)], 0.0).reshape(-1, BK)
            for t in range(TAPS):
                a = patch[prow + (t // 3) * pw + t % 3]  # (128, 64)
                for ks in range(KSTEPS):
                    k = t * cin + ch * BK + 16 * ks + np.arange(16)
                    ok = (k < 9 * cin)[:, None] & (n < cout)[None, :]
                    btile = np.where(ok, wmat[k.clip(0, 9 * cin - 1)][:, n.clip(0, cout - 1)],
                                     0.0)
                    acc += a[:, 16 * ks:16 * ks + 16] @ btile
        acc = acc + np.where(n < cout, bias[n.clip(0, cout - 1)], 0.0)
        for _, _, mm, nn in store_rows_cols(bn):
            rr = mm // tw
            hh_, ww_, nc = h0 + rr, w0 + mm - rr * tw, n0 + nn
            if mm < rows * tw and hh_ < h and ww_ < wd and nc < cout:
                out[b, hh_, ww_, nc] = acc[mm, nn]
    return out


# each path geometry (8 x 16 tiles) at small H, B and Cin, ragged ones,
# narrow images (W < 16: 128 / W rows), Cin tails (72, 80: a partial
# chunk), Cout tails (72, 136 on 64-channel tiles) and both tile widths
EXACT = [((1, 9, 32, 64), 128), ((2, 3, 17, 64), 64), ((1, 10, 16, 80), 136),
         ((1, 4, 40, 72), 72), ((1, 7, 13, 64), 192), ((1, 20, 5, 128), 64),
         ((1, 130, 1, 64), 128), ((1, 300, 1, 64), 64), ((1, 17, 18, 64), 64)]


@pytest.mark.parametrize("xshape,cout", EXACT)
def test_patch_and_taps_replay_the_conv(xshape, cout):
    rng = np.random.default_rng(sum(xshape) + cout)
    x = rng.standard_normal(xshape).astype(np.float32)
    w = (rng.standard_normal((3, 3, xshape[-1], cout)) / math.sqrt(9 * xshape[-1])
         ).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    got = emulate(x.astype(np.float64), w.astype(np.float64), bias.astype(np.float64))
    want = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias))
    np.testing.assert_allclose(got, want.numpy().astype(np.float64), atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------- the path choice


def _k1_calls(log):
    out = {}
    for name, key in log:
        if name == "conv3x3":
            (b, h, w, cin), cout, _ = key
            out[((b, h, w, cin), cout)] = out.get(((b, h, w, cin), cout), 0) + 1
    return out


def _scaled(calls: dict, factor: int) -> dict:
    return {((b, factor * h, factor * w, cin), cout): n
            for ((b, h, w, cin), cout), n in calls.items()}


def _recorded_paths(calls: dict):
    wide, narrow = set(), set()
    for (xshape, cout) in calls:
        x = torch.zeros((1, 2, 2, xshape[-1]), dtype=torch.bfloat16)
        w = torch.zeros((3, 3, xshape[-1], cout), dtype=torch.bfloat16)
        (wide if k1_path(x, w) == "wgmma" else narrow).add((xshape[-1], cout))
    return wide, narrow


@pytest.mark.parametrize("nf", [64, 128])
def test_every_wide_call_of_a_sample_takes_the_wgmma_path(nf):
    """A batch-1 sample at 32^2 records SAMPLE (scaled by 8 to 256^2):
    every call with Cin, Cout >= 64 takes the wgmma path, and only the
    stems (Cin 4 / 5) and the head (Cout 1) the general one."""
    from mudiff_torch import brats_recipe, build_sampler, ops

    cfg = brats_recipe(num_channels_dae=nf, image_size=32)
    sampler = build_sampler(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    conds = [torch.randn((1, 32, 32, 1), generator=g) for _ in range(3)]
    log = []
    with torch.no_grad(), ops.record_calls(log):
        sampler(*conds, generator=g)
    calls = _scaled(_k1_calls(log), 8)
    assert calls == SAMPLE[nf]
    wide, narrow = _recorded_paths(calls)
    assert narrow == {(4, 4 * nf), (5, 5 * nf), (nf, 1)}
    assert all(min(cin, cout) >= 64 for cin, cout in wide)


@pytest.mark.parametrize("nf", [64, 128])
def test_every_wide_call_of_a_training_step_takes_the_wgmma_path(nf):
    """One D + G step at 64^2, batch 1 (a small critic: the critic's convs
    are not K1's), forward and dx: every call with Cin, Cout >= 64 takes
    the wgmma path, the narrow ones (the stems, the head, the head's dx
    Cin 1, the stem's dx Cout 5) the general one."""
    from mudiff_torch import brats_recipe, ops
    from mudiff_torch.train.state import create_train_state
    from mudiff_torch.train.steps import make_train_step

    cfg = brats_recipe(num_channels_dae=nf, image_size=64, ngf=8, nz=8, z_emb_dim=32,
                       t_emb_dim=32)
    state = create_train_state(cfg, seed=0, device="cpu", attn="flash")
    rng = np.random.RandomState(0)
    batch = [torch.from_numpy((rng.randn(1, 64, 64, 1) * 0.5).astype(np.float32))
             for _ in range(4)]
    log = []
    with ops.record_calls(log):
        make_train_step(cfg)(state, batch, generator=torch.Generator().manual_seed(5),
                             with_r1=False)
    calls = _scaled(_k1_calls(log), 4)
    wide, narrow = _recorded_paths(calls)
    assert narrow == {(4, 4 * nf), (5, 5 * nf), (nf, 1), (1, nf), (5 * nf, 5)}
    assert all(min(cin, cout) >= 64 for cin, cout in wide)
    # the forward shapes are the sample's; dx adds the transposed ones
    assert {(x[-1], c) for x, c in SAMPLE[nf]} <= wide | narrow


def test_other_shapes_and_dtypes_take_the_other_paths():
    """fp32 takes the FMA kernel; bf16 / fp16 below 64 channels, Cin or
    Cout not a multiple of 8, or an x or w off a 16-byte boundary the
    general path; the choice needs no card."""
    def t(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    assert k1_path(t((2, 4, 4, 64), torch.float32), t((3, 3, 64, 64), torch.float32)) == "fma"
    assert k1_path(t((2, 4, 4, 64), torch.float16), t((3, 3, 64, 64), torch.float16)) == "wgmma"
    assert k1_path(t((2, 4, 4, 32)), t((3, 3, 32, 64))) == "general"
    assert k1_path(t((2, 4, 4, 64)), t((3, 3, 64, 60))) == "general"
    assert k1_path(t((2, 4, 4, 68)), t((3, 3, 68, 64))) == "general"
    flat = t(2 * 4 * 4 * 64 + 8)
    shifted = flat[4:4 + 2 * 4 * 4 * 64].view(2, 4, 4, 64)  # 8 bytes in
    assert k1_path(shifted, t((3, 3, 64, 64))) == "general"
    assert k1_path(flat[:2 * 4 * 4 * 64].view(2, 4, 4, 64), t((3, 3, 64, 64))) == "wgmma"
