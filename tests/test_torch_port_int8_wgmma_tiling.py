"""The index math of kernel K4's fused path (``csrc/int8_conv_kernel.cu``,
namespace ``s8wgmma``), replayed in PyTorch / numpy on the CPU and held
against the plain version's exact accumulator.

What the fused kernel adds to the general path's tiling: a block owns 128
output pixels (8 rows x 16 columns, or 128 / W rows x W where W < 16) and
128 channels; per chunk of 64 input channels TMA brings the halo patch of x,
zero-filled outside the image, the quantizers write its codes once into an
s8 patch of ``SQ_STRIDE`` bytes a pixel, and the nine taps are nine row
shifts into that patch, read by ``ldmatrix`` into wgmma's register A
operand; the weight tiles arrive by TMA with the 64-byte swizzle and are
read through wgmma descriptors; the s32 accumulator goes to NHWC outputs.
The constants are read from the kernel source (keep their ``constexpr int
NAME = N;`` lines in one-line form); the kernel itself is held against the
plain version on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import math
import re

import numpy as np
import pytest
import torch

from mudiff_torch.ops import _build
from mudiff_torch.ops import int8_conv as k4

_SRC = (_build.CSRC / "int8_conv_kernel.cu").read_text()
_NS = _SRC[_SRC.index("namespace s8wgmma {"):]


def _const(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", _NS)
    assert len(found) == 1, name
    return int(found[0])


THREADS, QUANT_THREADS = _const("THREADS"), _const("QUANT_THREADS")
CONSUMER_THREADS, TILE_M, TILE_W = (_const("CONSUMER_THREADS"), _const("TILE_M"),
                                    _const("TILE_W"))
BN, BK = _const("BN"), _const("BK")
TAPS, B_STAGES, A_SETS = _const("TAPS"), _const("B_STAGES"), _const("A_SETS")
PATCH_PIX, SQ_STRIDE, ABSMAX_PARTS = (_const("PATCH_PIX"), _const("SQ_STRIDE"),
                                      _const("ABSMAX_PARTS"))
B_TILE = BN * BK
SMEM_LIMIT = 232448  # bytes a block may use on an H100

# The routed sites (x shape at batch 1, Cout) of one sample at 256^2, with
# their launches: nf=64 and nf=128 (int8 stems on; what a run of the
# sampler records through ``record_calls``, checked below at 32^2).
SITES = {
    64: {((1, 64, 64, 128), 128): 16, ((1, 64, 64, 128), 256): 8, ((1, 64, 64, 256), 256): 80,
         ((1, 64, 64, 384), 256): 8, ((1, 64, 64, 512), 256): 16,
         ((1, 128, 128, 128), 128): 48, ((1, 128, 128, 192), 128): 8,
         ((1, 128, 128, 256), 128): 8, ((1, 128, 128, 256), 256): 16,
         ((1, 128, 128, 384), 128): 8, ((1, 256, 256, 128), 128): 16,
         ((1, 256, 256, 192), 192): 4, ((1, 256, 256, 192), 384): 4,
         ((1, 256, 256, 256), 256): 8},
    128: {((1, 64, 64, 256), 256): 16, ((1, 64, 64, 256), 512): 8, ((1, 64, 64, 512), 512): 80,
          ((1, 64, 64, 768), 512): 8, ((1, 64, 64, 1024), 512): 16,
          ((1, 128, 128, 256), 256): 48, ((1, 128, 128, 384), 256): 8,
          ((1, 128, 128, 512), 256): 8, ((1, 128, 128, 512), 512): 16,
          ((1, 128, 128, 768), 256): 8, ((1, 256, 256, 256), 256): 16,
          ((1, 256, 256, 384), 384): 4, ((1, 256, 256, 384), 768): 4,
          ((1, 256, 256, 512), 512): 8},
}
# Ragged edges: W and H not multiples of the tile's, W below 16 that does
# not divide 128, Cout tails, Cin tails.
RAGGED = [((2, 5, 300, 32), 136), ((1, 9, 64, 16), 24), ((3, 7, 20, 48), 7),
          ((1, 3, 100, 80), 200), ((2, 130, 2, 16), 16), ((1, 13, 5, 32), 9)]


def geometry(h: int, w: int, cout: int):
    """(tw, rows, tiles_w, tiles_h, tiles_n), as ``s8wgmma::fused`` sets them."""
    tw = min(w, TILE_W)
    rows = TILE_M // tw
    return tw, rows, math.ceil(w / tw), math.ceil(h / rows), math.ceil(cout / BN)


def block_origins(batch: int, h: int, w: int, cout: int):
    """(b, h0, w0, n0) of every block, as ``conv_kernel`` decodes blockIdx.x
    (output-channel tiles fastest)."""
    tw, rows, tiles_w, tiles_h, tiles_n = geometry(h, w, cout)
    bid = np.arange(batch * tiles_h * tiles_w * tiles_n)
    nt = bid % tiles_n
    bid = bid // tiles_n
    twi = bid % tiles_w
    bid = bid // tiles_w
    thi = bid % tiles_h
    b = bid // tiles_h
    return b, thi * rows, twi * tw, nt * BN


def store_rows_cols():
    """(m, n) of every accumulator of the two consumer warpgroups, as
    ``store_tile`` maps them: acc[4 j + 2 h + e] of consumer thread ctid is
    tile row row_base + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e."""
    out = []
    for ctid in range(CONSUMER_THREADS):
        lane = ctid & 31
        row_base = (ctid >> 7) * 64 + ((ctid >> 5) & 3) * 16
        for j in range(BN // 8):
            for half in range(2):
                for e in range(2):
                    out.append((ctid, 4 * j + 2 * half + e, row_base + (lane >> 2) + 8 * half,
                                8 * j + 2 * (lane & 3) + e))
    return out


def wgmma_d_position(ctid: int, idx: int):
    """(row, column) of accumulator ``idx`` of consumer thread ``ctid`` in its
    warpgroup's m64nBN s32 result (PTX's wgmma D fragment: warp w of the
    warpgroup holds rows 16 w .. 16 w + 15; d[4 j + 2 h + e] is row lane / 4
    + 8 h, column 8 j + 2 (lane % 4) + e), offset by the warpgroup's 64 rows."""
    lane, warp, wg = ctid & 31, (ctid >> 5) & 3, ctid >> 7
    j, rest = divmod(idx, 4)
    half, e = divmod(rest, 2)
    return wg * 64 + 16 * warp + (lane >> 2) + 8 * half, 8 * j + 2 * (lane & 3) + e


# ------------------------------------------------------------ the constants


def test_constants_fit_the_card_and_the_roles():
    """One producer warp, the quantizer warps and two consumer warpgroups of
    m64; the largest patch is the tallest tile's (W = 1: 128 rows) plus
    its halo, and a full-width tile's fits too; shared memory
    (the weight ring, the x patches: two in 2-byte x, one in fp32, two s8
    patches, barriers, the column scales) fits the 227 KB of a block; the
    s8 rows stay 16-byte aligned for ldmatrix, the weight stages on the
    64-byte swizzle's 512-byte repeat."""
    assert THREADS == 32 + QUANT_THREADS + CONSUMER_THREADS and THREADS % 128 == 0
    assert CONSUMER_THREADS == 2 * 128 and TILE_M == 2 * 64
    assert QUANT_THREADS % 32 == 0 and ABSMAX_PARTS <= QUANT_THREADS
    assert k4.ABSMAX_PARTS == ABSMAX_PARTS  # the wrapper sizes the partial maxima
    assert PATCH_PIX == 3 * (TILE_M + 2) and SQ_STRIDE % 16 == 0 and SQ_STRIDE >= BK
    assert TILE_M % TILE_W == 0 and (TILE_M // TILE_W + 2) * (TILE_W + 2) <= PATCH_PIX
    assert BK == 64 and B_TILE % 1024 == 0
    assert 65536 // THREADS >= 128  # the consumers' 64 accumulators + A sets fit
    for es, stages in ((2, 2), (4, 1)):
        dynamic = (B_STAGES * B_TILE + stages * PATCH_PIX * BK * es + 2 * PATCH_PIX * SQ_STRIDE
                   + (2 * B_STAGES + 8) * 8 + 16 * 4 + 1024)
        static = 2 * BN * 4  # col_scale, col_bias
        assert dynamic + static <= SMEM_LIMIT, es


def test_ldmatrix_rows_of_the_s8_patch_are_conflict_free():
    """Eight consecutive patch pixels (the eight rows of one ldmatrix
    matrix) start in eight distinct 4-bank groups."""
    assert len({(p * SQ_STRIDE // 4) % 32 // 4 for p in range(8)}) == 8


# --------------------------------------------------------- the tile schedule


@pytest.mark.parametrize("nf", [64, 128])
@pytest.mark.parametrize("batch", [4, 8])
def test_schedule_writes_every_output_once_at_the_path_sites(nf, batch):
    for (xshape, cout), _ in SITES[nf].items():
        _assert_covered_once((batch, *xshape[1:]), cout)


@pytest.mark.parametrize("xshape,cout", RAGGED)
def test_schedule_writes_every_output_once_at_ragged_edges(xshape, cout):
    _assert_covered_once(xshape, cout)


def _assert_covered_once(xshape, cout):
    batch, h, w, _ = xshape
    tw, rows, *_ = geometry(h, w, cout)
    assert rows * tw <= TILE_M and tw + 2 <= 256 and rows + 2 <= 256  # TMA box limits
    assert (rows + 2) * (tw + 2) <= PATCH_PIX
    b, h0, w0, n0 = block_origins(batch, h, w, cout)
    m = np.arange(TILE_M)
    r, c = m // tw, m % tw
    hh = h0[:, None] + r[None, :]
    ww = w0[:, None] + c[None, :]
    ok = (m[None, :] < rows * tw) & (hh < h) & (ww < w)
    count = np.zeros((math.ceil(cout / BN), batch, h, w), np.int64)
    bb = np.broadcast_to(b[:, None], ok.shape)
    nn = np.broadcast_to((n0 // BN)[:, None], ok.shape)
    np.add.at(count, (nn[ok], bb[ok], hh[ok], ww[ok]), 1)
    assert (count == 1).all(), (xshape, cout)
    # the channel tiles partition [0, Cout)
    assert sorted(set(n0.tolist())) == list(range(0, cout, BN))


def test_the_site_lists_are_the_samplers():
    """SITES is what a batch-1 sample records at 32^2 (the site list depends
    on the widths only), scaled by 8 to 256^2."""
    from mudiff_torch import brats_recipe, build_sampler, ops

    for nf in (64, 128):
        cfg = brats_recipe(num_channels_dae=nf, image_size=32, use_int8=True)
        sampler = build_sampler(cfg, device="cpu")
        g = torch.Generator().manual_seed(0)
        conds = [torch.randn((1, 32, 32, 1), generator=g) for _ in range(3)]
        log = []
        with torch.no_grad(), ops.record_calls(log):
            sampler(*conds, generator=g)
        got = {}
        for name, key in log:
            if name == "int8_conv3x3":
                (b, h, w, cin), cout = key[0], key[1]
                site = ((b, 8 * h, 8 * w, cin), cout)
                got[site] = got.get(site, 0) + 1
        assert got == SITES[nf], nf


# ----------------------------------------- the weight tile: TMA and descriptors


def tma_swizzle64(n: int, kbyte: int) -> int:
    """Where TMA's 64-byte swizzle puts byte ``kbyte`` of weight row ``n`` of
    a tile of 64-byte rows: 16-byte chunk index XOR bits 7-8 of the row's
    offset, i.e. (n / 2) % 4."""
    return n * 64 + (((kbyte >> 4) ^ ((n >> 1) & 3)) << 4) + (kbyte & 15)


def b_desc(addr: int) -> int:
    """``s8wgmma::b_desc``, with its fields read from the kernel source."""
    body = _NS[_NS.index("uint64_t b_desc("):]
    body = body[:body.index("}")]
    sbo = int(re.search(r"\(uint64_t\)\((\d+) >> 4\) << 32", body).group(1))
    layout = int(re.search(r"\(uint64_t\)(\d+) << 62", body).group(1))
    lbo = int(re.search(r"\(uint64_t\)(\d+) << 16", body).group(1))
    return ((addr & 0x3FFFF) >> 4) | (lbo << 16) | ((sbo >> 4) << 32) | (layout << 62)


def desc_read(desc: int, n: int, k: int) -> int:
    """The shared-memory byte wgmma reads for element (n, k) of a K-major
    B operand of 8-bit type (k < 32) from a B64 descriptor: the canonical
    layout ((8, n/8), 2) : ((64 B, SBO), 16 B) from the start address, then
    the 64-byte swizzle on the address bits (Swizzle<2, 4, 3>: bits 7-8
    XOR into bits 4-5)."""
    assert desc >> 62 == 2  # the 64-byte swizzle
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    addr = start + (n // 8) * sbo + (n % 8) * 64 + (k // 16) * 16 + (k % 16)
    return addr ^ (((addr >> 7) & 3) << 4)


@pytest.mark.parametrize("stage", [0, 3, B_STAGES - 1])
def test_descriptor_reads_the_bytes_tma_wrote(stage):
    """For both k32 steps of a tap (the second descriptor is the first plus
    32 >> 4), every (n, k) that the product needs is the byte TMA placed
    for weight row n, byte 32 ks + k of the tile."""
    base = 0x400 + stage * B_TILE  # a 1024-byte aligned stage of the ring
    tile = np.arange(BN * 64, dtype=np.int64).reshape(BN, 64)  # distinct bytes
    smem = np.full(base + B_TILE, -1, np.int64)
    for n in range(BN):
        for kb in range(64):
            smem[base + tma_swizzle64(n, kb)] = tile[n, kb]
    desc0 = b_desc(base)
    for ks, desc in enumerate((desc0, desc0 + (32 >> 4))):
        got = np.array([[smem[desc_read(desc, n, k)] for k in range(32)] for n in range(BN)])
        assert np.array_equal(got, tile[:, 32 * ks:32 * ks + 32]), ks


def test_weight_tile_coordinates_cover_k_once():
    """The producer loads, for chunk c and tap t, K columns t * Cin + 64 c
    .. + 64 of the (Cout, 9 Cin) weight: over all chunks and taps each K
    column of a tap is fetched once for the channels below Cin (the columns
    past Cin of a chunk meet the zero codes of the patch's channel tail)."""
    for cin in (16, 80, 128, 192, 1024):
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
    """``ldmatrix.x4`` (b16) on bytes: lane l gives the address of row l % 8
    of matrix l // 8; lane t receives, from each matrix, the 4 bytes at row
    t // 4, bytes 4 (t % 4) ..  Returns (32 lanes, 4 registers, 4 bytes)."""
    rows = [mem[a:a + 16] for a in addrs]
    regs = np.empty((32, 4, 4), mem.dtype)
    for t in range(32):
        for j in range(4):
            regs[t, j] = rows[8 * j + t // 4][4 * (t % 4):4 * (t % 4) + 4]
    return regs


def mma_a(regs: np.ndarray) -> np.ndarray:
    """The 16 x 32 byte A block of one warp that wgmma reads from a0..a3
    (the m16n8k32 s8 A fragment: a0 row g, bytes 4t..; a1 row g + 8; a2 row
    g, bytes 16 + 4t..; a3 row g + 8, bytes 16 + 4t..)."""
    a = np.empty((16, 32), regs.dtype)
    for t in range(32):
        g, c = t // 4, t % 4
        a[g, 4 * c:4 * c + 4] = regs[t, 0]
        a[g + 8, 4 * c:4 * c + 4] = regs[t, 1]
        a[g, 16 + 4 * c:20 + 4 * c] = regs[t, 2]
        a[g + 8, 16 + 4 * c:20 + 4 * c] = regs[t, 3]
    return a


@pytest.mark.parametrize("h,w", [(9, 256), (3, 64), (5, 20), (10, 8), (130, 1)])
def test_register_a_fragments_are_the_shifted_patch_rows(h, w):
    """For every consumer warp, tap and k32 step, the lanes' ldmatrix
    addresses (the s8 patch row of tile pixel m shifted by the tap, second
    16 bytes for lanes 16..31) give wgmma the codes of pixels (r + dy, c +
    dx) of the patch, bytes 32 ks .. 32 ks + 31."""
    tw, rows, *_ = geometry(h, w, BN)
    pw = tw + 2
    pix = (rows + 2) * pw
    rng = np.random.default_rng(h * w)
    patch = rng.integers(-127, 128, (pix, BK)).astype(np.int8)
    mem = np.zeros(PATCH_PIX * SQ_STRIDE, np.int8)
    for p in range(pix):
        mem[p * SQ_STRIDE:p * SQ_STRIDE + BK] = patch[p]
    for ctid in range(0, CONSUMER_THREADS, 32):  # one lane set a warp
        row_base = (ctid >> 7) * 64 + ((ctid >> 5) & 3) * 16
        offs = []
        for lane in range(32):
            m = row_base + (lane & 15)
            r = m // tw
            prow = r * pw + (m - r * tw) if m < rows * tw else 0
            offs.append(prow * SQ_STRIDE + (lane >> 4) * 16)
        for t in range(TAPS):
            dy, dx = t // 3, t % 3
            for ks in range(2):
                addrs = [o + (dy * pw + dx) * SQ_STRIDE + 32 * ks for o in offs]
                a = mma_a(ldsm_x4(mem, addrs))
                for i in range(16):
                    m = row_base + i
                    if m >= rows * tw:
                        continue
                    p = (m // tw + dy) * pw + m % tw + dx
                    assert np.array_equal(a[i], patch[p, 32 * ks:32 * ks + 32]), (ctid, t, i)


def test_accumulator_output_map_is_the_wgmma_layout_and_covers_the_tile():
    """store_tile's (row, column) of every accumulator is its place in the
    wgmma D fragment, and the 256 consumer threads cover the 128 x 128
    block tile once."""
    seen = np.zeros((TILE_M, BN), np.int64)
    for ctid, idx, m, n in store_rows_cols():
        assert (m, n) == wgmma_d_position(ctid, idx)
        seen[m, n] += 1
    assert (seen == 1).all()


# ------------------------------------ the halo patch and the taps: the whole conv


def emulate_fused(xq: torch.Tensor, wq_nk: torch.Tensor) -> torch.Tensor:
    """K4's fused conv on int8 codes, block by block as the kernel runs it:
    per chunk the TMA box of the codes from (64 c, w0 - 1, h0 - 1, b),
    zero-filled outside the tensor; per tap the 128 A rows at the shifted
    patch pixels and the weight tile of K columns t * Cin + 64 c .. read
    through the descriptors; the s32 accumulator stored to NHWC by the
    output map.  Returns the (B, H, W, Cout) accumulator as int64."""
    batch, h, w, cin = xq.shape
    cout = wq_nk.shape[0]
    tw, rows, *_ = geometry(h, w, cout)
    pw = tw + 2
    codes = xq.numpy().astype(np.int64)
    wmat = wq_nk.numpy().astype(np.int64)
    chunks = math.ceil(cin / BK)
    out = np.full((batch, h, w, cout), np.iinfo(np.int64).min, np.int64)
    m = np.arange(TILE_M)
    r, c = m // tw, m % tw
    prow = np.where(m < rows * tw, r * pw + c, 0)
    for b, h0, w0, n0 in zip(*block_origins(batch, h, w, cout)):
        acc = np.zeros((TILE_M, BN), np.int64)
        for ch in range(chunks):
            # the TMA box: (rows + 2) x (tw + 2) pixels x 64 channels
            hh = h0 - 1 + np.arange(rows + 2)[:, None]
            ww = w0 - 1 + np.arange(tw + 2)[None, :]
            cc = ch * BK + np.arange(BK)
            inside = ((hh >= 0) & (hh < h) & (ww >= 0) & (ww < w))[..., None] & (cc < cin)
            patch = np.where(inside, codes[b, hh.clip(0, h - 1), ww.clip(0, w - 1)][
                ..., cc.clip(0, cin - 1)], 0).reshape(-1, BK)
            for t in range(TAPS):
                a = patch[prow + (t // 3) * pw + t % 3]  # (128, 64)
                k = t * cin + ch * BK + np.arange(BK)
                n = n0 + np.arange(BN)
                ok = (n < cout)[:, None] & (k < 9 * cin)[None, :]
                btile = np.where(ok, wmat[n.clip(0, cout - 1)][:, k.clip(0, 9 * cin - 1)], 0)
                acc += a @ btile.T
        for ctid, idx, mm, nn in store_rows_cols():
            rr = mm // tw
            hh_, ww_, n = h0 + rr, w0 + mm - rr * tw, n0 + nn
            if mm < rows * tw and hh_ < h and ww_ < w and n < cout:
                out[b, hh_, ww_, n] = acc[mm, nn]
    return torch.from_numpy(out)


# each path site's tile geometry (8 x 16 tiles) at small H, B and Cin,
# ragged ones, and narrow images (W < 16: 128 / W rows); Cin 80 has a
# partial second chunk
EXACT = [((1, 9, 256, 32), 128), ((2, 3, 128, 16), 24), ((2, 10, 64, 80), 136),
         ((1, 4, 300, 32), 8), ((1, 7, 20, 48), 7), ((2, 3, 33, 16), 130),
         ((1, 20, 5, 16), 16), ((1, 130, 1, 16), 8)]


@pytest.mark.parametrize("xshape,cout", EXACT)
def test_patch_and_taps_give_the_exact_accumulator(xshape, cout):
    g = torch.Generator().manual_seed(sum(xshape) + cout)
    xq = torch.randint(-127, 128, xshape, generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, xshape[-1], cout), generator=g, dtype=torch.int8)
    wq_nk = wq.permute(3, 0, 1, 2).reshape(cout, -1).contiguous()
    got = emulate_fused(xq, wq_nk)
    assert torch.equal(got.double(), k4.conv_acc_plain(xq, wq))


# ------------------------------------------------ the quantizer's arithmetic

F32 = np.float32
MAGIC = F32(12582912.0)  # 1.5 * 2^23


def code_bits(v: np.ndarray) -> np.ndarray:
    """``s8wgmma::code_bits``: clamp to [-127, 127] (fminf / fmaxf drop a
    NaN operand), NaN to 0, plus 1.5 * 2^23; the low byte is the code."""
    c = np.fmin(np.fmax(v, F32(-127)), F32(127)).astype(F32)
    c = np.where(v == v, c, F32(0)).astype(F32)
    t = (c + MAGIC).astype(F32)
    return (t.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int64)


def exact_codes(q: np.ndarray) -> np.ndarray:
    """clip(rn(q), +-127) with NaN -> 0, as cvt.rni and the plain version."""
    with np.errstate(invalid="ignore"):
        r = np.rint(np.nan_to_num(q, nan=0.0, posinf=1e9, neginf=-1e9))
    return np.clip(r, -127, 127).astype(np.int64)


def test_code_bits_is_round_half_even_and_clip():
    v = np.concatenate([
        np.arange(-140, 140, 1 / 512, dtype=F32),
        np.nextafter(np.arange(-130, 130, 0.5, dtype=F32), F32(np.inf)),
        np.nextafter(np.arange(-130, 130, 0.5, dtype=F32), F32(-np.inf)),
        np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-45, 3e38, -3e38], F32)])
    assert np.array_equal(code_bits(v), exact_codes(v))


def quotient_codes(v: np.ndarray, scale: F32):
    """``s8wgmma::quotient_code_bits`` over a piece of values, with the
    kernel's fallback: the codes and where the fallback ran."""
    with np.errstate(all="ignore"):
        recip = (F32(1) / scale).astype(F32)
        q = (v * recip).astype(F32)
        c = np.fmin(np.fmax(q, F32(-127)), F32(127)).astype(F32)
        t = (c + MAGIC).astype(F32)
        k = (t - MAGIC).astype(F32)
        exact = (np.abs((c - k).astype(F32)) < F32(0.5 - 2 ** -14)) & (q == q)
        fast = (t.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int64)
        slow = code_bits((v / scale).astype(F32))  # __fdiv_rn: IEEE division
    return np.where(exact, fast, slow), ~exact


@pytest.mark.parametrize("seed", range(4))
def test_dynamic_codes_equal_the_true_division(seed):
    """The dynamic quantize takes the code of RN(x * RN(1 / scale)) where
    that lies farther than 2^-14 from a half-integer, else the correctly
    rounded division: the codes equal those of RN(x / scale) for every x,
    and the division runs for about 1 value in 8000 of normal data."""
    rng = np.random.default_rng(seed)
    for trial in range(8):
        scale = F32(10 ** rng.uniform(-30, 30) if trial % 2 else rng.uniform(1e-3, 50))
        v = (rng.standard_normal(100_000) * scale * rng.uniform(1, 150)).astype(F32)
        half = ((rng.integers(-128, 128, 20_000) + F32(0.5)) * scale).astype(F32)
        adversarial = np.concatenate([half, np.nextafter(half, F32(np.inf)),
                                      np.nextafter(half, F32(-np.inf))])
        special = np.array([0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -3e38], F32)
        for x in (v, adversarial, special):
            got, _ = quotient_codes(x, scale)
            with np.errstate(all="ignore"):
                want = exact_codes((x / scale).astype(F32))
            assert np.array_equal(got, want), (seed, trial)
    normal = (rng.standard_normal(400_000) * F32(40)).astype(F32)
    _, slow = quotient_codes(normal, F32(0.7))
    assert slow.mean() < 5e-4


# ----------------------------------------------------------- the path choice


def _weight(cin: int, cout: int) -> k4.Int8Weight:
    return k4.quantize_conv_weight(torch.zeros((3, 3, cin, cout)))


@pytest.mark.parametrize("nf", [64, 128])
def test_every_flagship_site_takes_the_wgmma_path(nf):
    for (xshape, cout), _ in SITES[nf].items():
        x = torch.zeros((4, 2, 2, xshape[-1]), dtype=torch.bfloat16)
        assert k4.k4_path(x, _weight(xshape[-1], cout)) == "wgmma", (xshape, cout)


def test_other_shapes_take_the_general_path():
    """Cin % 16 != 0 (the 9 * Cin-byte weight row and the x row are not
    16-byte strides) and an x that starts off a 16-byte boundary go to the
    general path; the choice needs no card."""
    x = torch.zeros((2, 4, 4, 72), dtype=torch.bfloat16)
    assert k4.k4_path(x, _weight(72, 64)) == "general"
    flat = torch.zeros(2 * 4 * 4 * 64 + 8, dtype=torch.bfloat16)
    shifted = flat[4:4 + 2 * 4 * 4 * 64].view(2, 4, 4, 64)  # 8 bytes in
    assert k4.k4_path(shifted, _weight(64, 64)) == "general"
    assert k4.k4_path(flat[:2 * 4 * 4 * 64].view(2, 4, 4, 64), _weight(64, 64)) == "wgmma"
