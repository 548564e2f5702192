"""The tiling of K3's wgmma paths (``csrc/flash_attn_kernel.cu`` and
``csrc/flash_attn_bwd_kernel.cu``, namespace ``wgmma``, with
``csrc/flash_wgmma.cuh``), replayed in PyTorch on the CPU and held against
the plain versions and the JAX package's references.

Forward: a block is one or two consumer warpgroups of 64 queries; per key
tile of 64 a warpgroup scores S = Q K^T in fp32, runs the online softmax
on its accumulator (each thread's partial row sums over its own columns,
added across the quad at the end), rounds the unnormalised p to the
input dtype and adds P V in fp32; one division by l, one rounding.
Backward: dkv owns 64 keys, warpgroup 0 forms the fp32 P^T and dV,
warpgroup 1 takes that P^T for dS^T and dK; dq owns 64 queries.  Operands
arrive by TMA through 3-D tensor maps over (C, L, B) as 64-channel boxes
with the 128-byte swizzle and are read by wgmma descriptors, K-major for
the scores and MN-major for the m64n256 products.

The constants are read from the sources (keep their ``constexpr int NAME =
N;`` lines in one-line form, and the descriptors' ``(uint64_t)N << ...``
fields).  The kernels themselves are held against the plain versions on
the card by ``chip_smoke.py``.  Tolerances: bf16 / fp16 as
``chip_smoke.FLASH_TOL`` and ``FLASH_BWD_TOL`` (one ulp of a rounded p or
ds apart from the plain version), fp32 against the JAX references 1e-5
(only the order of fp32 sums differs).
"""

from __future__ import annotations

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

from mudiff_torch import ops
from mudiff_torch.ops import _build, attn_di, flash_attn_plain, row_stats_plain
from mudiff_torch.ops.flash_attn import _bwd_plain, k3_path, k3_path_for

_FWD_SRC = (_build.CSRC / "flash_attn_kernel.cu").read_text()
_BWD_SRC = (_build.CSRC / "flash_attn_bwd_kernel.cu").read_text()
_HDR = (_build.CSRC / "flash_wgmma.cuh").read_text()
_FWD = _FWD_SRC[_FWD_SRC.index("namespace wgmma {"):]
_BWD = _BWD_SRC[_BWD_SRC.index("namespace wgmma {"):]


def _const(text: str, name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, name
    return int(found[0])


HEAD_DIM, TILE_ROWS, ATOM_C, ATOMS, ROW_BYTES, WG_THREADS = (
    _const(_HDR, n) for n in ("HEAD_DIM", "TILE_ROWS", "ATOM_C", "ATOMS", "ROW_BYTES",
                              "WG_THREADS"))
ATOM_BYTES = TILE_ROWS * ROW_BYTES
TILE_BYTES = ATOMS * ATOM_BYTES
QUERY_ROWS, KEY_ROWS = _const(_FWD, "QUERY_ROWS"), _const(_FWD, "KEY_ROWS")
STAGES = {1: _const(_FWD, "STAGES_NARROW"), 2: _const(_FWD, "STAGES_WIDE")}
BLOCKS = {1: _const(_FWD, "BLOCKS_NARROW"), 2: 1}
OWN_ROWS, STEP_ROWS = _const(_BWD, "OWN_ROWS"), _const(_BWD, "STEP_ROWS")
DKV_THREADS, DKV_STAGES = _const(_BWD, "DKV_THREADS"), _const(_BWD, "DKV_STAGES")
DQ_THREADS, DQ_STAGES = _const(_BWD, "DQ_THREADS"), _const(_BWD, "DQ_STAGES")
STAT_THREADS, STAT_BYTES = _const(_BWD, "STAT_THREADS"), _const(_BWD, "STAT_BYTES")
P_BYTES = _const(_BWD, "P_BYTES")
SMEM_LIMIT = _const(_FWD, "SMEM_LIMIT")
assert _const(_BWD, "SMEM_LIMIT") == SMEM_LIMIT
SM_SMEM = 233472       # shared memory of an H100 SM, 1 KB of it reserved a block
SCHEDULER_REGS = 16384  # 32-bit registers of each of an SM's four schedulers
FLASH_TOL = (2e-2, 2e-2)   # chip_smoke.FLASH_TOL["bf16"], also for fp16
FLASH_BWD_TOL = 2e-2       # chip_smoke.FLASH_BWD_TOL["bf16"], of max |plain|
FP32_TOL = 1e-5
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


# ------------------------------------------------------------ the constants


def fwd_smem(nwg: int) -> int:
    """``wgmma::Config<NWG>::SMEM``: alignment slack, the Q tiles, the ring,
    the barriers and the slot counts."""
    return 1024 + (nwg + STAGES[nwg]) * TILE_BYTES + (STAGES[nwg] + 1) * 8 + STAGES[nwg] * 4


def dkv_smem() -> int:
    return (1024 + 2 * TILE_BYTES + DKV_STAGES * (2 * TILE_BYTES + STAT_BYTES) + P_BYTES
            + (1 + 2 * DKV_STAGES) * 8)


def dq_smem() -> int:
    return 1024 + 2 * TILE_BYTES + DQ_STAGES * 2 * TILE_BYTES + (1 + 2 * DQ_STAGES) * 8


def registers(threads: int, blocks: int) -> int:
    """The registers a thread keeps when ``blocks`` blocks of ``threads``
    share an SM: the warps are dealt to the four schedulers in turn, each
    of which holds a quarter of the register file."""
    warps_per_scheduler = blocks * math.ceil(threads // 32 / 4)
    return min(255, SCHEDULER_REGS // (32 * warps_per_scheduler) // 8 * 8)


def test_tiles_are_one_wgmma_and_four_swizzle_boxes():
    """64-row tiles (m64 of every product, the scores' n64 and the m64n256
    products' k of 4 x 16), a 256-channel head in four 128-byte boxes."""
    assert HEAD_DIM == 256 and ATOMS * ATOM_C == HEAD_DIM and ATOM_C * 2 == ROW_BYTES == 128
    assert TILE_ROWS == QUERY_ROWS == KEY_ROWS == OWN_ROWS == STEP_ROWS == 64
    assert TILE_ROWS <= 256 and ATOM_C <= 256  # TMA box dimensions
    assert P_BYTES == OWN_ROWS * STEP_ROWS * 4 and 3 * STEP_ROWS * 4 <= STAT_BYTES
    assert STAT_THREADS == STEP_ROWS and DKV_THREADS == 2 * WG_THREADS
    assert DQ_THREADS == 2 * WG_THREADS and all(s % 2 == 0 for s in STAGES.values())


# (name, threads a block, blocks an SM, shared memory, fp32 accumulator +
# score + A registers a consumer thread holds at once)
INSTANCES = [
    ("forward, 64-query blocks", WG_THREADS, BLOCKS[1], fwd_smem(1), 128 + 32 + 16),
    ("forward, 128-query blocks", 2 * WG_THREADS, BLOCKS[2], fwd_smem(2), 128 + 32 + 16),
    ("dkv", DKV_THREADS, 1, dkv_smem(), 128 + 32 + 16),
    ("dq", DQ_THREADS, 1, dq_smem(), 128 + 2 * 32 + 16),
]


@pytest.mark.parametrize("name,threads,blocks,smem,live", INSTANCES,
                         ids=[i[0] for i in INSTANCES])
def test_instances_fit_the_card(name, threads, blocks, smem, live):
    """Shared memory within the 227 KB a block may use (and the planned
    blocks within an SM's 228 KB); the registers a thread keeps hold its
    accumulators, scores and register-A operand beside ~24 for addresses
    and statistics."""
    assert smem <= SMEM_LIMIT and blocks * (smem + 1024) <= SM_SMEM, name
    assert registers(threads, blocks) >= live + 24, name


def test_a_producer_warp_beside_two_warpgroups_would_starve_the_consumers():
    """Why dkv and 128-query forward blocks have no producer warp: nine
    warps put three on one scheduler, 168 registers a thread, too few for
    the live accumulators; eight keep 255."""
    assert registers(2 * WG_THREADS + 32, 1) == 168 < 128 + 32 + 16 + 24
    assert registers(2 * WG_THREADS, 1) == 255


# ------------------------------------------------ the TMA boxes and the reads


def tma_box(x: torch.Tensor, c0: int, r0: int, b: int) -> torch.Tensor:
    """The box ``encode_rows`` describes, loaded from (c0, r0, b): dims (C,
    L, B), a box of ATOM_C x TILE_ROWS x 1, zero outside the tensor."""
    _, length, c = x.shape
    box = torch.zeros(TILE_ROWS, ATOM_C, dtype=x.dtype)
    rows = x[b, max(r0, 0):min(r0 + TILE_ROWS, length), c0:c0 + ATOM_C]
    box[:rows.shape[0], :rows.shape[1]] = rows
    return box


def test_tensor_maps_are_3d_over_c_l_b():
    """``encode_rows`` encodes (C, L, B) with one batch row a box, so a
    box never reaches into the next batch row."""
    body = _HDR[_HDR.index("inline int encode_rows("):]
    body = body[:body.index("\n}\n")]
    assert "dim[3] = {(cuuint64_t)C, (cuuint64_t)L, (cuuint64_t)batch}" in body
    assert "box[3] = {ATOM_C, TILE_ROWS, 1}" in body
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in body and "OOB_FILL_NONE" in body


@pytest.mark.parametrize("length", [96, 200])
def test_box_at_a_ragged_length_is_zero_past_l(length):
    """B = 2: the last tile of batch row 0 holds rows past L as zeros, not
    batch row 1's first rows (what a 2-D map over (B L, C) would read)."""
    x = torch.arange(2 * length * HEAD_DIM, dtype=torch.float32).reshape(2, length, HEAD_DIM) + 1
    r0 = (length // TILE_ROWS) * TILE_ROWS
    valid = length - r0
    flat = x.reshape(2 * length, HEAD_DIM)
    for a in range(ATOMS):
        box = tma_box(x, a * ATOM_C, r0, 0)
        assert torch.equal(box[:valid], x[0, r0:, a * ATOM_C:(a + 1) * ATOM_C])
        assert bool((box[valid:] == 0).all())
        flat_box = flat[r0:r0 + TILE_ROWS, a * ATOM_C:(a + 1) * ATOM_C]
        assert bool((flat_box[valid:] != 0).all())  # the next row's keys


def swizzle128(addr: int) -> int:
    """Where TMA's 128-byte swizzle puts the byte at offset ``addr`` from a
    1024-byte aligned base: 16-byte chunk bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _desc_fields(name: str):
    body = _HDR[_HDR.index(f"uint64_t {name}("):]
    body = body[:body.index("\n}\n")]
    lbo = re.search(r"\(uint64_t\)(?:\((\d+) >> 4\)|(\d+)) << 16", body)
    lbo = (int(lbo.group(1)) if lbo.group(1) else int(lbo.group(2)) << 4)
    sbo = int(re.search(r"\(uint64_t\)\((\d+) >> 4\) << 32", body).group(1))
    layout = int(re.search(r"\(uint64_t\)(\d+) << 62", body).group(1))
    return lbo, sbo, layout


def kmajor_desc(tile: int, kk: int) -> int:
    """``k3w::kmajor_desc`` with its fields read from the header."""
    lbo, sbo, layout = _desc_fields("kmajor_desc")
    addr = tile + (kk >> 2) * ATOM_BYTES + (kk & 3) * 32
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32) | (layout << 62)


def mn_desc(tile: int, kk: int) -> int:
    lbo, sbo, layout = _desc_fields("mn_desc")
    addr = tile + kk * 16 * ROW_BYTES
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32) | (layout << 62)


def kmajor_read(desc: int, row: int, k: int) -> int:
    """The byte wgmma reads for element (row, k) (k < 16) of a K-major
    16-bit operand under the 128-byte swizzle: the canonical layout ((8,
    m), (8 T, 2)) : ((128 B, SBO), (2 B, 16 B)) from the start address,
    then the swizzle on the address bits (LBO unused)."""
    assert desc >> 62 == 1
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    return swizzle128(start + (row // 8) * sbo + (row % 8) * ROW_BYTES + k * 2)


def mn_read(desc: int, k: int, n: int) -> int:
    """The byte wgmma reads for element (k, n) (k < 16) of an MN-major B:
    ((8, 8, n / 64), (8, k / 8)) : ((2 B, 16 B, LBO), (128 B, SBO))."""
    assert desc >> 62 == 1
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    return swizzle128(start + (n // 64) * lbo + (n % 64) * 2 + (k % 8) * ROW_BYTES
                      + (k // 8) * sbo)


def _tma_tile(base: int):
    """A tile of distinct elements (64 rows x 256 channels) written by
    TMA as four swizzled boxes ATOM_BYTES apart from ``base``."""
    tile = np.arange(TILE_ROWS * HEAD_DIM, dtype=np.int64).reshape(TILE_ROWS, HEAD_DIM)
    smem = np.full((base + TILE_BYTES) // 2, -1, np.int64)
    for a in range(ATOMS):
        for r in range(TILE_ROWS):
            for c in range(ATOM_C):
                off = a * ATOM_BYTES + r * ROW_BYTES + c * 2
                smem[(base + swizzle128(off)) // 2] = tile[r, a * ATOM_C + c]
    return tile, smem


@pytest.mark.parametrize("base", [1024 * 3, 1024 * 3 + 2 * TILE_BYTES])
def test_kmajor_descriptors_read_the_elements_tma_wrote(base):
    """The scores' operands (Q, K, V, dO as rows x channels): k16 step kk
    of row r is channel 16 kk + k of tile row r, for every kk of the head."""
    tile, smem = _tma_tile(base)
    for kk in range(HEAD_DIM // 16):
        desc = kmajor_desc(base, kk)
        got = np.array([[smem[kmajor_read(desc, r, k) // 2] for k in range(16)]
                        for r in range(TILE_ROWS)])
        assert np.array_equal(got, tile[:, 16 * kk:16 * kk + 16]), kk


def test_mn_major_descriptors_read_the_elements_tma_wrote():
    """The m64n256 products' B (V, dO, Q, K as k = tile rows, n =
    channels): k16 step kk is tile rows 16 kk .., all 256 channels."""
    base = 1024 * 5
    tile, smem = _tma_tile(base)
    for kk in range(TILE_ROWS // 16):
        desc = mn_desc(base, kk)
        got = np.array([[smem[mn_read(desc, k, n) // 2] for n in range(HEAD_DIM)]
                        for k in range(16)])
        assert np.array_equal(got, tile[16 * kk:16 * kk + 16]), kk


def acc_row(t: int, x: int) -> int:
    """``k3w::acc_row`` / ``acc_col``: element x of thread t of the m64nN
    fp32 accumulator."""
    return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((x >> 1) & 1)


def acc_col(t: int, x: int) -> int:
    return 8 * (x >> 2) + 2 * (t & 3) + (x & 1)


def test_accumulator_map_covers_the_tiles_once():
    """The 64 x 64 score and the 64 x 256 output accumulators: every
    (row, column) held by one thread's one element."""
    for n, regs in ((64, 32), (256, 128)):
        seen = np.zeros((64, n), np.int64)
        for t in range(WG_THREADS):
            for x in range(regs):
                seen[acc_row(t, x), acc_col(t, x)] += 1
        assert (seen == 1).all(), n


def test_to_a_packs_the_m16n8k16_a_fragments():
    """``k3w::to_a``: register kk holds columns 16 kk .. 16 kk + 15 of the
    accumulator as wgmma's A fragments (a0 (r, c..c+1), a1 (r + 8, c..),
    a2 (r, c + 8..), a3 (r + 8, c + 8..), r = lane / 4 of the warp's 16
    rows, c = 2 (lane % 4))."""
    body = _HDR[_HDR.index("void to_a("):]
    pairs = [tuple(int(v) for v in m) for m in re.findall(
        r"pack2<T>\(f\[8 \* kk \+ (\d)\], f\[8 \* kk \+ (\d)\]\)", body[:body.index("\n}\n")])]
    assert len(pairs) == 4
    for t in range(WG_THREADS):
        lane, warp = t & 31, t >> 5
        r, c = 16 * warp + lane // 4, 2 * (lane % 4)
        want = [(r, c), (r + 8, c), (r, c + 8), (r + 8, c + 8)]
        for kk in range(4):
            for reg, (lo, hi) in enumerate(pairs):
                x0, x1 = 8 * kk + lo, 8 * kk + hi
                assert (acc_row(t, x0), acc_col(t, x0)) == (want[reg][0],
                                                            16 * kk + want[reg][1])
                assert (acc_row(t, x1), acc_col(t, x1)) == (want[reg][0],
                                                            16 * kk + want[reg][1] + 1)


# ------------------------------------------------------------- the replays


def _rows(t: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows [r0, r0 + n) of an (L, C) matrix as fp32, zero past L (the 3-D
    box's zero fill)."""
    block = torch.zeros(n, t.shape[1])
    rows = t[r0:r0 + n].float()
    block[:rows.shape[0]] = rows
    return block


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product of 16-bit-exact fp32 operands summed in fp32 (in float64,
    then rounded: the tensor cores' order aside)."""
    return (a.double() @ b.double()).float()


def fwd_replay(q, k, v, scale, block_q):
    """(out, m, l) as ``flash_attn_kernel_wgmma`` computes them with
    ``block_q`` queries a block: per warpgroup of 64 queries, per key
    tile, in the kernel's order."""
    b, length, c = q.shape
    dt = q.dtype
    out = torch.empty_like(q)
    m_out, l_out = torch.empty(b, length), torch.empty(b, length)
    quad = torch.arange(64) % 8 // 2          # the quad lane a key column lies on
    for bi in range(b):
        for q0 in range(0, length, block_q):
            for g in range(block_q // QUERY_ROWS):
                r0 = q0 + g * QUERY_ROWS
                qt = _rows(q[bi], r0, QUERY_ROWS)
                m = torch.full((QUERY_ROWS,), -math.inf)
                lp = torch.zeros(QUERY_ROWS, 4)     # a thread's partial row sums
                o = torch.zeros(QUERY_ROWS, c)
                for k0 in range(0, length, KEY_ROWS):
                    kt, vt = _rows(k[bi], k0, KEY_ROWS), _rows(v[bi], k0, KEY_ROWS)
                    s = _mm(qt, kt.T) * scale
                    s[:, torch.arange(k0, k0 + KEY_ROWS) >= length] = -math.inf
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp(m - m_new)
                    m = m_new
                    lp = lp * alpha[:, None]
                    p = torch.exp(s - m[:, None])
                    for j in range(8):              # a thread's columns in its order
                        for e in range(2):
                            cols = 8 * j + 2 * torch.arange(4) + e
                            lp[:, quad[cols]] += p[:, cols]
                    o = o * alpha[:, None] + _mm(p.to(dt).float(), vt)
                lsum = (lp[:, 0] + lp[:, 1]) + (lp[:, 2] + lp[:, 3])
                n = max(0, min(QUERY_ROWS, length - r0))
                out[bi, r0:r0 + n] = (o * (1.0 / lsum)[:, None])[:n].to(dt)
                m_out[bi, r0:r0 + n], l_out[bi, r0:r0 + n] = m[:n], lsum[:n]
    return out, m_out, l_out


def _inputs(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
                   for _ in range(4))
    q = (2.0 * q.float()).to(dtype)   # scores ~ N(0, 4): a peaked softmax
    return q, k, v, do, float(shape[-1]) ** -0.5


@pytest.mark.parametrize("tag", ["bf16", "fp16"])
@pytest.mark.parametrize("length", [96, 200])
def test_forward_replay_matches_the_plain_version(length, tag):
    q, k, v, _, scale = _inputs((2, length, HEAD_DIM), length, DTYPES[tag])
    out, m, l = fwd_replay(q, k, v, scale, 64)
    want = flash_attn_plain(q, k, v, scale)
    err = (out.float() - want.float()).abs()
    assert bool((err <= FLASH_TOL[0] + FLASH_TOL[1] * want.float().abs()).all())
    stats = row_stats_plain(q, k, scale)
    assert torch.allclose(m, stats[0], rtol=1e-6, atol=1e-6)
    assert torch.allclose(l, stats[1], rtol=1e-5)


def test_forward_replay_matches_the_jax_reference():
    """fp32: the stock Pallas module's own reference (sm_scale folded into
    q, as the JAX package's backward takes it)."""
    q, k, v, _, scale = _inputs((2, 200, HEAD_DIM), 7, torch.float32)
    out, _, _ = fwd_replay(q, k, v, scale, 128)
    ref = mha_reference(*(jnp.asarray(t.numpy())[:, None] for t in (q * scale, k, v)), None)
    assert np.allclose(out.numpy(), np.asarray(ref)[:, 0], rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("length", [96, 200])
def test_64_and_128_query_blocks_give_the_same_bits(length):
    """A row's sums follow the key tiling alone: the block size moves
    which warpgroup holds a row, not its arithmetic."""
    q, k, v, _, scale = _inputs((2, length, HEAD_DIM), 3, torch.bfloat16)
    a, b = fwd_replay(q, k, v, scale, 64), fwd_replay(q, k, v, scale, 128)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def dkv_replay(q, k, v, do, stats, di, scale):
    """(dk, dv) as ``flash_attn_bwd_dkv_kernel_wgmma`` computes them, and
    how many stores each element got: per block of 64 keys, per query step,
    warpgroup 0 forms P^T in fp32 (exp(s scale - m) times the staged 1 /
    l, zero past L) and adds round(P^T) dO; warpgroup 1 takes that fp32
    P^T, forms round((dP^T - di) P^T scale) and adds it times Q."""
    b, length, c = q.shape
    dt = q.dtype
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stores = torch.zeros(2, b, length, c, dtype=torch.int32)
    for bi in range(b):
        for k0 in range(0, length, OWN_ROWS):
            kt, vt = _rows(k[bi], k0, OWN_ROWS), _rows(v[bi], k0, OWN_ROWS)
            key_ok = (torch.arange(k0, k0 + OWN_ROWS) < length)[:, None]
            acc_k, acc_v = torch.zeros(OWN_ROWS, c), torch.zeros(OWN_ROWS, c)
            for q0 in range(0, length, STEP_ROWS):
                qt, dot = _rows(q[bi], q0, STEP_ROWS), _rows(do[bi], q0, STEP_ROWS)
                idx = torch.arange(q0, q0 + STEP_ROWS)
                ok = idx < length
                idx = idx.clamp(max=length - 1)
                m = torch.where(ok, stats[0, bi, idx], 0.0)
                il = torch.where(ok, 1.0 / stats[1, bi, idx], 0.0)
                dis = torch.where(ok, di[bi, idx], 0.0)
                pt = torch.where(key_ok, torch.exp(_mm(kt, qt.T) * scale - m) * il, 0.0)
                acc_v += _mm(pt.to(dt).float(), dot)                       # warpgroup 0
                dst = ((_mm(vt, dot.T) - dis) * pt * scale).to(dt).float()  # warpgroup 1
                acc_k += _mm(dst, qt)
            n = min(OWN_ROWS, length - k0)
            dk[bi, k0:k0 + n], dv[bi, k0:k0 + n] = acc_k[:n].to(dt), acc_v[:n].to(dt)
            stores[:, bi, k0:k0 + n] += 1   # dk by warpgroup 1, dv by warpgroup 0
    return dk, dv, stores


def dq_replay(q, k, v, do, stats, di, scale):
    """dq as ``flash_attn_bwd_dq_kernel_wgmma`` computes it, and the
    stores each element got."""
    b, length, c = q.shape
    dt = q.dtype
    dq = torch.empty_like(q)
    stores = torch.zeros(b, length, c, dtype=torch.int32)
    for bi in range(b):
        for q0 in range(0, length, OWN_ROWS):
            qt, dot = _rows(q[bi], q0, OWN_ROWS), _rows(do[bi], q0, OWN_ROWS)
            idx = torch.arange(q0, q0 + OWN_ROWS)
            ok = (idx < length)[:, None]
            idx = idx.clamp(max=length - 1)
            m, il, dis = stats[0, bi, idx][:, None], 1.0 / stats[1, bi, idx][:, None], \
                di[bi, idx][:, None]
            acc = torch.zeros(OWN_ROWS, c)
            for k0 in range(0, length, STEP_ROWS):
                kt, vt = _rows(k[bi], k0, STEP_ROWS), _rows(v[bi], k0, STEP_ROWS)
                k_ok = (torch.arange(k0, k0 + STEP_ROWS) < length)[None, :]
                p = torch.where(ok & k_ok, torch.exp(_mm(qt, kt.T) * scale - m) * il, 0.0)
                ds = ((_mm(dot, vt.T) - dis) * p * scale).to(dt).float()
                acc += _mm(ds, kt)
            n = min(OWN_ROWS, length - q0)
            dq[bi, q0:q0 + n] = acc[:n].to(dt)
            stores[bi, q0:q0 + n] += 1
    return dq, stores


def _bwd_inputs(shape, seed, dtype):
    q, k, v, do, scale = _inputs(shape, seed, dtype)
    stats = row_stats_plain(q, k, scale)
    di = attn_di(flash_attn_plain(q, k, v, scale), do)
    return q, k, v, do, stats, di, scale


def _check_rel(got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert scale > 0 and err <= tol * scale, f"max abs err {err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.parametrize("tag", ["bf16", "fp16"])
@pytest.mark.parametrize("length", [96, 200])
def test_backward_replay_matches_the_plain_version(length, tag):
    q, k, v, do, stats, di, scale = _bwd_inputs((2, length, HEAD_DIM), length + 1, DTYPES[tag])
    dq, dk, dv = _bwd_plain(q, k, v, do, stats, di, scale)
    got_k, got_v, _ = dkv_replay(q, k, v, do, stats, di, scale)
    for got, want in ((got_k, dk), (got_v, dv), (dq_replay(q, k, v, do, stats, di, scale)[0],
                                                 dq)):
        assert got.dtype == want.dtype
        _check_rel(got, want, FLASH_BWD_TOL)


def test_backward_replay_matches_the_jax_reference_gradients():
    """fp32: ``jax.vjp`` of the stock module's reference."""
    q, k, v, do, stats, di, scale = _bwd_inputs((2, 96, HEAD_DIM), 5, torch.float32)
    as_jax = [jnp.asarray(t.numpy())[:, None] for t in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b, c: mha_reference(a * scale, b, c, None), *as_jax)
    ref_q, ref_k, ref_v = (torch.from_numpy(np.array(g)[:, 0])
                           for g in vjp(jnp.asarray(do.numpy())[:, None]))
    got_k, got_v, _ = dkv_replay(q, k, v, do, stats, di, scale)
    for got, want in ((dq_replay(q, k, v, do, stats, di, scale)[0], ref_q), (got_k, ref_k),
                      (got_v, ref_v)):
        _check_rel(got, want, FP32_TOL)


@pytest.mark.parametrize("length", [96, 200, 1000])
def test_every_output_element_has_one_owner(length):
    """dk, dv and dq: one block and one warpgroup store each element once;
    no atomics, nothing left out at a ragged length."""
    shape = (2, length, HEAD_DIM)
    z = torch.zeros(shape)
    stats = torch.stack([torch.zeros(2, length), torch.ones(2, length)])
    _, _, kv_stores = dkv_replay(z, z, z, z, stats, torch.zeros(2, length), 1.0)
    _, q_stores = dq_replay(z, z, z, z, stats, torch.zeros(2, length), 1.0)
    assert bool((kv_stores == 1).all()) and bool((q_stores == 1).all())


# ------------------------------------------------------------------ the path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_k3_path_for(c, dtype):
    """fp32 on the FMA kernels; bf16 / fp16 on wgmma at the recipe's head
    dim (256) and on the general path's mma.sync kernels elsewhere (C = 512 at
    nf = 128, and the smaller heads of the tests and tiny configs)."""
    want = "fma" if dtype == torch.float32 else ("wgmma" if c == HEAD_DIM else "general")
    assert k3_path_for(c, dtype) == want
    assert k3_path(torch.zeros((1, 8, c), dtype=dtype)) == want


def test_path_counts_exist_and_reset():
    for fn in (ops.flash_attn, ops.flash_attn_bwd_dkv, ops.flash_attn_bwd_dq):
        fn.path_launches["wgmma"] += 1
    ops.reset_launch_counts()
    for fn in (ops.flash_attn, ops.flash_attn_bwd_dkv, ops.flash_attn_bwd_dq):
        assert fn.path_launches == {"wgmma": 0, "general": 0, "fma": 0}
