"""The tiling of K3's tensor-core backward, emulated in PyTorch on the CPU
and held against the plain version and the JAX reference gradients.

``csrc/flash_attn_bwd_kernel.cu`` (``flash_attn_bwd_dkv_kernel_tc``,
``flash_attn_bwd_dq_kernel_tc``): a block of eight warps owns OWN rows of
one side in row groups of 16 and steps over the other side in tiles of
STEP rows; SPLIT warps share a row group.  Phase 1: each warp scores its
STEP / SPLIT rows of the tile against its group's 16 over all of C, forms
p and ds and rounds both to the input dtype.  Phase 2: each warp adds the
group's products over the whole tile into its CMAX / SPLIT output
columns, in fp32.  Outputs are rounded once.  dkv owns keys and steps
over queries (dV += P^T dO, dK += dS^T Q); dq owns queries and steps over
keys (dQ += dS K).

The tile constants are read from the kernel source, so the emulation
follows them.  The kernels themselves are held against the plain version
on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

from mudiff_torch.ops import _build, attn_di, flash_attn_plain, row_stats_plain
from mudiff_torch.ops.flash_attn import _bwd_plain

_SRC = (_build.CSRC / "flash_attn_bwd_kernel.cu").read_text()
_TC = _SRC[_SRC.index("namespace tcbwd {"):]
PAD = int(re.search(r"constexpr int PAD = (\d+);", _TC).group(1))
THREADS = int(re.search(r"constexpr int THREADS = (\d+);", _TC).group(1))
# {CMAX: (SPLIT, OWN, STEP)}, both kernels: dkv owns OWN keys and steps
# over STEP queries, dq owns OWN queries and steps over STEP keys
TILES = {int(c): (int(s), int(own), int(step)) for c, s, own, step in re.findall(
    r"struct Shape<(\d+)> \{ static constexpr int SPLIT = (\d+), OWN = (\d+), STEP = (\d+); \};",
    _TC)}
CLASSES = sorted(TILES)
SMEM_LIMIT = 232448   # bytes of shared memory a block may use on an H100
FLASH_BWD_TOL = {"fp32": 1e-5, "bf16": 2e-2}   # of max |plain|


def head_class(c: int) -> int:
    """The CMAX a head dim runs at: the smallest class that holds it."""
    return next(cmax for cmax in CLASSES if c <= cmax)


def geometry(cmax: int):
    """(split, own, step, groups, rows a warp scores, columns a warp owns)."""
    split, own, step = TILES[cmax]
    return split, own, step, own // 16, step // split, cmax // split


def _rows(t: torch.Tensor, r0: int, n: int, cmax: int) -> torch.Tensor:
    """Rows [r0, r0 + n) of an (L, C) matrix as an (n, cmax) fp32 tile,
    zero past L and past C (the cp.async zero-fill)."""
    block = torch.zeros(n, cmax)
    rows = t[r0:r0 + n].float()
    block[:rows.shape[0], :rows.shape[1]] = rows
    return block


def _row_stats(stats, di, bi, r0, n, length):
    """m, 1/l, di of rows [r0, r0 + n) and their mask; zero past L."""
    idx = torch.arange(r0, r0 + n)
    ok = idx < length
    idx = idx.clamp(max=length - 1)
    m = torch.where(ok, stats[0, bi, idx], torch.zeros(()))
    il = torch.where(ok, 1.0 / stats[1, bi, idx], torch.zeros(()))
    return m, il, torch.where(ok, di[bi, idx], torch.zeros(())), ok


def _p_and_ds(s, dp, m, il, dis, ok, scale):
    """p and ds of a warp's scores, masked where either side is past L;
    the caller rounds both."""
    p = torch.where(ok, torch.exp(s * scale - m) * il, torch.zeros(()))
    return p, (dp - dis) * p * scale


def dkv_emulate(q, k, v, do, stats, di, scale):
    """(dk, dv) as ``flash_attn_bwd_dkv_kernel_tc`` computes them."""
    b, length, c = q.shape
    cmax = head_class(c)
    split, bk, bq, groups, sw, oc = geometry(cmax)
    dt = q.dtype
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for bi in range(b):
        for k0 in range(0, length, bk):
            kt, vt = _rows(k[bi], k0, bk, cmax), _rows(v[bi], k0, bk, cmax)
            key_ok = torch.arange(k0, k0 + bk) < length
            acc_k, acc_v = torch.zeros(bk, cmax), torch.zeros(bk, cmax)
            for q0 in range(0, length, bq):
                qt, dot = _rows(q[bi], q0, bq, cmax), _rows(do[bi], q0, bq, cmax)
                m, il, dis, q_ok = _row_stats(stats, di, bi, q0, bq, length)
                pt, dst = torch.zeros(bk, bq), torch.zeros(bk, bq)
                for w in range(THREADS // 32):   # phase 1: S^T, dP^T of a warp's queries
                    g, h = w % groups, w // groups
                    kr, qc = slice(16 * g, 16 * g + 16), slice(h * sw, h * sw + sw)
                    p, ds = _p_and_ds(kt[kr] @ qt[qc].T, vt[kr] @ dot[qc].T, m[qc], il[qc],
                                      dis[qc], key_ok[kr, None] & q_ok[None, qc], scale)
                    pt[kr, qc], dst[kr, qc] = p.to(dt).float(), ds.to(dt).float()
                for w in range(THREADS // 32):   # phase 2: a warp's output columns
                    g, h = w % groups, w // groups
                    kr, cols = slice(16 * g, 16 * g + 16), slice(h * oc, h * oc + oc)
                    acc_v[kr, cols] += pt[kr] @ dot[:, cols]
                    acc_k[kr, cols] += dst[kr] @ qt[:, cols]
            n = min(bk, length - k0)
            dk[bi, k0:k0 + n] = acc_k[:n, :c].to(dt)
            dv[bi, k0:k0 + n] = acc_v[:n, :c].to(dt)
    return dk, dv


def dq_emulate(q, k, v, do, stats, di, scale):
    """dq as ``flash_attn_bwd_dq_kernel_tc`` computes it."""
    b, length, c = q.shape
    cmax = head_class(c)
    split, bq, bk, groups, sw, oc = geometry(cmax)
    dt = q.dtype
    dq = torch.empty_like(q)
    for bi in range(b):
        for q0 in range(0, length, bq):
            qt, dot = _rows(q[bi], q0, bq, cmax), _rows(do[bi], q0, bq, cmax)
            m, il, dis, q_ok = _row_stats(stats, di, bi, q0, bq, length)
            acc = torch.zeros(bq, cmax)
            for k0 in range(0, length, bk):
                kt, vt = _rows(k[bi], k0, bk, cmax), _rows(v[bi], k0, bk, cmax)
                key_ok = torch.arange(k0, k0 + bk) < length
                dst = torch.zeros(bq, bk)
                for w in range(THREADS // 32):   # phase 1: S, dP of a warp's keys
                    g, h = w % groups, w // groups
                    qr, kc = slice(16 * g, 16 * g + 16), slice(h * sw, h * sw + sw)
                    _, ds = _p_and_ds(qt[qr] @ kt[kc].T, dot[qr] @ vt[kc].T, m[qr, None],
                                      il[qr, None], dis[qr, None],
                                      q_ok[qr, None] & key_ok[None, kc], scale)
                    dst[qr, kc] = ds.to(dt).float()
                for w in range(THREADS // 32):   # phase 2: a warp's output columns
                    g, h = w % groups, w // groups
                    qr, cols = slice(16 * g, 16 * g + 16), slice(h * oc, h * oc + oc)
                    acc[qr, cols] += dst[qr] @ kt[:, cols]
            n = min(bq, length - q0)
            dq[bi, q0:q0 + n] = acc[:n, :c].to(dt)
    return dq


def _inputs(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
                   for _ in range(4))
    q = (2.0 * q.float()).to(dtype)   # scores ~ N(0, 4): a peaked softmax
    scale = float(shape[-1]) ** -0.5
    stats = row_stats_plain(q, k, scale)
    di = attn_di(flash_attn_plain(q, k, v, scale), do)
    return q, k, v, do, stats, di, scale


def _check_rel(got, want, tol):
    assert got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert scale > 0 and err <= tol * scale, f"max abs err {err:.3g} > {tol} x {scale:.3g}"


# (B, L, C): every head-dim class at a length that fills whole tiles, a
# ragged one and one past several tiles; then C not a class (columns past
# C in every tile) and C not a multiple of 8 (the 8-byte copies).
BWD_CASES = ([(2, 64, c) for c in (64, 128, 256, 512)]
             + [(2, 77, c) for c in (64, 128, 256, 512)]
             + [(1, 1000, c) for c in (64, 128, 256, 512)]
             + [(2, 77, 132), (1, 70, 8)])


@pytest.mark.parametrize("tag,dtype", [("fp32", torch.float32), ("bf16", torch.bfloat16)])
@pytest.mark.parametrize("shape", BWD_CASES)
def test_bwd_emulation_matches_plain(shape, tag, dtype):
    """fp32: only the order of the fp32 sums differs.  bf16: p and ds are
    rounded at the same points as the plain version's, so an entry near a
    rounding boundary may land one ulp apart (chip_smoke FLASH_BWD_TOL)."""
    q, k, v, do, stats, di, scale = _inputs(shape, sum(shape), dtype)
    dq, dk, dv = _bwd_plain(q, k, v, do, stats, di, scale)
    got_k, got_v = dkv_emulate(q, k, v, do, stats, di, scale)
    _check_rel(got_k, dk, FLASH_BWD_TOL[tag])
    _check_rel(got_v, dv, FLASH_BWD_TOL[tag])
    _check_rel(dq_emulate(q, k, v, do, stats, di, scale), dq, FLASH_BWD_TOL[tag])


def test_bwd_emulation_matches_the_jax_reference_gradients():
    """The stock Pallas module's own reference, differentiated by JAX (its
    backward takes sm_scale = 1 only, so q is scaled before the call)."""
    q, k, v, do, stats, di, scale = _inputs((2, 77, 64), 5, torch.float32)
    as_jax = [jnp.asarray(t.numpy())[:, None] for t in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b, c: mha_reference(a * scale, b, c, None), *as_jax)
    ref_q, ref_k, ref_v = (torch.from_numpy(np.array(g)[:, 0])
                           for g in vjp(jnp.asarray(do.numpy())[:, None]))
    got_k, got_v = dkv_emulate(q, k, v, do, stats, di, scale)
    for got, want in ((dq_emulate(q, k, v, do, stats, di, scale), ref_q), (got_k, ref_k),
                      (got_v, ref_v)):
        _check_rel(got, want, FLASH_BWD_TOL["fp32"])


def _owners(length: int, c: int) -> torch.Tensor:
    """How many (block, warp) pairs store each element of an (L, C) output
    (dk and dv of dkv, dq of dq: the same tiling)."""
    split, own, _, groups, _, oc = geometry(head_class(c))
    count = torch.zeros(length, c, dtype=torch.int32)
    for r0 in range(0, length, own):                 # blocks
        for w in range(THREADS // 32):
            g, h = w % groups, w // groups
            rows = slice(r0 + 16 * g, min(r0 + 16 * g + 16, length))
            cols = slice(h * oc, min(h * oc + oc, c))
            count[rows, cols] += 1
    return count


@pytest.mark.parametrize("length", [64, 77, 1000])
@pytest.mark.parametrize("c", [8, 64, 132, 256, 512])
def test_every_output_element_has_one_owner(length, c):
    """One block and one warp store each element of dk, dv and dq: no
    atomics, no element stored twice or left out."""
    assert bool((_owners(length, c) == 1).all())


def dkv_smem_bytes(cmax: int) -> int:
    """``tcbwd::Tile::DKV_SMEM``: K, V; two stages of Q, dO and m, l, di;
    P^T, dS^T."""
    _, own, step, *_ = geometry(cmax)
    ld, ldp = cmax + PAD, step + PAD
    return 2 * 2 * own * ld + 2 * (2 * 2 * step * ld + 3 * 4 * step) + 2 * 2 * own * ldp


def dq_smem_bytes(cmax: int) -> int:
    """``tcbwd::Tile::DQ_SMEM``: Q, dO; two stages of K, V; dS."""
    _, own, step, *_ = geometry(cmax)
    ld, ldp = cmax + PAD, step + PAD
    return 2 * 2 * own * ld + 2 * 2 * 2 * step * ld + 2 * own * ldp


@pytest.mark.parametrize("cmax", [64, 128, 256, 512])
def test_tiles_fit_an_h100_block(cmax):
    """Eight warps; shared memory within the 227 KB a block may use; the
    fp32 accumulators at most 128 registers a thread (dkv: a 16 x OC block
    of dK and of dV, dq: of dQ, over a warp's 32 lanes); phase-1 rows in
    whole n-tiles of 8 and output columns in pairs of them."""
    assert dkv_smem_bytes(cmax) <= SMEM_LIMIT and dq_smem_bytes(cmax) <= SMEM_LIMIT
    split, own, step, groups, sw, oc = geometry(cmax)
    assert groups * split * 32 == THREADS
    assert own % 16 == 0 and sw % 8 == 0 and oc % 16 == 0
    assert 2 * 16 * oc // 32 <= 128   # dkv's two accumulators; dq's one is half


def test_tile_constants_follow_the_design():
    """The path's head dim (256) in 64 x 64 tiles and two warps a group,
    each holding 128 columns; C = 512 in four warps a group."""
    assert CLASSES == [64, 128, 256, 512]
    assert TILES[256] == (2, 64, 64)
    assert geometry(512)[5] == 128
    assert dkv_smem_bytes(256) == 222720 and dq_smem_bytes(256) == 211968
