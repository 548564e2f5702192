// Single-head attention backward: kernels K3 bwd dkv and K3 bwd dq.
//
// Replace the backward of the stock Pallas TPU flash attention that the
// JAX package differentiates in AttnBlockpp under the "flash" lowering
// (mudiff_tpu/nn/blocks.py:206-214; jax/experimental/pallas/ops/tpu/
// flash_attention.py _flash_attention_bwd, which runs two pallas_calls):
//   mudiff_flash_attn_bwd_dkv <- _flash_attention_bwd_dkv (kernel
//                                _flash_attention_dkv_kernel)
//   mudiff_flash_attn_bwd_dq  <- _flash_attention_bwd_dq (kernel
//                                _flash_attention_dq_kernel)
//
// Same function, per batch row, from the forward's row statistics m and
// l (flash_attn_kernel.cu) and di = rowsum(o * do) in fp32 (computed by
// the caller, as the JAX package computes it outside Pallas):
//   s  = q.k^T in fp32 from the input dtype, times scale
//   p  = exp(s - m) * (1 / l)                             fp32
//   dv = sum_q round(p)^T do                              fp32 accumulator
//   dp = do.v^T                                           fp32
//   ds = (dp - di) * p * scale,  rounded to the input dtype
//   dk = sum_q ds^T q,  dq = sum_k ds k                   fp32 accumulators
// "round" is to the input dtype, where the TPU kernel casts p and ds to
// do.dtype / k.dtype before its products.  Outputs are rounded once to the
// input dtype.  Non-causal, one head, no mask, bias or segment ids.  All
// of q, k, v, do, dq, dk, dv are (B, L, C) contiguous; m, l, di (B, L).
//
// What bounds it on an H100: operations.  dkv does four of the five
// products (s, dp, dv, dk), 8 B L^2 C flops, dq three (s, dp, dq), 6 B
// L^2 C, on about 7 B L C elements; at L = 4096 that is far above the
// card's ridge.  The bound is those flops over the tensor cores' 989
// TFLOP/s in bf16 / fp16, over 67 TFLOP/s in fp32.
//
// As on the TPU, two kernels, so that every output element has one owner:
// no atomics, and the same inputs give the same bits on every run.  Each
// has three versions; the wrapper (ops/flash_attn.py k3_path) picks one
// before any launch, from the head dim and dtype:
//
// * "wgmma", bf16 / fp16 at C = 256 (the recipe's head dim, nf = 64):
//   flash_attn_bwd_{dkv,dq}_kernel_wgmma, entry points
//   mudiff_flash_attn_bwd_{dkv,dq}_wgmma (namespace wgmma below), on
//   Hopper's warpgroup MMA fed by TMA (3-D tensor maps over (C, L, B),
//   64-channel boxes, the 128-byte swizzle, zero fill past L).  dkv: a
//   block owns 64 keys (K, V resident) and walks the query steps through a
//   two-stage ring of Q / dO tiles with their m, 1/l, di; warpgroup 0
//   computes S^T = K Q^T, P^T in fp32 and dV += round(P^T) dO, and hands
//   the fp32 P^T to warpgroup 1 through shared memory (named barriers),
//   which computes dP^T = V dO^T, dS^T and dK += round(dS^T) Q.  The two
//   accumulators (dK, dV: 256 fp32 registers a thread in one warpgroup)
//   are split between the warpgroups.  dq: a block owns 64 queries (Q, dO
//   resident) in one consumer warpgroup beside a producer warpgroup that
//   streams K / V tile pairs; S and dP as two commit groups of SS
//   m64n64k16, p formed while dP's products run, dQ += round(dS) K as RS
//   m64n256k16 with K read MN-major.  Scores are SS products on K-major
//   descriptors, the m64n256 products read their B MN-major: no transposed
//   copy of any operand.
//
// * "general", bf16 / fp16 at other head dims (C = 512 at nf = 128):
//   flash_attn_bwd_{dkv,dq}_kernel_tc, FlashAttention-2's backward on the
//   tensor cores.  Every product is mma.sync.m16n8k16 on
//   ldmatrix fragments: 16-bit operands, fp32 sums.  Operands stay 16-bit
//   in shared memory, copied in by cp.async (zero-filled past L and past
//   C).  A block of 8 warps owns OWN rows of one side, in row groups of
//   16, and walks over the other side in tiles of STEP rows through a
//   2-stage cp.async ring: the next tile's copy overlaps this tile's
//   products.  SPLIT warps share a row group, in two phases a tile:
//     1. each warp scores STEP / SPLIT of the tile's rows against its
//        group's 16 over all of C (s and dp in fp32 accumulators), forms
//        p and ds in registers, rounds both and writes them to shared
//        memory; a named barrier per group follows;
//     2. each warp adds the group's products over the whole tile into its
//        CMAX / SPLIT output columns.
//   dkv owns BK keys (K, V stay in shared memory) and steps over queries
//   (Q, dO and their m, l, di come through the ring): phase 1 writes P^T
//   and dS^T, phase 2 adds dV += P^T dO and dK += dS^T Q.  dq owns BQ
//   queries (Q, dO in shared memory, each thread's m, 1/l and di in
//   registers) and steps over keys: phase 1 writes dS, phase 2 adds dQ +=
//   dS K.  Within a kernel no score is computed twice; as on the TPU, dq
//   computes s and dp again.  Tiles (Shape) per head-dim class
//   (CMAX 64 / 128 / 256 / 512, columns past C zero): up to 256, 64 x 64
//   tiles and two warps a group, so at C = 256 (the path's head dim, nf =
//   64) a dkv warp holds a 16 x 128 block of both dK and dV (128 fp32
//   registers a thread), in 222,720 bytes of shared memory (dq: 211,968).
//   C = 512 (nf = 128): four warps a group, 128 columns each, and 32 x 32
//   tiles so that the block fits (205,568 and 202,240 bytes).
//   What still holds it back: mma.sync is not the card's full tensor-core
//   rate (wgmma is); phase 1 loads as many ldmatrix bytes as it feeds the
//   mma, and at C = 512 more; one block of 8 warps an SM leaves little to
//   hide latency with; outputs are stored 4 bytes a thread.
//
// * "fma", fp32: flash_attn_bwd_{dkv,dq}_kernel_fma, on the CUDA cores in
//   fp32 FMA (TF32 would miss the fp32 tolerance).  dkv: one block of 256
//   threads owns BK keys of one batch row; K and V of those keys stay in
//   shared memory (fp32) and the block walks over all queries in tiles of
//   BQ.  Per tile: load Q and dO and the rows' m, 1/l and di; (1) each
//   thread computes whole entries of S and dP (a length-C dot product
//   each) and writes p and ds to shared memory; (2) each thread owns a
//   RPT x CPT patch of both the dK and dV accumulators in registers and
//   adds ds^T q and p^T do.  dq: one block owns BQ queries; Q, dO and the
//   row statistics stay in shared memory and the block walks over all
//   keys in tiles of BK with the same two phases (the dq patch adds ds k).
//   Tiles per head-dim class keep the accumulators at 64 registers a
//   thread or fewer and shared memory under 227 KB.
//
// Ragged lengths: keys and queries past L load as zero rows and get p =
// ds = 0, so they add nothing, and their rows are not stored; columns
// past C are zero in shared memory and not stored.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_wgmma.cuh"
#include "tensor_core.cuh"

namespace {

// ---------------------------------------------------------------- fp32 FMA

namespace ffma {

constexpr int THREADS = 256;
constexpr int PAD = 4;     // floats of padding per shared-memory row
constexpr int NCG = 16;    // threads along C in an accumulator patch
constexpr int ROWG = THREADS / NCG;  // rows of an accumulator pass

// Tiles per head-dim class: dkv owns BK keys and steps over BQ queries;
// dq owns BQ queries and steps over BK keys.
template <int CMAX> struct DkvTile;
template <> struct DkvTile<512> { static constexpr int BK = 16, BQ = 16; };
template <> struct DkvTile<256> { static constexpr int BK = 32, BQ = 32; };
template <> struct DkvTile<128> { static constexpr int BK = 64, BQ = 32; };
template <> struct DkvTile<64> { static constexpr int BK = 64, BQ = 64; };
template <int CMAX> struct DqTile;
template <> struct DqTile<512> { static constexpr int BQ = 32, BK = 16; };
template <> struct DqTile<256> { static constexpr int BQ = 64, BK = 32; };
template <> struct DqTile<128> { static constexpr int BQ = 64, BK = 64; };
template <> struct DqTile<64> { static constexpr int BQ = 64, BK = 64; };

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// rows [row0, row0 + rows) of an (L, C) matrix into dst (row stride LD);
// rows past L are zeros.  C % 4 == 0.
template <int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int rows, int L, int C) {
  const int c4 = C >> 2;
  for (int i = threadIdx.x; i < rows * c4; i += THREADS) {
    const int r = i / c4;
    const int cc = (i - r * c4) << 2;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < L) val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * C + cc);
    *reinterpret_cast<float4*>(dst + r * LD + cc) = val;
  }
}

// m, 1/l and di of query rows [q0, q0 + rows) into shared memory; rows
// past L get zeros (their p is masked to 0).
__device__ __forceinline__ void load_stats(float* ms, float* ils, float* dis,
                                           const float* __restrict__ m,
                                           const float* __restrict__ l,
                                           const float* __restrict__ di, int q0, int rows,
                                           int L) {
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    const bool in = q0 + i < L;
    ms[i] = in ? m[q0 + i] : 0.f;
    ils[i] = in ? 1.f / l[q0 + i] : 0.f;
    dis[i] = in ? di[q0 + i] : 0.f;
  }
}

// Phase 1 of both kernels: for every (query r, key j) of the tile, s and
// dp as length-C dot products in fp32 (the forward's order of sums), then
// p and ds into ps / dss (row stride LDP).  Entries outside [0, L) on either side get p = ds = 0.
template <int LD, int LDP, int BQ, int BK, bool WRITE_P>
__device__ __forceinline__ void probs_and_ds(const float* qs, const float* dos,
                                             const float* ks, const float* vs,
                                             const float* ms, const float* ils,
                                             const float* dis, float* ps, float* dss,
                                             int q0, int k0, int L, int C, float scale) {
  for (int e = threadIdx.x; e < BQ * BK; e += THREADS) {
    const int r = e / BK;
    const int j = e - r * BK;
    const float* qr = qs + r * LD;
    const float* dor = dos + r * LD;
    const float* kj = ks + j * LD;
    const float* vj = vs + j * LD;
    float s = 0.f, dp = 0.f;
    for (int c = 0; c < C; c += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + c);
      const float4 kv = *reinterpret_cast<const float4*>(kj + c);
      const float4 dv = *reinterpret_cast<const float4*>(dor + c);
      const float4 vv = *reinterpret_cast<const float4*>(vj + c);
      s = fmaf(qv.x, kv.x, s);
      s = fmaf(qv.y, kv.y, s);
      s = fmaf(qv.z, kv.z, s);
      s = fmaf(qv.w, kv.w, s);
      dp = fmaf(dv.x, vv.x, dp);
      dp = fmaf(dv.y, vv.y, dp);
      dp = fmaf(dv.z, vv.z, dp);
      dp = fmaf(dv.w, vv.w, dp);
    }
    float p = 0.f, ds = 0.f;
    if (q0 + r < L && k0 + j < L) {
      p = expf(s * scale - ms[r]) * ils[r];
      ds = (dp - dis[r]) * p * scale;
    }
    if (WRITE_P) ps[r * LDP + j] = p;
    dss[r * LDP + j] = ds;
  }
}

template <int CMAX>
constexpr size_t dkv_smem_floats() {
  constexpr int BK = DkvTile<CMAX>::BK, BQ = DkvTile<CMAX>::BQ;
  return 2 * (size_t)BK * (CMAX + PAD) + 2 * (size_t)BQ * (CMAX + PAD) +
         2 * (size_t)BQ * (BK + 1) + 3 * (size_t)BQ;
}

template <int CMAX>
__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dkv_kernel_fma(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ m, const float* __restrict__ l,
                              const float* __restrict__ di, float* __restrict__ dk,
                              float* __restrict__ dv, int L, int C, float scale) {
  constexpr int BK = DkvTile<CMAX>::BK;
  constexpr int BQ = DkvTile<CMAX>::BQ;
  constexpr int LD = CMAX + PAD;
  constexpr int LDP = BK + 1;
  constexpr int RPT = BK / ROWG;   // key rows per thread
  constexpr int CPT = CMAX / NCG;  // columns per thread
  constexpr int NG = CPT / 4;
  static_assert(RPT >= 1 && BK % ROWG == 0, "accumulator patches tile the keys");

  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [BK][LD]
  float* vs = ks + BK * LD;         // [BK][LD]
  float* qs = vs + BK * LD;         // [BQ][LD]
  float* dos = qs + BQ * LD;        // [BQ][LD]
  float* ps = dos + BQ * LD;        // [BQ][LDP]
  float* dss = ps + BQ * LDP;       // [BQ][LDP]
  float* ms = dss + BQ * LDP;       // [BQ]
  float* ils = ms + BQ;             // [BQ]
  float* dis = ils + BQ;            // [BQ]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const size_t base = (size_t)blockIdx.y * L * C;
  const size_t sbase = (size_t)blockIdx.y * L;

  // columns past C are never loaded: zero all four tiles once
  for (int i = tid; i < 2 * (BK + BQ) * LD; i += THREADS) smem[i] = 0.f;
  __syncthreads();
  load_tile<LD>(ks, k + base, k0, BK, L, C);
  load_tile<LD>(vs, v + base, k0, BK, L, C);

  const int cg = tid % NCG;  // patch: columns g * NCG * 4 + cg * 4 + e
  const int jg = tid / NCG;  //        key rows jg + ROWG * i
  float acc_k[RPT][CPT], acc_v[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BQ) {
    __syncthreads();  // the previous tile's accumulation is done
    load_tile<LD>(qs, q + base, q0, BQ, L, C);
    load_tile<LD>(dos, dout + base, q0, BQ, L, C);
    load_stats(ms, ils, dis, m + sbase, l + sbase, di + sbase, q0, BQ, L);
    __syncthreads();
    probs_and_ds<LD, LDP, BQ, BK, true>(qs, dos, ks, vs, ms, ils, dis, ps, dss, q0, k0,
                                           L, C, scale);
    __syncthreads();
    for (int r = 0; r < BQ; ++r) {
      float pv[RPT], dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = ps[r * LDP + jg + ROWG * i];
        dsv[i] = dss[r * LDP + jg + ROWG * i];
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int col = g * NCG * 4 + cg * 4;
        const float4 dov = *reinterpret_cast<const float4*>(&dos[r * LD + col]);
        const float4 qv = *reinterpret_cast<const float4*>(&qs[r * LD + col]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc_v[i][g * 4 + 0] = fmaf(pv[i], dov.x, acc_v[i][g * 4 + 0]);
          acc_v[i][g * 4 + 1] = fmaf(pv[i], dov.y, acc_v[i][g * 4 + 1]);
          acc_v[i][g * 4 + 2] = fmaf(pv[i], dov.z, acc_v[i][g * 4 + 2]);
          acc_v[i][g * 4 + 3] = fmaf(pv[i], dov.w, acc_v[i][g * 4 + 3]);
          acc_k[i][g * 4 + 0] = fmaf(dsv[i], qv.x, acc_k[i][g * 4 + 0]);
          acc_k[i][g * 4 + 1] = fmaf(dsv[i], qv.y, acc_k[i][g * 4 + 1]);
          acc_k[i][g * 4 + 2] = fmaf(dsv[i], qv.z, acc_k[i][g * 4 + 2]);
          acc_k[i][g * 4 + 3] = fmaf(dsv[i], qv.w, acc_k[i][g * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + jg + ROWG * i;
    if (row >= L) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = g * NCG * 4 + cg * 4;
      if (col >= C) continue;
      store4(dk + base + (size_t)row * C + col, acc_k[i][g * 4 + 0], acc_k[i][g * 4 + 1],
             acc_k[i][g * 4 + 2], acc_k[i][g * 4 + 3]);
      store4(dv + base + (size_t)row * C + col, acc_v[i][g * 4 + 0], acc_v[i][g * 4 + 1],
             acc_v[i][g * 4 + 2], acc_v[i][g * 4 + 3]);
    }
  }
}

template <int CMAX>
constexpr size_t dq_smem_floats() {
  constexpr int BK = DqTile<CMAX>::BK, BQ = DqTile<CMAX>::BQ;
  return 2 * (size_t)BQ * (CMAX + PAD) + 2 * (size_t)BK * (CMAX + PAD) +
         (size_t)BQ * (BK + 1) + 3 * (size_t)BQ;
}

template <int CMAX>
__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dq_kernel_fma(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ m, const float* __restrict__ l,
                             const float* __restrict__ di, float* __restrict__ dq, int L,
                             int C, float scale) {
  constexpr int BK = DqTile<CMAX>::BK;
  constexpr int BQ = DqTile<CMAX>::BQ;
  constexpr int LD = CMAX + PAD;
  constexpr int LDP = BK + 1;
  constexpr int RPT = BQ / ROWG;   // query rows per thread
  constexpr int CPT = CMAX / NCG;
  constexpr int NG = CPT / 4;
  static_assert(RPT >= 1 && BQ % ROWG == 0, "accumulator patches tile the queries");

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [BQ][LD]
  float* dos = qs + BQ * LD;        // [BQ][LD]
  float* ks = dos + BQ * LD;        // [BK][LD]
  float* vs = ks + BK * LD;         // [BK][LD]
  float* dss = vs + BK * LD;        // [BQ][LDP]
  float* ms = dss + BQ * LDP;       // [BQ]
  float* ils = ms + BQ;             // [BQ]
  float* dis = ils + BQ;            // [BQ]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * L * C;
  const size_t sbase = (size_t)blockIdx.y * L;

  for (int i = tid; i < 2 * (BK + BQ) * LD; i += THREADS) smem[i] = 0.f;
  __syncthreads();
  load_tile<LD>(qs, q + base, q0, BQ, L, C);
  load_tile<LD>(dos, dout + base, q0, BQ, L, C);
  load_stats(ms, ils, dis, m + sbase, l + sbase, di + sbase, q0, BQ, L);

  const int cg = tid % NCG;  // patch: columns g * NCG * 4 + cg * 4 + e
  const int rg = tid / NCG;  //        query rows rg + ROWG * i
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile's accumulation is done with K and ds
    load_tile<LD>(ks, k + base, k0, BK, L, C);
    load_tile<LD>(vs, v + base, k0, BK, L, C);
    __syncthreads();
    probs_and_ds<LD, LDP, BQ, BK, false>(qs, dos, ks, vs, ms, ils, dis, nullptr, dss, q0,
                                            k0, L, C, scale);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = dss[(rg + ROWG * i) * LDP + j];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&ks[j * LD + g * NCG * 4 + cg * 4]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][g * 4 + 0] = fmaf(dsv[i], kv.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(dsv[i], kv.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(dsv[i], kv.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(dsv[i], kv.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg + ROWG * i;
    if (row >= L) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = g * NCG * 4 + cg * 4;
      if (col < C)
        store4(dq + base + (size_t)row * C + col, acc[i][g * 4 + 0], acc[i][g * 4 + 1],
               acc[i][g * 4 + 2], acc[i][g * 4 + 3]);
    }
  }
}

}  // namespace ffma

// ------------------------------------------------------ bf16/fp16 tensor cores

namespace tcbwd {

constexpr int PAD = 8;      // 16-bit elements of padding per shared row
constexpr int THREADS = 256;

// Tiles per head-dim class, the same for both kernels.  A block owns OWN
// rows of one side (dkv: keys, dq: queries), in row groups of 16, and
// steps over the other side in tiles of STEP rows.  SPLIT warps share a
// row group: in phase 1 they split the tile's STEP rows, in phase 2 the
// output's CMAX columns.
template <int CMAX> struct Shape;
template <> struct Shape<64> { static constexpr int SPLIT = 2, OWN = 64, STEP = 64; };
template <> struct Shape<128> { static constexpr int SPLIT = 2, OWN = 64, STEP = 64; };
template <> struct Shape<256> { static constexpr int SPLIT = 2, OWN = 64, STEP = 64; };
template <> struct Shape<512> { static constexpr int SPLIT = 4, OWN = 32, STEP = 32; };

template <int CMAX>
struct Tile : Shape<CMAX> {
  using S = Shape<CMAX>;
  static constexpr int GROUPS = S::OWN / 16;
  static constexpr int SW = S::STEP / S::SPLIT;  // tile rows a warp scores in phase 1
  static constexpr int OC = CMAX / S::SPLIT;     // output columns a warp owns
  static constexpr int LD = CMAX + PAD;          // Q / dO / K / V row
  static constexpr int LDP = S::STEP + PAD;      // P / dS row
  // dkv: K, V [OWN][LD]; two stages of (Q, dO [STEP][LD]; m, l, di [STEP]
  // fp32); P^T, dS^T [OWN][LDP].  dq: Q, dO [OWN][LD]; two stages of K, V
  // [STEP][LD]; dS [OWN][LDP].
  static constexpr size_t DKV_STAGE = 2 * 2 * (size_t)S::STEP * LD + 3 * 4 * (size_t)S::STEP;
  static constexpr size_t DKV_SMEM =
      2 * 2 * (size_t)S::OWN * LD + 2 * DKV_STAGE + 2 * 2 * (size_t)S::OWN * LDP;
  static constexpr size_t DQ_SMEM = 2 * 2 * (size_t)S::OWN * LD +
                                    2 * 2 * 2 * (size_t)S::STEP * LD + 2 * (size_t)S::OWN * LDP;
  static_assert(GROUPS * S::SPLIT * 32 == THREADS, "eight warps");
  static_assert(SW % 8 == 0 && OC % 16 == 0 && CMAX % 32 == 0 && S::STEP % 16 == 0,
                "warp tile");
  static_assert(DKV_SMEM <= 232448 && DQ_SMEM <= 232448,
                "tile exceeds the 227 KB a block may use");
};

// The phase-1 product of a warp: acc[n] (16 x 8 each, n < NT) += A . B^T
// over CMAX, A the 16 rows at `a` and B the NT x 8 rows at `b` (both
// row-major, stride LD, k along the row).  B's fragments come as one
// 8-row x 32-column ldmatrix.x4 a tile, covering two k steps.
template <typename T, int CMAX, int LD, int NT>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[NT][4], const T* a, const T* b,
                                              int lane) {
  const T* ap = a + (lane & 15) * LD + (lane >> 4) * 8;
  const T* bp = b + (lane & 7) * LD + (lane >> 3) * 8;
#pragma unroll 2
  for (int kk = 0; kk < CMAX; kk += 32) {
    uint32_t a0[4], a1[4];
    tc::ldsm_x4(a0, ap + kk);
    tc::ldsm_x4(a1, ap + kk + 16);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bf[4];
      tc::ldsm_x4(bf, bp + n * 8 * LD + kk);
      tc::mma16816<T>(acc[n], a0, bf[0], bf[1]);
      tc::mma16816<T>(acc[n], a1, bf[2], bf[3]);
    }
  }
}

// The phase-2 product of a warp: acc[n] (16 x 8 each, n < NO) += A . B
// over STEP, A the 16 x STEP 16-bit matrix at `a` (stride LDA) and B the
// STEP x (8 NO) matrix at `b` (stride LD, n along the row).
template <typename T, int STEP, int LDA, int LD, int NO>
__device__ __forceinline__ void rows_times_tile(float (&acc)[NO][4], const T* a, const T* b,
                                                int lane) {
  const T* ap = a + (lane & 15) * LDA + (lane >> 4) * 8;
  const T* bp = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < STEP; kk += 16) {
    uint32_t af[4];
    tc::ldsm_x4(af, ap + kk);
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      uint32_t bf[4];
      tc::ldsm_x4_t(bf, bp + kk * LD + n * 8);
      tc::mma16816<T>(acc[n], af, bf[0], bf[1]);
      tc::mma16816<T>(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

// A warp's 16 x (8 NT) fragment tile, rounded to T, into the 16 rows at
// dst (stride LDP).
template <typename T, int LDP, int NT>
__device__ __forceinline__ void store_frag(T* dst, const float (&f)[NT][4], int lane) {
  T* row = dst + (lane >> 2) * LDP + (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(row + n * 8) = tc::pack2<T>(f[n][0], f[n][1]);
    *reinterpret_cast<uint32_t*>(row + 8 * LDP + n * 8) = tc::pack2<T>(f[n][2], f[n][3]);
  }
}

// A warp's 16 x (8 NO) accumulator, rounded to T, into rows row0 (+ lane
// / 4, + 8) and columns col0 of an (L, C) matrix; rows past L and
// columns past C are not stored.
template <typename T, int NO>
__device__ __forceinline__ void store_out(T* out, const float (&f)[NO][4], int row0, int col0,
                                          int L, int C, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + (lane >> 2) + 8 * h;
    if (row >= L) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = col0 + n * 8 + (lane & 3) * 2;
      if (col < C)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * C + col) =
            tc::pack2<T>(f[n][2 * h], f[n][2 * h + 1]);
    }
  }
}

template <typename T, int CMAX>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bwd_dkv_kernel_tc(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ m, const float* __restrict__ l,
                             const float* __restrict__ di, T* __restrict__ dk,
                             T* __restrict__ dv, int L, int C, float scale) {
  using TL = Tile<CMAX>;
  constexpr int BK = TL::OWN, BQ = TL::STEP;
  constexpr int GROUPS = TL::GROUPS, LD = TL::LD, LDP = TL::LDP;
  constexpr int SW = TL::SW, OC = TL::OC;
  constexpr int NT = SW / 8;   // phase-1 n-tiles of a warp (queries)
  constexpr int NO = OC / 8;   // output n-tiles of a warp (columns)
  constexpr size_t STAGE = TL::DKV_STAGE;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [BK][LD]
  T* vs = ks + BK * LD;                    // [BK][LD]
  unsigned char* stages = reinterpret_cast<unsigned char*>(vs + BK * LD);
  T* ps = reinterpret_cast<T*>(stages + 2 * STAGE);  // P^T  [BK][LDP]
  T* dss = ps + BK * LDP;                            // dS^T [BK][LDP]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = warp % GROUPS;   // row group: keys 16g .. 16g + 15 of the block
  const int h = warp / GROUPS;   // split index: queries SW h.., columns OC h..
  const int k0 = blockIdx.x * BK;
  const size_t base = (size_t)blockIdx.y * L * C;
  const size_t sbase = (size_t)blockIdx.y * L;
  const bool vec16 = C % 8 == 0;
  const int tiles = (L + BQ - 1) / BQ;

  // Q, dO rows [q0, q0 + BQ) and their m, l, di into stage st
  auto load_tile = [&](int st, int q0) {
    T* qs = reinterpret_cast<T*>(stages + st * STAGE);
    float* st_f = reinterpret_cast<float*>(qs + 2 * BQ * LD);
    tc::load_rows<T, CMAX, LD, BQ, THREADS>(qs, q + base, q0, L, C, vec16);
    tc::load_rows<T, CMAX, LD, BQ, THREADS>(qs + BQ * LD, dout + base, q0, L, C, vec16);
    for (int i = threadIdx.x; i < 3 * BQ; i += THREADS) {
      const int which = i / BQ, r = i % BQ;
      const float* src = which == 0 ? m : which == 1 ? l : di;
      const bool valid = q0 + r < L;
      tc::cp_async4(st_f + i, valid ? src + sbase + q0 + r : src, valid);
    }
  };

  tc::load_rows<T, CMAX, LD, BK, THREADS>(ks, k + base, k0, L, C, vec16);
  tc::load_rows<T, CMAX, LD, BK, THREADS>(vs, v + base, k0, L, C, vec16);
  load_tile(0, 0);
  tc::cp_async_commit();

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  // this thread's keys in phase 1: rows lane / 4 and lane / 4 + 8 of the group
  const bool key_ok[2] = {k0 + g * 16 + (lane >> 2) < L, k0 + g * 16 + (lane >> 2) + 8 < L};

  for (int t = 0; t < tiles; ++t) {
    const int q0 = t * BQ;
    tc::cp_async_wait<0>();   // tile t landed
    __syncthreads();          // ... for all; every warp is done with tile t - 1
    if (t + 1 < tiles) load_tile((t + 1) & 1, q0 + BQ);
    tc::cp_async_commit();

    const T* qs = reinterpret_cast<const T*>(stages + (t & 1) * STAGE);
    const T* dos = qs + BQ * LD;
    const float* ms = reinterpret_cast<const float*>(dos + BQ * LD);
    const float* ls = ms + BQ;
    const float* dis = ls + BQ;

    // phase 1: S^T = K Q^T and dP^T = V dO^T, this warp's SW queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    rows_dot_rows<T, CMAX, LD, NT>(s, ks + g * 16 * LD, qs + h * SW * LD, lane);
    rows_dot_rows<T, CMAX, LD, NT>(dp, vs + g * 16 * LD, dos + h * SW * LD, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = h * SW + n * 8 + (lane & 3) * 2 + e;
        const bool q_ok = q0 + qi < L;
        const float mq = ms[qi], il = q_ok ? 1.f / ls[qi] : 0.f, dq = dis[qi];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 2 * r + e;
          const float p = q_ok && key_ok[r] ? expf(s[n][x] * scale - mq) * il : 0.f;
          dp[n][x] = (dp[n][x] - dq) * p * scale;
          s[n][x] = p;
        }
      }
    store_frag<T, LDP, NT>(ps + g * 16 * LDP + h * SW, s, lane);
    store_frag<T, LDP, NT>(dss + g * 16 * LDP + h * SW, dp, lane);
    tc::group_sync<TL::SPLIT>(g);

    // phase 2: dV += P^T dO and dK += dS^T Q, this warp's OC columns
    rows_times_tile<T, BQ, LDP, LD, NO>(acc_v, ps + g * 16 * LDP, dos + h * OC, lane);
    rows_times_tile<T, BQ, LDP, LD, NO>(acc_k, dss + g * 16 * LDP, qs + h * OC, lane);
  }

  store_out<T, NO>(dk + base, acc_k, k0 + g * 16, h * OC, L, C, lane);
  store_out<T, NO>(dv + base, acc_v, k0 + g * 16, h * OC, L, C, lane);
}

template <typename T, int CMAX>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bwd_dq_kernel_tc(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ m, const float* __restrict__ l,
                            const float* __restrict__ di, T* __restrict__ dq, int L, int C,
                            float scale) {
  using TL = Tile<CMAX>;
  constexpr int BQ = TL::OWN, BK = TL::STEP;
  constexpr int GROUPS = TL::GROUPS, LD = TL::LD, LDP = TL::LDP;
  constexpr int SW = TL::SW, OC = TL::OC;
  constexpr int NT = SW / 8;   // phase-1 n-tiles of a warp (keys)
  constexpr int NO = OC / 8;   // output n-tiles of a warp (columns)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* dos = qs + BQ * LD;                   // [BQ][LD]
  T* stages = dos + BQ * LD;               // two stages of K, V [BK][LD]
  T* dss = stages + 2 * 2 * BK * LD;       // dS [BQ][LDP]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = warp % GROUPS;   // row group: queries 16g .. 16g + 15 of the block
  const int h = warp / GROUPS;   // split index: keys SW h.., columns OC h..
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * L * C;
  const size_t sbase = (size_t)blockIdx.y * L;
  const bool vec16 = C % 8 == 0;
  const int tiles = (L + BK - 1) / BK;

  tc::load_rows<T, CMAX, LD, BQ, THREADS>(qs, q + base, q0, L, C, vec16);
  tc::load_rows<T, CMAX, LD, BQ, THREADS>(dos, dout + base, q0, L, C, vec16);
  tc::load_rows<T, CMAX, LD, BK, THREADS>(stages, k + base, 0, L, C, vec16);
  tc::load_rows<T, CMAX, LD, BK, THREADS>(stages + BK * LD, v + base, 0, L, C, vec16);
  tc::cp_async_commit();

  // this thread's queries: rows lane / 4 and lane / 4 + 8 of the group
  float mq[2], il[2], dq_i[2];
  bool q_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + g * 16 + (lane >> 2) + 8 * r;
    q_ok[r] = row < L;
    mq[r] = q_ok[r] ? m[sbase + row] : 0.f;
    il[r] = q_ok[r] ? 1.f / l[sbase + row] : 0.f;
    dq_i[r] = q_ok[r] ? di[sbase + row] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * BK;
    tc::cp_async_wait<0>();   // tile t (and Q, dO) landed
    __syncthreads();          // ... for all; every warp is done with tile t - 1
    if (t + 1 < tiles) {
      T* nk = stages + ((t + 1) & 1) * 2 * BK * LD;
      tc::load_rows<T, CMAX, LD, BK, THREADS>(nk, k + base, k0 + BK, L, C, vec16);
      tc::load_rows<T, CMAX, LD, BK, THREADS>(nk + BK * LD, v + base, k0 + BK, L, C, vec16);
    }
    tc::cp_async_commit();

    const T* ks = stages + (t & 1) * 2 * BK * LD;
    const T* vs = ks + BK * LD;

    // phase 1: S = Q K^T and dP = dO V^T, this warp's SW keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    rows_dot_rows<T, CMAX, LD, NT>(s, qs + g * 16 * LD, ks + h * SW * LD, lane);
    rows_dot_rows<T, CMAX, LD, NT>(dp, dos + g * 16 * LD, vs + h * SW * LD, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool k_ok = k0 + h * SW + n * 8 + (lane & 3) * 2 + e < L;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 2 * r + e;
          const float p = k_ok && q_ok[r] ? expf(s[n][x] * scale - mq[r]) * il[r] : 0.f;
          dp[n][x] = (dp[n][x] - dq_i[r]) * p * scale;
        }
      }
    store_frag<T, LDP, NT>(dss + g * 16 * LDP + h * SW, dp, lane);
    tc::group_sync<TL::SPLIT>(g);

    // phase 2: dQ += dS K, this warp's OC columns
    rows_times_tile<T, BK, LDP, LD, NO>(acc, dss + g * 16 * LDP, ks + h * OC, lane);
  }

  store_out<T, NO>(dq + base, acc, q0 + g * 16, h * OC, L, C, lane);
}

}  // namespace tcbwd

// ----------------------------------------- bf16/fp16 wgmma + TMA (Hopper)

namespace wgmma {

using namespace k3w;  // tiles, descriptors, the m64n64 / m64n256 products
using tc::mbar_arrive;
using tc::mbar_expect_tx;
using tc::mbar_init;

constexpr int OWN_ROWS = 64;          // keys a dkv block owns, queries a dq block owns
constexpr int STEP_ROWS = 64;         // queries (dkv) or keys (dq) a step of the walk
constexpr int DKV_THREADS = 256;      // WG 0: S^T, P^T, dV; WG 1: dP^T, dS^T, dK, and the loads
constexpr int DKV_STAGES = 2;         // Q / dO tiles, with their m, 1/l, di, in the ring
constexpr int STAT_THREADS = 64;      // WG 1's threads that stage a step's m, 1/l, di
constexpr int DQ_THREADS = 256;       // WG 0: S, dP, dS, dQ; WG 1: the producer (its thread 0)
constexpr int DQ_STAGES = 2;          // K / V tile pairs in the ring
constexpr int STAT_BYTES = 1024;      // m, 1/l, di of a step's 64 queries (768 bytes), padded
constexpr int P_BYTES = 16384;        // the fp32 P^T tile WG 0 hands WG 1 (64 x 64)
constexpr int P_FULL = 1;             // named barrier: P^T written (WG 0 arrives, WG 1 waits)
constexpr int P_EMPTY = 2;            // named barrier: P^T read (WG 1 arrives, WG 0 waits)
constexpr int SMEM_LIMIT = 232448;    // dynamic shared memory a block may use

constexpr int DKV_STAGE_BYTES = 2 * TILE_BYTES + STAT_BYTES;
// alignment slack, K and V, the ring, P^T, the barriers (kv, full, empty)
constexpr int DKV_SMEM = 1024 + 2 * TILE_BYTES + DKV_STAGES * DKV_STAGE_BYTES + P_BYTES +
                         (1 + 2 * DKV_STAGES) * 8;
// alignment slack, Q and dO, the ring, the barriers (q, full, empty)
constexpr int DQ_SMEM =
    1024 + 2 * TILE_BYTES + DQ_STAGES * 2 * TILE_BYTES + (1 + 2 * DQ_STAGES) * 8;
static_assert(OWN_ROWS == TILE_ROWS && STEP_ROWS == TILE_ROWS, "m64 tiles");
static_assert(DKV_SMEM <= SMEM_LIMIT && DQ_SMEM <= SMEM_LIMIT, "a block exceeds 227 KB");
static_assert(DKV_STAGE_BYTES % 1024 == 0 && 3 * STEP_ROWS * 4 <= STAT_BYTES, "stage layout");
static_assert(P_BYTES == OWN_ROWS * STEP_ROWS * 4, "one fp32 score tile");
static_assert(DKV_THREADS == 2 * WG_THREADS && DQ_THREADS == 2 * WG_THREADS, "roles");
static_assert(STAT_THREADS == STEP_ROWS, "one thread a query's statistics");
// Registers: an SM's four schedulers each hold a quarter of the register
// file, and a block's warps are dealt to them in turn, so a block of 9
// warps (two warpgroups and a producer warp) keeps 16384 / (3 x 32) = 168
// registers a thread, too few for dkv's 128 fp32 accumulators, 32 scores
// and 16 A registers beside their addresses (setmaxnreg does not raise
// what ptxas compiles for).  So dkv has no producer (its warpgroup 1
// issues the loads), and dq's producer is a whole warpgroup: 8 warps, two
// on each scheduler, keep up to 255 registers a thread.

struct Params {
  const float *m, *l, *di;  // (B, L) fp32
  void *d0, *d1;            // dkv: dk, dv; dq: dq
  int L;
  float scale;
};

// The accumulator (64 rows x 256 columns, fp32) rounded to T into rows
// row0 + acc_row of an (L, 256) matrix; rows past L are not stored.
template <typename T>
__device__ __forceinline__ void store_acc(T* out, const float (&acc)[128], int row0, int L,
                                          int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + acc_row(t, 2 * h);
    if (row >= L) continue;
    T* orow = out + (size_t)row * HEAD_DIM;
#pragma unroll
    for (int j = 0; j < HEAD_DIM / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + acc_col(t, 4 * j)) =
          tc::pack2<T>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// dK, dV of keys k0 .. k0 + 63 of batch row b.  K and V stay in shared
// memory; the query steps (Q, dO by TMA; m, 1/l, di staged by WG 1's first
// STAT_THREADS threads, zero past L) come through a DKV_STAGES ring.  Per
// step WG 0 computes S^T = K Q^T (SS m64n64k16), P^T = exp(s scale - m) /
// l in fp32, hands the fp32 P^T to WG 1 through shared memory (in its own
// fragment order: WG 1's dP^T accumulator has the same layout), rounds it
// into register A and adds dV += P^T dO (RS m64n256k16, dO MN-major);
// WG 1 computes dP^T = V dO^T, dS^T = (dP^T - di) P^T scale, rounds it and
// adds dK += dS^T Q.  WG 1, which takes P^T from WG 0 and so finishes a
// step after it, refills a slot once both have released it, while its
// next dP^T runs, and reads each step's statistics a step before it
// stages them.  Each output element has one owner and one summation
// order: no atomics.
template <typename T>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_attn_bwd_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const __grid_constant__ CUtensorMap domap, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = smem;
  unsigned char* vs = ks + TILE_BYTES;
  unsigned char* ring = vs + TILE_BYTES;  // DKV_STAGES of (Q, dO, statistics)
  float* pt = reinterpret_cast<float*>(ring + DKV_STAGES * DKV_STAGE_BYTES);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(pt + P_BYTES / 4);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + DKV_STAGES;

  const int b = blockIdx.y;
  const int k0 = blockIdx.x * OWN_ROWS;
  const int steps = (p.L + STEP_ROWS - 1) / STEP_ROWS;
  const int wg = threadIdx.x / WG_THREADS;
  const int t = threadIdx.x % WG_THREADS;
  const int lane = t & 31;
  const size_t sbase = (size_t)b * p.L;

  // WG 1's first STAT_THREADS threads read the statistics of query t of
  // step i (clamped past L) a step before they stage them
  float next_m = 0.f, next_l = 1.f, next_di = 0.f;
  auto fetch = [&](int i) {
    const int qi = i * STEP_ROWS + t;
    const size_t at = sbase + (qi < p.L ? qi : p.L - 1);
    next_m = p.m[at];
    next_l = p.l[at];
    next_di = p.di[at];
  };
  // step i into slot s: WG 1's thread 0 issues the TMA loads, its first
  // STAT_THREADS threads stage the fetched statistics (m, 1 / l, di, zero
  // past L); each of them arrives
  auto load_step = [&](int i, int s) {
    unsigned char* st = ring + s * DKV_STAGE_BYTES;
    if (t == 0) {
      mbar_expect_tx(&full[s], 2 * TILE_BYTES);
      for (int a = 0; a < ATOMS; ++a) {
        tc::tma_load_3d(st + a * ATOM_BYTES, &qmap, &full[s], a * ATOM_C, i * STEP_ROWS, b);
        tc::tma_load_3d(st + TILE_BYTES + a * ATOM_BYTES, &domap, &full[s], a * ATOM_C,
                        i * STEP_ROWS, b);
      }
    }
    float* sf = reinterpret_cast<float*>(st + 2 * TILE_BYTES);
    const bool ok = i * STEP_ROWS + t < p.L;
    sf[t] = ok ? next_m : 0.f;
    sf[STEP_ROWS + t] = ok ? 1.f / next_l : 0.f;
    sf[2 * STEP_ROWS + t] = ok ? next_di : 0.f;
    mbar_arrive(&full[s]);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&full[s], 1 + STAT_THREADS);  // the TMA bytes' arrival, the statistics'
      mbar_init(&empty[s], 8);                // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 1) {
    if (t == 0) {
      mbar_expect_tx(kv_full, 2 * TILE_BYTES);
      for (int a = 0; a < ATOMS; ++a) {
        tc::tma_load_3d(ks + a * ATOM_BYTES, &kmap, kv_full, a * ATOM_C, k0, b);
        tc::tma_load_3d(vs + a * ATOM_BYTES, &vmap, kv_full, a * ATOM_C, k0, b);
      }
    }
    if (t < STAT_THREADS) {
      for (int i = 0; i < DKV_STAGES && i < steps; ++i) {
        fetch(i);
        load_step(i, i);
      }
    }
  }

  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key_ok[h] = k0 + acc_row(t, 2 * h) < p.L;
  // the scores' A (K for S^T, V for dP^T)
  const uint32_t own = tc::smem_u32(wg == 0 ? ks : vs);
  const uint32_t ring0 = tc::smem_u32(ring);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t a[4][4];

  wait_phase(kv_full, 0);
  int s = 0, phase = 0;
  for (int i = 0; i < steps; ++i) {
    wait_phase(&full[s], phase);
    const uint32_t q_tile = ring0 + s * DKV_STAGE_BYTES;
    const uint32_t do_tile = q_tile + TILE_BYTES;
    const float* sf =
        reinterpret_cast<const float*>(ring + s * DKV_STAGE_BYTES + 2 * TILE_BYTES);
    // WG 0: S^T = K Q^T; WG 1: dP^T = V dO^T (keys x queries)
    float sc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = 0.f;
    const uint32_t other = wg == 0 ? q_tile : do_tile;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HEAD_DIM / 16; ++kk)
      mma_ss<T>(sc, kmajor_desc(own, kk), kmajor_desc(other, kk), kk);
    tc::wgmma_commit();
    if (wg == 1 && t < STAT_THREADS) {
      // under dP^T: the slot of step i - 1 takes step i + 1 once both
      // warpgroups left it; then the statistics of step i + 2 are read
      if (i >= 1 && i + 1 < steps) {
        const int slot = (i + 1) % DKV_STAGES;  // step i + 1's, step i - 1's
        wait_phase(&empty[slot], ((i - 1) / DKV_STAGES) & 1);
        load_step(i + 1, slot);
      }
      if (i + DKV_STAGES < steps) fetch(i + DKV_STAGES);
    }
    tc::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < 32; ++x) tc::fence_reg(sc[x]);

    if (wg == 0) {
      // P^T in fp32, queries along the columns; handed to WG 1 as is.
      // exp runs on every element and a select masks it (a branch per
      // element would serialize the 32 exps)
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int qi = acc_col(t, x);
        const float pv = expf(sc[x] * p.scale - sf[qi]) * sf[STEP_ROWS + qi];
        sc[x] = key_ok[(x >> 1) & 1] ? pv : 0.f;
      }
      if (i > 0) tc::named_sync(P_EMPTY, 2 * WG_THREADS);
#pragma unroll
      for (int v = 0; v < 8; ++v)
        *reinterpret_cast<float4*>(pt + (v * WG_THREADS + t) * 4) =
            make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]);
      tc::named_arrive(P_FULL, 2 * WG_THREADS);
    } else {
      // dS^T = (dP^T - di) P^T scale
      tc::named_sync(P_FULL, 2 * WG_THREADS);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float4 pv = *reinterpret_cast<const float4*>(pt + (v * WG_THREADS + t) * 4);
        const float pp[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * v + e;
          sc[x] = (sc[x] - sf[2 * STEP_ROWS + acc_col(t, x)]) * pp[e] * p.scale;
        }
      }
      if (i + 1 < steps) tc::named_arrive(P_EMPTY, 2 * WG_THREADS);
    }
    to_a<T>(a, sc);

    // WG 0: dV += round(P^T) dO; WG 1: dK += round(dS^T) Q
    const uint32_t bt = wg == 0 ? do_tile : q_tile;
#pragma unroll
    for (int x = 0; x < 128; ++x) tc::fence_reg(acc[x]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < STEP_ROWS / 16; ++kk) mma_rs<T>(acc, a[kk], mn_desc(bt, kk));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < 128; ++x) tc::fence_reg(acc[x]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) tc::fence_reg(a[kk][e]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == DKV_STAGES) s = 0, phase ^= 1;
  }

  T* out = static_cast<T*>(wg == 0 ? p.d1 : p.d0) + sbase * HEAD_DIM;
  store_acc<T>(out, acc, k0, p.L, t);
}

// dQ of queries q0 .. q0 + 63 of batch row b.  Q and dO stay in shared
// memory; the producer warp streams K and V of every key step through
// the ring.  Per step the consumer warpgroup computes S = Q K^T and dP =
// dO V^T (two commit groups of SS m64n64k16; p is formed while dP's
// products run), dS = (dP - di) p scale, rounds it into register A and
// adds dQ += dS K (RS m64n256k16, K MN-major).  Its rows' m, 1/l and di
// stay in registers.
template <typename T>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_attn_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap domap, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* dos = qs + TILE_BYTES;
  unsigned char* ring = dos + TILE_BYTES;  // DQ_STAGES of (K, V)
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + DQ_STAGES * 2 * TILE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + DQ_STAGES;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * OWN_ROWS;
  const int steps = (p.L + STEP_ROWS - 1) / STEP_ROWS;
  const int t = threadIdx.x % WG_THREADS;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG_THREADS) {
    // ---- producer
    if (t == 0) {
      mbar_expect_tx(q_full, 2 * TILE_BYTES);
      for (int a = 0; a < ATOMS; ++a) {
        tc::tma_load_3d(qs + a * ATOM_BYTES, &qmap, q_full, a * ATOM_C, q0, b);
        tc::tma_load_3d(dos + a * ATOM_BYTES, &domap, q_full, a * ATOM_C, q0, b);
      }
      int s = 0, phase = 0;
      for (int i = 0; i < steps; ++i) {
        wait_phase(&empty[s], phase ^ 1);
        unsigned char* st = ring + s * 2 * TILE_BYTES;
        mbar_expect_tx(&full[s], 2 * TILE_BYTES);
        for (int a = 0; a < ATOMS; ++a) {
          tc::tma_load_3d(st + a * ATOM_BYTES, &kmap, &full[s], a * ATOM_C, i * STEP_ROWS, b);
          tc::tma_load_3d(st + TILE_BYTES + a * ATOM_BYTES, &vmap, &full[s], a * ATOM_C,
                          i * STEP_ROWS, b);
        }
        if (++s == DQ_STAGES) s = 0, phase ^= 1;
      }
    }
    return;
  }

  // ---- consumer
  const int lane = t & 31;
  const size_t sbase = (size_t)b * p.L;
  float mq[2], il[2], dqi[2];
  bool q_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + acc_row(t, 2 * h);
    q_ok[h] = row < p.L;
    mq[h] = q_ok[h] ? p.m[sbase + row] : 0.f;
    il[h] = q_ok[h] ? 1.f / p.l[sbase + row] : 0.f;
    dqi[h] = q_ok[h] ? p.di[sbase + row] : 0.f;
  }
  const uint32_t q_tile = tc::smem_u32(qs), do_tile = tc::smem_u32(dos);
  const uint32_t ring0 = tc::smem_u32(ring);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t a[4][4];

  wait_phase(q_full, 0);
  int s = 0, phase = 0;
  for (int i = 0; i < steps; ++i) {
    const int k0 = i * STEP_ROWS;
    wait_phase(&full[s], phase);
    const uint32_t k_tile = ring0 + s * 2 * TILE_BYTES;
    const uint32_t v_tile = k_tile + TILE_BYTES;
    float sc[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HEAD_DIM / 16; ++kk)
      mma_ss<T>(sc, kmajor_desc(q_tile, kk), kmajor_desc(k_tile, kk), kk);
    tc::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HEAD_DIM / 16; ++kk)
      mma_ss<T>(dp, kmajor_desc(do_tile, kk), kmajor_desc(v_tile, kk), kk);
    tc::wgmma_commit();
    tc::wgmma_wait<1>();  // S is done; dP's products run on
#pragma unroll
    for (int x = 0; x < 32; ++x) tc::fence_reg(sc[x]);
#pragma unroll
    for (int x = 0; x < 32; ++x) {  // exp on every element, masked by a select
      const int h = (x >> 1) & 1;
      const float pv = expf(sc[x] * p.scale - mq[h]) * il[h];
      sc[x] = k0 + acc_col(t, x) < p.L && q_ok[h] ? pv : 0.f;
    }
    tc::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < 32; ++x) tc::fence_reg(dp[x]);
#pragma unroll
    for (int x = 0; x < 32; ++x) dp[x] = (dp[x] - dqi[(x >> 1) & 1]) * sc[x] * p.scale;
    to_a<T>(a, dp);

    // dQ += round(dS) K
#pragma unroll
    for (int x = 0; x < 128; ++x) tc::fence_reg(acc[x]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < STEP_ROWS / 16; ++kk) mma_rs<T>(acc, a[kk], mn_desc(k_tile, kk));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < 128; ++x) tc::fence_reg(acc[x]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) tc::fence_reg(a[kk][e]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == DQ_STAGES) s = 0, phase ^= 1;
  }

  store_acc<T>(static_cast<T*>(p.d0) + sbase * HEAD_DIM, acc, q0, p.L, t);
}

template <typename T>
int launch(bool dkv, const void* q, const void* k, const void* v, const void* dout,
           const Params& p, int batch, cudaStream_t stream) {
  const bool half = std::is_same<T, __half>::value;
  CUtensorMap qmap, kmap, vmap, domap;
  int rc = encode_rows(&qmap, q, half, batch, p.L, HEAD_DIM);
  if (rc == 0) rc = encode_rows(&kmap, k, half, batch, p.L, HEAD_DIM);
  if (rc == 0) rc = encode_rows(&vmap, v, half, batch, p.L, HEAD_DIM);
  if (rc == 0) rc = encode_rows(&domap, dout, half, batch, p.L, HEAD_DIM);
  if (rc != 0) return rc;
  const dim3 grid((p.L + OWN_ROWS - 1) / OWN_ROWS, batch);
  if (dkv) {
    auto kernel = flash_attn_bwd_dkv_kernel_wgmma<T>;
    static bool configured = false;  // once per instance
    if (!configured) {
      const cudaError_t err = configure(kernel, DKV_SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      configured = true;
    }
    kernel<<<grid, DKV_THREADS, DKV_SMEM, stream>>>(qmap, kmap, vmap, domap, p);
  } else {
    auto kernel = flash_attn_bwd_dq_kernel_wgmma<T>;
    static bool configured = false;  // once per instance
    if (!configured) {
      const cudaError_t err = configure(kernel, DQ_SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      configured = true;
    }
    kernel<<<grid, DQ_THREADS, DQ_SMEM, stream>>>(qmap, kmap, vmap, domap, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma

struct Args {
  const void *q, *k, *v, *dout;
  const float *m, *l, *di;
  void *d0, *d1;  // dkv: dk, dv; dq: dq
  int batch, L, C;
  float scale;
};

namespace ffma {

template <int CMAX>
cudaError_t launch(bool dkv, const Args& a, cudaStream_t stream) {
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k);
  const float *v = static_cast<const float*>(a.v), *dout = static_cast<const float*>(a.dout);
  if (dkv) {
    constexpr size_t smem = dkv_smem_floats<CMAX>() * sizeof(float);
    static_assert(smem <= 232448, "tile exceeds the 227 KB a block may use");
    static bool configured = false;  // once per instance
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dkv_kernel_fma<CMAX>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      configured = true;
    }
    constexpr int BK = DkvTile<CMAX>::BK;
    const dim3 grid((a.L + BK - 1) / BK, a.batch);
    flash_attn_bwd_dkv_kernel_fma<CMAX><<<grid, THREADS, smem, stream>>>(
        q, k, v, dout, a.m, a.l, a.di, static_cast<float*>(a.d0), static_cast<float*>(a.d1),
        a.L, a.C, a.scale);
  } else {
    constexpr size_t smem = dq_smem_floats<CMAX>() * sizeof(float);
    static_assert(smem <= 232448, "tile exceeds the 227 KB a block may use");
    static bool configured = false;  // once per instance
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dq_kernel_fma<CMAX>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      configured = true;
    }
    constexpr int BQ = DqTile<CMAX>::BQ;
    const dim3 grid((a.L + BQ - 1) / BQ, a.batch);
    flash_attn_bwd_dq_kernel_fma<CMAX><<<grid, THREADS, smem, stream>>>(
        q, k, v, dout, a.m, a.l, a.di, static_cast<float*>(a.d0), a.L, a.C, a.scale);
  }
  return cudaGetLastError();
}

}  // namespace ffma

namespace tcbwd {

template <typename T, int CMAX>
cudaError_t launch(bool dkv, const Args& a, cudaStream_t stream) {
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k);
  const T *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  using TL = Tile<CMAX>;
  const dim3 grid((a.L + TL::OWN - 1) / TL::OWN, a.batch);
  if (dkv) {
    static bool configured = false;  // once per instance
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dkv_kernel_tc<T, CMAX>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(TL::DKV_SMEM));
      if (err != cudaSuccess) return err;
      configured = true;
    }
    flash_attn_bwd_dkv_kernel_tc<T, CMAX><<<grid, THREADS, TL::DKV_SMEM, stream>>>(
        q, k, v, dout, a.m, a.l, a.di, static_cast<T*>(a.d0), static_cast<T*>(a.d1), a.L,
        a.C, a.scale);
  } else {
    static bool configured = false;  // once per instance
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dq_kernel_tc<T, CMAX>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(TL::DQ_SMEM));
      if (err != cudaSuccess) return err;
      configured = true;
    }
    flash_attn_bwd_dq_kernel_tc<T, CMAX><<<grid, THREADS, TL::DQ_SMEM, stream>>>(
        q, k, v, dout, a.m, a.l, a.di, static_cast<T*>(a.d0), a.L, a.C, a.scale);
  }
  return cudaGetLastError();
}

}  // namespace tcbwd

// Launch at head-dim class CMAX: fp32 on the FMA kernels, else the tensor cores.
template <int CMAX>
cudaError_t launch_class(bool dkv, const Args& a, int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0: return ffma::launch<CMAX>(dkv, a, s);
    case 1: return tcbwd::launch<__nv_bfloat16, CMAX>(dkv, a, s);
    default: return tcbwd::launch<__half, CMAX>(dkv, a, s);
  }
}

// The wgmma kernels at C = 256, bf16 (dtype 1) or fp16 (2); 16-byte
// aligned tensors (the tensor maps' addresses).
int dispatch_wgmma(bool dkv, const Args& a, int dtype, void* stream) {
  if (a.batch <= 0 || a.batch > 65535 || a.L <= 0 || a.C != k3w::HEAD_DIM || a.m == nullptr ||
      a.l == nullptr || a.di == nullptr ||
      (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
       reinterpret_cast<uintptr_t>(a.d0) | reinterpret_cast<uintptr_t>(dkv ? a.d1 : a.d0)) %
              16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const wgmma::Params p{a.m, a.l, a.di, a.d0, a.d1, a.L, a.scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return wgmma::launch<__nv_bfloat16>(dkv, a.q, a.k, a.v, a.dout, p, a.batch, s);
    case 2: return wgmma::launch<__half>(dkv, a.q, a.k, a.v, a.dout, p, a.batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(bool dkv, const Args& a, int dtype, void* stream) {
  if (a.batch <= 0 || a.batch > 65535 || a.L <= 0 || a.C <= 0 || a.C > 512 || a.C % 4 != 0 ||
      a.m == nullptr || a.l == nullptr || a.di == nullptr || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the head-dim class: the smallest of 64, 128, 256, 512 that holds C
  if (a.C <= 64) return static_cast<int>(launch_class<64>(dkv, a, dtype, s));
  if (a.C <= 128) return static_cast<int>(launch_class<128>(dkv, a, dtype, s));
  if (a.C <= 256) return static_cast<int>(launch_class<256>(dkv, a, dtype, s));
  return static_cast<int>(launch_class<512>(dkv, a, dtype, s));
}

}  // namespace

// dtype: 0 float32 (the FMA kernels), 1 bfloat16, 2 float16 (the
// tensor-core kernels).  q, k, v, dout and the outputs (B, L, C) in that
// dtype, contiguous, 16-byte aligned; m, l (the forward's row statistics)
// and di = rowsum(o * dout), (B, L) float32.  C % 4 == 0 and C <= 512.
// Launch on `stream`; return the launch's cudaError_t.
extern "C" int mudiff_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                         const void* dout, const float* m, const float* l,
                                         const float* di, void* dk, void* dv, int batch,
                                         int L, int C, float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, m, l, di, dk, dv, batch, L, C, scale};
  return dispatch(true, a, dtype, stream);
}

extern "C" int mudiff_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                        const void* dout, const float* m, const float* l,
                                        const float* di, void* dq, int batch, int L, int C,
                                        float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, m, l, di, dq, nullptr, batch, L, C, scale};
  return dispatch(false, a, dtype, stream);
}

// The wgmma paths: the same arguments as mudiff_flash_attn_bwd_dkv / _dq
// with C = 256 and dtype 1 (bfloat16) or 2 (float16).  Return 0, a
// cudaError_t, 10000 (no cuTensorMapEncodeTiled in the driver) or 20000 +
// CUresult (a tensor map refused).
extern "C" int mudiff_flash_attn_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                               const void* dout, const float* m, const float* l,
                                               const float* di, void* dk, void* dv, int batch,
                                               int L, int C, float scale, int dtype,
                                               void* stream) {
  const Args a{q, k, v, dout, m, l, di, dk, dv, batch, L, C, scale};
  return dispatch_wgmma(true, a, dtype, stream);
}

extern "C" int mudiff_flash_attn_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                              const void* dout, const float* m, const float* l,
                                              const float* di, void* dq, int batch, int L,
                                              int C, float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, m, l, di, dq, nullptr, batch, L, C, scale};
  return dispatch_wgmma(false, a, dtype, stream);
}
