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
// has two versions, chosen by dtype in dispatch():
//
// * bf16 / fp16: flash_attn_bwd_{dkv,dq}_kernel_tc, FlashAttention-2's
//   backward on the tensor cores.  Every product is mma.sync.m16n8k16 on
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
// * fp32: flash_attn_bwd_{dkv,dq}_kernel_fma, on the CUDA cores in fp32
//   FMA (TF32 would miss the fp32 tolerance).  dkv: one block of 256
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
    cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dkv_kernel_fma<CMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    constexpr int BK = DkvTile<CMAX>::BK;
    const dim3 grid((a.L + BK - 1) / BK, a.batch);
    flash_attn_bwd_dkv_kernel_fma<CMAX><<<grid, THREADS, smem, stream>>>(
        q, k, v, dout, a.m, a.l, a.di, static_cast<float*>(a.d0), static_cast<float*>(a.d1),
        a.L, a.C, a.scale);
  } else {
    constexpr size_t smem = dq_smem_floats<CMAX>() * sizeof(float);
    static_assert(smem <= 232448, "tile exceeds the 227 KB a block may use");
    cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dq_kernel_fma<CMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
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
    cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dkv_kernel_tc<T, CMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(TL::DKV_SMEM));
    if (err != cudaSuccess) return err;
    flash_attn_bwd_dkv_kernel_tc<T, CMAX><<<grid, THREADS, TL::DKV_SMEM, stream>>>(
        q, k, v, dout, a.m, a.l, a.di, static_cast<T*>(a.d0), static_cast<T*>(a.d1), a.L,
        a.C, a.scale);
  } else {
    cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dq_kernel_tc<T, CMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(TL::DQ_SMEM));
    if (err != cudaSuccess) return err;
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
