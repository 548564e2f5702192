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
// What bounds it on an H100: operations.  The backward does 10 B L^2 C
// flops (five products) on about 7 B L C elements; at L = 4096 that is
// far above the card's ridge.  This first version runs on the CUDA cores
// in fp32 FMA for every input dtype (so --no_bf16 trains through the same
// code), well above its tensor-core bound; PERF.md records the distance,
// and an mma/wgmma version is later work.
//
// Design.  As on the TPU, two kernels, so that every output element has
// one owner: no atomics, and the result is deterministic.
// * dkv: one block of 256 threads owns BK keys of one batch row.  K and
//   V of those keys stay in shared memory (fp32) for the whole kernel;
//   the block walks over all queries in tiles of BQ.  Per tile: load Q
//   and dO (fp32) and the rows' m, 1/l and di; (1) each thread computes
//   whole entries of S and dP (a length-C dot product each; a quarter
//   warp reads 8 different K rows from 8 bank groups), and writes p and
//   ds, rounded, to shared memory; (2) each thread owns a RPT x CPT patch
//   of both the dK and dV accumulators in registers and adds ds^T q and
//   p^T do.
// * dq: one block owns BQ queries; Q, dO and the row statistics stay in
//   shared memory, and the block walks over all keys in tiles of BK, with
//   the same two phases (the dq patch in registers adds ds k).
// Shared memory: the tiles are picked per head-dim class (CMAX 64 / 128 /
// 256 / 512) so that the accumulators take 64 registers a thread or
// fewer and shared memory stays under the 227 KB a block may use (set
// with cudaFuncSetAttribute); at C = 512, dkv keeps BK = BQ = 16 (134 KB)
// and dq BQ = 32, BK = 16 (200 KB).  Columns past C are zero in shared
// memory and masked at the store.  Ragged lengths: keys and queries past
// L load as zero rows and get p = ds = 0, so they add nothing, and their
// rows are not stored.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store4(__half* p, float a, float b, float c, float d) {
  uint2 raw;
  *reinterpret_cast<__half2*>(&raw.x) = __floats2half2_rn(a, b);
  *reinterpret_cast<__half2*>(&raw.y) = __floats2half2_rn(c, d);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <> __device__ __forceinline__ float round_to<__half>(float x) {
  return __half2float(__float2half(x));
}

// rows [row0, row0 + rows) of an (L, C) matrix into dst (row stride LD)
// as fp32; rows past L are zeros.  C % 4 == 0.
template <typename T, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int rows, int L, int C) {
  const int c4 = C >> 2;
  for (int i = threadIdx.x; i < rows * c4; i += THREADS) {
    const int r = i / c4;
    const int cc = (i - r * c4) << 2;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < L) val = load4(src + (size_t)(row0 + r) * C + cc);
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
// p and ds, each rounded to the input dtype, into ps / dss (row stride
// LDP).  Entries outside [0, L) on either side get p = ds = 0.
template <typename T, int LD, int LDP, int BQ, int BK, bool WRITE_P>
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
    if (WRITE_P) ps[r * LDP + j] = round_to<T>(p);
    dss[r * LDP + j] = round_to<T>(ds);
  }
}

template <int CMAX>
constexpr size_t dkv_smem_floats() {
  constexpr int BK = DkvTile<CMAX>::BK, BQ = DkvTile<CMAX>::BQ;
  return 2 * (size_t)BK * (CMAX + PAD) + 2 * (size_t)BQ * (CMAX + PAD) +
         2 * (size_t)BQ * (BK + 1) + 3 * (size_t)BQ;
}

template <typename T, int CMAX>
__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ m, const float* __restrict__ l,
                          const float* __restrict__ di, T* __restrict__ dk,
                          T* __restrict__ dv, int L, int C, float scale) {
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
  load_tile<T, LD>(ks, k + base, k0, BK, L, C);
  load_tile<T, LD>(vs, v + base, k0, BK, L, C);

  const int cg = tid % NCG;  // patch: columns g * NCG * 4 + cg * 4 + e
  const int jg = tid / NCG;  //        key rows jg + ROWG * i
  float acc_k[RPT][CPT], acc_v[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BQ) {
    __syncthreads();  // the previous tile's accumulation is done
    load_tile<T, LD>(qs, q + base, q0, BQ, L, C);
    load_tile<T, LD>(dos, dout + base, q0, BQ, L, C);
    load_stats(ms, ils, dis, m + sbase, l + sbase, di + sbase, q0, BQ, L);
    __syncthreads();
    probs_and_ds<T, LD, LDP, BQ, BK, true>(qs, dos, ks, vs, ms, ils, dis, ps, dss, q0, k0,
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

template <typename T, int CMAX>
__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ m, const float* __restrict__ l,
                         const float* __restrict__ di, T* __restrict__ dq, int L, int C,
                         float scale) {
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
  load_tile<T, LD>(qs, q + base, q0, BQ, L, C);
  load_tile<T, LD>(dos, dout + base, q0, BQ, L, C);
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
    load_tile<T, LD>(ks, k + base, k0, BK, L, C);
    load_tile<T, LD>(vs, v + base, k0, BK, L, C);
    __syncthreads();
    probs_and_ds<T, LD, LDP, BQ, BK, false>(qs, dos, ks, vs, ms, ils, dis, nullptr, dss, q0,
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

struct Args {
  const void *q, *k, *v, *dout;
  const float *m, *l, *di;
  void *d0, *d1;  // dkv: dk, dv; dq: dq
  int batch, L, C;
  float scale;
};

template <typename T, int CMAX>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_floats<CMAX>() * sizeof(float);
  static_assert(smem <= 232448, "tile exceeds the 227 KB a block may use");
  cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dkv_kernel<T, CMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int BK = DkvTile<CMAX>::BK;
  const dim3 grid((a.L + BK - 1) / BK, a.batch);
  flash_attn_bwd_dkv_kernel<T, CMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.m, a.l, a.di, static_cast<T*>(a.d0),
      static_cast<T*>(a.d1), a.L, a.C, a.scale);
  return cudaGetLastError();
}

template <typename T, int CMAX>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_floats<CMAX>() * sizeof(float);
  static_assert(smem <= 232448, "tile exceeds the 227 KB a block may use");
  cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dq_kernel<T, CMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int BQ = DqTile<CMAX>::BQ;
  const dim3 grid((a.L + BQ - 1) / BQ, a.batch);
  flash_attn_bwd_dq_kernel<T, CMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.m, a.l, a.di, static_cast<T*>(a.d0), a.L, a.C,
      a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_c(bool dkv, const Args& a, cudaStream_t s) {
  if (a.C <= 64) return dkv ? launch_dkv<T, 64>(a, s) : launch_dq<T, 64>(a, s);
  if (a.C <= 128) return dkv ? launch_dkv<T, 128>(a, s) : launch_dq<T, 128>(a, s);
  if (a.C <= 256) return dkv ? launch_dkv<T, 256>(a, s) : launch_dq<T, 256>(a, s);
  return dkv ? launch_dkv<T, 512>(a, s) : launch_dq<T, 512>(a, s);
}

int dispatch(bool dkv, const Args& a, int dtype, void* stream) {
  if (a.batch <= 0 || a.batch > 65535 || a.L <= 0 || a.C <= 0 || a.C > 512 || a.C % 4 != 0 ||
      a.m == nullptr || a.l == nullptr || a.di == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_for_c<float>(dkv, a, s));
    case 1: return static_cast<int>(launch_for_c<__nv_bfloat16>(dkv, a, s));
    case 2: return static_cast<int>(launch_for_c<__half>(dkv, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  q, k, v, dout and the outputs
// (B, L, C) in that dtype, contiguous, 8-byte aligned (16 for float32);
// m, l (the forward's row statistics) and di = rowsum(o * dout), (B, L)
// float32.  C % 4 == 0 and C <= 512.  Launch on `stream`; return the
// launch's cudaError_t.
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
