// Single-head attention forward, out = softmax(q k^T * scale) v: kernel K3.
//
// Replaces the stock Pallas TPU flash attention that the JAX package calls
// in AttnBlockpp under the "flash" lowering (mudiff_tpu/nn/blocks.py:211;
// jax/experimental/pallas/ops/tpu/flash_attention.py flash_attention ->
// _flash_attention_impl -> pallas_call, body
// _flash_attention_kernel_single_batch).  Same function: per batch row,
// s = q.k^T in fp32 from the input dtype, s *= scale, an online softmax
// with running max m and sum l in fp32, p = exp(s - m) rounded to the
// input dtype, p.v accumulated in fp32, the output rounded to the input
// dtype.  Non-causal, one head, no mask or segment ids.  q, k, v and out
// are (B, L, C) contiguous.  When m_out and l_out are not null, each row's
// final max m and sum l = sum exp(s - m) go there as (B, L) fp32: the
// statistics the backward (flash_attn_bwd_kernel.cu) recomputes p from,
// as the TPU kernel saves l and m as residuals.  With them null the
// output is the same bit for bit.
//
// What bounds it on an H100: operations.  Per batch row it does 4 L^2 C
// flops on 4 L C elements, i.e. L = 4096 flops per element moved, far
// above the card's ridge.  This first version runs on the CUDA cores in
// fp32 FMA (for bf16 and fp32 inputs alike), so it sits well above its
// tensor-core bound; its distance is recorded in PERF.md, and an
// mma/wgmma version is later work.
//
// Design.  One block of 256 threads owns BQ queries of one batch row and
// walks over all keys in tiles of BK = 64.  Q (BQ x C) stays in shared
// memory as fp32; one buffer takes the K tile, then the V tile.  Per key
// tile: (1) each thread computes an SR x 4 patch of the scores (its keys
// interleaved by 16, so a quarter-warp reads 8 different K rows from 8
// bank groups); (2) the row max and row sum are reduced across the 16
// lanes that share a row with shuffles, the running statistics are
// updated, and p (rounded to the input dtype) and the rescale factor go
// to shared memory; (3) each thread owns a 4 x CPT patch of the output
// accumulator in registers, rescales it and adds p.v.  The accumulator
// is not normalised per tile: it is divided by l once, at the end.
//
// Head dims 256 and 512 are large.  The block's tile sizes are picked per
// head-dim class (CMAX) so that the accumulator is 64 registers a thread
// and shared memory stays under the 227 KB a block may use: CMAX 512
// takes BQ = 32 queries (207 KB of dynamic shared memory), CMAX 256
// BQ = 64 (151 KB).  Any C that is a multiple of 4 and at most 512 runs
// in the smallest class that holds it; columns past C are zero in shared
// memory and masked at the store.  Keys past L score -inf (p = 0) and
// their V rows are zero; queries past L are computed and not stored.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;            // keys per tile
constexpr int PAD = 4;            // floats of padding per shared-memory row
constexpr int NKG = 16;           // lanes that share one score row
constexpr int KPT = BK / NKG;     // keys per thread in the score patch
constexpr int RPT = 4;            // output rows per thread

template <int CMAX> struct Tile;  // BQ queries per block, CPT output columns per thread
template <> struct Tile<512> { static constexpr int BQ = 32, CPT = 16; };
template <> struct Tile<256> { static constexpr int BQ = 64, CPT = 16; };
template <> struct Tile<128> { static constexpr int BQ = 64, CPT = 8; };
template <> struct Tile<64> { static constexpr int BQ = 64, CPT = 4; };

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

// p rounded to the input dtype before it multiplies v, as the TPU kernel
// casts p to v.dtype.
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

template <int CMAX>
constexpr size_t smem_floats() {
  return (size_t)Tile<CMAX>::BQ * (CMAX + PAD) + (size_t)BK * (CMAX + PAD) +
         (size_t)Tile<CMAX>::BQ * (BK + PAD) + 2 * (size_t)Tile<CMAX>::BQ;
}

template <typename T, int CMAX>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out, int L, int C,
                  float scale) {
  constexpr int BQ = Tile<CMAX>::BQ;
  constexpr int CPT = Tile<CMAX>::CPT;
  constexpr int NG = CPT / 4;                 // float4 column groups a thread owns
  constexpr int NCG = CMAX / CPT;             // threads along C in the output patch
  constexpr int SR = BQ / (THREADS / NKG);    // score rows per thread
  constexpr int LD = CMAX + PAD;
  constexpr int LDP = BK + PAD;
  static_assert((BQ / RPT) * NCG == THREADS, "output patches tile the block");
  static_assert(SR >= 1 && BQ % (THREADS / NKG) == 0, "score patches tile the block");

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [BQ][LD]
  float* kvs = qs + BQ * LD;          // [BK][LD], K then V
  float* ps = kvs + BK * LD;          // [BQ][LDP]
  float* alpha_s = ps + BQ * LDP;     // [BQ] rescale of the accumulator
  float* l_s = alpha_s + BQ;          // [BQ] final row sums

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * L * C;

  // columns past C of the K/V buffer are never loaded: zero them once
  for (int i = tid; i < BK * LD; i += THREADS) kvs[i] = 0.f;
  load_tile<T, LD>(qs, q + base, q0, BQ, L, C);

  const int kg = tid % NKG;           // score patch: keys kg + NKG * j
  const int sg = tid / NKG;           //              rows sg * SR + r
  const int cg = tid % NCG;           // output patch: columns g * NCG * 4 + cg * 4 + e
  const int og = tid / NCG;           //               rows og * RPT + r

  float m_run[SR], l_run[SR];
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  float acc[RPT][CPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile's p.v is done with the buffer
    load_tile<T, LD>(kvs, k + base, k0, BK, L, C);
    __syncthreads();

    float s[SR][KPT];
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[r][j] = 0.f;
    for (int c = 0; c < C; c += 4) {
      float4 qv[SR], kv[KPT];
#pragma unroll
      for (int r = 0; r < SR; ++r)
        qv[r] = *reinterpret_cast<const float4*>(&qs[(sg * SR + r) * LD + c]);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&kvs[(kg + NKG * j) * LD + c]);
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          float t = s[r][j];
          t = fmaf(qv[r].x, kv[j].x, t);
          t = fmaf(qv[r].y, kv[j].y, t);
          t = fmaf(qv[r].z, kv[j].z, t);
          t = fmaf(qv[r].w, kv[j].w, t);
          s[r][j] = t;
        }
    }

#pragma unroll
    for (int r = 0; r < SR; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[r][j] = (k0 + kg + NKG * j < L) ? s[r][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = NKG / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // key k0 + 0 is valid, so the first tile gives every row a finite max
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = expf(m_run[r] - m_new);
      float sum = 0.f;
      const int row = sg * SR + r;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[r][j] - m_new);
        sum += p;
        ps[row * LDP + kg + NKG * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = NKG / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
      if (kg == 0) alpha_s[row] = alpha;
    }
    __syncthreads();  // K is consumed; p and alpha are visible
    load_tile<T, LD>(kvs, v + base, k0, BK, L, C);
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float a = alpha_s[og * RPT + r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] *= a;
    }
    for (int j = 0; j < BK; ++j) {
      float pv[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) pv[r] = ps[(og * RPT + r) * LDP + j];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&kvs[j * LD + g * NCG * 4 + cg * 4]);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          acc[r][g * 4 + 0] = fmaf(pv[r], vv.x, acc[r][g * 4 + 0]);
          acc[r][g * 4 + 1] = fmaf(pv[r], vv.y, acc[r][g * 4 + 1]);
          acc[r][g * 4 + 2] = fmaf(pv[r], vv.z, acc[r][g * 4 + 2]);
          acc[r][g * 4 + 3] = fmaf(pv[r], vv.w, acc[r][g * 4 + 3]);
        }
      }
    }
  }

  if (kg == 0) {
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      l_s[sg * SR + r] = l_run[r];
      const int row = q0 + sg * SR + r;
      if (m_out != nullptr && row < L) {
        m_out[(size_t)blockIdx.y * L + row] = m_run[r];
        l_out[(size_t)blockIdx.y * L + row] = l_run[r];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = q0 + og * RPT + r;
    if (row >= L) continue;
    const float inv = 1.f / l_s[og * RPT + r];
    T* orow = out + base + (size_t)row * C;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = g * NCG * 4 + cg * 4;
      if (col < C)
        store4(orow + col, acc[r][g * 4 + 0] * inv, acc[r][g * 4 + 1] * inv,
               acc[r][g * 4 + 2] * inv, acc[r][g * 4 + 3] * inv);
    }
  }
}

template <typename T, int CMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* m,
                   float* l, int batch, int L, int C, float scale, cudaStream_t stream) {
  constexpr int BQ = Tile<CMAX>::BQ;
  constexpr size_t smem = smem_floats<CMAX>() * sizeof(float);
  static_assert(smem <= 232448, "tile exceeds the 227 KB a block may use");
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<T, CMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, batch);
  flash_attn_kernel<T, CMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), m, l, L, C, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_c(const void* q, const void* k, const void* v, void* out, float* m,
                         float* l, int batch, int L, int C, float scale, cudaStream_t s) {
  if (C <= 64) return launch<T, 64>(q, k, v, out, m, l, batch, L, C, scale, s);
  if (C <= 128) return launch<T, 128>(q, k, v, out, m, l, batch, L, C, scale, s);
  if (C <= 256) return launch<T, 256>(q, k, v, out, m, l, batch, L, C, scale, s);
  return launch<T, 512>(q, k, v, out, m, l, batch, L, C, scale, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  q, k, v, out (B, L, C) in that
// dtype, contiguous, 8-byte aligned (16 for float32); C % 4 == 0 and
// C <= 512.  m and l: both null, or both (B, L) float32 for the row
// statistics.  Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int mudiff_flash_attn(const void* q, const void* k, const void* v, void* out,
                                 float* m, float* l, int batch, int L, int C, float scale,
                                 int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || C <= 0 || C > 512 || C % 4 != 0 ||
      (m == nullptr) != (l == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_for_c<float>(q, k, v, out, m, l, batch, L, C, scale, s));
    case 1: return static_cast<int>(launch_for_c<__nv_bfloat16>(q, k, v, out, m, l, batch, L, C, scale, s));
    case 2: return static_cast<int>(launch_for_c<__half>(q, k, v, out, m, l, batch, L, C, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
