// Single-head attention forward, out = softmax(q k^T * scale) v: kernel K3.
//
// Replaces the stock Pallas TPU flash attention that the JAX package calls
// in AttnBlockpp under the "flash" lowering (mudiff_tpu/nn/blocks.py:211;
// jax/experimental/pallas/ops/tpu/flash_attention.py flash_attention ->
// _flash_attention_impl -> pallas_call, body
// _flash_attention_kernel_single_batch).  Same function: per batch row,
// s = q.k^T in fp32 from the input dtype, s *= scale, an online softmax
// with running max m and sum l in fp32, p = exp(s - m) rounded to the
// input dtype, p.v accumulated in fp32, one division by l at the end, the
// output rounded to the input dtype.  Non-causal, one head, no mask or
// segment ids.  q, k, v and out are (B, L, C) contiguous.  When m_out and
// l_out are not null, each row's final max m and sum l = sum exp(s - m)
// (unrounded p) go there as (B, L) fp32: the statistics the backward
// (flash_attn_bwd_kernel.cu) recomputes p from, as the TPU kernel saves l
// and m as residuals.  With them null the output is the same bit for bit.
//
// What bounds it on an H100: operations.  Per batch row it does 4 L^2 C
// flops on 4 L C elements, i.e. L = 4096 flops per element moved, far
// above the card's ridge.  Inside a block the limits are the L2 -> shared
// traffic of the K / V tiles (64 flops a byte for 64 queries a block, 128
// for 128) and the softmax between the two products.
//
// Three hand-written kernels; the wrapper (ops/flash_attn.py k3_path)
// picks one before any launch, from the head dim and dtype:
//
// * "wgmma", bf16 / fp16 at C = 256 (the recipe's head dim, nf = 64):
//   flash_attn_kernel_wgmma, entry point mudiff_flash_attn_wgmma, on
//   Hopper's warpgroup MMA fed by TMA (namespace wgmma below).  A block is
//   one or two consumer warpgroups of 64 queries each (128-query blocks
//   where the grid still gives each SM a block, else 64-query blocks, two
//   an SM: the same bits either way).  TMA brings the Q tiles and a ring
//   of K and V tiles through 3-D tensor maps over (C, L, B) as 64-channel
//   boxes with the 128-byte swizzle, zero-filled past L of the batch row
//   (never the next row's keys).  Per key tile of 64: S = Q K^T as 16 SS
//   wgmma.m64n64k16 (Q and K read K-major by descriptor), the online
//   softmax on the fp32 accumulator fragments, p rounded into wgmma's
//   register A and O += P V as 4 RS wgmma.m64n256k16 with V read as an
//   MN-major B (no transposed copy).  Each K / V tile is read once per
//   warpgroup from shared memory (mma.sync read it once per warp).  The
//   warpgroup that leaves a ring slot last refills it; there is no
//   producer warp, which would cap the consumers' registers (see Config).
//   A missing cuTensorMapEncodeTiled or a refused tensor map returns an
//   error code that the wrapper raises on.
//
// * "general", bf16 / fp16 at other head dims (C = 512 at nf = 128, C <
//   256): flash_attn_kernel_tc (mudiff_flash_attn), FlashAttention-2 on
//   the tensor cores.  A block owns BQ = 64 queries of one batch row, four row groups
//   of 16; each warp owns the 16 query rows of its group.  Q stays in
//   shared memory (its fragments are reloaded by ldmatrix, as registers
//   hold the output); K and V tiles of BK = 64 keys come in by cp.async
//   into one buffer each, the V tile's copy overlapping S = Q K^T and the
//   next K tile's copy overlapping the softmax and P V.  S and O += P V
//   run as mma.sync.m16n8k16 with fp32 accumulators.  C <= 256 (the path's
//   head dim, nf = 64; a smaller C runs with zero-filled columns): one
//   warp per row group owns the whole 16 x 256 output (128 fp32 registers
//   a thread) and all 64 keys, and P goes from the S accumulator straight
//   into A fragments.  C = 512
//   (nf = 128): a 16 x 512 fp32 output does not fit in a warp's
//   registers, so two warps share each row group.  Warp j scores keys
//   32j..32j+31 of the tile against all of C and owns output columns
//   256j..256j+255; the pair exchanges its row maxima through shared
//   memory (a named barrier per pair), both rescale by the same running
//   max, write their halves of P (rounded) to shared memory and each
//   multiplies the whole 16 x 64 P by its half of V.  The partial row
//   sums are added across the pair at the end.  No score is computed
//   twice.  Keys past L score -inf (p = 0) and their V rows load as
//   zeros; query rows past L load as zeros and are not stored; columns
//   past C load as zeros.
//
// * "fma", fp32: flash_attn_kernel_fma (mudiff_flash_attn), on the CUDA
//   cores in fp32 FMA (TF32 would miss the fp32 tolerance).  One block of
//   256 threads owns BQ queries; per key tile of 64 it computes a patch of
//   scores per thread, reduces the row statistics with shuffles, stages p
//   in shared memory and accumulates p.v in a register patch per thread.

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

template <int CMAX>
constexpr size_t smem_floats() {
  return (size_t)Tile<CMAX>::BQ * (CMAX + PAD) + (size_t)BK * (CMAX + PAD) +
         (size_t)Tile<CMAX>::BQ * (BK + PAD) + 2 * (size_t)Tile<CMAX>::BQ;
}

template <int CMAX>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel_fma(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
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
  load_tile<LD>(qs, q + base, q0, BQ, L, C);

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
    load_tile<LD>(kvs, k + base, k0, BK, L, C);
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
        ps[row * LDP + kg + NKG * j] = p;
      }
#pragma unroll
      for (int off = NKG / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
      if (kg == 0) alpha_s[row] = alpha;
    }
    __syncthreads();  // K is consumed; p and alpha are visible
    load_tile<LD>(kvs, v + base, k0, BK, L, C);
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
    float* orow = out + base + (size_t)row * C;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = g * NCG * 4 + cg * 4;
      if (col < C)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[r][g * 4 + 0] * inv, acc[r][g * 4 + 1] * inv,
                        acc[r][g * 4 + 2] * inv, acc[r][g * 4 + 3] * inv);
    }
  }
}

template <int CMAX>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, float* m,
                   float* l, int batch, int L, int C, float scale, cudaStream_t stream) {
  constexpr int BQ = Tile<CMAX>::BQ;
  constexpr size_t smem = smem_floats<CMAX>() * sizeof(float);
  static_assert(smem <= 232448, "tile exceeds the 227 KB a block may use");
  static bool configured = false;  // once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel_fma<CMAX>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((L + BQ - 1) / BQ, batch);
  flash_attn_kernel_fma<CMAX><<<grid, THREADS, smem, stream>>>(q, k, v, out, m, l, L, C, scale);
  return cudaGetLastError();
}

cudaError_t launch_for_c(const void* q, const void* k, const void* v, void* out, float* m,
                         float* l, int batch, int L, int C, float scale, cudaStream_t s) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  if (C <= 64) return launch<64>(qf, kf, vf, of, m, l, batch, L, C, scale, s);
  if (C <= 128) return launch<128>(qf, kf, vf, of, m, l, batch, L, C, scale, s);
  if (C <= 256) return launch<256>(qf, kf, vf, of, m, l, batch, L, C, scale, s);
  return launch<512>(qf, kf, vf, of, m, l, batch, L, C, scale, s);
}

}  // namespace ffma

// ------------------------------------------------------ bf16/fp16 tensor cores

namespace tcattn {

constexpr int BQ = 64;   // queries per block: four row groups of 16
constexpr int BK = 64;   // keys per tile
constexpr int PAD = 8;   // 16-bit elements of padding per shared row

template <int CMAX>
struct Tile {
  static constexpr int SPLIT = CMAX > 256 ? 2 : 1;  // warps per row group
  static constexpr int WARPS = 4 * SPLIT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int OC = CMAX / SPLIT;           // output columns of a warp
  static constexpr int KW = BK / SPLIT;             // keys a warp scores
  static constexpr int LD = CMAX + PAD;             // Q / K / V row
  static constexpr int LDP = BK + PAD;              // P row (SPLIT > 1)
  static constexpr size_t SMEM =
      2 * ((size_t)(BQ + 2 * BK) * LD + (SPLIT > 1 ? (size_t)BQ * LDP : 0)) +
      (SPLIT > 1 ? 4 * (size_t)WARPS * 16 : 0);
  static_assert(OC <= 256 && OC % 16 == 0 && KW % 16 == 0, "warp tile");
  static_assert(SMEM <= 232448, "tile exceeds the 227 KB a block may use");
};

template <typename T, int CMAX>
__global__ void __launch_bounds__(Tile<CMAX>::THREADS)
flash_attn_kernel_tc(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int L, int C, float scale) {
  using TL = Tile<CMAX>;
  constexpr int SPLIT = TL::SPLIT, LD = TL::LD, LDP = TL::LDP;
  constexpr int OC = TL::OC, KW = TL::KW;
  constexpr int SN = KW / 8;   // score n-tiles of a warp
  constexpr int ON = OC / 8;   // output n-tiles of a warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* ks = qs + BQ * LD;                    // [BK][LD]
  T* vs = ks + BK * LD;                    // [BK][LD]
  T* ps = vs + BK * LD;                    // [BQ][LDP]    (SPLIT > 1)
  float* red = reinterpret_cast<float*>(ps + (SPLIT > 1 ? BQ * LDP : 0));  // [WARPS][16]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = warp & 3;        // row group: block rows 16g .. 16g + 15
  const int j = warp >> 2;       // split index: keys KW j.., columns OC j..
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * L * C;
  const bool vec16 = C % 8 == 0;
  const int tiles = (L + BK - 1) / BK;

  tc::load_rows<T, CMAX, LD, BQ, TL::THREADS>(qs, q + base, q0, L, C, vec16);
  tc::load_rows<T, CMAX, LD, BK, TL::THREADS>(ks, k + base, 0, L, C, vec16);
  tc::cp_async_commit();

  float o[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // this thread's rows: lane / 4 (h = 0) and lane / 4 + 8 (h = 1) of the group
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};   // partial: this thread's columns, this warp's keys

  const T* qrow = qs + (g * 16 + (lane & 15)) * LD + (lane >> 4) * 8;

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * BK;
    tc::cp_async_wait<0>();   // K tile t (and Q) landed
    __syncthreads();          // ... for all; every warp is done with V tile t-1
    tc::load_rows<T, CMAX, LD, BK, TL::THREADS>(vs, v + base, k0, L, C, vec16);
    tc::cp_async_commit();

    // S = Q K^T over this warp's KW keys
    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const T* krow = ks + (j * KW + (lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < CMAX; kk += 16) {
      uint32_t a[4];
      tc::ldsm_x4(a, qrow + kk);
#pragma unroll
      for (int n = 0; n < SN; n += 2) {
        uint32_t b[4];
        tc::ldsm_x4(b, krow + n * 8 * LD + kk);
        tc::mma16816<T>(s[n], a, b[0], b[1]);
        tc::mma16816<T>(s[n + 1], a, b[2], b[3]);
      }
    }

    tc::cp_async_wait<0>();   // V tile t landed
    __syncthreads();          // ... for all; every warp is done with K tile t
    if (t + 1 < tiles)
      tc::load_rows<T, CMAX, LD, BK, TL::THREADS>(ks, k + base, k0 + BK, L, C, vec16);
    tc::cp_async_commit();

    // online softmax of this thread's two rows
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * KW + n * 8 + (lane & 3) * 2 + (e & 1);
        const float val = key < L ? s[n][e] * scale : -INFINITY;
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    if constexpr (SPLIT > 1) {
      if ((lane & 3) == 0) {
        red[warp * 16 + (lane >> 2)] = mx[0];
        red[warp * 16 + (lane >> 2) + 8] = mx[1];
      }
      tc::group_sync<SPLIT>(g);
#pragma unroll
      for (int jj = 0; jj < SPLIT; ++jj)
        if (jj != j) {
          mx[0] = fmaxf(mx[0], red[(g + 4 * jj) * 16 + (lane >> 2)]);
          mx[1] = fmaxf(mx[1], red[(g + 4 * jj) * 16 + (lane >> 2) + 8]);
        }
    }
    // key k0 + 0 is valid and in warp j = 0's keys, so the first tile gives
    // every row a finite max, and alpha = exp(-inf) = 0 there
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_run[e >> 1]);
        l_run[e >> 1] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V over all BK keys, this warp's OC columns; p rounded to T
    const T* vrow = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + j * OC + (lane >> 4) * 8;
    if constexpr (SPLIT == 1) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = tc::pack2<T>(s[2 * kk][0], s[2 * kk][1]);
        a[1] = tc::pack2<T>(s[2 * kk][2], s[2 * kk][3]);
        a[2] = tc::pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = tc::pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < ON; n += 2) {
          uint32_t b[4];
          tc::ldsm_x4_t(b, vrow + kk * 16 * LD + n * 8);
          tc::mma16816<T>(o[n], a, b[0], b[1]);
          tc::mma16816<T>(o[n + 1], a, b[2], b[3]);
        }
      }
    } else {
      T* prow = ps + (g * 16 + (lane >> 2)) * LDP + j * KW + (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        *reinterpret_cast<uint32_t*>(prow + n * 8) = tc::pack2<T>(s[n][0], s[n][1]);
        *reinterpret_cast<uint32_t*>(prow + 8 * LDP + n * 8) = tc::pack2<T>(s[n][2], s[n][3]);
      }
      tc::group_sync<SPLIT>(g);
      const T* pa = ps + (g * 16 + (lane & 15)) * LDP + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        tc::ldsm_x4(a, pa + kk * 16);
#pragma unroll
        for (int n = 0; n < ON; n += 2) {
          uint32_t b[4];
          tc::ldsm_x4_t(b, vrow + kk * 16 * LD + n * 8);
          tc::mma16816<T>(o[n], a, b[0], b[1]);
          tc::mma16816<T>(o[n + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // row sums: across the quad, then across the warps of the group
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  if constexpr (SPLIT > 1) {
    // every warp of the group read red (the maxima) before the last P
    // barrier, so it may be overwritten now
    if ((lane & 3) == 0) {
      red[warp * 16 + (lane >> 2)] = l_run[0];
      red[warp * 16 + (lane >> 2) + 8] = l_run[1];
    }
    tc::group_sync<SPLIT>(g);
    float total[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < SPLIT; ++jj) {
      total[0] += red[(g + 4 * jj) * 16 + (lane >> 2)];
      total[1] += red[(g + 4 * jj) * 16 + (lane >> 2) + 8];
    }
    l_run[0] = total[0];
    l_run[1] = total[1];
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + g * 16 + (lane >> 2) + 8 * h;
    if (row >= L) continue;
    if (m_out != nullptr && j == 0 && (lane & 3) == 0) {
      m_out[(size_t)blockIdx.y * L + row] = m_run[h];
      l_out[(size_t)blockIdx.y * L + row] = l_run[h];
    }
    const float inv = 1.f / l_run[h];
    T* orow = out + base + (size_t)row * C;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      const int col = j * OC + n * 8 + (lane & 3) * 2;
      if (col < C)
        *reinterpret_cast<uint32_t*>(orow + col) =
            tc::pack2<T>(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    }
  }
}

template <typename T, int CMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* m, float* l,
                   int batch, int L, int C, float scale, cudaStream_t stream) {
  using TL = Tile<CMAX>;
  static bool configured = false;  // once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel_tc<T, CMAX>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(TL::SMEM));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((L + BQ - 1) / BQ, batch);
  flash_attn_kernel_tc<T, CMAX><<<grid, TL::THREADS, TL::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), m, l, L, C, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_c(const void* q, const void* k, const void* v, void* out, float* m,
                         float* l, int batch, int L, int C, float scale, cudaStream_t s) {
  if (C <= 256) return launch<T, 256>(q, k, v, out, m, l, batch, L, C, scale, s);
  return launch<T, 512>(q, k, v, out, m, l, batch, L, C, scale, s);
}

}  // namespace tcattn

// ----------------------------------------- bf16/fp16 wgmma + TMA (Hopper)

namespace wgmma {

using namespace k3w;  // tiles, descriptors, the m64n64 / m64n256 products
using tc::mbar_expect_tx;
using tc::mbar_init;

constexpr int QUERY_ROWS = 64;            // queries a consumer warpgroup owns: one m64
constexpr int KEY_ROWS = 64;              // keys a K / V tile: the scores' n64, P V's k
constexpr int STAGES_NARROW = 2;          // K / V tiles in the ring, 64-query blocks: one key tile
constexpr int STAGES_WIDE = 4;            // the same, 128-query blocks: two key tiles
constexpr int BLOCKS_NARROW = 2;          // blocks an SM, 64-query blocks
constexpr int SMEM_LIMIT = 232448;        // dynamic shared memory a block may use

// NWG consumer warpgroups (64 queries each) and no producer: the
// warpgroup that leaves a ring slot last refills it (its thread 0 counts
// the warpgroups out of the slot and issues the TMA loads).  Registers: an
// SM's four schedulers each hold a quarter of the register file and a
// block's warps are dealt to them in turn, so a producer warp beside two
// consumer warpgroups (9 warps, three on one scheduler) would cap every
// thread at 168 registers, and setmaxnreg does not raise what ptxas
// compiles the consumers for (it serializes their wgmma instead).  With
// warpgroups only, each scheduler holds at most two warps of a block (or
// of the two 64-query blocks an SM) and a consumer keeps up to 255
// registers for its 128 fp32 O accumulators, 32 scores and 16 P registers.
template <int NWG>
struct Config {
  static constexpr int THREADS = NWG * WG_THREADS;
  static constexpr int BQ = NWG * QUERY_ROWS;
  static constexpr int STAGES = NWG == 1 ? STAGES_NARROW : STAGES_WIDE;
  static constexpr int BLOCKS = NWG == 1 ? BLOCKS_NARROW : 1;
  // alignment slack, NWG Q tiles, the ring, the barriers, the slot counts
  static constexpr int SMEM = 1024 + (NWG + STAGES) * TILE_BYTES + (STAGES + 1) * 8 + STAGES * 4;
  static_assert(NWG == 1 || NWG == 2, "64 or 128 queries a block");
  static_assert(SMEM <= SMEM_LIMIT && BLOCKS * (SMEM + 1024) <= 233472,
                "the planned blocks share an SM's 228 KB");
  static_assert(STAGES % 2 == 0, "K and V of a key tile alternate in the ring");
};
static_assert(QUERY_ROWS == TILE_ROWS && KEY_ROWS == TILE_ROWS, "m64 tiles");

struct Params {
  void* out;               // (B, L, C)
  float* m_out;            // (B, L) or null
  float* l_out;            // (B, L) or null
  int L;
  float scale;
};

// One block: queries q0 .. q0 + 64 NWG of batch row b, one consumer
// warpgroup a 64 of them.  Per key tile a warpgroup computes S = Q K^T (16
// SS m64n64k16), the online softmax on the accumulator, rounds p into
// register A and adds O += P V (4 RS m64n256k16, V MN-major).  The ring
// holds K and V of the key tiles in turn (item n = 2 tile + (V ? 1 : 0) in
// slot n % STAGES); a slot's full barrier counts its TMA bytes.  A
// consumer's arithmetic does not depend on NWG, so 64- and 128-query
// blocks give the same bits.
template <typename T, int NWG>
__global__ void __launch_bounds__(Config<NWG>::THREADS, Config<NWG>::BLOCKS)
flash_attn_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const Params p) {
  using CF = Config<NWG>;
  constexpr int STAGES = CF::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;                       // NWG Q tiles
  unsigned char* ring = qs + NWG * TILE_BYTES;    // STAGES K / V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * TILE_BYTES);
  uint64_t* q_full = full + STAGES;
  unsigned* left = reinterpret_cast<unsigned*>(q_full + 1);  // warpgroups out of each slot

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * CF::BQ;
  const int items = 2 * ((p.L + KEY_ROWS - 1) / KEY_ROWS);
  const int wg = threadIdx.x / WG_THREADS;
  const int t = threadIdx.x % WG_THREADS;
  const int lane = t & 31;

  // item n (K or V of key tile n / 2) into slot n % STAGES
  auto load = [&](int n) {
    const int s = n % STAGES;
    mbar_expect_tx(&full[s], TILE_BYTES);
    for (int a = 0; a < ATOMS; ++a)
      tc::tma_load_3d(ring + s * TILE_BYTES + a * ATOM_BYTES, (n & 1) ? &vmap : &kmap,
                      &full[s], a * ATOM_C, (n >> 1) * KEY_ROWS, b);
  };
  // this warpgroup is done with item n: the last one out refills its slot
  auto leave = [&](int n) {
    tc::named_sync(1 + wg, WG_THREADS);  // every warp of it has waited for its products
    if (t == 0 && n + STAGES < items) {
      __threadfence_block();
      if (atomicAdd(&left[n % STAGES], 1u) % NWG == NWG - 1) load(n + STAGES);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      left[s] = 0;
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, NWG * TILE_BYTES);
    for (int g = 0; g < NWG; ++g)
      for (int a = 0; a < ATOMS; ++a)
        tc::tma_load_3d(qs + g * TILE_BYTES + a * ATOM_BYTES, &qmap, q_full, a * ATOM_C,
                        q0 + g * QUERY_ROWS, b);
    for (int n = 0; n < STAGES && n < items; ++n) load(n);
  }

  const uint32_t q_tile = tc::smem_u32(qs + wg * TILE_BYTES);
  const uint32_t ring0 = tc::smem_u32(ring);
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  // this thread's rows: acc_row(t, x) for h = 0 (x & 2 == 0) and h = 1
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // partial: this thread's columns
  uint32_t a[4][4];

  wait_phase(q_full, 0);
  for (int n = 0; n < items; n += 2) {
    const int k0 = (n >> 1) * KEY_ROWS;
    // S = Q K^T over all 256 channels
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wait_phase(&full[n % STAGES], (n / STAGES) & 1);
    const uint32_t k_tile = ring0 + (n % STAGES) * TILE_BYTES;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HEAD_DIM / 16; ++kk)
      mma_ss<T>(sc, kmajor_desc(q_tile, kk), kmajor_desc(k_tile, kk), kk);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) tc::fence_reg(sc[i]);
    leave(n);

    // online softmax of this thread's two rows, as the general path's
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int key = k0 + acc_col(t, x);
      const float val = key < p.L ? sc[x] * p.scale : -INFINITY;
      sc[x] = val;
      mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], val);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    // key k0 + 0 is valid, so the first tile gives every row a finite max,
    // and alpha = exp(-inf) = 0 there
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const float pv = expf(sc[x] - m_run[(x >> 1) & 1]);
      l_run[(x >> 1) & 1] += pv;
      sc[x] = pv;
    }
#pragma unroll
    for (int x = 0; x < 128; ++x) o[x] *= alpha[(x >> 1) & 1];
    to_a<T>(a, sc);

    // O += P V over the tile's 64 keys, p rounded to T
    wait_phase(&full[(n + 1) % STAGES], ((n + 1) / STAGES) & 1);
    const uint32_t v_tile = ring0 + ((n + 1) % STAGES) * TILE_BYTES;
#pragma unroll
    for (int i = 0; i < 128; ++i) tc::fence_reg(o[i]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEY_ROWS / 16; ++kk) mma_rs<T>(o, a[kk], mn_desc(v_tile, kk));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) tc::fence_reg(o[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) tc::fence_reg(a[kk][i]);
    leave(n + 1);
  }

  // row sums across the quad; one division, one rounding
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  const size_t base = (size_t)b * p.L;
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wg * QUERY_ROWS + acc_row(t, 2 * h);
    if (row >= p.L) continue;
    if (p.m_out != nullptr && (lane & 3) == 0) {
      p.m_out[base + row] = m_run[h];
      p.l_out[base + row] = l_run[h];
    }
    const float inv = 1.f / l_run[h];
    T* orow = out + (base + row) * HEAD_DIM;
#pragma unroll
    for (int j = 0; j < HEAD_DIM / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + acc_col(t, 4 * j)) =
          tc::pack2<T>(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

template <typename T, int NWG>
cudaError_t launch_wgmma(const CUtensorMap& qmap, const CUtensorMap& kmap,
                         const CUtensorMap& vmap, const Params& p, int batch,
                         cudaStream_t stream) {
  using CF = Config<NWG>;
  auto kernel = flash_attn_kernel_wgmma<T, NWG>;
  static bool configured = false;  // once per instance
  if (!configured) {
    const cudaError_t err = configure(kernel, CF::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.L + CF::BQ - 1) / CF::BQ, batch);
  kernel<<<grid, CF::THREADS, CF::SMEM, stream>>>(qmap, kmap, vmap, p);
  return cudaGetLastError();
}

// block_q 128 (two consumer warpgroups sharing each K / V tile) where the
// grid still gives each SM a block, else 64 (twice the blocks, two an
// SM); 64 or 128 when the caller names it.
template <typename T>
int attn(const void* q, const void* k, const void* v, void* out, float* m, float* l, int batch,
         int L, float scale, int block_q, cudaStream_t stream) {
  const bool half = std::is_same<T, __half>::value;
  CUtensorMap qmap, kmap, vmap;
  int rc = encode_rows(&qmap, q, half, batch, L, HEAD_DIM);
  if (rc == 0) rc = encode_rows(&kmap, k, half, batch, L, HEAD_DIM);
  if (rc == 0) rc = encode_rows(&vmap, v, half, batch, L, HEAD_DIM);
  if (rc != 0) return rc;
  if (block_q == 0)
    block_q = (long long)batch * ((L + 127) / 128) >= tc::sm_count() ? 128 : 64;
  const Params p{out, m, l, L, scale};
  if (block_q == 128)
    return static_cast<int>(launch_wgmma<T, 2>(qmap, kmap, vmap, p, batch, stream));
  return static_cast<int>(launch_wgmma<T, 1>(qmap, kmap, vmap, p, batch, stream));
}

}  // namespace wgmma

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  q, k, v, out (B, L, C) in that
// dtype, contiguous, 16-byte aligned; C % 4 == 0 and C <= 512.  m and l:
// both null, or both (B, L) float32 for the row statistics.  float32 runs
// the FMA kernel, bfloat16 and float16 the tensor-core one.  Launches on
// `stream` and returns the cudaError_t of the launch.
extern "C" int mudiff_flash_attn(const void* q, const void* k, const void* v, void* out,
                                 float* m, float* l, int batch, int L, int C, float scale,
                                 int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || C <= 0 || C > 512 || C % 4 != 0 ||
      (m == nullptr) != (l == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(ffma::launch_for_c(q, k, v, out, m, l, batch, L, C, scale, s));
    case 1:
      return static_cast<int>(
          tcattn::launch_for_c<__nv_bfloat16>(q, k, v, out, m, l, batch, L, C, scale, s));
    case 2:
      return static_cast<int>(
          tcattn::launch_for_c<__half>(q, k, v, out, m, l, batch, L, C, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The wgmma path of q, k, v, out (B, L, 256) of dtype (1 bfloat16, 2
// float16), contiguous, 16-byte aligned; m and l as mudiff_flash_attn's.
// block_q: 0 (by the grid: 128 queries a block where that still gives each
// SM a block, else 64), 64 or 128; the bits do not depend on it.
// Launches on `stream`; returns 0, a cudaError_t, 10000 (no
// cuTensorMapEncodeTiled in the driver) or 20000 + CUresult (a tensor map
// refused).
extern "C" int mudiff_flash_attn_wgmma(const void* q, const void* k, const void* v, void* out,
                                       float* m, float* l, int batch, int L, int C, float scale,
                                       int dtype, int block_q, void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || C != k3w::HEAD_DIM ||
      (m == nullptr) != (l == nullptr) || (block_q != 0 && block_q != 64 && block_q != 128) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return wgmma::attn<__nv_bfloat16>(q, k, v, out, m, l, batch, L, scale, block_q, s);
    case 2: return wgmma::attn<__half>(q, k, v, out, m, l, batch, L, scale, block_q, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
