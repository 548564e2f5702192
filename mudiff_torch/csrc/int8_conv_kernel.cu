// W8A8 3x3 stride-1 SAME convolution, NHWC input x HWIO weight: kernel K4.
//
// Replaces the int8 conv of the JAX package (mudiff_tpu/ops/int8_conv.py:268
// int8_conv3x3 and :239 _static_int8_conv3x3, with quantize_activation :227;
// XLA-lowered on the TPU).  Same function, bit for bit:
//   dynamic: scale[b] = absmax_b / 127 + 1e-30 (absmax over H, W, C of
//            example b), q = clip(rn(x / scale[b]), +-127),
//            y = float(acc) * (scale[b] * w_scale[n]) + bias[n];
//   static:  q = clip(rn(x * inv_a[c]), +-127) (inv_a = 1 / (absmax_c / 127 +
//            1e-30), folded into the weight by the wrapper),
//            y = float(acc) * w_scale[n] + bias[n];
// acc = sum over (dy, dx, ci) of q[b, h+dy-1, w+dx-1, ci] * wq[n, dy, dx, ci]
// in s32, exact; rn is round half to even; y is rounded once to the output
// dtype.  The float arithmetic is the JAX package's as XLA compiles it (the
// way it serves): the division of a run-time absmax by 127 becomes a
// multiply by the float32 1/127, and each multiply-add one fused
// multiply-add, so the scales are fma(absmax, 1/127, 1e-30) and the output
// fma(float(acc), s, bias).  Every float operation is an explicit
// __f*_rn / __fmaf_rn intrinsic, so nvcc contracts nothing else.
//
// What bounds it on an H100: operations at the wide sites.  A routed conv
// (Cin, Cout >= 128) does 2 * 9 * Cin * Cout operations per pixel for
// (Cin + Cout) bytes of int8 in and out plus the input's float bytes, well
// above the card's int8 ridge (1979 TOP/s / 3.35 TB/s = 590 op/B) at
// Cin = Cout = 256.  Inside a block the limits are the L2 -> shared and the
// shared-memory traffic of the operand tiles.
//
// Two paths, chosen by the wrapper (ops/int8_conv.py k4_path) before any
// launch:
//
// * s8wgmma (Cin % 16 == 0, 16-byte aligned x and weight: every shape of
//   the flagship configurations), one entry point, mudiff_int8_conv3x3_fused:
//   absmax_kernel<PARTS> (dynamic scales only: per-example partial maxima,
//   every slot written, so nothing is zeroed first), then conv_kernel, which
//   quantizes inside the conv: the codes never reach device memory.  A
//   block owns 128 output pixels (8 rows x 16 columns, or 128 / W rows x W
//   for W < 16: the halo patch is then 10 x 18 pixels, 1.4 a pixel of
//   output) and 128 output channels.  For each chunk of 64 input channels
//   TMA brings the halo patch of x, (rows + 2) x (tw + 2) pixels in x's
//   dtype, zero-filled outside the image (SAME padding, code 0 is the value
//   0) and past Cin; quantizer warps turn it into an s8 patch in shared
//   memory once; the nine taps are then nine row shifts into that patch,
//   which ldmatrix reads into the registers of wgmma's A operand (a shift by
//   a pixel breaks the 8-row core matrices a shared-memory A descriptor
//   would need).  The weight tiles (128 channels x 64 bytes of one tap) come
//   by TMA with the 64-byte swizzle into a ring that the wgmma B
//   descriptors read.  wgmma.m64n128k32 s8 x s8 -> s32, two consumer
//   warpgroups of 64 rows.
// * the general path (any other shape), mudiff_int8_quantize then
//   mudiff_int8_conv3x3, three kernels:
//   - absmax_kernel (dynamic only): per-example max |x| over H*W*C; blocks
//     of a 2-D grid (chunks, B) reduce 16-byte vectors, then one atomicMax
//     on the float's bits (all values >= 0, so the integer order is the
//     float order);
//   - quantize_kernel: one thread per 16 elements writes one 16-byte chunk
//     of int8 codes (a scalar path when the sizes are not multiples of 16);
//   - s8conv::conv_kernel: an implicit GEMM on the tensor cores,
//     mma.sync.m16n8k32 s8 x s8 -> s32.  M = B*H*W output pixels, N = Cout,
//     K = 9*Cin ordered tap-major (dy, dx, ci).  The weight comes as a
//     (Cout, 9*Cin) int8 matrix with K contiguous (the wrapper transposes the
//     HWIO codes once and caches them), so both operand tiles are
//     K-contiguous rows in shared memory and both load with ldmatrix without
//     a transpose.  The rest is K1's skeleton (conv3x3_kernel.cu): a block
//     owns BM x BN outputs and walks K in steps of BK channels of one tap
//     through a STAGES-deep ring of 16-byte cp.async copies, halos and
//     channel tails zero-filled; eight warps own 64 x 32 sub-tiles.
//     Cin % 16 != 0 packs K across taps and loads both tiles with scalar
//     loads.
// Both epilogues rescale and add the bias in fp32 and store from the
// fragments (or the raw s32 accumulator, for the checks).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

// ------------------------------------------------------------------ quantize

constexpr int QTHREADS = 256;
constexpr int QCHUNK = 16;  // elements a thread quantizes (one 16-byte store)

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_float<__half>(__half v) {
  return __half2float(v);
}

// scale = absmax / 127 + 1e-30 as the JAX package compiles it: XLA turns
// the division by the constant 127 into a multiply by its float32
// reciprocal and contracts the multiply and the add into one FMA.
__device__ __forceinline__ float dynamic_scale(float absmax) {
  return __fmaf_rn(absmax, 1.0f / 127.0f, 1e-30f);
}

// clip(rn(v), -127, 127) as int8; rn is half to even (cvt.rni).
__device__ __forceinline__ int code_of(float v) {
  return min(127, max(-127, __float2int_rn(v)));
}

// Sixteen elements of T from 16-byte aligned memory.
template <typename T>
__device__ __forceinline__ void load16(float (&v)[QCHUNK], const T* p) {
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte vector
#pragma unroll
  for (int j = 0; j < QCHUNK / PER; ++j) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + j * PER);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) v[j * PER + i] = to_float(e[i]);
  }
}

// VEC: per_example % 16 == 0 and x 16-byte aligned; each thread reduces
// 16-element chunks.  Else one element at a time.  PARTS: block (i, b)
// writes its maximum to absmax[b * gridDim.x + i] (every slot is written,
// so nothing needs zeroing first); else one atomicMax into absmax[b].
template <typename T, bool VEC, bool PARTS = false>
__global__ void __launch_bounds__(QTHREADS)
absmax_kernel(const T* __restrict__ x, float* __restrict__ absmax, long long per_example) {
  const int b = blockIdx.y;
  const T* xb = x + (long long)b * per_example;
  const long long stride = (long long)gridDim.x * QTHREADS;
  float m = 0.f;
  if constexpr (VEC) {
    const long long chunks = per_example / QCHUNK;
    for (long long i = (long long)blockIdx.x * QTHREADS + threadIdx.x; i < chunks; i += stride) {
      float v[QCHUNK];
      load16(v, xb + i * QCHUNK);
#pragma unroll
      for (int j = 0; j < QCHUNK; ++j) m = fmaxf(m, fabsf(v[j]));
    }
  } else {
    for (long long i = (long long)blockIdx.x * QTHREADS + threadIdx.x; i < per_example;
         i += stride)
      m = fmaxf(m, fabsf(to_float(xb[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[QTHREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < QTHREADS / 32 ? warp_max[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) {
      if constexpr (PARTS)
        absmax[(long long)b * gridDim.x + blockIdx.x] = m;
      else
        atomicMax(reinterpret_cast<unsigned int*>(absmax) + b, __float_as_uint(m));
    }
  }
}

// STATIC: q = code(x * inv_a[c]); else q = code(x / scale[b]).  VEC: each
// thread quantizes 16 consecutive elements, all of one example (per_example
// % 16 == 0) and of consecutive channels (channels % 16 == 0), from 16-byte
// aligned x and q.  Else one element a thread.
template <typename T, bool STATIC, bool VEC>
__global__ void __launch_bounds__(QTHREADS)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ inv_a,
                const float* __restrict__ absmax, int8_t* __restrict__ q,
                long long per_example, int channels, long long total) {
  const long long t = (long long)blockIdx.x * QTHREADS + threadIdx.x;
  if constexpr (VEC) {
    const long long e0 = t * QCHUNK;
    if (e0 >= total) return;
    float v[QCHUNK];
    load16(v, x + e0);
    uint32_t packed[QCHUNK / 4];
    if constexpr (STATIC) {
      const int c0 = (int)(e0 % channels);
#pragma unroll
      for (int j = 0; j < QCHUNK; j += 4) {
        const float4 s = *reinterpret_cast<const float4*>(inv_a + c0 + j);
        const float sj[4] = {s.x, s.y, s.z, s.w};
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          word |= (uint32_t)(uint8_t)code_of(__fmul_rn(v[j + i], sj[i])) << (8 * i);
        packed[j / 4] = word;
      }
    } else {
      const float scale = dynamic_scale(absmax[e0 / per_example]);
#pragma unroll
      for (int j = 0; j < QCHUNK; j += 4) {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          word |= (uint32_t)(uint8_t)code_of(__fdiv_rn(v[j + i], scale)) << (8 * i);
        packed[j / 4] = word;
      }
    }
    *reinterpret_cast<uint4*>(q + e0) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  } else {
    if (t >= total) return;
    const float v = to_float(x[t]);
    const float r = STATIC ? __fmul_rn(v, inv_a[t % channels])
                           : __fdiv_rn(v, dynamic_scale(absmax[t / per_example]));
    q[t] = (int8_t)code_of(r);
  }
}

template <typename T>
cudaError_t quantize(const void* xv, const float* inv_a, float* absmax, int8_t* q, int batch,
                     long long per_example, int channels, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const long long total = (long long)batch * per_example;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool vec = aligned && per_example % QCHUNK == 0 &&
                   (inv_a == nullptr || (channels % QCHUNK == 0 &&
                                         reinterpret_cast<uintptr_t>(inv_a) % 16 == 0));
  if (inv_a == nullptr) {
    cudaError_t err = cudaMemsetAsync(absmax, 0, sizeof(float) * batch, stream);
    if (err != cudaSuccess) return err;
    const long long units = vec ? per_example / QCHUNK : per_example;
    const long long want = (units + QTHREADS - 1) / QTHREADS;
    const dim3 grid((unsigned)(want < 1024 ? want : 1024), batch);
    if (vec)
      absmax_kernel<T, true><<<grid, QTHREADS, 0, stream>>>(x, absmax, per_example);
    else
      absmax_kernel<T, false><<<grid, QTHREADS, 0, stream>>>(x, absmax, per_example);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long threads = vec ? total / QCHUNK : total;
  const long long blocks = (threads + QTHREADS - 1) / QTHREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned g = (unsigned)blocks;
  if (inv_a != nullptr) {
    if (vec)
      quantize_kernel<T, true, true><<<g, QTHREADS, 0, stream>>>(x, inv_a, absmax, q,
                                                                 per_example, channels, total);
    else
      quantize_kernel<T, true, false><<<g, QTHREADS, 0, stream>>>(x, inv_a, absmax, q,
                                                                  per_example, channels, total);
  } else {
    if (vec)
      quantize_kernel<T, false, true><<<g, QTHREADS, 0, stream>>>(x, inv_a, absmax, q,
                                                                  per_example, channels, total);
    else
      quantize_kernel<T, false, false><<<g, QTHREADS, 0, stream>>>(x, inv_a, absmax, q,
                                                                   per_example, channels, total);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------- s8 tensor cores

namespace s8conv {

constexpr int THREADS = 256;  // eight warps
constexpr int BM = 128;       // output pixels a block
constexpr int BN = 128;       // output channels a block
constexpr int BK = 64;        // int8 channels of one tap a K step (two k32 mma steps)
constexpr int STAGES = 4;     // cp.async ring depth
constexpr int WM = 2;         // warps along M (64 rows each)
constexpr int WN = 4;         // warps along N (32 columns each)
constexpr int PAD = 16;       // bytes of padding per shared row
constexpr int TM = BM / WM, TN = BN / WN;  // 64 x 32 a warp
constexpr int MT = TM / 16, NT = TN / 8;   // m16n8k32 tiles a warp
constexpr int LDS = BK + PAD;              // bytes a shared row (80: ldmatrix conflict-free)
constexpr int STAGE = (BM + BN) * LDS;     // A rows, then B rows
constexpr size_t SMEM = (size_t)STAGES * STAGE;
static_assert(WM * WN * 32 == THREADS, "eight warps");
static_assert(BM == BN, "one loop copies an A row and a B row");
static_assert(BM * (BK / 16) % THREADS == 0 && BN * (BK / 16) % THREADS == 0,
              "16-byte chunks divide among the threads");
static_assert(LDS % 16 == 0, "ldmatrix rows are 16-byte aligned");
static_assert(SMEM <= 232448, "ring exceeds the 227 KB a block may use");

// d += a . b: A 16 x 32 s8 (row), B 32 x 8 s8 (col), s32 sums.  Fragments
// (lane = g * 4 + t): a0 A[g][4t..4t+3], a1 A[g+8][4t..], a2 A[g][16+4t..],
// a3 A[g+8][16+4t..]; b0 B[4t..4t+3][g], b1 B[16+4t..][g]; d0, d1
// D[g][2t, 2t+1], d2, d3 D[g+8][2t, 2t+1].  In bytes these are the
// m16n8k16 16-bit layouts, so ldmatrix (b16) loads them from K-contiguous
// rows.
__device__ __forceinline__ void mma16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename O> __device__ __forceinline__ void store2(O* p, float v0, float v1);
template <> __device__ __forceinline__ void store2<float>(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float v0,
                                                                  float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
template <> __device__ __forceinline__ void store2<__half>(__half* p, float v0, float v1) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v0, v1);
}
template <typename O> __device__ __forceinline__ O round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half round_to<__half>(float v) {
  return __float2half_rn(v);
}

// O: float, bf16, half (the rescaled output) or int (the raw accumulator).
// DYN: per-example scales from absmax.  AVEC: Cin % 16 == 0 and 16-byte
// aligned operands (16-byte copies, K padded per tap), else scalar loads
// with K packed across taps.
template <typename O, bool DYN, bool AVEC>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ wq,
            const float* __restrict__ absmax, const float* __restrict__ w_scale,
            const float* __restrict__ bias, O* __restrict__ out, int M, int height, int width,
            int cin, int cout, int tiles_n, int chunks, int ksteps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / WN;
  const int warp_n = warp % WN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int hw = height * width;
  const long long krow = 9LL * cin;  // bytes of one weight row

  // The rows this thread copies (16-byte path): A pixels, and (h, w) of
  // each (rows past M get h far outside, so every tap is zero-filled).
  constexpr int CPR = BK / 16;                  // 16-byte chunks a row
  constexpr int ITERS = BM * CPR / THREADS;     // == BN * CPR / THREADS
  constexpr int RSTEP = THREADS / CPR;
  const int chunk = tid % CPR;
  const int row0 = tid / CPR;
  int a_m[AVEC ? ITERS : 1], a_h[AVEC ? ITERS : 1], a_w[AVEC ? ITERS : 1];
  if constexpr (AVEC) {
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int m = m0 + row0 + i * RSTEP;
      const int rem = m % hw;
      a_m[i] = m;
      a_h[i] = m < M ? rem / width : -4;
      a_w[i] = rem % width;
    }
  }

  auto load_stage = [&](int st, int s) {
    unsigned char* as = smem + st * STAGE;
    unsigned char* bs = as + BM * LDS;
    if constexpr (AVEC) {
      const int tap = s / chunks;
      const int ci = (s - tap * chunks) * BK + chunk * 16;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const long long delta = ((long long)dy * width + dx) * cin + ci;
      const bool ci_ok = ci < cin;
#pragma unroll
      for (int i = 0; i < ITERS; ++i) {
        const int r = row0 + i * RSTEP;
        const int hh = a_h[i] + dy, ww = a_w[i] + dx;
        const bool valid = ci_ok && hh >= 0 && hh < height && ww >= 0 && ww < width;
        tc::cp_async16(as + r * LDS + chunk * 16,
                       valid ? q + ((long long)a_m[i] * cin + delta) : q, valid);
        const int n = n0 + r;
        const bool wvalid = ci_ok && n < cout;
        tc::cp_async16(bs + r * LDS + chunk * 16,
                       wvalid ? wq + ((long long)n * krow + (long long)tap * cin + ci) : wq,
                       wvalid);
      }
    } else {
      // packed K: k = tap * cin + ci, scalar loads
      const int k0 = s * BK;
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int k = k0 + kk;
        const int m = m0 + r;
        int8_t v = 0;
        if (k < 9 * cin && m < M) {
          const int t = k / cin, ci = k - t * cin;
          const int n = m / hw, rem = m - n * hw;
          const int hh = rem / width + t / 3 - 1, ww = rem % width + t % 3 - 1;
          if (hh >= 0 && hh < height && ww >= 0 && ww < width)
            v = q[(((long long)n * height + hh) * width + ww) * cin + ci];
        }
        as[r * LDS + kk] = (unsigned char)v;
      }
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int k = k0 + kk;
        int8_t v = 0;
        if (k < 9 * cin && n0 + r < cout) v = wq[(long long)(n0 + r) * krow + k];
        bs[r * LDS + kk] = (unsigned char)v;
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load_stage(s, s);
    tc::cp_async_commit();
  }

  for (int s = 0; s < ksteps; ++s) {
    tc::cp_async_wait<STAGES - 2>();  // step s has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; stage s-1 is free
    const int next = s + STAGES - 1;
    if (next < ksteps) load_stage(next % STAGES, next);
    tc::cp_async_commit();

    const unsigned char* as = smem + (s % STAGES) * STAGE;
    const unsigned char* bs = as + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        tc::ldsm_x4(af[i], as + (warp_m * TM + i * 16 + (lane & 15)) * LDS + kk +
                               (lane >> 4) * 16);
      uint32_t bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        tc::ldsm_x4(r, bs + (warp_n * TN + j * 8 + (lane & 7) + (lane >> 4) * 8) * LDS + kk +
                           ((lane >> 3) & 1) * 16);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma16832(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  tc::cp_async_wait<0>();

  // Epilogue: y = fma(float(acc), a_scale * w_scale, bias) (dynamic) or
  // fma(float(acc), w_scale, bias) (static); stored from the fragments, two
  // neighbouring channels a store where Cout is even.
  const bool pairs = cout % 2 == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp_m * TM + i * 16 + (lane >> 2) + half * 8;
      if (m >= M) continue;
      float a_scale = 1.f;
      if constexpr (DYN) a_scale = dynamic_scale(absmax[m / hw]);
      O* orow = out + (long long)m * cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + warp_n * TN + j * 8 + (lane & 3) * 2;
        if (n >= cout) continue;
        const int a0 = acc[i][j][half * 2], a1 = acc[i][j][half * 2 + 1];
        if constexpr (std::is_same<O, int>::value) {
          // the raw s32 accumulator
          orow[n] = a0;
          if (n + 1 < cout) orow[n + 1] = a1;
        } else {
          float v[2];
          const int av[2] = {a0, a1};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n + e < cout ? n + e : n;
            const float s = DYN ? __fmul_rn(a_scale, w_scale[c]) : w_scale[c];
            const float accf = __int2float_rn(av[e]);
            v[e] = bias != nullptr ? __fmaf_rn(accf, s, bias[c]) : __fmul_rn(accf, s);
          }
          if (pairs) {
            store2<O>(orow + n, v[0], v[1]);
          } else {
            orow[n] = round_to<O>(v[0]);
            if (n + 1 < cout) orow[n + 1] = round_to<O>(v[1]);
          }
        }
      }
    }
  }
}

template <typename O, bool DYN, bool AVEC>
cudaError_t launch_paths(const int8_t* q, const int8_t* wq, const float* absmax,
                         const float* w_scale, const float* bias, O* out, int M, int height,
                         int width, int cin, int cout, cudaStream_t stream) {
  auto kernel = conv_kernel<O, DYN, AVEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  const int chunks = (cin + BK - 1) / BK;
  const int ksteps = AVEC ? 9 * chunks : (9 * cin + BK - 1) / BK;
  const int tiles_n = (cout + BN - 1) / BN;
  const long long blocks = (long long)((M + BM - 1) / BM) * tiles_n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM, stream>>>(
      q, wq, absmax, w_scale, bias, out, M, height, width, cin, cout, tiles_n, chunks, ksteps);
  return cudaGetLastError();
}

template <typename O>
cudaError_t launch(const int8_t* q, const int8_t* wq, const float* absmax, const float* w_scale,
                   const float* bias, void* out, int batch, int height, int width, int cin,
                   int cout, cudaStream_t stream) {
  const long long m = (long long)batch * height * width;
  if (m > 0x7fffffffLL || 9LL * cin > 0x7fffffffLL) return cudaErrorInvalidValue;
  O* o = static_cast<O*>(out);
  const bool avec = cin % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  const int M = (int)m;
  if (absmax != nullptr) {
    if (avec)
      return launch_paths<O, true, true>(q, wq, absmax, w_scale, bias, o, M, height, width,
                                         cin, cout, stream);
    return launch_paths<O, true, false>(q, wq, absmax, w_scale, bias, o, M, height, width,
                                        cin, cout, stream);
  }
  if (avec)
    return launch_paths<O, false, true>(q, wq, absmax, w_scale, bias, o, M, height, width, cin,
                                        cout, stream);
  return launch_paths<O, false, false>(q, wq, absmax, w_scale, bias, o, M, height, width, cin,
                                       cout, stream);
}

}  // namespace s8conv

// ------------------------------------------- fused quantize + s8 wgmma (Hopper)

namespace s8wgmma {

using namespace tc;  // the mbarrier, TMA and wgmma helpers

constexpr int THREADS = 512;           // four warpgroups: 128 registers a thread at most
constexpr int QUANT_THREADS = 224;     // warps 1..7: the producer warp's three and warpgroup 1
constexpr int CONSUMER_THREADS = 256;  // warpgroups 2 and 3 (m64 each)
constexpr int TILE_M = 128;            // output pixels a block: rows x tw, tw = min(W, TILE_W)
constexpr int TILE_W = 16;             // widest tile row: 8 x 16 pixels, a halo of 10 x 18
constexpr int BN = 128;                // output channels a block (m64n128k32 a consumer)
constexpr int BK = 64;                 // input channels a chunk (two k32 steps, 64-byte B rows)
constexpr int TAPS = 9;                // the 3 x 3 taps, each a shift into the s8 patch
constexpr int B_STAGES = 7;            // weight tiles (one tap of one chunk) in the TMA ring
constexpr int A_SETS = 3;              // A register sets a consumer cycles through (tap % 3)
constexpr int PATCH_PIX = 390;         // most halo pixels of a tile: (128 + 2) x (1 + 2)
constexpr int SQ_STRIDE = 80;          // bytes a pixel of the s8 patch (64 codes + 16 pad)
constexpr int ABSMAX_PARTS = 128;      // most partial maxima an example (dynamic scales)
constexpr int B_TILE = BN * BK;        // bytes of one weight tile, 64-byte swizzle
constexpr int NACC = BN / 8 * 4;       // s32 accumulators a consumer thread (64)
constexpr int SQ_BYTES = PATCH_PIX * SQ_STRIDE;  // one s8 patch
static_assert(THREADS == 32 + QUANT_THREADS + CONSUMER_THREADS, "roles");
static_assert(TILE_M == 2 * 64 && CONSUMER_THREADS == 256, "two m64 consumers");
static_assert(PATCH_PIX == (TILE_M + 2) * (1 + 2), "the tallest tile: 128 rows of 1 (W = 1)");
static_assert(TILE_M % TILE_W == 0 && (TILE_M / TILE_W + 2) * (TILE_W + 2) <= PATCH_PIX,
              "a tile of full rows fits the patch");
static_assert(SQ_STRIDE % 16 == 0 && SQ_STRIDE >= BK, "ldmatrix rows are 16-byte aligned");
static_assert(B_TILE % 1024 == 0, "every weight stage starts on a swizzle repeat");
static_assert(A_SETS == 3 && TAPS % A_SETS == 0, "one k32 group in flight: a tap's set is "
              "rewritten three taps later, across chunks too");
static_assert(ABSMAX_PARTS <= QUANT_THREADS, "one partial maximum a thread");
static_assert(TILE_M * (BN + 8) * 4 <= PATCH_PIX * BK * 2 * 2,
              "the staged output tile fits the x patch buffer (two 2-byte or one fp32 patch)");

// x patches in flight: two for 2-byte x (the next chunk's lands while one
// is quantized), one in fp32.
template <typename T>
__host__ __device__ constexpr int x_stages() { return sizeof(T) == 2 ? 2 : 1; }

template <typename T>
__host__ __device__ constexpr int x_patch_bytes() { return PATCH_PIX * BK * (int)sizeof(T); }

// Shared memory: the weight ring (1024-byte aligned for the swizzle), the
// x patches in x's dtype (TMA, 128-byte aligned), two s8 patches, then the
// barriers and the reduction slots; plus 1024 bytes to align the base.
template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)B_STAGES * B_TILE + x_stages<T>() * x_patch_bytes<T>() + 2 * SQ_BYTES +
         (2 * B_STAGES + 8) * 8 + 16 * 4 + 1024;
}
static_assert(smem_bytes<float>() <= 232448 && smem_bytes<__nv_bfloat16>() <= 232448,
              "patches and ring exceed 227 KB");

struct Params {
  const float* inv_a;     // (Cin,) static reciprocal scales, or null (dynamic)
  const float* parts;     // (B, nparts) partial maxima of |x| (dynamic)
  float* absmax;          // (B,) written by one block an example (dynamic)
  const float* w_scale;   // (Cout,)
  const float* bias;      // (Cout,) or null
  void* out;              // (B, H, W, Cout) of out_dtype
  int out_dtype;          // 0 float32, 1 bfloat16, 2 float16, 3 int32 (the accumulator)
  int height, width, cin, cout;
  int tw, rows;           // tile: rows x tw output pixels (rows * tw <= TILE_M)
  int tiles_w, tiles_h, tiles_n, chunks, nparts;
};

// Barrier `id` of `count` threads (1: the consumers, 2: the quantizers;
// 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The wgmma descriptor of a K-major B tile of 8-row groups of 64-byte rows
// written by TMA with the 64-byte swizzle: start address >> 4, leading
// byte offset 1 (unused by swizzled K-major layouts), stride byte offset
// 512 >> 4 (from one 8-row group to the next), layout type 2 (64B).
__device__ __forceinline__ uint64_t b_desc(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// clip(rn(v), -127, 127) in the low byte of the result, as code_of gives it
// (NaN -> 0, as cvt.rni does), without the quarter-rate float-to-int
// conversion: v clamped to [-127, 127] plus 1.5 * 2^23 is the float
// 1.5 * 2^23 + k with k = rn(v) (the add rounds half to even), whose low
// byte is k in two's complement.
__device__ __forceinline__ uint32_t code_bits(float v) {
  const float c = fminf(fmaxf(v, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(v == v ? c : 0.f, 12582912.f));
}

// code_bits(RN(v / scale)) without the division, for almost every v: q =
// RN(v * recip) with recip = RN(1 / scale) is within 2.3e-5 of RN(v /
// scale) wherever |q| <= 128 (each of recip, q and the quotient is off by
// at most 2^-24 relative), so where q lies farther than 2^-14 from every
// half-integer both round to the same integer, and beyond +-127 both
// clip.  `exact` turns false otherwise (about 1 value in 8000: near a .5,
// or NaN), and the caller then takes the correctly rounded division.
__device__ __forceinline__ uint32_t quotient_code_bits(float v, float recip, bool& exact) {
  const float q = __fmul_rn(v, recip);
  const float c = fminf(fmaxf(q, -127.f), 127.f);
  const float t = __fadd_rn(c, 12582912.f);
  const float k = __fsub_rn(t, 12582912.f);
  exact = exact && fabsf(__fsub_rn(c, k)) < 0.5f - 0x1p-14f && q == q;
  return __float_as_uint(t);
}

// Four codes' low bytes packed, the first in the lowest byte.
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

// d += a . b, m64n128k32, s8 x s8 -> s32: A (64 x 32) from registers, four per
// thread (the m16n8k32 A fragment of each warp's 16 rows); B (128 x 32, K-major)
// from shared memory through the descriptor.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Quantize the block's x patch (pix pixels of BK channels in T, dense, as
// TMA wrote it) into an s8 patch (SQ_STRIDE bytes a pixel), by the
// QUANT_THREADS quantizer threads.  Each thread takes 16-byte pieces of x,
// four loads before their four stores; its piece index within a pixel,
// and so its channels, are the same on every iteration.
template <typename T>
constexpr int PIECE_ELEMS = 16 / (int)sizeof(T);  // x elements a 16-byte piece

// Static scales: the reciprocal scales of quantizer thread qt's channels in
// the chunk from c0 (0 past Cin, where x is 0), loaded before the chunk's
// patch lands.
template <typename T>
__device__ __forceinline__ void load_inv(float (&inv)[PIECE_ELEMS<T>],
                                         const float* __restrict__ inv_a, int c0, int cin,
                                         int qt) {
  constexpr int PIECES = BK * (int)sizeof(T) / 16;  // pieces a pixel
  const int j = qt % PIECES;
#pragma unroll
  for (int e = 0; e < PIECE_ELEMS<T>; ++e) {
    const int ci = c0 + j * PIECE_ELEMS<T> + e;
    inv[e] = ci < cin ? inv_a[ci] : 0.f;
  }
}

template <typename T, bool DYN>
__device__ __forceinline__ void quantize_patch(const unsigned char* __restrict__ xs,
                                               unsigned char* __restrict__ sq, int pix,
                                               int qt, const float (&inv)[PIECE_ELEMS<T>],
                                               float scale, float recip) {
  constexpr int EPT = PIECE_ELEMS<T>;
  constexpr int PIECES = BK * (int)sizeof(T) / 16;   // pieces a pixel
  constexpr int UNROLL = 4;
  static_assert(QUANT_THREADS % PIECES == 0, "a thread keeps its channels");
  const int j = qt % PIECES;
  const int total = pix * PIECES;
  for (int i0 = qt; i0 < total; i0 += UNROLL * QUANT_THREADS) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * QUANT_THREADS;
      raw[u] = i < total ? *reinterpret_cast<const uint4*>(xs + (size_t)i * 16)
                         : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * QUANT_THREADS;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      uint32_t bits[EPT];
      bool exact = true;
#pragma unroll
      for (int l = 0; l < EPT; ++l)
        bits[l] = DYN ? quotient_code_bits(to_float(e[l]), recip, exact)
                      : code_bits(__fmul_rn(to_float(e[l]), inv[l]));
      if (DYN && !exact) {  // rare: the piece again, by the correctly rounded division
#pragma unroll
        for (int l = 0; l < EPT; ++l) bits[l] = code_bits(__fdiv_rn(to_float(e[l]), scale));
      }
      uint32_t word[EPT / 4];
#pragma unroll
      for (int k = 0; k < EPT / 4; ++k)
        word[k] = pack4(bits[4 * k], bits[4 * k + 1], bits[4 * k + 2], bits[4 * k + 3]);
      if (i < total) {
        unsigned char* dst = sq + (i / PIECES) * SQ_STRIDE + j * EPT;
        if constexpr (EPT == 8)
          *reinterpret_cast<uint2*>(dst) = make_uint2(word[0], word[1]);
        else
          *reinterpret_cast<uint32_t*>(dst) = word[0];
      }
    }
  }
}

// The epilogue: the consumers' accumulator rows (the m64nN s32 layout: warp
// wq of a warpgroup owns rows 16 wq .. 16 wq + 15; acc[4 j + 2 h + e] is
// row (lane / 4) + 8 h, column 8 j + 2 (lane % 4) + e) to NHWC outputs,
// rescaled as s8conv's epilogue does with the block's column scales
// (a_scale * w_scale, or w_scale) and biases.  Where an output row is a
// whole number of 16-byte vectors, the values go through the idle x patch
// buffer (`stage`, rows padded so that a store's 8 rows fall in distinct
// banks) and leave as 16-byte vectors, a pixel's channels contiguous; else
// two channels a store from the fragments.
template <typename O>
__device__ __forceinline__ void store_tile(const int (&acc)[NACC], const Params& p,
                                           int row_base, int b, int h0, int w0, int n0,
                                           const float* col_scale, const float* col_bias,
                                           unsigned char* stage) {
  constexpr int ES = (int)sizeof(O);
  constexpr int LD = BN * ES + 8 * ES;  // bytes a staged row
  const int lane = threadIdx.x & 31;
  O* out = static_cast<O*>(p.out);
  const bool staged = p.cout * ES % 16 == 0;
  const bool pairs = p.cout % 2 == 0;
  const bool has_bias = p.bias != nullptr;
  auto value = [&](int a, int nl) -> float {
    const float accf = __int2float_rn(a);
    return has_bias ? __fmaf_rn(accf, col_scale[nl], col_bias[nl])
                    : __fmul_rn(accf, col_scale[nl]);
  };
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = row_base + (lane >> 2) + 8 * half;
    const int r = m / p.tw;
    const int h = h0 + r, w = w0 + m - r * p.tw;
    const bool inside = m < p.rows * p.tw && h < p.height && w < p.width;
    O* orow = out + (((long long)b * p.height + h) * p.width + w) * p.cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int nl = 8 * j + 2 * (lane & 3);  // column within the block
      const int n = n0 + nl;
      const int a0 = acc[4 * j + 2 * half], a1 = acc[4 * j + 2 * half + 1];
      if (staged) {
        O* dst = reinterpret_cast<O*>(stage + m * LD) + nl;
        if constexpr (std::is_same<O, int>::value) {
          *reinterpret_cast<int2*>(dst) = make_int2(a0, a1);
        } else {
          s8conv::store2<O>(dst, value(a0, nl), value(a1, nl + 1));
        }
        continue;
      }
      if (!inside || n >= p.cout) continue;
      if constexpr (std::is_same<O, int>::value) {
        orow[n] = a0;
        if (n + 1 < p.cout) orow[n + 1] = a1;
      } else {
        const float v0 = value(a0, nl), v1 = value(a1, n + 1 < p.cout ? nl + 1 : nl);
        if (pairs) {
          s8conv::store2<O>(orow + n, v0, v1);
        } else {
          orow[n] = s8conv::round_to<O>(v0);
          if (n + 1 < p.cout) orow[n + 1] = s8conv::round_to<O>(v1);
        }
      }
    }
  }
  if (!staged) return;
  named_sync(1, CONSUMER_THREADS);  // the staged tile is complete
  constexpr int VPR = BN * ES / 16;  // 16-byte vectors a full staged row
  const int vectors = (p.cout - n0 < BN ? p.cout - n0 : BN) * ES / 16;
  const int ctid = threadIdx.x - (THREADS - CONSUMER_THREADS);
  for (int i = ctid; i < TILE_M * VPR; i += CONSUMER_THREADS) {
    const int m = i / VPR, v = i % VPR;
    const int r = m / p.tw;
    const int h = h0 + r, w = w0 + m - r * p.tw;
    if (v >= vectors || m >= p.rows * p.tw || h >= p.height || w >= p.width) continue;
    const long long pixel = ((long long)b * p.height + h) * p.width + w;
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(out + pixel * p.cout + n0) +
                              16 * v) = *reinterpret_cast<const uint4*>(stage + m * LD + 16 * v);
  }
}

// The maximum of example b's partial maxima of |x|, by the n threads (n >=
// nparts, a multiple of 32) of named barrier `bar`; red holds n / 32 floats.
__device__ __forceinline__ float example_absmax(const Params& p, int b, int tid, int n, int bar,
                                                float* red) {
  float v = tid < p.nparts ? p.parts[(long long)b * p.nparts + tid] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((tid & 31) == 0) red[tid >> 5] = v;
  named_sync(bar, n);
  float m = red[0];
  for (int i = 1; i < n / 32; ++i) m = fmaxf(m, red[i]);
  return m;
}

// One block: output pixels rows x tw of example b from (h0, w0), output
// channels n0 .. n0 + BN.  Three roles, each its own loop:
//   warp 0, one thread  the producer: every TMA load, the x patch of chunk
//                       c + 1 ahead of the nine weight tiles of chunk c;
//   warps 1..7          the quantizers: x patch -> s8 patch, one chunk
//                       ahead of the consumers;
//   warpgroups 2, 3     the consumers, 64 output rows each: per tap two
//                       ldmatrix.x4 of the shifted s8 rows and two
//                       wgmma.m64n128k32, one k32 step left in flight.
// Slots are handed over by mbarriers: weight stages (full: TMA bytes;
// empty: the eight consumer warps), x patches and s8 patches (a barrier
// pair each for the even and the odd chunks, waited on in chunk order).
// ptxas compiles every role within the launch bound's 128 registers a
// thread (setmaxnreg moves registers at run time but does not raise that
// bound), so the consumers hold 64 accumulators and three A sets.
template <typename T, bool DYN>
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
            const Params p) {
  constexpr int XS = x_stages<T>();
  constexpr int XB = x_patch_bytes<T>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ float col_scale[BN], col_bias[BN];  // the epilogue's, per block column
  unsigned char* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bs = smem;                        // B_STAGES weight tiles
  unsigned char* xs = bs + B_STAGES * B_TILE;      // XS x patches
  unsigned char* sq = xs + XS * XB;                // two s8 patches
  uint64_t* b_full = reinterpret_cast<uint64_t*>(sq + 2 * SQ_BYTES);
  uint64_t* b_empty = b_full + B_STAGES;
  uint64_t* x_full = b_empty + B_STAGES;  // [c & 1]: patch of chunk c landed
  uint64_t* x_empty = x_full + 2;         // [c & 1]: patch of chunk c quantized
  uint64_t* s_full = x_empty + 2;         // [c & 1]: codes of chunk c written
  uint64_t* s_empty = s_full + 2;         // [c & 1]: codes of chunk c read
  float* red = reinterpret_cast<float*>(s_empty + 2);  // 8 consumer + 7 quantizer slots

  int bid = blockIdx.x;
  const int nt = bid % p.tiles_n;
  bid /= p.tiles_n;
  const int twi = bid % p.tiles_w;
  bid /= p.tiles_w;
  const int thi = bid % p.tiles_h;
  const int b = bid / p.tiles_h;
  const int h0 = thi * p.rows, w0 = twi * p.tw, n0 = nt * BN;
  const int pw = p.tw + 2;
  const int pix = (p.rows + 2) * pw;

  if (threadIdx.x == 0) {
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], CONSUMER_THREADS / 32);  // one arrival a consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&x_full[i], 1);
      mbar_init(&x_empty[i], 1);
      mbar_init(&s_full[i], 1);
      mbar_init(&s_empty[i], CONSUMER_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    // ---- producer
    if (threadIdx.x == 0) {
      const unsigned patch_bytes = (unsigned)(pix * BK * (int)sizeof(T));
      auto load_patch = [&](int c) {
        if (c >= XS) mbar_wait(&x_empty[(c - XS) & 1], ((c - XS) >> 1) & 1);
        mbar_expect_tx(&x_full[c & 1], patch_bytes);
        tma_load_4d(xs + (c % XS) * XB, &xmap, &x_full[c & 1], c * BK, w0 - 1, h0 - 1, b);
      };
      load_patch(0);
      int s = 0, phase = 0;  // weight stage and its round's parity
      for (int c = 0; c < p.chunks; ++c) {
        if (c + 1 < p.chunks) load_patch(c + 1);
        for (int t = 0; t < TAPS; ++t) {
          mbar_wait(&b_empty[s], phase ^ 1);
          mbar_expect_tx(&b_full[s], B_TILE);
          tma_load_2d(bs + s * B_TILE, &wmap, &b_full[s], t * p.cin + c * BK, n0);
          if (++s == B_STAGES) s = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  if (threadIdx.x < 32 + QUANT_THREADS) {
    // ---- quantizers
    const int qt = threadIdx.x - 32;
    float scale = 1.f, recip = 1.f;
    if constexpr (DYN) {
      scale = dynamic_scale(example_absmax(p, b, qt, QUANT_THREADS, 2, red + 8));
      recip = __frcp_rn(scale);
    }
    float inv[PIECE_ELEMS<T>] = {};
    for (int c = 0; c < p.chunks; ++c) {
      if constexpr (!DYN) load_inv<T>(inv, p.inv_a, c * BK, p.cin, qt);
      mbar_wait(&x_full[c & 1], (c >> 1) & 1);
      if (c >= 2) mbar_wait(&s_empty[c & 1], ((c - 2) >> 1) & 1);
      quantize_patch<T, DYN>(xs + (c % XS) * XB, sq + (c & 1) * SQ_BYTES, pix, qt, inv, scale,
                             recip);
      named_sync(2, QUANT_THREADS);  // every quantizer's codes are written
      if (qt == 0) {
        mbar_arrive(&x_empty[c & 1]);
        mbar_arrive(&s_full[c & 1]);
      }
    }
    return;
  }

  // ---- consumers
  const int ctid = threadIdx.x - 32 - QUANT_THREADS;
  const int lane = ctid & 31;
  const int row_base = (ctid >> 7) * 64 + ((ctid >> 5) & 3) * 16;  // this warp's 16 rows
  {
    float a_scale = 1.f;
    if constexpr (DYN) {
      const float m = example_absmax(p, b, ctid, CONSUMER_THREADS, 1, red);
      a_scale = dynamic_scale(m);
      if (ctid == 0 && nt == 0 && thi == 0 && twi == 0) p.absmax[b] = m;
    }
    if (ctid < BN) {
      const int n = n0 + ctid;
      col_scale[ctid] = n < p.cout ? (DYN ? __fmul_rn(a_scale, p.w_scale[n]) : p.w_scale[n])
                                   : 0.f;
      col_bias[ctid] = n < p.cout && p.bias != nullptr ? p.bias[n] : 0.f;
    }
  }

  // The A rows of this lane: tile pixel m -> patch pixel (r, c); each tap
  // adds (dy * pw + dx) pixels.  Lanes 16..31 read the row's second 16 bytes.
  const int m = row_base + (lane & 15);
  const int r = m / p.tw;
  const int prow = m < p.rows * p.tw ? r * pw + (m - r * p.tw) : 0;
  const int a_off = prow * SQ_STRIDE + (lane >> 4) * 16;
  const uint32_t b_base = tc::smem_u32(bs);

  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  uint32_t a[A_SETS][2][4];

  int s = 0, phase = 0, prev = -1;  // weight stage, its parity, the previous tap's stage
  for (int c = 0; c < p.chunks; ++c) {
    mbar_wait(&s_full[c & 1], (c >> 1) & 1);
    const unsigned char* a_base = sq + (c & 1) * SQ_BYTES + a_off;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      mbar_wait(&b_full[s], phase);
      const unsigned char* row = a_base + ((t / 3) * pw + t % 3) * SQ_STRIDE;
      tc::ldsm_x4(a[t % A_SETS][0], row);
      tc::ldsm_x4(a[t % A_SETS][1], row + 32);
      if (t == TAPS - 1) {  // this warp is done with the chunk's codes
        __syncwarp();
        if (lane == 0) mbar_arrive(&s_empty[c & 1]);
      }
      const uint64_t desc = b_desc(b_base + s * B_TILE);
      // One commit group a k32 step, one group left in flight: with both
      // steps of a tap in one group ptxas serializes every wgmma (C7513).
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int i = 0; i < NACC; ++i) fence_reg(acc[i]);
        wgmma_fence();
        wgmma_m64n128k32(acc, a[t % A_SETS][k], desc + k * (32 >> 4));
        wgmma_commit();
        wgmma_wait<1>();
      }
#pragma unroll
      for (int i = 0; i < NACC; ++i) fence_reg(acc[i]);
      // the previous tap's products are done: its stage is free
      if (lane == 0 && prev >= 0) mbar_arrive(&b_empty[prev]);
      prev = s;
      if (++s == B_STAGES) s = 0, phase ^= 1;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NACC; ++i) fence_reg(acc[i]);

  named_sync(1, CONSUMER_THREADS);  // col_scale and col_bias are in place
  switch (p.out_dtype) {
    case 0: store_tile<float>(acc, p, row_base, b, h0, w0, n0, col_scale, col_bias, xs);
      break;
    case 1: store_tile<__nv_bfloat16>(acc, p, row_base, b, h0, w0, n0, col_scale, col_bias, xs);
      break;
    case 2: store_tile<__half>(acc, p, row_base, b, h0, w0, n0, col_scale, col_bias, xs);
      break;
    default: store_tile<int>(acc, p, row_base, b, h0, w0, n0, col_scale, col_bias, xs);
      break;
  }
}

template <typename T, bool DYN>
cudaError_t launch_conv(const CUtensorMap& xmap, const CUtensorMap& wmap, const Params& p,
                        long long blocks, cudaStream_t stream) {
  auto kernel = conv_kernel<T, DYN>;
  constexpr size_t smem = smem_bytes<T>();
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(xmap, wmap, p);
  return cudaGetLastError();
}

template <typename T>
int fused(const void* x, const int8_t* wq, const float* inv_a, float* absmax, float* parts,
          const float* w_scale, const float* bias, void* out, int out_dtype, int batch,
          int height, int width, int cin, int cout, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return NO_ENCODER;
  constexpr CUtensorMapDataType xtype =
      std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long es = sizeof(T);
  Params p{};
  p.tw = width < TILE_W ? width : TILE_W;
  p.rows = TILE_M / p.tw;
  p.tiles_w = (width + p.tw - 1) / p.tw;
  p.tiles_h = (height + p.rows - 1) / p.rows;
  p.tiles_n = (cout + BN - 1) / BN;
  p.chunks = (cin + BK - 1) / BK;
  p.height = height, p.width = width, p.cin = cin, p.cout = cout;
  p.inv_a = inv_a, p.absmax = absmax, p.parts = parts, p.w_scale = w_scale, p.bias = bias;
  p.out = out, p.out_dtype = out_dtype;
  const long long blocks = (long long)batch * p.tiles_h * p.tiles_w * p.tiles_n;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  // x as (C, W, H, B); a box of BK channels x (tw + 2) x (rows + 2) x 1
  // read from (c0, w0 - 1, h0 - 1, b): the halo patch, zero-filled outside
  // the image (SAME padding) and past Cin.
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {(cuuint64_t)cin, (cuuint64_t)width, (cuuint64_t)height,
                              (cuuint64_t)batch};
  const cuuint64_t xstride[3] = {(cuuint64_t)(cin * es), (cuuint64_t)(width * cin * es),
                                 (cuuint64_t)((long long)height * width * cin * es)};
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)(p.tw + 2), (cuuint32_t)(p.rows + 2), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult res = encode(&xmap, xtype, 4, const_cast<void*>(x), xdim, xstride, xbox, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(res);
  // the weight as (9 Cin, Cout) bytes; a box of BK x BN, 64-byte swizzle
  const cuuint64_t wdim[2] = {(cuuint64_t)(9LL * cin), (cuuint64_t)cout};
  const cuuint64_t wstride[1] = {(cuuint64_t)(9LL * cin)};
  const cuuint32_t wbox[2] = {BK, BN};
  res = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(wq), wdim, wstride,
               wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(res);

  if (inv_a == nullptr) {
    const long long per_example = (long long)height * width * cin;  // % 16 == 0
    const long long want = (per_example / QCHUNK + QTHREADS - 1) / QTHREADS;
    p.nparts = (int)(want < ABSMAX_PARTS ? want : ABSMAX_PARTS);
    absmax_kernel<T, true, true><<<dim3(p.nparts, batch), QTHREADS, 0, stream>>>(
        static_cast<const T*>(x), parts, per_example);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch_conv<T, true>(xmap, wmap, p, blocks, stream));
  }
  return static_cast<int>(launch_conv<T, false>(xmap, wmap, p, blocks, stream));
}

}  // namespace s8wgmma

}  // namespace

// Quantize x (B, H, W, C) of dtype (0 float32, 1 bfloat16, 2 float16),
// contiguous, into int8 codes q (same shape).  inv_a NULL: dynamic scales,
// absmax (B,) float32 receives each example's max |x| (the conv's epilogue
// reads it); else static scales inv_a (C,) float32.  per_example = H*W*C.
extern "C" int mudiff_int8_quantize(const void* x, int dtype, const float* inv_a, float* absmax,
                                    int8_t* q, int batch, long long per_example, int channels,
                                    void* stream) {
  if (batch <= 0 || batch > 65535 || per_example <= 0 || channels <= 0 ||
      per_example % channels != 0 || (inv_a == nullptr && absmax == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(quantize<float>(x, inv_a, absmax, q, batch, per_example,
                                                    channels, s));
    case 1: return static_cast<int>(quantize<__nv_bfloat16>(x, inv_a, absmax, q, batch,
                                                            per_example, channels, s));
    case 2: return static_cast<int>(quantize<__half>(x, inv_a, absmax, q, batch, per_example,
                                                     channels, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The s8 conv of codes q (B, H, W, Cin) int8 with wq (Cout, 9*Cin) int8
// (K contiguous, tap-major), both contiguous.  absmax (B,) float32 from
// mudiff_int8_quantize for dynamic scales, or NULL for static ones;
// w_scale (Cout,) float32; bias (Cout,) float32 or NULL.  out (B, H, W,
// Cout) of out_dtype: 0 float32, 1 bfloat16, 2 float16, or 3 int32 (the raw
// accumulator).  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int mudiff_int8_conv3x3(const int8_t* q, const int8_t* wq, const float* absmax,
                                   const float* w_scale, const float* bias, void* out,
                                   int out_dtype, int batch, int height, int width, int cin,
                                   int cout, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0 || cin <= 0 || cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return static_cast<int>(s8conv::launch<float>(q, wq, absmax, w_scale, bias, out,
                                                          batch, height, width, cin, cout, s));
    case 1: return static_cast<int>(s8conv::launch<__nv_bfloat16>(
        q, wq, absmax, w_scale, bias, out, batch, height, width, cin, cout, s));
    case 2: return static_cast<int>(s8conv::launch<__half>(q, wq, absmax, w_scale, bias, out,
                                                           batch, height, width, cin, cout, s));
    case 3: return static_cast<int>(s8conv::launch<int>(q, wq, absmax, w_scale, bias, out,
                                                        batch, height, width, cin, cout, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fused W8A8 conv of x (B, H, W, Cin) of x_dtype (0 float32, 1
// bfloat16, 2 float16), contiguous, with wq (Cout, 9*Cin) int8 (K
// contiguous, tap-major): the quantize happens in the conv (the codes never
// reach device memory).  inv_a (Cin,) float32 for static scales (one
// launch), or NULL for dynamic ones: then absmax (B,) float32 receives each
// example's max |x| and parts (B, 128) float32 is scratch (two launches:
// the partial maxima, then the conv).  w_scale, bias, out and out_dtype as
// mudiff_int8_conv3x3's.  Needs Cin % 16 == 0 and 16-byte aligned x and wq
// (the tensor maps' strides and addresses) and a 16-byte aligned out (its
// vector stores).  Returns 0, a cudaError_t, or
// 10000 (no cuTensorMapEncodeTiled in the driver) or 20000 + CUresult (a
// tensor map refused).
extern "C" int mudiff_int8_conv3x3_fused(const void* x, int x_dtype, const int8_t* wq,
                                         const float* inv_a, float* absmax, float* parts,
                                         const float* w_scale, const float* bias, void* out,
                                         int out_dtype, int batch, int height, int width,
                                         int cin, int cout, void* stream) {
  if (batch <= 0 || batch > 65535 || height <= 0 || width <= 0 || cin <= 0 || cout <= 0 ||
      cin % 16 != 0 || out_dtype < 0 || out_dtype > 3 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (inv_a == nullptr && (absmax == nullptr || parts == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return s8wgmma::fused<float>(x, wq, inv_a, absmax, parts, w_scale, bias, out,
                                         out_dtype, batch, height, width, cin, cout, s);
    case 1: return s8wgmma::fused<__nv_bfloat16>(x, wq, inv_a, absmax, parts, w_scale, bias,
                                                 out, out_dtype, batch, height, width, cin,
                                                 cout, s);
    case 2: return s8wgmma::fused<__half>(x, wq, inv_a, absmax, parts, w_scale, bias, out,
                                          out_dtype, batch, height, width, cin, cout, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
