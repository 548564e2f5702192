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
// Cin = Cout = 256.  The quantize passes are bound by bytes.
//
// Three kernels, launched by two entry points on the caller's stream:
//
// * absmax_kernel (dynamic only): per-example max |x| over H*W*C; blocks of
//   a 2-D grid (chunks, B) reduce 16-byte vectors, then one atomicMax on the
//   float's bits (all values >= 0, so the integer order is the float order).
// * quantize_kernel: one thread per 16 elements writes one 16-byte chunk of
//   int8 codes (a scalar path when the sizes are not multiples of 16).
// * s8conv::conv_kernel: an implicit GEMM on the tensor cores,
//   mma.sync.m16n8k32 s8 x s8 -> s32.  M = B*H*W output pixels, N = Cout,
//   K = 9*Cin ordered tap-major (dy, dx, ci).  The weight comes as a (Cout,
//   9*Cin) int8 matrix with K contiguous (the wrapper transposes the HWIO
//   codes once and caches them), so both operand tiles are K-contiguous rows
//   in shared memory and both load with ldmatrix without a transpose (the
//   b16 transpose of K1's weight tile does not apply to bytes).  The rest is
//   K1's skeleton (conv3x3_kernel.cu): a block owns BM x BN outputs and walks
//   K in steps of BK channels of one tap through a STAGES-deep ring of
//   16-byte cp.async copies (16 int8 channels a copy), halos and channel
//   tails zero-filled (code 0 is the value 0); eight warps own 64 x 32
//   sub-tiles.  Cin % 16 != 0 packs K across taps and loads both tiles with
//   scalar loads.  The epilogue rescales and adds the bias in fp32 and
//   stores from the fragments (or the raw s32 accumulator, for the checks).

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
// 16-element chunks.  Else one element at a time.
template <typename T, bool VEC>
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
    if (lane == 0) atomicMax(reinterpret_cast<unsigned int*>(absmax) + b, __float_as_uint(m));
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
