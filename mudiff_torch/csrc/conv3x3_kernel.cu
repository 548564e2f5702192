// 3x3 stride-1 SAME convolution, NHWC input x HWIO weight: kernel K1.
//
// Replaces the Pallas implicit-GEMM conv of the JAX package
// (mudiff_tpu/ops/pallas_conv.py:375 conv3x3_gemm -> _conv3x3_pallas,
// kernel bodies _conv_kernel / _conv_kernel_dxk, pallas_call at :293).
// Same function: out[n,h,w,co] = bias[co] + sum_{dy,dx,ci}
// x[n,h+dy-1,w+dx-1,ci] * W[dy,dx,ci,co], accumulated in fp32, the fp32
// bias added to the accumulator, the output rounded once to the input
// dtype.
//
// What bounds it on an H100: operations.  At the model's shapes
// (Cin, Cout >= 64) a conv does ~9*Cin*Cout*2 / ((Cin+Cout)*2) >= 290
// flops per byte moved, above the card's bf16 ridge (~295 flop/B), so
// the floor is the tensor-core rate.
//
// Two hand-written kernels, chosen by dtype in mudiff_conv3x3:
//
// * bf16 / fp16: conv3x3_kernel_tc, an implicit GEMM on the tensor cores.
//   M = B*H*W output pixels, N = Cout, K = 9*Cin ordered tap-major
//   (dy, dx, ci): the HWIO weight's own order, so the weight is a
//   (9*Cin, Cout) row-major matrix and a K step's weight tile is a slab
//   of it.  A block owns a BM x BN output tile (BM consecutive pixels in
//   NHWC order, any H and W) and walks K in steps of BK (64 for Cout > 64,
//   else 32).  Each step gathers the A tile (the im2col rows of its
//   pixels for one tap and a BK-channel chunk) and the B tile (weights)
//   into shared memory with 16-byte cp.async in a STAGES-deep ring; halo
//   pixels outside the image and channel tails use the zero-fill form,
//   so no padded copy goes to HBM.  Eight warps each own a 64 x 32 sub-tile: ldmatrix
//   loads the fragments and mma.sync.m16n8k16 accumulates in fp32
//   registers.  The epilogue adds the bias, rounds once, stages the tile
//   in shared memory and stores it with 16-byte row-contiguous writes.
//   Wide channels (Cin % 8 == 0) pad K per tap to a multiple of BK.  The
//   narrow-channel path (the stems' Cin = 4 / 5, the head's dx Cin = 1)
//   packs K = 9*Cin without padding and loads A with scalar loads into
//   the same layout; Cout % 8 != 0 (the head's Cout = 1, the stem's dx
//   Cout = 5) loads B and stores the output with scalar accesses.  Both
//   are template parameters chosen at launch.
//
// * fp32: conv3x3_kernel_fma, a direct conv on the CUDA cores in fp32
//   FMA, used by --no_bf16, the checks and fp32 training (TF32 would not
//   meet their tolerances).  One block computes a TH x TW tile of output
//   pixels for TCO output channels; per chunk of CI input channels it
//   stages the input tile with its halo and the chunk's 9 x CI x TCO
//   weights in shared memory; each thread owns PX pixels of one row times
//   CO channels in registers.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

// ---------------------------------------------------------------- fp32 FMA

namespace ffma {

constexpr int TH = 8;         // output tile rows
constexpr int TW = 16;        // output tile columns
constexpr int TCO = 64;       // output channels per block
constexpr int CI = 16;        // input channels staged per pass
constexpr int PX = 8;         // output pixels per thread (one row segment)
constexpr int CO = 4;         // output channels per thread
constexpr int THREADS = (TH * TW / PX) * (TCO / CO);  // 256

static_assert(TW % PX == 0, "a thread's pixels lie in one tile row");
static_assert(TCO % CO == 0, "channel groups tile TCO");

__global__ void __launch_bounds__(THREADS)
conv3x3_kernel_fma(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int height, int width, int cin, int cout, int tiles_w) {
  __shared__ float xs[CI][TH + 2][TW + 2];            // 11,520 B
  __shared__ __align__(16) float ws[9][CI][TCO];      // 36,864 B

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * TCO;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;

  constexpr int GROUPS_CO = TCO / CO;                 // 16
  const int cg = tid % GROUPS_CO;                     // channels co0+cg*CO ..
  const int pg = tid / GROUPS_CO;                     // pixel group
  const int prow = pg / (TW / PX);                    // tile row
  const int pcol = (pg % (TW / PX)) * PX;             // first tile column

  float acc[PX][CO];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[p][j] = 0.f;

  const float* xn = x + (size_t)n * height * width * cin;

  for (int ci0 = 0; ci0 < cin; ci0 += CI) {
    // input tile + halo, channel fastest (coalesced along NHWC channels)
    for (int i = tid; i < (TH + 2) * (TW + 2) * CI; i += THREADS) {
      const int c = i % CI;
      const int pix = i / CI;
      const int py = pix / (TW + 2);
      const int px = pix % (TW + 2);
      const int gy = y0 + py - 1;
      const int gx = x0 + px - 1;
      const int gc = ci0 + c;
      float v = 0.f;
      if (gy >= 0 && gy < height && gx >= 0 && gx < width && gc < cin)
        v = xn[((size_t)gy * width + gx) * cin + gc];
      xs[c][py][px] = v;
    }
    // weights W[tap][ci0 + c][co0 + co], output channel fastest
    for (int i = tid; i < 9 * CI * TCO; i += THREADS) {
      const int co = i % TCO;
      const int r = i / TCO;
      const int c = r % CI;
      const int tap = r / CI;
      const int gc = ci0 + c;
      const int gco = co0 + co;
      float v = 0.f;
      if (gc < cin && gco < cout) v = w[((size_t)tap * cin + gc) * cout + gco];
      ws[tap][c][co] = v;
    }
    __syncthreads();

    const int cmax = min(CI, cin - ci0);
    for (int c = 0; c < cmax; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float row[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) row[j] = xs[c][prow + dy][pcol + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(&ws[dy * 3 + dx][c][cg * CO]);
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            const float xv = row[p + dx];
            acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = y0 + prow;
  if (oy >= height) return;
  float bv[CO];
#pragma unroll
  for (int j = 0; j < CO; ++j) {
    const int co = co0 + cg * CO + j;
    bv[j] = (bias != nullptr && co < cout) ? bias[co] : 0.f;
  }
  float* orow = out + ((size_t)n * height + oy) * width * cout;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int ox = x0 + pcol + p;
    if (ox >= width) break;
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const int co = co0 + cg * CO + j;
      if (co < cout) orow[(size_t)ox * cout + co] = acc[p][j] + bv[j];
    }
  }
}

cudaError_t launch(const float* x, const float* w, const float* bias, float* out, int batch,
                   int height, int width, int cin, int cout, cudaStream_t stream) {
  if (batch > 65535) return cudaErrorInvalidValue;
  const int tiles_h = (height + TH - 1) / TH;
  const int tiles_w = (width + TW - 1) / TW;
  const dim3 grid(tiles_h * tiles_w, (cout + TCO - 1) / TCO, batch);
  conv3x3_kernel_fma<<<grid, THREADS, 0, stream>>>(x, w, bias, out, height, width, cin, cout,
                                                   tiles_w);
  return cudaGetLastError();
}

}  // namespace ffma

// ------------------------------------------------------ bf16/fp16 tensor cores

namespace tcconv {

constexpr int THREADS = 256;  // eight warps
constexpr int PAD = 8;        // 16-bit elements of padding per shared row

// A block tile of BM pixels x BN output channels; WM x WN warps, each a
// (BM / WM) x (BN / WN) = 64 x 32 sub-tile; K steps of BK (one tap, BK
// input channels) through a STAGES-deep cp.async ring.
template <int BM_, int BN_, int WM_, int WN_, int BK_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int BK = BK_, STAGES = STAGES_;
  static constexpr int TM = BM / WM, TN = BN / WN;   // warp sub-tile
  static constexpr int MT = TM / 16, NT = TN / 8;    // mma tiles per warp
  static constexpr int LDA = BK + PAD;               // A row
  static constexpr int LDB = BN + PAD;               // B row
  static constexpr int LDO = BN + PAD;               // epilogue row
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int RING = STAGES * STAGE, OUT = BM * LDO;
  static constexpr size_t SMEM = 2 * (size_t)(RING > OUT ? RING : OUT);
  static_assert(WM * WN * 32 == THREADS, "eight warps");
  static_assert(TM % 16 == 0 && TN % 16 == 0, "whole x4 fragment loads");
  static_assert(BM * (BK / 8) % THREADS == 0 && BK * BN / 8 % THREADS == 0,
                "16-byte chunks divide among the threads");
  static_assert(SMEM <= 232448, "tile exceeds the 227 KB a block may use");
};
// Both fit two blocks on an SM.  A K step of 64 through 3 stages beat 32
// through 4 on the card at Cout >= 128 and lost at Cout = 64 (PERF.md);
// either way each output sums its k16 slices in the same order.
using TileN128 = Tile<128, 128, 2, 4, 64, 3>;  // Cout > 64: 105 KB of ring
using TileN64 = Tile<256, 64, 4, 2, 32, 4>;    // Cout <= 64: 100.4 KB of ring

// AVEC: Cin % 8 == 0 and x 16-byte aligned (16-byte copies, K padded per
// tap), else scalar loads with K packed.  BVEC: Cout % 8 == 0 and w, out
// 16-byte aligned (16-byte weight copies and output stores), else scalar.
template <typename T, class TL, bool AVEC, bool BVEC>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel_tc(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, int M, int height,
                  int width, int cin, int cout, int tiles_n, int chunks, int ksteps) {
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, STAGES = TL::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / TL::WN;
  const int warp_n = warp % TL::WN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int hw = height * width;

  // The A rows this thread copies (16-byte path): pixel index and (h, w)
  // of each; rows past M get h far outside so every tap is zero-filled.
  constexpr int A_CPR = BK / 8;                 // 16-byte chunks per A row
  constexpr int A_ITERS = BM * A_CPR / THREADS;
  constexpr int A_RSTEP = THREADS / A_CPR;
  const int a_chunk = tid % A_CPR;
  const int a_row0 = tid / A_CPR;
  int a_m[AVEC ? A_ITERS : 1], a_h[AVEC ? A_ITERS : 1], a_w[AVEC ? A_ITERS : 1];
  if constexpr (AVEC) {
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int m = m0 + a_row0 + i * A_RSTEP;
      const int rem = m % hw;
      a_m[i] = m;
      a_h[i] = m < M ? rem / width : -4;
      a_w[i] = rem % width;
    }
  }

  // Copy K step s into ring stage st.
  auto load_stage = [&](int st, int s) {
    T* as = smem + st * TL::STAGE;
    T* bs = as + TL::A_ELEMS;
    // the K step's weight rows: wrow0 + kk for kk < klimit
    int tap = 0, ci0 = 0, wrow0, klimit;
    if constexpr (AVEC) {
      tap = s / chunks;
      ci0 = (s - tap * chunks) * BK;
      wrow0 = tap * cin + ci0;
      klimit = cin - ci0;
    } else {
      wrow0 = s * BK;
      klimit = 9 * cin - wrow0;
    }
    if constexpr (AVEC) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const int ci = ci0 + a_chunk * 8;
      const long long delta = ((long long)dy * width + dx) * cin + ci;
#pragma unroll
      for (int i = 0; i < A_ITERS; ++i) {
        const int hh = a_h[i] + dy, ww = a_w[i] + dx;
        const bool valid = hh >= 0 && hh < height && ww >= 0 && ww < width && ci < cin;
        const T* src = valid ? x + ((long long)a_m[i] * cin + delta) : x;
        tc::cp_async16(as + (a_row0 + i * A_RSTEP) * TL::LDA + a_chunk * 8, src, valid);
      }
    } else {
      // packed K: k = tap * cin + ci, scalar loads
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int k = wrow0 + kk;
        const int m = m0 + r;
        T v = tc::from_float<T>(0.f);
        if (k < 9 * cin && m < M) {
          const int t = k / cin, ci = k - t * cin;
          const int n = m / hw, rem = m - n * hw;
          const int hh = rem / width + t / 3 - 1, ww = rem % width + t % 3 - 1;
          if (hh >= 0 && hh < height && ww >= 0 && ww < width)
            v = x[(((long long)n * height + hh) * width + ww) * cin + ci];
        }
        as[r * TL::LDA + kk] = v;
      }
    }
    if constexpr (BVEC) {
      constexpr int B_CPR = BN / 8;
      constexpr int B_ITERS = BK * B_CPR / THREADS;
      constexpr int B_RSTEP = THREADS / B_CPR;
      const int c = (tid % B_CPR) * 8;
      const bool col_ok = n0 + c < cout;
#pragma unroll
      for (int i = 0; i < B_ITERS; ++i) {
        const int kk = tid / B_CPR + i * B_RSTEP;
        const bool valid = col_ok && kk < klimit;
        const T* src = valid ? w + ((long long)(wrow0 + kk) * cout + n0 + c) : w;
        tc::cp_async16(bs + kk * TL::LDB + c, src, valid);
      }
    } else {
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int kk = e / BN, nn = e % BN;
        T v = tc::from_float<T>(0.f);
        if (kk < klimit && n0 + nn < cout) v = w[(long long)(wrow0 + kk) * cout + n0 + nn];
        bs[kk * TL::LDB + nn] = v;
      }
    }
  };

  float acc[TL::MT][TL::NT][4];
#pragma unroll
  for (int i = 0; i < TL::MT; ++i)
#pragma unroll
    for (int j = 0; j < TL::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

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

    const T* as = smem + (s % STAGES) * TL::STAGE;
    const T* bs = as + TL::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[TL::MT][4];
#pragma unroll
      for (int i = 0; i < TL::MT; ++i)
        tc::ldsm_x4(af[i], as + (warp_m * TL::TM + i * 16 + (lane & 15)) * TL::LDA + kk +
                               (lane >> 4) * 8);
      uint32_t bf[TL::NT][2];
#pragma unroll
      for (int j = 0; j < TL::NT; j += 2) {
        uint32_t r[4];
        tc::ldsm_x4_t(r, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * TL::LDB +
                             warp_n * TL::TN + j * 8 + (lane >> 4) * 8);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < TL::MT; ++i)
#pragma unroll
        for (int j = 0; j < TL::NT; ++j) tc::mma16816<T>(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }

  // Epilogue: bias, one rounding, the tile staged in shared memory.
  tc::cp_async_wait<0>();
  __syncthreads();
  T* os = smem;
#pragma unroll
  for (int j = 0; j < TL::NT; ++j) {
    const int col = warp_n * TL::TN + j * 8 + (lane & 3) * 2;
    const int co = n0 + col;
    const float b0 = (bias != nullptr && co < cout) ? bias[co] : 0.f;
    const float b1 = (bias != nullptr && co + 1 < cout) ? bias[co + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < TL::MT; ++i) {
      const int row = warp_m * TL::TM + i * 16 + (lane >> 2);
      *reinterpret_cast<uint32_t*>(os + row * TL::LDO + col) =
          tc::pack2<T>(acc[i][j][0] + b0, acc[i][j][1] + b1);
      *reinterpret_cast<uint32_t*>(os + (row + 8) * TL::LDO + col) =
          tc::pack2<T>(acc[i][j][2] + b0, acc[i][j][3] + b1);
    }
  }
  __syncthreads();
  if constexpr (BVEC) {
    constexpr int CPR = BN / 8;
    for (int e = tid; e < BM * CPR; e += THREADS) {
      const int r = e / CPR, c = (e % CPR) * 8;
      const int m = m0 + r;
      if (m < M && n0 + c < cout)
        *reinterpret_cast<uint4*>(out + (long long)m * cout + n0 + c) =
            *reinterpret_cast<const uint4*>(os + r * TL::LDO + c);
    }
  } else {
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int m = m0 + r;
      if (m < M && n0 + c < cout) out[(long long)m * cout + n0 + c] = os[r * TL::LDO + c];
    }
  }
}

template <typename T, class TL, bool AVEC, bool BVEC>
cudaError_t launch_tile(const T* x, const T* w, const float* bias, T* out, int M, int height,
                        int width, int cin, int cout, cudaStream_t stream) {
  auto kernel = conv3x3_kernel_tc<T, TL, AVEC, BVEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(TL::SMEM));
  if (err != cudaSuccess) return err;
  const int chunks = (cin + TL::BK - 1) / TL::BK;
  const int ksteps = AVEC ? 9 * chunks : (9 * cin + TL::BK - 1) / TL::BK;
  const int tiles_n = (cout + TL::BN - 1) / TL::BN;
  const long long blocks = (long long)((M + TL::BM - 1) / TL::BM) * tiles_n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), THREADS, TL::SMEM, stream>>>(
      x, w, bias, out, M, height, width, cin, cout, tiles_n, chunks, ksteps);
  return cudaGetLastError();
}

template <typename T, class TL>
cudaError_t launch_paths(const T* x, const T* w, const float* bias, T* out, int M, int height,
                         int width, int cin, int cout, cudaStream_t stream) {
  const bool avec = cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool bvec = cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (avec && bvec)
    return launch_tile<T, TL, true, true>(x, w, bias, out, M, height, width, cin, cout, stream);
  if (avec)
    return launch_tile<T, TL, true, false>(x, w, bias, out, M, height, width, cin, cout, stream);
  if (bvec)
    return launch_tile<T, TL, false, true>(x, w, bias, out, M, height, width, cin, cout, stream);
  return launch_tile<T, TL, false, false>(x, w, bias, out, M, height, width, cin, cout, stream);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* bias, void* out, int batch,
                   int height, int width, int cin, int cout, cudaStream_t stream) {
  const long long m = (long long)batch * height * width;
  if (m > 0x7fffffffLL || 9LL * cin > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (cout <= 64)
    return launch_paths<T, TileN64>(xt, wt, bias, ot, (int)m, height, width, cin, cout, stream);
  return launch_paths<T, TileN128>(xt, wt, bias, ot, (int)m, height, width, cin, cout, stream);
}

}  // namespace tcconv

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  x (B,H,W,Cin), w (3,3,Cin,Cout)
// in that dtype, contiguous; bias float32 (Cout,) or NULL; out (B,H,W,Cout).
// float32 runs the FMA kernel, bfloat16 and float16 the tensor-core one.
// Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int mudiff_conv3x3(const void* x, const void* w, const float* bias,
                              void* out, int batch, int height, int width,
                              int cin, int cout, int dtype, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0 || cin <= 0 || cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(ffma::launch(static_cast<const float*>(x),
                                          static_cast<const float*>(w), bias,
                                          static_cast<float*>(out), batch, height, width, cin,
                                          cout, s));
    case 1:
      return static_cast<int>(
          tcconv::launch<__nv_bfloat16>(x, w, bias, out, batch, height, width, cin, cout, s));
    case 2:
      return static_cast<int>(
          tcconv::launch<__half>(x, w, bias, out, batch, height, width, cin, cout, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
