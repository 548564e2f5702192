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
// the floor is the tensor-core rate.  Inside a block the limits are the
// L2 -> shared traffic of the weight tiles (every block of 128 pixels
// reads the whole (9 Cin, BN) slab: 128 flops a byte) and the
// shared-memory reads of the operands.
//
// Three hand-written kernels; the wrapper (ops/conv3x3.py k1_path) picks
// one before any launch, from shapes, dtype and addresses:
//
// * "wgmma", bf16 / fp16 with Cin, Cout >= 64, both multiples of 8, and
//   16-byte aligned x and w (every forward and dx of the recipe but the
//   stems, the head and their dx): conv3x3_kernel_wgmma, entry point
//   mudiff_conv3x3_wgmma, Hopper's warpgroup MMA fed by TMA.  A block
//   owns 128 output pixels (8 rows x 16 columns, or 128 / W rows x W for
//   W < 16) and BN output channels (128 where Cout % 128 == 0 and the
//   grid still has a block for each SM, else 64: the same sums either way).
//   For each chunk of 64 input channels one 4-D TMA load brings the halo
//   patch of x, (rows + 2) x (tw + 2) pixels of 128 bytes with the
//   128-byte swizzle, zero-filled outside the image (SAME padding) and
//   past Cin, so padding and channel tails cost nothing and x is read
//   about 1.4 times per output instead of 9 times as im2col rows.  The
//   nine taps are nine row shifts into that patch; ldmatrix reads the
//   shifted rows (the swizzle spreads a matrix's eight pixels over all
//   banks) into the registers of wgmma's A operand, because a shift by
//   one pixel breaks the 8-row core matrices that a shared-memory A
//   descriptor needs (TMA's im2col mode, not tried, would land im2col
//   rows in shared memory per tap: nine copies of the patch).  The weight needs
//   no copy: the HWIO tensor is a (9 Cin, Cout) matrix with Cout
//   contiguous, which wgmma reads as an MN-major B (imm-trans-b); TMA
//   brings each tap's 64 K-rows as 64-channel atoms with the 128-byte
//   swizzle into a B_STAGES ring of mbarrier-guarded slots.  One producer
//   warp issues every load; two consumer warpgroups of 64 rows each run
//   wgmma.mma_async m64nBNk16 (fp32 accumulators), one k16 step a commit
//   group, one group left in flight, and release a weight slot once the
//   next tap's products are issued.  Each output sums its (chunk, tap,
//   k16) products in one fixed order: no split-K, no atomics, so a run
//   repeats its bits.  The epilogue adds the fp32 bias, rounds once,
//   stages the tile in the free patch buffers and stores 16-byte vectors.
//   Two blocks fit an SM (112 registers a thread, ~111 KB of shared
//   memory at 8 x 16 tiles), so one block's epilogue overlaps another's
//   main loop.  A missing cuTensorMapEncodeTiled or a refused tensor map
//   returns an error code that the wrapper raises on.
//
// * "general", bf16 / fp16 otherwise: conv3x3_kernel_tc (entry point
//   mudiff_conv3x3), an implicit GEMM on mma.sync.
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
// * "fma", fp32: conv3x3_kernel_fma (mudiff_conv3x3), a direct conv on the CUDA cores in fp32
//   FMA, used by --no_bf16, the checks and fp32 training (TF32 would not
//   meet their tolerances).  One block computes a TH x TW tile of output
//   pixels for TCO output channels; per chunk of CI input channels it
//   stages the input tile with its halo and the chunk's 9 x CI x TCO
//   weights in shared memory; each thread owns PX pixels of one row times
//   CO channels in registers.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  static bool configured = false;  // once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(TL::SMEM));
    if (err != cudaSuccess) return err;
    configured = true;
  }
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

// ----------------------------------------- bf16/fp16 wgmma + TMA (Hopper)

namespace wgmma {

using namespace tc;  // the mbarrier, TMA and wgmma helpers

constexpr int THREADS = 288;           // warpgroups 0 and 1 the consumers, warp 8 the producer
constexpr int CONSUMER_THREADS = 256;  // two warpgroups of m64: the block's 128 output rows
constexpr int TILE_M = 128;            // output pixels a block: rows x tw, tw = min(W, TILE_W)
constexpr int TILE_W = 16;             // widest tile row: 8 x 16 pixels, a halo patch of 10 x 18
constexpr int BLOCKS_N128 = 2;         // blocks an SM the launch bound plans for, BN = 128
constexpr int BLOCKS_N64 = 3;          // the same at BN = 64
constexpr int BK = 64;                 // input channels a chunk: one 128-byte patch row a pixel
constexpr int TAPS = 9;                // the 3 x 3 taps, each a shift into the patch
constexpr int KSTEPS = 4;              // k16 products a tap (BK / 16)
constexpr int B_STAGES = 3;            // weight tiles (one tap of one chunk) in the TMA ring
constexpr int A_SETS = 2;              // A register sets a consumer alternates between
constexpr int PATCH_TAP = 4;           // chunk c + 1's patch is fetched after tile (c, PATCH_TAP)
constexpr int ATOM_N = 64;             // output channels in a 128-byte row of a weight tile
constexpr int PATCH_PIX = 390;         // most halo pixels of a tile: (128 + 2) x (1 + 2)
constexpr int MIN_PATCH_PIX = 165;     // fewest: (9 + 2) x (13 + 2), W = 13
constexpr int ROW_BYTES = 128;         // a patch pixel, a weight tile's K row: the swizzle span
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a block may use
static_assert(THREADS == CONSUMER_THREADS + 32 && CONSUMER_THREADS == 2 * 128, "roles");
static_assert(BK * 2 == ROW_BYTES && ATOM_N * 2 == ROW_BYTES && KSTEPS * 16 == BK,
              "one swizzle row a pixel and a K row");
static_assert(TILE_M == 2 * 64 && TILE_M % TILE_W == 0, "two m64 consumers, full tile rows");
static_assert(PATCH_PIX == (TILE_M + 2) * (1 + 2), "the tallest tile: 128 rows of 1 (W = 1)");
static_assert(A_SETS >= 2 && A_SETS <= KSTEPS && (TAPS * KSTEPS) % A_SETS == 0,
              "a set is rewritten once its product is done; the previous tap's are done "
              "before its weight stage is released");

// The blocks an SM that the launch bound plans for, by the block's output
// channels: 65536 / (288 x 2) = 112 registers a thread at BN = 128 (ptxas
// then serializes its wgmma, C7512, and two blocks still beat one block
// without), 75 at BN = 64.
template <int BN>
__host__ __device__ constexpr int min_blocks() { return BN == 128 ? BLOCKS_N128 : BLOCKS_N64; }
static_assert(PATCH_TAP < TAPS && PATCH_TAP >= B_STAGES,
              "tile (c, PATCH_TAP) needs the slot of a tile of chunk c: chunk c - 1 is read");

// The weight ring: B_STAGES tiles of BK K-rows x BN channels; the two x
// patches, each 1024-byte aligned for the swizzle; the barriers.
template <int BN>
__host__ __device__ constexpr int b_tile_bytes() { return BK * BN * 2; }

__host__ __device__ constexpr int patch_stride(int pix) {
  return (pix * ROW_BYTES + 1023) / 1024 * 1024;
}

template <int BN>
__host__ __device__ constexpr int smem_bytes(int pix) {
  return 1024 + B_STAGES * b_tile_bytes<BN>() + 2 * patch_stride(pix) + (2 * B_STAGES + 4) * 8;
}
static_assert(smem_bytes<128>(PATCH_PIX) <= SMEM_LIMIT, "ring and patches exceed 227 KB");
static_assert(BLOCKS_N128 * (smem_bytes<128>(180) + 1024) <= 233472 &&
              BLOCKS_N64 * (smem_bytes<64>(180) + 1024) <= 233472,
              "the planned blocks of 8 x 16 pixels share an SM's 228 KB");
static_assert(TILE_M * (128 + 8) * 2 <= 2 * patch_stride(MIN_PATCH_PIX),
              "the staged output tile fits the two patch buffers");

struct Params {
  const float* bias;  // (Cout,) or null
  void* out;          // (B, H, W, Cout)
  int height, width, cin, cout;
  int tw, rows;       // tile: rows x tw output pixels (rows * tw <= TILE_M)
  int tiles_w, tiles_h, tiles_n, chunks;
  int patch_stride;   // bytes from one patch buffer to the other
};

// Barrier 1 of the CONSUMER_THREADS consumers (0 is __syncthreads).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
}

// ldmatrix.x4 from a shared-memory address.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The wgmma descriptor of an MN-major B tile (BK K-rows of BN 16-bit
// channels) that TMA wrote with the 128-byte swizzle as BN / 64 atoms of
// 64 K-rows x 128 bytes: start address >> 4, leading byte offset 8192 >> 4
// (from one 64-channel atom to the next, along N), stride byte offset
// 1024 >> 4 (from one 8-row group of K to the next), layout type 1 (128B).
// The k16 step k starts 2048 k bytes in (16 K-rows).
__device__ __forceinline__ uint64_t b_desc(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)(8192 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d += a . b, m64nBNk16, 16-bit T x T -> fp32: A (64 x 16) from registers,
// four a thread (the m16n8k16 A fragment of each warp's 16 rows); B (16 x
// BN, MN-major: imm-trans-b 1) from shared memory through the descriptor.
template <typename T, int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void mma<__nv_bfloat16, 128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void mma<__half, 128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void mma<__nv_bfloat16, 64>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void mma<__half, 64>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// One block: output pixels rows x tw of example b from (h0, w0), output
// channels n0 .. n0 + BN.  Two roles:
//   warp 8, one thread  the producer: every TMA load, the patch of chunk
//                       c + 1 after chunk c's weight tile PATCH_TAP;
//   warpgroups 0, 1     the consumers, 64 output rows each: per tap and
//                       k16 step one ldmatrix.x4 of the shifted patch rows
//                       and one wgmma.m64nBNk16, one product left in flight.
// Slots are handed over by mbarriers: weight stages (full: TMA bytes;
// empty: the eight consumer warps) and the two x patches (the same pair
// for each, chunk c in buffer c & 1).
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, min_blocks<BN>())
conv3x3_kernel_wgmma(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const Params p) {
  constexpr int B_TILE = b_tile_bytes<BN>();
  constexpr int NACC = BN / 2;  // fp32 accumulators a consumer thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bs = smem;                    // B_STAGES weight tiles
  unsigned char* xs = bs + B_STAGES * B_TILE;  // two x patches
  uint64_t* b_full = reinterpret_cast<uint64_t*>(xs + 2 * p.patch_stride);
  uint64_t* b_empty = b_full + B_STAGES;
  uint64_t* x_full = b_empty + B_STAGES;  // [c & 1]: patch of chunk c landed
  uint64_t* x_empty = x_full + 2;         // [c & 1]: patch of chunk c read

  int bid = blockIdx.x;
  const int nt = bid % p.tiles_n;
  bid /= p.tiles_n;
  const int twi = bid % p.tiles_w;
  bid /= p.tiles_w;
  const int thi = bid % p.tiles_h;
  const int b = bid / p.tiles_h;
  const int h0 = thi * p.rows, w0 = twi * p.tw, n0 = nt * BN;
  const int pw = p.tw + 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], CONSUMER_THREADS / 32);  // one arrival a consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&x_full[i], 1);
      mbar_init(&x_empty[i], CONSUMER_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {
    // ---- producer
    if (threadIdx.x == CONSUMER_THREADS) {
      const unsigned patch_bytes = (unsigned)((p.rows + 2) * pw * ROW_BYTES);
      auto load_patch = [&](int c) {
        if (c >= 2) mbar_wait(&x_empty[c & 1], ((c - 2) >> 1) & 1);
        mbar_expect_tx(&x_full[c & 1], patch_bytes);
        tma_load_4d(xs + (c & 1) * p.patch_stride, &xmap, &x_full[c & 1], c * BK, w0 - 1,
                    h0 - 1, b);
      };
      load_patch(0);
      int s = 0, phase = 0;  // weight stage and its round's parity
      for (int c = 0; c < p.chunks; ++c) {
        for (int t = 0; t < TAPS; ++t) {
          mbar_wait(&b_empty[s], phase ^ 1);
          mbar_expect_tx(&b_full[s], B_TILE);
#pragma unroll
          for (int a = 0; a < BN / ATOM_N; ++a)
            tma_load_2d(bs + s * B_TILE + a * BK * ROW_BYTES, &wmap, &b_full[s],
                        n0 + a * ATOM_N, t * p.cin + c * BK);
          if (++s == B_STAGES) s = 0, phase ^= 1;
          if (t == PATCH_TAP && c + 1 < p.chunks) load_patch(c + 1);
        }
      }
    }
    return;
  }

  // ---- consumers
  const int ctid = threadIdx.x;
  const int lane = ctid & 31;
  const int row_base = (ctid >> 7) * 64 + ((ctid >> 5) & 3) * 16;  // this warp's 16 rows
  // The A rows of this lane: tile pixel m -> patch pixel (r, c); each tap
  // adds (dy * pw + dx) pixels.  Lanes 16..31 read the k16 step's second
  // 16 bytes.  A pixel's 16-byte chunk j lies at chunk j ^ (pixel & 7)
  // of its 128-byte row (the 128-byte swizzle of a 1024-aligned patch).
  const int m = row_base + (lane & 15);
  const int r = m / p.tw;
  const int prow = m < p.rows * p.tw ? r * pw + (m - r * p.tw) : 0;
  const int hi = lane >> 4;
  const uint32_t x_base = tc::smem_u32(xs);
  const uint32_t b_base = tc::smem_u32(bs);

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  uint32_t a[A_SETS][4];

  int s = 0, phase = 0, prev = -1;  // weight stage, its parity, the previous tap's stage
  for (int c = 0; c < p.chunks; ++c) {
    mbar_wait(&x_full[c & 1], (c >> 1) & 1);
    const uint32_t patch = x_base + (c & 1) * p.patch_stride;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const int px = prow + (t / 3) * pw + t % 3;
      const uint32_t row = patch + px * ROW_BYTES;
      const int sw = (px & 7) ^ hi;  // chunk 2 k + hi of the row lies at (2 k) ^ sw
      mbar_wait(&b_full[s], phase);
      const uint64_t desc = b_desc(b_base + s * B_TILE);
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k) {
        uint32_t (&as)[4] = a[(t * KSTEPS + k) % A_SETS];
        ldsm_x4(as, row + (((2 * k) ^ sw) << 4));
        if (t == TAPS - 1 && k == KSTEPS - 1) {  // this warp is done with the chunk's patch
          __syncwarp();
          if (lane == 0) mbar_arrive(&x_empty[c & 1]);
        }
#pragma unroll
        for (int i = 0; i < NACC; ++i) fence_reg(acc[i]);
        wgmma_fence();
        mma<T, BN>(acc, as, desc + k * (16 * ROW_BYTES >> 4));
        wgmma_commit();
        wgmma_wait<A_SETS - 1>();
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

  // Epilogue: the fp32 bias, one rounding, the tile staged in the patch
  // buffers (rows of BN + 8 elements: a store's 8 rows fall in distinct
  // banks) and stored as 16-byte vectors, a pixel's channels contiguous.
  // acc[4 j + 2 h + e] is row (lane / 4) + 8 h, column 8 j + 2 (lane % 4)
  // + e of this warp's 16 rows (the m64nN fp32 layout of wgmma).
  constexpr int LD = BN + 8;
  consumer_sync();  // every consumer is past its last ldmatrix: the patches are free
  T* stage = reinterpret_cast<T*>(xs);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const int n = n0 + col;
    const float b0 = (p.bias != nullptr && n < p.cout) ? p.bias[n] : 0.f;
    const float b1 = (p.bias != nullptr && n + 1 < p.cout) ? p.bias[n + 1] : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_base + (lane >> 2) + 8 * half;
      *reinterpret_cast<uint32_t*>(stage + row * LD + col) =
          tc::pack2<T>(acc[4 * j + 2 * half] + b0, acc[4 * j + 2 * half + 1] + b1);
    }
  }
  consumer_sync();  // the staged tile is complete
  constexpr int VPR = BN / 8;  // 16-byte vectors a staged row
  const int vectors = (p.cout - n0 < BN ? p.cout - n0 : BN) / 8;
  T* out = static_cast<T*>(p.out);
  for (int i = ctid; i < TILE_M * VPR; i += CONSUMER_THREADS) {
    const int mm = i / VPR, v = i % VPR;
    const int rr = mm / p.tw;
    const int h = h0 + rr, w = w0 + mm - rr * p.tw;
    if (v >= vectors || mm >= p.rows * p.tw || h >= p.height || w >= p.width) continue;
    const long long pixel = ((long long)b * p.height + h) * p.width + w;
    *reinterpret_cast<uint4*>(out + pixel * p.cout + n0 + 8 * v) =
        *reinterpret_cast<const uint4*>(stage + mm * LD + 8 * v);
  }
}

template <typename T, int BN>
cudaError_t launch_conv(const CUtensorMap& xmap, const CUtensorMap& wmap, const Params& p,
                        long long blocks, int smem, cudaStream_t stream) {
  auto kernel = conv3x3_kernel_wgmma<T, BN>;
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(xmap, wmap, p);
  return cudaGetLastError();
}

template <typename T>
int conv(const void* x, const void* w, const float* bias, void* out, int batch, int height,
         int width, int cin, int cout, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return NO_ENCODER;
  constexpr CUtensorMapDataType dtype = std::is_same<T, __half>::value
                                            ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  Params p{};
  p.tw = width < TILE_W ? width : TILE_W;
  p.rows = TILE_M / p.tw;
  p.tiles_w = (width + p.tw - 1) / p.tw;
  p.tiles_h = (height + p.rows - 1) / p.rows;
  // m64n128 where Cout allows and the grid still gives each SM a block,
  // else m64n64 (twice the blocks); an output's sum is the same either way
  const long long m_tiles = (long long)batch * p.tiles_h * p.tiles_w;
  const bool wide = cout % 128 == 0 && m_tiles * (cout / 128) >= tc::sm_count();
  p.tiles_n = (cout + (wide ? 127 : 63)) / (wide ? 128 : 64);
  p.chunks = (cin + BK - 1) / BK;
  p.height = height, p.width = width, p.cin = cin, p.cout = cout;
  p.bias = bias, p.out = out;
  const int pix = (p.rows + 2) * (p.tw + 2);
  p.patch_stride = patch_stride(pix);
  const long long blocks = (long long)batch * p.tiles_h * p.tiles_w * p.tiles_n;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  // x as (C, W, H, B); a box of BK channels x (tw + 2) x (rows + 2) x 1 read
  // from (c0, w0 - 1, h0 - 1, b): the halo patch, zero-filled outside the
  // image (SAME padding) and past Cin, one 128-byte swizzled row a pixel.
  CUtensorMap xmap, wmap;
  const long long es = 2;
  const cuuint64_t xdim[4] = {(cuuint64_t)cin, (cuuint64_t)width, (cuuint64_t)height,
                              (cuuint64_t)batch};
  const cuuint64_t xstride[3] = {(cuuint64_t)(cin * es), (cuuint64_t)(width * cin * es),
                                 (cuuint64_t)((long long)height * width * cin * es)};
  const cuuint32_t xbox[4] = {BK, (cuuint32_t)(p.tw + 2), (cuuint32_t)(p.rows + 2), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult res = encode(&xmap, dtype, 4, const_cast<void*>(x), xdim, xstride, xbox, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(res);
  // the HWIO weight as (9 Cin, Cout), Cout contiguous; a box of 64
  // channels x BK K-rows, the 128-byte swizzle (one box an atom)
  const cuuint64_t wdim[2] = {(cuuint64_t)cout, (cuuint64_t)(9LL * cin)};
  const cuuint64_t wstride[1] = {(cuuint64_t)(cout * es)};
  const cuuint32_t wbox[2] = {ATOM_N, BK};
  res = encode(&wmap, dtype, 2, const_cast<void*>(w), wdim, wstride, wbox, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(res);
  if (wide)
    return static_cast<int>(
        launch_conv<T, 128>(xmap, wmap, p, blocks, smem_bytes<128>(pix), stream));
  return static_cast<int>(launch_conv<T, 64>(xmap, wmap, p, blocks, smem_bytes<64>(pix), stream));
}

}  // namespace wgmma

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

// The wgmma path of x (B,H,W,Cin) and w (3,3,Cin,Cout) of dtype (1
// bfloat16, 2 float16), contiguous; bias float32 (Cout,) or NULL; out
// (B,H,W,Cout).  Needs Cin % 8 == 0, Cout % 8 == 0 and 16-byte aligned x,
// w and out (the tensor maps' strides and addresses, the vector stores).
// Launches on `stream`; returns 0, a cudaError_t, 10000 (no
// cuTensorMapEncodeTiled in the driver) or 20000 + CUresult (a tensor map
// refused).
extern "C" int mudiff_conv3x3_wgmma(const void* x, const void* w, const float* bias, void* out,
                                    int batch, int height, int width, int cin, int cout,
                                    int dtype, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0 || cin <= 0 || cout <= 0 || cin % 8 != 0 ||
      cout % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return wgmma::conv<__nv_bfloat16>(x, w, bias, out, batch, height, width, cin, cout, s);
    case 2: return wgmma::conv<__half>(x, w, bias, out, batch, height, width, cin, cout, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
