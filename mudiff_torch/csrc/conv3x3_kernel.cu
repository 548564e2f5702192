// 3x3 stride-1 SAME convolution, NHWC input x HWIO weight: kernel K1.
//
// Replaces the Pallas implicit-GEMM conv of the JAX package
// (mudiff_tpu/ops/pallas_conv.py:375 conv3x3_gemm -> _conv3x3_pallas,
// kernel bodies _conv_kernel / _conv_kernel_dxk, pallas_call at :293).
// Same function: out[n,h,w,co] = bias[co] + sum_{dy,dx,ci}
// x[n,h+dy-1,w+dx-1,ci] * W[dy,dx,ci,co], accumulated in fp32, the fp32
// bias added to the accumulator, the output rounded to the input dtype.
//
// What bounds it on an H100: operations.  At the model's shapes
// (Cin, Cout >= 64) a conv does ~9*Cin*Cout*2 / ((Cin+Cout)*2) >= 290
// flops per byte moved, above the card's bf16 ridge (~295 flop/B), so
// the floor is the tensor-core rate.  This first version is a direct
// conv on the CUDA cores in fp32 (FFMA): right for every Cin/Cout and
// dtype, and simple; its distance to the tensor-core bound is recorded
// in PERF.md and is the work of a later wgmma/TMA version.
//
// Design.  One thread block computes a TH x TW tile of output pixels for
// TCO output channels of one image.  For each chunk of CI input
// channels it stages the input tile with its one-pixel halo (zeros
// outside the image, from bounds checks: no padded copy in HBM) and the
// chunk's 9 x CI x TCO weights in shared memory, as fp32.  Each thread
// owns PX consecutive output pixels of one row times CO consecutive
// output channels (PX*CO fp32 accumulators in registers); per (ci, dy)
// it loads PX+2 inputs once into registers and reuses them across the
// three dx taps.  Any Cin and Cout work (the stems' Cin = 4, 5 and the
// head's Cout = 1 included): channel tails are zero-filled in shared
// memory and masked at the store.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;         // output tile rows
constexpr int TW = 16;        // output tile columns
constexpr int TCO = 64;       // output channels per block
constexpr int CI = 16;        // input channels staged per pass
constexpr int PX = 8;         // output pixels per thread (one row segment)
constexpr int CO = 4;         // output channels per thread
constexpr int THREADS = (TH * TW / PX) * (TCO / CO);  // 256

static_assert(TW % PX == 0, "a thread's pixels lie in one tile row");
static_assert(TCO % CO == 0, "channel groups tile TCO");

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_float<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out,
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

  const T* xn = x + (size_t)n * height * width * cin;

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
        v = to_float(xn[((size_t)gy * width + gx) * cin + gc]);
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
      if (gc < cin && gco < cout) v = to_float(w[((size_t)tap * cin + gc) * cout + gco]);
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
  T* orow = out + ((size_t)n * height + oy) * width * cout;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int ox = x0 + pcol + p;
    if (ox >= width) break;
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const int co = co0 + cg * CO + j;
      if (co < cout) orow[(size_t)ox * cout + co] = from_float<T>(acc[p][j] + bv[j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* bias, void* out,
                   int batch, int height, int width, int cin, int cout,
                   cudaStream_t stream) {
  const int tiles_h = (height + TH - 1) / TH;
  const int tiles_w = (width + TW - 1) / TW;
  const dim3 grid(tiles_h * tiles_w, (cout + TCO - 1) / TCO, batch);
  conv3x3_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(out), height, width, cin, cout, tiles_w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  x (B,H,W,Cin), w (3,3,Cin,Cout)
// in that dtype, contiguous; bias float32 (Cout,) or NULL; out (B,H,W,Cout).
// Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int mudiff_conv3x3(const void* x, const void* w, const float* bias,
                              void* out, int batch, int height, int width,
                              int cin, int cout, int dtype, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0 || cin <= 0 || cout <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(x, w, bias, out, batch, height, width, cin, cout, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(x, w, bias, out, batch, height, width, cin, cout, s));
    case 2: return static_cast<int>(launch<__half>(x, w, bias, out, batch, height, width, cin, cout, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
