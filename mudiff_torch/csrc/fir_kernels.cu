// Factor-2 FIR resampling with 4x4 taps, NHWC: kernels K2a (down) and K2b (up).
//
// Replace the Pallas FIR kernels of the JAX package:
//   mudiff_fir_down2 <- mudiff_tpu/ops/pallas_fir.py:271 downsample_2d_pallas
//                       -> _down2_pallas (pallas_call at :182)
//   mudiff_fir_up2   <- mudiff_tpu/ops/pallas_fir.py:292 upsample_2d_pallas
//                       -> _up2_pallas (pallas_call at :248)
//
// down: out[i,j] = sum_{p,q<4} t[p][q] * x[2i+p-1, 2j+q-1]        (pad (1,1))
// up:   out[o,r] = sum_{p,q<4} t[p][q] * xd[o+p-2, r+q-2],
//       xd[2m] = x[m] and xd[odd] = 0 (zero-insert; pad (2,1) + the
//       trailing zero), so each output parity reads 2x2 of the 16 taps.
// t holds the correlation weights (flipped normalized kernel, x4 for
// up), passed from the host so any separable 4-tap kernel works.
// Out-of-image reads are zeros from bounds checks.
//
// What bounds them on an H100: bytes.  Down does 16 FMAs per output and
// up 4, a few flops per byte moved, far below the card's ridge.  So the
// design reads x once from HBM and writes out once: one thread per
// output element, channel fastest, so a warp's loads and stores are
// contiguous runs along C and the 2x2 / 4x4 neighbourhood re-reads hit
// L1/L2.  No phase-plane copies: their HBM round trips are what made
// the Pallas version lose in-model (pallas_fir.py:12-19).  Accumulation
// is fp32; the output is rounded once to the input dtype.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  float t[16];  // t[p * 4 + q]
};

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

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
fir_down2_kernel(const T* __restrict__ x, T* __restrict__ out, int height,
                 int width, int channels, int out_h, int out_w, int64_t total,
                 Taps taps) {
  for (int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * THREADS) {
    const int c = (int)(idx % channels);
    int64_t r = idx / channels;
    const int j = (int)(r % out_w);
    r /= out_w;
    const int i = (int)(r % out_h);
    const int64_t n = r / out_h;
    const T* xn = x + n * height * width * channels + c;
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int y = 2 * i + p - 1;
      if (y < 0 || y >= height) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int xx = 2 * j + q - 1;
        if (xx < 0 || xx >= width) continue;
        acc = fmaf(taps.t[p * 4 + q], to_float(xn[((int64_t)y * width + xx) * channels]), acc);
      }
    }
    out[idx] = from_float<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fir_up2_kernel(const T* __restrict__ x, T* __restrict__ out, int height,
               int width, int channels, int64_t total, Taps taps) {
  const int out_h = 2 * height;
  const int out_w = 2 * width;
  for (int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * THREADS) {
    const int c = (int)(idx % channels);
    int64_t r = idx / channels;
    const int ox = (int)(r % out_w);
    r /= out_w;
    const int oy = (int)(r % out_h);
    const int64_t n = r / out_h;
    const T* xn = x + n * height * width * channels + c;
    // taps p with (oy + p - 2) even: p = (oy & 1) + {0, 2}, reading input
    // rows y0, y0 + 1 with y0 = (oy >> 1) - 1 + (oy & 1); same for columns.
    const int py = oy & 1, px = ox & 1;
    const int y0 = (oy >> 1) - 1 + py;
    const int x0 = (ox >> 1) - 1 + px;
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int y = y0 + a;
      if (y < 0 || y >= height) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int xx = x0 + b;
        if (xx < 0 || xx >= width) continue;
        acc = fmaf(taps.t[(py + 2 * a) * 4 + (px + 2 * b)],
                   to_float(xn[((int64_t)y * width + xx) * channels]), acc);
      }
    }
    out[idx] = from_float<T>(acc);
  }
}

int blocks_for(int64_t total) {
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int64_t cap = 132 * 16;  // enough resident blocks to fill the card
  return (int)(want < cap ? want : cap);
}

template <typename T>
cudaError_t launch_down(const void* x, void* out, int batch, int height, int width,
                        int channels, const Taps& taps, cudaStream_t stream) {
  const int out_h = (height - 2) / 2 + 1;
  const int out_w = (width - 2) / 2 + 1;
  const int64_t total = (int64_t)batch * out_h * out_w * channels;
  fir_down2_kernel<T><<<blocks_for(total), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), height, width, channels,
      out_h, out_w, total, taps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_up(const void* x, void* out, int batch, int height, int width,
                      int channels, const Taps& taps, cudaStream_t stream) {
  const int64_t total = (int64_t)batch * 4 * height * width * channels;
  fir_up2_kernel<T><<<blocks_for(total), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), height, width, channels,
      total, taps);
  return cudaGetLastError();
}

bool load_taps(const float* host_taps, Taps* taps) {
  if (host_taps == nullptr) return false;
  for (int i = 0; i < 16; ++i) taps->t[i] = host_taps[i];
  return true;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  x (B,H,W,C) contiguous;
// taps: 16 host floats, t[p*4+q].  down: out (B,(H-2)/2+1,(W-2)/2+1,C);
// up: out (B,2H,2W,C).  Launch on `stream`; return the launch's cudaError_t.
extern "C" int mudiff_fir_down2(const void* x, void* out, int batch, int height,
                                int width, int channels, const float* host_taps,
                                int dtype, void* stream) {
  Taps taps;
  if (!load_taps(host_taps, &taps) || batch <= 0 || height < 2 || width < 2 || channels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_down<float>(x, out, batch, height, width, channels, taps, s));
    case 1: return static_cast<int>(launch_down<__nv_bfloat16>(x, out, batch, height, width, channels, taps, s));
    case 2: return static_cast<int>(launch_down<__half>(x, out, batch, height, width, channels, taps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int mudiff_fir_up2(const void* x, void* out, int batch, int height,
                              int width, int channels, const float* host_taps,
                              int dtype, void* stream) {
  Taps taps;
  if (!load_taps(host_taps, &taps) || batch <= 0 || height <= 0 || width <= 0 || channels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_up<float>(x, out, batch, height, width, channels, taps, s));
    case 1: return static_cast<int>(launch_up<__nv_bfloat16>(x, out, batch, height, width, channels, taps, s));
    case 2: return static_cast<int>(launch_up<__half>(x, out, batch, height, width, channels, taps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
