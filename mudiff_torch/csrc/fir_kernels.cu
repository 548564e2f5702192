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
//       trailing zero), so each output parity reads 2x2 of the 16 taps:
//       out[2m+py, 2n+px] = sum_{a,b<2} t[py+2a][px+2b] * x[m-1+py+a, n-1+px+b].
// t holds the correlation weights (flipped normalized kernel, x4 for
// up), passed from the host so any separable 4-tap kernel works.
//
// What bounds them on an H100: bytes.  Down does 16 FMAs per output and
// up 4, a few flops per byte moved, far below the card's ridge.  So each
// kernel reads x once from HBM, writes out once, and spends as few
// instructions as it can on the way:
//  * No division in the per-element path.  The grid is 3-D with 32-bit
//    indices: blockIdx.z is the image, blockIdx.y a strip of rows,
//    blockIdx.x * THREADS + threadIdx.x a (column, channel vector) pair,
//    split by the thread's one 32-bit division.  No grid-stride loop.
//  * 16-byte vectors along C: a thread owns VECTOR_BYTES of channels (8
//    bf16 / fp16 or 4 fp32) when C * itemsize is a multiple of 16 and
//    both pointers are 16-byte aligned (the wrapper decides, the entry
//    point checks), so a warp moves 512 contiguous bytes per load or
//    store.  Otherwise the same grid runs one channel a thread (C = 1 or
//    3, a view at an odd offset).
//  * Reuse inside a thread, each input vector loaded once by it, one step
//    of its strip ahead of the FMAs that use it (loads in flight while
//    the step before computes; no shared memory, no barriers):
//    - down: a thread owns DOWN_ROWS outputs down one column.  It streams
//      input rows 2i-1 ... 2i+2 in order, four vectors a row, and each row
//      feeds the two outputs whose windows hold it (rows overlap by half),
//      so an output costs 8 new vector loads (16 for a strip's first);
//    - up: a thread owns UP_ROWS 2x2 output quads down one column (one
//      input pixel each).  It streams input rows m-1 ... m+1, three
//      vectors a row; each row finishes two output rows and starts two,
//      so a quad costs 3 new vector loads (9 for a strip's first) and
//      writes 4 vectors.
//    Out-of-image vectors are zeros (bounds checks, no halo copies), and
//    no phase-plane copies: their HBM round trips are what made the
//    Pallas version lose in-model (pallas_fir.py:12-19).
//  * Every output keeps the order of the products of the one-output-per-
//    thread kernel these replace: an fp32 accumulator from 0, fmaf over
//    the taps with p (or a) outer and q (or b) inner, rounded once to the
//    input dtype.  A zero-filled halo adds +-0 to an accumulator that is
//    never -0, so it gives the same bits as skipping the tap: the outputs
//    are bit for bit those of that kernel.
// Tiny shapes (the critic's 8x8 levels) are bound by launch latency
// under any design; the strip lengths are set for the main path's
// shapes, where the smallest still launches 64K threads (about 500 a
// streaming multiprocessor, each with 8 or 3 16-byte loads in flight).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 128;
constexpr int VECTOR_BYTES = 16;
constexpr int DOWN_ROWS = 4;  // outputs a thread owns down a column
constexpr int UP_ROWS = 2;    // 2x2 quads (input rows) a thread owns down a column

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

// The raw word one load or store of N elements of T moves.
template <int BYTES> struct RawOf;
template <> struct RawOf<2> { using type = unsigned short; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<16> { using type = uint4; };
template <typename T, int N> using Raw = typename RawOf<sizeof(T) * N>::type;

// The raw vector at p, or zero bits (+0.0 in every dtype) where !ok.
template <typename T, int N>
__device__ __forceinline__ Raw<T, N> load_raw(const T* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const Raw<T, N>*>(p)) : Raw<T, N>{};
}

template <typename T, int N>
__device__ __forceinline__ void to_floats(const Raw<T, N>& r, float (&f)[N]) {
  T v[N];
  memcpy(v, &r, sizeof(r));
#pragma unroll
  for (int k = 0; k < N; ++k) f[k] = to_float(v[k]);
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[N]) {
  T v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = from_float<T>(f[k]);
  Raw<T, N> r;
  memcpy(&r, v, sizeof(r));
  *reinterpret_cast<Raw<T, N>*>(p) = r;
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.f;
}

// acc += t * v, one fmaf per channel.
template <int N>
__device__ __forceinline__ void fma_vec(float (&acc)[N], float t, const float (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = fmaf(t, v[k], acc[k]);
}

// Input row y, columns x0 ... x0 + COLS - 1, raw; zeros outside the image.
template <typename T, int N, int COLS>
__device__ __forceinline__ void load_row(const T* xn, int y, int x0, int height, int width,
                                         int channels, Raw<T, N> (&r)[COLS]) {
  const bool row_ok = y >= 0 && y < height;
#pragma unroll
  for (int q = 0; q < COLS; ++q) {
    const int xx = x0 + q;
    r[q] = load_raw<T, N>(xn + (y * width + xx) * channels, row_ok && xx >= 0 && xx < width);
  }
}

template <typename T, int N, int COLS>
__device__ __forceinline__ void row_floats(const Raw<T, N> (&r)[COLS], float (&v)[COLS][N]) {
#pragma unroll
  for (int q = 0; q < COLS; ++q) to_floats<T, N>(r[q], v[q]);
}

template <typename T, int N, int COLS>
__device__ __forceinline__ void copy_row(Raw<T, N> (&dst)[COLS], const Raw<T, N> (&src)[COLS]) {
#pragma unroll
  for (int q = 0; q < COLS; ++q) dst[q] = src[q];
}

// Down: tap row p of one output, q = 0..3 in order.
template <int N>
__device__ __forceinline__ void down_taps(float (&acc)[N], const float (&v)[4][N],
                                          const Taps& taps, int p) {
#pragma unroll
  for (int q = 0; q < 4; ++q) fma_vec(acc, taps.t[p * 4 + q], v[q]);
}

// Each step of a thread's strip reads input rows 2i+1, 2i+2 (taps p = 2,
// 3 of output i, p = 0, 1 of output i+1); their loads are issued one step
// ahead, so a step's FMAs run while the next step's rows are in flight.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
fir_down2_kernel(const T* __restrict__ x, T* __restrict__ out, int height, int width,
                 int vecs, int out_h, int out_w, Taps taps) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int j = t / vecs;  // the thread's one division
  if (j >= out_w) return;
  const int channels = vecs * N;
  const int c = (t - j * vecs) * N;
  const int i0 = blockIdx.y * DOWN_ROWS;
  const int rows = min(DOWN_ROWS, out_h - i0);
  const T* xn = x + (size_t)blockIdx.z * height * width * channels + c;
  T* on = out + ((size_t)blockIdx.z * out_h + i0) * out_w * channels + j * channels + c;
  const int x0 = 2 * j - 1;
  Raw<T, N> cur[2][4], ahead[2][4];
  float v[4][N], acc[N], nxt[N];
  load_row<T, N, 4>(xn, 2 * i0 - 1, x0, height, width, channels, cur[0]);
  load_row<T, N, 4>(xn, 2 * i0, x0, height, width, channels, cur[1]);
  load_row<T, N, 4>(xn, 2 * i0 + 1, x0, height, width, channels, ahead[0]);
  load_row<T, N, 4>(xn, 2 * i0 + 2, x0, height, width, channels, ahead[1]);
  // rows 2i0-1 and 2i0: taps p = 0, 1 of the strip's first output
  zero(acc);
  row_floats<T, N, 4>(cur[0], v);
  down_taps(acc, v, taps, 0);
  row_floats<T, N, 4>(cur[1], v);
  down_taps(acc, v, taps, 1);
#pragma unroll
  for (int s = 0; s < DOWN_ROWS; ++s) {
    if (s >= rows) break;
    const bool more = s + 1 < rows;
    const int y = 2 * (i0 + s) + 1;
    copy_row<T, N, 4>(cur[0], ahead[0]);
    copy_row<T, N, 4>(cur[1], ahead[1]);
    if (more) {
      load_row<T, N, 4>(xn, y + 2, x0, height, width, channels, ahead[0]);
      load_row<T, N, 4>(xn, y + 3, x0, height, width, channels, ahead[1]);
    }
    row_floats<T, N, 4>(cur[0], v);  // row 2i+1
    down_taps(acc, v, taps, 2);
    if (more) {
      zero(nxt);
      down_taps(nxt, v, taps, 0);
    }
    row_floats<T, N, 4>(cur[1], v);  // row 2i+2
    down_taps(acc, v, taps, 3);
    if (more) down_taps(nxt, v, taps, 1);
    store_vec<T, N>(on + s * out_w * channels, acc);
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = nxt[k];
  }
}

// Up: tap row p of output row parity py = p & 1, both column parities;
// v holds input columns n-1, n, n+1 of the row, b = 0, 1 in order.
template <int N>
__device__ __forceinline__ void up_taps(float (&acc)[2][N], const float (&v)[3][N],
                                        const Taps& taps, int p) {
#pragma unroll
  for (int px = 0; px < 2; ++px) {
#pragma unroll
    for (int b = 0; b < 2; ++b) fma_vec(acc[px], taps.t[p * 4 + px + 2 * b], v[px + b]);
  }
}

// Each step of a thread's strip reads input row m+1 (rows m-1 and m are
// in registers); its loads are issued one step ahead.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
fir_up2_kernel(const T* __restrict__ x, T* __restrict__ out, int height, int width,
               int vecs, Taps taps) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int n = t / vecs;  // the thread's one division: its input column
  if (n >= width) return;
  const int channels = vecs * N;
  const int c = (t - n * vecs) * N;
  const int m0 = blockIdx.y * UP_ROWS;
  const int rows = min(UP_ROWS, height - m0);
  const int out_row = 2 * width * channels;  // elements of one output row
  const T* xn = x + (size_t)blockIdx.z * height * width * channels + c;
  T* on = out + ((size_t)blockIdx.z * 2 * height + 2 * m0) * out_row + 2 * n * channels + c;
  Raw<T, N> cur[3], below[3], ahead[3];  // rows m, m+1 and m+2
  float v[3][N];
  float even[2][N], odd[2][N];  // output rows 2m and 2m+1, columns 2n and 2n+1
  load_row<T, N, 3>(xn, m0 - 1, n - 1, height, width, channels, cur);
  load_row<T, N, 3>(xn, m0, n - 1, height, width, channels, below);
  load_row<T, N, 3>(xn, m0 + 1, n - 1, height, width, channels, ahead);
  // row m0-1 opens output row 2m0 (a = 0, p = 0)
  zero(even[0]);
  zero(even[1]);
  row_floats<T, N, 3>(cur, v);
  up_taps(even, v, taps, 0);
#pragma unroll
  for (int s = 0; s < UP_ROWS; ++s) {
    if (s >= rows) break;
    const bool more = s + 1 < rows;
    copy_row<T, N, 3>(cur, below);
    copy_row<T, N, 3>(below, ahead);
    if (more) load_row<T, N, 3>(xn, m0 + s + 2, n - 1, height, width, channels, ahead);
    // row m closes 2m (a = 1, p = 2), opens 2m+1 (a = 0, p = 1) and,
    // if the strip goes on, 2m+2 (a = 0, p = 0)
    row_floats<T, N, 3>(cur, v);
    up_taps(even, v, taps, 2);
    store_vec<T, N>(on + 2 * s * out_row, even[0]);
    store_vec<T, N>(on + 2 * s * out_row + channels, even[1]);
    zero(odd[0]);
    zero(odd[1]);
    up_taps(odd, v, taps, 1);
    if (more) {
      zero(even[0]);
      zero(even[1]);
      up_taps(even, v, taps, 0);
    }
    // row m+1 closes 2m+1 (a = 1, p = 3)
    row_floats<T, N, 3>(below, v);
    up_taps(odd, v, taps, 3);
    store_vec<T, N>(on + (2 * s + 1) * out_row, odd[0]);
    store_vec<T, N>(on + (2 * s + 1) * out_row + channels, odd[1]);
  }
}

bool fits(int64_t v, int64_t limit) { return v > 0 && v <= limit; }

template <typename T, int N>
cudaError_t launch_down(const void* x, void* out, int batch, int height, int width,
                        int channels, const Taps& taps, cudaStream_t stream) {
  const int out_h = (height - 2) / 2 + 1;
  const int out_w = (width - 2) / 2 + 1;
  const int vecs = channels / N;
  const int64_t threads_x = (int64_t)out_w * vecs;
  const dim3 grid((unsigned)((threads_x + THREADS - 1) / THREADS),
                  (unsigned)((out_h + DOWN_ROWS - 1) / DOWN_ROWS), (unsigned)batch);
  if (!fits((int64_t)height * width * channels, INT32_MAX) || !fits(threads_x, INT32_MAX) ||
      !fits(grid.y, 65535) || !fits(batch, 65535))
    return cudaErrorInvalidValue;
  fir_down2_kernel<T, N><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), height, width, vecs, out_h, out_w, taps);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_up(const void* x, void* out, int batch, int height, int width,
                      int channels, const Taps& taps, cudaStream_t stream) {
  const int vecs = channels / N;
  const int64_t threads_x = (int64_t)width * vecs;
  const dim3 grid((unsigned)((threads_x + THREADS - 1) / THREADS),
                  (unsigned)((height + UP_ROWS - 1) / UP_ROWS), (unsigned)batch);
  if (!fits(4 * (int64_t)height * width * channels, INT32_MAX) ||
      !fits(threads_x, INT32_MAX) || !fits(grid.y, 65535) || !fits(batch, 65535))
    return cudaErrorInvalidValue;
  fir_up2_kernel<T, N><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), height, width, vecs, taps);
  return cudaGetLastError();
}

// The vector path needs whole 16-byte vectors along C and aligned pointers.
bool vector_ok(const void* x, const void* out, int channels, int itemsize) {
  return (int64_t)channels * itemsize % VECTOR_BYTES == 0 &&
         reinterpret_cast<uintptr_t>(x) % VECTOR_BYTES == 0 &&
         reinterpret_cast<uintptr_t>(out) % VECTOR_BYTES == 0;
}

template <typename T>
cudaError_t dispatch(bool down, const void* x, void* out, int batch, int height, int width,
                     int channels, const Taps& taps, int vector, cudaStream_t stream) {
  constexpr int VN = VECTOR_BYTES / sizeof(T);
  if (vector) {
    if (!vector_ok(x, out, channels, sizeof(T))) return cudaErrorInvalidValue;
    return down ? launch_down<T, VN>(x, out, batch, height, width, channels, taps, stream)
                : launch_up<T, VN>(x, out, batch, height, width, channels, taps, stream);
  }
  return down ? launch_down<T, 1>(x, out, batch, height, width, channels, taps, stream)
              : launch_up<T, 1>(x, out, batch, height, width, channels, taps, stream);
}

int run(bool down, const void* x, void* out, int batch, int height, int width, int channels,
        const float* host_taps, int dtype, int vector, void* stream) {
  const int min_hw = down ? 2 : 1;
  if (host_taps == nullptr || batch <= 0 || height < min_hw || width < min_hw ||
      channels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  for (int i = 0; i < 16; ++i) taps.t[i] = host_taps[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch<float>(down, x, out, batch, height, width, channels, taps, vector, s));
    case 1: return static_cast<int>(dispatch<__nv_bfloat16>(down, x, out, batch, height, width, channels, taps, vector, s));
    case 2: return static_cast<int>(dispatch<__half>(down, x, out, batch, height, width, channels, taps, vector, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  x (B,H,W,C) contiguous;
// taps: 16 host floats, t[p*4+q]; vector: 1 for 16-byte vectors along C
// (refused unless C * itemsize % 16 == 0 and x, out are 16-byte
// aligned), 0 for one channel a thread.  down: out (B,(H-2)/2+1,(W-2)/2+1,C);
// up: out (B,2H,2W,C).  One launch on `stream`; returns its cudaError_t.
extern "C" int mudiff_fir_down2(const void* x, void* out, int batch, int height,
                                int width, int channels, const float* host_taps,
                                int dtype, int vector, void* stream) {
  return run(true, x, out, batch, height, width, channels, host_taps, dtype, vector, stream);
}

extern "C" int mudiff_fir_up2(const void* x, void* out, int batch, int height,
                              int width, int channels, const float* host_taps,
                              int dtype, int vector, void* stream) {
  return run(false, x, out, batch, height, width, channels, host_taps, dtype, vector, stream);
}
