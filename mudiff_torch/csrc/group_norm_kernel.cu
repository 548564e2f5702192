// GroupNorm over an NHWC tensor with its affine or AdaGN modulation and an
// optional SiLU, in two passes: kernel K5 (group_norm_stats_kernel, then
// group_norm_apply_kernel).
//
// Replaces no Pallas kernel: the JAX package leaves GroupNorm to XLA
// (mudiff_tpu/nn/blocks.py).  It was added because the plain chain
// (ops/group_norm.py group_norm_plain: an fp32 upcast, separate passes for
// the mean, the mean of squares, the normalisation, the affine and the cast,
// then the modulation and the caller's SiLU) took 59-64% of the sampling
// device time on an H100: ~40 bytes and 17 launches a norm.
//
// What bounds it on an H100: bytes.  A few flops an element, far below the
// card's ridge.  The statistics need a whole example before any output, so
// the least it can do is read x twice and write the output once: 6 bytes an
// element in bf16.  No fp32 intermediate reaches device memory.
//
//  * stats, grid (chunk, example): a block streams its chunk of pixels, all
//    C channels, in 16-byte vectors (VECTOR_BYTES: 8 bf16 / fp16 or 4 fp32
//    channels; one channel where C or the pixel stride is not a whole number
//    of vectors or x is not 16-byte aligned).  A pixel holds `vecs` vectors
//    and the block `rows = blockDim / vecs` pixel rows: thread t owns vector
//    t % vecs of pixels p0 + t / vecs, + rows, ... for the whole chunk, so
//    its channels' fp32 sums and sums of squares stay in registers, with
//    UNROLL loads in flight.  Then in shared memory: each channel's rows
//    summed in row order, each group's channels in channel order, and one
//    (sum, sum of squares) per (example, chunk, group) written to scratch.
//  * apply, the same grid: a block sums its example's partials per group,
//    chunks in order (`lanes` threads a group, each a strided set of chunks,
//    then the lanes in order), forms mean, var = max(E[x^2] - mean^2, 0)
//    and rstd = rsqrtf(var + eps) as the plain chain does (chunk 0 writes
//    them out for the backward), then streams its chunk again with the
//    stats kernel's mapping: normalise, affine or AdaGN, SiLU, one store.
//    Its first UNROLL pixels are loaded before the partials are summed, and
//    each step's loads before the step before it computes.
//  * Chunks: TARGET_BLOCKS blocks over the batch, but at most SOFT_CHUNKS
//    an example (every apply block re-reads its example's partials: at batch
//    8, 132 chunks cost 14% over 66 on an H100), unless that leaves fewer
//    than MIN_BLOCKS blocks (batch 2 takes 128, not 66: 26% faster); never
//    above MAX_CHUNKS, nor below MIN_CHUNK_BYTES or `rows` pixels a chunk.
//  * No atomics: every sum has one fixed order, so two runs give the same
//    bits.  Launched on the caller's stream.
//  * Rounding after the statistics is the plain chain's on the card, op by
//    op: (x - mean) * rstd in fp32; the affine * w then + b, each rounded
//    (no FMA contraction), then the cast; AdaGN casts first, then gamma * h
//    and + beta, each rounded to the output dtype; SiLU x / (1 + expf(-x))
//    on the rounded value, rounded again.  Only the order of the
//    statistics' sums differs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace gnorm {

constexpr int THREADS = 256;           // a block, where a pixel's vectors fit in it
constexpr int MAX_THREADS = 512;       // at most 128 registers a thread
constexpr int VECTOR_BYTES = 16;
constexpr int UNROLL = 4;              // pixels a thread loads before it sums them
constexpr int TARGET_BLOCKS = 1056;    // 8 an SM on 132 SMs
constexpr int SOFT_CHUNKS = 66;        // chunks an example, unless the batch is small
constexpr int MIN_BLOCKS = 264;        // 2 an SM: a small batch takes more chunks
constexpr int MAX_CHUNKS = 128;        // chunks an example
constexpr int MIN_CHUNK_BYTES = 32768;
constexpr int MAX_CHANNELS = 4096;     // keeps each kernel's shared memory under 48 KB

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_float<__half>(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

// v rounded to T, back in fp32 (a cast to T and back, as torch's .to(T)).
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_float<T>(from_float<T>(v));
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, N>& v) {
  *reinterpret_cast<Vec<T, N>*>(p) = v;
}

// Partials: float2 (sum, sum of squares) at [(example * chunks + chunk) * groups + group].
template <typename T, int N>
__global__ void __launch_bounds__(MAX_THREADS)
group_norm_stats_kernel(const T* __restrict__ x, int64_t pixel_stride, int hw, int channels,
                        int cpg, int groups, int chunk_pixels, float2* __restrict__ partials) {
  extern __shared__ float smem[];  // sums [rows][channels], then squares [rows][channels]
  const int vecs = channels / N;
  const int rows = blockDim.x / vecs;
  const int tid = threadIdx.x;
  const int r = tid / vecs;
  const int v = tid - r * vecs;
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int p0 = chunk * chunk_pixels;
  const int p1 = min(p0 + chunk_pixels, hw);
  float* sums = smem;
  float* squares = smem + rows * channels;

  if (r < rows) {
    float s[N], q[N];
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] = q[j] = 0.f;
    const T* base = x + (int64_t)b * hw * pixel_stride + v * N;
    int p = p0 + r;
    for (; p + (UNROLL - 1) * rows < p1; p += UNROLL * rows) {
      Vec<T, N> in[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        in[u] = load_vec<T, N>(base + (int64_t)(p + u * rows) * pixel_stride);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float f = to_float<T>(in[u].v[j]);
          s[j] += f;
          q[j] = fmaf(f, f, q[j]);
        }
      }
    }
    for (; p < p1; p += rows) {
      const Vec<T, N> in = load_vec<T, N>(base + (int64_t)p * pixel_stride);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = to_float<T>(in.v[j]);
        s[j] += f;
        q[j] = fmaf(f, f, q[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      sums[r * channels + v * N + j] = s[j];
      squares[r * channels + v * N + j] = q[j];
    }
  }
  __syncthreads();
  // each channel's rows, in row order, into row 0
  for (int ch = tid; ch < channels; ch += blockDim.x) {
    float s = sums[ch], q = squares[ch];
    for (int k = 1; k < rows; ++k) {
      s += sums[k * channels + ch];
      q += squares[k * channels + ch];
    }
    sums[ch] = s;
    squares[ch] = q;
  }
  __syncthreads();
  // each group's channels, in channel order
  for (int g = tid; g < groups; g += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int k = 0; k < cpg; ++k) {
      s += sums[g * cpg + k];
      q += squares[g * cpg + k];
    }
    partials[((int64_t)b * gridDim.x + chunk) * groups + g] = make_float2(s, q);
  }
}

// One element after the statistics, in the plain chain's order of roundings.
template <typename Tout, bool STYLE, bool SILU>
__device__ __forceinline__ float finish(float xv, float mean, float rstd, float scale,
                                        float shift) {
  const float n = __fmul_rn(__fsub_rn(xv, mean), rstd);
  float y;
  if (STYLE) {  // (gamma * h.to(out) + beta) in the output dtype
    y = rounded<Tout>(__fmul_rn(scale, rounded<Tout>(n)));
    y = rounded<Tout>(__fadd_rn(y, shift));
  } else {      // (n * w + b) in fp32, then the cast (w = 1, b = 0 when absent)
    y = rounded<Tout>(__fadd_rn(__fmul_rn(n, scale), shift));
  }
  if (SILU) y = rounded<Tout>(__fdiv_rn(y, __fadd_rn(1.f, expf(-y))));
  return y;
}

// Stats out: float2 (mean, rstd) at [example * groups + group].  Style:
// [batch, 2C] in the output dtype, gamma then beta.
template <typename Tin, typename Tout, int N, bool STYLE, bool SILU>
__global__ void __launch_bounds__(MAX_THREADS)
group_norm_apply_kernel(const Tin* __restrict__ x, int64_t pixel_stride, Tout* __restrict__ out,
                        int hw, int channels, int cpg, int groups, int chunk_pixels,
                        const float2* __restrict__ partials, float2* __restrict__ stats,
                        const float* __restrict__ weight, const float* __restrict__ bias,
                        const Tout* __restrict__ style, float eps) {
  extern __shared__ float smem[];  // mean [groups], rstd [groups], lane sums [blockDim]
  float* mean_s = smem;
  float* rstd_s = smem + groups;
  float2* lane_s = reinterpret_cast<float2*>(smem + 2 * groups);
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int chunks = gridDim.x;
  const int b = blockIdx.y;
  const int vecs = channels / N;
  const int rows = blockDim.x / vecs;
  const int r = tid / vecs;
  const int v = tid - r * vecs;
  const int p1 = min(chunk * chunk_pixels + chunk_pixels, hw);
  const Tin* xb = x + (int64_t)b * hw * pixel_stride + v * N;
  Tout* ob = out + (int64_t)b * hw * channels + v * N;
  // the thread's first UNROLL pixels, loaded while the block sums the partials
  int p = chunk * chunk_pixels + r;
  Vec<Tin, N> cur[UNROLL];
  if (r < rows) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p + u * rows < p1) cur[u] = load_vec<Tin, N>(xb + (int64_t)(p + u * rows) * pixel_stride);
  }

  const float2* part = partials + (int64_t)b * chunks * groups;
  const float inv_n = 1.f / (float)((int64_t)hw * cpg);
  const int lanes = max(1, (int)blockDim.x / groups);
  auto moments = [&](int g, float2 acc) {
    const float mean = __fmul_rn(acc.x, inv_n);
    float var = __fsub_rn(__fmul_rn(acc.y, inv_n), __fmul_rn(mean, mean));
    var = var < 0.f ? 0.f : var;  // clamp_min(0), NaN kept
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    mean_s[g] = mean;
    rstd_s[g] = rstd;
    if (chunk == 0) stats[(int64_t)b * groups + g] = make_float2(mean, rstd);
  };
  for (int base = 0; base < groups * lanes; base += blockDim.x) {
    const int i = base + tid;
    const int g = i / lanes;
    const int lane = i - g * lanes;
    float2 acc = make_float2(0.f, 0.f);
    if (g < groups) {
      for (int k = lane; k < chunks; k += lanes) {
        const float2 pk = part[(int64_t)k * groups + g];
        acc.x += pk.x;
        acc.y += pk.y;
      }
    }
    if (lanes == 1) {
      if (g < groups) moments(g, acc);
    } else {
      lane_s[tid] = acc;  // one pass: groups * lanes <= blockDim
    }
  }
  if (lanes > 1) {
    __syncthreads();
    for (int g = tid; g < groups; g += blockDim.x) {
      float2 acc = lane_s[g * lanes];
      for (int l = 1; l < lanes; ++l) {
        acc.x += lane_s[g * lanes + l].x;
        acc.y += lane_s[g * lanes + l].y;
      }
      moments(g, acc);
    }
  }
  __syncthreads();
  if (r >= rows) return;

  float mean[N], rstd[N], scale[N], shift[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int ch = v * N + j;
    const int g = ch / cpg;
    mean[j] = mean_s[g];
    rstd[j] = rstd_s[g];
    if (STYLE) {
      scale[j] = to_float<Tout>(style[(int64_t)b * 2 * channels + ch]);
      shift[j] = to_float<Tout>(style[(int64_t)b * 2 * channels + channels + ch]);
    } else {
      scale[j] = weight != nullptr ? weight[ch] : 1.f;
      shift[j] = bias != nullptr ? bias[ch] : 0.f;
    }
  }
  // UNROLL pixels a step, the next step's loads issued before this step's math
  for (; p < p1; p += UNROLL * rows) {
    const int q = p + UNROLL * rows;
    Vec<Tin, N> nxt[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (q + u * rows < p1) nxt[u] = load_vec<Tin, N>(xb + (int64_t)(q + u * rows) * pixel_stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p + u * rows < p1) {
        Vec<Tout, N> o;
#pragma unroll
        for (int j = 0; j < N; ++j)
          o.v[j] = from_float<Tout>(finish<Tout, STYLE, SILU>(
              to_float<Tin>(cur[u].v[j]), mean[j], rstd[j], scale[j], shift[j]));
        store_vec<Tout, N>(ob + (int64_t)(p + u * rows) * channels, o);
      }
      cur[u] = nxt[u];
    }
  }
}

struct Args {
  const void* x;
  void* out;
  float2* partials;
  float2* stats;
  const float* weight;
  const float* bias;
  const void* style;
  int batch, hw, channels, groups;
  int64_t pixel_stride;
  int silu;
  float eps;
  cudaStream_t stream;
};

// The launch geometry, from the shape alone (tests/test_torch_port_group_norm.py
// replays it): threads a block, pixel rows a block, pixels a chunk, chunks.
struct Plan {
  int threads, rows, chunk_pixels, chunks;
};

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

Plan plan(int batch, int hw, int channels, int n, int itemsize) {
  Plan p;
  const int vecs = channels / n;
  p.threads = vecs <= THREADS ? THREADS : (int)ceil_div(vecs, 32) * 32;
  p.rows = p.threads / vecs;
  int64_t chunks = ceil_div(TARGET_BLOCKS, batch);
  chunks = chunks < SOFT_CHUNKS ? chunks : SOFT_CHUNKS;
  const int64_t small_batch = ceil_div(MIN_BLOCKS, batch);
  chunks = chunks > small_batch ? chunks : small_batch;
  const int64_t by_bytes = (int64_t)hw * channels * itemsize / MIN_CHUNK_BYTES;
  chunks = chunks < by_bytes ? chunks : by_bytes;
  const int64_t by_rows = ceil_div(hw, p.rows);
  chunks = chunks < by_rows ? chunks : by_rows;
  chunks = chunks < MAX_CHUNKS ? chunks : MAX_CHUNKS;
  chunks = chunks > 1 ? chunks : 1;
  p.chunk_pixels = (int)ceil_div(hw, chunks);
  p.chunks = (int)ceil_div(hw, p.chunk_pixels);
  return p;
}

template <typename Tin, typename Tout, int N, bool STYLE, bool SILU>
cudaError_t launch(const Args& a, const Plan& p) {
  const int cpg = a.channels / a.groups;
  const dim3 grid((unsigned)p.chunks, (unsigned)a.batch);
  const size_t stats_smem = 2 * sizeof(float) * (size_t)p.rows * a.channels;
  group_norm_stats_kernel<Tin, N><<<grid, p.threads, stats_smem, a.stream>>>(
      static_cast<const Tin*>(a.x), a.pixel_stride, a.hw, a.channels, cpg, a.groups,
      p.chunk_pixels, a.partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t apply_smem = sizeof(float) * (2 * (size_t)a.groups + 2 * (size_t)p.threads);
  group_norm_apply_kernel<Tin, Tout, N, STYLE, SILU><<<grid, p.threads, apply_smem, a.stream>>>(
      static_cast<const Tin*>(a.x), a.pixel_stride, static_cast<Tout*>(a.out), a.hw, a.channels,
      cpg, a.groups, p.chunk_pixels, a.partials, a.stats, a.weight, a.bias,
      static_cast<const Tout*>(a.style), a.eps);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, int N>
cudaError_t by_mode(const Args& a, const Plan& p) {
  const bool style = a.style != nullptr;
  if (style && a.silu) return launch<Tin, Tout, N, true, true>(a, p);
  if (style) return launch<Tin, Tout, N, true, false>(a, p);
  if (a.silu) return launch<Tin, Tout, N, false, true>(a, p);
  return launch<Tin, Tout, N, false, false>(a, p);
}

bool aligned(const void* ptr, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename Tin, typename Tout>
cudaError_t by_path(const Args& a, int vector) {
  constexpr int VN = VECTOR_BYTES / sizeof(Tin);
  if (vector) {
    if ((int64_t)a.channels * sizeof(Tin) % VECTOR_BYTES != 0 ||
        a.pixel_stride * (int64_t)sizeof(Tin) % VECTOR_BYTES != 0 || !aligned(a.x, VECTOR_BYTES) ||
        !aligned(a.out, VN * sizeof(Tout)))
      return cudaErrorInvalidValue;
    const Plan p = plan(a.batch, a.hw, a.channels, VN, sizeof(Tin));
    if (p.threads > MAX_THREADS) return cudaErrorInvalidValue;
    return by_mode<Tin, Tout, VN>(a, p);
  }
  const Plan p = plan(a.batch, a.hw, a.channels, 1, sizeof(Tin));
  if (p.threads > MAX_THREADS) return cudaErrorInvalidValue;
  return by_mode<Tin, Tout, 1>(a, p);
}

template <typename Tin>
cudaError_t by_out(const Args& a, int out_dtype, int vector) {
  switch (out_dtype) {
    case 0: return by_path<Tin, float>(a, vector);
    case 1: return by_path<Tin, __nv_bfloat16>(a, vector);
    case 2: return by_path<Tin, __half>(a, vector);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gnorm
}  // namespace

// dtypes: 0 float32, 1 bfloat16, 2 float16.  x: (B, HW, C) in in_dtype, pixel
// p of example b at x + (b * HW + p) * pixel_stride (pixel_stride >= C: a
// channel slice of a wider NHWC tensor).  out: (B, HW, C) contiguous in
// out_dtype.  partials: B * MAX_CHUNKS * groups float2 of scratch; stats:
// B * groups float2 (mean, rstd) out.  weight, bias: C fp32 or null; style:
// (B, 2C) in out_dtype (gamma, beta) or null, not with weight or bias.
// vector: 1 for 16-byte vectors along C (refused unless C and pixel_stride
// are whole vectors and the pointers aligned), 0 for one channel a thread.
// Two launches on `stream`; returns the first cudaError_t that is not 0.
extern "C" int mudiff_group_norm(const void* x, void* out, void* partials, void* stats,
                                 const void* weight, const void* bias, const void* style,
                                 int batch, int hw, int channels, long long pixel_stride,
                                 int groups, int in_dtype, int out_dtype, int vector, int silu,
                                 float eps, void* stream) {
  using namespace gnorm;
  if (batch <= 0 || batch > 65535 || hw <= 0 || channels <= 0 || channels > MAX_CHANNELS ||
      groups <= 0 || channels % groups != 0 || pixel_stride < channels ||
      (int64_t)hw * pixel_stride > INT64_MAX / batch ||
      (style != nullptr && (weight != nullptr || bias != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, out, static_cast<float2*>(partials), static_cast<float2*>(stats),
         static_cast<const float*>(weight), static_cast<const float*>(bias), style,
         batch, hw, channels, groups, pixel_stride, silu, eps,
         static_cast<cudaStream_t>(stream)};
  switch (in_dtype) {
    case 0: return static_cast<int>(by_out<float>(a, out_dtype, vector));
    case 1: return static_cast<int>(by_out<__nv_bfloat16>(a, out_dtype, vector));
    case 2: return static_cast<int>(by_out<__half>(a, out_dtype, vector));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
