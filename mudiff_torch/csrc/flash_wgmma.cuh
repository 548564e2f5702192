// K3's Hopper building blocks, shared by the forward's and the backward's
// wgmma paths (flash_attn_kernel.cu, flash_attn_bwd_kernel.cu, namespace
// wgmma in each).
//
// Every operand of those kernels is a TILE_ROWS x HEAD_DIM tile of a
// (B, L, C) 16-bit tensor (queries or keys of one batch row, all of C),
// brought by TMA through a 3-D tensor map over (C, L, B) as ATOMS boxes of
// ATOM_C channels x TILE_ROWS rows, one ROW_BYTES row a box row, with the
// 128-byte swizzle: the 16-byte chunk j of tile row r lies at chunk j ^ (r
// % 8) of its row.  Rows past L (of this batch row: the map is 3-D, so the
// next batch row is never read) and columns past C are zero-filled.  wgmma
// reads such a tile two ways through a descriptor:
//   K-major (kmajor_desc): rows are M or N, channels are K, the k16 step kk
//     starts 32 (kk % 4) bytes into box kk / 4; SBO 1024 bytes from one
//     8-row group to the next (LBO unused under the swizzle).  Q K^T, K Q^T,
//     V dO^T and dO V^T read both of their operands so.
//   MN-major (mn_desc): rows are K, channels are N (imm-trans-b 1), the k16
//     step kk starts 16 kk rows in; LBO ATOM_BYTES from one 64-channel box
//     to the next along N, SBO 1024 bytes from one 8-row group of K to the
//     next (as K1 reads its HWIO weight).  P V, P^T dO, dS^T Q and dS K
//     read their B so, with no transposed copy.
// The 64 x 64 fp32 accumulator of a score product (m64n64) becomes the
// register A operand of the next product (m64n256, k = the 64 scores'
// columns) by to_a: wgmma's accumulator and its A fragment share the
// m16n8k16 layout of each warp's 16 rows.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace k3w {

constexpr int HEAD_DIM = 256;                       // the one head dim of the wgmma paths
constexpr int TILE_ROWS = 64;                       // queries or keys a tile: one m64
constexpr int ATOM_C = 64;                          // channels a box: one 128-byte row
constexpr int ATOMS = 4;                            // boxes a tile (HEAD_DIM / ATOM_C)
constexpr int ROW_BYTES = 128;                      // the swizzle span
constexpr int ATOM_BYTES = TILE_ROWS * ROW_BYTES;   // 8192
constexpr int TILE_BYTES = ATOMS * ATOM_BYTES;      // 32768
constexpr int WG_THREADS = 128;                     // a warpgroup
static_assert(ATOMS * ATOM_C == HEAD_DIM && ATOM_C * 2 == ROW_BYTES, "four 128-byte boxes");

// The K-major descriptor of k16 step kk (channels 16 kk .. 16 kk + 15) of
// the tile at shared address `tile` (1024-aligned): start >> 4, LBO 1
// (unused), SBO 1024 >> 4, layout 1 (128B swizzle).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  const uint32_t addr = tile + (kk >> 2) * ATOM_BYTES + (kk & 3) * 32;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The MN-major descriptor of k16 step kk (tile rows 16 kk .. 16 kk + 15,
// all HEAD_DIM channels as N): start >> 4, LBO 8192 >> 4, SBO 1024 >> 4,
// layout 1 (128B swizzle).
__device__ __forceinline__ uint64_t mn_desc(uint32_t tile, int kk) {
  const uint32_t addr = tile + kk * 16 * ROW_BYTES;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(8192 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Wait for the phase of parity `parity` of an mbarrier (tc::mbar_wait),
// trapping after WAIT_CYCLES clocks without it: a handover that never
// comes ends the launch with an error instead of hanging the card.
constexpr long long WAIT_CYCLES = 1LL << 34;  // ~10 s at the H100's clocks

__device__ __forceinline__ void wait_phase(uint64_t* bar, unsigned parity) {
  const uint32_t addr = tc::smem_u32(bar);
  long long start = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0)
      start = now;
    else if (now - start > WAIT_CYCLES)
      __trap();
  }
}

// d (64 x 64, fp32) = a . b (+ d when accumulate), m64n64k16: A (64 x 16)
// and B (16 x 64) from shared memory by K-major descriptors.
template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a_desc, uint64_t b_desc,
                                       int accumulate);

// d (64 x 256, fp32) += a . b, m64n256k16: A (64 x 16) from registers, four
// a thread; B (16 x 256) from shared memory by an MN-major descriptor.
template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b_desc);

template <>
__device__ __forceinline__ void mma_ss<__nv_bfloat16>(float (&d)[32], uint64_t a_desc, uint64_t b_desc,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_ss<__half>(float (&d)[32], uint64_t a_desc, uint64_t b_desc,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_rs<__nv_bfloat16>(float (&d)[128], const uint32_t (&a)[4],
                                          uint64_t b_desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<__half>(float (&d)[128], const uint32_t (&a)[4],
                                          uint64_t b_desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// The 64 x 64 accumulator f (f[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + e) rounded to T as four k16 A operands over
// its columns: a[kk] holds columns 16 kk .. 16 kk + 15.
template <typename T>
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&f)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = tc::pack2<T>(f[8 * kk + 0], f[8 * kk + 1]);
    a[kk][1] = tc::pack2<T>(f[8 * kk + 2], f[8 * kk + 3]);
    a[kk][2] = tc::pack2<T>(f[8 * kk + 4], f[8 * kk + 5]);
    a[kk][3] = tc::pack2<T>(f[8 * kk + 6], f[8 * kk + 7]);
  }
}

// Row r (0 .. 63) of the accumulator's tile that element x of this thread
// lies on, and its column: the m64nN fp32 layout of wgmma.
__device__ __forceinline__ int acc_row(int t, int x) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((x >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int x) { return 8 * (x >> 2) + 2 * (t & 3) + (x & 1); }

// The 3-D tensor map of a (B, L, C) 16-bit tensor at `ptr` (C = HEAD_DIM):
// boxes of ATOM_C channels x TILE_ROWS rows x 1 batch row, the 128-byte
// swizzle, zero fill past L.  Returns 0, tc::NO_ENCODER or
// tc::ENCODE_FAILED + CUresult.
inline int encode_rows(CUtensorMap* map, const void* ptr, bool half, int batch, int L, int C) {
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return tc::NO_ENCODER;
  const cuuint64_t dim[3] = {(cuuint64_t)C, (cuuint64_t)L, (cuuint64_t)batch};
  const cuuint64_t stride[2] = {(cuuint64_t)C * 2, (cuuint64_t)L * C * 2};
  const cuuint32_t box[3] = {ATOM_C, TILE_ROWS, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult res =
      encode(map, half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dim, stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : tc::ENCODE_FAILED + static_cast<int>(res);
}

// Once per kernel instance: its dynamic shared memory and the carveout.
template <typename Kernel>
cudaError_t configure(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

}  // namespace k3w
