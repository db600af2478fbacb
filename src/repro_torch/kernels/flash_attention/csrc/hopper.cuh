// Hopper (sm_90a) building blocks of the tensor-core flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): 16-byte cp.async copies of bf16 tiles into
// swizzled shared memory, the wgmma shared-memory descriptors of those
// tiles, and wgmma.mma_async products with f32 accumulators.
//
// Tile layout. A tile of R rows by D bf16 columns is stored as D*2/W
// column blocks of R rows of W = min(2D, 128) bytes each, block after
// block, each row's 16-byte chunks permuted by the 128-byte (W = 128, D >=
// 64), 64-byte (W = 64, D = 32) or 32-byte (W = 32, D = 16) swizzle that
// the descriptor names: byte offset o holds what the plain layout holds at
// o ^ (((o >> 7) & (W/16 - 1)) << 4). Tiles start on 1024-byte
// boundaries, so offsets and shared addresses agree in the bits the
// swizzle reads. The same tile serves as a K-major operand (rows are M or
// N, columns the reduction) and as an MN-major one (rows are the
// reduction, columns N), as the descriptors below say.
//
// Accumulator fragments (m64nN, f32): thread t of the warpgroup holds, for
// each 8-column chunk j, d[4j+0..1] at row 16(t/32) + (t%32)/4, columns
// 8j + 2(t%4) + 0..1, and d[4j+2..3] at the row 8 below. The register A
// operand of m64nNk16 wants, for k slice kk, exactly chunks 2kk and 2kk+1
// of such an accumulator packed as bf16 pairs: a[q] = (d[8kk+2q],
// d[8kk+2q+1]), q = 0..3 (pack_a below).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

// Let `kernel` take `bytes` of dynamic shared memory and report, in
// *blocks, how many of its blocks of `threads` fit an SM.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int bytes, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       threads, bytes);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int D>
struct Tile {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "tiles of 16, 32, 64 or 128 bf16 columns");
  static constexpr int W = D * 2 >= 128 ? 128 : D * 2;  // bytes in a row
  // the descriptor's swizzle mode: 1 = 128B, 2 = 64B, 3 = 32B
  static constexpr int LAYOUT = W == 128 ? 1 : W == 64 ? 2 : 3;
  static constexpr int CHUNKS = D / 8;                   // 16-byte chunks a row
  // byte offset of 16-byte chunk c of row r in a tile of R rows
  template <int R>
  __device__ static __forceinline__ uint32_t offset(int r, int c) {
    const uint32_t o = (c * 16) / W * (R * W) + r * W + (c * 16) % W;
    return o ^ (((o >> 7) & (W / 16 - 1)) << 4);
  }
};

// cp.async of one 16-byte chunk; src_bytes 0 zero-fills the chunk.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// cp.async of one 4-byte word; src_bytes 0 zero-fills it.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to the async proxy that wgmma reads through; a
// barrier after it publishes them to the other threads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy rows [0, R) of a tile of D bf16 columns, rows `row_stride` elements
// apart in global memory, into the swizzled tile at shared address `dst`;
// rows at and past `valid` are zero-filled. Threads tid of nthreads share
// the chunks, neighbouring threads on neighbouring chunks.
template <int R, int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int valid,
                                          int tid, int nthreads) {
  constexpr int C = Tile<D>::CHUNKS;
  for (int i = tid; i < R * C; i += nthreads) {
    const int r = i / C, c = i % C;
    const bool in = r < valid;
    const __nv_bfloat16* p = in ? src + r * row_stride + c * 8 : src;
    cp_async_16(dst + Tile<D>::template offset<R>(r, c), p, in ? 16 : 0);
  }
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

// K-major operand: rows [r0, r0 + 64) (A) or all N rows (B) of a tile of R
// rows, k slice kk (columns 16kk .. 16kk+15). Rows 8 apart are SBO = 8W
// bytes apart; the leading offset is unused by swizzled K-major layouts.
template <int R, int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  using L = Tile<D>;
  const uint32_t byte = kk * 32;
  return make_desc(tile + byte / L::W * (R * L::W) + r0 * L::W + byte % L::W,
                   16, 8 * L::W, L::LAYOUT);
}

// MN-major operand: a tile of R rows (the reduction) by D columns (N), k
// slice kk (rows 16kk .. 16kk+15). Column blocks are LBO = R*W bytes
// apart, groups of 8 rows SBO = 8W.
template <int R, int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using L = Tile<D>;
  return make_desc(tile + kk * 16 * L::W, R * L::W, 8 * L::W, L::LAYOUT);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An m64n(16*KS) accumulator as KS k slices of the register A operand.
template <int KS>
__device__ __forceinline__ void pack_a(const float (&d)[8 * KS],
                                       uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[kk][q] = pack_bf16(d[8 * kk + 2 * q], d[8 * kk + 2 * q + 1]);
}

// D (64 x 64, f32) (+)= A (64 x 16, shared, K-major) * B (64 x 16, shared,
// K-major)^T. scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 16, f32) (+)= A (64 x 16, bf16 pairs in registers, in
// the accumulator's fragment layout) * B (16 x 16, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// D (64 x 32, f32) (+)= A (64 x 16, bf16 pairs in registers, in
// the accumulator's fragment layout) * B (16 x 32, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// D (64 x 64, f32) (+)= A (64 x 16, bf16 pairs in registers, in
// the accumulator's fragment layout) * B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 16, bf16 pairs in registers, in
// the accumulator's fragment layout) * B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 16) {
    wgmma_rs_n16(d, a, b, scale_d);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, b, scale_d);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b, scale_d);
  } else {
    static_assert(N == 128, "wgmma_rs: N is 16, 32, 64 or 128");
    wgmma_rs_n128(d, a, b, scale_d);
  }
}

}  // namespace hopper
