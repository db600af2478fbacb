// Helpers shared by the selective scan's forward (selective_scan.cu) and
// backward (selective_scan_bwd.cu) kernels: the tile sizes and the saved
// states' cadence, dtype conversions, ex2, cp.async staging of time tiles
// into shared memory, and the dispatch over (x dtype, dt/B/C dtype, state
// size). Each source includes it once; everything here has internal
// linkage.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CH = 64;      // channels a block
constexpr int TT = 32;      // time steps a staged tile
// time steps between the states a training forward saves: a sub-tile of
// the backward, which recomputes and walks one at a time in registers
constexpr int SAVE_EVERY = 16;
static_assert(TT % SAVE_EVERY == 0, "a staged tile holds whole sub-tiles");
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive values from shared memory, as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of SIZE (4, 8 or 16) bytes; src_bytes below SIZE zero-fills
// the rest.
template <int SIZE>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (SIZE == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "n"(SIZE), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows [0, TT) of `cols` elements of T, rows `stride` elements apart
// from `src` (row 0 at time t0), into `dst` (rows of `cols` elements);
// rows at and past time T_len and columns at and past `valid` are zero.
// vec: pointer and stride aligned to CHUNK bytes, and cols * sizeof(T) a
// multiple of CHUNK.
template <typename T, int CHUNK>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           int64_t stride, int cols,
                                           int valid, int t0, int T_len,
                                           bool vec, int tid, int nthreads) {
  if (vec) {
    constexpr int E = CHUNK / sizeof(T);  // elements a chunk
    const int per_row = cols / E;
    for (int i = tid; i < TT * per_row; i += nthreads) {
      const int r = i / per_row, c = (i % per_row) * E;
      const int left = t0 + r < T_len ? valid - c : 0;
      const int bytes = left <= 0 ? 0 : (left >= E ? CHUNK : left * sizeof(T));
      cp_async<CHUNK>(dst + r * cols + c,
                      bytes ? src + (t0 + r) * stride + c : src, bytes);
    }
  } else {
    for (int i = tid; i < TT * cols; i += nthreads) {
      const int r = i / cols, c = i % cols;
      const bool in = t0 + r < T_len && c < valid;
      dst[i] = in ? src[(t0 + r) * stride + c] : from_f32<T>(0.f);
    }
  }
}

bool aligned(const void* p, const long long* strides, int n, int itemsize,
             int chunk) {
  if (reinterpret_cast<uintptr_t>(p) % chunk) return false;
  for (int i = 0; i < n; ++i)
    if (strides[i] * itemsize % chunk) return false;
  return true;
}

// Calls F<TX, TP, N>::run(args...) for the dtype pair and state size, or
// returns cudaErrorInvalidValue for one the kernel does not take.
template <template <typename, typename, int> class F, typename... Args>
cudaError_t dispatch(int x_dtype, int p_dtype, int N, Args... args) {
  using bf16 = __nv_bfloat16;
  auto by_n = [&](auto tx, auto tp) -> cudaError_t {
    using TX = decltype(tx);
    using TP = decltype(tp);
    switch (N) {
      case 4: return F<TX, TP, 4>::run(args...);
      case 8: return F<TX, TP, 8>::run(args...);
      case 16: return F<TX, TP, 16>::run(args...);
      default: return cudaErrorInvalidValue;
    }
  };
  if (x_dtype == 0 && p_dtype == 0) return by_n(float{}, float{});
  if (x_dtype == 1 && p_dtype == 0) return by_n(bf16{}, float{});
  if (x_dtype == 1 && p_dtype == 1) return by_n(bf16{}, bf16{});
  return cudaErrorInvalidValue;
}

}  // namespace
