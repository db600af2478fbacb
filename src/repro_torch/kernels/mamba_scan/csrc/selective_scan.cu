// Mamba selective scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/kernel.py::
// selective_scan (_scan_kernel): per batch row b and channel d, with the
// state h (N values) in f32,
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = sum_n h_t[n] * C_t[n] + D * x_t
// from h_0 = 0, y written in x's dtype. The final state h_T (the TPU
// kernel's h_sc scratch after the last time block) is written out when
// h_out is given, since the prefill cache needs it.
//
// Bound at the serving shape (jamba prefill: B=4, T=1024, dI=8192, N=16,
// x bf16, dt/B/C f32), computed from shapes, not measured:
//   bytes  x 67 MB + dt 134 MB + y 67 MB + B, C, A, D, h_T ~ 3 MB
//          ~ 271 MB -> 0.081 ms at 3.35 TB/s
//   f32    ~ 6 flops per (b, t, d, n) = 3.2e9 -> 0.048 ms at 67 TFLOP/s
//   exps   B*T*dI*N = 5.4e8 ex2 at 16 per clock per SM -> ~0.13 ms
// so the SFU's exps bind it.
//
// Design, against the TPU version, which carries the state across time
// blocks in VMEM scratch (CUDA blocks, run in no order, cannot):
//   * a channel's N states are split over L = N/4 neighbouring lanes (1,
//     2 or 4), four states and four A values a lane in registers; each
//     lane walks all T steps, and y_t is its four products summed over the
//     L lanes by log2 L __shfl_xor_sync. At the serving shape that is
//     B*dI*4 = 131,072 threads, ~31 warps an SM, where one thread a
//     channel with 16 states gave ~8 warps and 161 registers, too few to
//     hide the SFU's, the shared loads' and the h chain's latencies;
//   * a block is CH = 64 channels of one batch row (64 L threads). The
//     x, dt, B and C of TT = 32 time steps arrive in shared memory by
//     cp.async in a ring of 2 stages, tile i+1 copied while tile i is
//     computed: x and dt as 16-byte chunks of rows over d, B and C as
//     rows of N values, which a lane reads as four at a time; one
//     __syncthreads a tile;
//   * one ex2.approx.ftz.f32 (one MUFU.EX2) per state, exp(dt A) =
//     2^(dt A log2 e); a flushed result is below 2^-126 and adds nothing
//     to h. The exps of a step depend on dt alone, so they are formed
//     ahead of the h chain that uses them;
//   * y is gathered a tile at a time in shared memory (double-buffered)
//     and written as 16-byte rows over d while the next tile is computed,
//     in place of one 2-byte store a thread a step;
//   * ragged T and dI are zero-filled on load and masked on store (the
//     TPU wrapper asserts that its blocks divide them); inputs are read
//     through strides (unit stride over d and n). Where a pointer or a
//     stride is not aligned to the copy's width, the tiles are loaded
//     element by element instead, into the same ring.
// Rejected: splitting T into chunks scanned in parallel. It needs a
// second pass and, for the cumulative decay across a chunk, one more exp
// per (t, n): more SFU work against an SFU bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CH = 64;      // channels a block
constexpr int TT = 32;      // time steps a staged tile
constexpr int STAGES = 2;   // input ring
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

// Shared memory of one block: STAGES x (x, dt, B, C) of a tile, then two
// y tiles; each part a multiple of 16 bytes.
template <typename TX, typename TP, int N>
struct ScanSmem {
  static constexpr int X = TT * CH * sizeof(TX);
  static constexpr int DT = TT * CH * sizeof(TP);
  static constexpr int BC = TT * N * sizeof(TP);
  static constexpr int STAGE = X + DT + 2 * BC;
  static constexpr int Y = TT * CH * sizeof(TX);
  static constexpr int BYTES = STAGES * STAGE + 2 * Y;
};

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

// TX: x and y; TP: dt, B and C (float, or TX's bfloat16). The bounds ask
// for 32 warps an SM: at most 64 registers a thread.
template <typename TX, typename TP, int N>
__global__ void __launch_bounds__(CH * N / 4, 4096 / (CH * N))
selective_scan_kernel(const TX* __restrict__ x, const TP* __restrict__ dt,
                      const float* __restrict__ A,
                      const TP* __restrict__ Bc, const TP* __restrict__ Cc,
                      const float* __restrict__ Dv, TX* __restrict__ y,
                      float* __restrict__ h_out, int T_len, int dI,
                      int64_t xsb, int64_t xst, int64_t dsb, int64_t dst,
                      int64_t bsb, int64_t bst, int64_t csb, int64_t cst,
                      int vec_xd, int vec_bc) {
  constexpr int L = N / 4;                 // lanes a channel
  constexpr int THREADS = CH * L;
  constexpr int BC_CHUNK = N * sizeof(TP) < 16 ? N * sizeof(TP) : 16;
  using Smem = ScanSmem<TX, TP, N>;
  extern __shared__ __align__(16) uint8_t smem[];
  auto sx = [&](int st) { return reinterpret_cast<TX*>(smem + st * Smem::STAGE); };
  auto sdt = [&](int st) {
    return reinterpret_cast<TP*>(smem + st * Smem::STAGE + Smem::X);
  };
  auto sb = [&](int st) {
    return reinterpret_cast<TP*>(smem + st * Smem::STAGE + Smem::X + Smem::DT);
  };
  auto sc = [&](int st) { return sb(st) + TT * N; };
  auto sy = [&](int i) {
    return reinterpret_cast<TX*>(smem + STAGES * Smem::STAGE + i * Smem::Y);
  };

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int c = tid / L;                   // this lane's channel in the block
  const int j = tid % L;                   // and its four states 4j .. 4j+3
  const int d = d0 + c;
  const bool active = d < dI;
  const int valid = min(CH, dI - d0);      // channels of this block in dI

  float a2[4], h[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a2[i] = active ? A[static_cast<int64_t>(d) * N + 4 * j + i] * LOG2E : 0.f;
  const float dd = active ? Dv[d] : 0.f;

  const TX* xb = x + b * xsb + d0;
  const TP* db = dt + b * dsb + d0;
  const TP* bb = Bc + b * bsb;
  const TP* cb = Cc + b * csb;
  TX* yb = y + static_cast<int64_t>(b) * T_len * dI + d0;
  const bool vec_y = (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
                     (static_cast<int64_t>(dI) * sizeof(TX)) % 16 == 0;

  auto load = [&](int i) {  // tile i into stage i % STAGES
    const int t0 = i * TT, st = i % STAGES;
    stage_rows<TX, 16>(sx(st), xb, xst, CH, valid, t0, T_len, vec_xd, tid,
                       THREADS);
    stage_rows<TP, 16>(sdt(st), db, dst, CH, valid, t0, T_len, vec_xd, tid,
                       THREADS);
    stage_rows<TP, BC_CHUNK>(sb(st), bb, bst, N, N, t0, T_len, vec_bc, tid,
                             THREADS);
    stage_rows<TP, BC_CHUNK>(sc(st), cb, cst, N, N, t0, T_len, vec_bc, tid,
                             THREADS);
  };
  auto store_y = [&](int i) {  // tile i's y from sy[i % 2]
    const int t0 = i * TT, steps = min(TT, T_len - t0);
    const TX* src = sy(i % 2);
    if (vec_y) {
      constexpr int E = 16 / sizeof(TX);
      for (int k = tid; k < steps * (CH / E); k += THREADS) {
        const int r = k / (CH / E), cc = (k % (CH / E)) * E;
        if (cc < valid)
          *reinterpret_cast<uint4*>(yb + static_cast<int64_t>(t0 + r) * dI + cc) =
              *reinterpret_cast<const uint4*>(src + r * CH + cc);
      }
    } else {
      for (int k = tid; k < steps * CH; k += THREADS) {
        const int r = k / CH, cc = k % CH;
        if (cc < valid) yb[static_cast<int64_t>(t0 + r) * dI + cc] = src[k];
      }
    }
  };

  const int n_tiles = (T_len + TT - 1) / TT;
  load(0);
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();  // tile i landed for this thread
    __syncthreads();      // ... for all; tile i-1 and y tile i-1 complete
    if (i + 1 < n_tiles) load(i + 1);
    cp_async_commit();
    if (i > 0) store_y(i - 1);

    const int st = i % STAGES;
    const TX* xs = sx(st);
    const TP* ds = sdt(st);
    const TP* bs = sb(st) + 4 * j;
    const TP* cs = sc(st) + 4 * j;
    TX* ys = sy(i % 2);
    const int steps = min(TT, T_len - i * TT);
#pragma unroll 8
    for (int s = 0; s < steps; ++s) {
      const float xv = to_f32(xs[s * CH + c]);
      const float dtv = to_f32(ds[s * CH + c]);
      const float4 bv = load4(bs + s * N);
      const float4 cv = load4(cs + s * N);
      const float dx = dtv * xv;
      const float e0 = ex2(dtv * a2[0]), e1 = ex2(dtv * a2[1]);
      const float e2 = ex2(dtv * a2[2]), e3 = ex2(dtv * a2[3]);
      h[0] = fmaf(e0, h[0], dx * bv.x);
      h[1] = fmaf(e1, h[1], dx * bv.y);
      h[2] = fmaf(e2, h[2], dx * bv.z);
      h[3] = fmaf(e3, h[3], dx * bv.w);
      float part = fmaf(h[0], cv.x, fmaf(h[1], cv.y,
                        fmaf(h[2], cv.z, h[3] * cv.w)));
      if constexpr (L >= 2) part += __shfl_xor_sync(FULL, part, 1);
      if constexpr (L >= 4) part += __shfl_xor_sync(FULL, part, 2);
      if (j == 0) ys[s * CH + c] = from_f32<TX>(fmaf(dd, xv, part));
    }
  }
  cp_async_wait_all();
  __syncthreads();
  store_y(n_tiles - 1);

  if (h_out != nullptr && active) {
    float* hb = h_out + (static_cast<int64_t>(b) * dI + d) * N + 4 * j;
#pragma unroll
    for (int i = 0; i < 4; ++i) hb[i] = h[i];
  }
}

bool aligned(const void* p, const long long* strides, int n, int itemsize,
             int chunk) {
  if (reinterpret_cast<uintptr_t>(p) % chunk) return false;
  for (int i = 0; i < n; ++i)
    if (strides[i] * itemsize % chunk) return false;
  return true;
}

template <typename TX, typename TP, int N>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bc, const void* Cc, const void* D, void* y,
                   void* h_out, int B, int T_len, int dI, const long long* st,
                   cudaStream_t stream) {
  constexpr int bytes = ScanSmem<TX, TP, N>::BYTES;
  constexpr int bc_chunk = N * sizeof(TP) < 16 ? N * sizeof(TP) : 16;
  auto kernel = selective_scan_kernel<TX, TP, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int vec_xd = aligned(x, st, 2, sizeof(TX), 16) &&
                     aligned(dt, st + 2, 2, sizeof(TP), 16);
  const int vec_bc = aligned(Bc, st + 4, 2, sizeof(TP), bc_chunk) &&
                     aligned(Cc, st + 6, 2, sizeof(TP), bc_chunk);
  const dim3 grid((dI + CH - 1) / CH, B);
  kernel<<<grid, CH * N / 4, bytes, stream>>>(
      static_cast<const TX*>(x), static_cast<const TP*>(dt),
      static_cast<const float*>(A), static_cast<const TP*>(Bc),
      static_cast<const TP*>(Cc), static_cast<const float*>(D),
      static_cast<TX*>(y), static_cast<float*>(h_out), T_len, dI, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], vec_xd, vec_bc);
  return cudaGetLastError();
}

template <typename TX, typename TP, int N>
cudaError_t info(int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = ScanSmem<TX, TP, N>::BYTES;
  auto kernel = selective_scan_kernel<TX, TP, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, CH * N / 4, *smem_bytes);
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

template <typename TX, typename TP, int N>
struct Launch {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch<TX, TP, N>(args...); }
};

template <typename TX, typename TP, int N>
struct Info {
  static cudaError_t run(int* smem_bytes, int* blocks_per_sm) {
    return info<TX, TP, N>(smem_bytes, blocks_per_sm);
  }
};

}  // namespace

// x (B,T,dI) and dt (B,T,dI) with unit stride over dI; Bc, Cc (B,T,N) with
// unit stride over N; element strides (batch, time) of each in
// xsb..cst. A (dI,N) and D (dI,) contiguous f32. y (B,T,dI) contiguous in
// x's dtype; h_out (B,dI,N) contiguous f32, or null to skip it.
// x_dtype / p_dtype (of dt, Bc, Cc): 0 = float32, 1 = bfloat16; taken are
// (0,0), (1,0) and (1,1). N in {4, 8, 16}.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int selective_scan(const void* x, const void* dt, const void* A,
                              const void* Bc, const void* Cc, const void* D,
                              void* y, void* h_out, int B, int T_len, int dI,
                              int N, long long xsb, long long xst,
                              long long dsb, long long dst, long long bsb,
                              long long bst, long long csb, long long cst,
                              int x_dtype, int p_dtype, void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || dI <= 0)
    return cudaErrorInvalidValue;
  const long long st[8] = {xsb, xst, dsb, dst, bsb, bst, csb, cst};
  return dispatch<Launch>(x_dtype, p_dtype, N, x, dt, A, Bc, Cc, D, y, h_out,
                          B, T_len, dI, static_cast<const long long*>(st),
                          static_cast<cudaStream_t>(stream));
}

// The kernel for dtypes (x_dtype, p_dtype) and state size N: its dynamic
// shared memory in *smem_bytes and how many of its blocks fit an SM in
// *blocks_per_sm. Returns the query's cudaError_t.
extern "C" int selective_scan_info(int N, int x_dtype, int p_dtype,
                                   int* smem_bytes, int* blocks_per_sm) {
  return dispatch<Info>(x_dtype, p_dtype, N, smem_bytes, blocks_per_sm);
}
