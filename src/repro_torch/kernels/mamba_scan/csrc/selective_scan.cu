// Mamba selective scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/kernel.py::
// selective_scan (_scan_kernel): per batch row b and channel d, with the
// state h (N values) in f32,
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = sum_n h_t[n] * C_t[n] + D * x_t
// from h_0 = 0, y written in x's dtype. The final state h_T (the TPU
// kernel's h_sc scratch after the last time block) is written out when
// h_out is given, since the prefill cache needs it. A training forward
// also gives h_chunks, (B, ceil(T/SAVE_EVERY), dI, N) f32, and gets the
// state at the end of every SAVE_EVERY = 16 steps (scan.cuh): the
// backward kernel (selective_scan_bwd.cu) recomputes each sub-tile's
// states from the one before it. Serving passes null and writes nothing
// more.
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

#include "scan.cuh"

namespace {

constexpr int STAGES = 2;   // input ring

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

// TX: x and y; TP: dt, B and C (float, or TX's bfloat16); SAVE: a
// training forward, which writes h_chunks (serving runs the instantiation
// without it). The bounds ask for 32 warps an SM: at most 64 registers a
// thread.
template <typename TX, typename TP, int N, bool SAVE>
__global__ void __launch_bounds__(CH * N / 4, 4096 / (CH * N))
selective_scan_kernel(const TX* __restrict__ x, const TP* __restrict__ dt,
                      const float* __restrict__ A,
                      const TP* __restrict__ Bc, const TP* __restrict__ Cc,
                      const float* __restrict__ Dv, TX* __restrict__ y,
                      float* __restrict__ h_out,
                      float* __restrict__ h_chunks, int T_len, int dI,
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
      if constexpr (SAVE) {  // the state after every SAVE_EVERY steps, at T
        const int t = i * TT + s;
        const int n_saved = (T_len + SAVE_EVERY - 1) / SAVE_EVERY;
        if (((s + 1) % SAVE_EVERY == 0 || t == T_len - 1) && active)
          *reinterpret_cast<float4*>(
              h_chunks + ((static_cast<int64_t>(b) * n_saved +
                           t / SAVE_EVERY) * dI + d) * N + 4 * j) =
              make_float4(h[0], h[1], h[2], h[3]);
      }
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

template <typename TX, typename TP, int N>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bc, const void* Cc, const void* D, void* y,
                   void* h_out, void* h_chunks, int B, int T_len, int dI,
                   const long long* st, cudaStream_t stream) {
  constexpr int bytes = ScanSmem<TX, TP, N>::BYTES;
  constexpr int bc_chunk = N * sizeof(TP) < 16 ? N * sizeof(TP) : 16;
  auto kernel = h_chunks != nullptr ? selective_scan_kernel<TX, TP, N, true>
                                    : selective_scan_kernel<TX, TP, N, false>;
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
      static_cast<TX*>(y), static_cast<float*>(h_out),
      static_cast<float*>(h_chunks), T_len, dI, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], vec_xd, vec_bc);
  return cudaGetLastError();
}

template <typename TX, typename TP, int N>
cudaError_t info(int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = ScanSmem<TX, TP, N>::BYTES;
  auto kernel = selective_scan_kernel<TX, TP, N, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, CH * N / 4, *smem_bytes);
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
// x's dtype; h_out (B,dI,N) contiguous f32, or null to skip it; h_chunks
// (B,ceil(T/16),dI,N) contiguous f32, the state at the end of every 16
// steps (and at T), or null to skip it.
// x_dtype / p_dtype (of dt, Bc, Cc): 0 = float32, 1 = bfloat16; taken are
// (0,0), (1,0) and (1,1). N in {4, 8, 16}.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int selective_scan(const void* x, const void* dt, const void* A,
                              const void* Bc, const void* Cc, const void* D,
                              void* y, void* h_out, void* h_chunks, int B,
                              int T_len, int dI,
                              int N, long long xsb, long long xst,
                              long long dsb, long long dst, long long bsb,
                              long long bst, long long csb, long long cst,
                              int x_dtype, int p_dtype, void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || dI <= 0)
    return cudaErrorInvalidValue;
  const long long st[8] = {xsb, xst, dsb, dst, bsb, bst, csb, cst};
  return dispatch<Launch>(x_dtype, p_dtype, N, x, dt, A, Bc, Cc, D, y, h_out,
                          h_chunks, B, T_len, dI,
                          static_cast<const long long*>(st),
                          static_cast<cudaStream_t>(stream));
}

// The kernel for dtypes (x_dtype, p_dtype) and state size N: its dynamic
// shared memory in *smem_bytes and how many of its blocks fit an SM in
// *blocks_per_sm. Returns the query's cudaError_t.
extern "C" int selective_scan_info(int N, int x_dtype, int p_dtype,
                                   int* smem_bytes, int* blocks_per_sm) {
  return dispatch<Info>(x_dtype, p_dtype, N, smem_bytes, blocks_per_sm);
}
