// Backward of the Mamba selective scan for Hopper (sm_90a), plain C
// interface for ctypes.
//
// There is no Pallas backward to replace: the JAX package trains jamba by
// jax.grad through the jnp chunked scan of src/repro/models/mamba.py
// (mamba_apply, the chunk_step scan), and this kernel is held to what that
// gives. For the forward (selective_scan.cu), per batch row b and channel
// d, with N states in f32 and a_t = exp(dt_t A),
//   h_t = a_t h_{t-1} + dt_t x_t B_t,   y_t = C_t . h_t + D x_t,
// it walks time backwards with g_t = dy_t C_t + a_{t+1} g_{t+1} (the
// gradient of h_t) and gives
//   dx_t  = sum_n g_t dt_t B_t + D dy_t
//   ddt_t = sum_n g_t (A a_t h_{t-1} + x_t B_t)
//   dA    = sum_{b,t} g_t dt_t a_t h_{t-1}
//   dB_t  = sum_d g_t dt_t x_t,   dC_t = sum_d dy_t h_t
//   dD    = sum_{b,t} dy_t x_t
// in the inputs' dtypes (dx in x's, ddt in dt's; dA, dB, dC, dD as f32
// partial sums, below).
//
// The states h_{t-1}: the training forward writes the f32 state at the end
// of every tile of TT = 32 steps, h_chunks (B, ceil(T/32), dI, N). At B 4,
// T 1024, dI 8192, N 16 that is 4 * 32 * 8192 * 16 * 4 B = 67 MB a mamba
// layer, held from the forward to the backward (under full remat, from the
// recompute to the backward of that layer only). A block recomputes each
// tile's 32 states from the state before it into shared memory, then walks
// the tile in reverse. Rejected: recovering h_{t-1} as
// (h_t - dt x B) / a_t, which blows up where a_t is small.
//
// Sums without atomics, so that every launch gives the same bits: dB_t and
// dC_t are summed over the block's 64 channels (a butterfly of
// __shfl_xor_sync over the warp's channels, then the warps in order
// through shared memory) into per-block partials (dI/64, B, T, N) f32; dA
// and dD into per-batch-row partials (B, dI, N) and (B, dI) f32. The
// caller sums the partials over their leading axis.
//
// Bound at the training shape (B=4, T=1024, dI=8192, N=16, x bf16,
// dt/B/C f32), computed from shapes (repro_torch.core.cost.scan_bwd_work),
// not measured: bytes x, dy 67 MB each, dt, ddt 134 MB each, dx 67 MB,
// h_chunks 67 MB, ~537 MB -> 0.16 ms at 3.35 TB/s; 1.2e10 f32 FLOPs ->
// 0.18 ms at 67 TFLOP/s; 5.4e8 ex2 -> 0.13 ms. So f32 operations bind it.
//
// Design: the forward's layout, for a simple kernel that is right first.
// A block is CH = 64 channels of one batch row, a channel's N states over
// L = N/4 lanes, four a lane in registers. x, dy, dt, B and C of a tile
// arrive in shared memory by cp.async in a ring of two stages, tile i-1
// copied while tile i is computed (the forward's staging, scan.cuh). The
// tile's recomputed states take TT * 64 * N * 4 bytes (128 KB at N = 16),
// so one block an SM at N = 16, 8 warps: the recurrence's latency is not
// hidden. Each step evaluates ex2 twice (recompute and walk): twice the
// least SFU work.

#include "scan.cuh"

namespace {

// Shared memory of one block: two stages of (x, dy, dt, B, C) of a tile;
// the tile's states, one float4 a thread a step; per-warp partial sums of
// dB and dC for each step of the tile. Each part a multiple of 16 bytes.
template <typename TX, typename TP, int N>
struct BwdSmem {
  static constexpr int THREADS = CH * N / 4;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int X = TT * CH * sizeof(TX);
  static constexpr int DT = TT * CH * sizeof(TP);
  static constexpr int BC = TT * N * sizeof(TP);
  static constexpr int STAGE = 2 * X + DT + 2 * BC;
  static constexpr int H = TT * THREADS * 16;
  static constexpr int RED = WARPS * TT * N * 4;
  static constexpr int BYTES = 2 * STAGE + H + 2 * RED;
};

template <typename TX, typename TP, int N>
__global__ void __launch_bounds__(CH * N / 4)
selective_scan_bwd_kernel(const TX* __restrict__ x, const TP* __restrict__ dt,
                          const float* __restrict__ A,
                          const TP* __restrict__ Bc, const TP* __restrict__ Cc,
                          const float* __restrict__ Dv,
                          const TX* __restrict__ dy,
                          const float* __restrict__ h_chunks,
                          TX* __restrict__ dx, TP* __restrict__ ddt,
                          float* __restrict__ dA_part,
                          float* __restrict__ dD_part,
                          float* __restrict__ dB_part,
                          float* __restrict__ dC_part, int T_len, int dI,
                          int64_t xsb, int64_t xst, int64_t dsb, int64_t dst,
                          int64_t bsb, int64_t bst, int64_t csb, int64_t cst,
                          int vec_xd, int vec_bc) {
  constexpr int L = N / 4;                 // lanes a channel
  constexpr int BC_CHUNK = N * sizeof(TP) < 16 ? N * sizeof(TP) : 16;
  using Smem = BwdSmem<TX, TP, N>;
  constexpr int THREADS = Smem::THREADS;
  constexpr int WARPS = Smem::WARPS;
  extern __shared__ __align__(16) uint8_t smem[];
  auto sx = [&](int st) { return reinterpret_cast<TX*>(smem + st * Smem::STAGE); };
  auto sdy = [&](int st) {
    return reinterpret_cast<TX*>(smem + st * Smem::STAGE + Smem::X);
  };
  auto sdt = [&](int st) {
    return reinterpret_cast<TP*>(smem + st * Smem::STAGE + 2 * Smem::X);
  };
  auto sb = [&](int st) {
    return reinterpret_cast<TP*>(smem + st * Smem::STAGE + 2 * Smem::X +
                                 Smem::DT);
  };
  auto sc = [&](int st) { return sb(st) + TT * N; };
  float4* sh = reinterpret_cast<float4*>(smem + 2 * Smem::STAGE);
  float* red_b = reinterpret_cast<float*>(smem + 2 * Smem::STAGE + Smem::H);
  float* red_c = red_b + WARPS * TT * N;

  const int b = blockIdx.y, B = gridDim.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c = tid / L;                   // this lane's channel in the block
  const int j = tid % L;                   // and its four states 4j .. 4j+3
  const int d = d0 + c;
  const bool active = d < dI;
  const int valid = min(CH, dI - d0);      // channels of this block in dI

  float Av[4], a2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    Av[i] = active ? A[static_cast<int64_t>(d) * N + 4 * j + i] : 0.f;
    a2[i] = Av[i] * LOG2E;
  }
  const float dd = active ? Dv[d] : 0.f;

  const TX* xb = x + b * xsb + d0;
  const TP* db = dt + b * dsb + d0;
  const TP* bb = Bc + b * bsb;
  const TP* cb = Cc + b * csb;
  const int64_t row = static_cast<int64_t>(b) * T_len * dI;
  const TX* dyb = dy + row + d0;
  const bool vec_dy = (reinterpret_cast<uintptr_t>(dy) % 16 == 0) &&
                      (static_cast<int64_t>(dI) * sizeof(TX)) % 16 == 0;
  const int n_tiles = (T_len + TT - 1) / TT;

  auto load = [&](int i) {  // tile i into stage i % 2
    const int t0 = i * TT, st = i % 2;
    stage_rows<TX, 16>(sx(st), xb, xst, CH, valid, t0, T_len, vec_xd, tid,
                       THREADS);
    stage_rows<TX, 16>(sdy(st), dyb, dI, CH, valid, t0, T_len, vec_dy, tid,
                       THREADS);
    stage_rows<TP, 16>(sdt(st), db, dst, CH, valid, t0, T_len, vec_xd, tid,
                       THREADS);
    stage_rows<TP, BC_CHUNK>(sb(st), bb, bst, N, N, t0, T_len, vec_bc, tid,
                             THREADS);
    stage_rows<TP, BC_CHUNK>(sc(st), cb, cst, N, N, t0, T_len, vec_bc, tid,
                             THREADS);
  };

  // g_{t+1} and a_{t+1} carried from step to step (zero past the end)
  float g[4] = {0.f, 0.f, 0.f, 0.f}, an[4] = {0.f, 0.f, 0.f, 0.f};
  float dA_acc[4] = {0.f, 0.f, 0.f, 0.f}, dD_acc = 0.f;

  load(n_tiles - 1);
  cp_async_commit();
  for (int i = n_tiles - 1; i >= 0; --i) {
    cp_async_wait_all();  // tile i landed for this thread
    __syncthreads();      // ... for all; tile i+1's stage and sums are free
    if (i > 0) load(i - 1);
    cp_async_commit();

    const int st = i % 2, t0 = i * TT;
    const int steps = min(TT, T_len - t0);
    const TX* xs = sx(st);
    const TX* dys = sdy(st);
    const TP* ds = sdt(st);
    const TP* bs = sb(st) + 4 * j;
    const TP* cs = sc(st) + 4 * j;

    // the state entering tile i: the end of tile i-1, zero before tile 0
    float4 h0 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i > 0 && active)
      h0 = *reinterpret_cast<const float4*>(
          h_chunks + ((static_cast<int64_t>(b) * n_tiles + i - 1) * dI + d) *
                         N + 4 * j);

    // 1. the tile's states h_t, as the forward computes them
    {
      float h[4] = {h0.x, h0.y, h0.z, h0.w};
#pragma unroll 4
      for (int s = 0; s < steps; ++s) {
        const float xv = to_f32(xs[s * CH + c]);
        const float dtv = to_f32(ds[s * CH + c]);
        const float4 bv = load4(bs + s * N);
        const float dxv = dtv * xv;
        const float e0 = ex2(dtv * a2[0]), e1 = ex2(dtv * a2[1]);
        const float e2 = ex2(dtv * a2[2]), e3 = ex2(dtv * a2[3]);
        h[0] = fmaf(e0, h[0], dxv * bv.x);
        h[1] = fmaf(e1, h[1], dxv * bv.y);
        h[2] = fmaf(e2, h[2], dxv * bv.z);
        h[3] = fmaf(e3, h[3], dxv * bv.w);
        sh[s * THREADS + tid] = make_float4(h[0], h[1], h[2], h[3]);
      }
    }

    // 2. the tile's steps in reverse
#pragma unroll 2
    for (int s = steps - 1; s >= 0; --s) {
      const float xv = to_f32(xs[s * CH + c]);
      const float dtv = to_f32(ds[s * CH + c]);
      const float dyv = to_f32(dys[s * CH + c]);
      const float4 b4 = load4(bs + s * N);
      const float4 c4 = load4(cs + s * N);
      const float4 h4 = sh[s * THREADS + tid];
      const float4 p4 = s > 0 ? sh[(s - 1) * THREADS + tid] : h0;
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      const float hc[4] = {h4.x, h4.y, h4.z, h4.w};
      const float hp[4] = {p4.x, p4.y, p4.z, p4.w};
      const float dtx = dtv * xv;
      float sum_dx = 0.f, sum_ddt = 0.f, vb[4], vc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float e = ex2(dtv * a2[k]);
        g[k] = fmaf(an[k], g[k], dyv * cv[k]);
        const float eh = e * hp[k];
        sum_dx = fmaf(g[k], bv[k], sum_dx);
        sum_ddt = fmaf(g[k], fmaf(Av[k], eh, xv * bv[k]), sum_ddt);
        dA_acc[k] = fmaf(g[k] * dtv, eh, dA_acc[k]);
        vb[k] = g[k] * dtx;
        vc[k] = dyv * hc[k];
        an[k] = e;
      }
      if constexpr (L >= 2) {
        sum_dx += __shfl_xor_sync(FULL, sum_dx, 1);
        sum_ddt += __shfl_xor_sync(FULL, sum_ddt, 1);
      }
      if constexpr (L >= 4) {
        sum_dx += __shfl_xor_sync(FULL, sum_dx, 2);
        sum_ddt += __shfl_xor_sync(FULL, sum_ddt, 2);
      }
      if (j == 0 && active) {
        const int64_t at = row + static_cast<int64_t>(t0 + s) * dI + d;
        dx[at] = from_f32<TX>(fmaf(dtv, sum_dx, dd * dyv));
        ddt[at] = from_f32<TP>(sum_ddt);
      }
      dD_acc = fmaf(dyv, xv, dD_acc);
      // dB_t and dC_t over the warp's channels: lanes of one j hold them
#pragma unroll
      for (int off = L; off < 32; off <<= 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          vb[k] += __shfl_xor_sync(FULL, vb[k], off);
          vc[k] += __shfl_xor_sync(FULL, vc[k], off);
        }
      }
      if (lane < L) {
        float* rb = red_b + (warp * TT + s) * N + 4 * j;
        float* rc = red_c + (warp * TT + s) * N + 4 * j;
        *reinterpret_cast<float4*>(rb) = make_float4(vb[0], vb[1], vb[2], vb[3]);
        *reinterpret_cast<float4*>(rc) = make_float4(vc[0], vc[1], vc[2], vc[3]);
      }
    }
    __syncthreads();

    // 3. this block's dB_t and dC_t of the tile: the warps summed in order
    for (int k = tid; k < steps * N; k += THREADS) {
      const int s = k / N, n = k % N;
      float pb = 0.f, pc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        pb += red_b[(w * TT + s) * N + n];
        pc += red_c[(w * TT + s) * N + n];
      }
      const int64_t at =
          ((static_cast<int64_t>(blockIdx.x) * B + b) * T_len + t0 + s) * N + n;
      dB_part[at] = pb;
      dC_part[at] = pc;
    }
  }

  if (active) {
    float* pa = dA_part + (static_cast<int64_t>(b) * dI + d) * N + 4 * j;
#pragma unroll
    for (int k = 0; k < 4; ++k) pa[k] = dA_acc[k];
    if (j == 0) dD_part[static_cast<int64_t>(b) * dI + d] = dD_acc;
  }
}

template <typename TX, typename TP, int N>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bc, const void* Cc, const void* D,
                   const void* dy, const void* h_chunks, void* dx, void* ddt,
                   void* dA_part, void* dD_part, void* dB_part, void* dC_part,
                   int B, int T_len, int dI, const long long* st,
                   cudaStream_t stream) {
  constexpr int bytes = BwdSmem<TX, TP, N>::BYTES;
  constexpr int bc_chunk = N * sizeof(TP) < 16 ? N * sizeof(TP) : 16;
  auto kernel = selective_scan_bwd_kernel<TX, TP, N>;
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
      static_cast<const TX*>(dy), static_cast<const float*>(h_chunks),
      static_cast<TX*>(dx), static_cast<TP*>(ddt),
      static_cast<float*>(dA_part), static_cast<float*>(dD_part),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part), T_len, dI,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], vec_xd, vec_bc);
  return cudaGetLastError();
}

template <typename TX, typename TP, int N>
cudaError_t info(int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = BwdSmem<TX, TP, N>::BYTES;
  auto kernel = selective_scan_bwd_kernel<TX, TP, N>;
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

// The forward's inputs and layouts (selective_scan.cu); dy (B,T,dI)
// contiguous in x's dtype; h_chunks (B,ceil(T/32),dI,N) contiguous f32, the
// forward's state at the end of every tile of 32 steps. Writes dx
// (B,T,dI) contiguous in x's dtype, ddt (B,T,dI) contiguous in dt's, and
// f32 partial sums, all contiguous: dA_part (B,dI,N) and dD_part (B,dI)
// over each batch row, dB_part and dC_part (ceil(dI/64),B,T,N) over each
// block of 64 channels. dtypes and N as the forward's.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int selective_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bc,
    const void* Cc, const void* D, const void* dy, const void* h_chunks,
    void* dx, void* ddt, void* dA_part, void* dD_part, void* dB_part,
    void* dC_part, int B, int T_len, int dI, int N, long long xsb,
    long long xst, long long dsb, long long dst, long long bsb, long long bst,
    long long csb, long long cst, int x_dtype, int p_dtype, void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || dI <= 0)
    return cudaErrorInvalidValue;
  const long long st[8] = {xsb, xst, dsb, dst, bsb, bst, csb, cst};
  return dispatch<Launch>(x_dtype, p_dtype, N, x, dt, A, Bc, Cc, D, dy,
                          h_chunks, dx, ddt, dA_part, dD_part, dB_part,
                          dC_part, B, T_len, dI,
                          static_cast<const long long*>(st),
                          static_cast<cudaStream_t>(stream));
}

// The backward kernel for dtypes (x_dtype, p_dtype) and state size N: its
// dynamic shared memory in *smem_bytes and how many of its blocks fit an
// SM in *blocks_per_sm. Returns the query's cudaError_t.
extern "C" int selective_scan_bwd_info(int N, int x_dtype, int p_dtype,
                                       int* smem_bytes, int* blocks_per_sm) {
  return dispatch<Info>(x_dtype, p_dtype, N, smem_bytes, blocks_per_sm);
}
