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
// The states: the training forward writes the f32 state at the end of
// every SAVE_EVERY = 16 steps (scan.cuh), h_chunks (B, ceil(T/16), dI, N).
// At B 4, T 1024, dI 8192, N 16 that is 134,217,728 B a mamba layer, held
// from the forward to the backward (under full remat, from the recompute
// to the backward of that layer only).
//
// Bound at the training shape (B=4, T=1024, dI=8192, N=16, x bf16,
// dt/B/C f32), computed from shapes (repro_torch.core.cost.scan_bwd_work),
// not measured: bytes x, dy 67 MB each, dt, ddt 134 MB each, dx 67 MB,
// the states at a 32-step interval 67 MB (the least the gradients need),
// ~539 MB -> 0.161 ms at 3.35 TB/s; 1.2e10 f32 FLOPs -> 0.179 ms at 67
// TFLOP/s; 5.4e8 ex2 -> 0.128 ms. So f32 operations bind it. The 16-step
// cadence reads 67 MB more than the bound counts, 0.02 ms.
//
// Design. The first cut (a 32-step tile's states recomputed into 128 KB
// of shared memory, then walked) ran at 10.5% of the bound: one block of
// 8 warps an SM, ex2 twice a state, 28 shuffles a warp-step, 48 B of
// shared-memory state traffic a thread-step. Now:
//   * a block is CH = 64 channels of one batch row, a channel's N states
//     over L = N/4 lanes, four a lane (the forward's layout). x, dy, dt,
//     B and C of a 32-step tile, and the saved states its two sub-tiles
//     start from, arrive in shared memory by cp.async in a ring of two
//     stages, tile i-1 copied while tile i is computed;
//   * one ex2 a state a step. A sub-tile of S = 16 steps is recomputed
//     from its saved state in a fully unrolled loop that keeps a_t and h_t
//     in registers (2 x 4 x 16 = 128 a lane), then walked back in the same
//     unrolled code: g takes a_{t+1} from those registers, and
//     a_t h_{t-1} = h_t - (dt_t x_t) B_t, so the walk needs neither
//     h_{t-1} nor a state tile in shared memory. Rejected: recovering
//     h_{t-1} as (h_t - dt x B) / a_t, which blows up where a_t is small;
//   * the walk's steps in flight together. A step depends on the one
//     after it only through g = a_{t+1} g + dy C, one FMA a state. The
//     walk takes P = 4 steps at a time: their arithmetic, then their lane
//     sums level by level, so that the shuffles of four steps are in
//     flight together;
//   * a quarter of the shuffles. dB_t and dC_t (8 values a lane) are
//     summed over the warp's channels by a reduce-scatter: at lane bits
//     4, 3 and 2 a lane sends half of its values and keeps the sums of
//     the other half (4 + 2 + 1 shuffles), and ends with one (dB or dC,
//     n) sum; lane bits 1 and 0, channels at N = 8 and 4, add one shuffle
//     each. dx's and ddt's sums over a channel's lanes likewise (one
//     shuffle, and one more at L = 4). 9 shuffles a warp-step at N = 16.
//     ddt folds x into dx's sum: sum_n g (A a h_{t-1} + x B) =
//     sum_n A g a h_{t-1} + x sum_n g B;
//   * no store under a predicate in the walk: each step's dx and ddt go to
//     a shared-memory tile (lanes that hold the same sum store the same
//     value to the same place) and out to device memory as rows over d at
//     the tile's end, with dB's and dC's block sums.
// Shared memory 106,496 B at N = 16, x bf16, dt f32 (against 204,800);
// registers (up to 255, no spill) hold a block of 256 threads to one an
// SM.
//
// What it measured at the training shape (scripts/scan_pair.py, the first
// cut and this kernel in one call, in turns; scripts/scan_bwd_variants.py;
// NVIDIA H100 80GB HBM3, 700 W): 0.984-0.992 ms against the first cut's
// 1.703-1.709, 18.2% of the bound. The walk one step at a time (P = 1):
// 1.089-1.096 ms; P = 2: 1.009; P = 8: 0.982-0.986. dx and ddt stored
// to device memory from the walk under a predicate, as the first cut did
// (P = 1): 1.261 ms. States saved every 8 steps (sub-tiles of 8):
// 0.987 ms, no gain. Tiles of 16 steps and states every 8, which leave
// 128 registers and 61,440 B for two blocks (16 warps) an SM: 0.880-0.886
// ms, 11% faster for twice the saved states (268 MB a layer); not taken.
// Without the lane sums (wrong results, timed only): 0.796-0.801 ms;
// with an FMA for each ex2: 0.943-0.946. So the shuffles cost ~0.19 ms
// and the SFU ~0.04; the rest is the walk's issue and latency on 8 warps
// an SM, which twice the warps shortened by 11%.
//
// Sums without atomics, so that every launch gives the same bits: dB_t and
// dC_t are summed over the block's 64 channels (the reduce-scatter over
// the warp's channels, then the warps in order through shared memory)
// into per-block partials (dI/64, B, T, N) f32; dA and dD into per-batch-
// row partials (B, dI, N) and (B, dI) f32. The caller sums the partials
// over their leading axis. Steps past T (zero-filled x, dt, dy, B, C: a
// = 1, g = 0) add nothing and write nothing.

#include "scan.cuh"

namespace {

constexpr int SUBS = TT / SAVE_EVERY;   // sub-tiles a staged tile

// Shared memory of one block: two stages of (x, dy, dt, B, C) of a tile
// and the saved states its sub-tiles start from; the tile's dx and ddt
// (f32); per-warp partial sums of dB and dC for each step of the tile.
// Each part a multiple of 16 bytes.
template <typename TX, typename TP, int N>
struct BwdSmem {
  static constexpr int THREADS = CH * N / 4;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int X = TT * CH * sizeof(TX);
  static constexpr int DT = TT * CH * sizeof(TP);
  static constexpr int BC = TT * N * sizeof(TP);
  static constexpr int H0 = SUBS * CH * N * 4;
  static constexpr int STAGE = 2 * X + DT + 2 * BC + H0;
  static constexpr int OUT = 2 * TT * CH * 4;
  static constexpr int RED = WARPS * TT * 2 * N * 4;
  static constexpr int BYTES = 2 * STAGE + OUT + RED;
};

// The sums over the warp's channels of v[p] (a lane's dB_t for its
// states 4j .. 4j+3, then its dC_t for them; one row a step, P steps at a
// time, so that each level's shuffles of the P steps are in flight
// together), each at one of the 2N (dB or dC, n), reduced and scattered:
// lane bits 4, 3 and 2 each halve the values a lane keeps, 8 -> 4 -> 2 ->
// 1, the lane with the bit set keeping the upper half; lane bits 1 and 0,
// where they name channels (L < 4), add the rest. A lane ends with value
// m = lane >> 2 of each row: dB (m < 4) or dC, state 4j + m % 4.
template <int L, int P>
__device__ __forceinline__ void channel_sums(const float (&v)[P][8],
                                             int lane, float (&r)[P]) {
  const bool hi4 = lane & 16, hi3 = lane & 8, hi2 = lane & 4;
  float v4[P][4], v2[P][2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int p = 0; p < P; ++p)
      v4[p][k] = (hi4 ? v[p][k + 4] : v[p][k]) +
                 __shfl_xor_sync(FULL, hi4 ? v[p][k] : v[p][k + 4], 16);
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int p = 0; p < P; ++p)
      v2[p][k] = (hi3 ? v4[p][k + 2] : v4[p][k]) +
                 __shfl_xor_sync(FULL, hi3 ? v4[p][k] : v4[p][k + 2], 8);
#pragma unroll
  for (int p = 0; p < P; ++p)
    r[p] = (hi2 ? v2[p][1] : v2[p][0]) +
           __shfl_xor_sync(FULL, hi2 ? v2[p][0] : v2[p][1], 4);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if constexpr (L <= 2) r[p] += __shfl_xor_sync(FULL, r[p], 2);
    if constexpr (L == 1) r[p] += __shfl_xor_sync(FULL, r[p], 1);
  }
}

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
  constexpr int S = SAVE_EVERY;            // steps a sub-tile
  constexpr int P = 4;                     // steps whose lane sums overlap
  static_assert(S % P == 0, "the walk takes a sub-tile P steps at a time");
  constexpr int BC_CHUNK = N * sizeof(TP) < 16 ? N * sizeof(TP) : 16;
  using Smem = BwdSmem<TX, TP, N>;
  constexpr int THREADS = Smem::THREADS;
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
  auto sh0 = [&](int st) {
    return reinterpret_cast<float*>(smem + st * Smem::STAGE + 2 * Smem::X +
                                    Smem::DT + 2 * Smem::BC);
  };
  float* sout = reinterpret_cast<float*>(smem + 2 * Smem::STAGE);
  float* red = sout + 2 * TT * CH;

  const int b = blockIdx.y, B = gridDim.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c = tid / L;                   // this lane's channel in the block
  const int j = tid % L;                   // and its four states 4j .. 4j+3
  const int d = d0 + c;
  const bool active = d < dI;
  const int valid = min(CH, dI - d0);      // channels of this block in dI
  // the (dB or dC, n) sum channel_sums leaves this lane, and its place
  // among a step's 2N partials (lanes that differ only in channel bits
  // hold the same sum and store it to the same place)
  const int m = lane >> 2;
  const int red_at = (m >> 2) * N + 4 * j + (m & 3);
  // where this lane stores the dx or ddt that the lane sums leave it
  float* out = sout + ((L > 1 && (j & 1)) ? TT * CH : 0) + c;

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
  const int n_saved = (T_len + S - 1) / S;
  const float* hb =
      h_chunks + (static_cast<int64_t>(b) * n_saved * dI + d0) * N;

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
    // the state entering sub-tile u of the tile: saved state i*SUBS+u-1,
    // zero before the first; the block's CH*N floats are contiguous
    float* h0 = sh0(st);
    for (int k = tid; k < SUBS * CH * N / 4; k += THREADS) {
      const int u = k / (CH * N / 4), e = (k % (CH * N / 4)) * 4;
      const int q = i * SUBS + u - 1;
      const bool in = q >= 0 && q < n_saved && e < valid * N;
      cp_async<16>(h0 + u * CH * N + e,
                   in ? hb + static_cast<int64_t>(q) * dI * N + e : hb,
                   in ? 16 : 0);
    }
  };

  // g_{t+1} and a_{t+1} carried from sub-tile to sub-tile (zero past the
  // end)
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
    const TX* xs = sx(st) + c;
    const TX* dys = sdy(st) + c;
    const TP* ds = sdt(st) + c;
    const TP* bs = sb(st) + 4 * j;
    const TP* cs = sc(st) + 4 * j;

#pragma unroll 1
    for (int u = SUBS - 1; u >= 0; --u) {
      const int s0 = u * S;
      if (t0 + s0 >= T_len) continue;      // a sub-tile past the end

      // 1. the sub-tile's a_t and h_t, as the forward computes them
      float a[S][4], h[S][4];
      {
        const float4 h0 = *reinterpret_cast<const float4*>(
            sh0(st) + u * CH * N + c * N + 4 * j);
        float hc[4] = {h0.x, h0.y, h0.z, h0.w};
#pragma unroll
        for (int v = 0; v < S; ++v) {
          const int s = s0 + v;
          const float dtv = to_f32(ds[s * CH]);
          const float4 b4 = load4(bs + s * N);
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
          const float dtx = dtv * to_f32(xs[s * CH]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            a[v][k] = ex2(dtv * a2[k]);
            hc[k] = fmaf(a[v][k], hc[k], dtx * bv[k]);
            h[v][k] = hc[k];
          }
        }
      }

      // 2. its steps in reverse, P at a time: the arithmetic of each
      // step (whose only link to the next is g), then the lane sums of the
      // P steps together
#pragma unroll
      for (int v0 = S - 1; v0 >= 0; v0 -= P) {
        float vbc[P][8], sum_dx[P], sum_ddt[P], dtvs[P], ddy[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int v = v0 - p, s = s0 + v;
          const float xv = to_f32(xs[s * CH]);
          const float dtv = to_f32(ds[s * CH]);
          const float dyv = to_f32(dys[s * CH]);
          const float4 b4 = load4(bs + s * N);
          const float4 c4 = load4(cs + s * N);
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float dtx = dtv * xv;
          float sdx = 0.f, sa = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            g[k] = fmaf(v == S - 1 ? an[k] : a[v + 1][k], g[k], dyv * cv[k]);
            // g a_t h_{t-1}, with a_t h_{t-1} = h_t - (dt x) B
            const float q = g[k] * fmaf(-dtx, bv[k], h[v][k]);
            sa = fmaf(Av[k], q, sa);
            dA_acc[k] = fmaf(dtv, q, dA_acc[k]);
            sdx = fmaf(g[k], bv[k], sdx);
            vbc[p][k] = g[k] * dtx;
            vbc[p][4 + k] = dyv * h[v][k];
          }
          dD_acc = fmaf(dyv, xv, dD_acc);
          sum_dx[p] = sdx;
          sum_ddt[p] = fmaf(xv, sdx, sa);
          dtvs[p] = dtv;
          ddy[p] = dd * dyv;
        }
        // dx's and ddt's sums over the channel's lanes: with L >= 2 the
        // lanes of even j end with dx's, of odd j with ddt's
        const bool odd = L > 1 && (j & 1);
        float r[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          r[p] = odd ? sum_ddt[p] : sum_dx[p];
          if constexpr (L > 1)
            r[p] += __shfl_xor_sync(FULL, odd ? sum_dx[p] : sum_ddt[p], 1);
        }
#pragma unroll
        for (int p = 0; p < P; ++p)
          if constexpr (L == 4) r[p] += __shfl_xor_sync(FULL, r[p], 2);
        float bc[P];
        channel_sums<L, P>(vbc, lane, bc);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int s = s0 + v0 - p;
          out[s * CH] = odd ? r[p] : fmaf(dtvs[p], r[p], ddy[p]);
          if constexpr (L == 1) out[TT * CH + s * CH] = sum_ddt[p];
          red[(warp * TT + s) * 2 * N + red_at] = bc[p];
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) an[k] = a[0][k];
    }
    __syncthreads();

    // 3. the tile's dx and ddt, rows over d; this block's dB_t and dC_t
    // of the tile, the warps summed in order
    const int steps = min(TT, T_len - t0);
    for (int k = tid; k < steps * CH; k += THREADS) {
      const int s = k / CH, cc = k % CH;
      if (cc < valid) {
        const int64_t at = row + static_cast<int64_t>(t0 + s) * dI + d0 + cc;
        dx[at] = from_f32<TX>(sout[k]);
        ddt[at] = from_f32<TP>(sout[TT * CH + k]);
      }
    }
    for (int k = tid; k < steps * 2 * N; k += THREADS) {
      const int s = k / (2 * N), e = k % (2 * N);
      float p = 0.f;
#pragma unroll
      for (int w = 0; w < Smem::WARPS; ++w) p += red[(w * TT + s) * 2 * N + e];
      const int64_t at =
          ((static_cast<int64_t>(blockIdx.x) * B + b) * T_len + t0 + s) * N +
          e % N;
      (e < N ? dB_part : dC_part)[at] = p;
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
// contiguous in x's dtype; h_chunks (B,ceil(T/16),dI,N) contiguous f32, the
// forward's state at the end of every 16 steps. Writes dx
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
