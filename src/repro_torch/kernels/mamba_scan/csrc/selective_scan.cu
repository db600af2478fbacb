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
// Design, against the TPU version:
//   * one thread per (b, d) channel holds its N states and its A row in
//     registers and walks all T steps itself; the TPU grid carries the
//     state across time blocks in VMEM scratch, which CUDA blocks, run
//     in no order, cannot do;
//   * a block is BD channels of one batch row, so every thread of a block
//     reads the same B_t and C_t: they are staged TT steps at a time in
//     shared memory, while x and dt (contiguous over d: coalesced) go to
//     registers; the next tile's loads are issued before the current
//     tile is computed, so their latency hides behind its exps;
//   * ragged T and dI are masked here (the TPU wrapper asserts that its
//     blocks divide them); inputs are read through strides (unit stride
//     over d and n);
//   * exp(dt * A) is exp2(dt * A * log2 e), one ex2 on the SFU per state.
//
// Bound at the serving shape (jamba prefill: B=4, T=1024, dI=8192, N=16,
// x bf16, dt/B/C f32), computed from shapes, not measured:
//   bytes  x 67 MB + dt 134 MB + y 67 MB + B, C, A, D, h_T ~ 3 MB
//          ~ 271 MB -> 0.081 ms at 3.35 TB/s
//   f32    ~ 6 flops per (b, t, d, n) = 3.2e9 -> 0.048 ms at 67 TFLOP/s
//   exps   B*T*dI*N = 5.4e8 ex2 at 16 per clock per SM -> ~0.13-0.15 ms
// so the SFU's exps bind it. Occupancy is low at that shape (B*dI =
// 32,768 threads, ~8 warps an SM), and each step's N exps and FMAs are a
// dependent chain through h: splitting N over lanes, and more channels in
// flight, are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BD = 128;   // channels (threads) per block
constexpr int TT = 16;    // time steps per staged tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// TX: x and y; TP: dt, B and C (float, or TX's bfloat16).
template <typename TX, typename TP, int N>
__global__ void __launch_bounds__(BD)
selective_scan_kernel(const TX* __restrict__ x, const TP* __restrict__ dt,
                      const float* __restrict__ A,
                      const TP* __restrict__ Bc, const TP* __restrict__ Cc,
                      const float* __restrict__ Dv, TX* __restrict__ y,
                      float* __restrict__ h_out, int T_len, int dI,
                      int64_t xsb, int64_t xst, int64_t dsb, int64_t dst,
                      int64_t bsb, int64_t bst, int64_t csb, int64_t cst) {
  // B and C values of one tile that each thread loads (TT*N of each)
  constexpr int PER = (TT * N + BD - 1) / BD;
  __shared__ float sB[TT * N];
  __shared__ float sC[TT * N];

  const int b = blockIdx.y;
  const int d = blockIdx.x * BD + threadIdx.x;
  const bool active = d < dI;
  const int dc = active ? d : 0;   // a valid channel for address arithmetic

  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = active ? A[static_cast<int64_t>(dc) * N + n] * LOG2E : 0.f;
    h[n] = 0.f;
  }
  const float dd = active ? Dv[dc] : 0.f;

  const TX* xb = x + b * xsb + dc;
  const TP* db = dt + b * dsb + dc;
  const TP* bb = Bc + b * bsb;
  const TP* cb = Cc + b * csb;
  TX* yb = y + static_cast<int64_t>(b) * T_len * dI + dc;

  float xr[TT], dr[TT], br[PER], cr[PER];
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int s = 0; s < TT; ++s) {
      const int t = t0 + s;
      const bool in = active && t < T_len;
      xr[s] = in ? to_f32(xb[t * xst]) : 0.f;
      dr[s] = in ? to_f32(db[t * dst]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * BD;
      const int t = t0 + i / N, n = i % N;
      const bool in = i < TT * N && t < T_len;
      br[j] = in ? to_f32(bb[t * bst + n]) : 0.f;
      cr[j] = in ? to_f32(cb[t * cst + n]) : 0.f;
    }
  };

  load_tile(0);
  for (int t0 = 0; t0 < T_len; t0 += TT) {
    __syncthreads();  // the previous tile's sB/sC fully read
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * BD;
      if (i < TT * N) {
        sB[i] = br[j];
        sC[i] = cr[j];
      }
    }
    float xc[TT], dtc[TT];
#pragma unroll
    for (int s = 0; s < TT; ++s) {
      xc[s] = xr[s];
      dtc[s] = dr[s];
    }
    __syncthreads();
    if (t0 + TT < T_len) load_tile(t0 + TT);  // in flight during the tile

    const int steps = min(TT, T_len - t0);
#pragma unroll
    for (int s = 0; s < TT; ++s) {
      if (s < steps) {
        const float dx = dtc[s] * xc[s];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float dA = exp2f(dtc[s] * a2[n]);
          h[n] = fmaf(dA, h[n], dx * sB[s * N + n]);
          acc = fmaf(h[n], sC[s * N + n], acc);
        }
        if (active)
          store(yb + static_cast<int64_t>(t0 + s) * dI, fmaf(dd, xc[s], acc));
      }
    }
  }

  if (h_out != nullptr && active) {
    float* hb = h_out + (static_cast<int64_t>(b) * dI + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hb[n] = h[n];
  }
}

template <typename TX, typename TP>
cudaError_t dispatch_n(int N, const void* x, const void* dt, const void* A,
                       const void* Bc, const void* Cc, const void* D,
                       void* y, void* h_out, int B, int T_len, int dI,
                       const long long* st, cudaStream_t stream) {
  const dim3 grid((dI + BD - 1) / BD, B);
#define SCAN_LAUNCH(NN)                                                     \
  selective_scan_kernel<TX, TP, NN><<<grid, BD, 0, stream>>>(               \
      static_cast<const TX*>(x), static_cast<const TP*>(dt),                \
      static_cast<const float*>(A), static_cast<const TP*>(Bc),             \
      static_cast<const TP*>(Cc), static_cast<const float*>(D),             \
      static_cast<TX*>(y), static_cast<float*>(h_out), T_len, dI, st[0],    \
      st[1], st[2], st[3], st[4], st[5], st[6], st[7])
  switch (N) {
    case 4: SCAN_LAUNCH(4); break;
    case 8: SCAN_LAUNCH(8); break;
    case 16: SCAN_LAUNCH(16); break;
    default: return cudaErrorInvalidValue;
  }
#undef SCAN_LAUNCH
  return cudaGetLastError();
}

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && p_dtype == 0)
    return dispatch_n<float, float>(N, x, dt, A, Bc, Cc, D, y, h_out, B,
                                    T_len, dI, st, s);
  if (x_dtype == 1 && p_dtype == 0)
    return dispatch_n<__nv_bfloat16, float>(N, x, dt, A, Bc, Cc, D, y, h_out,
                                            B, T_len, dI, st, s);
  if (x_dtype == 1 && p_dtype == 1)
    return dispatch_n<__nv_bfloat16, __nv_bfloat16>(N, x, dt, A, Bc, Cc, D, y,
                                                    h_out, B, T_len, dI, st,
                                                    s);
  return cudaErrorInvalidValue;
}
