// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd (_fwd_kernel, _mask, _block_needed): causal,
// sliding-window or non-causal softmax(Q K^T * scale) V with an online
// softmax whose (acc, m, l) stay in f32 on chip, returning the output in
// the input dtype and the row logsumexp in f32.
//
// Design, against the TPU version:
//   * one thread block per (q tile of BQ rows, head h, batch b); the
//     block loops over only the kv tiles the causal/window band needs,
//     where the TPU grid steps over every kv block and skips the masked
//     ones with pl.when;
//   * it reads the model layout (B,T,H,D) / (B,S,K,D) through strides
//     and takes kv head h / (H/K), so the wrapper neither repeats kv
//     heads (GQA) nor transposes;
//   * it masks the ragged edges (t >= T, s >= S) itself, so any length
//     works; the TPU version asserts T % bq == 0 and S % bk == 0;
//   * arithmetic is f32 on the CUDA cores (scalar FMA): bf16 inputs are
//     widened on load, f32 inputs stay true f32 (no TF32).
//
// Bound at the serving shape (yi-6b prefill: B=4, T=S=1024, H=32, K=4,
// D=128, causal, bf16), computed from shapes, not measured:
//   useful work  4*D*B*H*T(T+1)/2 = 3.44e10 FLOP -> 34.7 us at 989 TFLOP/s
//   bytes        q,k,v read + out, lse written ~ 76 MB -> 22.7 us at 3.35 TB/s
// so the function is compute-bound at ~35 us per launch on the tensor
// cores. This kernel uses no tensor cores (67 TFLOP/s f32 peak): wgmma,
// TMA and pipelining are later work.
//
// Warp layout: BK = 32 keys per kv tile, one key per lane for the scores;
// each of the NWARPS warps owns ROWS query rows and keeps their m, l and
// ROWS x D/32 accumulator columns (d = lane + 32 c) in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr int NWARPS = 4;
constexpr int ROWS = BQ / NWARPS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr int smem_floats() {
  // Q tile, K tile (rows padded to D + 4 floats: 16-byte aligned rows whose
  // float4 reads by neighbouring lanes fall in different banks), V tile,
  // and one P tile per warp.
  return BQ * D + BK * (D + 4) + BK * D + NWARPS * ROWS * BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int T_len, int S_len, int H, int KH,
                 int64_t qsb, int64_t qst, int64_t qsh,
                 int64_t ksb, int64_t kss, int64_t ksh,
                 int64_t vsb, int64_t vss, int64_t vsh,
                 int causal, int window, float scale) {
  constexpr int DP = D + 4;
  constexpr int NC = D / 32;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + BQ * D;
  float* sv = sk + BK * DP;
  float* sp = sv + BK * D;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    sq[i] = t < T_len ? to_f32(qb[t * qst + d]) : 0.f;
  }

  // kv band of this q tile: keys in [lo, hi)
  int lo = 0, hi = S_len;
  if (causal) hi = min(S_len, q0 + BQ);
  if (window > 0) lo = max(0, q0 - window + 1);
  lo = lo / BK * BK;

  float m[ROWS], l[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  float* pw = sp + warp * ROWS * BK;
  const float* qw = sq + warp * ROWS * D;

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // previous tile fully read (and the Q tile stored)
    for (int i = threadIdx.x; i < BK * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const int s = k0 + r;
      const bool in = s < S_len;
      sk[r * DP + d] = in ? to_f32(kb[s * kss + d]) : 0.f;
      sv[i] = in ? to_f32(vb[s * vss + d]) : 0.f;
    }
    __syncthreads();

    // scores of this warp's rows against key k0 + lane
    float sc[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) sc[i] = 0.f;
    const float* kr = sk + lane * DP;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + i * D + d);
        sc[i] = fmaf(qq.x, kk.x, sc[i]);
        sc[i] = fmaf(qq.y, kk.y, sc[i]);
        sc[i] = fmaf(qq.z, kk.z, sc[i]);
        sc[i] = fmaf(qq.w, kk.w, sc[i]);
      }
    }

    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = q0 + warp * ROWS + i;
      const bool ok = key < S_len && (!causal || key <= row) &&
                      (window <= 0 || key > row - window);
      const float x = ok ? sc[i] * scale : -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // while a row has seen no unmasked key, m_new is -inf: keep p = 0
      const float p = m_new == -INFINITY ? 0.f : expf(x - m_new);
      const float corr = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(FULL, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      pw[i * BK + lane] = p;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sv[j * D + c * 32 + lane];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = pw[i * BK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + warp * ROWS + i;
    if (row >= T_len) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    T* o = out + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + c * 32 + lane, acc[i][c] * inv);
    if (lane == 0)
      lse[(static_cast<int64_t>(b) * H + h) * T_len + row] = m[i] + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int T_len, int S_len, int H, int KH,
                   const long long* st, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NWARPS * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), T_len, S_len, H, KH, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* out, void* lse, int B, int T_len, int S_len,
                       int H, int KH, const long long* st, int causal,
                       int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, T_len, S_len, H, KH, st,
                           causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, T_len, S_len, H, KH, st,
                           causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, T_len, S_len, H, KH, st,
                            causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,T,H,D), k and v (B,S,K,D) with unit stride over D and element
// strides (batch, position, head) in q_strides / k_strides / v_strides;
// out (B,T,H,D) contiguous in q's dtype; lse (B,H,T) contiguous f32.
// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int T_len, int S_len,
                         int H, int KH, int D, long long qsb, long long qst,
                         long long qsh, long long ksb, long long kss,
                         long long ksh, long long vsb, long long vss,
                         long long vsh, int causal, int window, float scale,
                         int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || S_len <= 0 || KH <= 0 || H % KH != 0)
    return cudaErrorInvalidValue;
  const long long st[9] = {qsb, qst, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, out, lse, B, T_len, S_len, H, KH,
                             st, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, lse, B, T_len, S_len,
                                     H, KH, st, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
