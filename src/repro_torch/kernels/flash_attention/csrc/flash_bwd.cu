// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention/kernel.py::
// flash_attention_bwd: _dq_kernel (flash_bwd_dq below) and _dkv_kernel
// (flash_bwd_dkv). Both recompute s = q k^T * scale and p = exp(s - lse)
// from the forward's row logsumexp, and take delta = rowsum(do * out)
// (one f32 reduction done by the wrapper, as the JAX package does in jnp):
//   dp = do v^T,  ds = p (dp - delta) scale,
//   dq = ds k,    dk = ds^T q,    dv = p^T do.
//
// Design, against the TPU version:
//   * the TPU grid carries a dq (or dk/dv) sum in scratch across its
//     sequential minor grid axis; here one thread block owns one output
//     tile and loops over its band itself, so no sum crosses blocks and
//     no atomics are needed;
//   * dq: one block per (q tile of BQ rows, head h, batch b), looping over
//     the kv tiles of the causal/window band of that q tile;
//   * dk/dv: one block per (kv tile of BK keys, kv head kh, batch b),
//     looping over the G = H/K query heads of its group and, for each,
//     over the q tiles of the band of that kv tile. It writes (B,S,K,D)
//     directly: the JAX wrapper instead repeats kv heads to H and lets
//     jnp.repeat's VJP sum the group (src/repro/kernels/flash_attention/
//     ops.py::flash_attention);
//   * the model layout (B,T,H,D) / (B,S,K,D) is read through strides;
//     ragged edges (t >= T, s >= S) are zero-filled on load and masked;
//   * masked pairs get p = 0 explicitly, and a row whose lse is -inf
//     contributes nothing: exp(-inf - -inf) is never formed;
//   * arithmetic is f32 on the CUDA cores (scalar FMA), as in flash_fwd.cu.
//
// Bound at the training shape (yi-6b: B=4, T=S=1024, H=32, K=4, D=128,
// causal, bf16), computed from shapes, not measured:
//   dq   6*D FLOP per unmasked (q,k) pair per head = 5.16e10 -> 52 us at
//        989 TFLOP/s; ~110 MB moved -> 33 us at 3.35 TB/s;
//   dk/dv 8*D FLOP per pair = 6.88e10 -> 70 us; ~85 MB -> 25 us;
// so both are bound by operations on the tensor cores. These kernels use
// none (67 TFLOP/s f32 peak): wgmma, TMA and pipelining are later work.
//
// Warp layout (both kernels): tiles of 32 x 32 (q rows x keys); NWARPS
// warps each own ROWS rows of the block's own tile, keep their f32
// accumulators in registers (d = lane + 32 c), and let lane index the
// other tile's rows when forming s and dp.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr int NWARPS = 4;
constexpr int ROWS = 32 / NWARPS;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ bool allowed(int row, int key, int T_len, int S_len,
                                        int causal, int window) {
  return row < T_len && key < S_len && (!causal || key <= row) &&
         (window <= 0 || key > row - window);
}

// Rows read by lane index are padded to D + 4 floats: 16-byte aligned rows
// whose float4 reads by neighbouring lanes fall in different banks.
template <int D>
constexpr int dq_smem_floats() {
  // Q and dO tiles (broadcast reads), K and V tiles (lane-indexed), one
  // ds tile per warp.
  return 2 * BQ * D + 2 * BK * (D + 4) + NWARPS * ROWS * BK;
}

template <int D>
constexpr int dkv_smem_floats() {
  // K and V tiles (broadcast reads), Q and dO tiles (lane-indexed), lse and
  // delta of the Q tile, one p and one ds tile per warp.
  return 2 * BK * D + 2 * BQ * (D + 4) + 2 * BQ + 2 * NWARPS * ROWS * BQ;
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int T_len, int S_len, int H, int KH,
                    int64_t qsb, int64_t qst, int64_t qsh,
                    int64_t ksb, int64_t kss, int64_t ksh,
                    int64_t vsb, int64_t vss, int64_t vsh,
                    int64_t dsb, int64_t dst, int64_t dsh,
                    int causal, int window, float scale) {
  constexpr int DP = D + 4;
  constexpr int NC = D / 32;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + BQ * D;
  float* sk = sdo + BQ * D;
  float* sv = sk + BK * DP;
  float* sds = sv + BK * DP;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qb = q + b * qsb + h * qsh;
  const T* dob = dout + b * dsb + h * dsh;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    const bool in = t < T_len;
    sq[i] = in ? to_f32(qb[t * qst + d]) : 0.f;
    sdo[i] = in ? to_f32(dob[t * dst + d]) : 0.f;
  }

  float row_lse[ROWS], row_delta[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + warp * ROWS + i;
    const int64_t idx = (static_cast<int64_t>(b) * H + h) * T_len + row;
    row_lse[i] = row < T_len ? lse[idx] : -INFINITY;
    row_delta[i] = row < T_len ? delta[idx] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // kv band of this q tile: keys in [lo, hi)
  int lo = 0, hi = S_len;
  if (causal) hi = min(S_len, q0 + BQ);
  if (window > 0) lo = max(0, q0 - window + 1);
  lo = lo / BK * BK;

  float* dsw = sds + warp * ROWS * BK;
  const float* qw = sq + warp * ROWS * D;
  const float* dow = sdo + warp * ROWS * D;

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // previous tile fully read (and the Q, dO tiles stored)
    for (int i = threadIdx.x; i < BK * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const int s = k0 + r;
      const bool in = s < S_len;
      sk[r * DP + d] = in ? to_f32(kb[s * kss + d]) : 0.f;
      sv[r * DP + d] = in ? to_f32(vb[s * vss + d]) : 0.f;
    }
    __syncthreads();

    // s and dp of this warp's rows against key k0 + lane
    float sc[ROWS], dp[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) sc[i] = dp[i] = 0.f;
    const float* kr = sk + lane * DP;
    const float* vr = sv + lane * DP;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
      const float4 vv = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + i * D + d);
        const float4 oo = *reinterpret_cast<const float4*>(dow + i * D + d);
        sc[i] = fmaf(qq.x, kk.x, sc[i]);
        sc[i] = fmaf(qq.y, kk.y, sc[i]);
        sc[i] = fmaf(qq.z, kk.z, sc[i]);
        sc[i] = fmaf(qq.w, kk.w, sc[i]);
        dp[i] = fmaf(oo.x, vv.x, dp[i]);
        dp[i] = fmaf(oo.y, vv.y, dp[i]);
        dp[i] = fmaf(oo.z, vv.z, dp[i]);
        dp[i] = fmaf(oo.w, vv.w, dp[i]);
      }
    }

    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = q0 + warp * ROWS + i;
      const bool ok = allowed(row, key, T_len, S_len, causal, window) &&
                      row_lse[i] != -INFINITY;
      const float p = ok ? expf(sc[i] * scale - row_lse[i]) : 0.f;
      dsw[i * BK + lane] = p * (dp[i] - row_delta[i]) * scale;
    }
    __syncwarp();

    // dq[i, d] += sum_j ds[i, j] k[j, d]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float kk[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kk[c] = sk[j * DP + c * 32 + lane];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float ds = dsw[i * BK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds, kk[c], acc[i][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + warp * ROWS + i;
    if (row >= T_len) continue;
    T* o = dq + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + c * 32 + lane, acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int T_len, int S_len, int H, int KH,
                     int64_t qsb, int64_t qst, int64_t qsh,
                     int64_t ksb, int64_t kss, int64_t ksh,
                     int64_t vsb, int64_t vss, int64_t vsh,
                     int64_t dsb, int64_t dst, int64_t dsh,
                     int causal, int window, float scale) {
  constexpr int DP = D + 4;
  constexpr int NC = D / 32;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + BK * D;
  float* sq = sv + BK * D;
  float* sdo = sq + BQ * DP;
  float* slse = sdo + BQ * DP;
  float* sdelta = slse + BQ;
  float* sp = sdelta + BQ;
  float* sds = sp + NWARPS * ROWS * BQ;

  const int k0 = blockIdx.x * BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;
  for (int i = threadIdx.x; i < BK * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int s = k0 + r;
    const bool in = s < S_len;
    sk[i] = in ? to_f32(kb[s * kss + d]) : 0.f;
    sv[i] = in ? to_f32(vb[s * vss + d]) : 0.f;
  }

  float acc_k[ROWS][NC], acc_v[ROWS][NC];
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  // q band of this kv tile: rows in [lo, hi)
  int lo = 0, hi = T_len;
  if (causal) lo = k0;
  if (window > 0) hi = min(T_len, k0 + BK - 1 + window);
  lo = lo / BQ * BQ;

  const float* kw = sk + warp * ROWS * D;
  const float* vw = sv + warp * ROWS * D;
  float* pw = sp + warp * ROWS * BQ;
  float* dsw = sds + warp * ROWS * BQ;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qb = q + b * qsb + h * qsh;
    const T* dob = dout + b * dsb + h * dsh;
    const int64_t lrow = (static_cast<int64_t>(b) * H + h) * T_len;
    for (int q0 = lo; q0 < hi; q0 += BQ) {
      __syncthreads();  // previous tile fully read (and the K, V tiles stored)
      for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        const int t = q0 + r;
        const bool in = t < T_len;
        sq[r * DP + d] = in ? to_f32(qb[t * qst + d]) : 0.f;
        sdo[r * DP + d] = in ? to_f32(dob[t * dst + d]) : 0.f;
      }
      for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
        const int t = q0 + r;
        slse[r] = t < T_len ? lse[lrow + t] : -INFINITY;
        sdelta[r] = t < T_len ? delta[lrow + t] : 0.f;
      }
      __syncthreads();

      // s and dp of this warp's keys against query row q0 + lane
      float sc[ROWS], dp[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) sc[j] = dp[j] = 0.f;
      const float* qr = sq + lane * DP;
      const float* dor = sdo + lane * DP;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qr + d);
        const float4 oo = *reinterpret_cast<const float4*>(dor + d);
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          const float4 kk = *reinterpret_cast<const float4*>(kw + j * D + d);
          const float4 vv = *reinterpret_cast<const float4*>(vw + j * D + d);
          sc[j] = fmaf(qq.x, kk.x, sc[j]);
          sc[j] = fmaf(qq.y, kk.y, sc[j]);
          sc[j] = fmaf(qq.z, kk.z, sc[j]);
          sc[j] = fmaf(qq.w, kk.w, sc[j]);
          dp[j] = fmaf(oo.x, vv.x, dp[j]);
          dp[j] = fmaf(oo.y, vv.y, dp[j]);
          dp[j] = fmaf(oo.z, vv.z, dp[j]);
          dp[j] = fmaf(oo.w, vv.w, dp[j]);
        }
      }

      const int row = q0 + lane;
      const float l = slse[lane];
      const float dl = sdelta[lane];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int key = k0 + warp * ROWS + j;
        const bool ok = allowed(row, key, T_len, S_len, causal, window) &&
                        l != -INFINITY;
        const float p = ok ? expf(sc[j] * scale - l) : 0.f;
        pw[j * BQ + lane] = p;
        dsw[j * BQ + lane] = p * (dp[j] - dl) * scale;
      }
      __syncwarp();

      // dv[j, d] += sum_i p[j, i] do[i, d];  dk[j, d] += sum_i ds[j, i] q[i, d]
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float qq[NC], oo[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          qq[c] = sq[i * DP + c * 32 + lane];
          oo[c] = sdo[i * DP + c * 32 + lane];
        }
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          const float p = pw[j * BQ + i];
          const float ds = dsw[j * BQ + i];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc_v[j][c] = fmaf(p, oo[c], acc_v[j][c]);
            acc_k[j][c] = fmaf(ds, qq[c], acc_k[j][c]);
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int key = k0 + warp * ROWS + j;
    if (key >= S_len) continue;
    const int64_t off = ((static_cast<int64_t>(b) * S_len + key) * KH + kh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(dk + off + c * 32 + lane, acc_k[j][c]);
      store(dv + off + c * 32 + lane, acc_v[j][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, T_len, S_len, H, KH;
  long long st[12];
  int causal, window;
  float scale;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T_len + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_kernel<T, D><<<grid, NWARPS * 32, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.T_len, a.S_len, a.H, a.KH, a.st[0],
      a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7], a.st[8],
      a.st[9], a.st[10], a.st[11], a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S_len + BK - 1) / BK, a.KH, a.B);
  flash_bwd_dkv_kernel<T, D><<<grid, NWARPS * 32, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.T_len,
      a.S_len, a.H, a.KH, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4],
      a.st[5], a.st[6], a.st[7], a.st[8], a.st[9], a.st[10], a.st[11],
      a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int which, int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 32: return which == 0 ? launch_dq<T, 32>(a, s) : launch_dkv<T, 32>(a, s);
    case 64: return which == 0 ? launch_dq<T, 64>(a, s) : launch_dkv<T, 64>(a, s);
    case 128: return which == 0 ? launch_dq<T, 128>(a, s) : launch_dkv<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, int B, int T_len, int S_len, int H, int KH, int D,
        const long long* st, int causal, int window, float scale, int dtype,
        void* stream) {
  if (B <= 0 || T_len <= 0 || S_len <= 0 || KH <= 0 || H % KH != 0)
    return cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, dk, dv, B, T_len, S_len, H, KH,
         {}, causal, window, scale};
  for (int i = 0; i < 12; ++i) a.st[i] = st[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(which, D, a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(which, D, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B,T,H,D), do (B,T,H,D), k and v (B,S,K,D), all of one dtype, with unit
// stride over D and element strides (batch, position, head) in
// q_, k_, v_, do_strides; lse and delta (B,H,T) contiguous f32.
// flash_bwd_dq writes dq (B,T,H,D) contiguous; flash_bwd_dkv writes dk and
// dv (B,S,K,D) contiguous; both in the inputs' dtype.
// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Each returns the cudaError_t of its launch (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int T_len,
                            int S_len, int H, int KH, int D, long long qsb,
                            long long qst, long long qsh, long long ksb,
                            long long kss, long long ksh, long long vsb,
                            long long vss, long long vsh, long long dsb,
                            long long dst, long long dsh, int causal,
                            int window, float scale, int dtype, void* stream) {
  const long long st[12] = {qsb, qst, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, dsb, dst, dsh};
  return run(0, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, T_len,
             S_len, H, KH, D, st, causal, window, scale, dtype, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int T_len, int S_len, int H, int KH, int D,
                             long long qsb, long long qst, long long qsh,
                             long long ksb, long long kss, long long ksh,
                             long long vsb, long long vss, long long vsh,
                             long long dsb, long long dst, long long dsh,
                             int causal, int window, float scale, int dtype,
                             void* stream) {
  const long long st[12] = {qsb, qst, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, dsb, dst, dsh};
  return run(1, q, k, v, dout, lse, delta, nullptr, dk, dv, B, T_len, S_len,
             H, KH, D, st, causal, window, scale, dtype, stream);
}
