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
// Kernels, picked by dtype before the launch:
//   * bf16: flash_bwd_dq_wgmma_kernel and flash_bwd_dkv_wgmma_kernel, on
//     the tensor cores;
//   * f32: flash_bwd_dq_f32_kernel and flash_bwd_dkv_f32_kernel, scalar
//     f32 FMA on the CUDA cores (true f32, no TF32), which the f32 model
//     checks depend on.
//
// All of them, against the TPU version:
//   * the TPU grid carries a dq (or dk/dv) sum in scratch across its
//     sequential minor grid axis; here one thread block owns one output
//     tile and loops over its band itself, so no sum crosses blocks and
//     no atomics are needed: the result is deterministic;
//   * dq: one block per (q tile of BQ rows, head h, batch b), looping over
//     the kv tiles of the causal/window band of that q tile;
//   * dk/dv: one block per (kv tile, kv head kh, batch b), looping over
//     the G = H/K query heads of its group and, for each, over the q tiles
//     of the band of that kv tile. It writes (B,S,K,D) directly: the JAX
//     wrapper instead repeats kv heads to H and lets jnp.repeat's VJP sum
//     the group (src/repro/kernels/flash_attention/ops.py::flash_attention);
//   * the model layout (B,T,H,D) / (B,S,K,D) is read through strides;
//     ragged edges (t >= T, s >= S) are zero-filled on load and masked;
//   * masked pairs get p = 0 explicitly, and a row whose lse is -inf
//     contributes nothing: exp(-inf - -inf) is never formed.
//
// Bound at the training shape (yi-6b: B=4, T=S=1024, H=32, K=4, D=128,
// causal, bf16), computed from shapes, not measured:
//   dq   6*D FLOP per unmasked (q,k) pair per head = 5.16e10 -> 52 us at
//        989 TFLOP/s; ~110 MB moved -> 33 us at 3.35 TB/s;
//   dk/dv 8*D FLOP per pair = 6.88e10 -> 70 us; ~85 MB -> 25 us;
// so both are bound by operations on the tensor cores.
//
// f32 layout: tiles of 32 x 32 (q rows x keys); NWARPS
// warps each own ROWS rows of the block's own tile, keep their f32
// accumulators in registers (d = lane + 32 c; at D = 16 lanes 16 to 31
// hold no column), and let lane index the other tile's rows when forming
// s and dp.
//
// bf16 dk/dv design (flash_bwd_dkv_wgmma_kernel), hopper.cuh for the
// building blocks:
//   * a block is one consumer warpgroup (128 threads) on a kv tile of 64
//     keys; it steps over (query head g, q tile of 64 rows) and computes
//     the transposed products, so that each accumulator feeds the next
//     product as it lies:
//       S^T  = K Q^T and dP^T = V dO^T   (wgmma m64n64k16, all K-major),
//       P^T  = exp2(S^T scale log2 e - lse log2 e), masked,
//       dS^T = P^T (dP^T - delta) scale  (lse, delta by the fragment's
//              column, from shared memory),
//       dV  += P^T dO and dK += dS^T Q  (wgmma m64nDk16, P^T and dS^T bf16
//              register A operands, dO and Q the MN-major B operands of
//              the same [t][d] tiles);
//     dK and dV stay in f32 registers (D/2 each a thread) to the end;
//   * K and V arrive once; the Q, dO, lse and delta of each step stream
//     through a ring of STAGES by cp.async (16-byte chunks, zero-filled
//     past T and S; lse and delta 4 bytes each);
//   * causal imbalance: kv tile 0, which walks every q tile, launches
//     first (the kv tile index is the grid's slowest dimension), and 64-key
//     tiles give the training shape 256 blocks, two resident on each SM.
//
// bf16 dq design (flash_bwd_dq_wgmma_kernel), row-major like the forward
// (flash_fwd.cu), whose layout it follows:
//   * a block is 2 consumer warpgroups (256 threads) on a q tile of 128
//     rows, 64 rows each, of one (batch, head); its Q and dO tiles arrive
//     once, and each thread reads the lse and delta of its two rows once
//     into registers (lse -inf, or a row past T, gives p = 0);
//   * it walks the kv tiles (64 keys) of the causal/window band; K and V
//     stream through a ring of STAGES = 3 by 16-byte cp.async, the copies
//     of tile j+2 running while tile j is multiplied;
//   * per kv tile: S = Q K^T and dP = dO V^T (wgmma m64n64k16, all
//     K-major) as two commit groups, so that P = exp2(S scale log2 e -
//     lse log2 e), masked at the causal diagonal, the window's edge and
//     keys >= S, is formed while dP is still on the tensor cores; then
//     dS = P (dP - delta) scale, rounded once to bf16 pairs as the
//     register A operand of dQ += dS K (wgmma m64nDk16), K the MN-major B
//     operand of the same [s][d] tile, as V is in the forward's O += P V;
//   * dQ stays in f32 registers (D/2 a thread) and is written as bf16
//     pairs from the fragment; each block owns its dq tile: no atomics,
//     and the result is bit-identical from launch to launch;
//   * a warpgroup whose rows see no key of a tile skips it; under a
//     causal mask the heaviest q tiles launch first (the q tile index
//     runs backwards through the grid's slowest dimension);
//   * 128 rows and not 64: Q and dO (64 KB at D = 128) are loaded once
//     for twice the rows, and each K/V tile serves two warpgroups. The
//     f32 accumulators (dQ 64, S 32, dP 32 a thread at D = 128) allow one
//     block an SM either way, so its 161 KB of shared memory (3 stages)
//     costs no occupancy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr int NWARPS = 4;
constexpr int ROWS = 32 / NWARPS;

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
// dq, f32: scalar FMA
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int T_len, int S_len, int H,
                        int KH, int64_t qsb, int64_t qst, int64_t qsh,
                        int64_t ksb, int64_t kss, int64_t ksh,
                        int64_t vsb, int64_t vss, int64_t vsh,
                        int64_t dsb, int64_t dst, int64_t dsh,
                        int causal, int window, float scale) {
  constexpr int DP = D + 4;
  constexpr int NC = (D + 31) / 32;
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
  const bool lane_col = D % 32 == 0 || lane < D % 32;  // holds column lane

  const float* qb = q + b * qsb + h * qsh;
  const float* dob = dout + b * dsb + h * dsh;
  const float* kb = k + b * ksb + kh * ksh;
  const float* vb = v + b * vsb + kh * vsh;

  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    const bool in = t < T_len;
    sq[i] = in ? qb[t * qst + d] : 0.f;
    sdo[i] = in ? dob[t * dst + d] : 0.f;
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
      sk[r * DP + d] = in ? kb[s * kss + d] : 0.f;
      sv[r * DP + d] = in ? vb[s * vss + d] : 0.f;
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
      for (int c = 0; c < NC; ++c)
        kk[c] = lane_col ? sk[j * DP + c * 32 + lane] : 0.f;
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
    float* o = dq + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lane_col) o[c * 32 + lane] = acc[i][c];
  }
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int T_len, int S_len, int H, int KH,
                         int64_t qsb, int64_t qst, int64_t qsh,
                         int64_t ksb, int64_t kss, int64_t ksh,
                         int64_t vsb, int64_t vss, int64_t vsh,
                         int64_t dsb, int64_t dst, int64_t dsh,
                         int causal, int window, float scale) {
  constexpr int DP = D + 4;
  constexpr int NC = (D + 31) / 32;
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
  const bool lane_col = D % 32 == 0 || lane < D % 32;  // holds column lane

  const float* kb = k + b * ksb + kh * ksh;
  const float* vb = v + b * vsb + kh * vsh;
  for (int i = threadIdx.x; i < BK * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int s = k0 + r;
    const bool in = s < S_len;
    sk[i] = in ? kb[s * kss + d] : 0.f;
    sv[i] = in ? vb[s * vss + d] : 0.f;
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
    const float* qb = q + b * qsb + h * qsh;
    const float* dob = dout + b * dsb + h * dsh;
    const int64_t lrow = (static_cast<int64_t>(b) * H + h) * T_len;
    for (int q0 = lo; q0 < hi; q0 += BQ) {
      __syncthreads();  // previous tile fully read (and the K, V tiles stored)
      for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        const int t = q0 + r;
        const bool in = t < T_len;
        sq[r * DP + d] = in ? qb[t * qst + d] : 0.f;
        sdo[r * DP + d] = in ? dob[t * dst + d] : 0.f;
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
          qq[c] = lane_col ? sq[i * DP + c * 32 + lane] : 0.f;
          oo[c] = lane_col ? sdo[i * DP + c * 32 + lane] : 0.f;
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
      if (!lane_col) continue;
      dk[off + c * 32 + lane] = acc_k[j][c];
      dv[off + c * 32 + lane] = acc_v[j][c];
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv, bf16: wgmma
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int DKV_BK = 64;   // keys a block: one consumer warpgroup
constexpr int DKV_BQ = 64;   // query rows a step

template <int D>
struct DkvSmem {
  static constexpr int STAGES = 2;                 // Q/dO/lse/delta ring
  static constexpr int KV_BYTES = DKV_BK * D * 2;
  static constexpr int Q_BYTES = DKV_BQ * D * 2;
  // K, V, then STAGES x (Q, dO), then STAGES x (lse, delta); 1024 more to
  // align the base
  static constexpr int ROWS_OFF = 2 * KV_BYTES + STAGES * 2 * Q_BYTES;
  static constexpr int BYTES = ROWS_OFF + STAGES * 2 * DKV_BQ * 4 + 1024;
};

template <int D>
__global__ void __launch_bounds__(128, 2)
flash_bwd_dkv_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int T_len, int S_len, int H, int KH,
                           int64_t qsb, int64_t qst, int64_t qsh,
                           int64_t ksb, int64_t kss, int64_t ksh,
                           int64_t vsb, int64_t vss, int64_t vsh,
                           int64_t dsb, int64_t dst, int64_t dsh,
                           int causal, int window, float scale) {
  using namespace hopper;
  using Smem = DkvSmem<D>;
  constexpr int STAGES = Smem::STAGES;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(sm);
  const uint32_t sk = base, sv = base + Smem::KV_BYTES;
  auto sq = [&](int s) { return base + 2 * Smem::KV_BYTES + s * 2 * Smem::Q_BYTES; };
  auto sdo = [&](int s) { return sq(s) + Smem::Q_BYTES; };
  auto srow = [&](int s) {  // lse at [0, BQ), delta at [BQ, 2 BQ)
    return reinterpret_cast<float*>(sm + Smem::ROWS_OFF) + s * 2 * DKV_BQ;
  };

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * DKV_BK;
  const int G = H / KH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // q band of this kv tile: rows in [lo, lo + n_qt * BQ)
  int lo = 0, hi = T_len;
  if (causal) lo = k0;
  if (window > 0) hi = min(T_len, k0 + DKV_BK - 1 + window);
  lo = lo / DKV_BQ * DKV_BQ;
  const int n_qt = hi > lo ? (hi - lo + DKV_BQ - 1) / DKV_BQ : 0;
  const int n_steps = G * n_qt;

  load_tile<DKV_BK, D>(sk, k + b * ksb + kh * ksh + k0 * kss, kss, S_len - k0,
                       tid, 128);
  load_tile<DKV_BK, D>(sv, v + b * vsb + kh * vsh + k0 * vss, vss, S_len - k0,
                       tid, 128);
  cp_async_commit();
  // step i: query head kh * G + i / n_qt, q tile i % n_qt
  auto load_step = [&](int i) {
    const int h = kh * G + i / n_qt;
    const int t0 = lo + (i % n_qt) * DKV_BQ;
    const int s = i % STAGES;
    load_tile<DKV_BQ, D>(sq(s), q + b * qsb + h * qsh + t0 * qst, qst,
                         T_len - t0, tid, 128);
    load_tile<DKV_BQ, D>(sdo(s), dout + b * dsb + h * dsh + t0 * dst, dst,
                         T_len - t0, tid, 128);
    const int r = tid % DKV_BQ;
    const float* src = (tid < DKV_BQ ? lse : delta) +
                       (static_cast<int64_t>(b) * H + h) * T_len;
    const bool in = t0 + r < T_len;
    cp_async_4(smem_u32(srow(s) + tid), in ? src + t0 + r : src, in ? 4 : 0);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_steps) load_step(i);
    cp_async_commit();
  }

  // this thread's two keys: key (d[4j+0..1]) and key + 8 (d[4j+2..3])
  const int key0 = k0 + warp * 16 + lane / 4;
  const int keys[2] = {key0, key0 + 8};
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<STAGES - 2>();  // step i (and K, V) landed for this thread
    fence_proxy_async();
    __syncthreads();              // ... for all; step i-1 fully read
    if (i + STAGES - 1 < n_steps) load_step(i + STAGES - 1);
    cp_async_commit();

    const int s = i % STAGES;
    const int t0 = lo + (i % n_qt) * DKV_BQ;
    float st[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st, desc_k<DKV_BK, D>(sk, 0, kk),
                   desc_k<DKV_BQ, D>(sq(s), 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<DKV_BK, D>(sv, 0, kk),
                   desc_k<DKV_BQ, D>(sdo(s), 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();

    // rows >= T have zero q and do: they add nothing; keys >= S are never
    // written. Only the causal diagonal and the window's edge need a mask.
    const bool edge = (causal && k0 + DKV_BK - 1 > t0) ||
                      (window > 0 && k0 <= t0 + DKV_BQ - 1 - window);
    const float* rl = srow(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * (lane % 4) + e;
        const float l = rl[c];
        // a row with lse = -inf has p = 0: subtract +inf
        const float l2 = l == -INFINITY ? INFINITY : l * LOG2E;
        const float dl = rl[DKV_BQ + c];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int idx = 4 * j + 2 * rr + e;
          float p = exp2f(st[idx] * scale_log2 - l2);
          const int t = t0 + c, key = keys[rr];
          if (edge && !((!causal || key <= t) &&
                        (window <= 0 || key > t - window)))
            p = 0.f;
          st[idx] = p;
          dp[idx] = p * (dp[idx] - dl) * scale;
        }
      }
    }
    uint32_t pa[DKV_BQ / 16][4], da[DKV_BQ / 16][4];
    pack_a<DKV_BQ / 16>(st, pa);
    pack_a<DKV_BQ / 16>(dp, da);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk)
      wgmma_rs<D>(dv_acc, pa[kk], desc_mn<DKV_BQ, D>(sdo(s), kk), 1);
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk)
      wgmma_rs<D>(dk_acc, da[kk], desc_mn<DKV_BQ, D>(sq(s), kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = keys[rr];
    if (key >= S_len) continue;
    const int64_t off =
        ((static_cast<int64_t>(b) * S_len + key) * KH + kh) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      const int i = 4 * c + 2 * rr;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
          __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq, bf16: wgmma
// ---------------------------------------------------------------------------

constexpr int DQ_BQ = 128;   // q rows a block: 64 a consumer warpgroup
constexpr int DQ_BK = 64;    // keys a kv tile
constexpr int DQ_THREADS = 256;

template <int D>
struct DqSmem {
  static constexpr int STAGES = 3;                 // K/V ring
  static constexpr int Q_BYTES = DQ_BQ * D * 2;
  static constexpr int KV_BYTES = DQ_BK * D * 2;
  // Q, dO, then STAGES x (K, V); every tile a multiple of 1024 bytes; 1024
  // more to align the base
  static constexpr int BYTES = 2 * Q_BYTES + STAGES * 2 * KV_BYTES + 1024;
};

// Tells the compiler that the wgmma accumulator `d` changes here, so that
// it neither reads nor moves those registers earlier, while a product that
// writes them may still be in flight.
template <int N>
__device__ __forceinline__ void fence_accumulator(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int T_len, int S_len, int H,
                          int KH, int64_t qsb, int64_t qst, int64_t qsh,
                          int64_t ksb, int64_t kss, int64_t ksh,
                          int64_t vsb, int64_t vss, int64_t vsh,
                          int64_t dsb, int64_t dst, int64_t dsh,
                          int causal, int window, float scale) {
  using namespace hopper;
  using Smem = DqSmem<D>;
  constexpr int STAGES = Smem::STAGES;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sdo = base + Smem::Q_BYTES;
  const uint32_t skv = base + 2 * Smem::Q_BYTES;  // stage s: K, then V
  auto sk = [&](int s) { return skv + s * 2 * Smem::KV_BYTES; };
  auto sv = [&](int s) { return skv + s * 2 * Smem::KV_BYTES + Smem::KV_BYTES; };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * DQ_BQ;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  const bf16* kb = k + b * ksb + kh * ksh;
  const bf16* vb = v + b * vsb + kh * vsh;

  // kv band of this q tile: keys in [lo, lo + n_tiles * BK)
  int lo = 0, hi = S_len;
  if (causal) hi = min(S_len, q0 + DQ_BQ);
  if (window > 0) lo = max(0, q0 - window + 1);
  lo = lo / DQ_BK * DQ_BK;
  const int n_tiles = hi > lo ? (hi - lo + DQ_BK - 1) / DQ_BK : 0;

  auto load_kv = [&](int j) {
    const int k0 = lo + j * DQ_BK;
    const int s = j % STAGES;
    load_tile<DQ_BK, D>(sk(s), kb + k0 * kss, kss, S_len - k0, tid,
                        DQ_THREADS);
    load_tile<DQ_BK, D>(sv(s), vb + k0 * vss, vss, S_len - k0, tid,
                        DQ_THREADS);
  };
  load_tile<DQ_BQ, D>(sq, q + b * qsb + h * qsh + q0 * qst, qst, T_len - q0,
                      tid, DQ_THREADS);
  load_tile<DQ_BQ, D>(sdo, dout + b * dsb + h * dsh + q0 * dst, dst,
                      T_len - q0, tid, DQ_THREADS);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }

  // this thread's two rows: r (d[4j+0..1]) and r + 8 (d[4j+2..3]), with
  // their lse in the log2 domain (+inf for a row past T or with lse -inf,
  // so that p = 0) and their delta
  const int r_lo = q0 + wg * 64;             // the warpgroup's first row
  const int row0 = r_lo + warp * 16 + lane / 4;
  const int rows[2] = {row0, row0 + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int64_t idx = (static_cast<int64_t>(b) * H + h) * T_len + rows[rr];
    const float l = rows[rr] < T_len ? lse[idx] : -INFINITY;
    lse2[rr] = l == -INFINITY ? INFINITY : l * LOG2E;
    dl[rr] = rows[rr] < T_len ? delta[idx] : 0.f;
  }
  const float scale_log2 = scale * LOG2E;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j (and Q, dO) landed for this thread
    fence_proxy_async();
    __syncthreads();              // ... for all; tile j-1 fully read
    if (j + STAGES - 1 < n_tiles) load_kv(j + STAGES - 1);
    cp_async_commit();

    const int k0 = lo + j * DQ_BK;
    const int s = j % STAGES;
    // a warpgroup whose rows see no key of this tile (or lie past T) skips it
    if (r_lo >= T_len || (causal && k0 > r_lo + 63) ||
        (window > 0 && k0 + DQ_BK - 1 <= r_lo - window))
      continue;

    // S = Q K^T, then dP = dO V^T, as two groups: P is formed from S while
    // dP is still on the tensor cores
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, desc_k<DQ_BQ, D>(sq, wg * 64, kk),
                   desc_k<DQ_BK, D>(sk(s), 0, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<DQ_BQ, D>(sdo, wg * 64, kk),
                   desc_k<DQ_BK, D>(sv(s), 0, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_accumulator(sc);

    const bool edge = k0 + DQ_BK > S_len ||
                      (causal && k0 + DQ_BK - 1 > r_lo) ||
                      (window > 0 && k0 <= r_lo + 63 - window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
      const int rr = (i / 2) & 1;
      float p = exp2f(sc[i] * scale_log2 - lse2[rr]);
      if (edge && !allowed(rows[rr], key, T_len, S_len, causal, window))
        p = 0.f;
      sc[i] = p;
    }
    wgmma_wait<0>();
    fence_accumulator(dp);
    // dS = P (dP - delta) scale, rounded to bf16 pairs as the A operand
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i / 2) & 1;
      sc[i] = sc[i] * (dp[i] - dl[rr]) * scale;
    }
    uint32_t da[DQ_BK / 16][4];
    pack_a<DQ_BK / 16>(sc, da);

    // dQ += dS K, K the MN-major B operand of the same [s][d] tile
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk)
      wgmma_rs<D>(acc, da[kk], desc_mn<DQ_BK, D>(sk(s), kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulator(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rows[rr];
    if (row >= T_len) continue;
    bf16* orow = dq + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
          acc[4 * c + 2 * rr], acc[4 * c + 2 * rr + 1]);
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

// what the entries write to *launched: the kernel they launched
constexpr int LAUNCHED_SCALAR = 0;
constexpr int LAUNCHED_WGMMA = 1;

template <int D>
cudaError_t launch_dq_f32(const Args& a, cudaStream_t stream, int* launched) {
  constexpr size_t bytes = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T_len + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_f32_kernel<D><<<grid, NWARPS * 32, bytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.T_len, a.S_len, a.H, a.KH,
      a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7],
      a.st[8], a.st[9], a.st[10], a.st[11], a.causal, a.window, a.scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = LAUNCHED_SCALAR;
  return err;
}

template <int D>
cudaError_t launch_dq_wgmma(const Args& a, cudaStream_t stream,
                            int* launched) {
  constexpr int bytes = DqSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, (a.T_len + DQ_BQ - 1) / DQ_BQ);
  flash_bwd_dq_wgmma_kernel<D><<<grid, DQ_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dq), a.T_len, a.S_len, a.H, a.KH,
      a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7],
      a.st[8], a.st[9], a.st[10], a.st[11], a.causal, a.window, a.scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = LAUNCHED_WGMMA;
  return err;
}

template <int D>
cudaError_t launch_dkv_f32(const Args& a, cudaStream_t stream, int* launched) {
  constexpr size_t bytes = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S_len + BK - 1) / BK, a.KH, a.B);
  flash_bwd_dkv_f32_kernel<D><<<grid, NWARPS * 32, bytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.T_len, a.S_len, a.H, a.KH, a.st[0], a.st[1], a.st[2], a.st[3],
      a.st[4], a.st[5], a.st[6], a.st[7], a.st[8], a.st[9], a.st[10],
      a.st[11], a.causal, a.window, a.scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = LAUNCHED_SCALAR;
  return err;
}

template <int D>
cudaError_t launch_dkv_wgmma(const Args& a, cudaStream_t stream,
                             int* launched) {
  constexpr int bytes = DkvSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.KH, a.B, (a.S_len + DKV_BK - 1) / DKV_BK);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, 128, bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.T_len,
      a.S_len, a.H, a.KH, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4],
      a.st[5], a.st[6], a.st[7], a.st[8], a.st[9], a.st[10], a.st[11],
      a.causal, a.window, a.scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = LAUNCHED_WGMMA;
  return err;
}

// which: 0 = dq, 1 = dk/dv; each scalar for f32 (dtype 0), wgmma for bf16
template <int D>
cudaError_t dispatch(int which, int dtype, const Args& a, cudaStream_t s,
                     int* launched) {
  if (which == 0)
    return dtype == 0 ? launch_dq_f32<D>(a, s, launched)
                      : launch_dq_wgmma<D>(a, s, launched);
  return dtype == 0 ? launch_dkv_f32<D>(a, s, launched)
                    : launch_dkv_wgmma<D>(a, s, launched);
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, int B, int T_len, int S_len, int H, int KH, int D,
        const long long* st, int causal, int window, float scale, int dtype,
        void* stream, int* launched) {
  if (B <= 0 || T_len <= 0 || S_len <= 0 || KH <= 0 || H % KH != 0 ||
      B > 65535 || (S_len + DKV_BK - 1) / DKV_BK > 65535 ||
      (T_len + DQ_BQ - 1) / DQ_BQ > 65535)
    return cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, dk, dv, B, T_len, S_len, H, KH,
         {}, causal, window, scale};
  for (int i = 0; i < 12; ++i) a.st[i] = st[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (D) {
    case 16: return dispatch<16>(which, dtype, a, s, launched);
    case 32: return dispatch<32>(which, dtype, a, s, launched);
    case 64: return dispatch<64>(which, dtype, a, s, launched);
    case 128: return dispatch<128>(which, dtype, a, s, launched);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,T,H,D), do (B,T,H,D), k and v (B,S,K,D), all of one dtype, with unit
// stride over D and element strides (batch, position, head) in
// q_, k_, v_, do_strides; lse and delta (B,H,T) contiguous f32.
// flash_bwd_dq writes dq (B,T,H,D) contiguous; flash_bwd_dkv writes dk and
// dv (B,S,K,D) contiguous; both in the inputs' dtype.
// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Each returns the cudaError_t of its launch (0 on success); on success
// *launched names the kernel that ran: 0 the scalar one (f32), 1 the
// wgmma one (bf16, which needs 16-byte aligned pointers and strides: the
// wrapper checks).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int T_len,
                            int S_len, int H, int KH, int D, long long qsb,
                            long long qst, long long qsh, long long ksb,
                            long long kss, long long ksh, long long vsb,
                            long long vss, long long vsh, long long dsb,
                            long long dst, long long dsh, int causal,
                            int window, float scale, int dtype, void* stream,
                            int* launched) {
  const long long st[12] = {qsb, qst, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, dsb, dst, dsh};
  return run(0, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, T_len,
             S_len, H, KH, D, st, causal, window, scale, dtype, stream,
             launched);
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
                             void* stream, int* launched) {
  const long long st[12] = {qsb, qst, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, dsb, dst, dsh};
  return run(1, q, k, v, dout, lse, delta, nullptr, dk, dv, B, T_len, S_len,
             H, KH, D, st, causal, window, scale, dtype, stream, launched);
}

// The bf16 dq kernel at head_dim D: its dynamic shared memory in
// *smem_bytes and how many of its blocks fit an SM in *blocks_per_sm.
// Returns the query's cudaError_t.
extern "C" int flash_bwd_dq_wgmma_info(int D, int* smem_bytes,
                                       int* blocks_per_sm) {
  switch (D) {
    case 16: *smem_bytes = DqSmem<16>::BYTES; break;
    case 32: *smem_bytes = DqSmem<32>::BYTES; break;
    case 64: *smem_bytes = DqSmem<64>::BYTES; break;
    case 128: *smem_bytes = DqSmem<128>::BYTES; break;
    default: return cudaErrorInvalidValue;
  }
  auto kernel = D == 16   ? flash_bwd_dq_wgmma_kernel<16>
                : D == 32 ? flash_bwd_dq_wgmma_kernel<32>
                : D == 64 ? flash_bwd_dq_wgmma_kernel<64>
                          : flash_bwd_dq_wgmma_kernel<128>;
  return hopper::occupancy(kernel, DQ_THREADS, *smem_bytes, blocks_per_sm);
}

// The bf16 dk/dv kernel at head_dim D: its dynamic shared memory in
// *smem_bytes and how many of its blocks fit an SM in *blocks_per_sm.
// Returns the query's cudaError_t.
extern "C" int flash_bwd_dkv_wgmma_info(int D, int* smem_bytes,
                                        int* blocks_per_sm) {
  switch (D) {
    case 16: *smem_bytes = DkvSmem<16>::BYTES; break;
    case 32: *smem_bytes = DkvSmem<32>::BYTES; break;
    case 64: *smem_bytes = DkvSmem<64>::BYTES; break;
    case 128: *smem_bytes = DkvSmem<128>::BYTES; break;
    default: return cudaErrorInvalidValue;
  }
  auto kernel = D == 16   ? flash_bwd_dkv_wgmma_kernel<16>
                : D == 32 ? flash_bwd_dkv_wgmma_kernel<32>
                : D == 64 ? flash_bwd_dkv_wgmma_kernel<64>
                          : flash_bwd_dkv_wgmma_kernel<128>;
  return hopper::occupancy(kernel, 128, *smem_bytes, blocks_per_sm);
}
