// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd (_fwd_kernel, _mask, _block_needed): causal,
// sliding-window or non-causal softmax(Q K^T * scale) V with an online
// softmax whose (acc, m, l) stay in f32 on chip, returning the output in
// the input dtype and the row logsumexp in f32.
//
// Two kernels, picked by dtype before the launch:
//   * bfloat16: flash_fwd_wgmma_kernel, on the tensor cores;
//   * float32: flash_fwd_f32_kernel, scalar f32 FMA on the CUDA cores (true
//     f32, no TF32), which the f32 model checks depend on.
//
// Both, against the TPU version:
//   * one thread block per (q tile, head h, batch b); the block loops over
//     only the kv tiles the causal/window band needs, where the TPU grid
//     steps over every kv block and skips the masked ones with pl.when;
//     nothing carries across blocks;
//   * they read the model layout (B,T,H,D) / (B,S,K,D) through strides and
//     take kv head h / (H/K), so the wrapper neither repeats kv heads (GQA)
//     nor transposes;
//   * they mask the ragged edges (t >= T, s >= S) themselves, so any length
//     works; the TPU version asserts T % bq == 0 and S % bk == 0;
//   * a row that has seen no key keeps p = 0: exp(-inf - -inf) is never
//     formed, and a row with no key at all gets out 0 and lse -inf.
//
// Bound at the serving shape (yi-6b prefill: B=4, T=S=1024, H=32, K=4,
// D=128, causal, bf16), computed from shapes, not measured:
//   useful work  4*D*B*H*T(T+1)/2 = 3.44e10 FLOP -> 34.7 us at 989 TFLOP/s
//   bytes        q,k,v read + out, lse written ~ 76 MB -> 22.7 us at 3.35 TB/s
// so the function is bound by operations on the tensor cores.
//
// bf16 design (flash_fwd_wgmma_kernel), hopper.cuh for the building blocks:
//   * a block is 2 consumer warpgroups (256 threads) on a q tile of BQ = 128
//     rows, 64 rows each; kv tiles are BK = 64 keys;
//   * S = Q K^T is wgmma m64n64k16 with Q and K K-major in shared memory;
//     the online softmax runs on the accumulator fragments in the log2
//     domain (exp2 of s * scale * log2 e), a row's max reduced over the 4
//     lanes of a quad with __shfl_xor_sync and its sum kept per thread
//     until the epilogue;
//   * P, rounded to bf16 pairs in registers, is the register A operand of
//     O += P V (wgmma m64nDk16), V the MN-major B operand (the transpose
//     bit set) of the same [s][d] tile; O stays in f32 registers, and the
//     row sum l is taken of P before its rounding;
//   * Q and a ring of STAGES K/V tiles arrive by 16-byte cp.async (zero-
//     filled past T and S) in the 128-byte swizzle (64-byte at D = 32,
//     32-byte at D = 16) the descriptors name: the copies of tile
//     j+STAGES-1 run while tile j is multiplied;
//   * head dim 256 (gemma3) is the same kernel: Q K^T is 16 k-steps of
//     m64n64k16, P V one m64n256k16 a k slice, O 128 f32 registers a
//     thread; its ring has 2 stages (193 KB of shared memory), where D <=
//     128 has 3. Bound at gemma3's prefill (B=4, T=S=2048, H=16, K=8,
//     D=256, bf16): 1.375e11 FLOP a causal layer -> 0.139 ms, 1.031e11 a
//     window-1024 layer -> 0.104 ms at 989 TFLOP/s, both by operations;
//   * under a causal mask the heaviest q tiles launch first (the q tile
//     index runs backwards through the grid's slowest dimension), and a
//     warpgroup skips a kv tile that its rows cannot see.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
// what the entry writes to *launched: the kernel it launched
constexpr int LAUNCHED_SCALAR = 0;
constexpr int LAUNCHED_WGMMA = 1;

// ---------------------------------------------------------------------------
// float32: scalar FMA
// ---------------------------------------------------------------------------
//
// BQ = BK = 32; one key per lane for the scores; each of the NWARPS warps
// owns ROWS query rows and keeps their m, l and ROWS x ceil(D/32)
// accumulator columns (d = lane + 32 c) in registers; at D = 16 lanes 16
// to 31 hold no column. The tiles take 100.5 KB at D = 256, above the 48
// KB default: the launch opts in to that much dynamic shared memory.

constexpr int F32_BQ = 32;
constexpr int F32_BK = 32;
constexpr int NWARPS = 4;
constexpr int ROWS = F32_BQ / NWARPS;

template <int D>
constexpr int f32_smem_floats() {
  // Q tile, K tile (rows padded to D + 4 floats: 16-byte aligned rows whose
  // float4 reads by neighbouring lanes fall in different banks), V tile,
  // and one P tile per warp.
  return F32_BQ * D + F32_BK * (D + 4) + F32_BK * D + NWARPS * ROWS * F32_BK;
}

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int T_len, int S_len, int H,
                     int KH, int64_t qsb, int64_t qst, int64_t qsh,
                     int64_t ksb, int64_t kss, int64_t ksh,
                     int64_t vsb, int64_t vss, int64_t vsh,
                     int causal, int window, float scale) {
  constexpr int BQ = F32_BQ, BK = F32_BK;
  constexpr int DP = D + 4;
  constexpr int NC = (D + 31) / 32;
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
  const bool lane_col = D % 32 == 0 || lane < D % 32;  // holds column lane

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kh * ksh;
  const float* vb = v + b * vsb + kh * vsh;

  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    sq[i] = t < T_len ? qb[t * qst + d] : 0.f;
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
      sk[r * DP + d] = in ? kb[s * kss + d] : 0.f;
      sv[i] = in ? vb[s * vss + d] : 0.f;
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
      for (int c = 0; c < NC; ++c)
        vv[c] = lane_col ? sv[j * D + c * 32 + lane] : 0.f;
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
    float* o = out + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (lane_col) o[c * 32 + lane] = acc[i][c] * inv;
    if (lane == 0)
      lse[(static_cast<int64_t>(b) * H + h) * T_len + row] = m[i] + logf(lc);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       void* lse, int B, int T_len, int S_len, int H, int KH,
                       const long long* st, int causal, int window,
                       float scale, cudaStream_t stream, int* launched) {
  constexpr size_t bytes = f32_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + F32_BQ - 1) / F32_BQ, H, B);
  flash_fwd_f32_kernel<D><<<grid, NWARPS * 32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), T_len, S_len, H, KH, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], causal, window, scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = LAUNCHED_SCALAR;
  return err;
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int WG_BQ = 128;   // q rows a block: 64 a consumer warpgroup
constexpr int WG_BK = 64;    // keys a kv tile
constexpr int WG_THREADS = 256;

template <int D>
struct FwdSmem {
  // K/V ring: 3 stages; 2 at D = 256, where 3 would need 257 KB of the
  // 227 KB a block may take (Q 64 KB + 3 x (32 + 32) KB + 1 KB)
  static constexpr int STAGES = D == 256 ? 2 : 3;
  static constexpr int Q_BYTES = WG_BQ * D * 2;
  static constexpr int KV_BYTES = WG_BK * D * 2;
  // Q, then STAGES x (K, V); every tile a multiple of 1024 bytes; 1024
  // more to align the base
  static constexpr int BYTES = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;
};

__device__ __forceinline__ bool allowed(int row, int key, int causal,
                                        int window) {
  return (!causal || key <= row) && (window <= 0 || key > row - window);
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       float* __restrict__ lse, int T_len, int S_len, int H,
                       int KH, int64_t qsb, int64_t qst, int64_t qsh,
                       int64_t ksb, int64_t kss, int64_t ksh,
                       int64_t vsb, int64_t vss, int64_t vsh,
                       int causal, int window, float scale_log2) {
  using namespace hopper;
  using Smem = FwdSmem<D>;
  constexpr int STAGES = Smem::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t skv = base + Smem::Q_BYTES;  // stage s: K, then V
  auto sk = [&](int s) { return skv + s * 2 * Smem::KV_BYTES; };
  auto sv = [&](int s) { return skv + s * 2 * Smem::KV_BYTES + Smem::KV_BYTES; };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * WG_BQ;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;

  const bf16* qb = q + b * qsb + h * qsh + q0 * qst;
  const bf16* kb = k + b * ksb + kh * ksh;
  const bf16* vb = v + b * vsb + kh * vsh;

  // kv band of this q tile: keys in [lo, lo + n_tiles * BK)
  int lo = 0, hi = S_len;
  if (causal) hi = min(S_len, q0 + WG_BQ);
  if (window > 0) lo = max(0, q0 - window + 1);
  lo = lo / WG_BK * WG_BK;
  const int n_tiles = hi > lo ? (hi - lo + WG_BK - 1) / WG_BK : 0;

  auto load_kv = [&](int j) {
    const int k0 = lo + j * WG_BK;
    const int s = j % STAGES;
    load_tile<WG_BK, D>(sk(s), kb + k0 * kss, kss, S_len - k0, tid,
                        WG_THREADS);
    load_tile<WG_BK, D>(sv(s), vb + k0 * vss, vss, S_len - k0, tid,
                        WG_THREADS);
  };
  load_tile<WG_BQ, D>(sq, qb, qst, T_len - q0, tid, WG_THREADS);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }

  // this thread's two rows: r (d[4j+0..1]) and r + 8 (d[4j+2..3])
  const int r_lo = q0 + wg * 64;             // the warpgroup's first row
  const int row0 = r_lo + warp * 16 + lane / 4;
  const int rows[2] = {row0, row0 + 8};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j (and Q) landed for this thread
    fence_proxy_async();
    __syncthreads();              // ... for all; tile j-1 fully read
    if (j + STAGES - 1 < n_tiles) load_kv(j + STAGES - 1);
    cp_async_commit();

    const int k0 = lo + j * WG_BK;
    const int s = j % STAGES;
    // a warpgroup whose rows see no key of this tile (or lie past T) skips it
    if (r_lo >= T_len || (causal && k0 > r_lo + 63) ||
        (window > 0 && k0 + WG_BK - 1 <= r_lo - window))
      continue;

    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, desc_k<WG_BQ, D>(sq, wg * 64, kk),
                   desc_k<WG_BK, D>(sk(s), 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();

    const bool edge = k0 + WG_BK > S_len ||
                      (causal && k0 + WG_BK - 1 > r_lo) ||
                      (window > 0 && k0 <= r_lo + 63 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
      const int rr = (i / 2) & 1;
      float x = sc[i] * scale_log2;
      if (edge && (key >= S_len || !allowed(rows[rr], key, causal, window)))
        x = -INFINITY;
      sc[i] = x;
      mx[rr] = fmaxf(mx[rr], x);
    }
    float m_use[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(FULL, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(FULL, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      // while a row has seen no key, m_new is -inf: subtract 0, so p = 0
      m_use[rr] = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[rr] - m_use[rr]);
      m[rr] = m_new;
      l[rr] *= corr;
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        if (((i / 2) & 1) == rr) o[i] *= corr;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i / 2) & 1;
      sc[i] = exp2f(sc[i] - m_use[rr]);
      l[rr] += sc[i];
    }
    uint32_t pa[WG_BK / 16][4];
    pack_a<WG_BK / 16>(sc, pa);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], desc_mn<WG_BK, D>(sv(s), kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(FULL, l[rr], 1);
    l[rr] += __shfl_xor_sync(FULL, l[rr], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rows[rr];
    if (row >= T_len) continue;
    const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
    bf16* orow = out + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
          o[4 * c + 2 * rr] * inv, o[4 * c + 2 * rr + 1] * inv);
    }
    if (lane % 4 == 0)
      lse[(static_cast<int64_t>(b) * H + h) * T_len + row] =
          (m[rr] + log2f(l[rr])) * 0.69314718055994531f;
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int T_len, int S_len,
                         int H, int KH, const long long* st, int causal,
                         int window, float scale, cudaStream_t stream,
                         int* launched) {
  constexpr int bytes = FwdSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (T_len + WG_BQ - 1) / WG_BQ);
  flash_fwd_wgmma_kernel<D><<<grid, WG_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), T_len, S_len, H, KH, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = LAUNCHED_WGMMA;
  return err;
}

// ---------------------------------------------------------------------------
// probe: one warpgroup's two products, as the bf16 kernel forms them
// ---------------------------------------------------------------------------
//
// c1 (64 x 64, f32) = a (64 x D) b^T, b (64 x D): wgmma m64n64k16 over D/16
// k slices with both operands K-major, as S = Q K^T; then c2 (64 x D, f32) =
// bf16(c1) v, v (64 x D): c1's accumulator packed as the register A operand
// and v the MN-major B operand, as O = P V. All row-major and contiguous.

template <int D>
__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                   const bf16* __restrict__ v, float* __restrict__ c1,
                   float* __restrict__ c2) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  constexpr int TILE = 64 * D * 2;
  const uint32_t sa = base, sb = base + TILE, sv = base + 2 * TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  load_tile<64, D>(sa, a, D, 64, tid, 128);
  load_tile<64, D>(sb, b, D, 64, tid, 128);
  load_tile<64, D>(sv, v, D, 64, tid, 128);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float s[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, desc_k<64, D>(sa, 0, kk), desc_k<64, D>(sb, 0, kk), kk);
  wgmma_commit();
  wgmma_wait<0>();
  uint32_t pa[4][4];
  pack_a<4>(s, pa);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, pa[kk], desc_mn<64, D>(sv, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();

  const int row = warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    c1[(row + 8 * ((i / 2) & 1)) * 64 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1)] = s[i];
#pragma unroll
  for (int i = 0; i < D / 2; ++i)
    c2[(row + 8 * ((i / 2) & 1)) * D + 8 * (i / 4) + 2 * (lane % 4) + (i & 1)] = o[i];
}

template <int D>
cudaError_t launch_probe(const void* a, const void* b, const void* v,
                         void* c1, void* c2, cudaStream_t stream) {
  constexpr int bytes = 3 * 64 * D * 2 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  wgmma_probe_kernel<D><<<1, 128, bytes, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const bf16*>(v), static_cast<float*>(c1),
      static_cast<float*>(c2));
  return cudaGetLastError();
}

}  // namespace

// q (B,T,H,D), k and v (B,S,K,D) with unit stride over D and element
// strides (batch, position, head) in q_strides / k_strides / v_strides;
// out (B,T,H,D) contiguous in q's dtype; lse (B,H,T) contiguous f32.
// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (wgmma kernel, which
// needs 16-byte aligned pointers and strides: the wrapper checks).
// window <= 0 means no window. Returns the cudaError_t of the launch
// (0 on success); on success *launched names the kernel that ran: 0 the
// scalar one, 1 the wgmma one.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int T_len, int S_len,
                         int H, int KH, int D, long long qsb, long long qst,
                         long long qsh, long long ksb, long long kss,
                         long long ksh, long long vsb, long long vss,
                         long long vsh, int causal, int window, float scale,
                         int dtype, void* stream, int* launched) {
  if (B <= 0 || T_len <= 0 || S_len <= 0 || KH <= 0 || H % KH != 0 ||
      B > 65535 || (T_len + WG_BQ - 1) / WG_BQ > 65535)
    return cudaErrorInvalidValue;
  const long long st[9] = {qsb, qst, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == 0;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return (f32 ? launch_f32<16> : launch_wgmma<16>)(
          q, k, v, out, lse, B, T_len, S_len, H, KH, st, causal, window,
          scale, s, launched);
    case 32:
      return (f32 ? launch_f32<32> : launch_wgmma<32>)(
          q, k, v, out, lse, B, T_len, S_len, H, KH, st, causal, window,
          scale, s, launched);
    case 64:
      return (f32 ? launch_f32<64> : launch_wgmma<64>)(
          q, k, v, out, lse, B, T_len, S_len, H, KH, st, causal, window,
          scale, s, launched);
    case 128:
      return (f32 ? launch_f32<128> : launch_wgmma<128>)(
          q, k, v, out, lse, B, T_len, S_len, H, KH, st, causal, window,
          scale, s, launched);
    case 256:
      return (f32 ? launch_f32<256> : launch_wgmma<256>)(
          q, k, v, out, lse, B, T_len, S_len, H, KH, st, causal, window,
          scale, s, launched);
    default:
      return cudaErrorInvalidValue;
  }
}

// Test entry: a, b, v (64 x D) bf16 contiguous; c1 (64 x 64) and c2 (64 x D)
// f32 contiguous (see wgmma_probe_kernel). Returns the launch's cudaError_t.
extern "C" int wgmma_probe(const void* a, const void* b, const void* v,
                           void* c1, void* c2, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_probe<16>(a, b, v, c1, c2, s);
    case 32: return launch_probe<32>(a, b, v, c1, c2, s);
    case 64: return launch_probe<64>(a, b, v, c1, c2, s);
    case 128: return launch_probe<128>(a, b, v, c1, c2, s);
    case 256: return launch_probe<256>(a, b, v, c1, c2, s);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 kernel at head_dim D: its dynamic shared memory in *smem_bytes
// and how many of its blocks fit an SM in *blocks_per_sm. Returns the
// query's cudaError_t.
extern "C" int flash_fwd_wgmma_info(int D, int* smem_bytes,
                                    int* blocks_per_sm) {
  switch (D) {
    case 16: *smem_bytes = FwdSmem<16>::BYTES; break;
    case 32: *smem_bytes = FwdSmem<32>::BYTES; break;
    case 64: *smem_bytes = FwdSmem<64>::BYTES; break;
    case 128: *smem_bytes = FwdSmem<128>::BYTES; break;
    case 256: *smem_bytes = FwdSmem<256>::BYTES; break;
    default: return cudaErrorInvalidValue;
  }
  auto kernel = D == 16    ? flash_fwd_wgmma_kernel<16>
                : D == 32  ? flash_fwd_wgmma_kernel<32>
                : D == 64  ? flash_fwd_wgmma_kernel<64>
                : D == 128 ? flash_fwd_wgmma_kernel<128>
                           : flash_fwd_wgmma_kernel<256>;
  return hopper::occupancy(kernel, WG_THREADS, *smem_bytes, blocks_per_sm);
}
