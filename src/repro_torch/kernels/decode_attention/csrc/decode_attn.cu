// Decode attention for Hopper (sm_90a), plain C interface for ctypes: one
// query position of every sequence against its KV cache.
//
// Replaces no Pallas kernel: the JAX package decodes in plain jnp
// (src/repro/models/attention.py::decode_attention), as the port did in
// plain torch (naive_attention, kept as the CPU path and the reference).
// Per batch row b, kv head kh and query head g of its group (G = H / K):
//   s[t]  = (q[g] . k[t]) / sqrt(D)     over the slots t whose position
//           pos_k[t] satisfies 0 <= pos_k[t] <= pos_q and, with a window,
//           pos_k[t] > pos_q - window
//   out[g] = sum_t softmax(s)[t] v[t]
// q (B, 1, K, G, D) contiguous; k_cache, v_cache (B, S, K, D) read in
// place through their (batch, slot, head) strides; out (B, 1, K, G, D) in
// the cache's dtype. pos_q is a 0-d int32 on the device, read by every
// block: nothing is read back to the host, so a captured decode step
// replays at any position.
//
// Bound: bytes. One step at yi-6b's decode shape (B 32, K 4, G 8, D 128,
// ~768 filled slots) reads 2 * 32 * 768 * 4 * 128 * 2 B = 50 MB of cache a
// layer for 2 * 8 * 128 FLOPs a slot and head group: 8 FLOPs a byte, far
// below the 295 at which the tensor cores would bind. So the design reads
// the filled cache once, and no more of it, and keeps the fixed costs of a
// launch small beside a transfer of only 10-25 us:
//   * a block is one (split, kv head, batch row): it loads each K and V
//     tile once for all G query heads of its group;
//   * a global layer's slot s holds position s or is empty, so the filled
//     range is [0, min(pos_q + 1, S)); the blocks of a (b, kh) split it
//     evenly, in whole 16-slot tiles, on the device and stop at it. A
//     windowed ring cache, or a cross-attention cache (pos_q = 2**30,
//     every slot valid), is read in full and masked by pos_k;
//   * splits: NS blocks a (b, kh), from B * K and S alone (the wrapper's
//     kernel.n_splits: B 32, K 4 take 2; B 4 take 8, the portable
//     cluster's most, which measured faster than 16). The NS blocks of
//     a (b, kh) are one thread block cluster: each leaves
//     its partial softmax (max, sum, unnormalized out; f32) in its shared
//     memory, and after a cluster barrier every block combines a slice of
//     the output from all NS partials through distributed shared memory.
//     No scratch in device memory, no second kernel;
//   * bf16: each of the block's 4 warps walks its own 16-slot tiles,
//     copied by cp.async (16 B a lane, zero-filled past the range) with
//     their 16 positions into a ring of STAGES tiles of its own, rows
//     padded by 16 B so that ldmatrix reads them without bank conflicts.
//     QK^T and P.V run on mma.sync m16n8k16 with the G query heads as the
//     16 rows (rows G..15 zero): Q as A from registers, K by ldmatrix and
//     V by ldmatrix.trans as B, the scores' accumulator reused as P's A
//     fragment. A tile's fragments are read from shared memory at once
//     and its products run on independent accumulators, so that a tile
//     costs a few tensor-core latencies, not one a product. P is split
//     into two bf16 halves (hi = bf16(p), lo = bf16(p - hi)) and both are
//     multiplied, so P.V carries ~16 bits of p, not bf16's 8 (the plain
//     version rounds p to bf16); accumulation, the online softmax (ex2 of
//     scores scaled by log2 e / sqrt D) and the merges are f32. The
//     tensor cores have room for the padding and the second product: the
//     copies, not the MMAs, set the pace;
//   * f32 caches (the f32 checks): a scalar kernel, one slot a warp at a
//     time, lanes over D, the same merges;
//   * the block's 4 warps merge their partial softmaxes in shared memory,
//     so a block holds one partial, not four.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 16;     // slots a warp's tile: the k of P.V's mma
constexpr int GMAX = 8;      // query heads a kv head, at most
constexpr int PAD = 8;       // bf16 elements of padding a staged row
constexpr int MAX_SPLITS = 8;    // blocks a cluster: the portable most
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -INFINITY;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos_k;
  const int* pos_q;
  void* out;
  int S, K, G, NS, window;   // window 0: none
  long long ksb, kss, ksk, vsb, vss, vsk;   // element strides
  float scale_log2;          // log2(e) / sqrt(D)
};

__device__ __forceinline__ bool attended(int pk, int pq, int window) {
  return pk >= 0 && pk <= pq && (window == 0 || pk > pq - window);
}

// [lo, hi): this block's slots of the range that a query at position pq
// reads, whole tiles but the last
__device__ __forceinline__ void block_range(const Args& a, int pq, int split,
                                            int* lo, int* hi) {
  int n = a.S;
  if (a.window == 0) n = pq < 0 ? 0 : (pq >= a.S - 1 ? a.S : pq + 1);
  const int tiles = (n + TILE - 1) / TILE;
  *lo = tiles * split / a.NS * TILE;
  *hi = min(tiles * (split + 1) / a.NS * TILE, n);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, of which src_bytes are read and
// the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += A (16 x 16, rows 8..15 zero: a1 = a3 = 0) . B (16 x 8), f32; not
// volatile, so that the compiler interleaves independent products
__device__ __forceinline__ void mma(float c[4], uint32_t a0, uint32_t a2,
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// The block's warps' partial softmaxes: m and l of (warp, row), o of
// (warp, row, d); rows are the query heads.
template <int D>
struct Merge {
  float o[WARPS][GMAX][D];
  float m[WARPS][GMAX];
  float l[WARPS][GMAX];
};

// The block's partial softmax, read by the other blocks of its cluster.
template <int D>
struct Partial {
  float o[GMAX][D];
  float m[GMAX];
  float l[GMAX];
};

// Dynamic shared memory: a work area of WORK bytes (the staging ring,
// which the warps' partials then reuse) and the block's partial.
template <int D, int WORK>
struct Layout {
  static constexpr int AREA =
      WORK > (int)sizeof(Merge<D>) ? WORK : (int)sizeof(Merge<D>);
  static constexpr int PARTIAL = (AREA + 15) / 16 * 16;
  static constexpr int BYTES = PARTIAL + (int)sizeof(Partial<D>);
};

// The end of both split kernels, with the warps' partials in mg: merge
// them into the block's partial, then, after a cluster barrier, write
// this block's slice of out[b, 0, kh] from the partials of all NS blocks
// of the cluster (the splits of (b, kh)).
template <typename T, int D>
__device__ void finish(const Merge<D>& mg, Partial<D>& mine, const Args& a,
                       int b, int kh) {
  for (int i = threadIdx.x; i < a.G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mg.m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float s = mg.m[w][g] == NEG_INF ? 0.f : exp2f(mg.m[w][g] - M);
      L += s * mg.l[w][g];
      O += s * mg.o[w][g][d];
    }
    mine.o[g][d] = O;
    if (d == 0) {
      mine.m[g] = M;
      mine.l[g] = L;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every partial of the cluster is written
  const int ns = a.NS, rank = static_cast<int>(cluster.block_rank());
  const int per = (a.G * D + ns - 1) / ns;
  const int end = min((rank + 1) * per, a.G * D);
  T* out = static_cast<T*>(a.out) +
           (static_cast<long long>(b) * a.K + kh) * a.G * D;
  for (int i = rank * per + threadIdx.x; i < end; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
    for (int r = 0; r < ns; ++r)
      M = fmaxf(M, cluster.map_shared_rank(&mine, r)->m[g]);
    float L = 0.f, O = 0.f;
    for (int r = 0; r < ns; ++r) {
      const Partial<D>* p = cluster.map_shared_rank(&mine, r);
      const float s = p->m[g] == NEG_INF ? 0.f : exp2f(p->m[g] - M);
      L += s * p->l[g];
      O += s * p->o[g][d];
    }
    out[i] = from_f32<T>(L > 0.f ? O / L : 0.f);
  }
  cluster.sync();   // no block leaves while another reads its partial
}

// One warp's staging ring: STAGES tiles of K rows, V rows (padded) and
// their positions.
template <int D, int STAGES>
struct Ring {
  static constexpr int RS = D + PAD;                       // a staged row
  static constexpr int STAGE = 2 * TILE * RS * 2 + TILE * 4;   // bytes
  static constexpr int BYTES = WARPS * STAGES * STAGE;
};

template <int D, int STAGES>
__global__ void __launch_bounds__(THREADS)
    decode_attn_split_kernel(const Args a) {
  using R = Ring<D, STAGES>;
  using Lay = Layout<D, R::BYTES>;
  constexpr int RS = R::RS;
  constexpr int CHUNKS = D / 8;   // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int pq = *a.pos_q;
  int lo, hi;
  block_range(a, pq, split, &lo, &hi);
  const int ntiles = (hi - lo + TILE - 1) / TILE;
  const int mine = ntiles > w ? (ntiles - w + WARPS - 1) / WARPS : 0;

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + kh * a.ksk;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + kh * a.vsk;
  unsigned char* ring = smem + w * STAGES * R::STAGE;

  // this warp's j-th tile: slots lo + TILE * (w + WARPS * j) on
  auto load = [&](int j) {
    const int s0 = lo + TILE * (w + WARPS * j);
    unsigned char* st = ring + (j % STAGES) * R::STAGE;
    bf16* ks = reinterpret_cast<bf16*>(st);
    bf16* vs = ks + TILE * RS;
    for (int c = lane; c < TILE * CHUNKS; c += 32) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
      const int s = s0 + r;
      const bool ok = s < hi;
      cp_async16(ks + r * RS + col, ok ? kb + s * a.kss + col : kb,
                 ok ? 16 : 0);
      cp_async16(vs + r * RS + col, ok ? vb + s * a.vss + col : vb,
                 ok ? 16 : 0);
    }
    if (lane < TILE / 4) {   // positions: 4 a lane, zero past the cache
      const int s = s0 + lane * 4;
      const int left = max(0, min(4, a.S - s));
      cp_async16(vs + TILE * RS + lane * 8, left ? a.pos_k + s : a.pos_k,
                 left * 4);
    }
  };

  // Q as the A fragments of QK^T: row gid (a query head), d pairs
  uint32_t qa[D / 16][2];
  {
    const bf16* qg = static_cast<const bf16*>(a.q) +
                     ((static_cast<long long>(b) * a.K + kh) * a.G + gid) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = gid < a.G
          ? *reinterpret_cast<const uint32_t*>(qg + kk * 16 + tq * 2) : 0u;
      qa[kk][1] = gid < a.G
          ? *reinterpret_cast<const uint32_t*>(qg + kk * 16 + 8 + tq * 2)
          : 0u;
    }
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < mine) load(j);
    cp_async_commit();
  }
  // ldmatrix row addresses: lane l names row l % 8 of matrix l / 8
  const int mat = lane >> 3, mrow = lane & 7;
  for (int j = 0; j < mine; ++j) {
    if (j + STAGES - 1 < mine) load(j + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const unsigned char* st = ring + (j % STAGES) * R::STAGE;
    const bf16* ks = reinterpret_cast<const bf16*>(st);
    const bf16* vs = ks + TILE * RS;
    const int* ps = reinterpret_cast<const int*>(vs + TILE * RS);
    const int s0 = lo + TILE * (w + WARPS * j);

    // The tile's fragments are read from shared memory first, all at once,
    // and the products run on independent accumulators: one tile is then
    // a few latencies of the tensor cores, not one a product. K:
    // matrices (slots 0-7 | 8-15) x (d kk*16 + 0-7 | 8-15); V (read
    // transposed): (slots 0-7 | 8-15) x (d dp*16 + 0-7), then d + 8-15. At
    // D = 256 V waits for the scores, for registers.
    uint32_t kr[D / 16][4], vr[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(kr[kk],
              ks + (mrow + (mat >> 1) * 8) * RS + kk * 16 + (mat & 1) * 8);
    auto load_v = [&]() {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp)
        ldsm_x4_trans(vr[dp], vs + (mrow + (mat & 1) * 8) * RS + dp * 16 +
                                  (mat >> 1) * 8);
    };
    if constexpr (D <= 128) load_v();
    // scores of slots s0 + 8 n + 2 tq + e (n = 0, 1; e = 0, 1), row gid,
    // over even and odd kk apart
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float sc2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (kk % 2) {
        mma(sc2[0], qa[kk][0], qa[kk][1], kr[kk][0], kr[kk][1]);
        mma(sc2[1], qa[kk][0], qa[kk][1], kr[kk][2], kr[kk][3]);
      } else {
        mma(sc[0], qa[kk][0], qa[kk][1], kr[kk][0], kr[kk][1]);
        mma(sc[1], qa[kk][0], qa[kk][1], kr[kk][2], kr[kk][3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) sc[n][e] += sc2[n][e];
    float mx = NEG_INF;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * n + 2 * tq + e;
        const bool ok = s0 + r < hi && attended(ps[r], pq, a.window);
        sc[n][e] = ok ? sc[n][e] * a.scale_log2 : NEG_INF;
        mx = fmaxf(mx, sc[n][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float base = m_new == NEG_INF ? 0.f : m_new;
    const float alpha = exp2f(m_run - base);
    float p[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) p[n][e] = exp2f(sc[n][e] - base);
    l_run = l_run * alpha + (p[0][0] + p[0][1] + p[1][0] + p[1][1]);
    m_run = m_new;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
    }
    // P as the A fragment of P.V (k = the tile's 16 slots), in two halves
    uint32_t ph[2], pl[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(p[n][0], p[n][1]);
      const float2 hf = __bfloat1622float2(h);
      ph[n] = pack(h);
      pl[n] = pack(__floats2bfloat162_rn(p[n][0] - hf.x, p[n][1] - hf.y));
    }
    if constexpr (D > 128) load_v();
    // every high half, then every low half: no product waits on the last
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      mma(o[2 * dp], ph[0], ph[1], vr[dp][0], vr[dp][1]);
      mma(o[2 * dp + 1], ph[0], ph[1], vr[dp][2], vr[dp][3]);
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      mma(o[2 * dp], pl[0], pl[1], vr[dp][0], vr[dp][1]);
      mma(o[2 * dp + 1], pl[0], pl[1], vr[dp][2], vr[dp][3]);
    }
    __syncwarp();   // the stage is free for the load of tile j + STAGES
  }
  cp_async_wait<0>();
  l_run += __shfl_xor_sync(FULL, l_run, 1);
  l_run += __shfl_xor_sync(FULL, l_run, 2);

  __syncthreads();   // every warp is done with the ring
  Merge<D>& mg = *reinterpret_cast<Merge<D>*>(smem);
  if (gid < a.G) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      mg.o[w][gid][n * 8 + tq * 2] = o[n][0];
      mg.o[w][gid][n * 8 + tq * 2 + 1] = o[n][1];
    }
    if (tq == 0) {
      mg.m[w][gid] = m_run;
      mg.l[w][gid] = l_run;
    }
  }
  __syncthreads();
  finish<bf16, D>(mg, *reinterpret_cast<Partial<D>*>(smem + Lay::PARTIAL), a,
                  b, kh);
}

// f32 caches: a warp attends one slot at a time, lanes over D
template <int D>
__global__ void __launch_bounds__(THREADS)
    decode_attn_split_f32_kernel(const Args a) {
  using Lay = Layout<D, 0>;
  constexpr int EPL = D >= 32 ? D / 32 : 1;   // elements a lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int pq = *a.pos_q;
  int lo, hi;
  block_range(a, pq, split, &lo, &hi);

  const float* qg = static_cast<const float*>(a.q) +
                    (static_cast<long long>(b) * a.K + kh) * a.G * D;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + kh * a.ksk;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + kh * a.vsk;
  float qr[GMAX][EPL], o[GMAX][EPL], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = i * 32 + lane;
      qr[g][i] = g < a.G && d < D ? qg[g * D + d] : 0.f;
      o[g][i] = 0.f;
    }
  }
  for (int s = lo + w; s < hi; s += WARPS) {
    if (!attended(a.pos_k[s], pq, a.window)) continue;
    float kv[EPL], vv[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = i * 32 + lane;
      kv[i] = d < D ? kb[s * a.kss + d] : 0.f;
      vv[i] = d < D ? vb[s * a.vss + d] : 0.f;
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= a.G) break;
      float sc = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) sc = fmaf(qr[g][i], kv[i], sc);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sc += __shfl_xor_sync(FULL, sc, off);
      sc *= a.scale_log2;
      const float mn = fmaxf(m[g], sc);
      const float alpha = exp2f(m[g] - mn);
      const float p = exp2f(sc - mn);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < EPL; ++i) o[g][i] = fmaf(p, vv[i], o[g][i] * alpha);
      m[g] = mn;
    }
  }
  Merge<D>& mg = *reinterpret_cast<Merge<D>*>(smem);
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= a.G) break;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = i * 32 + lane;
      if (d < D) mg.o[w][g][d] = o[g][i];
    }
    if (lane == 0) {
      mg.m[w][g] = m[g];
      mg.l[w][g] = l[g];
    }
  }
  __syncthreads();
  finish<float, D>(mg, *reinterpret_cast<Partial<D>*>(smem + Lay::PARTIAL),
                   a, b, kh);
}

// the ring's depth: two tiles in flight a warp, one at D = 256 so that the
// ring fits an SM
template <int D> constexpr int stages() { return D == 256 ? 2 : 3; }

// the split kernel for head dim D and dtype (1 bf16, 0 f32), and its
// dynamic shared memory
template <int D>
void kernel_of(int dtype, void (**kernel)(const Args), int* bytes) {
  if (dtype == 1) {
    constexpr int ST = stages<D>();
    *kernel = decode_attn_split_kernel<D, ST>;
    *bytes = Layout<D, Ring<D, ST>::BYTES>::BYTES;
  } else {
    *kernel = decode_attn_split_f32_kernel<D>;
    *bytes = Layout<D, 0>::BYTES;
  }
}

cudaError_t prepare(void (*kernel)(const Args), int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch(const Args& a, int B, int dtype, cudaStream_t stream) {
  void (*kernel)(const Args);
  int bytes;
  kernel_of<D>(dtype, &kernel, &bytes);
  // once an instantiation, outside any graph capture (a call's first
  // launch is eager)
  static cudaError_t ready[2] = {cudaErrorNotReady, cudaErrorNotReady};
  if (ready[dtype] == cudaErrorNotReady) ready[dtype] = prepare(kernel, bytes);
  if (ready[dtype] != cudaSuccess) return ready[dtype];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.NS, a.K, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.NS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// q (B, 1, K, G, D) contiguous; k_cache, v_cache (B, S, K, D) with unit
// stride over D and element strides (batch, slot, head) ksb..vsk, each a
// multiple of 16 bytes, pointers 16-byte aligned; pos_k (S,) int32,
// 16-byte aligned, and pos_q (0-d) int32; out (B, 1, K, G, D) contiguous
// in the cache's dtype. dtype: 0 = float32, 1 = bfloat16 (q, the caches and
// out alike). D in {16, 64, 128, 256}, 1 <= G <= 8, 1 <= NS <= 8 splits
// (a cluster), window 0 for none. Launches the split kernel on `stream`;
// returns the cudaError_t of the launch.
extern "C" int decode_attn(const void* q, const void* k_cache,
                           const void* v_cache, const int* pos_k,
                           const int* pos_q, void* out, int B, int S, int K,
                           int G, int D, int NS, int window, long long ksb,
                           long long kss, long long ksk, long long vsb,
                           long long vss, long long vsk, int dtype,
                           void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > 65535 || S < 1 || G < 1 ||
      G > GMAX || NS < 1 || NS > MAX_SPLITS || window < 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Args a{q, k_cache, v_cache, pos_k, pos_q, out, S, K, G, NS, window,
         ksb, kss, ksk, vsb, vss, vsk,
         static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, B, dtype, st);
    case 64: return launch<64>(a, B, dtype, st);
    case 128: return launch<128>(a, B, dtype, st);
    case 256: return launch<256>(a, B, dtype, st);
    default: return cudaErrorInvalidValue;
  }
}
