// Ring attention's block kernel, written by hand for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package's ring
// (dynamo_tpu/parallel/ring_attention.py, `_block_attn` and the merge in
// `ring_attention_local`'s scan) is XLA ops.  Its plain form holds f32
// scores [B, H, Sq, Sk] a round (4 GiB at Llama-3.1-8B's widths with 8192
// tokens a rank), so the port computes a round as a flash kernel instead:
//
//   ring_block_wgmma_kernel (bf16, wgmma) and ring_block_f32_kernel (f32)
//       fold one key source into a CARRIED flash accumulator, in place:
//       m, l [B, Sq, H] and o [B, Sq, H, hd], all f32.  The key source is
//       either a contiguous K/V block [B, Sk, n_kv, hd] (a ring round: key
//       j of row b sits at position k_base[b] + j) or the paged pool
//       through the page table (the cached prefix: key t < prefix_lens[b]
//       at position t, read in place as pa_prefill_wgmma_kernel reads its
//       prefix pages);
//   ring_finish_kernel
//       the end of attention: the sink logit joins the denominator, the
//       denominator is clamped at 1e-20, o / l is written in q's dtype.
//
// Semantics (shared with ring_block_plain / ring_finish_plain in
// dynamo_tpu_torch/ops/ring_attention.py, and JAX's `_block_attn`):
//   - query row s of row b sits at position q_base[b] + s; a key is
//     visible when (causal: k_pos <= q_pos) and (window > 0: k_pos >
//     q_pos - window) and it lies inside its source;
//   - scores are q.k / sqrt(hd) in f32; the carried m is the running max
//     in those units, never below -1e29 (JAX's guard of a fully masked
//     row: its m stays -1e29, its l and o 0), and l, o are sums of
//     exp(score - m);
//   - the merge is JAX's: m_new = max(m, m_blk), l and o rescaled by
//     exp(m - m_new) and exp(m_blk - m_new).  The kernel folds key tiles
//     one at a time starting from the carried state, which is the same
//     sum in another order;
//   - GQA groups 1-8, head dims 64 and 128, windows; sinks at the finish.
//
// The carried accumulator is [B, Sq, H, hd] (and m, l [B, Sq, H]) rather
// than JAX's [B, H, Sq, hd]: a tile's rows are 64/G query positions x the
// G heads of one kv head, one contiguous run of q in this layout, so the
// carry loads and stores as contiguous rows, and the finish writes the
// model's [B, Sq, H, hd] with no transpose.
//
// WHAT BOUNDS IT: a round of Sq x Sk visible pairs does 4 * Sq * Sk_vis *
// H * hd flops against (Sq + Sk) * n_kv * hd * 2 bytes of q, K, V plus
// the f32 carry read and written; at the main path's shapes (Sq = Sk =
// 4096, 32 q / 8 kv heads of 128) that is ~275 GFLOP (diagonal round:
// half) against ~0.9 GB, so the tensor cores bound it (278 us at the bf16
// peak for a full round).  The design is pa_prefill_wgmma_kernel's: one
// warpgroup per (64-row tile, kv head, row), S = Q.K^T and O += P.V as
// wgmma from 128-byte-swizzled tiles, a 2-stage cp.async ring.  Tiles of
// keys that no query of the block can see (past the diagonal, before the
// window, past the source's end) are skipped: a masked key adds
// exp(-1e30 - m) = 0, so the skip is exact, and a block with no visible
// key leaves its carry untouched.  The f32 kernel is the CUDA-core fold
// of pa_prefill_kernel (f32 is the tests' dtype, not the serving one).
//
// The PTX helpers, the tile layout and the f32 key-tile fold are
// attention_common.cuh's, shared with paged_attention.cu.
//
// Each C entry point returns cudaGetLastError() right after its launch.

#include "attention_common.cuh"

namespace {

constexpr float M_FLOOR = -1e29f;  // JAX's floor of a block's max
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int PSTAGES = 2;  // depth of the bf16 K/V ring
constexpr int MROWS = 64;   // bf16 rows per block (positions x G)
constexpr int NKEYS = 64;   // bf16 keys per tile
constexpr int BQ = 16;      // f32 query rows per block
constexpr int RPW = BQ / NWARPS;  // f32 rows per warp

// The key range [u_lo, u_hi) a block must fold: keys u of a source of nk
// keys at positions kb + u, for queries at positions qlo .. qhi.
struct KeyRange {
  int lo, hi;
};
__device__ __forceinline__ KeyRange key_range(int nk, int kb, int qlo, int qhi,
                                             int causal, int window) {
  KeyRange r{0, nk};
  if (causal) r.hi = min(r.hi, max(qhi - kb + 1, 0));
  if (window > 0) r.lo = max(r.lo, qlo - window + 1 - kb);
  return r;
}

__device__ __forceinline__ bool visible(int u, int nk, int kp, int qp, int causal,
                                        int window) {
  return u < nk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// ---------------------------------------------------------------------------
// f32 on CUDA cores: grid (ceil(Sq / BQ), H, B), NTHREADS threads; each
// warp owns RPW query rows, each lane hd / 32 of their dims.  POOL: the
// keys come from the pool through the table (nk = nkeys[b], positions from
// 0); else from the block [B, Sk, n_kv, hd] (nk = Sk, positions from
// k_base[b]).
// ---------------------------------------------------------------------------
template <int HD, bool POOL>
__global__ void __launch_bounds__(NTHREADS)
ring_block_f32_kernel(const float* __restrict__ q,    // [B, Sq, H, HD]
                      const float* __restrict__ ksrc,  // block or pool
                      const float* __restrict__ vsrc,
                      const int* __restrict__ table,   // [B, maxp] (POOL)
                      const int* __restrict__ nkeys,   // [B] (POOL)
                      const int* __restrict__ q_base,  // [B]
                      const int* __restrict__ k_base,  // [B] (block)
                      float* __restrict__ m_c,         // [B, Sq, H]
                      float* __restrict__ l_c,
                      float* __restrict__ o_c,         // [B, Sq, H, HD]
                      int Sq, int H, int n_kv, int Sk_or_maxp, int page,
                      int causal, int window, float scale) {
  constexpr int EPL = HD / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + (size_t)KEYS * HD;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / n_kv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qb = q_base[b];
  const int kb = POOL ? 0 : k_base[b];
  const int nk = POOL ? min(nkeys[b], Sk_or_maxp * page) : Sk_or_maxp;
  const int q_rows = min(BQ, Sq - q0);
  const KeyRange kr = key_range(nk, kb, qb + q0, qb + q0 + q_rows - 1, causal, window);
  if (kr.hi <= kr.lo) return;  // no visible key: the carry stays as it is
  const size_t tok_stride = (size_t)n_kv * HD;

  int row[RPW];
  float qr[RPW][EPL], m[RPW], l[RPW], acc[RPW][EPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    row[i] = q0 + warp * RPW + i;
    const bool in = row[i] < Sq;
    const size_t rix = ((size_t)b * Sq + min(row[i], Sq - 1)) * H + h;
    const float* qh = q + rix * HD + lane * EPL;
    const float* oh = o_c + rix * HD + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[i][e] = in ? qh[e] * scale : 0.f;
      acc[i][e] = in ? oh[e] : 0.f;
    }
    m[i] = in ? m_c[rix] : M_FLOOR;
    l[i] = in ? l_c[rix] : 0.f;
  }

  const int* trow = POOL ? table + (size_t)b * Sk_or_maxp : nullptr;
  for (int u0 = (kr.lo / KEYS) * KEYS; u0 < kr.hi; u0 += KEYS) {
    __syncthreads();
    auto src_of = [&](int r, const float* src) -> const float* {
      const int u = u0 + r;
      if (u >= kr.hi) return nullptr;
      if (POOL) {
        const size_t slot = (size_t)trow[u / page] * page + (u % page);
        return src + slot * tok_stride + (size_t)kh * HD;
      }
      return src + (((size_t)b * Sk_or_maxp + u) * n_kv + kh) * HD;
    };
    stage_rows<float, HD>(ks, KEYS, [&](int r) { return src_of(r, ksrc); });
    stage_rows<float, HD>(vs, KEYS, [&](int r) { return src_of(r, vsrc); });
    stage_wait();
    const int u = u0 + lane;
    bool valid[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      valid[i] = row[i] < Sq && u < kr.hi &&
                 visible(u, nk, kb + u, qb + row[i], causal, window);
    fold_tile<float, HD, RPW>(qr, ks, vs, valid, m, l, acc);
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (row[i] >= Sq) continue;
    const size_t rix = ((size_t)b * Sq + row[i]) * H + h;
    if (lane == 0) {
      m_c[rix] = m[i];
      l_c[rix] = l[i];
    }
    float* oh = o_c + rix * HD + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) oh[e] = acc[i][e];
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: grid (ceil(Sq / (MROWS / G)), n_kv, B),
// NTHREADS threads (one warpgroup).  Tile row r is query position
// q0 + r / G of head kh * G + r % G.  Warp w holds rows 16w..16w+15 of
// every accumulator.  Dynamic shared memory: the Q tile, the K/V ring,
// then (POOL) the block's page ids.
// ---------------------------------------------------------------------------
template <int HD, int G, bool POOL>
__global__ void __launch_bounds__(NTHREADS)
ring_block_wgmma_kernel(const __nv_bfloat16* __restrict__ q,    // [B, Sq, H, HD]
                        const __nv_bfloat16* __restrict__ ksrc,  // block or pool
                        const __nv_bfloat16* __restrict__ vsrc,
                        const int* __restrict__ table,   // [B, maxp] (POOL)
                        const int* __restrict__ nkeys,   // [B] (POOL)
                        const int* __restrict__ q_base,  // [B]
                        const int* __restrict__ k_base,  // [B] (block)
                        float* __restrict__ m_c,         // [B, Sq, H]
                        float* __restrict__ l_c,
                        float* __restrict__ o_c,         // [B, Sq, H, HD]
                        int Sq, int n_kv, int Sk_or_maxp, int page,
                        int page_shift, int causal, int window, float scale) {
  constexpr int R = MROWS / G;      // query positions per block
  constexpr int CPR = HD / 8;       // 16-byte chunks per row
  constexpr int NT_S = NKEYS / 8;   // score n-tiles (8 keys each)
  constexpr int NT_O = HD / 8;      // output n-tiles (8 dims each)
  constexpr int KS_Q = HD / 16;     // k-steps of Q.K^T over the head dim
  constexpr int TILE_BYTES = NKEYS * HD * 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t pad = ((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw);
  unsigned char* smem = smem_raw + pad;
  const uint32_t qs = smem_u32(smem);
  const uint32_t ring = qs + MROWS * HD * 2;

  const int q0 = blockIdx.x * R, kh = blockIdx.y, b = blockIdx.z;
  const int H = n_kv * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qb = q_base[b];
  const int kb = POOL ? 0 : k_base[b];
  const int maxp = Sk_or_maxp;
  const int nk = POOL ? min(nkeys[b], maxp * page) : Sk_or_maxp;
  const int q_rows = min(R, Sq - q0);
  const KeyRange kr = key_range(nk, kb, qb + q0, qb + q0 + q_rows - 1, causal, window);
  if (kr.hi <= kr.lo) return;  // no visible key: the carry stays as it is
  const float scale_log2 = scale * LOG2E;

  // the Q tile (rows past Sq zero-filled)
  const __nv_bfloat16* q_blk = q + (((size_t)b * Sq + q0) * H + kh * G) * HD;
  for (int i = tid; i < MROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r / G < q_rows;
    const size_t off = ok ? ((size_t)(r / G) * H + r % G) * HD + c * 8 : 0;
    cp_async16(qs + tile_off(r, c), q_blk + off, ok);
  }

  const int u_first = (kr.lo / NKEYS) * NKEYS;
  const int n_tiles = (kr.hi - u_first + NKEYS - 1) / NKEYS;
  int* spid = reinterpret_cast<int*>(smem + MROWS * HD * 2 + PSTAGES * 2 * TILE_BYTES);
  const int pg0 = u_first / page;
  int n_pg = 0;
  if (POOL) {
    const int* trow = table + (size_t)b * maxp;
    n_pg = min((kr.hi - 1) / page - pg0 + 1, maxp);
    for (int i = tid; i < n_pg; i += NTHREADS) spid[i] = trow[min(pg0 + i, maxp - 1)];
  }
  __syncthreads();

  constexpr int RSTEP = NTHREADS / CPR;
  constexpr int RPT = NKEYS / RSTEP;
  const int lr = tid / CPR, lc = tid % CPR;
  const uint32_t dst0 = tile_off(lr, lc);
  const size_t tok_stride = (size_t)n_kv * HD;
  const size_t col = (size_t)kh * HD + lc * 8;
  const __nv_bfloat16* kb_b = ksrc + (POOL ? 0 : (size_t)b * Sk_or_maxp * tok_stride) + col;
  const __nv_bfloat16* vb_b = vsrc + (POOL ? 0 : (size_t)b * Sk_or_maxp * tok_stride) + col;
  auto load_tile = [&](int it) {
    if (it >= n_tiles) return;
    const int u0 = u_first + it * NKEYS;
    const uint32_t ks = ring + (it % PSTAGES) * 2 * TILE_BYTES + dst0, vs = ks + TILE_BYTES;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int u = u0 + lr + k * RSTEP;
      const bool ok = u < kr.hi;  // else zero-filled (and masked)
      size_t slot = 0;
      if (ok) {
        if (POOL) {
          const int pidx = page_shift >= 0 ? u >> page_shift : u / page;
          slot = (size_t)spid[min(pidx - pg0, n_pg - 1)] * page + (u - pidx * page);
        } else {
          slot = (size_t)u;
        }
      }
      cp_async16(ks + k * RSTEP * 128, kb_b + slot * tok_stride, ok);
      cp_async16(vs + k * RSTEP * 128, vb_b + slot * tok_stride, ok);
    }
  };

  const int g8 = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16 + g8;  // this thread's rows: row0, row0 + 8
  const int qpos[2] = {qb + q0 + row0 / G, qb + q0 + (row0 + 8) / G};
  bool live[2];
  size_t rix[2];

  float s[NT_S][4], o[NT_O][4];
  uint32_t pa[NKEYS / 16][4];
  // mn: running max in score units (>= -1e29, the carry's); l: this
  // thread's share of the denominator (the carried l rides on t4 == 0)
  float mn[2], l[2], mu[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h, p = r / G;
    live[h] = r < R * G && p < q_rows;
    rix[h] = ((size_t)b * Sq + q0 + (live[h] ? p : 0)) * H + kh * G + r % G;
    mn[h] = live[h] ? m_c[rix[h]] : M_FLOOR;
    l[h] = live[h] && t4 == 0 ? l_c[rix[h]] : 0.f;
    mu[h] = mn[h] * LOG2E;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      float2 v = make_float2(0.f, 0.f);
      if (live[h]) v = *reinterpret_cast<const float2*>(o_c + rix[h] * HD + 8 * n + 2 * t4);
      o[n][2 * h] = v.x;
      o[n][2 * h + 1] = v.y;
    }
  }

  auto issue_s = [&](int it) {
    const uint32_t ks = ring + (it % PSTAGES) * 2 * TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < KS_Q; ++kk) {
      const uint32_t off = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      wg_ss_n64(s, gdesc(qs + off, 16, 1024), gdesc(ks + off, 16, 1024), kk > 0);
    }
    wg_commit();
  };
  auto issue_pv = [&](int it) {
    const uint32_t vs = ring + (it % PSTAGES) * 2 * TILE_BYTES + TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < NKEYS / 16; ++kk)
      wg_pv<HD>(o, pa[kk], gdesc(vs + kk * 16 * 128, V_LBO, V_SBO));
    wg_commit();
  };
  // the online softmax of tile `it` from the carried state: s becomes P
  // (f32), l and the maxima move, corr holds O's rescale.  Masked scores
  // give p = 0 outright (a row with no visible key yet has m = -1e29).
  float corr[2];
  auto softmax = [&](int it) {
    const int u0 = u_first + it * NKEYS;
    const bool need_mask = window > 0 || u0 + NKEYS > nk ||
                           (causal && kb + u0 + NKEYS - 1 > qb + q0);
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (need_mask) {
          const int u = u0 + 8 * j + 2 * t4 + (e & 1);
          if (!visible(u, nk, kb + u, qpos[e >> 1], causal, window)) s[j][e] = NEG_INF;
        }
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(FULL, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(FULL, mt[h], 2));
      const float mt_s = mt[h] > 0.5f * NEG_INF ? mt[h] * scale : M_FLOOR;
      const float m_new = fmaxf(mn[h], mt_s);
      corr[h] = fast_exp2((mn[h] - m_new) * LOG2E);  // 1 unless the max moved
      mn[h] = m_new;
      mu[h] = m_new * LOG2E;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        s[j][e] = x > 0.5f * NEG_INF ? fast_exp2(fmaf(x, scale_log2, -mu[e >> 1])) : 0.f;
        l[e >> 1] += s[j][e];
      }
    }
  };
  auto rescale_and_pack = [&]() {
    if (__any_sync(FULL, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
    }
#pragma unroll
    for (int kk = 0; kk < NKEYS / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  };
  load_tile(0);  // with the Q tile, group 0
  cp_commit();
  for (int it = 0; it < n_tiles; ++it) {
    load_tile(it + 1);
    cp_commit();
    cp_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    fence_acc(s);
    wg_fence();
    issue_s(it);
    wg_wait0();
    fence_acc(s);
    softmax(it);
    rescale_and_pack();
    fence_acc(o);
    fence_frag(pa);
    wg_fence();
    issue_pv(it);
    wg_wait0();
    fence_acc(o);
    fence_frag(pa);
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    if (!live[h]) continue;
    if (t4 == 0) {
      m_c[rix[h]] = mn[h];
      l_c[rix[h]] = l[h];
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<float2*>(o_c + rix[h] * HD + 8 * n + 2 * t4) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// the finish: one warp a (row, position, head), each lane hd / 32 dims.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
ring_finish_kernel(const float* __restrict__ m_c, const float* __restrict__ l_c,
                   const float* __restrict__ o_c, const float* __restrict__ sink,
                   T* __restrict__ out, int rows, int H) {
  constexpr int EPL = HD / 32;
  const int r = blockIdx.x * NWARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float m = m_c[r];
  float L = l_c[r], sc = 1.f;
  if (sink != nullptr) {
    const float sk = sink[r % H];
    const float mf = fmaxf(m, sk);
    sc = expf(m - mf);
    L = L * sc + expf(sk - mf);
  }
  L = fmaxf(L, 1e-20f);
  const float* o = o_c + (size_t)r * HD + lane * EPL;
  T* y = out + (size_t)r * HD + lane * EPL;
#pragma unroll
  for (int e = 0; e < EPL; ++e) y[e] = from_f<T>(o[e] * sc / L);
}

template <int HD, bool POOL>
int launch_f32(const void* q, const void* k, const void* v, const void* table,
               const void* nkeys, const void* qb, const void* kb, float* m,
               float* l, float* o, int B, int Sq, int H, int n_kv, int skm,
               int page, int causal, int window, float scale, cudaStream_t st) {
  const size_t bytes = 2 * (size_t)KEYS * HD * sizeof(float);
  auto kern = ring_block_f32_kernel<HD, POOL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((Sq + BQ - 1) / BQ, H, B), NTHREADS, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(table),
      static_cast<const int*>(nkeys), static_cast<const int*>(qb),
      static_cast<const int*>(kb), m, l, o, Sq, H, n_kv, skm, page, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <int HD, int G, bool POOL>
int launch_wgmma(const void* q, const void* k, const void* v, const void* table,
                 const void* nkeys, const void* qb, const void* kb, float* m,
                 float* l, float* o, int B, int Sq, int n_kv, int skm, int page,
                 int causal, int window, float scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  constexpr int R = MROWS / G;
  const size_t bytes = 1024 + (size_t)MROWS * HD * 2 +
                       (size_t)PSTAGES * 2 * NKEYS * HD * 2 +
                       (POOL ? (size_t)skm * sizeof(int) : 0);
  int page_shift = -1;
  for (int p = 0; p < 31; ++p)
    if ((1 << p) == page) page_shift = p;
  auto kern = ring_block_wgmma_kernel<HD, G, POOL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((Sq + R - 1) / R, n_kv, B), NTHREADS, bytes, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const int*>(table),
      static_cast<const int*>(nkeys), static_cast<const int*>(qb),
      static_cast<const int*>(kb), m, l, o, Sq, n_kv, skm, page, page_shift,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD, bool POOL>
int wgmma_by_groups(int G, const void* q, const void* k, const void* v,
                    const void* table, const void* nkeys, const void* qb,
                    const void* kb, float* m, float* l, float* o, int B, int Sq,
                    int n_kv, int skm, int page, int causal, int window,
                    float scale, cudaStream_t st) {
  switch (G) {
    case 1: return launch_wgmma<HD, 1, POOL>(q, k, v, table, nkeys, qb, kb, m, l, o, B, Sq, n_kv, skm, page, causal, window, scale, st);
    case 2: return launch_wgmma<HD, 2, POOL>(q, k, v, table, nkeys, qb, kb, m, l, o, B, Sq, n_kv, skm, page, causal, window, scale, st);
    case 3: return launch_wgmma<HD, 3, POOL>(q, k, v, table, nkeys, qb, kb, m, l, o, B, Sq, n_kv, skm, page, causal, window, scale, st);
    case 4: return launch_wgmma<HD, 4, POOL>(q, k, v, table, nkeys, qb, kb, m, l, o, B, Sq, n_kv, skm, page, causal, window, scale, st);
    case 5: return launch_wgmma<HD, 5, POOL>(q, k, v, table, nkeys, qb, kb, m, l, o, B, Sq, n_kv, skm, page, causal, window, scale, st);
    case 6: return launch_wgmma<HD, 6, POOL>(q, k, v, table, nkeys, qb, kb, m, l, o, B, Sq, n_kv, skm, page, causal, window, scale, st);
    case 7: return launch_wgmma<HD, 7, POOL>(q, k, v, table, nkeys, qb, kb, m, l, o, B, Sq, n_kv, skm, page, causal, window, scale, st);
    case 8: return launch_wgmma<HD, 8, POOL>(q, k, v, table, nkeys, qb, kb, m, l, o, B, Sq, n_kv, skm, page, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool POOL>
int block_dispatch(const void* q, const void* k, const void* v,
                   const void* table, const void* nkeys, const void* qb,
                   const void* kb, float* m, float* l, float* o, int B, int Sq,
                   int H, int n_kv, int hd, int skm, int page, int causal,
                   int window, int dtype, float scale, cudaStream_t st) {
  const int G = H / n_kv;
  if (dtype == 1 && hd == 128)
    return wgmma_by_groups<128, POOL>(G, q, k, v, table, nkeys, qb, kb, m, l, o, B, Sq, n_kv, skm, page, causal, window, scale, st);
  if (dtype == 1 && hd == 64)
    return wgmma_by_groups<64, POOL>(G, q, k, v, table, nkeys, qb, kb, m, l, o, B, Sq, n_kv, skm, page, causal, window, scale, st);
  if (dtype == 0 && hd == 128)
    return launch_f32<128, POOL>(q, k, v, table, nkeys, qb, kb, m, l, o, B, Sq, H, n_kv, skm, page, causal, window, scale, st);
  if (dtype == 0 && hd == 64)
    return launch_f32<64, POOL>(q, k, v, table, nkeys, qb, kb, m, l, o, B, Sq, H, n_kv, skm, page, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One round of ring attention folded into the carry (m, l, o; f32, in
// place).  pool = 0: k, v are a block [B, Sk, n_kv, hd] with key j of row
// b at position k_base[b] + j (skm = Sk; table, nkeys unused).  pool = 1:
// k, v are the pool [P, page, n_kv, hd], row b's keys t < nkeys[b] at
// position t through table [B, skm] (k_base unused).  dtype: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int ring_block(const void* q, const void* k, const void* v,
                          const void* table, const void* nkeys,
                          const void* q_base, const void* k_base, void* m,
                          void* l, void* o, int B, int Sq, int H, int n_kv,
                          int hd, int skm, int page, int pool, int causal,
                          int window, int dtype, float scale, void* stream) {
  if (B == 0 || Sq == 0 || skm == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* of = static_cast<float*>(o);
  if (pool)
    return block_dispatch<true>(q, k, v, table, nkeys, q_base, k_base, mf, lf, of, B, Sq, H, n_kv, hd, skm, page, causal, window, dtype, scale, st);
  return block_dispatch<false>(q, k, v, table, nkeys, q_base, k_base, mf, lf, of, B, Sq, H, n_kv, hd, skm, page, causal, window, dtype, scale, st);
}

// out [rows, hd] (rows = B * Sq * H) in q's dtype from the carry; sink [H]
// f32 or null.
extern "C" int ring_finish(const void* m, const void* l, const void* o,
                           const void* sink, void* out, int rows, int H,
                           int hd, int dtype, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + NWARPS - 1) / NWARPS);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const float* of = static_cast<const float*>(o);
  const float* sk = static_cast<const float*>(sink);
  if (dtype == 1 && hd == 128)
    ring_finish_kernel<__nv_bfloat16, 128><<<grid, NTHREADS, 0, st>>>(mf, lf, of, sk, static_cast<__nv_bfloat16*>(out), rows, H);
  else if (dtype == 1 && hd == 64)
    ring_finish_kernel<__nv_bfloat16, 64><<<grid, NTHREADS, 0, st>>>(mf, lf, of, sk, static_cast<__nv_bfloat16*>(out), rows, H);
  else if (dtype == 0 && hd == 128)
    ring_finish_kernel<float, 128><<<grid, NTHREADS, 0, st>>>(mf, lf, of, sk, static_cast<float*>(out), rows, H);
  else if (dtype == 0 && hd == 64)
    ring_finish_kernel<float, 64><<<grid, NTHREADS, 0, st>>>(mf, lf, of, sk, static_cast<float*>(out), rows, H);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
