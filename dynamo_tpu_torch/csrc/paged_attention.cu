// Paged attention for the KV page pool, written by hand for Hopper (sm_90a).
//
// Each kernel is the counterpart of one Pallas TPU kernel of the JAX
// package (dynamo_tpu/ops/pallas_attention.py):
//
//   pa_decode_split_kernel + pa_decode_merge_kernel
//       replace decode_attention_pallas (_decode_kernel, _page_dmas): one
//       query token per sequence over its page-table row;
//   pa_prefill_wgmma_kernel (bf16, wgmma) and pa_prefill_kernel (f32)
//       replace prefill_attention_pallas (_prefill_kernel): a new chunk
//       attends to its cached prefix pages, then to itself causally.
//
// Semantics (shared with the plain PyTorch versions in
// dynamo_tpu_torch/ops/paged_attention.py):
//   - pools are [P, page, n_kv, hd]; a sequence's keys live in the pages
//     its table row names, token t at (table[t / page], t % page);
//   - GQA: q head h reads kv head h / (H / n_kv), for any group G = H / n_kv
//     from 1 to 8 (Qwen2's 7 and 6 included).  The decode split pass sizes
//     its lane split from G rounded up to a power of two and holds G rows;
//     the bf16 prefill tile holds floor(64 / G) positions x G heads, so at
//     G 7 one row of 64 is spare: it loads zeros and is never stored;
//   - scores are q.k * 1/sqrt(hd) in f32; an f32 online softmax (running
//     max m, denominator l, accumulator acc) streams the keys.  Scores are
//     kept in log2 units (scaled by log2(e)) so the exponentials are exp2;
//   - a sliding window > 0 keeps keys with position > query_pos - window;
//   - per-head sink logits join the denominator only: l += exp(sink - m);
//   - the denominator is clamped to 1e-30 and NEG_INF is -1e30, so a row
//     with no valid key (seq_len 0, or a prefill row past chunk_len)
//     gives zeros, never NaN.
//
// DECODE -- what bounds it: every cached K/V byte of the batch is read
// once for ~1 flop per byte, so HBM bytes bound it.  At the serving shape
// (8 padded rows, ~5300 live tokens, n_kv 8, hd 128, bf16) that is about
// 21.7 MB, 6.5 us at 3.35 TB/s.  The first version (one block per
// (kv head, row), grid n_kv x B) left most of the 132 SMs idle, walked a
// 4095-token row with one block, reduced every key's score with a serial
// 5-shuffle warp sum per head, waited for each tile before scoring it,
// and re-read the page table for every 16-byte vector.  This version:
//   - split-KV: grid (n_kv, B, n_split); a block scores one kv head's G
//     query heads over one run of 256 keys (whole pages) of one row.
//     The run is a constant, so a row's splits, and the f32 sums of its
//     output, do not change with its batch-mates; n_split covers the
//     table width (a shape, never seq_lens), which fills the card at
//     least twice at the serving shape.  A split wholly past seq_len or
//     before the window writes m = NEG_INF, l = 0 and exits;
//   - the split's page ids are read once into shared memory;
//   - K/V tiles of 64 keys move with 16-byte cp.async into a ring of 2
//     stages: the next tile's copies are issued before this tile is
//     scored;
//   - lanes are split over keys: a group of LPK lanes (4-16, by G and hd)
//     owns one key at a time, each lane a slice of hd read as 16-byte
//     vectors, so a score is reduced over log2(LPK) shuffles, not a
//     5-shuffle sum per key and head.  CUDA cores rather than
//     mma.sync with G padded to 16 rows: the kernel is bytes-bound, the
//     same code serves f32 pools, and padding G = 4 to 16 rows would waste
//     3/4 of every product;
//   - each split's (m, l, acc) go in f32 to scratch the wrapper allocates;
//     pa_decode_merge_kernel combines the splits by their maxima, adds
//     the sink, clamps the denominator and writes q's dtype.
//
// PREFILL -- what bounds it: at the serving shape (one 512-token chunk
// after a 1536-token prefix, 32 q / 8 kv heads, hd 128) it does 15.0
// GFLOP against 16.8 MB, so it is operations-bound: 15.2 us at the bf16
// tensor-core peak (989 TFLOP/s).  Only tensor cores get near that.
// pa_prefill_wgmma_kernel (bf16):
//   - one block (one warpgroup, 4 warps) per (64-row tile, kv head,
//     sequence); the tile's rows are 64/G query positions x the G query
//     heads that share the kv head, so each K/V tile crosses from memory
//     to shared memory once per kv head (the first version loaded it once
//     per query head);
//   - S = Q.K^T and O += P.V run on the tensor cores as wgmma (m64n64k16
//     with Q and K from shared memory; m64n{64,128}k16 with P from
//     registers and V as the transposed B), f32 accumulate, from
//     128-byte-swizzled tiles.  One warpgroup reads each K/V tile once
//     for all 64 rows, where mma.sync made every warp read it again;
//   - tiles of 64 keys in a ring of 2 stages filled with cp.async; prefix
//     keys come through the table row (page ids read once into shared
//     memory), chunk keys from k_new/v_new, both in one key space
//     u = prefix position, then prefix_len + chunk position;
//   - the copy of tile i + 1 runs under the products and softmax of
//     tile i;
//   - causal: the key loop ends at the block's last row, and only tiles
//     that cross the first row's diagonal (or any tile under a window)
//     are masked; a window starts at the first visible tile.
// f32 inputs keep the first version's CUDA-core pa_prefill_kernel: tensor
// cores would need TF32, which breaks the 1e-4 f32 tolerance.  f32 is the
// tests' dtype, not the serving path's.
//
// Each C entry point returns cudaGetLastError() right after its launches.

#include "attention_common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int STAGES = 2;   // depth of the decode K/V ring
constexpr int PSTAGES = 2;  // depth of the bf16 prefill K/V ring
constexpr int DTILE = 64;   // decode keys per tile
constexpr int MROWS = 64;   // bf16 prefill rows per block (positions x G)
constexpr int NKEYS = 64;   // bf16 prefill keys per tile
constexpr int BQ = 16;      // f32 prefill query rows per block
constexpr int RPW = BQ / NWARPS;  // f32 prefill rows per warp

// 16 bytes of a row (one vector) as floats
__device__ __forceinline__ void load_f(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load_f(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// The group rounded up to a power of two: 3 -> 4, 5..7 -> 8.
__host__ __device__ constexpr int pow2_ceil(int g) {
  return g <= 1 ? 1 : (g <= 2 ? 2 : (g <= 4 ? 4 : 8));
}

// Lanes that share one key in the decode split pass: enough that a lane
// holds at most 64 f32 of q (G heads x hd/LPK) and 64 of acc, at least 4.
// Sized from the group rounded up to a power of two, so LPK is one (its
// shuffle tree halves) and divides hd at every group from 1 to 8: Qwen2's
// 7 (28 / 4 heads) takes G 8's 16 lanes and simply holds 7 heads' rows.
template <int G, int HD>
__host__ __device__ constexpr int lanes_per_key() {
  constexpr int GP = pow2_ceil(G);
  return GP * HD / 64 < 4 ? 4 : (GP * HD / 64 > 32 ? 32 : GP * HD / 64);
}

// Dynamic shared memory of the split pass: the K/V ring (reused by the
// final merge of the warps), then the split's page ids.
template <typename T, int HD, int G>
struct DecodeSmem {
  static constexpr size_t ring = (size_t)STAGES * 2 * DTILE * HD * sizeof(T);
  static constexpr size_t merge = (2 * NWARPS * G + (size_t)NWARPS * G * HD) * sizeof(float);
  static constexpr size_t pids = ring > merge ? ring : merge;  // byte offset of the page ids
  static size_t bytes(int split_keys, int page) {
    return pids + (size_t)(split_keys / page + 2) * sizeof(int);
  }
};

// ---------------------------------------------------------------------------
// decode, split pass: grid (n_kv, B, n_split), NTHREADS threads.  Writes
// each (row, head, split)'s f32 (m, l) to part_ml [B, H, n_split, 2] and
// its unnormalised acc to part_acc [B, H, n_split, HD]; m is in log2 units.
// ---------------------------------------------------------------------------
template <typename T, int HD, int G>
__global__ void __launch_bounds__(NTHREADS)
pa_decode_split_kernel(const T* __restrict__ q,        // [B, H, HD]
                       const T* __restrict__ k_pages,  // [P, page, n_kv, HD]
                       const T* __restrict__ v_pages,
                       const int* __restrict__ table,     // [B, maxp]
                       const int* __restrict__ seq_lens,  // [B]
                       float* __restrict__ part_ml,
                       float* __restrict__ part_acc,
                       int maxp, int page, int n_kv, int window,
                       int split_keys, float scale_log2) {
  constexpr int LPK = lanes_per_key<G, HD>();
  constexpr int EPL = HD / LPK;                  // elements of a row per lane
  constexpr int VEC = 16 / (int)sizeof(T);       // elements per 16-byte vector
  constexpr int NV = EPL / VEC;                  // vectors per lane
  constexpr int NG = NWARPS * 32 / LPK;          // key groups per block
  constexpr int KPG = DTILE / NG;                // keys per group per tile
  constexpr int VPR = HD / VEC;                  // vectors per key row
  constexpr int TILE = DTILE * HD;               // elements of one K (or V) tile
  static_assert(NV >= 1 && KPG >= 1, "decode lane layout");

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [STAGES][K, V][DTILE][HD]
  int* pids = reinterpret_cast<int*>(smem + DecodeSmem<T, HD, G>::pids);

  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z, H = n_kv * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int seq_len = seq_lens[b];
  const int lo = split * split_keys;
  const int hi = min(lo + split_keys, seq_len);
  const int first = max(lo, window > 0 ? seq_len - window : 0);
  // partials of head kh*G + g sit at base + g * n_split
  const size_t base = ((size_t)b * H + kh * G) * n_split + split;
  if (first >= hi) {  // nothing of this row in this split
    if (tid < G) {
      part_ml[(base + (size_t)tid * n_split) * 2] = NEG_INF;
      part_ml[(base + (size_t)tid * n_split) * 2 + 1] = 0.f;
    }
    return;
  }

  // the split's page ids, read once
  const int p_first = first / page;
  const int n_pid = (hi - 1) / page - p_first + 1;
  const int* trow = table + (size_t)b * maxp;
  for (int i = tid; i < n_pid; i += NTHREADS) pids[i] = trow[min(p_first + i, maxp - 1)];
  __syncthreads();

  const size_t tok_stride = (size_t)n_kv * HD;
  const int t_begin = lo + ((first - lo) / DTILE) * DTILE;
  const int n_tiles = (hi - t_begin + DTILE - 1) / DTILE;
  auto load_tile = [&](int it) {
    const int t0 = t_begin + it * DTILE;
    T* ks = ring + (size_t)(it % STAGES) * 2 * TILE;
    T* vs = ks + TILE;
    for (int i = tid; i < DTILE * VPR; i += NTHREADS) {
      const int r = i / VPR, c = i % VPR;
      const int t = t0 + r;
      const bool ok = t >= first && t < hi;
      size_t off = (size_t)c * VEC;
      if (ok)
        off += ((size_t)pids[t / page - p_first] * page + t % page) * tok_stride +
               (size_t)kh * HD;
      const size_t dst = (size_t)r * HD + c * VEC;
      cp_async16(smem_u32(ks + dst), k_pages + off, ok);
      cp_async16(smem_u32(vs + dst), v_pages + off, ok);
    }
  };

  // lane li of key group gi holds elements (v * LPK + li) * VEC + [0, VEC)
  const int gi = warp * (32 / LPK) + lane / LPK, li = lane % LPK;
  float qr[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qh = q + ((size_t)b * H + kh * G + g) * HD;
#pragma unroll
    for (int v = 0; v < NV; ++v) load_f(qh + (v * LPK + li) * VEC, &qr[g][v * VEC]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] *= scale_log2;
      acc[g][e] = 0.f;
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

  load_tile(0);
  cp_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(it + 1);  // next tile in flight while this one is scored
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const T* ks = ring + (size_t)(it % STAGES) * 2 * TILE;
    const T* vs = ks + TILE;
    const int t0 = t_begin + it * DTILE;

    float s[G][KPG];
#pragma unroll
    for (int r = 0; r < KPG; ++r) {
      const int j = gi + NG * r;
      const int t = t0 + j;
      const bool ok = t >= first && t < hi;
      float kf[EPL];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        load_f(ks + (size_t)j * HD + (v * LPK + li) * VEC, &kf[v * VEC]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) d += __shfl_xor_sync(FULL, d, o);
        s[g][r] = ok ? d : NEG_INF;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = s[g][0];
#pragma unroll
      for (int r = 1; r < KPG; ++r) mt = fmaxf(mt, s[g][r]);
      const float m_new = fmaxf(m[g], mt);
      const float m_use = m_new > 0.5f * NEG_INF ? m_new : 0.f;
      const float corr = exp2f(m[g] - m_use);
      float ps = 0.f;
#pragma unroll
      for (int r = 0; r < KPG; ++r) {
        s[g][r] = exp2f(s[g][r] - m_use);  // masked keys: exp2(-1e30) = 0
        ps += s[g][r];
      }
      l[g] = l[g] * corr + ps;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
      m[g] = m_new;
    }
#pragma unroll
    for (int r = 0; r < KPG; ++r) {
      const int j = gi + NG * r;
      float vf[EPL];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        load_f(vs + (size_t)j * HD + (v * LPK + li) * VEC, &vf[v * VEC]);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(s[g][r], vf[e], acc[g][e]);
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  // merge the key groups of a warp (lanes li, li + LPK, ...) ...
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
      const float mo = __shfl_xor_sync(FULL, m[g], o);
      const float lo_ = __shfl_xor_sync(FULL, l[g], o);
      const float M = fmaxf(m[g], mo);
      const float Mu = M > 0.5f * NEG_INF ? M : 0.f;
      const float f1 = exp2f(m[g] - Mu), f2 = exp2f(mo - Mu);
      l[g] = l[g] * f1 + lo_ * f2;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] = acc[g][e] * f1 + __shfl_xor_sync(FULL, acc[g][e], o) * f2;
      m[g] = M;
    }
  }
  // ... then the warps, through shared memory (the ring is free now)
  float* cm = reinterpret_cast<float*>(smem);  // [NWARPS][G]
  float* cl = cm + NWARPS * G;                  // [NWARPS][G]
  float* ca = cl + NWARPS * G;                  // [NWARPS][G][HD]
  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (li == 0) {
        cm[warp * G + g] = m[g];
        cl[warp * G + g] = l[g];
      }
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          ca[(warp * G + g) * HD + (v * LPK + li) * VEC + e] = acc[g][v * VEC + e];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += NTHREADS) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, cm[w * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = exp2f(cm[w * G + g] - M);
      L += cl[w * G + g] * f;
      A += ca[(w * G + g) * HD + d] * f;
    }
    const size_t pi = base + (size_t)g * n_split;
    part_acc[pi * HD + d] = A;
    if (d == 0) {
      part_ml[pi * 2] = M;
      part_ml[pi * 2 + 1] = L;
    }
  }
}

// ---------------------------------------------------------------------------
// decode, merge pass: grid (H, B), HD threads; one block per (row, head).
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
pa_decode_merge_kernel(const float* __restrict__ part_ml,
                       const float* __restrict__ part_acc,
                       const float* __restrict__ sink,  // [H] or nullptr
                       T* __restrict__ out,              // [B, H, HD]
                       int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, d = threadIdx.x;
  const size_t base = ((size_t)b * H + h) * n_split;
  float M = NEG_INF;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, part_ml[(base + s) * 2]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float ms = part_ml[(base + s) * 2];
    if (ms > 0.5f * NEG_INF) {  // empty splits wrote no acc
      const float f = exp2f(ms - M);
      L += part_ml[(base + s) * 2 + 1] * f;
      A += part_acc[(base + s) * HD + d] * f;
    }
  }
  if (sink != nullptr) L += exp2f(sink[h] * LOG2E - M);  // inf for an empty row: 0 out
  out[((size_t)b * H + h) * HD + d] = from_f<T>(A / fmaxf(L, 1e-30f));
}

// ---------------------------------------------------------------------------
// f32 prefill on CUDA cores: grid (ceil(S / BQ), H, B), NTHREADS threads;
// each warp owns RPW query rows; dynamic shared memory holds one 32-key K
// tile and V tile.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
pa_prefill_kernel(const T* __restrict__ q,      // [B, S, H, HD]
                  const T* __restrict__ k_new,  // [B, S, n_kv, HD]
                  const T* __restrict__ v_new,
                  const T* __restrict__ k_pages,  // [P, page, n_kv, HD]
                  const T* __restrict__ v_pages,
                  const int* __restrict__ table,        // [B, maxp]
                  const int* __restrict__ prefix_lens,  // [B]
                  const int* __restrict__ chunk_lens,   // [B]
                  const float* __restrict__ sink,       // [H] or nullptr
                  T* __restrict__ out,                  // [B, S, H, HD]
                  int S, int H, int n_kv, int maxp, int page, int window,
                  float scale) {
  constexpr int EPL = HD / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)KEYS * HD;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / n_kv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pre = prefix_lens[b], cl = chunk_lens[b];
  const size_t tok_stride = (size_t)n_kv * HD;

  int row[RPW];
  float qr[RPW][EPL], m[RPW], l[RPW], acc[RPW][EPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    row[i] = q0 + warp * RPW + i;
    const bool in = row[i] < cl;
    const T* qh = q + (((size_t)b * S + min(row[i], S - 1)) * H + h) * HD + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[i][e] = in ? to_f(qh[e]) * scale : 0.f;
      acc[i][e] = 0.f;
    }
    m[i] = NEG_INF;
    l[i] = 0.f;
  }

  if (q0 < cl) {  // block-uniform: rows at or past chunk_len are zeros
    // ---- the cached prefix, read through the page table ---- //
    const int* trow = table + (size_t)b * maxp;
    const int kstart = window > 0 ? max(pre + q0 - window + 1, 0) : 0;
    for (int t0 = (kstart / KEYS) * KEYS; t0 < pre; t0 += KEYS) {
      __syncthreads();
      auto src_of = [&](int r, const T* pool) -> const T* {
        const int t = t0 + r;
        if (t >= pre) return nullptr;
        const int pidx = min(t / page, maxp - 1);
        const size_t slot = (size_t)trow[pidx] * page + (t % page);
        return pool + slot * tok_stride + (size_t)kh * HD;
      };
      stage_rows<T, HD>(ks, KEYS, [&](int r) { return src_of(r, k_pages); });
      stage_rows<T, HD>(vs, KEYS, [&](int r) { return src_of(r, v_pages); });
      stage_wait();
      const int t = t0 + lane;
      bool valid[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        valid[i] = row[i] < cl && t < pre &&
                   (window <= 0 || t > pre + row[i] - window);
      fold_tile<T, HD, RPW>(qr, ks, vs, valid, m, l, acc);
    }
    // ---- the chunk itself, causal ---- //
    const int jstart = window > 0 ? max(q0 - window + 1, 0) : 0;
    const int jend = min(cl, q0 + BQ);
    for (int j0 = (jstart / KEYS) * KEYS; j0 < jend; j0 += KEYS) {
      __syncthreads();
      auto src_of = [&](int r, const T* src) -> const T* {
        const int j = j0 + r;
        if (j >= jend) return nullptr;
        return src + (((size_t)b * S + j) * n_kv + kh) * HD;
      };
      stage_rows<T, HD>(ks, KEYS, [&](int r) { return src_of(r, k_new); });
      stage_rows<T, HD>(vs, KEYS, [&](int r) { return src_of(r, v_new); });
      stage_wait();
      const int j = j0 + lane;
      bool valid[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        valid[i] = row[i] < cl && j <= row[i] &&
                   (window <= 0 || j > row[i] - window);
      fold_tile<T, HD, RPW>(qr, ks, vs, valid, m, l, acc);
    }
  }

  const float sk = sink != nullptr ? sink[h] : NEG_INF;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (row[i] >= S) continue;
    const float L = l[i] + (sink != nullptr ? expf(sk - m[i]) : 0.f);
    const float inv = row[i] < cl ? 1.f / fmaxf(L, 1e-30f) : 0.f;
    T* o = out + (((size_t)b * S + row[i]) * H + h) * HD + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = from_f<T>(acc[i][e] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 prefill on the tensor cores: grid (ceil(S / (MROWS / G)), n_kv, B),
// NTHREADS threads (one warpgroup).  Tile row r is query position
// q0 + r / G of head kh * G + r % G, so the tile's rows are one contiguous
// run of q (and of the output).  Warp w holds rows 16w..16w+15 of every
// accumulator.  Dynamic shared memory: the Q tile, then the K/V ring, in
// the swizzled atoms of tile_off.
// ---------------------------------------------------------------------------
template <int HD, int G>
__global__ void __launch_bounds__(NTHREADS)
pa_prefill_wgmma_kernel(const __nv_bfloat16* __restrict__ q,      // [B, S, H, HD]
                      const __nv_bfloat16* __restrict__ k_new,  // [B, S, n_kv, HD]
                      const __nv_bfloat16* __restrict__ v_new,
                      const __nv_bfloat16* __restrict__ k_pages,  // [P, page, n_kv, HD]
                      const __nv_bfloat16* __restrict__ v_pages,
                      const int* __restrict__ table,        // [B, maxp]
                      const int* __restrict__ prefix_lens,  // [B]
                      const int* __restrict__ chunk_lens,   // [B]
                      const float* __restrict__ sink,       // [H] or nullptr
                      __nv_bfloat16* __restrict__ out,      // [B, S, H, HD]
                      int S, int n_kv, int maxp, int page, int page_shift,
                      int window, float scale_log2) {
  constexpr int R = MROWS / G;      // query positions per block (rows R * G..63 spare)
  constexpr int CPR = HD / 8;       // 16-byte chunks per row
  constexpr int NT_S = NKEYS / 8;   // score n-tiles (8 keys each)
  constexpr int NT_O = HD / 8;      // output n-tiles (8 dims each)
  constexpr int KS_Q = HD / 16;     // k-steps of Q.K^T over the head dim
  constexpr int TILE_BYTES = NKEYS * HD * 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // 1024-byte aligned (the wgmma swizzle atoms): the Q tile, the K/V ring
  // [PSTAGES][K, V][NKEYS rows], then the block's prefix page ids
  const uint32_t pad = ((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw);
  unsigned char* smem = smem_raw + pad;
  const uint32_t qs = smem_u32(smem);
  const uint32_t ring = qs + MROWS * HD * 2;

  const int q0 = blockIdx.x * R, kh = blockIdx.y, b = blockIdx.z;
  const int H = n_kv * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pre = prefix_lens[b], cl = chunk_lens[b];
  const int q_rows = min(R, S - q0);  // positions of this tile inside S
  __nv_bfloat16* o_base = out + (((size_t)b * S + q0) * H + kh * G) * HD;

  if (q0 >= cl) {  // block-uniform: rows at or past chunk_len are zeros
    for (int i = tid; i < q_rows * G * CPR; i += NTHREADS) {
      const int p = i / (G * CPR), c = i % (G * CPR);
      *reinterpret_cast<uint4*>(o_base + (size_t)p * H * HD + c * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  // the Q tile (rows past S zero-filled)
  for (int i = tid; i < MROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r / G < q_rows;
    const size_t off = ok ? ((size_t)(r / G) * H + r % G) * HD + c * 8 : 0;
    cp_async16(qs + tile_off(r, c), q + (((size_t)b * S + q0) * H + kh * G) * HD + off, ok);
  }

  // key space u: prefix position u < pre, else chunk position u - pre.
  // Keys past the block's last valid row are causally invisible to every
  // valid row of the block, so the loop ends there.
  const int u_end = pre + min(q0 + R, cl);
  const int u_start = window > 0 ? max(0, pre + q0 - window + 1) : 0;
  const int u_first = (u_start / NKEYS) * NKEYS;
  const int n_tiles = (u_end - u_first + NKEYS - 1) / NKEYS;
  // the page ids of the prefix keys this block reads, once
  int* spid = reinterpret_cast<int*>(smem + MROWS * HD * 2 + PSTAGES * 2 * TILE_BYTES);
  const int* trow = table + (size_t)b * maxp;
  const int pg0 = u_first / page;
  const int pre_hi = min(u_end, pre);
  const int n_pg = pre_hi > u_first ? min((pre_hi - 1) / page - pg0 + 1, maxp) : 0;
  for (int i = tid; i < n_pg; i += NTHREADS) spid[i] = trow[min(pg0 + i, maxp - 1)];
  __syncthreads();

  // thread tid copies chunk lc of rows lr, lr + RSTEP, ... of each tile;
  // RSTEP is a multiple of 8, so the swizzle of its rows is one constant
  constexpr int RSTEP = NTHREADS / CPR;
  constexpr int RPT = NKEYS / RSTEP;
  const int lr = tid / CPR, lc = tid % CPR;
  const uint32_t dst0 = tile_off(lr, lc);
  const size_t tok_stride = (size_t)n_kv * HD;
  const size_t col = (size_t)kh * HD + lc * 8;
  const __nv_bfloat16* kn_b = k_new + (size_t)b * S * tok_stride + col;
  const __nv_bfloat16* vn_b = v_new + (size_t)b * S * tok_stride + col;
  // K and V of tile `it` into its stage of the ring (one address per key
  // for both)
  auto load_tile = [&](int it) {
    if (it >= n_tiles) return;
    const int u0 = u_first + it * NKEYS;
    const uint32_t ks = ring + (it % PSTAGES) * 2 * TILE_BYTES + dst0, vs = ks + TILE_BYTES;
    if (u0 >= pre && u0 + NKEYS <= u_end) {  // a whole tile of the chunk
      const size_t off = (size_t)(u0 - pre + lr) * tok_stride;
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const size_t o = off + (size_t)k * RSTEP * tok_stride;
        cp_async16(ks + k * RSTEP * 128, kn_b + o, true);
        cp_async16(vs + k * RSTEP * 128, vn_b + o, true);
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int u = u0 + lr + k * RSTEP;
      const bool ok = u < u_end;  // else zero-filled (and masked)
      const __nv_bfloat16 *ksrc = k_new, *vsrc = v_new;
      if (ok && u < pre) {
        const int pidx = page_shift >= 0 ? u >> page_shift : u / page;
        const size_t slot = (size_t)spid[min(pidx - pg0, n_pg - 1)] * page + (u - pidx * page);
        ksrc = k_pages + slot * tok_stride + col;
        vsrc = v_pages + slot * tok_stride + col;
      } else if (ok) {
        ksrc = kn_b + (size_t)(u - pre) * tok_stride;
        vsrc = vn_b + (size_t)(u - pre) * tok_stride;
      }
      cp_async16(ks + k * RSTEP * 128, ksrc, ok);
      cp_async16(vs + k * RSTEP * 128, vsrc, ok);
    }
  };

  const int g8 = lane >> 2, t4 = lane & 3;  // accumulator fragment coordinates
  const int row0 = warp * 16 + g8;           // this thread's rows: row0, row0 + 8
  const int qpos[2] = {pre + q0 + row0 / G, pre + q0 + (row0 + 8) / G};

  // Accumulators in the wgmma layout (that of mma.sync's m16n8 tiles):
  // s[j] / o[j] hold rows row0 and row0 + 8 of keys / dims 8j + 2*t4 + {0, 1}.
  float s[NT_S][4], o[NT_O][4];
  uint32_t pa[NKEYS / 16][4];  // P of the tile, bf16 A fragments of P.V
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // m: running row max of the unscaled scores; mu: the max in use, scaled
  // to log2 units (0 while the row has seen no visible key)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, mu[2] = {0.f, 0.f};

  // S = Q.K^T of tile `it` into s (asynchronous: committed, not waited)
  auto issue_s = [&](int it) {
    const uint32_t ks = ring + (it % PSTAGES) * 2 * TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < KS_Q; ++kk) {  // 16 dims a step, 4 steps per atom
      const uint32_t off = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      wg_ss_n64(s, gdesc(qs + off, 16, 1024), gdesc(ks + off, 16, 1024), kk > 0);
    }
    wg_commit();
  };
  // O += P.V of tile `it` with pa (asynchronous: committed, not waited)
  auto issue_pv = [&](int it) {
    const uint32_t vs = ring + (it % PSTAGES) * 2 * TILE_BYTES + TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < NKEYS / 16; ++kk)  // 16 keys (2048 bytes of V) a step
      wg_pv<HD>(o, pa[kk], gdesc(vs + kk * 16 * 128, V_LBO, V_SBO));
    wg_commit();
  };
  // the online softmax of tile `it`'s scores in s: s becomes P (f32), l
  // and the row maxima move, and corr holds O's rescale.  Only tiles that
  // cross the diagonal of the block's first row, or lie under a window,
  // are masked; scores stay unscaled until the exponential.
  float corr[2];
  auto softmax = [&](int it) {
    const int u0 = u_first + it * NKEYS;
    const bool need_mask = window > 0 || u0 + NKEYS - 1 > pre + q0;
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (need_mask) {
          const int u = u0 + 8 * j + 2 * t4 + (e & 1), qp = qpos[e >> 1];
          if (u > qp || (window > 0 && u <= qp - window)) s[j][e] = NEG_INF;
        }
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the 4 threads of a quad share a row
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(FULL, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(FULL, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      const float m_use = m_new > 0.5f * NEG_INF ? m_new : 0.f;
      corr[h] = fast_exp2((m[h] - m_use) * scale_log2);  // 1 unless the max moved
      mu[h] = m_use * scale_log2;
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked: exp2(-1e30 * scale) = 0
        s[j][e] = fast_exp2(fmaf(s[j][e], scale_log2, -mu[e >> 1]));
        l[e >> 1] += s[j][e];
      }
    }
  };
  // O *= corr, then P (f32 in s) -> pa (bf16 A fragments of P.V)
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
  // Per tile: the copy of the next tile is issued into the other stage,
  // then S = Q.K^T, the softmax, and O += P.V of this one.  (Overlapping
  // the softmax with the next products, FA3-style, made ptxas serialize
  // the wgmmas and ran slower; it is later work.)
  load_tile(0);  // with the Q tile, group 0
  cp_commit();
  for (int it = 0; it < n_tiles; ++it) {
    load_tile(it + 1);  // its stage was freed by the last iteration's barrier
    cp_commit();
    cp_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // cp.async data -> wgmma
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
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    const int r = row0 + 8 * h, p = r / G, gh = r % G;
    if (p >= q_rows) continue;  // a spare row (R * G <= r: G 3, 5, 6, 7) or past S
    const float L = l[h] + (sink != nullptr ? fast_exp2(sink[kh * G + gh] * LOG2E - mu[h]) : 0.f);
    const float inv = q0 + p < cl ? 1.f / fmaxf(L, 1e-30f) : 0.f;
    __nv_bfloat16* orow = o_base + ((size_t)p * H + gh) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
  }
}

template <typename T, int HD, int G>
int launch_decode(const void* q, const void* kp, const void* vp,
                  const void* table, const void* seq_lens, const void* sink,
                  void* out, float* part_ml, float* part_acc, int B, int n_kv,
                  int maxp, int page, int window, int n_split, int split_keys,
                  float scale, cudaStream_t stream) {
  const size_t bytes = DecodeSmem<T, HD, G>::bytes(split_keys, page);
  auto split = pa_decode_split_kernel<T, HD, G>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  split<<<dim3(n_kv, B, n_split), NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(seq_lens), part_ml, part_acc, maxp, page, n_kv,
      window, split_keys, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pa_decode_merge_kernel<T, HD><<<dim3(n_kv * G, B), HD, 0, stream>>>(
      part_ml, part_acc, static_cast<const float*>(sink), static_cast<T*>(out),
      n_split);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int decode_by_groups(int G, const void* q, const void* kp, const void* vp,
                     const void* table, const void* seq_lens, const void* sink,
                     void* out, float* ml, float* acc, int B, int n_kv,
                     int maxp, int page, int window, int n_split,
                     int split_keys, float scale, cudaStream_t s) {
  switch (G) {
    case 1: return launch_decode<T, HD, 1>(q, kp, vp, table, seq_lens, sink, out, ml, acc, B, n_kv, maxp, page, window, n_split, split_keys, scale, s);
    case 2: return launch_decode<T, HD, 2>(q, kp, vp, table, seq_lens, sink, out, ml, acc, B, n_kv, maxp, page, window, n_split, split_keys, scale, s);
    case 3: return launch_decode<T, HD, 3>(q, kp, vp, table, seq_lens, sink, out, ml, acc, B, n_kv, maxp, page, window, n_split, split_keys, scale, s);
    case 4: return launch_decode<T, HD, 4>(q, kp, vp, table, seq_lens, sink, out, ml, acc, B, n_kv, maxp, page, window, n_split, split_keys, scale, s);
    case 5: return launch_decode<T, HD, 5>(q, kp, vp, table, seq_lens, sink, out, ml, acc, B, n_kv, maxp, page, window, n_split, split_keys, scale, s);
    case 6: return launch_decode<T, HD, 6>(q, kp, vp, table, seq_lens, sink, out, ml, acc, B, n_kv, maxp, page, window, n_split, split_keys, scale, s);
    case 7: return launch_decode<T, HD, 7>(q, kp, vp, table, seq_lens, sink, out, ml, acc, B, n_kv, maxp, page, window, n_split, split_keys, scale, s);
    case 8: return launch_decode<T, HD, 8>(q, kp, vp, table, seq_lens, sink, out, ml, acc, B, n_kv, maxp, page, window, n_split, split_keys, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int HD>
int launch_prefill(const void* q, const void* kn, const void* vn,
                   const void* kp, const void* vp, const void* table,
                   const void* prefix, const void* chunk, const void* sink,
                   void* out, int B, int S, int H, int n_kv, int maxp,
                   int page, int window, float scale, cudaStream_t stream) {
  const size_t bytes = 2 * (size_t)KEYS * HD * sizeof(T);
  auto kern = pa_prefill_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((S + BQ - 1) / BQ, H, B), NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(prefix), static_cast<const int*>(chunk),
      static_cast<const float*>(sink), static_cast<T*>(out), S, H, n_kv,
      maxp, page, window, scale);
  return (int)cudaGetLastError();
}

template <int HD, int G>
int launch_prefill_wgmma(const void* q, const void* kn, const void* vn,
                       const void* kp, const void* vp, const void* table,
                       const void* prefix, const void* chunk, const void* sink,
                       void* out, int B, int S, int n_kv, int maxp, int page,
                       int window, float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr int R = MROWS / G;
  const size_t bytes = 1024 + (size_t)MROWS * HD * 2 +
                       (size_t)PSTAGES * 2 * NKEYS * HD * 2 + (size_t)maxp * sizeof(int);
  int page_shift = -1;  // log2(page) when page is a power of two
  for (int p = 0; p < 31; ++p)
    if ((1 << p) == page) page_shift = p;
  auto kern = pa_prefill_wgmma_kernel<HD, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((S + R - 1) / R, n_kv, B), NTHREADS, bytes, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(kn),
      static_cast<const bf*>(vn), static_cast<const bf*>(kp),
      static_cast<const bf*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(prefix), static_cast<const int*>(chunk),
      static_cast<const float*>(sink), static_cast<bf*>(out), S, n_kv, maxp,
      page, page_shift, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int prefill_wgmma_by_groups(int G, const void* q, const void* kn, const void* vn,
                          const void* kp, const void* vp, const void* table,
                          const void* prefix, const void* chunk,
                          const void* sink, void* out, int B, int S, int n_kv,
                          int maxp, int page, int window, float scale,
                          cudaStream_t s) {
  switch (G) {
    case 1: return launch_prefill_wgmma<HD, 1>(q, kn, vn, kp, vp, table, prefix, chunk, sink, out, B, S, n_kv, maxp, page, window, scale, s);
    case 2: return launch_prefill_wgmma<HD, 2>(q, kn, vn, kp, vp, table, prefix, chunk, sink, out, B, S, n_kv, maxp, page, window, scale, s);
    case 3: return launch_prefill_wgmma<HD, 3>(q, kn, vn, kp, vp, table, prefix, chunk, sink, out, B, S, n_kv, maxp, page, window, scale, s);
    case 4: return launch_prefill_wgmma<HD, 4>(q, kn, vn, kp, vp, table, prefix, chunk, sink, out, B, S, n_kv, maxp, page, window, scale, s);
    case 5: return launch_prefill_wgmma<HD, 5>(q, kn, vn, kp, vp, table, prefix, chunk, sink, out, B, S, n_kv, maxp, page, window, scale, s);
    case 6: return launch_prefill_wgmma<HD, 6>(q, kn, vn, kp, vp, table, prefix, chunk, sink, out, B, S, n_kv, maxp, page, window, scale, s);
    case 7: return launch_prefill_wgmma<HD, 7>(q, kn, vn, kp, vp, table, prefix, chunk, sink, out, B, S, n_kv, maxp, page, window, scale, s);
    case 8: return launch_prefill_wgmma<HD, 8>(q, kn, vn, kp, vp, table, prefix, chunk, sink, out, B, S, n_kv, maxp, page, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Pointers are device pointers; sink
// may be null.  part_ml [B, H, n_split, 2] and part_acc [B, H, n_split, hd]
// are f32 scratch; splits cover split_keys keys each.  Launches the split
// pass, then the merge pass.  Returns a cudaError_t (0 = launched).
extern "C" int pa_decode(const void* q, const void* k_pages,
                         const void* v_pages, const void* table,
                         const void* seq_lens, const void* sink, void* out,
                         void* part_ml, void* part_acc, int B, int H, int n_kv,
                         int hd, int maxp, int page, int window, int n_split,
                         int split_keys, int dtype, float scale, void* stream) {
  if (B == 0) return 0;
  const int G = H / n_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  if (dtype == 1 && hd == 128)
    return decode_by_groups<__nv_bfloat16, 128>(G, q, k_pages, v_pages, table, seq_lens, sink, out, ml, acc, B, n_kv, maxp, page, window, n_split, split_keys, scale, s);
  if (dtype == 1 && hd == 64)
    return decode_by_groups<__nv_bfloat16, 64>(G, q, k_pages, v_pages, table, seq_lens, sink, out, ml, acc, B, n_kv, maxp, page, window, n_split, split_keys, scale, s);
  if (dtype == 0 && hd == 128)
    return decode_by_groups<float, 128>(G, q, k_pages, v_pages, table, seq_lens, sink, out, ml, acc, B, n_kv, maxp, page, window, n_split, split_keys, scale, s);
  if (dtype == 0 && hd == 64)
    return decode_by_groups<float, 64>(G, q, k_pages, v_pages, table, seq_lens, sink, out, ml, acc, B, n_kv, maxp, page, window, n_split, split_keys, scale, s);
  return (int)cudaErrorInvalidValue;
}

// bf16 goes to the tensor-core kernel, f32 to the CUDA-core one.
extern "C" int pa_prefill(const void* q, const void* k_new, const void* v_new,
                          const void* k_pages, const void* v_pages,
                          const void* table, const void* prefix_lens,
                          const void* chunk_lens, const void* sink, void* out,
                          int B, int S, int H, int n_kv, int hd, int maxp,
                          int page, int window, int dtype, float scale,
                          void* stream) {
  if (B == 0 || S == 0) return 0;
  const int G = H / n_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && hd == 128)
    return prefill_wgmma_by_groups<128>(G, q, k_new, v_new, k_pages, v_pages, table, prefix_lens, chunk_lens, sink, out, B, S, n_kv, maxp, page, window, scale, s);
  if (dtype == 1 && hd == 64)
    return prefill_wgmma_by_groups<64>(G, q, k_new, v_new, k_pages, v_pages, table, prefix_lens, chunk_lens, sink, out, B, S, n_kv, maxp, page, window, scale, s);
  if (dtype == 0 && hd == 128)
    return launch_prefill<float, 128>(q, k_new, v_new, k_pages, v_pages, table, prefix_lens, chunk_lens, sink, out, B, S, H, n_kv, maxp, page, window, scale, s);
  if (dtype == 0 && hd == 64)
    return launch_prefill<float, 64>(q, k_new, v_new, k_pages, v_pages, table, prefix_lens, chunk_lens, sink, out, B, S, H, n_kv, maxp, page, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
