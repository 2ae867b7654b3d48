// Paged attention for the KV page pool, written by hand for Hopper (sm_90a).
//
// Two kernels, each the counterpart of one Pallas TPU kernel of the JAX
// package:
//
//   pa_decode_kernel  replaces dynamo_tpu/ops/pallas_attention.py
//                     decode_attention_pallas (_decode_kernel, _page_dmas):
//                     one query token per sequence over its page-table row.
//   pa_prefill_kernel replaces dynamo_tpu/ops/pallas_attention.py
//                     prefill_attention_pallas (_prefill_kernel): a new
//                     chunk attends to its cached prefix pages, then to
//                     itself causally.
//
// Semantics (shared with the plain PyTorch versions in
// dynamo_tpu_torch/ops/paged_attention.py):
//   - pools are [P, page, n_kv, hd]; a sequence's keys live in the pages
//     its table row names, token t at (table[t / page], t % page);
//   - GQA: q head h reads kv head h / (H / n_kv);
//   - scores are q.k * 1/sqrt(hd) in f32; an f32 online softmax (running
//     max m, denominator l, accumulator acc) streams the keys;
//   - a sliding window > 0 keeps keys with position > query_pos - window;
//   - per-head sink logits join the denominator only: l += exp(sink - m);
//   - the denominator is clamped to 1e-30 and NEG_INF is -1e30, so a row
//     with no valid key (seq_len 0, or a prefill row past chunk_len)
//     gives zeros, never NaN.
//
// What bounds them on an H100: decode reads every cached K/V byte of the
// batch once and does ~4 flops per byte, so it is bound by HBM bytes
// (3.35 TB/s).  Prefill of a 512-token chunk reads q and writes the output
// for all H heads once and does 4*hd flops per (row, key) pair; at
// Llama-3.1-8B's shapes its byte and operation bounds lie within 2x of
// each other (bytes the larger), far below what this version reaches.
//
// What the design does about it (first, simple version):
//   - decode: one block per (kv head, sequence).  The block's G query
//     heads share every K/V tile: the tile is copied once from the pool
//     into shared memory with 16-byte asynchronous copies (cp.async), and
//     each of the four warps scores its 32 keys against all G heads from
//     there -- the reuse the TPU kernel gets by slicing per kv head.
//     The block reads
//     its own table row and seq_len (no scalar prefetch) and starts at
//     the first tile inside the window.  Warps keep their own online
//     softmax state and are merged through shared memory at the end.
//     At batch 4 with 8 kv heads this is only 32 blocks on 132 SMs: the
//     first thing to fix is a split over the KV length (split-KV).
//   - prefill: one block per (16 query rows, q head, sequence); a loop
//     inside the block replaces the TPU's sequential chunk grid, first
//     over the prefix pages, then over k_new/v_new tiles up to the causal
//     limit.  Scores use CUDA cores (lane-split dot products and warp
//     shuffles); wgmma/TMA tiles are later work.
//
// Each C entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int KEYS = 32;    // keys per warp per tile (one per lane)
constexpr int BQ = 16;      // prefill query rows per block
constexpr int RPW = BQ / NWARPS;  // prefill rows per warp

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Copy `nrows` key rows of one kv head (HD elements each) into shared
// memory as 16-byte vectors; row r comes from src_of(r), or is zero when
// src_of(r) returns nullptr.  All threads of the block take part.  The
// copies are asynchronous (cp.async): every thread issues all of its
// copies before any completes, so a tile costs about one memory latency
// instead of one per vector.  Callers wait with stage_wait().
template <typename T, int HD, typename SrcOf>
__device__ __forceinline__ void stage_rows(T* dst, int nrows, SrcOf src_of) {
  constexpr int VPR = HD * (int)sizeof(T) / 16;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < nrows * VPR; i += blockDim.x) {
    const int r = i / VPR, c = i % VPR;
    const T* src = src_of(r);
    uint4* d = reinterpret_cast<uint4*>(dst + (size_t)r * HD) + c;
    if (src != nullptr) {
      __pipeline_memcpy_async(d, reinterpret_cast<const uint4*>(src) + c, 16);
    } else {
      *d = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void stage_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// One warp folds a tile of 32 keys (row j of ks/vs is the key of lane j)
// into the online softmax state of R query rows.  valid[i] says whether
// THIS lane's key is visible to row i.  q rows are pre-scaled f32, split
// over lanes as EPL contiguous elements each.
template <typename T, int HD, int R>
__device__ __forceinline__ void fold_tile(float (&qr)[R][HD / 32],
                                          const T* ks, const T* vs,
                                          bool (&valid)[R],
                                          float (&m)[R], float (&l)[R],
                                          float (&acc)[R][HD / 32]) {
  constexpr int EPL = HD / 32;
  const int lane = threadIdx.x & 31;
  float s_own[R];
#pragma unroll
  for (int i = 0; i < R; ++i) s_own[i] = NEG_INF;
  for (int j = 0; j < KEYS; ++j) {
    const T* kr = ks + (size_t)j * HD + lane * EPL;
    float kf[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) kf[e] = to_f(kr[e]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d = fmaf(qr[i][e], kf[e], d);
      d = warp_sum(d);
      if (lane == j) s_own[i] = d;
    }
  }
  float p_own[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float s = valid[i] ? s_own[i] : NEG_INF;
    const float mt = warp_max(s);  // warp-uniform
    p_own[i] = 0.f;
    if (mt > 0.5f * NEG_INF) {
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      const float p = valid[i] ? expf(s - m_new) : 0.f;
      l[i] = l[i] * corr + warp_sum(p);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[i][e] *= corr;
      m[i] = m_new;
      p_own[i] = p;
    }
  }
  for (int j = 0; j < KEYS; ++j) {
    const T* vr = vs + (size_t)j * HD + lane * EPL;
    float vf[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) vf[e] = to_f(vr[e]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float pj = __shfl_sync(FULL, p_own[i], j);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[i][e] = fmaf(pj, vf[e], acc[i][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// decode: grid (n_kv, B), NTHREADS threads; dynamic shared memory holds one
// tile of NWARPS*32 keys for K and V (reused for the final warp merge).
// ---------------------------------------------------------------------------
template <typename T, int HD, int G>
__global__ void __launch_bounds__(NTHREADS)
pa_decode_kernel(const T* __restrict__ q,        // [B, H, HD]
                 const T* __restrict__ k_pages,  // [P, page, n_kv, HD]
                 const T* __restrict__ v_pages,
                 const int* __restrict__ table,  // [B, maxp]
                 const int* __restrict__ seq_lens,  // [B]
                 const float* __restrict__ sink,    // [H] or nullptr
                 T* __restrict__ out,               // [B, H, HD]
                 int maxp, int page, int n_kv, int window, float scale) {
  constexpr int EPL = HD / 32;
  constexpr int TILE = KEYS * NWARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)TILE * HD;

  const int kh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = n_kv * G;
  const int seq_len = seq_lens[b];
  const int start = window > 0 ? max(seq_len - window, 0) : 0;
  const int* trow = table + (size_t)b * maxp;
  const size_t tok_stride = (size_t)n_kv * HD;

  float qr[G][EPL], m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qh = q + ((size_t)b * H + kh * G + g) * HD + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] = to_f(qh[e]) * scale;
      acc[g][e] = 0.f;
    }
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

  for (int t0 = (start / TILE) * TILE; t0 < seq_len; t0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    auto src_of = [&](int r, const T* pool) -> const T* {
      const int t = t0 + r;
      if (t >= seq_len || t < start) return nullptr;
      const int pidx = min(t / page, maxp - 1);
      const size_t slot = (size_t)trow[pidx] * page + (t % page);
      return pool + slot * tok_stride + (size_t)kh * HD;
    };
    stage_rows<T, HD>(ks, TILE, [&](int r) { return src_of(r, k_pages); });
    stage_rows<T, HD>(vs, TILE, [&](int r) { return src_of(r, v_pages); });
    stage_wait();
    const int tw = t0 + warp * KEYS;
    if (tw < seq_len && tw + KEYS > start) {  // warp-uniform
      const int t = tw + lane;
      const bool ok = t < seq_len && t >= start;
      bool valid[G];
#pragma unroll
      for (int g = 0; g < G; ++g) valid[g] = ok;
      fold_tile<T, HD, G>(qr, ks + (size_t)warp * KEYS * HD,
                          vs + (size_t)warp * KEYS * HD, valid, m, l, acc);
    }
  }

  // merge the warps' partial softmax states
  __syncthreads();
  float* cm = reinterpret_cast<float*>(smem);  // [NWARPS][G]
  float* cl = cm + NWARPS * G;                  // [NWARPS][G]
  float* ca = cl + NWARPS * G;                  // [NWARPS][G][HD]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      cm[warp * G + g] = m[g];
      cl[warp * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      ca[((size_t)warp * G + g) * HD + lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, cm[w * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = expf(cm[w * G + g] - M);
      L += cl[w * G + g] * f;
      A += ca[((size_t)w * G + g) * HD + d] * f;
    }
    if (sink != nullptr) L += expf(sink[kh * G + g] - M);
    out[((size_t)b * H + kh * G + g) * HD + d] = from_f<T>(A / fmaxf(L, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// prefill: grid (ceil(S / BQ), H, B), NTHREADS threads; each warp owns RPW
// query rows; dynamic shared memory holds one 32-key K tile and V tile.
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

template <typename T, int HD, int G>
int launch_decode(const void* q, const void* kp, const void* vp,
                  const void* table, const void* seq_lens, const void* sink,
                  void* out, int B, int n_kv, int maxp, int page, int window,
                  float scale, cudaStream_t stream) {
  const size_t tile = 2 * (size_t)KEYS * NWARPS * HD * sizeof(T);
  const size_t merge = (2 * NWARPS * G + (size_t)NWARPS * G * HD) * sizeof(float);
  const size_t bytes = tile > merge ? tile : merge;
  auto kern = pa_decode_kernel<T, HD, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(n_kv, B), NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(seq_lens), static_cast<const float*>(sink),
      static_cast<T*>(out), maxp, page, n_kv, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int decode_by_groups(int G, const void* q, const void* kp, const void* vp,
                     const void* table, const void* seq_lens, const void* sink,
                     void* out, int B, int n_kv, int maxp, int page, int window,
                     float scale, cudaStream_t s) {
  switch (G) {
    case 1: return launch_decode<T, HD, 1>(q, kp, vp, table, seq_lens, sink, out, B, n_kv, maxp, page, window, scale, s);
    case 2: return launch_decode<T, HD, 2>(q, kp, vp, table, seq_lens, sink, out, B, n_kv, maxp, page, window, scale, s);
    case 4: return launch_decode<T, HD, 4>(q, kp, vp, table, seq_lens, sink, out, B, n_kv, maxp, page, window, scale, s);
    case 8: return launch_decode<T, HD, 8>(q, kp, vp, table, seq_lens, sink, out, B, n_kv, maxp, page, window, scale, s);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Pointers are device pointers; sink
// may be null.  Returns a cudaError_t (0 = launched).
extern "C" int pa_decode(const void* q, const void* k_pages,
                         const void* v_pages, const void* table,
                         const void* seq_lens, const void* sink, void* out,
                         int B, int H, int n_kv, int hd, int maxp, int page,
                         int window, int dtype, float scale, void* stream) {
  if (B == 0) return 0;
  const int G = H / n_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && hd == 128)
    return decode_by_groups<__nv_bfloat16, 128>(G, q, k_pages, v_pages, table, seq_lens, sink, out, B, n_kv, maxp, page, window, scale, s);
  if (dtype == 1 && hd == 64)
    return decode_by_groups<__nv_bfloat16, 64>(G, q, k_pages, v_pages, table, seq_lens, sink, out, B, n_kv, maxp, page, window, scale, s);
  if (dtype == 0 && hd == 128)
    return decode_by_groups<float, 128>(G, q, k_pages, v_pages, table, seq_lens, sink, out, B, n_kv, maxp, page, window, scale, s);
  if (dtype == 0 && hd == 64)
    return decode_by_groups<float, 64>(G, q, k_pages, v_pages, table, seq_lens, sink, out, B, n_kv, maxp, page, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pa_prefill(const void* q, const void* k_new, const void* v_new,
                          const void* k_pages, const void* v_pages,
                          const void* table, const void* prefix_lens,
                          const void* chunk_lens, const void* sink, void* out,
                          int B, int S, int H, int n_kv, int hd, int maxp,
                          int page, int window, int dtype, float scale,
                          void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && hd == 128)
    return launch_prefill<__nv_bfloat16, 128>(q, k_new, v_new, k_pages, v_pages, table, prefix_lens, chunk_lens, sink, out, B, S, H, n_kv, maxp, page, window, scale, s);
  if (dtype == 1 && hd == 64)
    return launch_prefill<__nv_bfloat16, 64>(q, k_new, v_new, k_pages, v_pages, table, prefix_lens, chunk_lens, sink, out, B, S, H, n_kv, maxp, page, window, scale, s);
  if (dtype == 0 && hd == 128)
    return launch_prefill<float, 128>(q, k_new, v_new, k_pages, v_pages, table, prefix_lens, chunk_lens, sink, out, B, S, H, n_kv, maxp, page, window, scale, s);
  if (dtype == 0 && hd == 64)
    return launch_prefill<float, 64>(q, k_new, v_new, k_pages, v_pages, table, prefix_lens, chunk_lens, sink, out, B, S, H, n_kv, maxp, page, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
