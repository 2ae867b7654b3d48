// Segment attention for the vision towers, written by hand for Hopper
// (sm_90a).
//
// What it replaces.  There is no Pallas kernel here: the JAX towers
// compute attention as XLA ops over the whole patch stream with an
// additive -1e9 mask, `einsum("qhd,khd->hqk") + mask`, `softmax`,
// `einsum("hqk,khd->qhd")` (dynamo_tpu/models/qwen_vl.py:280-309, the
// frame and window masks of `encode_patches`; dynamo_tpu/models/
// vision.py:140-150, one image per batch row in `_vit_layer`).  This
// kernel computes the same function with the mask's block structure made
// explicit: for each head, every patch attends bidirectionally to the
// patches of its own segment, segments given as contiguous runs
// (cu_seqlens).  Qwen's full layers have one segment per frame, its 2.5
// windowed layers one per 112-px window (the caller permutes the stream
// into window order once), CLIP one per image.
//
// Semantics (shared with the plain version in
// dynamo_tpu_torch/ops/vision_attention.py): q, k, v and out are
// [L, nh, hd] float32; scores q.k * scale in f32; an f32 online softmax
// (running max m, denominator l, accumulator acc) streams the segment's
// keys; every product is an f32 FMA on the CUDA cores (no TF32: the JAX
// towers run in f32, and TF32 would widen the tolerance).
//
// What bounds it: the products.  A segment of n patches costs 4 n^2 hd
// flops a head, so a Qwen2.5-VL full layer over one 1288x728 image (4784
// patches, 16 heads of 80) is 117 GFLOP against 98 MB of q, k, v and
// out: 1.75 ms at the H100's 67 TFLOP/s of f32 FMA, far above its 29 us
// of bytes.  The windowed layers (segments of 64) need 1/75 of those
// products and sit at the bytes bound.  What the design does about it, simply (speed is
// a later PR's work):
//   - no S^2 buffer and no mask: one block per (query tile of 64 rows of
//     one segment, head) walks only its own segment's keys, so masked-out
//     scores are never computed (the JAX form computes all L^2 and masks
//     them, and 28 of the tower's 32 layers are windowed);
//   - K/V tiles of 16 keys of the segment staged in shared memory with
//     16-byte cp.async into a ring of 2 stages: the next tile's copies are
//     in flight while this one is scored;
//   - four threads share two query rows, each a strided quarter of hd as
//     float4 chunks (chunk i*4 + c, so the four read neighbouring 16-byte
//     words, free of bank conflicts); each K or V word read from shared
//     memory feeds both rows' FMAs, halving the shared-memory reads a
//     product needs (one row a thread made them the limit); a score is
//     two xor shuffles;
//   - the query tiles never straddle segments: the wrapper builds a tile
//     table (q0, q1, k0, k1) on the host from the layout, which the
//     towers know before they run.
// hd may be any multiple of 16 up to 128 (80 for the Qwen towers, 64 for
// CLIP ViT-L, 16 for the golden LLaVA anchor).
//
// The C entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int RPT = 2;               // query rows a thread holds
constexpr int BQ = 32 * RPT;         // query rows per block
constexpr int KT = 16;               // keys per shared-memory tile
constexpr int NTHREADS = 128;        // 32 quads: four threads share a row pair

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte asynchronous copy global -> shared; when !ok nothing is read and
// the 16 bytes are zero-filled (src must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}
__device__ __forceinline__ void fma4(float& d, const float4& a, const float4& b) {
  d = fmaf(a.x, b.x, d);
  d = fmaf(a.y, b.y, d);
  d = fmaf(a.z, b.z, d);
  d = fmaf(a.w, b.w, d);
}
__device__ __forceinline__ void axpy4(float4& acc, float p, const float4& x) {
  acc.x = fmaf(p, x.x, acc.x);
  acc.y = fmaf(p, x.y, acc.y);
  acc.z = fmaf(p, x.z, acc.z);
  acc.w = fmaf(p, x.w, acc.w);
}

// grid (n_tiles, nh), NTHREADS threads.  tiles [n_tiles, 4] int32: the
// tile's query rows [q0, q1) and its segment's keys [k0, k1).  Thread
// (quad r, lane c) holds rows q0 + r and q0 + r + 32, each as the strided
// quarter c of hd.  Dynamic shared memory: the K/V ring [2][K, V][KT][HD]
// f32.
template <int HD>
__global__ void __launch_bounds__(NTHREADS)
segment_attention_kernel(const float* __restrict__ q,  // [L, nh, HD]
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ tiles,
                         float* __restrict__ out,  // [L, nh, HD]
                         int n_tok, int nh, float scale_log2) {
  constexpr int NC = HD / 16;  // float4 chunks a thread holds of a row
  constexpr int V4 = HD / 4;   // float4 chunks of a row
  extern __shared__ __align__(16) float smem[];

  const int h = blockIdx.y;
  const int4 tl = reinterpret_cast<const int4*>(tiles)[blockIdx.x];
  const int q0 = tl.x, q1 = tl.y, k0 = tl.z, k1 = min(tl.w, n_tok);
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const size_t tok = (size_t)nh * HD;  // elements between tokens

  // this thread's quarter of its rows: chunks i * 4 + c, pre-scaled
  float4 qr[RPT][NC], acc[RPT][NC];
  float m[RPT], l[RPT];
#pragma unroll
  for (int t = 0; t < RPT; ++t) {
    const int row = q0 + r + 32 * t;
    const float4* qp = reinterpret_cast<const float4*>(
        q + (size_t)(row < q1 ? row : q0) * tok + (size_t)h * HD);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float4 x = qp[i * 4 + c];
      qr[t][i] = make_float4(x.x * scale_log2, x.y * scale_log2, x.z * scale_log2,
                             x.w * scale_log2);
      acc[t][i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    m[t] = NEG_INF;
    l[t] = 0.f;
  }

  const int n_tiles = (k1 - k0 + KT - 1) / KT;
  auto load_tile = [&](int it) {
    float* ks = smem + (size_t)(it & 1) * 2 * KT * HD;
    float* vs = ks + KT * HD;
    const int t0 = k0 + it * KT;
    for (int i = tid; i < KT * V4; i += NTHREADS) {
      const int j = i / V4, cc = i % V4;
      const bool ok = t0 + j < k1;  // else zero-filled (and masked)
      const size_t off = (size_t)(ok ? t0 + j : k0) * tok + (size_t)h * HD + cc * 4;
      cp_async16(smem_u32(ks + j * HD + cc * 4), k + off, ok);
      cp_async16(smem_u32(vs + j * HD + cc * 4), v + off, ok);
    }
  };

  load_tile(0);
  cp_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(it + 1);  // in flight while this tile is scored
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* ks = smem + (size_t)(it & 1) * 2 * KT * HD;
    const float* vs = ks + KT * HD;
    const int n_valid = min(KT, k1 - (k0 + it * KT));

    // scores: each K word read from shared memory serves both rows
    float s[RPT][KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * HD);
      float d[RPT];
#pragma unroll
      for (int t = 0; t < RPT; ++t) d[t] = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float4 x = kr[i * 4 + c];
#pragma unroll
        for (int t = 0; t < RPT; ++t) fma4(d[t], qr[t][i], x);
      }
#pragma unroll
      for (int t = 0; t < RPT; ++t) {
        d[t] += __shfl_xor_sync(FULL, d[t], 1);
        d[t] += __shfl_xor_sync(FULL, d[t], 2);
        s[t][j] = j < n_valid ? d[t] : NEG_INF;
      }
    }
    // the online softmax: every tile holds at least one key of the
    // segment, so each row's tile maximum is finite
    float mn[RPT];
#pragma unroll
    for (int t = 0; t < RPT; ++t) {
      float mt = s[t][0];
#pragma unroll
      for (int j = 1; j < KT; ++j) mt = fmaxf(mt, s[t][j]);
      mn[t] = fmaxf(m[t], mt);
      const float corr = exp2f(m[t] - mn[t]);  // 0 on the first tile
      l[t] *= corr;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        acc[t][i].x *= corr; acc[t][i].y *= corr; acc[t][i].z *= corr; acc[t][i].w *= corr;
      }
      m[t] = mn[t];
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float p[RPT];
#pragma unroll
      for (int t = 0; t < RPT; ++t) {
        p[t] = exp2f(s[t][j] - mn[t]);  // masked keys: exp2(-1e30) = 0
        l[t] += p[t];
      }
      const float4* vr = reinterpret_cast<const float4*>(vs + j * HD);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float4 x = vr[i * 4 + c];
#pragma unroll
        for (int t = 0; t < RPT; ++t) axpy4(acc[t][i], p[t], x);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

#pragma unroll
  for (int t = 0; t < RPT; ++t) {
    const int row = q0 + r + 32 * t;
    if (row >= q1) continue;
    const float inv = 1.f / l[t];
    float4* op = reinterpret_cast<float4*>(out + (size_t)row * tok + (size_t)h * HD);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      op[i * 4 + c] = make_float4(acc[t][i].x * inv, acc[t][i].y * inv,
                                  acc[t][i].z * inv, acc[t][i].w * inv);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* tiles,
           void* out, int n_tiles, int n_tok, int nh, float scale,
           cudaStream_t stream) {
  const size_t bytes = (size_t)2 * 2 * KT * HD * sizeof(float);
  auto kern = segment_attention_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(n_tiles, nh), NTHREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(tiles),
      static_cast<float*>(out), n_tok, nh, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers are device pointers to n_tok tokens; tiles is [n_tiles, 4]
// int32 (q0, q1, k0, k1) with q1 - q0 <= 64 and [q0, q1) inside [k0, k1).
// Returns a cudaError_t (0 = launched).
extern "C" int seg_attention(const void* q, const void* k, const void* v,
                             const void* tiles, void* out, int n_tiles,
                             int n_tok, int nh, int hd, float scale,
                             void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, tiles, out, n_tiles, n_tok, nh, scale, s);
    case 32: return launch<32>(q, k, v, tiles, out, n_tiles, n_tok, nh, scale, s);
    case 48: return launch<48>(q, k, v, tiles, out, n_tiles, n_tok, nh, scale, s);
    case 64: return launch<64>(q, k, v, tiles, out, n_tiles, n_tok, nh, scale, s);
    case 80: return launch<80>(q, k, v, tiles, out, n_tiles, n_tok, nh, scale, s);
    case 96: return launch<96>(q, k, v, tiles, out, n_tiles, n_tok, nh, scale, s);
    case 112: return launch<112>(q, k, v, tiles, out, n_tiles, n_tok, nh, scale, s);
    case 128: return launch<128>(q, k, v, tiles, out, n_tiles, n_tok, nh, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
