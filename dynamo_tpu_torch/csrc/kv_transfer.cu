// The KV re-page of disaggregated serving, for Hopper (sm_90a).
//
// Replaces the XLA ops of the JAX package's device lane: the gather ->
// mask -> cast -> reshape of `from_pool` (dynamo_tpu/disagg/
// device_transfer.py:77-113) and the scatter that imports the result
// (`_build_import_fn`, dynamo_tpu/engine/engine.py:444).  One launch moves
// a prompt's K and V from the source pool (pages of ps_s tokens) straight
// into the destination pool (pages of ps_d tokens), with no intermediate
// tensor:
//
//   for each layer l, K and V, and destination token t in [0, n_dst * ps_d):
//     dst[l, dst_pages[t / ps_d], t % ps_d] =
//         t < prompt_len ? cast(src[l, src_pages[t / ps_s], t % ps_s]) : 0
//
// Pools are [L, P, page, n_kv, hd] contiguous, so one token of one layer
// is a run of row = n_kv * hd elements.  Under tensor parallelism the two
// pools may hold different head counts (a rank's n_kv / tp): then the
// rows differ (row_s, row_d) and one launch moves a window of `heads`
// heads, from head `src_head` of the source row into head `dst_head` of
// the destination row (its other heads untouched, written by the launches
// of the other source ranks).  A destination rank whose heads span several
// source ranks takes one launch per source rank; the whole row (both
// offsets 0, heads = n_kv) is the single-pool case.  The source pool is
// the other engine's (colocated lane) or the prefill worker's, mapped
// into this process through CUDA IPC (ipc lane): a raw device pointer
// either way, with its geometry passed as arguments.  `src_pages` is
// padded by the caller to cover n_dst * ps_d tokens (padding entries name
// the trash page 0), so no index read leaves it.
//
// What bounds it on an H100: bytes.  The prompt's K and V are read once
// and the destination pages written once; there is no arithmetic beyond a
// cast (a 2049-token Llama-3.1-8B prompt moves 2 x 268 MB, a 0.161 ms
// bound at 3.35 TB/s).  The design does what a copy needs: each thread
// moves 8 elements per step (16-byte bf16 loads and stores, two 16-byte
// f32 ones), neighbouring threads on neighbouring addresses along the
// token's contiguous row; a block takes one destination page of one
// layer of K or V (grid n_dst x L x 2: 8256 blocks for that prompt), so
// the card is filled many times over and every block's indices are
// computed from blockIdx, with no data-dependent control flow beyond the
// prompt_len mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;  // elements a thread moves per step
constexpr int THREADS = 256;

// 8 elements from `in` (source type) to `out` (destination type);
// same-type moves copy the bits, f32 -> bf16 rounds to nearest even
// (torch's and JAX's cast), bf16 -> f32 is exact.
template <typename TS, typename TD>
struct Move8;

template <>
struct Move8<__nv_bfloat16, __nv_bfloat16> {
  static __device__ __forceinline__ void copy(const __nv_bfloat16* in,
                                              __nv_bfloat16* out) {
    *reinterpret_cast<uint4*>(out) = __ldg(reinterpret_cast<const uint4*>(in));
  }
};

template <>
struct Move8<float, float> {
  static __device__ __forceinline__ void copy(const float* in, float* out) {
    const uint4* i = reinterpret_cast<const uint4*>(in);
    uint4* o = reinterpret_cast<uint4*>(out);
    o[0] = __ldg(i);
    o[1] = __ldg(i + 1);
  }
};

template <>
struct Move8<float, __nv_bfloat16> {
  static __device__ __forceinline__ void copy(const float* in,
                                              __nv_bfloat16* out) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(in));
    const float4 b = __ldg(reinterpret_cast<const float4*>(in) + 1);
    __nv_bfloat162 h[4] = {__floats2bfloat162_rn(a.x, a.y),
                           __floats2bfloat162_rn(a.z, a.w),
                           __floats2bfloat162_rn(b.x, b.y),
                           __floats2bfloat162_rn(b.z, b.w)};
    *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(h);
  }
};

template <>
struct Move8<__nv_bfloat16, float> {
  static __device__ __forceinline__ void copy(const __nv_bfloat16* in,
                                              float* out) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(in));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float4* o = reinterpret_cast<float4*>(out);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
    o[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
    o[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
};

template <typename TD>
__device__ __forceinline__ void zero8(TD* out) {
  uint4* o = reinterpret_cast<uint4*>(out);
#pragma unroll
  for (int i = 0; i < (int)(VEC * sizeof(TD) / 16); ++i) o[i] = make_uint4(0, 0, 0, 0);
}

template <typename TS, typename TD>
__global__ void __launch_bounds__(THREADS) kv_repage_kernel(
    const TS* __restrict__ src_k, const TS* __restrict__ src_v,
    TD* __restrict__ dst_k, TD* __restrict__ dst_v,
    const int* __restrict__ src_pages, const int* __restrict__ dst_pages,
    long long src_layer, long long dst_layer, int ps_s, int ps_d, int row_s,
    int row_d, int src_off, int dst_off, int width, int prompt_len) {
  const int j = blockIdx.x;  // destination page, in the transfer's order
  const int l = blockIdx.y;  // layer
  const TS* src = (blockIdx.z ? src_v : src_k) + (size_t)l * src_layer + src_off;
  TD* dst = (blockIdx.z ? dst_v : dst_k) + (size_t)l * dst_layer +
            (size_t)dst_pages[j] * ps_d * row_d + dst_off;
  const int vecs = width / VEC;  // 16-byte moves along the window
  const int total = ps_d * vecs;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int s = i / vecs;  // slot in the destination page
    const int c = (i - s * vecs) * VEC;
    const int t = j * ps_d + s;  // the prompt's token
    TD* out = dst + (size_t)s * row_d + c;
    if (t >= prompt_len) {
      zero8(out);
      continue;
    }
    const int sp = src_pages[t / ps_s];
    const TS* in = src + ((size_t)sp * ps_s + t % ps_s) * row_s + c;
    Move8<TS, TD>::copy(in, out);
  }
}

template <typename TS, typename TD>
cudaError_t launch(const void* src_k, const void* src_v, void* dst_k,
                   void* dst_v, const int* src_pages, const int* dst_pages,
                   int L, int n_dst, int ps_s, int ps_d, int row_s, int row_d,
                   int src_off, int dst_off, int width, long long src_layer,
                   long long dst_layer, int prompt_len, cudaStream_t stream) {
  dim3 grid(n_dst, L, 2);
  kv_repage_kernel<TS, TD><<<grid, THREADS, 0, stream>>>(
      static_cast<const TS*>(src_k), static_cast<const TS*>(src_v),
      static_cast<TD*>(dst_k), static_cast<TD*>(dst_v), src_pages, dst_pages,
      src_layer, dst_layer, ps_s, ps_d, row_s, row_d, src_off, dst_off, width,
      prompt_len);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  The pools hold kvh_s and kvh_d
// heads of hd; the launch moves `heads` heads from head src_head of the
// source row into head dst_head of the destination row.  Returns the
// launch's CUDA error (0 on success); the wrapper raises on anything else
// and checks first that the window lies inside both rows.  A window that
// is not a multiple of 8 elements wide and 8-element aligned (every move
// is 16 bytes) is refused here too.
extern "C" int kv_repage(const void* src_k, const void* src_v, void* dst_k,
                         void* dst_v, const void* src_pages,
                         const void* dst_pages, int L, int n_dst, int ps_s,
                         int ps_d, int hd, int kvh_s, int kvh_d, int src_head,
                         int dst_head, int heads, long long src_layer,
                         long long dst_layer, int prompt_len, int src_dtype,
                         int dst_dtype, void* stream) {
  const int* sp = static_cast<const int*>(src_pages);
  const int* dp = static_cast<const int*>(dst_pages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_s = kvh_s * hd, row_d = kvh_d * hd, width = heads * hd;
  const int src_off = src_head * hd, dst_off = dst_head * hd;
  if (width <= 0 || width % VEC || src_off % VEC || dst_off % VEC)
    return (int)cudaErrorInvalidValue;
#define KV_REPAGE_ARGS                                                       \
  src_k, src_v, dst_k, dst_v, sp, dp, L, n_dst, ps_s, ps_d, row_s, row_d,   \
      src_off, dst_off, width, src_layer, dst_layer, prompt_len, s
  if (src_dtype == 1 && dst_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(KV_REPAGE_ARGS);
  if (src_dtype == 0 && dst_dtype == 0) return launch<float, float>(KV_REPAGE_ARGS);
  if (src_dtype == 0 && dst_dtype == 1)
    return launch<float, __nv_bfloat16>(KV_REPAGE_ARGS);
  if (src_dtype == 1 && dst_dtype == 0)
    return launch<__nv_bfloat16, float>(KV_REPAGE_ARGS);
#undef KV_REPAGE_ARGS
  return (int)cudaErrorInvalidValue;
}
