// The device helpers that the attention kernels of paged_attention.cu and
// ring_attention.cu share: PTX wrappers (cp.async, ex2, the wgmma products
// and their fences), the 128-byte-swizzled tile layout and its descriptor,
// warp reductions, and the CUDA-core key-tile fold of the f32 kernels.
// Each .cu builds into its own library and includes this file once; the
// helpers live in an anonymous namespace, so each library keeps its own
// copy.  ops/_build.py hashes this file into every library's name, so an
// edit here rebuilds both.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int KEYS = 32;    // f32 kernels: keys per warp per tile (one per lane)

// ---- PTX helpers -----------------------------------------------------------


__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; when !ok nothing is read and
// the 16 bytes are zero-filled (src must still be a valid address).
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

// 2^x on the special-function unit (relative error ~2^-22; 0 for x <= -126
// after flushing the denormal result)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// ---- wgmma (sm_90a) --------------------------------------------------------
// V is the MN-major (transposed) B of O += P.V: its 64-dim atoms lie 8192
// bytes apart (64 keys x 128 bytes, the leading byte offset), its 8-key
// row groups 1024 bytes apart (the stride byte offset)
constexpr uint32_t V_LBO = 8192, V_SBO = 1024;

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t gdesc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// keep the compiler from moving accesses of wgmma operands across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}
// d (64 x 64 f32) (+)= A (smem, K-major) * B (smem, K-major)
__device__ __forceinline__ void wg_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (64 x 64 f32) += A (registers) * B (smem, MN-major: transposed)
__device__ __forceinline__ void wg_rs_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 128 f32) += A (registers) * B (smem, MN-major: transposed)
__device__ __forceinline__ void wg_rs_n128(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int HD>
__device__ __forceinline__ void wg_pv(float (&d)[HD / 8][4], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 128) wg_rs_n128(d, a, db); else wg_rs_n64(d, a, db);
}

// Byte offset of 16-byte chunk c of row r in a 64-row bf16 tile of the
// prefill: 64-column atoms of 128-byte rows, each atom swizzled as the
// wgmma B128 layout expects (chunk XOR row % 8, atoms 1024-byte aligned),
// so the 8 rows a phase of the tensor cores reads at one column fall in 8
// different bank groups.
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return (uint32_t)((c >> 3) * (64 * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ float to_f(float x) { return x; }
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
      cp_async16(smem_u32(d), reinterpret_cast<const uint4*>(src) + c, true);
    } else {
      *d = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void stage_wait() {
  cp_commit();
  cp_wait<0>();
  __syncthreads();
}

// (stage_rows, stage_wait and fold_tile serve the f32 kernels.)
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

}  // namespace
