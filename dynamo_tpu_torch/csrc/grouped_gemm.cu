// MoE grouped GEMM, written by hand for Hopper (sm_90a).
//
// The counterpart of `jax.lax.ragged_dot` in the JAX package's dropless
// MoE (`_moe_ragged`, dynamo_tpu/models/llama.py:336): rows of `xs` are
// sorted by expert, expert e owns rows [offs[e], offs[e+1]), and each row
// is multiplied by its expert's weight:
//
//   out[r, :] = xs[r, :] @ w[e, :, :]      (bf16 in, f32 out)
//
// ragged_dot is an XLA op, not a Pallas kernel; the port writes it by
// hand because the decode steps run as CUDA graphs: the group offsets
// live on the device and the grid may not change with the routing.
//
// Shapes: xs [A, K] bf16 (row-major), w [E, K, N] bf16 (the JAX layout,
// N contiguous), offs [E+1] int32 on the device with offs[0] = 0,
// nondecreasing, offs[E] = A; out [A, N] f32.  K and N are multiples of 8
// (16-byte rows of 8 bf16).
//
// WHAT BOUNDS IT: the expert weights.  At gpt-oss-20b's shapes (K = N =
// 2880) an expert's matrix is 16.6 MB; a decode step of 8 rows x top-4
// touches up to 32 experts for 32 rows, about 2 flops per weight byte,
// and a 512-token prefill chunk (2048 rows, ~64 an expert) about 128 --
// both below the ~295 flops/byte where the H100's bf16 tensor cores, not
// HBM, would be the limit.  So the kernel streams each touched expert's
// weights once per 64-row tile and does not read untouched experts.
//
// DESIGN (a first, simple version; wgmma, TMA and a fused gate||up are
// later speed work):
//   - grid (ceil(A/BM) + E, ceil(N/BN)), fixed by shapes: expert e needs
//     ceil(n_e/BM) row tiles, and sum_e ceil(n_e/BM) <= ceil(A/BM) + E.
//     Block x walks offs (E <= a few dozen entries) to find its expert
//     and first row; blocks past the last tile exit;
//   - a 64 x 64 output tile per block of 4 warps (each 32 x 32), over K in
//     tiles of 64, through a 3-stage ring of 16-byte cp.async copies.
//     Rows past the expert's last row and columns past N are zero-filled,
//     never read from memory, and never stored;
//   - mma.sync m16n8k16 bf16 -> f32, operands from shared memory by
//     ldmatrix (B transposed on the way: w is K-major in memory); shared
//     rows are skewed by 16 bytes so ldmatrix hits 8 distinct bank groups;
//   - batch invariance: each output element is one thread's f32 sum over
//     K in the same order (BK tiles in order, 16-wide steps in order, the
//     mma's own fixed order inside), whichever tile holds its row and
//     whatever else was routed to its expert.  No atomics, no split-K.
//
// The C entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows per tile
constexpr int BN = 64;        // output columns per tile
constexpr int BK = 64;        // contraction per pipeline stage
constexpr int STAGES = 3;     // depth of the cp.async ring
constexpr int NTHREADS = 128; // 4 warps, 2 x 2 over the 64 x 64 tile
constexpr int LDA = BK + 8;   // shared row strides, skewed by 16 bytes
constexpr int LDB = BN + 8;
constexpr int STAGE_ELEMS = BM * LDA + BK * LDB;
constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2;

using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(NTHREADS)
moe_grouped_gemm_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ w,
                        const int* __restrict__ offs, float* __restrict__ out,
                        int A, int E, int K, int N) {
  __shared__ int tile_info[3];  // expert (-1: past the last tile), row0, row1
  if (threadIdx.x == 0) {
    const int t = blockIdx.x;
    int before = 0, e_hit = -1, r0 = 0, r1 = 0;
    for (int e = 0; e < E; ++e) {
      const int lo = offs[e], hi = offs[e + 1];
      const int tiles = hi > lo ? (hi - lo + BM - 1) / BM : 0;
      if (t < before + tiles) {
        e_hit = e;
        r0 = lo + (t - before) * BM;
        r1 = min(min(r0 + BM, hi), A);
        break;
      }
      before += tiles;
    }
    tile_info[0] = e_hit;
    tile_info[1] = r0;
    tile_info[2] = r1;
  }
  __syncthreads();
  const int e = tile_info[0];
  if (e < 0) return;
  const int r0 = tile_info[1], r1 = tile_info[2];
  if (r0 >= r1) return;
  const int n0 = blockIdx.y * BN;
  const bf16* we = w + (size_t)e * K * N;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;

  auto load_stage = [&](int stage, int k0) {
    bf16* as = smem + stage * STAGE_ELEMS;
    bf16* bs = as + BM * LDA;
    #pragma unroll
    for (int i = tid; i < BM * (BK / 8); i += NTHREADS) {
      const int r = i / (BK / 8), c = i % (BK / 8);
      const int row = r0 + r, k = k0 + c * 8;
      const bool ok = row < r1 && k < K;
      cp_async16(smem_u32(as + r * LDA + c * 8),
                 ok ? (const void*)(xs + (size_t)row * K + k) : (const void*)xs, ok);
    }
    #pragma unroll
    for (int i = tid; i < BK * (BN / 8); i += NTHREADS) {
      const int r = i / (BN / 8), c = i % (BN / 8);
      const int k = k0 + r, n = n0 + c * 8;
      const bool ok = k < K && n < N;
      cp_async16(smem_u32(bs + r * LDB + c * 8),
                 ok ? (const void*)(we + (size_t)k * N + n) : (const void*)we, ok);
    }
  };

  const int KT = (K + BK - 1) / BK;
  #pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s * BK);
    cp_commit();
  }

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  float acc[2][4][4];
  #pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    #pragma unroll
    for (int nj = 0; nj < 4; ++nj)
      #pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

  // ldmatrix lane addressing: lane l names row (l % 8) of matrix (l / 8)
  const int lm = lane / 8, lr = lane % 8;
  const int a_row = lr + (lm % 2) * 8, a_col = (lm / 2) * 8;  // A: m0..m3 = (r0-7,k0-7), (r8-15,k0-7), (r0-7,k8-15), (r8-15,k8-15)
  const int b_row = lr + (lm % 2) * 8, b_col = (lm / 2) * 8;  // B^T: (k0-7,n), (k8-15,n), (k0-7,n+8), (k8-15,n+8)

  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt-1 is free
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk * BK);
    cp_commit();
    const bf16* as = smem + (kt % STAGES) * STAGE_ELEMS;
    const bf16* bs = as + BM * LDA;
    #pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
      #pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], smem_u32(as + (wm + mi * 16 + a_row) * LDA + kk + a_col));
      #pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        uint32_t t[4];
        ldmatrix_x4_trans(t, smem_u32(bs + (kk + b_row) * LDB + wn + nj * 8 + b_col));
        b[nj][0] = t[0];
        b[nj][1] = t[1];
        b[nj + 1][0] = t[2];
        b[nj + 1][1] = t[3];
      }
      #pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        #pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[mi][nj], a[mi], b[nj][0], b[nj][1]);
    }
  }
  cp_wait<0>();

  // accumulator (mma C layout): c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at
  // row g + 8, with g = lane / 4, t = lane % 4
  const int g = lane / 4, tq = lane % 4;
  #pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    #pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int col = n0 + wn + nj * 8 + tq * 2;
      if (col >= N) continue;
      const int row = r0 + wm + mi * 16 + g;
      if (row < r1)
        *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
            make_float2(acc[mi][nj][0], acc[mi][nj][1]);
      if (row + 8 < r1)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8) * N + col) =
            make_float2(acc[mi][nj][2], acc[mi][nj][3]);
    }
  }
}

}  // namespace

// xs [A, K] bf16, w [E, K, N] bf16, offs [E+1] int32 (device), out [A, N]
// f32.  Returns a cudaError_t (0 = launched).
extern "C" int moe_grouped_gemm(const void* xs, const void* w, const void* offs,
                                void* out, int A, int E, int K, int N,
                                void* stream) {
  if (A == 0 || N == 0) return 0;
  if (E <= 0 || K <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      moe_grouped_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((A + BM - 1) / BM + E, (N + BN - 1) / BN);
  moe_grouped_gemm_kernel<<<grid, NTHREADS, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(xs), static_cast<const bf16*>(w),
      static_cast<const int*>(offs), static_cast<float*>(out), A, E, K, N);
  return (int)cudaGetLastError();
}
