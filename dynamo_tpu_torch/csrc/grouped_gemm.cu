// MoE grouped GEMM, written by hand for Hopper (sm_90a): TMA tiles into an
// mbarrier ring, wgmma on them, gate||up fused with its bias and gated
// activation, and a fixed split-K for weights with few output tiles.
//
// The counterpart of `jax.lax.ragged_dot` (plus the bias and `moe_act`) in
// the JAX package's dropless MoE (`_moe_ragged`,
// dynamo_tpu/models/llama.py:336-383) and of its router einsum
// (`moe_router_logits`, :305-310).  Rows of `xs` are sorted by expert,
// expert e owns rows [offs[e], offs[e+1]), and each row is multiplied by
// its expert's weight:
//
//   moe_grouped_gemm: out[r, :] = xs[r, :] @ w[e] (+ b[e])          f32 out
//   moe_grouped_glu:  out[r, :] = act(xs[r] @ wg[e] + bg[e],
//                                     xs[r] @ wu[e] + bu[e])      bf16 out
//
// with act the JAX `moe_act` in f32 (silu(g) * u, or gpt-oss's clamped
// GLU: g <= 7, |u| <= 7, (u + 1) * g * sigmoid(1.702 g)) and one rounding
// to bf16 at the end, JAX's own order.  ragged_dot is an XLA op, not a
// Pallas kernel; the port writes it by hand because the decode steps run
// as CUDA graphs: the group offsets live on the device and the grid may
// not change with the routing.
//
// Shapes: xs [A, K] bf16 (row-major), w [E, K, N] bf16 (the JAX layout, N
// contiguous), offs [E+1] int32 on the device with offs[0] = 0,
// nondecreasing, offs[E] = A; biases [E, N] bf16 or null.  K and N are
// multiples of 8 (TMA strides are multiples of 16 bytes); every pointer
// is 16-byte aligned.
//
// WHAT BOUNDS IT: the expert weights.  At gpt-oss-20b's shapes (K = N =
// 2880) an expert's matrix is 16.6 MB; a decode step of 8 rows x top-4
// touches ~21 of 32 experts for 32 rows, about 2 flops per weight byte,
// and a 512-token chunk (2048 rows, ~64 an expert) about 128: both below
// the ~295 flops/byte where the H100's bf16 tensor cores, not HBM, would
// be the limit.  So every touched expert's weights should cross HBM once
// per call and untouched experts not at all.
//
// DESIGN:
//   - tiles by TMA.  A 2-D tensor map over xs and a 3-D one over w (dims
//     N, K, E), boxes of 64 x 64 bf16 (128-byte rows, 128-byte swizzle,
//     8 KB), built on the host for each call (they hold the pointers) and
//     passed as __grid_constant__ parameters.  One producer warp (one
//     thread) keeps a ring of STAGES stages in flight, each stage a K
//     slice of 64: the A tile (one box per 64 rows) and a 128-column B
//     tile of each weight (two boxes).  Rows and columns past A, N and K
//     come in as zeros from TMA; rows of the next expert inside the tile
//     are loaded and multiplied but never stored;
//   - wgmma.  Each consumer warpgroup issues wgmma.mma_async m64n128k16
//     bf16 -> f32 on its 64 rows, A from shared memory (K-major), B from
//     shared memory MN-major (the transpose bit: the weights are read in
//     their JAX layout, never re-laid out).  A stage is released to the
//     producer through its `empty` mbarrier once the products reading it
//     completed;
//   - one tile per expert at chunk sizes.  A tile is 64 rows (one
//     consumer warpgroup) at decode and 128 rows (two) where the rows per
//     expert reach ~64 (the wrapper picks by A and E), so each expert's
//     weights are streamed once per 128 rows, not once per 64;
//   - the grid (ceil(N/128), ceil(A/BM) + E, slices) is fixed by shapes:
//     expert e needs ceil(n_e/BM) row tiles and their sum is at most
//     ceil(A/BM) + E.  Warp 0 walks offs (a scan over the experts, 32 at
//     a time) to find the block's expert and rows; blocks past the last
//     tile exit.  The column tiles of one row tile are neighbours in
//     launch order, so the blocks in flight sweep whole rows of the same
//     experts' weights together (DRAM pages, the A tile in L2): 16-20%
//     faster at chunk sizes than row tiles first on an H100 SXM;
//   - gate||up fused (moe_grouped_glu): each block reads its A tile once
//     and keeps two accumulators for the same output columns, one from
//     wg[e], one from wu[e]; the epilogue adds the biases, applies the
//     activation in f32 and stores bf16 once.  The down product's
//     epilogue adds its bias in f32;
//   - split-K for few output tiles (the router: one group, N = 32): where
//     E * ceil(N/128) cannot fill the 132 SMs, K is cut into a fixed
//     number of slices (a function of the weight's shape only, never of
//     A), each slice's f32 partial goes to its own plane of a workspace,
//     and a second launch sums the planes in slice order, then the bias;
//   - batch invariance: every variant (64 or 128 rows, any row of a tile)
//     issues the same wgmma shape over the same K order, so a row's f32
//     sum does not depend on A or on its batch-mates; the split is fixed
//     by the weight's shape, so a split row's order is too.  No atomics.
//
// The C entry points return cudaGetLastError() right after their
// launches, or a negative value when a tensor map cannot be built.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BOX = 64;                   // a TMA box: 64 x 64 bf16, 128-byte rows
constexpr int BOX_BYTES = BOX * BOX * 2;  // 8 KB
constexpr int BN = 2 * BOX;               // output columns per tile
constexpr int BK = BOX;                   // contraction per stage
constexpr int STAGES = 4;                 // depth of the TMA ring
constexpr unsigned FULL_MASK = 0xffffffffu;

// WG consumer warpgroups (64 rows each), NW weights (1: gemm, 2: gate||up)
template <int WG, int NW>
struct Cfg {
  static constexpr int BM = 64 * WG;
  static constexpr int THREADS = 128 * WG + 32;  // + the producer warp
  // a stage: WG boxes of A, then two column boxes of each weight
  static constexpr int STAGE_BYTES = (WG + 2 * NW) * BOX_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA -----------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------
// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t gdesc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// keep the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
// d (64 x 128 f32) += A (smem, K-major) * B (smem, MN-major: transposed)
__device__ __forceinline__ void wg_ss_n128(float (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

// the JAX `moe_act` in f32: 0 silu(g) * u; 1 gpt-oss's clamped GLU
__device__ __forceinline__ float moe_act(int act, float g, float u) {
  if (act == 1) {
    g = fminf(g, 7.f);
    u = fminf(fmaxf(u, -7.f), 7.f);
    return (u + 1.f) * (g * (1.f / (1.f + expf(-1.702f * g))));
  }
  return g / (1.f + expf(-g)) * u;
}

// ---------------------------------------------------------------------------
// One block: BM rows of one expert x 128 columns, over one K slice.
// Warps 0 .. 4*WG-1 are the consumer warpgroups (warpgroup w holds rows
// 64w .. 64w+63 of the tile), warp 4*WG the producer.  Split (gridDim.z >
// 1): raw f32 partials into plane blockIdx.z of `part`; else the epilogue
// (bias, activation) into `out` (f32 for NW 1, bf16 for NW 2).
// ---------------------------------------------------------------------------
template <int WG, int NW>
__global__ void __launch_bounds__(Cfg<WG, NW>::THREADS, 1)
moe_grouped_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w0,
                   const __grid_constant__ CUtensorMap map_w1,
                   const bf16* __restrict__ bias0, const bf16* __restrict__ bias1,
                   const int* __restrict__ offs, void* __restrict__ out,
                   float* __restrict__ part, int A, int E, int K, int N,
                   int kt_per_slice, int act) {
  using C = Cfg<WG, NW>;
  constexpr int BM = C::BM;
  __shared__ __align__(8) uint64_t bars[2 * STAGES];  // full[s], then empty[s]
  __shared__ int tile[3];                             // expert (-1: none), row0, row1
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stages start on it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar0 = smem_u32(bars);
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (STAGES + s); };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (warp == 0) {
    // row tile t is expert e's tile t - first, where first counts the
    // tiles of the experts before e
    const int t = blockIdx.y;
    int before = 0, res_e = -1, res_r0 = 0, res_r1 = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      int lo = 0, hi = 0;
      if (e < E) {
        lo = offs[e];
        hi = offs[e + 1];
      }
      const int n = hi > lo ? (hi - lo + BM - 1) / BM : 0;
      int inc = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, inc, o);
        if (lane >= o) inc += v;
      }
      const int first = before + inc - n;
      const int row0 = lo + (t - first) * BM;
      const unsigned hit = __ballot_sync(FULL_MASK, n > 0 && t >= first && t < first + n);
      if (hit) {
        const int src = __ffs(hit) - 1;
        res_e = __shfl_sync(FULL_MASK, e, src);
        res_r0 = __shfl_sync(FULL_MASK, row0, src);
        res_r1 = __shfl_sync(FULL_MASK, min(row0 + BM, hi), src);
        break;
      }
      before += __shfl_sync(FULL_MASK, inc, 31);
    }
    if (lane == 0) {
      tile[0] = res_e;
      tile[1] = res_r0;
      tile[2] = res_r1;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);    // the producer's arrive, plus the bytes
      mbar_init(empty(s), WG);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  const int e = tile[0];
  if (e < 0) return;  // past the last tile (block-uniform)
  const int r0 = tile[1], r1 = tile[2];
  const int n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * kt_per_slice;
  const int kt1 = min(KT, kt0 + kt_per_slice);

  if (warp == 4 * WG) {  // the producer
    if (lane == 0) {
      // boxes wholly past the tile's rows or past N are not loaded: the
      // rows and columns they would fill are never stored
      const int nb_a = r1 > r0 + BOX ? WG : 1;
      const int nb_n = N > n0 + BOX ? 2 : 1;
      const uint32_t tx = (uint32_t)(nb_a + NW * nb_n) * BOX_BYTES;
      for (int kt = kt0; kt < kt1; ++kt) {
        const int i = kt - kt0, s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(full(s), tx);
        const uint32_t st = base + s * C::STAGE_BYTES;
        const int k0 = kt * BK;
        for (int a = 0; a < nb_a; ++a)
          tma_2d(st + a * BOX_BYTES, &map_x, full(s), k0, r0 + a * BOX);
        for (int w = 0; w < NW; ++w)
          for (int nb = 0; nb < nb_n; ++nb)
            tma_3d(st + (WG + 2 * w + nb) * BOX_BYTES, w ? &map_w1 : &map_w0, full(s),
                   n0 + nb * BOX, k0, e);
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies rows 64wg.. of the tile
  const int wg = warp >> 2;
  float acc0[16][4], acc1[NW == 2 ? 16 : 1][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc0[j][0] = acc0[j][1] = acc0[j][2] = acc0[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < (NW == 2 ? 16 : 1); ++j) acc1[j][0] = acc1[j][1] = acc1[j][2] = acc1[j][3] = 0.f;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0, s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);
    const uint32_t st = base + s * C::STAGE_BYTES;
    const uint32_t as = st + wg * BOX_BYTES;
    const uint32_t bs0 = st + WG * BOX_BYTES, bs1 = bs0 + 2 * BOX_BYTES;
    fence_acc(acc0);
    fence_acc(acc1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: 16 columns (32 bytes) along the swizzled rows, 8-row groups
      // 1024 bytes apart; B: 16 K rows (2048 bytes) down, its two 64-column
      // boxes BOX_BYTES apart
      const uint64_t da = gdesc(as + kk * 32, 16, 1024);
      wg_ss_n128(acc0, da, gdesc(bs0 + kk * 2048, BOX_BYTES, 1024));
      if constexpr (NW == 2) wg_ss_n128(acc1, da, gdesc(bs1 + kk * 2048, BOX_BYTES, 1024));
    }
    wg_commit();
    wg_wait0();
    fence_acc(acc0);
    fence_acc(acc1);
    if ((tid & 127) == 0) mbar_arrive(empty(s));  // the stage is free again
  }

  // accumulator (wgmma layout): acc[j][0..1] at row 16*(warp%4) + lane/4,
  // columns 8j + 2*(lane%4) + {0, 1}; acc[j][2..3] eight rows further
  const int row_a = r0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int col_a = n0 + 2 * (lane & 3);
  const bool split = gridDim.z > 1;
  const size_t brow = (size_t)e * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    if (row >= r1) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col_a + 8 * j;
      if (col >= N) continue;
      float v0 = acc0[j][2 * h], v1 = acc0[j][2 * h + 1];
      const size_t o = (size_t)row * N + col;
      if (split) {
        *reinterpret_cast<float2*>(part + (size_t)blockIdx.z * A * N + o) = make_float2(v0, v1);
        continue;
      }
      if (bias0 != nullptr) {
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias0 + brow + col));
        v0 += b.x;
        v1 += b.y;
      }
      if constexpr (NW == 1) {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
      } else {
        float u0 = acc1[j][2 * h], u1 = acc1[j][2 * h + 1];
        if (bias1 != nullptr) {
          const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias1 + brow + col));
          u0 += b.x;
          u1 += b.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o) =
            __floats2bfloat162_rn(moe_act(act, v0, u0), moe_act(act, v1, u1));
      }
    }
  }
}

// out = the sum of S partial planes [S, A, N] in slice order, then the
// row's expert's bias (largest e < E with offs[e] <= row)
__global__ void moe_split_reduce_kernel(const float* __restrict__ part,
                                        const bf16* __restrict__ bias,
                                        const int* __restrict__ offs,
                                        float* __restrict__ out, int A, int E, int N, int S) {
  const size_t plane = (size_t)A * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float v = part[i];
  for (int z = 1; z < S; ++z) v += part[(size_t)z * plane + i];
  if (bias != nullptr) {
    const int row = (int)(i / N);
    int lo = 0, hi = E - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (offs[mid] <= row) lo = mid; else hi = mid - 1;
    }
    v += __bfloat162float(bias[(size_t)lo * N + i % N]);
  }
  out[i] = v;
}

// ---- host side ---------------------------------------------------------------
// cuTensorMapEncodeTiled is a driver-API call: taken from the driver the
// CUDA runtime already loaded, so the library links nothing more
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a tensor map of `rank` dims (innermost first) over bf16 at p, boxes of
// 64 x 64 (x 1), 128-byte swizzle, zeros past the edges; 0 = built
int make_map(CUtensorMap* m, const void* p, int rank, const cuuint64_t* dims,
             const cuuint64_t* strides) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return -1;
  const cuuint32_t box[3] = {BOX, BOX, 1}, step[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(p), dims,
                         strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - (int)r;
}
int map_rows(CUtensorMap* m, const void* p, int rows, int cols) {  // [rows, cols]
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  return make_map(m, p, 2, dims, strides);
}
int map_experts(CUtensorMap* m, const void* p, int E, int K, int N) {  // [E, K, N]
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  return make_map(m, p, 3, dims, strides);
}

template <int WG, int NW>
int launch(const CUtensorMap& mx, const CUtensorMap& m0, const CUtensorMap& m1,
           const void* b0, const void* b1, const void* offs, void* out, float* part,
           int A, int E, int K, int N, int n_split, int act, cudaStream_t s) {
  using C = Cfg<WG, NW>;
  auto kern = moe_grouped_kernel<WG, NW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int KT = (K + BK - 1) / BK;
  const int per = (KT + n_split - 1) / n_split;
  dim3 grid((N + BN - 1) / BN, (A + C::BM - 1) / C::BM + E, n_split);
  kern<<<grid, C::THREADS, C::SMEM, s>>>(
      mx, m0, m1, static_cast<const bf16*>(b0), static_cast<const bf16*>(b1),
      static_cast<const int*>(offs), out, part, A, E, K, N, per, act);
  return (int)cudaGetLastError();
}

bool bad_shape(int A, int E, int K, int N, int bm) {
  return A < 0 || E <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || (bm != 64 && bm != 128);
}

}  // namespace

// xs [A, K] bf16, w [E, K, N] bf16, bias [E, N] bf16 or null, offs [E+1]
// int32 (device), out [A, N] f32; bm 64 or 128 rows a tile; n_split > 1
// sums K in that many slices through part [n_split, A, N] f32.  Returns
// a cudaError_t (0 = launched), or < 0 when a tensor map was refused.
extern "C" int moe_grouped_gemm(const void* xs, const void* w, const void* bias,
                                const void* offs, void* out, void* part, int A, int E,
                                int K, int N, int bm, int n_split, void* stream) {
  if (A == 0) return 0;
  if (bad_shape(A, E, K, N, bm) || n_split < 1 || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap mx, mw;
  int err = map_rows(&mx, xs, A, K);
  if (err == 0) err = map_experts(&mw, w, E, K, N);
  if (err != 0) return err;
  float* p = n_split > 1 ? static_cast<float*>(part) : nullptr;
  const void* b = n_split > 1 ? nullptr : bias;
  err = bm == 128 ? launch<2, 1>(mx, mw, mw, b, nullptr, offs, out, p, A, E, K, N, n_split, 0, s)
                  : launch<1, 1>(mx, mw, mw, b, nullptr, offs, out, p, A, E, K, N, n_split, 0, s);
  if (err != 0 || n_split == 1) return err;
  const size_t n = (size_t)A * N;
  moe_split_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      p, static_cast<const bf16*>(bias), static_cast<const int*>(offs),
      static_cast<float*>(out), A, E, N, n_split);
  return (int)cudaGetLastError();
}

// xs [A, K] bf16, w_gate / w_up [E, K, N] bf16, b_gate / b_up [E, N] bf16
// or null, offs [E+1] int32 (device), out [A, N] bf16 = act(gate, up);
// act 0 silu, 1 gpt-oss's clamped GLU.  Returns as moe_grouped_gemm.
extern "C" int moe_grouped_glu(const void* xs, const void* w_gate, const void* w_up,
                               const void* b_gate, const void* b_up, const void* offs,
                               void* out, int A, int E, int K, int N, int bm, int act,
                               void* stream) {
  if (A == 0) return 0;
  if (bad_shape(A, E, K, N, bm) || (act != 0 && act != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap mx, mg, mu;
  int err = map_rows(&mx, xs, A, K);
  if (err == 0) err = map_experts(&mg, w_gate, E, K, N);
  if (err == 0) err = map_experts(&mu, w_up, E, K, N);
  if (err != 0) return err;
  return bm == 128
             ? launch<2, 2>(mx, mg, mu, b_gate, b_up, offs, out, nullptr, A, E, K, N, 1, act, s)
             : launch<1, 2>(mx, mg, mu, b_gate, b_up, offs, out, nullptr, A, E, K, N, 1, act, s);
}
