// Segment attention for the vision towers, written by hand for Hopper
// (sm_90a): the products on the tensor cores in TF32, three passes each
// ("3xTF32"), so the result keeps f32 accuracy.
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
// [L, nh, hd] float32; scores q.k * hd^-0.5, an online softmax (running
// max m, denominator l, accumulator O) over the segment's keys, all in
// f32.
//
// What bounds it: the products.  A segment of n patches costs 4 n^2 hd
// flops a head, so a Qwen2.5-VL full layer over one 1288x728 image (4784
// patches, 16 heads of 80) is 117 GFLOP against 98 MB of q, k, v and
// out.  As f32 FMAs on the CUDA cores (the first version of this kernel)
// that is 1.75 ms at 67 TFLOP/s; on the tensor cores in TF32 (495
// TFLOP/s) three passes take 0.71 ms.  The windowed layers (segments of
// at most 64 patches, 28 of the tower's 32) need 1/75 of those products
// and sit near the bytes bound (29 us).  A 64-row query tile re-reads its
// segment's K and V from L2 (75 times over for the full layer's 4784
// patches), so the copies must read whole 32-byte sectors.
//
// How three TF32 passes keep f32 accuracy.  TF32 keeps 10 of f32's 23
// mantissa bits: one pass a product leaves output rows ~2e-3 from f32,
// twenty times the 1e-4 the port holds.  Each f32 operand x is split into
// a TF32 hi and lo = tf32(x - hi) (x - hi is exact in f32), and each
// product A.B becomes lo.hi + hi.lo + hi.hi, issued in that order into
// one f32 accumulator (small terms first).  What is dropped, lo.lo and
// lo's own rounding, is ~2^-21 of each product: the output rows stay
// ~3e-6 from the JAX form (tests/test_torch_segment_tf32.py emulates this
// arithmetic on the CPU).  Q (scaled by hd^-0.5 * log2(e) first: scores
// in log2 units, exp2), P and V take hi rounded to nearest (what
// cvt.rna.tf32.f32 computes, here in two integer operations).  K is used
// as it lands: the tensor cores read the top 19 bits of an f32 operand,
// so the raw K is its own truncated hi and only lo = tf32(x - trunc(x))
// is written, which saves a store per element of every key tile (were
// the low bits rounded instead, S would be off by a TF32 rounding, as in
// one pass, and every case of chip_smoke.py phase 3 would miss its 1e-4:
// they hold).
//
// The design:
//   - each block owns one entry of the tile table: up to 64 query rows
//     [q0, q1) of one segment [k0, k1), for one head (grid n_tiles x nh).
//     Query tiles never straddle segments, so masked-out scores are never
//     computed;
//   - two warpgroups, specialized: the producer copies each key tile
//     (cp.async), writes K's lo and transposes V into V^T hi and lo; the
//     consumer runs the products and the softmax.  Two buffers of each
//     operand and named barriers (full / empty per buffer) let the
//     producer prepare tile i + 1 while the consumer computes tile i;
//   - S = Q.K^T as wgmma m64n{NK}k8 .tf32 with Q and K from shared memory
//     (NK keys a tile: 64 for hd <= 80, 32 above, for shared memory).  Q
//     and K use the 64-byte swizzled K-major layout (atoms of 16 floats:
//     five a row at hd 80, which the 128-byte atoms do not tile), so rows
//     copied as consecutive 16-byte chunks, read coalesced, land without
//     bank conflicts;
//   - TF32 wgmma reads both operands K-major only (the transpose bit is
//     for 16-bit types), so for O = P.V the B operand is V^T [hd x keys],
//     keys contiguous, in the interleaved layout (8 rows x 16 bytes a core
//     matrix of 128 contiguous bytes, which the producer's transposed
//     16-byte stores fill without conflicts).  No pass over V in global
//     memory: the windowed layers are bound by its bytes;
//   - P = softmax(S) stays in the accumulator registers and is the A
//     operand of P.V (the register form).  A thread holds keys 2t and
//     2t + 1 of its rows where TF32's A fragment wants columns t and
//     t + 4, so the keys of each 8-key group are permuted in V^T instead
//     (column t holds key 2t, column t + 4 key 2t + 1: `col_key`): P's
//     hi and lo go from the accumulators to the A registers as they lie;
//   - each tile's P.V goes to a fresh accumulator, added to O on the CUDA
//     cores (O = O * corr + P.V, f32 rounding to nearest): the tensor
//     cores' own f32 accumulation drifts one way, to near the 1e-4
//     tolerance over the 1800 k-steps of a 4784-key segment, so they sum
//     only one tile's 24;
//   - partial tiles: keys past the segment are zero-filled by cp.async (V
//     rows of zeros, never stale shared memory: NaN * 0 is NaN) and their
//     scores set to -inf before the row max; query rows past q1 are
//     computed and not stored;
//   - the online softmax on the accumulator layout: a thread holds rows
//     r and r + 8 of its warp's 16, a quad shares a row (max and sum over
//     two xor shuffles), O and l rescaled in f32 as in the prefill kernel
//     of csrc/paged_attention.cu.
// hd may be any multiple of 16 up to 128 (80 for the Qwen towers, 64 for
// CLIP ViT-L, 16 for the golden LLaVA anchor).
//
// The C entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BQ = 64;          // query rows per block (TILE_ROWS in the wrapper)
constexpr int WG = 128;         // threads of a warpgroup
constexpr int NTHREADS = 2 * WG;  // a consumer and a producer warpgroup
// named barriers (0 is __syncthreads): buffer b full / empty, the producer's own
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PRODUCER = 5;

// Shared memory of one block, per head dim: Q hi and lo; two buffers of
// K (raw, its own hi), K lo, V^T hi and V^T lo; the raw V the producer
// transposes.
template <int HD>
struct Smem {
  static constexpr int NK = HD <= 80 ? 64 : 32;  // keys a tile
  // raw V rows padded to 16 floats mod 32: the transpose reads one column
  // of two keys at once without bank conflicts
  static constexpr int VRS = HD % 32 == 16 ? HD : HD + 16;
  static constexpr int Q_BYTES = BQ * HD * 4, K_BYTES = NK * HD * 4,
                       VR_BYTES = NK * VRS * 4;
  static constexpr int QHI = 0, QLO = Q_BYTES, KHI = 2 * Q_BYTES,
                       KLO = KHI + 2 * K_BYTES, VTHI = KLO + 2 * K_BYTES,
                       VTLO = VTHI + 2 * K_BYTES, VRAW = VTLO + 2 * K_BYTES,
                       BYTES = VRAW + VR_BYTES + 1024;  // + the 1024-byte alignment
  static_assert(BYTES <= 232448, "shared memory of one block");
};

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
// generic-proxy writes to shared memory -> wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// 2^x on the special-function unit (0 for -inf)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// f32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 computes for finite x, in two integer
// operations
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}
// x = hi + lo to ~2^-22 of x, both TF32 values
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}
// the lo of an f32 x whose hi is x itself as the tensor cores read it:
// its top 19 bits (x - trunc(x) is exact)
__device__ __forceinline__ float lo_of(float x) {
  return tf32_rna(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u));
}
__device__ __forceinline__ void split4(float4& x, float4& lo) {
  split(x.x, x.x, lo.x);
  split(x.y, x.y, lo.y);
  split(x.z, x.z, lo.z);
  split(x.w, x.w, lo.w);
}

// Byte offset of 16-byte chunk c of row r in a K-major operand tile of
// c4 chunks a row, in the interleaved layout: 8 rows x 16 bytes make a
// core matrix of 128 contiguous bytes; a row group's core matrices follow
// each other along K (LBO 128), row groups lie c4 * 128 bytes apart (SBO).
__device__ __forceinline__ uint32_t kmaj_off(int r, int c, int c4) {
  return (uint32_t)((r >> 3) * (c4 * 128) + c * 128 + (r & 7) * 16);
}
// Byte offset of 16-byte chunk c of row r in a K-major tile of `rows` rows
// in the 64-byte swizzled layout: atoms of 16 floats along K, each `rows`
// x 64 bytes, chunk c & 3 of row r stored at (c & 3) ^ ((r >> 1) & 3)
// (the hardware's Swizzle<2,4,3> of the byte address; atoms 512-byte
// aligned).  Rows of 16-byte chunks copied in order then land without
// bank conflicts, and the tensor cores read it without any.
__device__ __forceinline__ uint32_t sw64_off(int r, int c, int rows) {
  return (uint32_t)((c >> 2) * (rows * 64) + r * 64 + (((c & 3) ^ ((r >> 1) & 3)) << 4));
}
// The key (in its tile) held by column c of V^T: in each 8-key group
// column t holds key 2t and column t + 4 key 2t + 1, the order in which a
// thread of S's accumulator holds its keys' probabilities
__device__ __forceinline__ int col_key(int c) {
  return (c & ~7) | ((c & 3) << 1) | ((c >> 2) & 1);
}

// ---- wgmma (sm_90a), TF32 ---------------------------------------------
// Shared-memory matrix descriptor, interleaved layout (type 0, no
// swizzle): start address, leading byte offset (between the core matrices
// of a k-step) and stride byte offset (between 8-row groups), 16-byte units.
__device__ __forceinline__ uint64_t idesc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}
// the same for the 64-byte swizzled K-major layout (type 2, B64): the
// 8-row groups of an atom lie 512 bytes apart (SBO); the leading offset
// is unused within an atom (a k-step's 32 bytes never cross one)
__device__ __forceinline__ uint64_t sdesc64(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// keep the compiler from moving accesses of wgmma operands across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
// d (64 x 32 f32) (+)= A (smem) * B (smem), both K-major TF32
__device__ __forceinline__ void wg_ss(float (&d)[4][4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (64 x 64 f32) (+)= A (smem) * B (smem), both K-major TF32
__device__ __forceinline__ void wg_ss(float (&d)[8][4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (64 x 16 f32) (+)= A (registers) * B (smem, K-major), TF32
__device__ __forceinline__ void wg_rs(float (&d)[2][4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}
// d (64 x 32 f32) (+)= A (registers) * B (smem, K-major), TF32
__device__ __forceinline__ void wg_rs(float (&d)[4][4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}
// d (64 x 48 f32) (+)= A (registers) * B (smem, K-major), TF32
__device__ __forceinline__ void wg_rs(float (&d)[6][4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}
// d (64 x 64 f32) (+)= A (registers) * B (smem, K-major), TF32
__device__ __forceinline__ void wg_rs(float (&d)[8][4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}
// d (64 x 80 f32) (+)= A (registers) * B (smem, K-major), TF32
__device__ __forceinline__ void wg_rs(float (&d)[10][4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}
// d (64 x 96 f32) (+)= A (registers) * B (smem, K-major), TF32
__device__ __forceinline__ void wg_rs(float (&d)[12][4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}
// d (64 x 112 f32) (+)= A (registers) * B (smem, K-major), TF32
__device__ __forceinline__ void wg_rs(float (&d)[14][4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}
// d (64 x 128 f32) (+)= A (registers) * B (smem, K-major), TF32
__device__ __forceinline__ void wg_rs(float (&d)[16][4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// grid (n_tiles, nh), NTHREADS threads: warpgroup 0 consumes, warpgroup 1
// produces.  tiles [n_tiles, 4] int32: the tile's query rows [q0, q1) and
// its segment's keys [k0, k1).  Dynamic shared memory: Smem<HD>.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
segment_attention_kernel(const float* __restrict__ q,  // [L, nh, HD]
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ tiles,
                         float* __restrict__ out,  // [L, nh, HD]
                         int n_tok, int nh, float scale_log2) {
  using SM = Smem<HD>;
  constexpr int NK = SM::NK;
  constexpr int C4 = HD / 4;     // 16-byte chunks of a row
  constexpr int NT_S = NK / 8;   // S's n-tiles (8 keys each), P.V's k-steps
  constexpr int NT_O = HD / 8;   // O's n-tiles (8 dims each), S's k-steps
  constexpr uint32_t SBO_VT = NK * 32;  // V^T's 8-row groups: NK / 4 core matrices
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // 1024-byte aligned: the swizzle atoms of Q and K
  unsigned char* smem = smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw));
  const uint32_t sb = smem_u32(smem);
  const float NEG_INF = __int_as_float(0xff800000);

  const int head = blockIdx.y;
  const int4 tl = reinterpret_cast<const int4*>(tiles)[blockIdx.x];
  const int q0 = tl.x, q1 = tl.y, k0 = tl.z, k1 = min(tl.w, n_tok);
  const size_t tok = (size_t)nh * HD;  // elements between tokens
  const int n_tiles = (k1 - k0 + NK - 1) / NK;

  if (threadIdx.x >= WG) {
    // ---- producer: loads, splits and transposes tile it into buffer it & 1
    const int tid = threadIdx.x - WG;
    const float* kh = k + (size_t)head * HD;
    const float* vh = v + (size_t)head * HD;
    // copies of a tile: chunk i is 16-byte chunk i % C4 of row i / C4, so
    // consecutive threads read consecutive 16 bytes of a row
#pragma unroll
    for (int n = 0; n < BQ * C4 / WG; ++n) {  // the Q tile (rows past q1 zero-filled)
      const int i = tid + n * WG, r = i / C4, c = i % C4;
      const bool ok = q0 + r < q1;
      cp_async16(sb + SM::QHI + sw64_off(r, c, BQ),
                 q + (size_t)(ok ? q0 + r : q0) * tok + (size_t)head * HD + 4 * c, ok);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int b = it & 1, t0 = k0 + it * NK;
      if (it >= 2) bar_sync(BAR_EMPTY + b, 2 * WG);  // the consumer is done with buffer b
      bar_sync(BAR_PRODUCER, WG);  // every producer thread is done with raw V
      // K (K-major, into K hi of buffer b) and raw V; keys past the
      // segment are zero-filled (and masked)
#pragma unroll
      for (int n = 0; n < NK * C4 / WG; ++n) {
        const int i = tid + n * WG, r = i / C4, c = i % C4;
        const bool ok = t0 + r < k1;
        const size_t off = (size_t)(ok ? t0 + r : k0) * tok + 4 * c;
        cp_async16(sb + SM::KHI + b * SM::K_BYTES + sw64_off(r, c, NK), kh + off, ok);
        cp_async16(sb + SM::VRAW + (r * SM::VRS + 4 * c) * 4, vh + off, ok);
      }
      cp_commit();
      cp_wait<0>();
      bar_sync(BAR_PRODUCER, WG);  // every copy landed
      if (it == 0) {  // Q, scaled, split into hi (in place) and lo
        float4* hi = reinterpret_cast<float4*>(smem + SM::QHI);
        float4* lo = reinterpret_cast<float4*>(smem + SM::QLO);
#pragma unroll
        for (int n = 0; n < BQ * C4 / WG; ++n) {
          const int i = tid + n * WG;
          float4 x = hi[i], y;
          x.x *= scale_log2, x.y *= scale_log2, x.z *= scale_log2, x.w *= scale_log2;
          split4(x, y);
          hi[i] = x;
          lo[i] = y;
        }
      }
      {  // K lo = x - trunc(x); the raw K serves as its own hi (see the head)
        const float4* hi = reinterpret_cast<const float4*>(smem + SM::KHI + b * SM::K_BYTES);
        float4* lo = reinterpret_cast<float4*>(smem + SM::KLO + b * SM::K_BYTES);
#pragma unroll
        for (int n = 0; n < NK * C4 / WG; ++n) {
          const int i = tid + n * WG;
          const float4 x = hi[i];
          lo[i] = make_float4(lo_of(x.x), lo_of(x.y), lo_of(x.z), lo_of(x.w));
        }
      }
      {  // raw V -> V^T hi and lo of buffer b: row d of V^T, columns
         // 4c..4c+3 per job (8 consecutive threads write 8 rows of one
         // core matrix)
        const float* vr = reinterpret_cast<const float*>(smem + SM::VRAW);
#pragma unroll
        for (int n = 0; n < HD * NK / 4 / WG; ++n) {
          const int j = tid + n * WG, d = j % HD, c = j / HD;
          float hi[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = col_key(4 * c + i);
            split(vr[key * SM::VRS + d], hi[i], lo[i]);
          }
          const uint32_t o = b * SM::K_BYTES + kmaj_off(d, c, NK / 4);
          *reinterpret_cast<float4*>(smem + SM::VTHI + o) = make_float4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<float4*>(smem + SM::VTLO + o) = make_float4(lo[0], lo[1], lo[2], lo[3]);
        }
      }
      fence_async_smem();
      bar_arrive(BAR_FULL + b, 2 * WG);  // buffer b holds tile it
    }
    return;
  }

  // ---- consumer: S, the softmax and P.V of tile it from buffer it & 1
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Accumulators in the wgmma layout: s[j] / ot[j] hold rows g and g + 8
  // of the warp's 16, keys / dims 8j + 2t + {0, 1}.  After the softmax s
  // holds P's hi and pl its lo; ot is the tile's P.V, o the running O in
  // the same layout.
  const int g = lane >> 2, t4 = lane & 3;
  float s[NT_S][4], pl[NT_S][4], ot[NT_O][4], o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // one pass of S = Q.K^T (A and B from shared memory, 64-byte swizzled)
  auto issue_s_pass = [&](uint32_t a, uint32_t b, bool first) {
#pragma unroll
    for (int kk = 0; kk < NT_O; ++kk) {  // 8 dims a k-step, 2 k-steps an atom
      const uint32_t in_atom = (kk & 1) * 32;
      wg_ss(s, sdesc64(a + (kk >> 1) * (BQ * 64) + in_atom),
            sdesc64(b + (kk >> 1) * (NK * 64) + in_atom), first && kk == 0 ? 0 : 1);
    }
  };
  // one pass of ot (+)= P.V (P from registers, V^T from shared memory);
  // A's fragment of a k-step is {row g: column t, row g+8: column t, row
  // g: column t+4, row g+8: column t+4}, which col_key maps to the keys
  // the thread holds
  auto issue_pv_pass = [&](const float (&a)[NT_S][4], uint32_t b, bool first) {
#pragma unroll
    for (int kk = 0; kk < NT_S; ++kk)
      wg_rs(ot, __float_as_uint(a[kk][0]), __float_as_uint(a[kk][2]),
            __float_as_uint(a[kk][1]), __float_as_uint(a[kk][3]),
            idesc(b + kk * 256, 128, SBO_VT), first && kk == 0 ? 0 : 1);
  };

  for (int it = 0; it < n_tiles; ++it) {
    const int b = it & 1;
    const uint32_t khi = sb + SM::KHI + b * SM::K_BYTES, klo = sb + SM::KLO + b * SM::K_BYTES;
    const uint32_t vthi = sb + SM::VTHI + b * SM::K_BYTES, vtlo = sb + SM::VTLO + b * SM::K_BYTES;
    bar_sync(BAR_FULL + b, 2 * WG);  // the producer filled buffer b
    // S of this tile, small terms first
    fence_regs(s);
    wg_fence();
    issue_s_pass(sb + SM::QLO, khi, true);
    issue_s_pass(sb + SM::QHI, klo, false);
    issue_s_pass(sb + SM::QHI, khi, false);
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // the online softmax: every tile holds at least one key of the
    // segment, so each row's new maximum is finite
    const int n_valid = k1 - (k0 + it * NK);
    float mt[2] = {NEG_INF, NEG_INF}, corr[2];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (8 * j + 2 * t4 + (e & 1) >= n_valid) s[j][e] = NEG_INF;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 threads of a quad share a row
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL, mt[r], 2));
      const float mn = fmaxf(m[r], mt[r]);
      corr[r] = fast_exp2(m[r] - mn);  // 0 on the first tile
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[j][e] - m[e >> 1]);  // masked: 0
        l[e >> 1] += p;
        split(p, s[j][e], pl[j][e]);
      }
    // P.V of this tile into a fresh accumulator
    fence_regs(ot);
    fence_regs(s);
    fence_regs(pl);
    wg_fence();
    issue_pv_pass(pl, vthi, true);
    issue_pv_pass(s, vtlo, false);
    issue_pv_pass(s, vthi, false);
    wg_commit();
    wg_wait0();
    fence_regs(ot);
    fence_regs(s);
    fence_regs(pl);
    if (it + 2 < n_tiles) bar_arrive(BAR_EMPTY + b, 2 * WG);  // buffer b is free
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] = fmaf(o[n][0], corr[0], ot[n][0]);
      o[n][1] = fmaf(o[n][1], corr[0], ot[n][1]);
      o[n][2] = fmaf(o[n][2], corr[1], ot[n][2]);
      o[n][3] = fmaf(o[n][3], corr[1], ot[n][3]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= q1) continue;
    const float inv = 1.f / l[r];
    float* op = out + (size_t)row * tok + (size_t)head * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<float2*>(op + 8 * n) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* tiles,
           void* out, int n_tiles, int n_tok, int nh, float scale,
           cudaStream_t stream) {
  constexpr int bytes = Smem<HD>::BYTES;
  auto kern = segment_attention_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
