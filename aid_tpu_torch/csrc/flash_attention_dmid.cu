// Flash interpolated attention, bf16 and f16, head dims 161-512 in the four endpoint modes and in self
// mode, sm_90a.
//
// Replaces the endpoint-mode and self-mode contracts of the Pallas TPU
// kernels behind aid_tpu/ops/flash_attention.py::flash_interpolated_attention
// at head dims 161-512 (self mode at D = 512 exactly stays on the VAE's D=512
// self kernels, flash_attention_bf16_d512.cu): the streaming `_kernel` (flash_attention.py:101) and the
// whole-stream-resident `_kernel_onepass` (flash_attention.py:339), which the
// JAX wrapper runs there at D padded to the next multiple of 128. On the
// model's path that is an SD 1.x UNet whose `attention_head_dim` list is read
// as head counts ([1, 2, 4, 4]: 320-wide heads at every level). Per batch
// row b (flash_interpolated_attention.cu's header):
//   fused_outer  (1-c_b) Attn(q, [k_b; K_begin]) + c_b Attn(q, [k_b; K_end])
//   pure_outer   (1-c_b) Attn(q, K_begin)        + c_b Attn(q, K_end)
//   fused_inner  Attn(q, [k_b; K_cross]),  K_cross = lerp(K_begin, K_end, c_b)
//   pure_inner   Attn(q, K_cross)
//   self         Attn(q, [k_b])
// with K_cross / V_cross lerped in f32 by the wrapper and passed in the begin
// slot, and a skip row (fused modes) attending its own K/V alone. Self mode
// is the instance with no endpoint set (NSETS = 0): its key stream is the own
// segment alone, as on a skip row, with no endpoint map, no park and no
// workspace (the uncond pass of a UNet with 161-512-wide heads, its 77-key
// cross calls, and the late steps of `interpolate`).
//
// What bounds it on the card: at (7,1,4096,320) fused_outer a call is ~365
// GFLOP against ~80 MB of operands, so the tensor cores bind (0.369 ms at
// 989 TFLOP/s). What stands between a design and that rate here:
//   * the head dim. The kernel works at the caller's D rounded up to its
//     64-column chunk (NC chunks, 3..8): the tensor maps run over the caller's
//     tensors with dim 0 of extent D, so a chunk's columns past D come in as
//     zeros (TMA's fill), and no padded copy is made. D = 320 is five chunks,
//     not the eight a padding to 512 computed;
//   * per-tile fixed costs (ring hand-offs, barriers, an exchange of partial
//     scores between warpgroups that split D), which dominated the padded
//     design once its products were fast;
//   * the bytes each block pulls from L2 per key: K and V tiles are shared by
//     all the query rows of a block, so a block wants as many rows as its
//     registers hold.
// Two layouts answer it, one template each, both with a producer warpgroup
// (one thread issues every TMA copy; setmaxnreg 24, the consumers 240) and
// K and V rings of their own (a K slot frees once its tile's Q K^T is done,
// a V slot once its P V is):
//   * the rows layout, NC = 3..5 (D <= 320): 64 query rows x D f32 is at most
//     160 registers a thread, so one consumer warpgroup owns its 64 rows over
//     the whole of D and computes its own scores: no exchange. Two such
//     warpgroups share a block (128 rows over each K/V tile) where the grid of
//     64-row blocks would be over one wave of the 132 SMs, else one (a block
//     of 64 rows, so small grids still spread over the card). S = Q K^T is
//     wgmma m64nBKk16 with Q and K K-major in shared memory, O += P V is
//     m64n(64 NC)k16 with P from the S registers and V through the transpose
//     bit. Key tiles are as large as shared memory allows beside the resident
//     Q tiles with two slots in each ring: 64 keys at NC = 3 and 4 (three and
//     two slots), 48 at NC = 5 (two slots of 30 KB each for K and V beside 80
//     KB of Q: 64-key tiles would leave one slot each, and each tile would
//     wait for its loads). The two warpgroups take turns on named barriers:
//     each issues this tile's P V and the next tile's Q K^T in its turn and
//     hands the turn over, so one warpgroup's softmax runs beside the other's
//     products;
//   * the split layout, NC = 6..8 (D 321-512, 7 chunks run as 8): 64 x D f32
//     no longer fits one warpgroup, so two consumer warpgroups split D (3 or 4
//     chunks each), compute partial scores over their columns, exchange them
//     through shared memory at a named barrier and run the same online
//     softmax (flash_attention_bf16_d512.cu's self design: 32-key tiles, the
//     exchange double-buffered, a tile's Q K^T issued before the previous
//     tile's P V within a warpgroup);
//   * the key stream is a list of segments: the own K/V (fused modes), then
//     K_begin / V_begin and, in the outer modes, K_end / V_end, each of its
//     own length and tensor map (a shared (H, Le, D) endpoint: batch extent
//     1). A segment's last tile masks its keys past the length;
//   * the outer modes need two softmax sets. The own segment's state (O, max,
//     sum) is computed once; the begin segment continues it to (1 - c) O / l,
//     which is swapped with the own state, and the end segment continues that
//     to c O / l. A second 64 x D f32 set has room neither in registers nor in
//     shared memory beside the Q tile and the rings, so the own state is
//     parked in a global f32 workspace the wrapper allocates per call at the
//     caller's chunk count (32 NC + 4 words a thread, word i of every thread
//     side by side so a warp writes one 128-byte line a word; it stays in
//     L2). Nothing is in flight while a state is parked or swapped;
//   * the output leaves through each warpgroup's part of the Q tile (its
//     products are done) and a TMA store, clipped at Sq and at D.
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled, taken
// through cudaGetDriverEntryPoint (tma_sm90.cuh; no -lcuda at link time), and
// passed as __grid_constant__ parameters, kept in a small cache keyed by
// everything they encode (map_cache.cuh). Measured times, bounds and the
// ablation (tools/dmid_ablation.py) are in PERF.md.
//
// One design, two element types (elem16.cuh): T = __nv_bfloat16 is
// aid_flash_attn_bf16_dmid, T = __half is aid_flash_attn_f16_dmid (an f16
// UNet). They differ in the wgmma type suffix, the tensor maps' data type and
// the rounding of P and of the output; every mask and running max stays on
// the f32 scores.
//
// The static-shift softmax (`static_smax`, the static branch of `_kernel` at
// flash_attention.py:210-256) is this body built with AID_STATIC_SHIFT = 1 by
// flash_attention_dmid_static.cu, a translation unit of its own, bf16 only
// (entry aid_flash_attn_bf16_dmid_static, both layouts, every mode and self
// mode; in f16, exp(-40) is below the smallest subnormal). Each tile's P is
// ex2(min(s * scale_log2 - shift_log2, clip_log2)), the shift C and the
// 30-nat clip in log2 units after the scale: no row max, no quad max, no
// rescale of O and l. Each softmax set's P V and sum just add up, so the
// outer modes' park keeps O and l and no max (the workspace's layout is the
// exact instances'; the max words go unused), and the own segment's state is
// added to both sets unchanged, as the JAX branch's w0 / w1 weights do. Each
// row's sum is guarded (max(l, 1e-37)) as the JAX kernels' denominator is. In
// the split layout the static softmax leaves P in f32, packed into P V's A
// registers once the previous P V is done, before the next tile's Q K^T is
// issued (take_p): packed in the softmax, beside that P V in flight, P took
// its A registers and ptxas serialised every wgmma (C7513).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#ifndef AID_STATIC_SHIFT
#define AID_STATIC_SHIFT 0
#endif

namespace {
#if AID_STATIC_SHIFT
namespace static_shift {  // kernel names of their own beside the exact instances' in one library
#endif

#include "elem16.cuh"
#include "tma_sm90.cuh"
#include "map_cache.cuh"

constexpr bool kStatic = AID_STATIC_SHIFT != 0;

constexpr int kThreads = 384;        // two consumer warpgroups and the producer warpgroup
constexpr int kSmemLimit = 232448;   // the 227 KB a block can use
constexpr int kOneWave = 132;        // the H100's SMs: the rows layout doubles its blocks' rows past one wave
constexpr bool kTurns = true;        // the rows layout's warpgroups take turns to issue their products
constexpr int kMaxStages = 4;

// The rows layout at NC 64-column chunks: each consumer warpgroup owns 64
// query rows over all of D (tests/test_torch_dmid.py reads these constants)
template <int NC>
struct Rows {
  static constexpr int kBK = NC == 5 ? 48 : 64;         // keys per K/V tile
  static constexpr int kQBytes = NC * 64 * 128;         // one warpgroup's 64 query rows
  static constexpr int kBoxBytes = kBK * 128;           // one 64-column box of a K/V tile
  static constexpr int kTileBytes = NC * kBoxBytes;     // one K (or V) tile
  static constexpr int kFit = (kSmemLimit - 1024 - 2 * kQBytes - 8 * (4 * kMaxStages + 2)) / (2 * kTileBytes);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;   // slots in each of the K and V rings
  static constexpr int kSmem = 1024 + 2 * kQBytes + 2 * kStages * kTileBytes + 8 * (4 * kStages + 2);
  static constexpr int kParkWords = 32 * NC + 4;        // a consumer thread's parked state: O, m[2], l[2]
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "two slots a ring beside the Q tiles");
};

// The split layout at 2 NCW 64-column chunks: two consumer warpgroups split
// D, NCW chunks each, over 64 query rows
template <int NCW>
struct Split {
  static constexpr int kBK = 32;                         // keys per K/V tile
  static constexpr int kBoxes = 2 * NCW;
  static constexpr int kCols = 64 * NCW;                 // output columns per warpgroup
  static constexpr int kQBytes = kBoxes * 64 * 128;
  static constexpr int kBoxBytes = kBK * 128;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kXBytes = 2 * 2 * 16 * 128 * 4;   // the score exchange, double-buffered
  static constexpr int kFit = (kSmemLimit - 1024 - kQBytes - kXBytes - 8 * (4 * kMaxStages + 1)) / (2 * kTileBytes);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes + kXBytes + 8 * (4 * kStages + 1);
  static constexpr int kParkWords = kCols / 2 + 4;
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "two slots a ring beside the Q tile");
};

struct Params {
  const float* coef;    // (B,) f32, read by the outer modes
  const uint8_t* skip;  // (B,) bool or null, read by the fused modes
  float* work;          // the outer modes' parked states: (row tiles, kParkWords, threads) f32
  int Sq, Lk, Le;
  int nwg;              // rows layout: consumer warpgroups a block (1 or 2); split layout: 2
  int shared_eps;       // bit i: endpoint map i (k_begin, v_begin, k_end, v_end) is one (H, Le, D) tensor
  float scale_log2;     // softmax scale * log2(e)
  float shift_log2, clip_log2;  // the static shift C and the clip, * log2(e) (kStatic instances only)
};

// A row's sum: the thread's partial sums reduced over the quad; at the
// static shift guarded, so a row whose every key underflowed gives 0
__device__ __forceinline__ float row_sum(float l) {
  if constexpr (kStatic) return fmaxf(quad_sum(l), 1e-37f);
  return quad_sum(l);
}

// wgmma descriptor of a 128-byte-swizzled tile (8-row groups 1024 bytes
// apart, SBO): K-major operands (Q, K) step along K by moving the start 32
// bytes within a row; the MN-major V steps to its next 64 columns by LBO
// (one box of the tile) and along K (keys) by whole 8-row groups.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads (accumulators) or reuses
// (P, read asynchronously by wgmma) across the wait before it
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The static shift's P of one score: 2^min(s scale_log2 - shift_log2, clip_log2)
// (a masked key stays -inf and gives 0); a template, so the exact build, which
// never calls it, compiles it away without a word
template <class P>
__device__ __forceinline__ float static_p(float s, const P& p) {
  return ex2(fminf(fmaf(s, p.scale_log2, -p.shift_log2), p.clip_log2));
}

// One box from shared memory into a (D, H, S, B) map; parts out of bounds are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}

// S(64 x 32, f32) (+)= A(64 x 16) B(16 x 32): both K-major in shared memory (128-byte swizzle)
template <class T>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])  \
      : "l"(da), "l"(db), "r"(scale_d))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// S(64 x 48, f32) (+)= A(64 x 16) B(16 x 48): both K-major in shared memory (128-byte swizzle)
template <class T>
__device__ __forceinline__ void wgmma_ss(float (&d)[24], uint64_t da, uint64_t db, int scale_d) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n48k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])  \
      : "l"(da), "l"(db), "r"(scale_d))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// S(64 x 64, f32) (+)= A(64 x 16) B(16 x 64): both K-major in shared memory (128-byte swizzle)
template <class T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
      : "l"(da), "l"(db), "r"(scale_d))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// O[OFF .. OFF + 32)(64 x 64, f32) += P(64 x 16, registers) V(16 x 64): V MN-major in shared memory
// (the transpose bit; 64-column groups LBO apart)
template <class T, int OFF, int M>
__device__ __forceinline__ void wgmma_rs64(float (&d)[M], const uint32_t (&a)[4], uint64_t db) {
  static_assert(OFF + 32 <= M, "accumulators past the array");
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),  \
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),  \
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),  \
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),  \
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),  \
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// O[OFF .. OFF + 96)(64 x 192, f32) += P(64 x 16, registers) V(16 x 192): V MN-major in shared memory
// (the transpose bit; 64-column groups LBO apart)
template <class T, int OFF, int M>
__device__ __forceinline__ void wgmma_rs192(float (&d)[M], const uint32_t (&a)[4], uint64_t db) {
  static_assert(OFF + 96 <= M, "accumulators past the array");
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),  \
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),  \
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),  \
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),  \
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),  \
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),  \
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),  \
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),  \
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),  \
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),  \
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63]), "+f"(d[OFF + 64]), "+f"(d[OFF + 65]),  \
        "+f"(d[OFF + 66]), "+f"(d[OFF + 67]), "+f"(d[OFF + 68]), "+f"(d[OFF + 69]), "+f"(d[OFF + 70]), "+f"(d[OFF + 71]),  \
        "+f"(d[OFF + 72]), "+f"(d[OFF + 73]), "+f"(d[OFF + 74]), "+f"(d[OFF + 75]), "+f"(d[OFF + 76]), "+f"(d[OFF + 77]),  \
        "+f"(d[OFF + 78]), "+f"(d[OFF + 79]), "+f"(d[OFF + 80]), "+f"(d[OFF + 81]), "+f"(d[OFF + 82]), "+f"(d[OFF + 83]),  \
        "+f"(d[OFF + 84]), "+f"(d[OFF + 85]), "+f"(d[OFF + 86]), "+f"(d[OFF + 87]), "+f"(d[OFF + 88]), "+f"(d[OFF + 89]),  \
        "+f"(d[OFF + 90]), "+f"(d[OFF + 91]), "+f"(d[OFF + 92]), "+f"(d[OFF + 93]), "+f"(d[OFF + 94]), "+f"(d[OFF + 95])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// O[OFF .. OFF + 128)(64 x 256, f32) += P(64 x 16, registers) V(16 x 256): V MN-major in shared memory
// (the transpose bit; 64-column groups LBO apart)
template <class T, int OFF, int M>
__device__ __forceinline__ void wgmma_rs256(float (&d)[M], const uint32_t (&a)[4], uint64_t db) {
  static_assert(OFF + 128 <= M, "accumulators past the array");
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),  \
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),  \
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),  \
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),  \
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),  \
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),  \
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),  \
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),  \
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),  \
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),  \
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63]), "+f"(d[OFF + 64]), "+f"(d[OFF + 65]),  \
        "+f"(d[OFF + 66]), "+f"(d[OFF + 67]), "+f"(d[OFF + 68]), "+f"(d[OFF + 69]), "+f"(d[OFF + 70]), "+f"(d[OFF + 71]),  \
        "+f"(d[OFF + 72]), "+f"(d[OFF + 73]), "+f"(d[OFF + 74]), "+f"(d[OFF + 75]), "+f"(d[OFF + 76]), "+f"(d[OFF + 77]),  \
        "+f"(d[OFF + 78]), "+f"(d[OFF + 79]), "+f"(d[OFF + 80]), "+f"(d[OFF + 81]), "+f"(d[OFF + 82]), "+f"(d[OFF + 83]),  \
        "+f"(d[OFF + 84]), "+f"(d[OFF + 85]), "+f"(d[OFF + 86]), "+f"(d[OFF + 87]), "+f"(d[OFF + 88]), "+f"(d[OFF + 89]),  \
        "+f"(d[OFF + 90]), "+f"(d[OFF + 91]), "+f"(d[OFF + 92]), "+f"(d[OFF + 93]), "+f"(d[OFF + 94]), "+f"(d[OFF + 95]),  \
        "+f"(d[OFF + 96]), "+f"(d[OFF + 97]), "+f"(d[OFF + 98]), "+f"(d[OFF + 99]), "+f"(d[OFF + 100]), "+f"(d[OFF + 101]),  \
        "+f"(d[OFF + 102]), "+f"(d[OFF + 103]), "+f"(d[OFF + 104]), "+f"(d[OFF + 105]), "+f"(d[OFF + 106]), "+f"(d[OFF + 107]),  \
        "+f"(d[OFF + 108]), "+f"(d[OFF + 109]), "+f"(d[OFF + 110]), "+f"(d[OFF + 111]), "+f"(d[OFF + 112]), "+f"(d[OFF + 113]),  \
        "+f"(d[OFF + 114]), "+f"(d[OFF + 115]), "+f"(d[OFF + 116]), "+f"(d[OFF + 117]), "+f"(d[OFF + 118]), "+f"(d[OFF + 119]),  \
        "+f"(d[OFF + 120]), "+f"(d[OFF + 121]), "+f"(d[OFF + 122]), "+f"(d[OFF + 123]), "+f"(d[OFF + 124]), "+f"(d[OFF + 125]),  \
        "+f"(d[OFF + 126]), "+f"(d[OFF + 127])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// The key stream of batch row b: the own segment's tiles (fused modes and
// self mode), then NSETS segments of endpoint tiles (none in self mode), or
// the own tiles alone on a skip row
template <bool HAS_OWN, int NSETS, int BK>
struct Stream {
  int n_own, n_ep, ntiles;
  bool skip;
  __device__ Stream(const Params& p, int b) {
    skip = HAS_OWN && p.skip != nullptr && p.skip[b] != 0;  // the pure modes never skip
    n_own = HAS_OWN ? (p.Lk + BK - 1) / BK : 0;
    n_ep = (p.Le + BK - 1) / BK;
    ntiles = n_own + (skip ? 0 : NSETS * n_ep);
  }
  // tile it's segment (0 own, 1 begin or cross, 2 end), its first key and its keys
  __device__ int seg(int it) const { return it < n_own ? 0 : 1 + (it - n_own) / n_ep; }
  __device__ int row(int it) const { return it < n_own ? it * BK : ((it - n_own) % n_ep) * BK; }
  __device__ int valid(int it, const Params& p) const {
    const int len = seg(it) == 0 ? p.Lk : p.Le, r = row(it);
    return len - r < BK ? len - r : BK;
  }
  // the first and one past the last tile of run r: 0 the own segment, 1 begin, 2 end
  __device__ int run_begin(int r) const { return r == 0 ? 0 : n_own + (r - 1) * n_ep; }
  __device__ int run_end(int r) const { return r == 0 ? n_own : n_own + r * n_ep; }
};

// The producer thread: the Q boxes of `nq` query tiles of 64 rows (one
// barrier each), then every tile of the key stream, K into its ring and V
// into its own, each slot reloaded once its consumers have released it
template <bool HAS_OWN, int NSETS, int BK, int BOXES, int STAGES>
__device__ __forceinline__ void produce(const Stream<HAS_OWN, NSETS, BK>& st, const Params& p, uint32_t qs, int nq,
                                        uint32_t qbar, uint32_t ks, uint32_t vs, uint32_t kfull, uint32_t kempty,
                                        uint32_t vfull, uint32_t vempty, const CUtensorMap* qm,
                                        const CUtensorMap* const (&kmaps)[3], const CUtensorMap* const (&vmaps)[3],
                                        int h, int q0, int b) {
  for (int w = 0; w < nq; ++w) {
    mbar_expect_tx(qbar + 8 * w, BOXES * 64 * 128);
    for (int c = 0; c < BOXES; ++c) {
      tma_load(qs + (w * BOXES + c) * (64 * 128), qm, qbar + 8 * w, 64 * c, h, q0 + 64 * w, b);
    }
  }
  for (int it = 0; it < st.ntiles; ++it) {
    const int slot = it % STAGES, seg = st.seg(it), r0 = st.row(it);
    for (int kv = 0; kv < 2; ++kv) {
      const uint32_t bar = (kv ? vfull : kfull) + 8 * slot;
      const uint32_t dst = (kv ? vs : ks) + slot * (BOXES * BK * 128);
      const CUtensorMap* map = kv ? vmaps[seg] : kmaps[seg];
      const int bi = seg > 0 && ((p.shared_eps >> (2 * (seg - 1) + kv)) & 1) ? 0 : b;
      if (it >= STAGES) mbar_wait((kv ? vempty : kempty) + 8 * slot, (it / STAGES - 1) & 1);
      mbar_expect_tx(bar, BOXES * BK * 128);
      for (int c = 0; c < BOXES; ++c) tma_load(dst + c * (BK * 128), map, bar, 64 * c, h, r0, bi);
    }
  }
}

// The outer modes' two softmax sets over a warpgroup's registers (O in NO
// accumulators, the two rows' max and sum): run 0 the own segment (fused
// modes), 1 begin, 2 end, through one call site of run(r), so the pipelined
// loop is compiled once. The own state is parked after its run (parked():
// this thread's words in its row tile of the workspace, `stride` apart, made
// again where they are used, as is the coefficient coef(), so that neither
// holds a register through the runs), the begin run continues it to (1 - c)
// O / l, swapped word for word with the parked state, and the end run
// continues that to c O / l, plus the parked words. The pure outer mode
// parks (1 - c) O / l and starts the end set afresh.
template <bool HAS_OWN, int NO, class Run, class Park, class Coef, class Norm>
__device__ __forceinline__ void blend_sets(float (&o)[NO], float& m0, float& m1, float& l0, float& l1, int stride,
                                           Run&& run, Park&& parked, Coef&& coef, Norm&& normalise) {
#pragma unroll 1
  for (int r = HAS_OWN ? 0 : 1; r < 3; ++r) {
    run(r);
    float* park = parked();
    if (r == 0) {  // park the own segment's state: the end segment continues it too
#pragma unroll
      for (int i = 0; i < NO; ++i) park[i * stride] = o[i];
      if constexpr (!kStatic) {  // the static shift keeps no max
        park[NO * stride] = m0;
        park[(NO + 1) * stride] = m1;
      }
      park[(NO + 2) * stride] = l0;
      park[(NO + 3) * stride] = l1;
    } else if (r == 1) {
      normalise(1.f - coef());
      if (HAS_OWN) {  // swap (1 - c) O_begin / l with the parked own state
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          const float own = park[i * stride];
          park[i * stride] = o[i];
          o[i] = own;
        }
        if constexpr (!kStatic) {
          m0 = park[NO * stride];
          m1 = park[(NO + 1) * stride];
        }
        l0 = park[(NO + 2) * stride];
        l1 = park[(NO + 3) * stride];
      } else {  // park it, and start the end set afresh
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          park[i * stride] = o[i];
          o[i] = 0.f;
        }
        if constexpr (!kStatic) m0 = m1 = -INFINITY;
        l0 = l1 = 0.f;
      }
    }
  }
  normalise(coef());
  const float* park = parked();
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] += park[i * stride];
}

// Maps: q, k, v, k_begin, v_begin, k_end, v_end, out, each (D, H, S, B) with
// boxes of 64 columns by 64 (q, out) or the tile's keys.
// HAS_OWN: the row's own K/V segment leads the stream (fused modes, self).
// NSETS: 0 = none (self: the own segment alone), 1 = one cross segment
// (inner), 2 = begin and end blended by coef (outer).
template <class T, int NC, bool HAS_OWN, int NSETS>
__global__ void __launch_bounds__(kThreads, 1)
    flash16_dmid_rows_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                             const __grid_constant__ CUtensorMap vm, const __grid_constant__ CUtensorMap kbm,
                             const __grid_constant__ CUtensorMap vbm, const __grid_constant__ CUtensorMap kem,
                             const __grid_constant__ CUtensorMap vem, const __grid_constant__ CUtensorMap om,
                             const Params p) {
  using L = Rows<NC>;
  constexpr int BK = L::kBK, S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte-swizzled tiles are 1024-byte aligned
  const uint32_t qs = base, ks = qs + 2 * L::kQBytes, vs = ks + S * L::kTileBytes;
  const uint32_t kfull = vs + S * L::kTileBytes, kempty = kfull + 8 * S, vfull = kempty + 8 * S;
  const uint32_t vempty = vfull + 8 * S, qbar = vempty + 8 * S;  // qbar: one per warpgroup's Q tile

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 64 * p.nwg;
  const int tid = threadIdx.x, wg = tid >> 7;
  const Stream<HAS_OWN, NSETS, BK> st(p, b);

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(kfull + 8 * i, 1);
      mbar_init(vfull + 8 * i, 1);
      mbar_init(kempty + 8 * i, 4 * p.nwg);  // one arrival per consumer warp
      mbar_init(vempty + 8 * i, 4 * p.nwg);
    }
    mbar_init(qbar, 1);
    mbar_init(qbar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      const CUtensorMap* const kmaps[3] = {&km, &kbm, &kem};
      const CUtensorMap* const vmaps[3] = {&vm, &vbm, &vem};
      produce<HAS_OWN, NSETS, BK, NC, S>(st, p, qs, p.nwg, qbar, ks, vs, kfull, kempty, vfull, vempty, &qm, kmaps,
                                         vmaps, h, q0, b);
    }
    return;
  }
  if (wg >= p.nwg) return;  // a block of one warpgroup: the second stays idle

  // consumer warpgroup wg: query rows q0 + 64 wg .., all of D
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int ct = tid & 127, warp = ct >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool turns = kTurns && p.nwg == 2;
  const uint32_t q = qs + wg * L::kQBytes;  // this warpgroup's Q tile
  mbar_wait(qbar + 8 * wg, 0);

  float o[NC * 32];  // O (64 x 64 NC), n8 tile j at o[4j .. 4j + 3]: rows g, g + 8, columns 8j + 2t, + 1
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[BK / 2];             // a tile's scores
  uint32_t pa[BK / 16][4];     // P in T: the A fragments of P V

  // Turns (named barriers 4 and 5): warpgroup 0 issues first, then each hands
  // the turn to the other once its products are issued
  auto take_turn = [&]() {
    if (turns) asm volatile("bar.sync %0, 256;\n" ::"r"(4 + wg) : "memory");
  };
  auto pass_turn = [&]() {
    if (turns) asm volatile("bar.arrive %0, 256;\n" ::"r"(5 - wg) : "memory");
  };
  if (turns && wg == 1) asm volatile("bar.arrive 4, 256;\n" ::: "memory");

  auto wait_k = [&](int it) { mbar_wait(kfull + 8 * (it % S), (it / S) & 1); };
  auto wait_v = [&](int it) { mbar_wait(vfull + 8 * (it % S), (it / S) & 1); };
  // S = Q K^T of tile it over all of D: box kk / 4 of Q and K, 32 bytes in per k16 step
  auto issue_qk = [&](int it) {
    const uint32_t kt = ks + (it % S) * L::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NC * 4; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<T>(s, desc_sw128(q + (kk / 4) * (64 * 128) + off, 16),
                  desc_sw128(kt + (kk / 4) * L::kBoxBytes + off, 16), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile it: 16 keys (2048 bytes) a step, the next 64 columns LBO (one box) away
  auto issue_pv = [&](int it) {
    const uint32_t vt = vs + (it % S) * L::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t at = vt + kk * 2048;
      if constexpr (NC == 3) {
        wgmma_rs192<T, 0>(o, pa[kk], desc_sw128(at, L::kBoxBytes));
      } else {
        wgmma_rs256<T, 0>(o, pa[kk], desc_sw128(at, L::kBoxBytes));
      }
      if constexpr (NC == 5) wgmma_rs64<T, 128>(o, pa[kk], desc_sw128(at + 4 * L::kBoxBytes, L::kBoxBytes));
    }
    wgmma_commit();
  };
  auto release = [&](uint32_t empty, int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % S));
  };
  // online softmax of tile it (scores in s) into P (pa); O rescaled in place
  // (the static instances: P at the static shift, no max, no rescale)
  auto softmax = [&](int it) {
    const int valid = st.valid(it, p);
    if (valid < BK) {  // the segment's last tile: keys past its length do not exist
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if ((i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
      }
    }
    if constexpr (kStatic) {
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = static_p(s[4 * j], p), p1 = static_p(s[4 * j + 1], p);
        const float p2 = static_p(s[4 * j + 2], p), p3 = static_p(s[4 * j + 3], p);
        ls0 += p0 + p1;
        ls1 += p2 + p3;
        pa[j / 2][2 * (j & 1)] = Elem<T>::pack(p0, p1);
        pa[j / 2][2 * (j & 1) + 1] = Elem<T>::pack(p2, p3);
      }
      l0 += ls0;
      l1 += ls1;
      return;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // every tile holds at least one real key, so the new max is finite
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = ex2((m0 - mn0) * p.scale_log2), al1 = ex2((m1 - mn1) * p.scale_log2);
    m0 = mn0;
    m1 = mn1;
    const float ms0 = mn0 * p.scale_log2, ms1 = mn1 * p.scale_log2;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = ex2(fmaf(s[4 * j], p.scale_log2, -ms0)), p1 = ex2(fmaf(s[4 * j + 1], p.scale_log2, -ms0));
      const float p2 = ex2(fmaf(s[4 * j + 2], p.scale_log2, -ms1)), p3 = ex2(fmaf(s[4 * j + 3], p.scale_log2, -ms1));
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      // keys 16 kk .. 16 kk + 15 are n8 tiles 2 kk and 2 kk + 1: P's A fragment for k16 step kk
      pa[j / 2][2 * (j & 1)] = Elem<T>::pack(p0, p1);
      pa[j / 2][2 * (j & 1) + 1] = Elem<T>::pack(p2, p3);
    }
    l0 = l0 * al0 + ls0;
    l1 = l1 * al1 + ls1;
#pragma unroll
    for (int j = 0; j < NC * 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
  };
  // tiles t0 .. t1 - 1 into the running state. In one turn a warpgroup issues
  // tile it's P V and tile it + 1's Q K^T, then waits for both and runs tile
  // it + 1's softmax while the other warpgroup's products run. Nothing is in
  // flight when it returns.
  auto run = [&](int t0, int t1) {
    wait_k(t0);
    take_turn();
    issue_qk(t0);
    pass_turn();
    wgmma_wait<0>();
    reg_fence(s);
    release(kempty, t0);
    softmax(t0);
    int it = t0;
    for (; it + 1 < t1; ++it) {
      wait_v(it);
      wait_k(it + 1);
      take_turn();
      issue_pv(it);
      issue_qk(it + 1);
      pass_turn();
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pa);
      reg_fence(s);
      release(vempty, it);
      release(kempty, it + 1);
      softmax(it + 1);
    }
    wait_v(it);
    take_turn();
    issue_pv(it);
    pass_turn();
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(pa);
    release(vempty, it);
  };
  // O = w O / l, the row sums reduced over the quad
  auto normalise = [&](float w) {
    const float i0 = w / row_sum(l0), i1 = w / row_sum(l1);
#pragma unroll
    for (int j = 0; j < NC * 8; ++j) {
      o[4 * j] *= i0;
      o[4 * j + 1] *= i0;
      o[4 * j + 2] *= i1;
      o[4 * j + 3] *= i1;
    }
  };

  if (NSETS == 2 && !st.skip) {
    blend_sets<HAS_OWN>(
        o, m0, m1, l0, l1, 128, [&](int r) { run(st.run_begin(r), st.run_end(r)); },
        [&]() {
          const size_t tile = ((size_t)(b * gridDim.y + h) * gridDim.x + blockIdx.x) * p.nwg + wg;
          return p.work + tile * (L::kParkWords * 128) + ct;
        },
        [&]() { return p.coef[b]; }, normalise);
  } else {
    run(0, st.ntiles);
    normalise(1.f);
  }
  if (turns && wg == 0) asm volatile("bar.sync 4, 256;\n" ::: "memory");  // the other's last hand-over

  // T output through this warpgroup's Q tile (its products are done), in the
  // TMA box layout: 128-byte rows, 16-byte chunk j of row r at j ^ (r % 8)
  unsigned char* tile = smem_raw + (q - raw);
#pragma unroll
  for (int j = 0; j < NC * 8; ++j) {
    const int box = j / 8, chunk = j % 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + 8 * half;
      *reinterpret_cast<uint32_t*>(tile + box * (64 * 128) + r * 128 + ((chunk ^ (r & 7)) * 16) + 4 * t) =
          Elem<T>::pack(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic stores -> the TMA store's proxy
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  if (ct == 0) {
    for (int c = 0; c < NC; ++c) tma_store(&om, q + c * (64 * 128), 64 * c, h, q0 + 64 * wg, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // shared memory stays until read
  }
}

// The split layout: two consumer warpgroups split D (NCW chunks each) over
// 64 query rows and exchange partial scores once a tile. Maps as above.
template <class T, int NCW, bool HAS_OWN, int NSETS>
__global__ void __launch_bounds__(kThreads, 1)
    flash16_dmid_split_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                              const __grid_constant__ CUtensorMap vm, const __grid_constant__ CUtensorMap kbm,
                              const __grid_constant__ CUtensorMap vbm, const __grid_constant__ CUtensorMap kem,
                              const __grid_constant__ CUtensorMap vem, const __grid_constant__ CUtensorMap om,
                              const Params p) {
  using L = Split<NCW>;
  constexpr int BK = L::kBK, S = L::kStages, kCols = L::kCols;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t qs = base, ks = qs + L::kQBytes, vs = ks + S * L::kTileBytes, xs_at = vs + S * L::kTileBytes;
  float* xs = reinterpret_cast<float*>(smem_raw + (xs_at - raw));  // [tile parity][warpgroup][16][128]
  const uint32_t kfull = xs_at + L::kXBytes, kempty = kfull + 8 * S, vfull = kempty + 8 * S;
  const uint32_t vempty = vfull + 8 * S, qbar = vempty + 8 * S;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 64;
  const int tid = threadIdx.x, wg = tid >> 7;
  const Stream<HAS_OWN, NSETS, BK> st(p, b);

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(kfull + 8 * i, 1);
      mbar_init(vfull + 8 * i, 1);
      mbar_init(kempty + 8 * i, 8);  // one arrival per consumer warp
      mbar_init(vempty + 8 * i, 8);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      const CUtensorMap* const kmaps[3] = {&km, &kbm, &kem};
      const CUtensorMap* const vmaps[3] = {&vm, &vbm, &vem};
      // the Q boxes as one 64-row tile of 2 NCW boxes
      produce<HAS_OWN, NSETS, BK, L::kBoxes, S>(st, p, qs, 1, qbar, ks, vs, kfull, kempty, vfull, vempty, &qm, kmaps,
                                                vmaps, h, q0, b);
    }
    return;
  }

  // consumer warpgroup wg: output columns kCols * wg ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int ct = tid & 127, warp = ct >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t q = qs + wg * NCW * (64 * 128);  // this warpgroup's boxes of Q
  mbar_wait(qbar, 0);

  float o[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[16];               // a tile's (partial, then whole) scores
  uint32_t pa[BK / 16][4];   // P in T: the A fragments of the P V in flight

  // partial scores of tile it over this warpgroup's columns, issued (not waited for)
  auto issue_qk = [&](int it) {
    const uint32_t kt = ks + (it % S) * L::kTileBytes + wg * NCW * L::kBoxBytes;
    mbar_wait(kfull + 8 * (it % S), (it / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<T>(s, desc_sw128(q + (kk / 4) * (64 * 128) + off, 16),
                  desc_sw128(kt + (kk / 4) * L::kBoxBytes + off, 16), kk > 0);
    }
    wgmma_commit();
  };
  auto release = [&](uint32_t empty, int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % S));
  };
  // write our partial scores, meet the other warpgroup, add theirs
  auto exchange = [&](int it) {
    float* mine = xs + (((it & 1) * 2 + wg) * 16) * 128 + ct;
    const float* theirs = xs + (((it & 1) * 2 + (1 - wg)) * 16) * 128 + ct;
#pragma unroll
    for (int i = 0; i < 16; ++i) mine[i * 128] = s[i];
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] += theirs[i * 128];
  };
  float al0 = 0.f, al1 = 0.f;
  uint32_t pn[BK / 16][4];
  [[maybe_unused]] float pf[BK / 2];  // the static instances' P in f32, packed into pa by take_p
  auto softmax = [&](int it) {
    const int valid = st.valid(it, p);
    if (valid < BK) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if ((i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
      }
    }
    if constexpr (kStatic) {  // P at the static shift: no max, no factors
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p0 = static_p(s[4 * j], p), p1 = static_p(s[4 * j + 1], p);
        const float p2 = static_p(s[4 * j + 2], p), p3 = static_p(s[4 * j + 3], p);
        ls0 += p0 + p1;
        ls1 += p2 + p3;
        pf[4 * j] = p0;
        pf[4 * j + 1] = p1;
        pf[4 * j + 2] = p2;
        pf[4 * j + 3] = p3;
      }
      l0 += ls0;
      l1 += ls1;
      return;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    al0 = ex2((m0 - mn0) * p.scale_log2);
    al1 = ex2((m1 - mn1) * p.scale_log2);
    m0 = mn0;
    m1 = mn1;
    const float ms0 = mn0 * p.scale_log2, ms1 = mn1 * p.scale_log2;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p0 = ex2(fmaf(s[4 * j], p.scale_log2, -ms0)), p1 = ex2(fmaf(s[4 * j + 1], p.scale_log2, -ms0));
      const float p2 = ex2(fmaf(s[4 * j + 2], p.scale_log2, -ms1)), p3 = ex2(fmaf(s[4 * j + 3], p.scale_log2, -ms1));
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      pn[j / 2][2 * (j & 1)] = Elem<T>::pack(p0, p1);
      pn[j / 2][2 * (j & 1) + 1] = Elem<T>::pack(p2, p3);
    }
    l0 = l0 * al0 + ls0;
    l1 = l1 * al1 + ls1;
  };
  // O = O * alpha + P V of tile it (P taken from pn; the static instances' by take_p), issued (not waited for)
  auto pv = [&](int it) {
    if constexpr (!kStatic) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
      }
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
    }
    const uint32_t vt = vs + (it % S) * L::kTileBytes + wg * NCW * L::kBoxBytes;
    mbar_wait(vfull + 8 * (it % S), (it / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (NCW == 3) {
        wgmma_rs192<T, 0>(o, pa[kk], desc_sw128(vt + kk * 2048, L::kBoxBytes));
      } else {
        wgmma_rs256<T, 0>(o, pa[kk], desc_sw128(vt + kk * 2048, L::kBoxBytes));
      }
    }
    wgmma_commit();
  };
  // tiles t0 .. t1 - 1 into the running state, software-pipelined within the
  // warpgroup: tile it + 1's Q K^T before tile it's P V, its exchange and
  // softmax beside that P V. Nothing is in flight when it returns.
  // The static instances' softmax leaves P in f32 (pf) and packs it into P
  // V's A registers here, once the previous P V is done and before the next
  // Q K^T is issued (packed in the softmax, beside P V in flight, P took that
  // product's A registers and ptxas serialised every wgmma, C7513)
  auto take_p = [&]() {
    if constexpr (kStatic) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        pa[j / 2][2 * (j & 1)] = Elem<T>::pack(pf[4 * j], pf[4 * j + 1]);
        pa[j / 2][2 * (j & 1) + 1] = Elem<T>::pack(pf[4 * j + 2], pf[4 * j + 3]);
      }
      reg_fence(pa);
    }
  };
  auto run = [&](int t0, int t1) {
    issue_qk(t0);
    wgmma_wait<0>();
    reg_fence(s);
    release(kempty, t0);
    exchange(t0);
    softmax(t0);
    int it = t0;
    for (; it + 1 < t1; ++it) {
      take_p();
      issue_qk(it + 1);
      pv(it);
      wgmma_wait<1>();  // Q K^T of tile it + 1 is done (P V of tile it may run): its K is free
      reg_fence(s);
      release(kempty, it + 1);
      exchange(it + 1);
      softmax(it + 1);
      wgmma_wait<0>();  // P V of tile it is done: O and P are free, and its V
      reg_fence(o);
      reg_fence(pa);
      release(vempty, it);
    }
    take_p();
    pv(it);
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(pa);
    release(vempty, it);
  };
  auto normalise = [&](float w) {
    const float i0 = w / row_sum(l0), i1 = w / row_sum(l1);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      o[4 * j] *= i0;
      o[4 * j + 1] *= i0;
      o[4 * j + 2] *= i1;
      o[4 * j + 3] *= i1;
    }
  };

  if (NSETS == 2 && !st.skip) {
    blend_sets<HAS_OWN>(
        o, m0, m1, l0, l1, 256, [&](int r) { run(st.run_begin(r), st.run_end(r)); },
        [&]() {
          const size_t tile = (size_t)(b * gridDim.y + h) * gridDim.x + blockIdx.x;
          return p.work + tile * (L::kParkWords * 256) + tid;
        },
        [&]() { return p.coef[b]; }, normalise);
  } else {
    run(0, st.ntiles);
    normalise(1.f);
  }

  // T output through this warpgroup's boxes of the Q tile
  unsigned char* tile = smem_raw + (q - raw);
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
    const int box = j / 8, chunk = j % 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + 8 * half;
      *reinterpret_cast<uint32_t*>(tile + box * (64 * 128) + r * 128 + ((chunk ^ (r & 7)) * 16) + 4 * t) =
          Elem<T>::pack(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  if (ct == 0) {
    for (int c = 0; c < NCW; ++c) tma_store(&om, q + c * (64 * 128), kCols * wg + 64 * c, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// A (D, H, S, B) map of a T operand at element strides (b, h, s), boxes of
// 64 columns by `rows` rows, 128-byte swizzle, zeros out of bounds (past D
// and past S), from the cache of maps (map_cache.cuh).
template <class T>
bool encode_map(CUtensorMap* map, const void* ptr, int D, int H, int S, int B, const long long* strides, int rows) {
  return encode_map_cached(map, Elem<T>::kMapType, 2, ptr, D, H, S, B, strides, 64, rows);
}

template <class T, int NC, bool HAS_OWN, int NSETS>
int launch_rows(const CUtensorMap (&m)[8], const Params& p, int H, int B, cudaStream_t s) {
  static bool smem_allowed = false;  // once per instance and process
  const cudaError_t err = allow_smem_once(reinterpret_cast<const void*>(&flash16_dmid_rows_kernel<T, NC, HAS_OWN, NSETS>),
                                          Rows<NC>::kSmem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.Sq + 64 * p.nwg - 1) / (64 * p.nwg)), (unsigned)H, (unsigned)B);
  flash16_dmid_rows_kernel<T, NC, HAS_OWN, NSETS><<<grid, kThreads, Rows<NC>::kSmem, s>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], p);
  return (int)cudaGetLastError();
}

template <class T, int NCW, bool HAS_OWN, int NSETS>
int launch_split(const CUtensorMap (&m)[8], const Params& p, int H, int B, cudaStream_t s) {
  static bool smem_allowed = false;
  const cudaError_t err = allow_smem_once(
      reinterpret_cast<const void*>(&flash16_dmid_split_kernel<T, NCW, HAS_OWN, NSETS>), Split<NCW>::kSmem,
      smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.Sq + 63) / 64), (unsigned)H, (unsigned)B);
  flash16_dmid_split_kernel<T, NCW, HAS_OWN, NSETS><<<grid, kThreads, Split<NCW>::kSmem, s>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], p);
  return (int)cudaGetLastError();
}

// one layout instance in the four endpoint modes and self mode (n_sets 0)
template <class T, int NC, bool ROWS>
int launch_modes(const CUtensorMap (&m)[8], const Params& p, int H, int B, int has_own, int n_sets, cudaStream_t s) {
  if constexpr (ROWS) {
    if (n_sets == 0) return launch_rows<T, NC, true, 0>(m, p, H, B, s);
    if (has_own && n_sets == 1) return launch_rows<T, NC, true, 1>(m, p, H, B, s);
    if (has_own && n_sets == 2) return launch_rows<T, NC, true, 2>(m, p, H, B, s);
    if (!has_own && n_sets == 1) return launch_rows<T, NC, false, 1>(m, p, H, B, s);
    return launch_rows<T, NC, false, 2>(m, p, H, B, s);
  } else {
    if (n_sets == 0) return launch_split<T, NC, true, 0>(m, p, H, B, s);
    if (has_own && n_sets == 1) return launch_split<T, NC, true, 1>(m, p, H, B, s);
    if (has_own && n_sets == 2) return launch_split<T, NC, true, 2>(m, p, H, B, s);
    if (!has_own && n_sets == 1) return launch_split<T, NC, false, 1>(m, p, H, B, s);
    return launch_split<T, NC, false, 2>(m, p, H, B, s);
  }
}

template <class T>
int entry(const void* const (&ptrs)[8], const void* coef, const void* skip, void* work, const long long* dims,
          float scale, float shift_log2, float clip_log2, int has_own, int n_sets, void* stream) {
  const int B = (int)dims[0], H = (int)dims[1], D = (int)dims[5];
  Params p;
  p.Sq = (int)dims[2];
  p.Lk = (int)dims[3];
  p.Le = (int)dims[4];
  if (B <= 0 || H <= 0 || p.Sq <= 0 || p.Lk <= 0 || (n_sets > 0 && p.Le <= 0)) return (int)cudaErrorInvalidValue;
  if (D <= 160 || D > 512 || D % 8 != 0) return (int)cudaErrorInvalidValue;  // 16-byte rows
  // self mode (n_sets 0) streams the own segment: it needs has_own and reads no endpoint
  if (n_sets < 0 || n_sets > 2 || (n_sets == 0 && !has_own) || (n_sets == 2 && (coef == nullptr || work == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 8; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) return (int)cudaErrorMisalignedAddress;
    for (int j = 0; j < 3; ++j) {
      if (dims[6 + 3 * i + j] % 8 != 0) return (int)cudaErrorMisalignedAddress;
    }
  }
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  const int nc = (D + 63) / 64;
  const bool rows = nc <= 5;
  const int bk = rows ? (nc == 5 ? Rows<5>::kBK : Rows<4>::kBK) : Split<4>::kBK;
  // the rows layout: two warpgroups a block where 64-row blocks would be over one wave
  p.nwg = rows && (long long)B * H * ((p.Sq + 63) / 64) > kOneWave ? 2 : rows ? 1 : 2;
  p.coef = static_cast<const float*>(coef);
  p.skip = static_cast<const uint8_t*>(skip);
  p.work = static_cast<float*>(work);
  p.shared_eps = 0;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.shift_log2 = shift_log2;
  p.clip_log2 = clip_log2;
  // rows of each map: queries, own keys, endpoint keys x4, queries out
  const int rows_of[8] = {p.Sq, p.Lk, p.Lk, p.Le, p.Le, p.Le, p.Le, p.Sq};
  CUtensorMap m[8];
  for (int i = 0; i < 8; ++i) {
    const long long* st = dims + 6 + 3 * i;
    if ((!has_own && (i == 1 || i == 2)) || (n_sets == 0 && i >= 3 && i < 7)) {  // never read: any valid map
      m[i] = m[0];
      continue;
    }
    if (!encode_map<T>(&m[i], ptrs[i], D, H, rows_of[i], B, st, i == 0 || i == 7 ? 64 : bk)) {
      return (int)cudaErrorInvalidValue;
    }
    if (i >= 3 && i < 7 && st[0] == 0) p.shared_eps |= 1 << (i - 3);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nc) {
    case 3:
      return launch_modes<T, 3, true>(m, p, H, B, has_own, n_sets, s);
    case 4:
      return launch_modes<T, 4, true>(m, p, H, B, has_own, n_sets, s);
    case 5:
      return launch_modes<T, 5, true>(m, p, H, B, has_own, n_sets, s);
    case 6:
      return launch_modes<T, 3, false>(m, p, H, B, has_own, n_sets, s);
    default:  // 7 chunks run as 8, the eighth box past D zero-filled
      return launch_modes<T, 4, false>(m, p, H, B, has_own, n_sets, s);
  }
}

#if AID_STATIC_SHIFT
}  // namespace static_shift
using static_shift::entry;
#endif
}  // namespace

#if AID_STATIC_SHIFT
// The static-shift instance over bf16 operands: aid_flash_attn_bf16_dmid's
// arguments with the shift C and the clip after the scale, both times
// log2(e) (p = 2^min(s * scale * log2(e) - shift_log2, clip_log2)), every
// mode and self mode, the same workspace. Returns the launch's cudaError_t.
extern "C" int aid_flash_attn_bf16_dmid_static(const void* q, const void* k, const void* v, const void* kb,
                                               const void* vb, const void* ke, const void* ve, void* out,
                                               const void* coef, const void* skip, void* work, const long long* dims,
                                               float scale, float shift_log2, float clip_log2, int has_own,
                                               int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__nv_bfloat16>(ptrs, coef, skip, work, dims, scale, shift_log2, clip_log2, has_own, n_sets, stream);
}
#else
// The endpoint modes and self mode at head dims 161-512: the C signature of
// aid_flash_attn_bf16_dwide. dims are [B, H, Sq, Lk, Le, D, then (b, h, s)
// element strides of q, k, v, k_begin, v_begin, k_end, v_end, out] (30
// values; a b stride of 0 marks an endpoint shared by every row), D the
// operands' head dim (161..512, a multiple of 8: 16-byte rows); coef (B,) f32;
// skip (B,) bool or null; has_own 1 in the fused modes and self mode, 0 in
// the pure ones; n_sets 2 in the outer modes, 1 in the inner ones (their
// lerped K/V in the begin slot), 0 in self mode (has_own 1: the own K/V
// alone; coef, skip and work null, the endpoint pointers and Le not read);
// work the outer modes' f32 workspace (null in the inner modes and self):
// with NC = ceil(D / 64), for NC <= 5 B * H * ceil(Sq / 64 W) * W * (32 NC +
// 4) * 128 floats, W the warpgroups a block (2 where B * H * ceil(Sq / 64) >
// 132, else 1); for NC >= 6 B * H * ceil(Sq / 64) * (32 NCW + 4) * 256, NCW
// 3 at NC = 6, else 4. Every operand has its head dim contiguous, 16-byte
// aligned rows and its other strides multiples of 8 elements. Returns the
// launch's cudaError_t (0 on success).
extern "C" int aid_flash_attn_bf16_dmid(const void* q, const void* k, const void* v, const void* kb, const void* vb,
                                        const void* ke, const void* ve, void* out, const void* coef, const void* skip,
                                        void* work, const long long* dims, float scale, int has_own, int n_sets,
                                        void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__nv_bfloat16>(ptrs, coef, skip, work, dims, scale, 0.f, 0.f, has_own, n_sets, stream);
}

// The same over f16 operands.
extern "C" int aid_flash_attn_f16_dmid(const void* q, const void* k, const void* v, const void* kb, const void* vb,
                                       const void* ke, const void* ve, void* out, const void* coef, const void* skip,
                                       void* work, const long long* dims, float scale, int has_own, int n_sets,
                                       void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__half>(ptrs, coef, skip, work, dims, scale, 0.f, 0.f, has_own, n_sets, stream);
}
#endif
