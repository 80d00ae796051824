// Flash interpolated attention for the AID family, bf16 and f16, head dims 40/64/80/160, sm_90a.
//
// Replaces the two Pallas TPU kernels behind
// aid_tpu/ops/flash_attention.py::flash_interpolated_attention
// (flash_attention.py:683-1061): the streaming online-softmax `_kernel`
// (flash_attention.py:101) and the whole-stream-resident `_kernel_onepass`
// (flash_attention.py:339). One kernel covers both: their split, the
// one-pass routing threshold, head grouping, `mxu_den`, `static_smax` and
// `pad_d` came from VMEM and Mosaic limits and have no counterpart here.
//
// What it computes (the JAX function's contract), per batch row b:
//   self         softmax(q k_b^T) v_b
//   fused_outer  (1-c_b) Attn(q, [k_b; K_begin]) + c_b Attn(q, [k_b; K_end])
//   pure_outer   (1-c_b) Attn(q, K_begin)        + c_b Attn(q, K_end)
//   fused_inner  Attn(q, [k_b; K_cross]),  K_cross = lerp(K_begin, K_end, c_b)
//   pure_inner   Attn(q, K_cross)
// The inner modes' K_cross/V_cross are lerped in f32 by the wrapper (as
// `pack_stream` does on the TPU) and arrive in the K_begin/V_begin slot.
// A row with skip != 0 drops its endpoint segments (fused modes), which
// makes it exactly vanilla attention.
//
// What bounds it on the card. At the self-attention shapes (S = 1024..4096
// keys per segment) attention is compute-bound: 4*S*L*D flops against
// 2*(S+L)*D*2 bytes, far above the H100's ~295 flop/byte bf16 ridge, and at
// D = 40/64 the exponentials (one MUFU op per score) cost about as much as
// the products. At 77 keys (text cross attention, the endpoint segments of
// the cross layers) and at D = 160 over 256 or 64 tokens, the bytes of q
// and out bind, and a call lasts a few microseconds. The design:
//   * every operand arrives by TMA (cp.async.bulk.tensor) through a tensor
//     map over the (B, S, H*D) projection viewed as (D, H, S, B): boxes of
//     64 columns (128 bytes, the 128-byte swizzle) by a tile of rows. Dim 0
//     has the extent D, so a box's columns past D (D = 40, the second box
//     at D = 80, the third at 160) come in as zeros, never as the next
//     head's columns; rows past a segment's length come in as zeros, never
//     as the next batch row's keys. Q K^T then contracts over 48 (D = 40),
//     80 or 160 columns of which the pad is zero in both operands. Shared
//     (H, Le, D) endpoints get a map of batch extent 1, indexed by head
//     alone (a tensor map takes no stride of 0);
//   * warp specialisation: a producer warpgroup (one thread issues every
//     copy, its registers given to the consumers with setmaxnreg) keeps a
//     ring of K/V stages full on mbarriers across the segment loop (own,
//     begin, end), so the next tiles load while this one computes;
//   * one to three consumer warpgroups own 64 query rows each and run
//     wgmma.mma_async: S = Q K^T as m64nBKk16 with Q and K K-major in shared
//     memory, then O += P V as m64nDk16 with P from registers (the S
//     accumulator layout is the A-fragment layout of P) and V as B in its
//     row-major tile through the descriptor's transpose bit, so V is never
//     copied transposed. The online softmax stays in f32 (ex2.approx with
//     log2(e) folded into the scale, one FFMA and one MUFU per score).
//     Each warpgroup waits for its own products (wait_group 0); the
//     warpgroups of a block interleave on the SM by themselves, one's
//     softmax beside another's products. Measured on an H100 (see PERF.md),
//     that beat both FA3-style schedules: overlapping a warpgroup's softmax
//     with its own previous P V (a second P, wait_group 1) and ping-pong
//     turns on named barriers were each 10-21% slower, and a third
//     warpgroup at D = 40/64 (more to interleave) was 8-21% faster than two;
//   * the outer modes keep one accumulator set in registers. The own
//     segment is computed once; its state (O, max, sum) is parked in this
//     thread's private words of shared memory, the begin segment continues
//     it to (1-c) O / l, which is exchanged word for word with the parked
//     state, and the end segment continues that. Two sets of 64 x 160 f32
//     would need 160 registers a thread before S and P; one set needs 80 at
//     D = 160, so no instance splits the output columns or spills;
//   * the output leaves through shared memory (this warpgroup's Q tile,
//     written in the same swizzled layout) and a TMA store, which clips
//     rows past Sq and columns past D;
//   * tiles by head dim (Tiles below), 128-key tiles at D <= 80 so a
//     77-key segment is one tile: 192 query rows (three consumer
//     warpgroups at 128 registers, no spills; four would get 96 and spill)
//     at D = 40 and 64; 128 rows at D = 80, whose parked states and two
//     stages of 128 x 80 K and V fill the shared memory; 64 rows and 64-key
//     tiles at D = 160, whose SD1.x shapes (256 and 64 tokens) would
//     otherwise give fewer blocks than the card has SMs, with three stages.
//     A segment's last tile masks its key columns past the length.
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled, taken
// through cudaGetDriverEntryPoint (no -lcuda at link time), and passed as
// __grid_constant__ parameters.
//
// One design, two element types (elem16.cuh): T = __nv_bfloat16 is
// aid_flash_attn_bf16, T = __half is aid_flash_attn_f16 (an f16 UNet, the
// dtype SD checkpoints are stored in). They differ in the wgmma type suffix
// (.bf16 or .f16, f32 accumulation in both), the tensor maps' data type and
// the rounding of P and of the output; the tiles, the barriers, the
// softmax and every mask (on the f32 scores, never stored in T) are the
// same. P in [0, 1] rounded to f16 goes subnormal below 6.1e-5, as the JAX
// kernel's cast of P to V's dtype does (flash_attention.py:205, 223).
//
// The static-shift softmax (`static_smax`, flash_attention.py:44-65 and the
// branches of `_kernel` at :210-256 and `_kernel_onepass` at :520-545) is
// the same body built with AID_STATIC_SHIFT = 1: flash_interpolated_attention_static.cu
// includes this file so, as a translation unit of its own (the exact
// instances here compile as before, and the parallel build's wall does not
// grow by its instances). There each tile's P is ex2(min(s * scale_log2 -
// shift_log2, clip_log2)), the shift C and the clip (30 nats) folded into
// log2 units by the wrapper as the scale is: no row max, no quad reduction,
// no rescale of O and l, so the chain from Q K^T to P V loses its two
// serial steps; P V and l just add up, the outer modes park the own
// segment's state as the exact instances do, and a row's sum is guarded
// (max(l, 1e-37)) as the JAX kernels' denominator is. The same softmax while
// every set's row max lies in [C - 72, C + 30]; ex2.approx.ftz flushes below
// 2^-126 ~ e^-87, the window's lower edge. bf16 only (aid_flash_attn_bf16_static):
// in f16, exp(-40) is below the smallest subnormal.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef AID_STATIC_SHIFT
#define AID_STATIC_SHIFT 0
#endif

namespace {
#if AID_STATIC_SHIFT
namespace static_shift {  // kernel names of their own beside the exact instances' in one library
#endif

#include "elem16.cuh"

constexpr bool kStatic = AID_STATIC_SHIFT != 0;

// The tile table (tests/test_torch_ops.py reads it): query rows per block,
// keys per K/V tile, K/V stages in the ring.
template <int D> struct Tiles;
template <> struct Tiles<40> { static constexpr int kBQ = 192, kBK = 128, kStages = 3; };
template <> struct Tiles<64> { static constexpr int kBQ = 192, kBK = 128, kStages = 3; };
template <> struct Tiles<80> { static constexpr int kBQ = 128, kBK = 128, kStages = 2; };
template <> struct Tiles<160> { static constexpr int kBQ = 64, kBK = 64, kStages = 3; };

template <int D>
struct Cfg {
  static constexpr int kBQ = Tiles<D>::kBQ, kBK = Tiles<D>::kBK, kStages = Tiles<D>::kStages;
  static constexpr int kWG = kBQ / 64;                   // consumer warpgroups, 64 query rows each
  static constexpr int kThreads = 128 * (kWG + 1);       // + the producer warpgroup
  // registers a consumer thread takes from the producer's (24): 65536 in all
  static constexpr int kConsumerRegs = kWG == 3 ? 160 : 240;
  static constexpr int kChunks = (D + 63) / 64;          // 64-column boxes of a row
  static constexpr int kKSteps = (D + 15) / 16;          // k16 steps of Q K^T
  static constexpr int kQBytes = 64 * 128 * kChunks;     // one warpgroup's Q tile
  static constexpr int kKVBytes = kBK * 128 * kChunks;   // one K (or V) tile
  static constexpr int kStageBytes = 2 * kKVBytes;       // K then V
  static constexpr int kSlot = D / 2 + 4;                // parked words a thread: O, m[2], l[2]
  static_assert(D % 8 == 0 && kBK % 16 == 0, "wgmma N and K steps");
  static constexpr int smem_bytes(bool outer) {
    return 1024 + kWG * kQBytes + kStages * kStageBytes + (outer ? kWG * 128 * kSlot * 4 : 0) +
           (2 * kStages + 1) * 8;
  }
  static_assert(smem_bytes(true) <= 232448, "over the 227 KB a block can use");
};

struct Params {
  const float* coef;  // (B,) f32, read by the outer modes only
  const uint8_t* skip;  // (B,) bool or null, read by the fused endpoint modes only
  int Sq, Lk, Le;
  int shared_eps;     // bit i: endpoint map i (k_begin, v_begin, k_end, v_end) is one (H, Le, D) tensor
  float scale_log2;   // softmax scale * log2(e)
  float shift_log2, clip_log2;  // the static shift C and the clip, * log2(e) (kStatic instances only)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed (one asm
// loop: a C++ loop around try_wait makes ptxas serialise wgmmas, C7520).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a (D, H, S, B) map into shared memory, completion counted on `bar` in bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(h), "r"(s), "r"(b), "r"(bar)
      : "memory");
}

// One box from shared memory into a (D, H, S, B) map; parts out of bounds are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int d, int h, int s, int b) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(d), "r"(h), "r"(s), "r"(b)
               : "memory");
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
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S(64 x 64, f32) (+)= A(64 x 16) B(16 x 64): both K-major in shared memory
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

// S(64 x 128, f32) (+)= A(64 x 16) B(16 x 128): both K-major in shared memory
template <class T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
      : "l"(da), "l"(db), "r"(scale_d))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// O(64 x 40, f32) += P(64 x 16, registers) V(16 x 40): V MN-major in shared memory (transpose bit)
template <class T>
__device__ __forceinline__ void wgmma_rs(float (&d)[20], const uint32_t (&a)[4], uint64_t db) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n40k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// O(64 x 64, f32) += P(64 x 16, registers) V(16 x 64): V MN-major in shared memory (transpose bit)
template <class T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// O(64 x 80, f32) += P(64 x 16, registers) V(16 x 80): V MN-major in shared memory (transpose bit)
template <class T>
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// O(64 x 160, f32) += P(64 x 16, registers) V(16 x 160): V MN-major in shared memory (transpose bit)
template <class T>
__device__ __forceinline__ void wgmma_rs(float (&d)[80], const uint32_t (&a)[4], uint64_t db) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n160k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),  \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),  \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}


// The running softmax state of this thread's two query rows (g and g + 8
// of its warp's 16): O in the wgmma accumulator layout, the running max m
// of the raw scores and this thread's partial row sums l.
template <int D>
struct State {
  float o[D / 2];
  float m[2], l[2];
};

template <int D>
__device__ __forceinline__ void init_state(State<D>& st) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) st.o[i] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// One K/V tile of online softmax for this warpgroup's 64 query rows. `valid`
// keys of the tile are real (the rest are zero rows past the segment). The
// kStatic instances take P at the static shift instead (see the header).
template <class T, int D>
__device__ __forceinline__ void tile_update(State<D>& st, uint32_t q, uint32_t kt, uint32_t vt, int valid,
                                            float scale_log2, float shift_log2, float clip_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::kBK;
  const int t = threadIdx.x & 3;
  float s[BK / 2];
  // S = Q K^T, k16 steps over the (zero-padded) head dim: box kk / 4, 32 bytes in per step
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kKSteps; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<T>(s, desc_sw128(q + (kk / 4) * (64 * 128) + off, 16),
             desc_sw128(kt + (kk / 4) * (BK * 128) + off, 16), kk > 0);
  }
  wgmma_commit();
  wgmma_wait0();
  reg_fence(s);

  if (valid < BK) {  // the segment's last tile: keys past its length do not exist
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if ((i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
    }
  }
  if constexpr (kStatic) {
    // P = 2^min(s scale_log2 - shift_log2, clip_log2): no max, no rescale (a masked key stays -inf and gives 0)
    float ls0 = 0.f, ls1 = 0.f;
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = ex2(fminf(fmaf(s[4 * j], scale_log2, -shift_log2), clip_log2));
      const float p1 = ex2(fminf(fmaf(s[4 * j + 1], scale_log2, -shift_log2), clip_log2));
      const float p2 = ex2(fminf(fmaf(s[4 * j + 2], scale_log2, -shift_log2), clip_log2));
      const float p3 = ex2(fminf(fmaf(s[4 * j + 3], scale_log2, -shift_log2), clip_log2));
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      pa[j / 2][2 * (j & 1)] = Elem<T>::pack(p0, p1);
      pa[j / 2][2 * (j & 1) + 1] = Elem<T>::pack(p2, p3);
    }
    st.l[0] += ls0;
    st.l[1] += ls1;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<T>(st.o, pa[kk], desc_sw128(vt + kk * 2048, BK * 128));
    wgmma_commit();
    wgmma_wait0();
    reg_fence(st.o);
    reg_fence(pa);
    return;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  // every tile holds at least one real key, so the new max is finite
  const float mn0 = fmaxf(st.m[0], quad_max(mx0)), mn1 = fmaxf(st.m[1], quad_max(mx1));
  const float al0 = ex2((st.m[0] - mn0) * scale_log2), al1 = ex2((st.m[1] - mn1) * scale_log2);
  st.m[0] = mn0;
  st.m[1] = mn1;
  const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
  float ls0 = 0.f, ls1 = 0.f;
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float p0 = ex2(fmaf(s[4 * j], scale_log2, -ms0)), p1 = ex2(fmaf(s[4 * j + 1], scale_log2, -ms0));
    const float p2 = ex2(fmaf(s[4 * j + 2], scale_log2, -ms1)), p3 = ex2(fmaf(s[4 * j + 3], scale_log2, -ms1));
    ls0 += p0 + p1;
    ls1 += p2 + p3;
    // keys 16 kk .. 16 kk + 15 are n-tiles 2 kk and 2 kk + 1: P's A fragment for k-step kk
    pa[j / 2][2 * (j & 1)] = Elem<T>::pack(p0, p1);
    pa[j / 2][2 * (j & 1) + 1] = Elem<T>::pack(p2, p3);
  }
  st.l[0] = st.l[0] * al0 + ls0;
  st.l[1] = st.l[1] * al1 + ls1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    st.o[4 * j] *= al0;
    st.o[4 * j + 1] *= al0;
    st.o[4 * j + 2] *= al1;
    st.o[4 * j + 3] *= al1;
  }
  // O += P V: 16 keys (two 8-row groups, 2048 bytes) per step; V's next box is LBO away
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<T>(st.o, pa[kk], desc_sw128(vt + kk * 2048, BK * 128));
  wgmma_commit();
  wgmma_wait0();
  reg_fence(st.o);
  reg_fence(pa);
}

// A row's sum: the thread's partial sums reduced over the quad; at the
// static shift guarded, so a row whose every key underflowed gives 0
__device__ __forceinline__ float row_sum(float l) {
  if constexpr (kStatic) return fmaxf(quad_sum(l), 1e-37f);
  return quad_sum(l);
}

// (1 - c) or c times O / l: the row sums reduced over the quad
template <int D>
__device__ __forceinline__ void normalise(State<D>& st, float w) {
  const float i0 = w / row_sum(st.l[0]), i1 = w / row_sum(st.l[1]);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    st.o[4 * j] *= i0;
    st.o[4 * j + 1] *= i0;
    st.o[4 * j + 2] *= i1;
    st.o[4 * j + 3] *= i1;
  }
}

// HAS_OWN: the row's own K/V segment leads the stream (self and fused modes).
// NSETS: 0 = no endpoint segment (self), 1 = one cross segment (inner),
// 2 = begin and end segments blended by coef (outer).
// Maps: q, k, v, k_begin, v_begin, k_end, v_end, out.
template <class T, int D, bool HAS_OWN, int NSETS>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                 const __grid_constant__ CUtensorMap vm, const __grid_constant__ CUtensorMap kbm,
                 const __grid_constant__ CUtensorMap vbm, const __grid_constant__ CUtensorMap kem,
                 const __grid_constant__ CUtensorMap vem, const __grid_constant__ CUtensorMap om, const Params p) {
  using C = Cfg<D>;
  constexpr int BK = C::kBK, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte-swizzled tiles are 1024-byte aligned
  const uint32_t qs = base, kvs = qs + C::kWG * C::kQBytes;
  const uint32_t slot_at = kvs + S * C::kStageBytes;
  float* slot = reinterpret_cast<float*>(smem_raw + (slot_at - raw));
  const uint32_t full = slot_at + (NSETS == 2 ? C::kWG * 128 * C::kSlot * 4 : 0);
  const uint32_t empty = full + 8 * S, qbar = empty + 8 * S;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * C::kBQ;
  const int tid = threadIdx.x, wg = tid >> 7;
  // skip rows drop the endpoint segments; pure modes never skip (the
  // wrapper passes no skip rows), their stream has no own segment
  const bool skip = NSETS > 0 && p.skip != nullptr && p.skip[b] != 0;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * C::kWG);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C::kWG) {
    // producer warpgroup: one thread issues every copy
    if (C::kWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == C::kWG * 128) {
      mbar_expect_tx(qbar, C::kWG * C::kQBytes);
      for (int w = 0; w < C::kWG; ++w) {
        for (int c = 0; c < C::kChunks; ++c) tma_load(qs + w * C::kQBytes + c * 8192, &qm, qbar, 64 * c, h, q0 + 64 * w, b);
      }
      int it = 0;
      auto segment = [&](const CUtensorMap* kmap, const CUtensorMap* vmap, int len, int kb, int vb) {
        for (int r0 = 0; r0 < len; r0 += BK, ++it) {
          const int st = it % S;
          if (it >= S) mbar_wait(empty + 8 * st, (it / S - 1) & 1);
          const uint32_t kt = kvs + st * C::kStageBytes, bar = full + 8 * st;
          mbar_expect_tx(bar, C::kStageBytes);
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load(kt + c * BK * 128, kmap, bar, 64 * c, h, r0, kb);
            tma_load(kt + C::kKVBytes + c * BK * 128, vmap, bar, 64 * c, h, r0, vb);
          }
        }
      };
      if (HAS_OWN) segment(&km, &vm, p.Lk, b, b);
      if (NSETS > 0 && !skip) {
        segment(&kbm, &vbm, p.Le, p.shared_eps & 1 ? 0 : b, p.shared_eps & 2 ? 0 : b);
        if (NSETS == 2) segment(&kem, &vem, p.Le, p.shared_eps & 4 ? 0 : b, p.shared_eps & 8 ? 0 : b);
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg ...
    if (C::kWG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const uint32_t q = qs + wg * C::kQBytes;
    mbar_wait(qbar, 0);

    State<D> st;
    init_state(st);
    int it = 0;
    auto segment = [&](int len) {
      for (int r0 = 0; r0 < len; r0 += BK, ++it) {
        const int s = it % S;
        mbar_wait(full + 8 * s, (it / S) & 1);
        const uint32_t kt = kvs + s * C::kStageBytes;
        tile_update<T, D>(st, q, kt, kt + C::kKVBytes, min(BK, len - r0), p.scale_log2, p.shift_log2,
                          p.clip_log2);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    };
    if (HAS_OWN) segment(p.Lk);
    if (NSETS == 2 && !skip) {
      // this thread's parked words, one column of (kSlot, 128) per thread (conflict free)
      float* park = slot + wg * 128 * C::kSlot + (tid & 127);
      const float c = p.coef[b];
      if (HAS_OWN) {  // park the own segment's state: the end segment continues it too
#pragma unroll
        for (int i = 0; i < D / 2; ++i) park[i * 128] = st.o[i];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          park[(D / 2 + r) * 128] = st.m[r];
          park[(D / 2 + 2 + r) * 128] = st.l[r];
        }
      }
      segment(p.Le);  // begin
      normalise(st, 1.f - c);
      if (HAS_OWN) {  // exchange (1 - c) O_begin / l with the parked own state
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          const float own = park[i * 128];
          park[i * 128] = st.o[i];
          st.o[i] = own;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          st.m[r] = park[(D / 2 + r) * 128];
          st.l[r] = park[(D / 2 + 2 + r) * 128];
        }
      } else {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) park[i * 128] = st.o[i];
        init_state(st);
      }
      segment(p.Le);  // end
      normalise(st, c);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) st.o[i] += park[i * 128];
    } else {
      if (NSETS == 1 && !skip) segment(p.Le);
      normalise(st, 1.f);
    }

    // T output through this warpgroup's Q tile (its products are done),
    // in the TMA box layout: 128-byte rows, 16-byte chunk j of row r at j ^ (r % 8)
    unsigned char* tile = smem_raw + (q - raw);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t, box = col / 64, chunk = (col % 64) / 8;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + g + 8 * half;
        *reinterpret_cast<uint32_t*>(tile + box * 8192 + r * 128 + ((chunk ^ (r & 7)) * 16) + (col % 8) * 2) =
            Elem<T>::pack(st.o[4 * j + 2 * half], st.o[4 * j + 2 * half + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic stores -> the TMA store's proxy
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if ((tid & 127) == 0) {
      for (int c = 0; c < C::kChunks; ++c) tma_store(&om, q + c * 8192, 64 * c, h, q0 + 64 * wg, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // smem stays until read
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found at run time (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (D, H, S, B) map of a T operand at element strides (b, h, s), boxes
// of 64 columns by `rows` rows, 128-byte swizzle, zeros out of bounds. A
// batch stride of 0 (one tensor shared by every row) becomes a batch extent of 1.
template <class T>
bool encode_map(CUtensorMap* map, const void* ptr, int D, int H, int S, int B, const long long* strides, int rows) {
  const long long sb = strides[0], sh = strides[1], ss = strides[2];
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, sb == 0 ? 1u : (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)(sb == 0 ? ss * S + sh * H : sb) * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1}, unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, Elem<T>::kMapType, 4, const_cast<void*>(ptr), dims, bytes, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class T, int D, bool HAS_OWN, int NSETS>
int launch(const CUtensorMap (&m)[8], const Params& p, int B, int H, cudaStream_t s) {
  using C = Cfg<D>;
  constexpr int smem = C::smem_bytes(NSETS == 2);
  static bool attribute_set = false;  // once per instance and process
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&flash_kernel<T, D, HAS_OWN, NSETS>),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const dim3 grid((p.Sq + C::kBQ - 1) / C::kBQ, H, B);
  flash_kernel<T, D, HAS_OWN, NSETS><<<grid, C::kThreads, smem, s>>>(m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], p);
  return (int)cudaGetLastError();
}

template <class T, int D>
int launch_d(const void* const (&ptrs)[8], const long long* dims, Params& p, int has_own, int n_sets,
             cudaStream_t s) {
  const int B = (int)dims[0], H = (int)dims[1];
  // rows of each map: queries, own keys, endpoint keys x4, queries out
  const int rows[8] = {p.Sq, p.Lk, p.Lk, p.Le, p.Le, p.Le, p.Le, p.Sq};
  const int box[8] = {64, Cfg<D>::kBK, Cfg<D>::kBK, Cfg<D>::kBK, Cfg<D>::kBK, Cfg<D>::kBK, Cfg<D>::kBK, 64};
  CUtensorMap m[8];
  p.shared_eps = 0;
  for (int i = 0; i < 8; ++i) {
    const long long* st = dims + 6 + 3 * i;
    const bool used = i == 0 || i == 7 || (i < 3 ? has_own != 0 : n_sets > 0);
    if (!used) {  // a map the instance never reads: any valid one
      m[i] = m[0];
      continue;
    }
    if (!encode_map<T>(&m[i], ptrs[i], D, H, rows[i], B, st, box[i])) return (int)cudaErrorInvalidValue;
    if (i >= 3 && i < 7 && st[0] == 0) p.shared_eps |= 1 << (i - 3);
  }
  if (has_own && n_sets == 0) return launch<T, D, true, 0>(m, p, B, H, s);
  if (has_own && n_sets == 1) return launch<T, D, true, 1>(m, p, B, H, s);
  if (has_own && n_sets == 2) return launch<T, D, true, 2>(m, p, B, H, s);
  if (!has_own && n_sets == 1) return launch<T, D, false, 1>(m, p, B, H, s);
  if (!has_own && n_sets == 2) return launch<T, D, false, 2>(m, p, B, H, s);
  return (int)cudaErrorInvalidValue;
}

template <class T>
int entry(const void* const (&ptrs)[8], const void* coef, const void* skip, const long long* dims, float scale,
          float shift_log2, float clip_log2, int has_own, int n_sets, void* stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  Params p;
  p.coef = static_cast<const float*>(coef);
  p.skip = static_cast<const uint8_t*>(skip);
  p.Sq = (int)dims[2];
  p.Lk = (int)dims[3];
  p.Le = (int)dims[4];
  p.scale_log2 = scale * 1.4426950408889634f;
  p.shift_log2 = shift_log2;
  p.clip_log2 = clip_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims[5]) {
    case 40: return launch_d<T, 40>(ptrs, dims, p, has_own, n_sets, s);
    case 64: return launch_d<T, 64>(ptrs, dims, p, has_own, n_sets, s);
    case 80: return launch_d<T, 80>(ptrs, dims, p, has_own, n_sets, s);
    case 160: return launch_d<T, 160>(ptrs, dims, p, has_own, n_sets, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#if AID_STATIC_SHIFT
}  // namespace static_shift
using static_shift::entry;
#endif
}  // namespace

#if AID_STATIC_SHIFT
// The static-shift instance over bf16 operands: aid_flash_attn_bf16's
// arguments with the shift C and the clip after the scale, both times
// log2(e) (p = 2^min(s * scale * log2(e) - shift_log2, clip_log2)), every
// mode at D = 40, 64, 80 or 160. Returns the launch's cudaError_t.
extern "C" int aid_flash_attn_bf16_static(const void* q, const void* k, const void* v, const void* kb,
                                          const void* vb, const void* ke, const void* ve, void* out, const void* coef,
                                          const void* skip, const long long* dims, float scale, float shift_log2,
                                          float clip_log2, int has_own, int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__nv_bfloat16>(ptrs, coef, skip, dims, scale, shift_log2, clip_log2, has_own, n_sets, stream);
}
#else
// dims: [B, H, Sq, Lk, Le, D, then (b, h, s) element strides of
//        q, k, v, k_begin, v_begin, k_end, v_end, out]  (30 values); a b
// stride of 0 marks an endpoint shared by every row. Every operand is bf16
// with its head dim contiguous, 16-byte aligned, its other strides
// multiples of 8 elements. coef: (B,) f32, read by the outer modes; skip:
// (B,) bool or null, read by the fused endpoint modes. D must be 40, 64,
// 80 or 160. Returns the launch's cudaError_t (0 on success).
extern "C" int aid_flash_attn_bf16(const void* q, const void* k, const void* v, const void* kb, const void* vb,
                                   const void* ke, const void* ve, void* out, const void* coef, const void* skip,
                                   const long long* dims, float scale, int has_own, int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__nv_bfloat16>(ptrs, coef, skip, dims, scale, 0.f, 0.f, has_own, n_sets, stream);
}

// The same over f16 operands (every one f16, the rest as aid_flash_attn_bf16).
extern "C" int aid_flash_attn_f16(const void* q, const void* k, const void* v, const void* kb, const void* vb,
                                  const void* ke, const void* ve, void* out, const void* coef, const void* skip,
                                  const long long* dims, float scale, int has_own, int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__half>(ptrs, coef, skip, dims, scale, 0.f, 0.f, has_own, n_sets, stream);
}
#endif
