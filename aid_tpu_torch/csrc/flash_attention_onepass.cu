// Flash interpolated attention over short key streams, bf16 and f16, head dims 40/64/80/160, sm_90a.
//
// Replaces the whole-stream-resident Pallas TPU kernel `_kernel_onepass`
// (aid_tpu/ops/flash_attention.py:339, its pallas_call at :991), which the
// JAX wrapper runs for every key stream of up to `onepass_max` keys: the
// 77-token text cross-attention, the IP-Adapter's 4 or 16 image tokens and
// short self calls. Per batch row b, over the stream's segments (own K/V,
// then K_begin and K_end, or the lerped K_cross):
//   self         softmax(q k_b^T) v_b
//   fused_outer  (1-c_b) Attn(q, [k_b; K_begin]) + c_b Attn(q, [k_b; K_end])
//   pure_outer   (1-c_b) Attn(q, K_begin)        + c_b Attn(q, K_end)
//   fused_inner  Attn(q, [k_b; K_cross]),  K_cross = lerp(K_begin, K_end, c_b)
//   pure_inner   Attn(q, K_cross)
// with K_cross / V_cross lerped in f32 by the wrapper (as `pack_stream` does
// on the TPU) and passed in the begin slot. A skip row (fused modes) drops
// its endpoint segments, which makes it exactly vanilla attention.
//
// What bounds it on the card. At (7,10,4096,77) the whole call is ~73 MB of
// q and out against 20 KB of K and V a head: the bytes of q and out bind
// (0.022 ms at 3.35 TB/s), and the products and exponentials of a 77-key
// stream (one MUFU op a score) sit below them. The streaming kernel
// (flash_interpolated_attention.cu) spends a block on one query tile and one
// 128-key tile, each block fetching the same keys again, with one block an
// SM and nothing to hide its load-compute-store chain. This design:
//   * the whole stream of one (b, h) is resident in shared memory, loaded
//     once by TMA: the own K/V, then each endpoint segment, each padded to
//     whole 16-key tiles (77 keys -> 80 rows, 16 -> 16, 4 -> 16; rows past a
//     segment are the map's zero fill), laid out back to back as one stream
//     of 16 * KT rows (KT from kStreamTiles, the instance's tiles). Shared
//     (H, Le, D) endpoints are read through a map of batch extent 1;
//   * query tiles loop over the resident stream. The flattened (b, h, query
//     tile) space is cut into one contiguous run a block, as many blocks as
//     the SMs hold at once (occupancy from the runtime), so every SM gets an
//     equal share; a block reloads the stream where its run crosses into the
//     next (b, h). A block is one to three consumer warpgroups of 64 query
//     rows each (up to two past D = 64), sharing one copy of the stream: the
//     host takes the count that keeps the most real query rows an SM. More
//     warpgroups an SM also hide more of each tile's chain of loads,
//     products and softmax, whose latency the ablation found to bind the
//     240-key stream (tools/onepass_ablation.py);
//   * each warpgroup keeps a ring of Q/O buffers (three up to D = 64, two
//     above, whose larger buffers would cost blocks an SM): a tile's Q
//     arrives by TMA two tiles ahead (one above D = 64), its output is
//     staged in the same buffer and leaves by a TMA store, and the read-wait
//     on that store comes only before the buffer is loaded again, a tile
//     later;
//   * one pass over the stream, no online rescale (`_kernel_onepass`'s
//     segment-decomposed softmax, flash_attention.py:385-402): S = Q K^T is
//     one wgmma m64n(16 KT)k16 per k16 step over the whole stream, K and Q
//     K-major in shared memory. Each segment takes its exact row maximum
//     (masking only its ragged last tile), exp2 with log2(e) folded into the
//     scale, and its row sum. The sets then combine at row granularity:
//     self one set {own}; the inner modes {own, cross}; the outer modes set
//     0 = {own, begin} and set 1 = {own, end}, blended (1-c) O_0 + c O_1.
//     Each segment's weight in the blend is a per-row scalar (its exp2(m_seg -
//     M_set) / L_set times the set's blend weight, summed over the sets it
//     is in), folded into P before P is rounded to T, so O = sum_seg P_seg
//     V_seg is one accumulator: the own segment's P V is computed once and
//     shared by both sets, and nothing is parked or swapped;
//   * P V is wgmma m64nDk16 with P from the S registers (the S accumulator
//     layout is the A-fragment layout of P) and V as B in its row-major
//     tile through the descriptor's transpose bit.
// A skip row's endpoint segments are loaded as any row's (from L2: shared
// endpoints are small) and masked whole; the instance's tiles past the
// stream are zeroed once a block, so their P V adds zeros. The tensor maps
// are encoded on the host (tma_sm90.cuh, no -lcuda at link time) and cached
// (map_cache.cuh). Measured times, bounds and the route before them are in
// PERF.md.
//
// One design, two element types (elem16.cuh): T = __nv_bfloat16 is
// aid_flash_attn_bf16_onepass, T = __half is aid_flash_attn_f16_onepass.
// They differ in the wgmma type suffix, the tensor maps' data type and the
// rounding of P and of the output; every mask and max stays on the f32
// scores. The C signature is aid_flash_attn_bf16's.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

#include "elem16.cuh"
#include "tma_sm90.cuh"
#include "map_cache.cuh"

// The instances and their buffers (ops/flash_attention.py and
// tests/test_torch_onepass.py read these lines): the stream's 16-key tiles an
// instance holds (a stream takes the first at or above its own count), the
// shared memory a block can use, and by head dim, up to kNarrowD and above:
// the Q/O buffers a warpgroup (Q two tiles ahead, or one: the 16-24 KB
// buffers past 64 columns leave room for more blocks an SM) and the consumer
// warpgroups a block at most (three fit 168 registers a thread up to 64
// columns).
constexpr int kStreamTiles[] = {1, 3, 5, 10, 15};
constexpr int kSmemLimit = 232448;
constexpr int kNarrowD = 64;
constexpr int kRingNarrow = 3, kRingWide = 2;
constexpr int kWGNarrow = 3, kWGWide = 2;

template <int D, int KT>
struct Onepass {
  static constexpr int kChunks = (D + 63) / 64;          // 64-column boxes of a row
  static constexpr int kKSteps = (D + 15) / 16;          // k16 steps of Q K^T
  static constexpr int kRows = 16 * KT;                  // key rows of the resident stream
  static constexpr int kBox = kRows * 128;               // one 64-column box of K (or V)
  static constexpr int kKVBytes = kChunks * kBox;        // K (or V)
  static constexpr int kQBytes = kChunks * 64 * 128;     // one Q/O buffer of 64 rows
  static constexpr int kRing = D <= kNarrowD ? kRingNarrow : kRingWide;  // Q/O buffers a warpgroup
  static constexpr int smem_bytes(int nwg) { return 1024 + 2 * kKVBytes + nwg * kRing * kQBytes + 8 * (1 + kRing * nwg); }
  static constexpr bool kFits = smem_bytes(1) <= kSmemLimit;
  static constexpr int kWGLimit = D <= kNarrowD ? kWGNarrow : kWGWide;
  static constexpr int kMaxWG = kWGLimit == 3 && smem_bytes(3) <= kSmemLimit ? 3 : smem_bytes(2) <= kSmemLimit ? 2 : 1;
  static_assert(D % 8 == 0 && KT * 16 <= 256, "wgmma N and the TMA box");
};

struct Params {
  const float* coef;    // (B,) f32, read by the outer modes
  const uint8_t* skip;  // (B,) bool or null, read by the fused endpoint modes
  int H, Sq, Lk, Le;
  int has_own, n_sets;  // the own segment leads the stream; 0, 1 (cross) or 2 (begin, end) endpoint segments
  int nt_own, nt_ep;    // 16-key tiles of the own segment and of each endpoint segment
  int shared_eps;       // bit i: endpoint map i (k_begin, v_begin, k_end, v_end) is one (H, Le, D) tensor
  int tiles;            // query tiles of 64 * nwg rows a (b, h)
  int units;            // B * H * tiles
  float scale_log2;     // softmax scale * log2(e)
};

// wgmma descriptor of a 128-byte-swizzled tile (8-row groups 1024 bytes
// apart, SBO): K-major operands (Q, K) step along K by moving the start 32
// bytes within a row; the MN-major V steps to its next 64 columns by LBO
// (one box of the stream) and along K (keys) by whole 8-row groups.
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

// x, which the compiler cannot see through: the stream's descriptors are
// made where each product is issued, not held in registers across the loop
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.u32 %0, %0;" : "+r"(x));
  return x;
}

// A parameter the tile loop's segment logic reads. In the instances of
// kRecomputeTiles tiles, whose scores take most of the 168 registers three
// warpgroups a block leave, it goes through opaque(), so the compiler makes
// each tile's per-segment values where they are used instead of keeping
// fifteen of them in local memory across the loop (measured: fused_outer
// (7,10,4096,77) 0.0845 ms against 0.091, tools/attention_bench.py); the
// smaller instances keep them in registers, which their loop runs faster on.
constexpr int kRecomputeTiles = 15;
template <int KT>
__device__ __forceinline__ int per_tile(int x) {
  if constexpr (KT >= kRecomputeTiles) {
    return (int)opaque((uint32_t)x);
  } else {
    return x;
  }
}

// One box from shared memory into a (D, H, S, B) map; parts out of bounds are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}

// S(64 x 16, f32) (+)= Q(64 x 16) K(16 x 16): both K-major in shared memory
template <class T>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])  \
      : "l"(da), "l"(db), "r"(scale_d))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// S(64 x 48, f32) (+)= Q(64 x 16) K(16 x 48): both K-major in shared memory
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

// S(64 x 80, f32) (+)= Q(64 x 16) K(16 x 80): both K-major in shared memory
template <class T>
__device__ __forceinline__ void wgmma_ss(float (&d)[40], uint64_t da, uint64_t db, int scale_d) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])  \
      : "l"(da), "l"(db), "r"(scale_d))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// S(64 x 160, f32) (+)= Q(64 x 16) K(16 x 160): both K-major in shared memory
template <class T>
__device__ __forceinline__ void wgmma_ss(float (&d)[80], uint64_t da, uint64_t db, int scale_d) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n160k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, %80, %81, p, 1, 1, 0, 0;\n}\n"  \
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
      : "l"(da), "l"(db), "r"(scale_d))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// S(64 x 240, f32) (+)= Q(64 x 16) K(16 x 240): both K-major in shared memory
template <class T>
__device__ __forceinline__ void wgmma_ss(float (&d)[120], uint64_t da, uint64_t db, int scale_d) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %122, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n240k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119}, %120, %121, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),  \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),  \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),  \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),  \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),  \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),  \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),  \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119])  \
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



// A row's segments (0 own, 1 begin or cross, 2 end) over the stream's 16-key
// tiles: the first tile of segments 1 and 2, whether segment 2 exists, and
// each segment's real keys (0 where dropped).
struct Segments {
  int first1, first2, has2, len0, len1, len2;
};

__device__ __forceinline__ int segment_of(int j, const Segments& g) {
  return j < g.first1 ? 0 : (j < g.first2 || !g.has2) ? 1 : 2;
}

// the keys of tile j of its segment that are real (<= 0: none; the rest are masked)
__device__ __forceinline__ int tile_keys(int j, const Segments& g) {
  const int seg = segment_of(j, g);
  return seg == 0 ? g.len0 - 16 * j : seg == 1 ? g.len1 - 16 * (j - g.first1) : g.len2 - 16 * (j - g.first2);
}

// x[seg] of a per-segment triple, as selects (seg is uniform; no local memory)
__device__ __forceinline__ float pick(const float (&x)[3], int seg) {
  return seg == 0 ? x[0] : seg == 1 ? x[1] : x[2];
}

// One row's weight of each segment in the output, from the segments' maxima
// (exp2 domain, -inf where a segment is empty) and row sums: self and skip
// rows the own segment alone; the inner modes one set {own, cross}; the
// outer modes (1 - c) {own, begin} + c {own, end}, the own segment in both
__device__ __forceinline__ void set_weights(const float (&ms)[3], const float (&l)[3], int n_sets, bool skip, float cf,
                                            float (&w)[3]) {
  if (n_sets == 0 || skip) {
    w[0] = 1.f / l[0];
    w[1] = w[2] = 0.f;
  } else if (n_sets == 1) {
    const float top = fmaxf(ms[0], ms[1]), a0 = ex2(ms[0] - top), a1 = ex2(ms[1] - top);
    const float inv = 1.f / (l[0] * a0 + l[1] * a1);
    w[0] = a0 * inv;
    w[1] = a1 * inv;
    w[2] = 0.f;
  } else {
    const float top0 = fmaxf(ms[0], ms[1]), top1 = fmaxf(ms[0], ms[2]);
    const float a0 = ex2(ms[0] - top0), a1 = ex2(ms[1] - top0), b0 = ex2(ms[0] - top1), b2 = ex2(ms[2] - top1);
    const float i0 = (1.f - cf) / (l[0] * a0 + l[1] * a1), i1 = cf / (l[0] * b0 + l[2] * b2);
    w[0] = a0 * i0 + b0 * i1;
    w[1] = a1 * i0;
    w[2] = b2 * i1;
  }
}

// Maps: q, k, v, k_begin, v_begin, k_end, v_end, out. Grid: one block a run of
// query tiles; block: nwg consumer warpgroups (1 or 2).
template <class T, int D, int KT>
__global__ void __launch_bounds__(128 * Onepass<D, KT>::kWGLimit, 1)
    onepass_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                   const __grid_constant__ CUtensorMap vm, const __grid_constant__ CUtensorMap kbm,
                   const __grid_constant__ CUtensorMap vbm, const __grid_constant__ CUtensorMap kem,
                   const __grid_constant__ CUtensorMap vem, const __grid_constant__ CUtensorMap om, const Params p) {
  using C = Onepass<D, KT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte-swizzled tiles are 1024-byte aligned
  const int nwg = blockDim.x >> 7, BQ = 64 * nwg;
  const uint32_t ks = base, vs = ks + C::kKVBytes, rings = vs + C::kKVBytes;
  const uint32_t kvbar = rings + nwg * C::kRing * C::kQBytes;
  const int tid = threadIdx.x, wg = tid >> 7, ltid = tid & 127;
  const int warp = ltid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t ring = rings + wg * C::kRing * C::kQBytes, full = kvbar + 8 + 8 * C::kRing * wg;
  // this block's run of (b, h, query tile) units
  const int u0 = (int)((long long)blockIdx.x * p.units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * p.units / gridDim.x);

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int i = 0; i < C::kRing * nwg; ++i) mbar_init(kvbar + 8 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the instance's tiles past the stream are masked whole and never loaded:
  // zeroed once, their P V adds zeros (never a stale NaN). Each of the 2
  // kChunks boxes of K and V has `pad` such 16-byte words past the stream
  const int pad = (C::kRows - 16 * (p.nt_own + p.n_sets * p.nt_ep)) * 8;
  for (int i = tid; i < 2 * C::kChunks * pad; i += blockDim.x) {
    const uint32_t at = ks + (i / pad) * C::kBox + C::kBox - 16 * pad + 16 * (i % pad);
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0) : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros before the TMA writes
  __syncthreads();

  const CUtensorMap *qmap = &qm, *kmap = &km, *vmap = &vm, *kbmap = &kbm, *vbmap = &vbm, *kemap = &kem,
                    *vemap = &vem;
  // tile i of this warpgroup (unit u) into its ring buffer
  auto load_q = [&](int i, int u) {
    const int bh = u / p.tiles, q0 = (u - bh * p.tiles) * BQ + 64 * wg;
    const uint32_t buf = ring + (i % C::kRing) * C::kQBytes, bar = full + 8 * (i % C::kRing);
    mbar_expect_tx(bar, C::kQBytes);
    for (int c = 0; c < C::kChunks; ++c) tma_load(buf + c * 8192, qmap, bar, 64 * c, bh % p.H, q0, bh / p.H);
  };
  // the stream of (b, h): the own segment, then the endpoint segments
  auto load_stream = [&](int b, int h) {
    const int own_rows = 16 * p.nt_own, ep_rows = 16 * p.nt_ep, n_eps = p.n_sets;
    mbar_expect_tx(kvbar, 2 * C::kChunks * 128 * (own_rows + n_eps * ep_rows));
    for (int c = 0; c < C::kChunks; ++c) {
      const uint32_t kc = ks + c * C::kBox, vc = vs + c * C::kBox;
      if (p.has_own) {
        tma_load(kc, kmap, kvbar, 64 * c, h, 0, b);
        tma_load(vc, vmap, kvbar, 64 * c, h, 0, b);
      }
      for (int e = 0; e < n_eps; ++e) {
        const uint32_t off = (own_rows + e * ep_rows) * 128;
        tma_load(kc + off, e ? kemap : kbmap, kvbar, 64 * c, h, 0, p.shared_eps & (1 << (2 * e)) ? 0 : b);
        tma_load(vc + off, e ? vemap : vbmap, kvbar, 64 * c, h, 0, p.shared_eps & (2 << (2 * e)) ? 0 : b);
      }
    }
  };

  if (ltid == 0) {  // Q as many tiles ahead as the ring has buffers but one
    for (int a = 0; a < C::kRing - 1 && u0 + a < u1; ++a) load_q(a, u0 + a);
  }
  int held = -1, loads = 0;
  for (int u = u0, i = 0; u < u1; ++u, ++i) {
    const int bh = u / p.tiles, b = bh / p.H, h = bh - b * p.H, q0 = (u - bh * p.tiles) * BQ + 64 * wg;
    const bool skip = p.n_sets > 0 && p.skip != nullptr && p.skip[b] != 0;
    if (bh != held) {  // every warpgroup of the block reaches the same units: reload the stream together
      if (held >= 0) __syncthreads();  // the products over the held stream are done
      if (tid == 0) load_stream(b, h);
      mbar_wait(kvbar, loads & 1);
      ++loads;
      held = bh;
    }
    const uint32_t q = ring + (i % C::kRing) * C::kQBytes;
    mbar_wait(full + 8 * (i % C::kRing), (i / C::kRing) & 1);

    // S = Q K^T over the whole stream, k16 steps over the (zero-padded) head dim
    float s[8 * KT];
    const uint32_t kst = opaque(ks);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kKSteps; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<T>(s, desc_sw128(q + (kk / 4) * 8192 + off, 16), desc_sw128(kst + (kk / 4) * C::kBox + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(s);

    // each segment's exact row max; keys past a segment's length (its ragged
    // last tile, a dropped segment, the tiles past the stream) are masked
    const float neg = -INFINITY;
    const int le = skip ? 0 : per_tile<KT>(p.Le), sets = per_tile<KT>(p.n_sets);
    const Segments segs = {per_tile<KT>(p.nt_own), per_tile<KT>(p.nt_own + p.nt_ep), sets == 2, per_tile<KT>(p.Lk),
                           sets >= 1 ? le : 0, sets == 2 ? le : 0};
    float mx0[3] = {neg, neg, neg}, mx1[3] = {neg, neg, neg};
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int seg = segment_of(j, segs);
      const int lim = tile_keys(j, segs);
      if (lim < 16) {  // the segment's last tile, or a tile with no key of it
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if ((e / 4) * 8 + 2 * t + (e & 1) >= lim) s[8 * j + e] = neg;
        }
      }
      float a = neg, c = neg;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e & 2) {
          c = fmaxf(c, s[8 * j + e]);
        } else {
          a = fmaxf(a, s[8 * j + e]);
        }
      }
#pragma unroll
      for (int sg = 0; sg < 3; ++sg) {
        if (seg == sg) {
          mx0[sg] = fmaxf(mx0[sg], a);
          mx1[sg] = fmaxf(mx1[sg], c);
        }
      }
    }
    // in the exp2 domain: -inf for an empty segment; its exps take 0 instead
    float ms0[3], ms1[3], safe0[3], safe1[3];
#pragma unroll
    for (int sg = 0; sg < 3; ++sg) {
      ms0[sg] = quad_max(mx0[sg]) * p.scale_log2;
      ms1[sg] = quad_max(mx1[sg]) * p.scale_log2;
      safe0[sg] = ms0[sg] == neg ? 0.f : ms0[sg];
      safe1[sg] = ms1[sg] == neg ? 0.f : ms1[sg];
    }
    float l0[3] = {0.f, 0.f, 0.f}, l1[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int seg = segment_of(j, segs);
      const float m0 = pick(safe0, seg), m1 = pick(safe1, seg);
      float a = 0.f, c = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float x = ex2(fmaf(s[8 * j + e], p.scale_log2, -((e & 2) ? m1 : m0)));
        s[8 * j + e] = x;
        if (e & 2) {
          c += x;
        } else {
          a += x;
        }
      }
#pragma unroll
      for (int sg = 0; sg < 3; ++sg) {
        if (seg == sg) {
          l0[sg] += a;
          l1[sg] += c;
        }
      }
    }
    // the sets at row granularity: each segment's weight in the output
    const float cf = p.n_sets == 2 && !skip ? p.coef[b] : 0.f;
    const float ls0[3] = {quad_sum(l0[0]), quad_sum(l0[1]), quad_sum(l0[2])};
    const float ls1[3] = {quad_sum(l1[0]), quad_sum(l1[1]), quad_sum(l1[2])};
    float w0[3], w1[3];
    set_weights(ms0, ls0, p.n_sets, skip, cf, w0);
    set_weights(ms1, ls1, p.n_sets, skip, cf, w1);
    // P weighted in f32, rounded to T: keys 16 j .. 16 j + 15 are the A fragment of k-step j
    uint32_t pa[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int seg = segment_of(j, segs);
      const float x0 = pick(w0, seg), x1 = pick(w1, seg);
      pa[j][0] = Elem<T>::pack(s[8 * j] * x0, s[8 * j + 1] * x0);
      pa[j][1] = Elem<T>::pack(s[8 * j + 2] * x1, s[8 * j + 3] * x1);
      pa[j][2] = Elem<T>::pack(s[8 * j + 4] * x0, s[8 * j + 5] * x0);
      pa[j][3] = Elem<T>::pack(s[8 * j + 6] * x1, s[8 * j + 7] * x1);
    }
    // O = P V over the whole stream: 16 keys (two 8-row groups, 2048 bytes) a step; V's next box is LBO away
    float o[D / 2];
#pragma unroll
    for (int k = 0; k < D / 2; ++k) o[k] = 0.f;
    const uint32_t vst = opaque(vs);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KT; ++j) wgmma_rs<T>(o, pa[j], desc_sw128(vst + j * 2048, C::kBox));
    wgmma_commit();
    wgmma_wait0();
    reg_fence(o);
    reg_fence(pa);

    // T output through this tile's buffer (its Q K^T is done), in the TMA
    // box layout: 128-byte rows, 16-byte chunk j of row r at j ^ (r % 8)
    unsigned char* tile = smem_raw + (q - raw);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t, box = col / 64, chunk = (col % 64) / 8;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + g + 8 * half;
        *reinterpret_cast<uint32_t*>(tile + box * 8192 + r * 128 + ((chunk ^ (r & 7)) * 16) + (col % 8) * 2) =
            Elem<T>::pack(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic stores -> the TMA store's proxy
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (ltid == 0) {
      for (int c = 0; c < C::kChunks; ++c) tma_store(&om, q + c * 8192, 64 * c, h, q0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (u + C::kRing - 1 < u1) {  // into the buffer of tile i - 1, once its store has read it
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        load_q(i + C::kRing - 1, u + C::kRing - 1);
      }
    }
  }
  if (ltid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One launch of the instance: one or two warpgroups a block, and as many
// blocks as the SMs hold at once (the runtime's occupancy for this instance),
// capped at the units of work
template <class T, int D, int KT>
int launch(const CUtensorMap (&m)[8], Params& p, int B, int H, cudaStream_t s) {
  using C = Onepass<D, KT>;
  const void* kernel = reinterpret_cast<const void*>(&onepass_kernel<T, D, KT>);
  static bool smem_set = false;
  static int sms = 0, per_sm[4] = {0, 0, 0, 0};  // once per instance and process
  const cudaError_t err = allow_smem_once(kernel, C::smem_bytes(C::kMaxWG), smem_set);
  if (err != cudaSuccess) return (int)err;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    for (int w = 1; w <= C::kMaxWG; ++w) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[w], kernel, 128 * w, C::smem_bytes(w));
    }
  }
  // the warpgroups a block that hold the most query rows an SM at once (the
  // warpgroups it holds times the share of their rows that are real, past
  // Sq padding); ties to more warpgroups, which share one copy of the stream
  int nwg = 1;
  double best = 0.0;
  for (int w = 1; w <= C::kMaxWG; ++w) {
    const int t = (p.Sq + 64 * w - 1) / (64 * w);
    const double real = w * per_sm[w] * (double)p.Sq / (64.0 * w * t);
    if (real >= best) {
      best = real;
      nwg = w;
    }
  }
  p.tiles = (p.Sq + 64 * nwg - 1) / (64 * nwg);
  p.units = B * H * p.tiles;
  const int blocks = per_sm[nwg] * sms < p.units ? per_sm[nwg] * sms : p.units;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  onepass_kernel<T, D, KT><<<blocks, 128 * nwg, C::smem_bytes(nwg), s>>>(m[0], m[1], m[2], m[3], m[4], m[5], m[6],
                                                                          m[7], p);
  return (int)cudaGetLastError();
}

template <class T, int D, int KT>
int launch_fit(const CUtensorMap (&m)[8], Params& p, int B, int H, cudaStream_t s) {
  if constexpr (Onepass<D, KT>::kFits) {
    return launch<T, D, KT>(m, p, B, H, s);
  } else {  // the stream and one warpgroup's ring are over the 227 KB: the route never sends it
    return (int)cudaErrorInvalidValue;
  }
}

template <class T, int D>
int launch_d(const CUtensorMap (&m)[8], Params& p, int B, int H, int kt, cudaStream_t s) {
  switch (kt) {
    case 1: return launch_fit<T, D, 1>(m, p, B, H, s);
    case 3: return launch_fit<T, D, 3>(m, p, B, H, s);
    case 5: return launch_fit<T, D, 5>(m, p, B, H, s);
    case 10: return launch_fit<T, D, 10>(m, p, B, H, s);
    case 15: return launch_fit<T, D, 15>(m, p, B, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class T>
int entry(const void* const (&ptrs)[8], const void* coef, const void* skip, const long long* dims, float scale,
          int has_own, int n_sets, void* stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  const int B = (int)dims[0], H = (int)dims[1], D = (int)dims[5];
  if (n_sets < 0 || n_sets > 2 || (!has_own && n_sets == 0)) return (int)cudaErrorInvalidValue;
  Params p;
  p.coef = static_cast<const float*>(coef);
  p.skip = static_cast<const uint8_t*>(skip);
  p.H = H;
  p.Sq = (int)dims[2];
  p.Lk = (int)dims[3];
  p.Le = (int)dims[4];
  p.has_own = has_own != 0;
  p.n_sets = n_sets;
  p.nt_own = p.has_own ? (p.Lk + 15) / 16 : 0;
  p.nt_ep = n_sets > 0 ? (p.Le + 15) / 16 : 0;
  p.scale_log2 = scale * 1.4426950408889634f;
  const int nt = p.nt_own + n_sets * p.nt_ep;
  int kt = 0;
  for (int c : kStreamTiles) {
    if (kt == 0 && nt <= c) kt = c;
  }
  if (kt == 0) return (int)cudaErrorInvalidValue;  // a stream longer than the largest instance holds
  // rows of each map and of its box: queries, own keys, endpoint keys x4, queries out
  const int rows[8] = {p.Sq, p.Lk, p.Lk, p.Le, p.Le, p.Le, p.Le, p.Sq};
  const int box[8] = {64, 16 * p.nt_own, 16 * p.nt_own, 16 * p.nt_ep, 16 * p.nt_ep, 16 * p.nt_ep, 16 * p.nt_ep, 64};
  CUtensorMap m[8];
  p.shared_eps = 0;
  for (int i = 0; i < 8; ++i) {
    const long long* st = dims + 6 + 3 * i;
    const bool used = i == 0 || i == 7 || (i < 3 ? p.has_own : i < 5 ? n_sets > 0 : n_sets == 2);
    if (!used) {  // a map the call never reads: any valid one
      m[i] = m[0];
      continue;
    }
    if (!encode_map_cached(&m[i], Elem<T>::kMapType, 2, ptrs[i], D, H, rows[i], B, st, 64, box[i])) {
      return (int)cudaErrorInvalidValue;
    }
    if (i >= 3 && i < 7 && st[0] == 0) p.shared_eps |= 1 << (i - 3);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return launch_d<T, 40>(m, p, B, H, kt, s);
    case 64: return launch_d<T, 64>(m, p, B, H, kt, s);
    case 80: return launch_d<T, 80>(m, p, B, H, kt, s);
    case 160: return launch_d<T, 160>(m, p, B, H, kt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dims: [B, H, Sq, Lk, Le, D, then (b, h, s) element strides of
//        q, k, v, k_begin, v_begin, k_end, v_end, out]  (30 values), as
// aid_flash_attn_bf16 takes them; a b stride of 0 marks an endpoint shared
// by every row. Every operand is bf16 with its head dim contiguous, 16-byte
// aligned, its other strides multiples of 8 elements. coef: (B,) f32, read
// by the outer modes; skip: (B,) bool or null, read by the fused endpoint
// modes. D must be 40, 64, 80 or 160, and the stream (the own segment and
// each endpoint segment, each in whole 16-key tiles) at most the largest of
// kStreamTiles, with its instance inside the shared memory. Returns the
// launch's cudaError_t (0 on success).
extern "C" int aid_flash_attn_bf16_onepass(const void* q, const void* k, const void* v, const void* kb,
                                           const void* vb, const void* ke, const void* ve, void* out, const void* coef,
                                           const void* skip, const long long* dims, float scale, int has_own,
                                           int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__nv_bfloat16>(ptrs, coef, skip, dims, scale, has_own, n_sets, stream);
}

// The same over f16 operands (every one f16, the rest as aid_flash_attn_bf16_onepass).
extern "C" int aid_flash_attn_f16_onepass(const void* q, const void* k, const void* v, const void* kb,
                                          const void* vb, const void* ke, const void* ve, void* out, const void* coef,
                                          const void* skip, const long long* dims, float scale, int has_own,
                                          int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__half>(ptrs, coef, skip, dims, scale, has_own, n_sets, stream);
}
