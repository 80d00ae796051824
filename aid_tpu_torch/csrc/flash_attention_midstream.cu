// Flash interpolated attention over mid-length key streams, bf16 and f16, head dims 64 and 80, sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel_onepass` (aid_tpu/ops/flash_attention.py:339,
// its pallas_call at :991) for the streams it takes past what the short-stream
// kernel (flash_attention_onepass.cu) holds in shared memory: the JAX wrapper
// sends every stream of up to `onepass_max` = 3072 keys there
// (flash_attention.py:709-715, 869-886), which routes SDXL's 1024-token self
// calls (60 of a UNet forward's 70 self-attentions, 20 heads at D = 64) and
// their warmup fused_outer calls (own, begin and end: 3072 keys), SD 2.1's
// 576-token calls and SD 1.5's 1024-token level (D = 80). Per batch row b,
// over the stream's segments (own K/V, then K_begin and K_end, or the lerped
// K_cross):
//   self         softmax(q k_b^T) v_b
//   fused_outer  (1-c_b) Attn(q, [k_b; K_begin]) + c_b Attn(q, [k_b; K_end])
//   pure_outer   (1-c_b) Attn(q, K_begin)        + c_b Attn(q, K_end)
//   fused_inner  Attn(q, [k_b; K_cross]),  K_cross = lerp(K_begin, K_end, c_b)
//   pure_inner   Attn(q, K_cross)
// with K_cross / V_cross lerped in f32 by the wrapper and passed in the begin
// slot. A skip row (fused modes) drops its endpoint segments: vanilla
// attention.
//
// What bounds it on the card. At (7,20,1024,64) a self call is 37.6 GFLOP of
// products (0.038 ms at 989 TFLOP/s) and 147 M exponentials (one MUFU op a
// score, about as long again at D = 64) against 37 MB of q, k, v and out:
// operations bind. The streaming kernel (flash_interpolated_attention.cu,
// designed for 4096 keys) loses there for four reasons this design answers:
//   * padded query rows: its 192-row blocks cut 1024 rows into 6 tiles, 11%
//     of them padding, computed. Here a block is three consumer warpgroups
//     of 64 query rows (two at D = 80), a work item 192 rows, and a
//     warpgroup whose rows are all past Sq skips the products and the
//     softmax (it only waits for each K/V stage and frees it), so padding
//     costs no work; three warpgroups a block measured faster than two
//     128-row warpgroups with no padding at all;
//   * waves: its grid of 840 one-block-an-SM blocks runs 6.36 waves, rounded
//     up to 7. Here the grid is persistent: as many blocks as the SMs hold
//     (one an SM) walk one list of (head, batch row, query tile) work items.
//     Items differ in work: a skip row's stream is a third of a fused_outer
//     row's, and the last query tile of a (b, h) may leave warpgroups idle.
//     So the list puts the heavy items first (rows that keep their
//     endpoints, then skip rows; within each, the full tiles, then the last
//     ones; head-major within a class, so the blocks running at one time
//     read one head's shared endpoint tiles from L2), and block i takes
//     position i of even rounds and grid - 1 - i of odd ones (a snake): the
//     longest-first greedy order, worked out by each block from the call's
//     shape and skip rows alone, so no state outlives a launch;
//   * fill and drain: each of its blocks loads Q, fills its ring and drains
//     around only 8 key tiles (self) or 24 (fused_outer). Here one producer
//     thread runs ahead across work items: the next item's Q goes into a
//     ring of Q/O buffers and its first K/V stages into the K/V ring while
//     the consumers finish the current item; the output leaves through the
//     item's Q buffer by a TMA store, waited on only before the buffer is
//     loaded again (kRing buffers; with two, right after the store);
//   * K/V reads from L2: each of its blocks reads its (b, h)'s whole K and V
//     (215 MB a self call, 645 MB a fused_outer call). Here, at 192 rows an
//     item, each K/V tile is read once for three warpgroups. Two more
//     K/V-sharing schemes measured slower and are not in this source
//     (tools/midstream_switches.patch puts them back for
//     tools/midstream_ablation.py): clusters of two 128-row blocks on
//     neighbouring SMs taking two query tiles of one (b, h), each K/V stage
//     loaded once, half by each block by TMA multicast into both (33-75%
//     slower: the pair moves in lockstep); and, in two-warpgroup blocks,
//     FA3's overlap of a tile's softmax with the next tile's Q K^T and this
//     one's P V within each warpgroup (17-22% slower).
// Each consumer warpgroup runs the streaming kernel's tile step (measured
// there and again here: warpgroups interleaving by themselves beat the
// intra-warpgroup overlap of softmax and P V): S = Q K^T as wgmma m64nBKk16
// with Q and K K-major in shared memory, the online softmax in f32 (exp2 with
// log2(e) folded into the scale), O += P V as wgmma m64nDk16 with P from the
// S registers and V through the descriptor's transpose bit. The outer modes
// keep one accumulator set: the own segment is computed once, its state (O,
// max, sum) parked in this thread's words of shared memory, continued by the
// begin segment to (1-c) O / l, which is swapped with the parked state and
// the end segment continues that. Every operand arrives through a tensor map
// over the caller's (B, S, H*D) projections viewed as (D, H, S, B) (64-column
// boxes, the 128-byte swizzle, zeros past D and past a segment); shared (H,
// Le, D) endpoints through a map of batch extent 1. The maps are encoded on
// the host (tma_sm90.cuh) and cached (map_cache.cuh). What binds after all
// this is each warpgroup's chain of Q K^T, softmax and P V: taking out any
// one of the three saves 9-17% (tools/midstream_ablation.py), no pipe is
// saturated. Measured times, bounds and the route before it are in PERF.md.
//
// One design, two element types (elem16.cuh): T = __nv_bfloat16 is
// aid_flash_attn_bf16_midstream, T = __half is aid_flash_attn_f16_midstream.
// The C signature is aid_flash_attn_bf16's.
//
// The static-shift softmax (`static_smax`, the static branch of
// `_kernel_onepass` at flash_attention.py:520-545) is this body built with
// AID_STATIC_SHIFT = 1 by flash_attention_midstream_static.cu, a
// translation unit of its own: bf16, D = 64, the four endpoint modes (NSETS
// 1 and 2; self mode stays exact, as the JAX wrapper keeps `_kernel_onepass`'s
// self calls), entry aid_flash_attn_bf16_midstream_static. Each tile's P
// is ex2(min(s * scale_log2 - shift_log2, clip_log2)) with the shift C and
// the 30-nat clip in log2 units: no row max, no quad reduction, no rescale
// of O between Q K^T and P V; P V and l add up, the outer modes' park is
// kept, and each row's sum is guarded (max(l, 1e-37)) as the JAX kernels'
// denominator is.

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

// The shared memory a block can use (ops/flash_attention.py and
// tests/test_torch_midstream.py read this line and the Mid lines below).
constexpr int kSmemLimit = 232448;

// By head dim: keys a K/V tile, K/V stages in the ring at two consumer
// warpgroups (one fewer at three), Q/O buffers in the ring, and the most
// consumer warpgroups (64 query rows each) a block.
template <int D> struct Mid;
template <> struct Mid<64> { static constexpr int kBK = 128, kStages = 3, kRing = 3, kMaxWG = 3; };
template <> struct Mid<80> { static constexpr int kBK = 64, kStages = 3, kRing = 2, kMaxWG = 2; };

template <int D, int NWG>
struct Cfg {
  static constexpr int kBK = Mid<D>::kBK, kStages = Mid<D>::kStages - (NWG == 3), kRing = Mid<D>::kRing;
  static constexpr int kThreads = 128 * (NWG + 1);       // + the producer warpgroup
  // registers a consumer thread takes from the producer's (24): 65536 in all
  static constexpr int kConsumerRegs = NWG == 3 ? 160 : 240;
  static constexpr int kChunks = (D + 63) / 64;          // 64-column boxes of a row
  static constexpr int kQWG = 64 * 128 * kChunks;        // one warpgroup's 64 Q (or O) rows
  static constexpr int kQBytes = NWG * kQWG;             // one Q/O buffer: a work item's rows
  static constexpr int kKVBytes = kBK * 128 * kChunks;   // one K (or V) tile
  static constexpr int kStageBytes = 2 * kKVBytes;       // K then V
  static constexpr int kSlot = D / 2 + 4;                // parked words a thread: O, m[2], l[2]
  static constexpr int kParkBytes = NWG * 128 * kSlot * 4;
  static constexpr int kSmem = 1024 + kRing * kQBytes + kStages * kStageBytes + kParkBytes + 8 * (2 * kStages + 3 * kRing);
  static_assert(D % 8 == 0 && kBK % 16 == 0 && NWG <= Mid<D>::kMaxWG, "wgmma N and K steps");
  static_assert(kSmem <= kSmemLimit, "over the 227 KB a block can use");
};

struct Params {
  const float* coef;    // (B,) f32, read by the outer modes
  const uint8_t* skip;  // (B,) bool or null, read by the fused endpoint modes
  int B, H, Sq, Lk, Le;
  int has_own, n_sets;  // the own segment leads the stream; 0, 1 (cross) or 2 (begin, end) endpoint segments
  int shared_eps;       // bit i: endpoint map i (k_begin, v_begin, k_end, v_end) is one (H, Le, D) tensor
  int tiles;            // query tiles of 64 * nwg rows a (b, h)
  int units;            // work items: B * H * tiles (the list: work_item)
  float scale_log2;     // softmax scale * log2(e)
  float shift_log2, clip_log2;  // the static shift C and the clip, * log2(e) (kStatic instances only)
};

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

// One box from shared memory into a (D, H, S, B) map; parts out of bounds are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
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

// S = Q K^T of one 64-row Q tile against a K tile, k16 steps over the
// (zero-padded) head dim: box kk / 4, 32 bytes in per step (issued, not waited on)
template <class T, int D, int BK>
__device__ __forceinline__ void qk_issue(float (&s)[BK / 2], uint32_t q, uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < (D + 15) / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<T>(s, desc_sw128(q + (kk / 4) * (64 * 128) + off, 16), desc_sw128(kt + (kk / 4) * (BK * 128) + off, 16),
                kk > 0);
  }
}

// O += P V: 16 keys (two 8-row groups, 2048 bytes) per step; V's next box is LBO away (issued, not waited on)
template <class T, int D, int BK>
__device__ __forceinline__ void pv_issue(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4], uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<T>(o, pa[kk], desc_sw128(vt + kk * 2048, BK * 128));
}

// The online softmax of one tile's scores: `valid` keys of the tile are real
// (the rest are zero rows past the segment, masked); the running max and sum
// move on, P (exp2 of the scores against the new max) is packed into pa, and
// the factors that take O from the old max to the new are returned in al.
// The kStatic instances take P at the static shift (no max; al is not set).
template <class T, int D, int BK>
__device__ __forceinline__ void softmax_tile(State<D>& st, float (&s)[BK / 2], int valid, float scale_log2,
                                             float shift_log2, float clip_log2, uint32_t (&pa)[BK / 16][4],
                                             float (&al)[2]) {
  const int t = threadIdx.x & 3;
  if (valid < BK) {  // the segment's last tile: keys past its length do not exist
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if ((i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
    }
  }
  if constexpr (kStatic) {
    // P = 2^min(s scale_log2 - shift_log2, clip_log2) (a masked key stays -inf and gives 0)
    float ls0 = 0.f, ls1 = 0.f;
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
  al[0] = ex2((st.m[0] - mn0) * scale_log2);
  al[1] = ex2((st.m[1] - mn1) * scale_log2);
  st.m[0] = mn0;
  st.m[1] = mn1;
  const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
  float ls0 = 0.f, ls1 = 0.f;
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
  st.l[0] = st.l[0] * al[0] + ls0;
  st.l[1] = st.l[1] * al[1] + ls1;
}

template <int D>
__device__ __forceinline__ void rescale(State<D>& st, const float (&al)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    st.o[4 * j] *= al[0];
    st.o[4 * j + 1] *= al[0];
    st.o[4 * j + 2] *= al[1];
    st.o[4 * j + 3] *= al[1];
  }
}

// One run of K/V tiles of the ring (the stages it .. it + n - 1: na tiles of
// a segment of len_a keys, then those of one of len_b) into this warpgroup's
// state, each tile's Q K^T, softmax and P V in turn. `stage(j)` waits for the
// stage of the run's tile j and returns its K tile's address (V follows),
// `release(j)` frees it for the producer.
template <class T, int D, int BK, class Stage, class Release>
__device__ __forceinline__ void run_tiles(State<D>& st, uint32_t q, int len_a, int len_b, const Params& p,
                                          Stage stage, Release release) {
  constexpr int kKV = BK * 128 * ((D + 63) / 64);  // one K (or V) tile: V follows K in a stage
  const int na = (len_a + BK - 1) / BK, n = na + (len_b + BK - 1) / BK;
  auto valid = [&](int j) { return j < na ? min(BK, len_a - j * BK) : min(BK, len_b - (j - na) * BK); };
  float s[BK / 2], al[2];
  uint32_t pa[BK / 16][4];
  for (int j = 0; j < n; ++j) {
    const uint32_t kt = stage(j);
    wgmma_fence();
    qk_issue<T, D, BK>(s, q, kt);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(s);
    softmax_tile<T, D, BK>(st, s, valid(j), p.scale_log2, p.shift_log2, p.clip_log2, pa, al);
    if constexpr (!kStatic) rescale(st, al);
    wgmma_fence();
    pv_issue<T, D, BK>(st.o, pa, kt + kKV);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(st.o);
    reg_fence(pa);
    release(j);
  }
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

// Whether row b drops its endpoint segments (the skip rows of the fused
// endpoint modes), and the r-th row of the call that does (skipped) or not
__device__ __forceinline__ bool skip_row(const Params& p, int b, bool endpoints) {
  return endpoints && p.skip != nullptr && p.skip[b] != 0;
}
__device__ __forceinline__ int nth_row(const Params& p, bool endpoints, bool skipped, int r) {
  int b = 0;
  for (;; ++b) {
    if (skip_row(p, b, endpoints) == skipped && r-- == 0) break;
  }
  return b;
}

// Position u of the work list: its batch row, head and first query row. The
// list runs in four classes, heaviest first: the rows that keep their
// endpoint segments (B - nskip of them) with their full query tiles, then
// their last tiles, then the skip rows' full tiles, then their last tiles;
// head-major within a class (a head's rows, each row's tiles in order).
__device__ __forceinline__ void work_item(const Params& p, bool endpoints, int nskip, int u, int bq, int& b, int& h,
                                          int& q0) {
  const int full = p.tiles - 1;  // a (b, h)'s query tiles before its last
  for (int c = 0;; ++c) {
    const bool skipped = c >= 2, last = c & 1;
    const int per = (skipped ? nskip : p.B - nskip) * (last ? 1 : full), n = p.H * per;  // per: items a head
    if (u < n) {
      h = u / per;
      const int rest = u - h * per, r = last ? rest : rest / full;
      q0 = (last ? full : rest - r * full) * bq;
      b = nth_row(p, endpoints, skipped, r);
      return;
    }
    u -= n;
  }
}

// NSETS: 0 = no endpoint segment (self), 1 = one cross segment (inner), 2 =
// begin and end segments blended by coef (outer); whether the own segment
// leads the stream is the call's (p.has_own). IDLE: some work item has a
// warpgroup whose rows are all past Sq, which then only passes the stages
// on (an instance of its own: the branch costs 3-10% where none is idle,
// tools/midstream_ablation.py). Maps: q, k, v, k_begin,
// v_begin, k_end, v_end, out. Grid: persistent blocks; block: NWG consumer
// warpgroups of 64 query rows and a producer warpgroup.
template <class T, int D, int NWG, bool IDLE, int NSETS>
__global__ void __launch_bounds__(Cfg<D, NWG>::kThreads, 1)
    midstream_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                     const __grid_constant__ CUtensorMap vm, const __grid_constant__ CUtensorMap kbm,
                     const __grid_constant__ CUtensorMap vbm, const __grid_constant__ CUtensorMap kem,
                     const __grid_constant__ CUtensorMap vem, const __grid_constant__ CUtensorMap om, const Params p) {
  using C = Cfg<D, NWG>;
  constexpr int BK = C::kBK, S = C::kStages, R = C::kRing, BQ = 64 * NWG;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte-swizzled tiles are 1024-byte aligned
  const uint32_t ring = base, kvs = ring + R * C::kQBytes, slot_at = kvs + S * C::kStageBytes;
  float* slot = reinterpret_cast<float*>(smem_raw + (slot_at - raw));
  const uint32_t full = slot_at + C::kParkBytes, empty = full + 8 * S, qfull = empty + 8 * S, qempty = qfull + 8 * R;
  // the unit of the item in each Q/O buffer (-1: the list is done), written by the producer before qfull's arrival
  volatile int* unit_of = reinterpret_cast<volatile int*>(smem_raw + (qempty + 8 * R - raw));
  const int tid = threadIdx.x, wg = tid >> 7;
  int nskip = 0;  // the skip rows, which the work list takes last
  for (int b = 0; b < p.B; ++b) nskip += skip_row(p, b, NSETS > 0);

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * NWG);  // one arrival a consumer warp
    }
    for (int i = 0; i < R; ++i) {
      mbar_init(qfull + 8 * i, 1);
      mbar_init(qempty + 8 * i, NWG);  // one a warpgroup, once its output has left the buffer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // producer warpgroup: one thread issues every copy, running ahead across work items
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == NWG * 128) {
      int it = 0;
      for (int i = 0;; ++i) {
        // the item's Q into ring buffer i % R, once the output of item i - R has left it
        const int r = i % R;
        if (i >= R) mbar_wait(qempty + 8 * r, (i / R - 1) & 1);
        // this block's next item of the list: position i grid + blockIdx.x in
        // even rounds i, i grid + grid - 1 - blockIdx.x in odd ones (a snake)
        int u = i * gridDim.x + (i & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
        if (u >= p.units) u = -1;
        unit_of[r] = u;
        if (u < 0) {  // no item more: the consumers leave on this buffer's arrival
          mbar_arrive(qfull + 8 * r);
          break;
        }
        int b, h, q0;
        work_item(p, NSETS > 0, nskip, u, BQ, b, h, q0);
        const bool skip = skip_row(p, b, NSETS > 0);
        mbar_expect_tx(qfull + 8 * r, C::kQBytes);
        for (int w = 0; w < NWG; ++w) {
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load(ring + r * C::kQBytes + w * C::kQWG + c * 8192, &qm, qfull + 8 * r, 64 * c, h, q0 + 64 * w, b);
          }
        }
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
        if (p.has_own) segment(&km, &vm, p.Lk, b, b);
        if (NSETS > 0 && !skip) {
          segment(&kbm, &vbm, p.Le, p.shared_eps & 1 ? 0 : b, p.shared_eps & 2 ? 0 : b);
          if (NSETS == 2) segment(&kem, &vem, p.Le, p.shared_eps & 4 ? 0 : b, p.shared_eps & 8 ? 0 : b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: rows q0 + 64 wg .. of each work item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
    const int ltid = tid & 127, warp = ltid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    // this thread's parked words, one column of (kSlot, 128) per thread (conflict free)
    float* park = slot + wg * 128 * C::kSlot + ltid;
    int it = 0;
    for (int i = 0;; ++i) {
      const uint32_t q = ring + (i % R) * C::kQBytes + wg * C::kQWG;
      mbar_wait(qfull + 8 * (i % R), (i / R) & 1);
      const int u = unit_of[i % R];
      if (u < 0) break;
      int b, h, q0;
      work_item(p, NSETS > 0, nskip, u, BQ, b, h, q0);
      const bool skip = skip_row(p, b, NSETS > 0);

      State<D> st;
      init_state(st);
      // a run of the stream's tiles (one segment, or the own and the cross
      // segment of the inner modes) through the K/V ring, from stage `it` on
      auto segment = [&](int len_a, int len_b = 0) {
        auto stage = [&](int j) {
          const int s = (it + j) % S;
          mbar_wait(full + 8 * s, ((it + j) / S) & 1);
          return kvs + s * C::kStageBytes;
        };
        auto release = [&](int j) {
          const int s = (it + j) % S;
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * s);  // one arrival a warp: the stage is free for the producer
        };
        run_tiles<T, D, BK>(st, q, len_a, len_b, p, stage, release);
        it += (len_a + BK - 1) / BK + (len_b + BK - 1) / BK;
      };
      if (IDLE && q0 + 64 * wg >= p.Sq) {  // every row of this warpgroup past Sq: it only passes the stages on
        // (its output, unset, is stored by the same steps as any tile's and clipped whole by the TMA store)
        const int n = (p.has_own ? (p.Lk + BK - 1) / BK : 0) + (skip ? 0 : NSETS * ((p.Le + BK - 1) / BK));
        for (int j = 0; j < n; ++j, ++it) {
          const int s = it % S;
          mbar_wait(full + 8 * s, (it / S) & 1);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * s);
        }
      } else if (NSETS == 2 && !skip) {  // the outer modes: own, begin and end, two softmax sets
        if (p.has_own) segment(p.Lk);
        const float c = p.coef[b];
        if (p.has_own) {  // park the own segment's state: the end segment continues it too
#pragma unroll
          for (int k = 0; k < D / 2; ++k) park[k * 128] = st.o[k];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            park[(D / 2 + r) * 128] = st.m[r];
            park[(D / 2 + 2 + r) * 128] = st.l[r];
          }
        }
        segment(p.Le);  // begin
        normalise(st, 1.f - c);
        if (p.has_own) {  // exchange (1 - c) O_begin / l with the parked own state
#pragma unroll
          for (int k = 0; k < D / 2; ++k) {
            const float own = park[k * 128];
            park[k * 128] = st.o[k];
            st.o[k] = own;
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            st.m[r] = park[(D / 2 + r) * 128];
            st.l[r] = park[(D / 2 + 2 + r) * 128];
          }
        } else {
#pragma unroll
          for (int k = 0; k < D / 2; ++k) park[k * 128] = st.o[k];
          init_state(st);
        }
        segment(p.Le);  // end
        normalise(st, c);
#pragma unroll
        for (int k = 0; k < D / 2; ++k) st.o[k] += park[k * 128];
      } else {  // one run: the own segment, and the cross segment of the inner modes
        segment(p.has_own ? p.Lk : 0, NSETS == 1 && !skip ? p.Le : 0);
        normalise(st, 1.f);
      }

      // T output through this warpgroup's rows of the item's Q buffer (its
      // products are done), in the TMA box layout: 128-byte rows, 16-byte
      // chunk j of row r at j ^ (r % 8)
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
      if (ltid == 0) {
        for (int c = 0; c < C::kChunks; ++c) tma_store(&om, q + c * 8192, 64 * c, h, q0 + 64 * wg, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // the store of item i - (R - 2) has read its buffer: the producer may load it again
        asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(R - 2) : "memory");
        if (i >= R - 2) mbar_arrive(qempty + 8 * ((i - (R - 2)) % R));
      }
    }
    if (ltid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// One launch of the instance: persistent blocks (as many as the SMs hold at
// once), capped at the work items
template <class T, int D, int NWG, bool IDLE, int NSETS>
int launch(const CUtensorMap (&m)[8], Params& p, cudaStream_t s) {
  using C = Cfg<D, NWG>;
  auto kernel = &midstream_kernel<T, D, NWG, IDLE, NSETS>;
  static bool smem_set = false;
  static int max_blocks = 0;  // once per instance and process
  const cudaError_t err = allow_smem_once(reinterpret_cast<const void*>(kernel), C::kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  p.tiles = (p.Sq + 64 * NWG - 1) / (64 * NWG);
  p.units = p.B * p.H * p.tiles;
  if (max_blocks == 0) {
    int dev = 0, sms = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, C::kThreads, C::kSmem);
    if (occ != cudaSuccess) return (int)occ;
    max_blocks = n * sms;
  }
  const int blocks = max_blocks < p.units ? max_blocks : p.units;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  kernel<<<blocks, C::kThreads, C::kSmem, s>>>(m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], p);
  return (int)cudaGetLastError();
}

// The instance of the call: the most consumer warpgroups the head dim has
// (three a block interleave one's softmax with the others' products better
// than two, tools/midstream_ablation.py, PERF.md); at three, the IDLE
// instance where the last item's last warpgroup has no row (at two every
// warpgroup computes, the IDLE branch measured slower at D = 80).
template <class T, int D, int NSETS>
int launch_sets(const CUtensorMap (&m)[8], Params& p, cudaStream_t s) {
  constexpr int NWG = Mid<D>::kMaxWG;
  if constexpr (NWG == 3) {
    if ((p.Sq + 191) / 192 * 192 - p.Sq >= 64) return launch<T, D, 3, true, NSETS>(m, p, s);
  }
  return launch<T, D, NWG, false, NSETS>(m, p, s);
}

template <class T, int D>
int launch_d(const CUtensorMap (&m)[8], Params& p, cudaStream_t s) {
  switch (p.n_sets) {
#if !AID_STATIC_SHIFT  // the static-shift instances: the endpoint modes alone (self mode stays exact)
    case 0: return launch_sets<T, D, 0>(m, p, s);
#endif
    case 1: return launch_sets<T, D, 1>(m, p, s);
    case 2: return launch_sets<T, D, 2>(m, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class T>
int entry(const void* const (&ptrs)[8], const void* coef, const void* skip, const long long* dims, float scale,
          float shift_log2, float clip_log2, int has_own, int n_sets, void* stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  const int B = (int)dims[0], H = (int)dims[1], D = (int)dims[5];
  if (n_sets < (kStatic ? 1 : 0) || n_sets > 2 || (!has_own && n_sets == 0)) return (int)cudaErrorInvalidValue;
  Params p;
  p.coef = static_cast<const float*>(coef);
  p.skip = static_cast<const uint8_t*>(skip);
  p.B = B;
  p.H = H;
  p.Sq = (int)dims[2];
  p.Lk = (int)dims[3];
  p.Le = (int)dims[4];
  p.has_own = has_own != 0;
  p.n_sets = n_sets;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.shift_log2 = shift_log2;
  p.clip_log2 = clip_log2;
  int bk = 0;
  switch (D) {
    case 64: bk = Mid<64>::kBK; break;
#if !AID_STATIC_SHIFT  // the static-shift instances: D = 64 alone
    case 80: bk = Mid<80>::kBK; break;
#endif
    default: return (int)cudaErrorInvalidValue;
  }
  // rows of each map and of its box: queries, own keys, endpoint keys x4, queries out
  const int rows[8] = {p.Sq, p.Lk, p.Lk, p.Le, p.Le, p.Le, p.Le, p.Sq};
  const int box[8] = {64, bk, bk, bk, bk, bk, bk, 64};
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
    case 64: return launch_d<T, 64>(m, p, s);
#if !AID_STATIC_SHIFT
    case 80: return launch_d<T, 80>(m, p, s);
#endif
    default: return (int)cudaErrorInvalidValue;
  }
}

#if AID_STATIC_SHIFT
}  // namespace static_shift
using static_shift::entry;
#endif
}  // namespace

#if AID_STATIC_SHIFT
// The static-shift instance over bf16 operands: aid_flash_attn_bf16_midstream's
// arguments with the shift C and the clip after the scale, both times log2(e)
// (p = 2^min(s * scale * log2(e) - shift_log2, clip_log2)); D must be 64 and
// n_sets 1 or 2. Returns the launch's cudaError_t (0 on success).
extern "C" int aid_flash_attn_bf16_midstream_static(const void* q, const void* k, const void* v, const void* kb,
                                                    const void* vb, const void* ke, const void* ve, void* out,
                                                    const void* coef, const void* skip, const long long* dims,
                                                    float scale, float shift_log2, float clip_log2, int has_own,
                                                    int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__nv_bfloat16>(ptrs, coef, skip, dims, scale, shift_log2, clip_log2, has_own, n_sets, stream);
}
#else

// dims: [B, H, Sq, Lk, Le, D, then (b, h, s) element strides of
//        q, k, v, k_begin, v_begin, k_end, v_end, out]  (30 values), as
// aid_flash_attn_bf16 takes them; a b stride of 0 marks an endpoint shared
// by every row. Every operand is bf16 with its head dim contiguous, 16-byte
// aligned, its other strides multiples of 8 elements. coef: (B,) f32, read
// by the outer modes; skip: (B,) bool or null, read by the fused endpoint
// modes. D must be 64 or 80. Returns the launch's cudaError_t (0 on success).
extern "C" int aid_flash_attn_bf16_midstream(const void* q, const void* k, const void* v, const void* kb,
                                             const void* vb, const void* ke, const void* ve, void* out,
                                             const void* coef, const void* skip, const long long* dims, float scale,
                                             int has_own, int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__nv_bfloat16>(ptrs, coef, skip, dims, scale, 0.f, 0.f, has_own, n_sets, stream);
}

// The same over f16 operands (every one f16, the rest as aid_flash_attn_bf16_midstream).
extern "C" int aid_flash_attn_f16_midstream(const void* q, const void* k, const void* v, const void* kb,
                                            const void* vb, const void* ke, const void* ve, void* out,
                                            const void* coef, const void* skip, const long long* dims, float scale,
                                            int has_own, int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__half>(ptrs, coef, skip, dims, scale, 0.f, 0.f, has_own, n_sets, stream);
}
#endif
