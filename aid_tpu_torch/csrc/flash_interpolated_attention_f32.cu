// Flash interpolated attention for the AID family, f32, head dims 40/64/80/160, sm_90a.
//
// The f32 instance of the two Pallas TPU kernels behind
// aid_tpu/ops/flash_attention.py::flash_interpolated_attention
// (flash_attention.py:683-1061): the streaming `_kernel` (flash_attention.py:101)
// and the whole-stream-resident `_kernel_onepass` (flash_attention.py:339),
// which take any dtype. An f32 UNet (the reference's default dtype) sends every
// attention here. The contract is flash_interpolated_attention.cu's, per batch
// row b:
//   self         softmax(q k_b^T) v_b
//   fused_outer  (1-c_b) Attn(q, [k_b; K_begin]) + c_b Attn(q, [k_b; K_end])
//   pure_outer   (1-c_b) Attn(q, K_begin)        + c_b Attn(q, K_end)
//   fused_inner  Attn(q, [k_b; K_cross]),  K_cross = lerp(K_begin, K_end, c_b)
//   pure_inner   Attn(q, K_cross)
// with the inner modes' K_cross/V_cross lerped by the wrapper and passed in
// the begin slot, shared (H, Le, D) endpoints passed with a batch stride of
// 0, and fused-mode skip rows dropping their endpoint segments. The output
// is written at its own strides: the wrapper passes a (B, Sq, H, D) buffer
// viewed as (B, H, Sq, D), so heads merge with no copy.
//
// What bounds it on the card: 4*S*L*D flops against (S+L)*D*8 bytes is far
// over the ridge at the self-attention shapes (S = 1024..9216), so the
// products bind. f32 outside the tensor cores runs at 67 TFLOP/s; plain TF32
// on them keeps only ~4e-4 of max |out| (tests/test_torch_ops.py), which
// breaks the f32 promise of 1e-4. So both products run in 3xTF32: a = hi +
// lo, hi*hi + hi*lo + lo*hi summed in f32 (lo*lo dropped); three passes at
// the 495 TFLOP/s TF32 rate are the bound.
//
// Every head dim (40, 64, 80, 160): wgmma, TMA and a split/transpose
// warpgroup.
//   * hi is the raw f32 operand: the tensor cores read a tf32 operand's top
//     19 bits, so hi = trunc(a) costs nothing and only lo = a - trunc(a)
//     (exact in f32, read truncated in turn) is made. Relative error of the
//     split ~2^-20 (cvt.rna: ~2^-22); tests/test_torch_ops.py holds it under
//     1e-4 of max |out| over SD 2.1's 18432-key fused_outer stream;
//   * every K/V tile arrives by TMA (cp.async.bulk.tensor) through a tensor
//     map over the (B, S, H*D) projection viewed as (D, H, S, B): boxes of
//     32 f32 (128 bytes, the 128-byte swizzle) by a tile of rows. Dim 0 has
//     the extent D, so columns past D (the second box at D = 40, the third
//     half at D = 80) come in as zeros and rows past a segment's length as
//     zeros, never as the next head's or batch row's. Shared (H, Le, D)
//     endpoints get a map of batch extent 1. Each block's query rows arrive
//     the same way, once;
//   * S = Q K^T runs wgmma m64nBKk8 tf32 with Q as A from registers (hi and
//     lo, loaded and split once a block: Q in shared memory as well would
//     not leave room for two stages) and K as B in its TMA tile, which is
//     K-major (D contiguous) as tf32 wgmma needs: hi*hi into S, hi*lo and
//     lo*hi into a second accumulator, added after the product;
//   * O += P V runs wgmma m64nDk8 with P as A from registers. tf32 wgmma
//     has no transpose bit, so V must reach it K-major, keys contiguous:
//     the producer warpgroup's three split warps write, for every arrived
//     tile, V^T and (V^T)_lo in shared memory, and K_lo beside the raw K.
//     V^T's keys are permuted within each 8-key group (0,2,4,6,1,3,5,7), so
//     the S accumulator (keys 2t and 2t+1 of each n8 tile in one thread) is
//     P's A fragment (k = t and t + 4) with no shuffle; P_lo is split in
//     registers. V^T's rows are 32 keys (128 bytes, the 128-byte swizzle) or,
//     for 16-key tiles, 16 keys (64 bytes under the 64-byte swizzle);
//   * the producer warpgroup (40 registers a thread after setmaxnreg): one
//     thread keeps the TMA ring full across the segment loop (own, begin,
//     end), three warps split and transpose each arrived stage and arrive
//     on its "ready" mbarrier. The consumer warpgroups (the rest of the
//     registers) run the products and the online softmax in f32 (exp2f,
//     log2(e) folded into the scale) and release the stage;
//   * each tile's P V is summed from zero on the tensor cores and folded
//     into O by an f32 FMA: summed in place, the tensor cores' truncating
//     accumulation drifted 1.3e-4 of max |out| over 16384 keys (the D=512
//     kernel);
//   * the outer modes keep one accumulator set: the own segment's state is
//     parked in this thread's private words of shared memory (the region
//     the block's Q tile arrived in, read into registers by then), the
//     begin segment continues it to (1-c) O / l, which is exchanged with
//     the parked state, and the end segment continues that
//     (flash_interpolated_attention.cu's scheme).
// At D = 40/64/80 each consumer warpgroup owns 64 query rows and all D
// columns. At D = 160 one warpgroup cannot hold them: Q's hi and lo are 160
// registers a thread, and Q in shared memory (80 KB for hi and lo) beside a
// 32-key stage (100 KB: raw K, K_lo, raw V, V^T, (V^T)_lo) leaves no second
// stage. So D = 160 splits D between two consumer warpgroups on the same 64
// rows, flash_attention_bf16_d512.cu's scheme: each holds Q's hi and lo for
// its 80 columns in registers (80 a thread) and a 64 x 80 O (40), the D = 80
// instance's per-warpgroup work. Each computes partial scores over its 80
// columns (k8 steps 10 w .. 10 w + 9: every step is 32 bytes inside one
// 32-float box, so the descriptors start inside a swizzle atom as at every
// head dim), writes them to shared memory in accumulator order, meets the
// other at one named barrier and adds theirs (double-buffered by tile
// parity; the sum is commutative, so both hold the same scores bit for bit),
// and both run the same softmax: P never leaves registers, and each runs P V
// over its 80 columns (V^T rows 80 w .., 512-byte aligned). The region a
// row group's Q arrived in parks both warpgroups' outer state (2 x 22.5 KB).
// Room decides the key tile: 16 keys (a 50 KB stage) in three stages.
// The tile table (Tiles below): shared memory per 64 rows of Q or parked
// state (the larger), the exchange (D = 160), per stage raw K, raw V and
// K_lo (BK x 128 bytes per 32-column box) and V^T, (V^T)_lo (D x BK x 4
// bytes); ptxas (CUDA 12.8) reports the launch bound's registers (128 at 512
// threads, 168 at 384) and no spill for every instance; setmaxnreg gives the
// consumers:
//   D   rows keys stages  warpgroups  stage bytes   shared memory   consumer registers
//   40   192   32    4     3 x 40        34816           189,544         152
//   64   128   64    2     2 x 64        81920           201,784         232
//   80   128   32    3     2 x 80        57344           222,288         232
//   160   64   16    3     2 x 80        51200           216,144         232
// A third stage does not fit at D = 64 beside the Q / parked regions, nor
// 64-key tiles at D = 80 (139 KB a stage), nor a second 32-key stage at
// D = 160 beside the exchange. At D = 40, three warpgroups and 32-key tiles
// beat two and 64 (fused_outer (7,8,4096,40) 4.16 against 4.50 ms, self 1.88
// against 1.90-1.98; H100, tools/attention_bench.py); at D = 64, 32-key
// tiles in four stages won at the 77- and 144-key calls (0.128 against 0.152
// ms at 4096 x 77 keys) and lost at 9216 tokens (7.56 against 7.33 ms), so
// 64 stays. D = 160's SD 1.5 shapes (256 and 64 tokens) are latency-bound
// calls of 28-224 blocks: 64 rows a block, not more.
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled, taken
// through cudaGetDriverEntryPoint (no -lcuda), kept in a small cache keyed by
// everything they encode (pointer, extents, strides, box), and passed as
// __grid_constant__ parameters.
//
// The static-shift softmax (`static_smax`, the static branches of `_kernel`
// at flash_attention.py:210-256 and `_kernel_onepass` at :520-545) is this
// body built with AID_STATIC_SHIFT = 1 by
// flash_interpolated_attention_f32_static.cu, a translation unit of its own:
// every mode at D = 40/64/80/160, entry aid_flash_attn_f32_static. Each
// tile's P is exp2f(min(s * sl2 - shift_log2, clip_log2)) with the shift C and
// the 30-nat clip in log2 units: no row max, no quad reduction, and each
// tile's P V is added to O with no rescale; P's hi/lo split is unchanged, the
// outer modes' park is kept, and each row's sum is guarded (max(l, 1e-37)) as
// the JAX kernels' denominator is.

#include <cuda.h>
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

#include "tf32_mma.cuh"
#include "map_cache.cuh"

constexpr bool kStatic = AID_STATIC_SHIFT != 0;

// The tile table (tests/test_torch_ops.py reads it): query rows per block,
// keys per K/V tile, stages in the ring.
template <int D> struct Tiles;
template <> struct Tiles<40> { static constexpr int kBQ = 192, kBK = 32, kStages = 4; };
template <> struct Tiles<64> { static constexpr int kBQ = 128, kBK = 64, kStages = 2; };
template <> struct Tiles<80> { static constexpr int kBQ = 128, kBK = 32, kStages = 3; };
template <> struct Tiles<160> { static constexpr int kBQ = 64, kBK = 16, kStages = 3; };

template <int D>
struct Cfg {
  static constexpr int kBQ = Tiles<D>::kBQ, kBK = Tiles<D>::kBK, kStages = Tiles<D>::kStages;
  static constexpr int kSplit = D > 128 ? 2 : 1;        // consumer warpgroups sharing 64 query rows, splitting D
  static constexpr int kDW = D / kSplit;                // a warpgroup's columns of Q K^T's depth and of O
  static constexpr int kRG = kBQ / 64;                  // row groups of 64 query rows
  static constexpr int kWG = kRG * kSplit;              // consumer warpgroups
  static constexpr int kThreads = 128 * (kWG + 1);      // + the producer warpgroup
  static constexpr int kProducerRegs = 40;
  // what is left of the SM's 65536 registers, per consumer thread, a multiple of 8, at most 240
  static constexpr int kConsumerRegs = (65536 - 128 * kProducerRegs) / (128 * kWG) / 8 * 8 > 240
                                          ? 240 : (65536 - 128 * kProducerRegs) / (128 * kWG) / 8 * 8;
  static constexpr int kSplitWarps = 3;                 // the producer's warps 1..3
  static constexpr int kChunks = (D + 31) / 32;         // 32-float boxes of a row
  static constexpr int kKSteps = kDW / 8;               // a warpgroup's k8 steps of Q K^T
  static constexpr int kQBytes = 64 * 128 * kChunks;    // one row group's Q tile
  static constexpr int kKVBytes = kBK * 128 * kChunks;  // one raw K or V tile, or K_lo
  static constexpr int kVTRow = (kBK < 32 ? kBK : 32) * 4;  // bytes of a V^T row: 128 or 64 (the swizzle's width)
  static constexpr int kVTGroups = kVTRow / 32;         // 8-key groups (k8 steps) in a V^T row
  static constexpr int kVTBytes = kBK * 4 * D;          // V^T or (V^T)_lo: D rows per kVTRow bytes of keys
  static constexpr int kStageBytes = 3 * kKVBytes + 2 * kVTBytes;  // K, V, K_lo, V^T, (V^T)_lo
  static constexpr int kSlot = kDW / 2 + 4;             // parked words a thread: O, m[2], l[2]
  static constexpr int kParkBytes = kSplit * 128 * kSlot * 4;  // a row group's parked state
  static constexpr int kRegionBytes = ((kQBytes > kParkBytes ? kQBytes : kParkBytes) + 1023) / 1024 * 1024;
  static constexpr int kXBytes = kSplit > 1 ? 2 * kSplit * (kBK / 2) * 128 * 4 : 0;  // the exchange, by tile parity
  static constexpr int smem_bytes() {
    return 1024 + kRG * kRegionBytes + kRG * kXBytes + kStages * kStageBytes + (3 * kStages + 1) * 8;
  }
  static_assert(kDW % 8 == 0 && (kBK % 32 == 0 || kBK == 16), "k8 steps, 128- or 64-byte rows of V^T");
  static_assert(kSplit == 1 || kSplit == 2, "the exchange adds one other warpgroup's partial scores");
  static_assert(kWG * kConsumerRegs * 128 + kProducerRegs * 128 <= 65536, "registers");
  static_assert(smem_bytes() <= 232448, "over the 227 KB a block can use");
};

struct Params {
  float* out;
  long long sob, soh, sos;  // the output's (b, h, s) element strides
  const float* coef;        // (B,) f32, read by the outer modes only
  const uint8_t* skip;      // (B,) bool or null, read by the fused endpoint modes only
  int Sq, Lk, Le;
  int shared_eps;           // bit i: endpoint map i (k_begin, v_begin, k_end, v_end) is one (H, Le, D) tensor
  float scale_log2;         // softmax scale * log2(e)
  float shift_log2, clip_log2;  // the static shift C and the clip, * log2(e) (kStatic instances only)
};

// The 128-byte swizzle of a byte offset in a 1024-byte-aligned tile of
// 128-byte rows: 16-byte chunk j of row r lies at chunk j ^ (r % 8)
__device__ __forceinline__ uint32_t swz(uint32_t off) { return off ^ (((off >> 7) & 7) << 4); }

// V^T's layout: rows of 128 bytes under the 128-byte swizzle, or of 64
// bytes under the 64-byte one (16-byte chunk j of 512-byte-aligned row r at
// j ^ (r / 2 % 4)), and the wgmma descriptor that reads it
template <int ROW>
__device__ __forceinline__ uint32_t vt_swz(uint32_t off) {
  return ROW == 128 ? swz(off) : off ^ (((off >> 7) & 3) << 4);
}
template <int ROW>
__device__ __forceinline__ uint64_t vt_desc(uint32_t addr) {
  return ROW == 128 ? desc_sw128(addr) : desc_sw64(addr);
}

// The running softmax state of this thread's two query rows (g and g + 8
// of its warp's 16): O's N columns of this warpgroup in the wgmma
// accumulator layout, the running max m of the raw scores and this
// thread's partial row sums l.
template <int N>
struct State {
  float o[N / 2];
  float m[2], l[2];
};

template <int N>
__device__ __forceinline__ void init_state(State<N>& st) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) st.o[i] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// A row's sum: the thread's partial sums reduced over the quad; at the
// static shift guarded, so a row whose every key underflowed gives 0
__device__ __forceinline__ float row_sum(float l) {
  if constexpr (kStatic) return fmaxf(quad_sum(l), 1e-37f);
  return quad_sum(l);
}

// (w / l) O: the row sums reduced over the quad
template <int N>
__device__ __forceinline__ void normalise(State<N>& st, float w) {
  const float i0 = w / row_sum(st.l[0]), i1 = w / row_sum(st.l[1]);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    st.o[4 * j] *= i0;
    st.o[4 * j + 1] *= i0;
    st.o[4 * j + 2] *= i1;
    st.o[4 * j + 3] *= i1;
  }
}

// One stage of online softmax for this warpgroup's 64 query rows and its
// columns part * kDW ..: raw K, K_lo, V^T and (V^T)_lo at their offsets from
// `stage`; `valid` keys of the tile are real (the rest are zero rows past
// the segment). With D split (kSplit = 2), `xs` is the row group's exchange
// buffer and `it` the tile's index in the stream (its parity picks the half).
// The kStatic instances take P at the static shift (shift_log2, clip_log2)
// and add P V to O with no rescale.
template <int D>
__device__ __forceinline__ void tile_update(State<Cfg<D>::kDW>& st, const uint32_t (&qhi)[Cfg<D>::kKSteps][4],
                                            const uint32_t (&qlo)[Cfg<D>::kKSteps][4], uint32_t stage, int valid,
                                            float sl2, float shift_log2, float clip_log2, int part, float* xs,
                                            int it) {
  using C = Cfg<D>;
  constexpr int BK = C::kBK, DW = C::kDW, ROW = C::kVTRow;
  const int t = threadIdx.x & 3;
  const uint32_t kt = stage, klo = stage + 2 * C::kKVBytes, vt = stage + 3 * C::kKVBytes, vtlo = vt + C::kVTBytes;
  // S = Q K^T over this warpgroup's columns: hi*hi into s, hi*lo + lo*hi
  // into sm; k8 step ks is box ks / 4, 32 bytes in per step
  float s[BK / 2], sm[BK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kKSteps; ++kk) {
    const int ks = part * C::kKSteps + kk;
    const uint32_t off = (ks / 4) * (BK * 128) + (ks % 4) * 32;
    wgmma_tf32(sm, qlo[kk], desc_sw128(kt + off), kk > 0);
    wgmma_tf32(sm, qhi[kk], desc_sw128(klo + off), 1);
    wgmma_tf32(s, qhi[kk], desc_sw128(kt + off), kk > 0);
  }
  wgmma_commit();
  wgmma_wait0();
  reg_fence(s);
  reg_fence(sm);

#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] += sm[i];
  if (C::kSplit > 1) {
    // partial scores out in accumulator order, meet the other warpgroup, add theirs
    const int ct = threadIdx.x & 127;
    float* mine = xs + ((it & 1) * C::kSplit + part) * (BK / 2) * 128 + ct;
    const float* theirs = xs + ((it & 1) * C::kSplit + (1 - part)) * (BK / 2) * 128 + ct;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mine[i * 128] = s[i];
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + (int)(threadIdx.x >> 7) / C::kSplit), "n"(128 * C::kSplit) : "memory");
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] += theirs[i * 128];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (valid < BK && (i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;  // keys past the segment
  }
  // the exact softmax's running max (al: the factors that take O to the new
  // max); the static shift's P has a fixed offset and clip instead, al = 1
  float al0 = 1.f, al1 = 1.f, ms0 = shift_log2, ms1 = shift_log2, clip = clip_log2;
  if constexpr (!kStatic) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // every tile holds at least one real key, so the new max is finite
    const float mn0 = fmaxf(st.m[0], quad_max(mx0)), mn1 = fmaxf(st.m[1], quad_max(mx1));
    al0 = exp2f((st.m[0] - mn0) * sl2);  // 0 on the first tile
    al1 = exp2f((st.m[1] - mn1) * sl2);
    st.m[0] = mn0;
    st.m[1] = mn1;
    ms0 = mn0 * sl2;
    ms1 = mn1 * sl2;
    clip = INFINITY;
  }
  float ls0 = 0.f, ls1 = 0.f;
  // P's A fragment of k8 step j is S's n8 tile j: V^T holds key 2t at k = t
  // and key 2t + 1 at k = t + 4, so a0..a3 = P(g, 2t), P(g+8, 2t), P(g, 2t+1), P(g+8, 2t+1)
  uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    float p0, p1, p2, p3;
    if constexpr (kStatic) {
      p0 = exp2f(fminf(fmaf(s[4 * j], sl2, -ms0), clip));
      p1 = exp2f(fminf(fmaf(s[4 * j + 1], sl2, -ms0), clip));
      p2 = exp2f(fminf(fmaf(s[4 * j + 2], sl2, -ms1), clip));
      p3 = exp2f(fminf(fmaf(s[4 * j + 3], sl2, -ms1), clip));
    } else {
      p0 = exp2f(fmaf(s[4 * j], sl2, -ms0));
      p1 = exp2f(fmaf(s[4 * j + 1], sl2, -ms0));
      p2 = exp2f(fmaf(s[4 * j + 2], sl2, -ms1));
      p3 = exp2f(fmaf(s[4 * j + 3], sl2, -ms1));
    }
    ls0 += p0 + p1;
    ls1 += p2 + p3;
    ph[j][0] = __float_as_uint(p0);
    ph[j][1] = __float_as_uint(p2);
    ph[j][2] = __float_as_uint(p1);
    ph[j][3] = __float_as_uint(p3);
    pl[j][0] = __float_as_uint(tf32_rest(p0));
    pl[j][1] = __float_as_uint(tf32_rest(p2));
    pl[j][2] = __float_as_uint(tf32_rest(p1));
    pl[j][3] = __float_as_uint(tf32_rest(p3));
  }
  st.l[0] = st.l[0] * al0 + ls0;
  st.l[1] = st.l[1] * al1 + ls1;

  // this tile's P V over this warpgroup's columns (V^T rows part * DW ..)
  // from zero (hi*lo and lo*hi first), folded into O by FMA
  float pv[DW / 2];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    const uint32_t off = (ks / C::kVTGroups) * (D * ROW) + part * DW * ROW + (ks % C::kVTGroups) * 32;
    wgmma_tf32(pv, pl[ks], vt_desc<ROW>(vt + off), ks > 0);
    wgmma_tf32(pv, ph[ks], vt_desc<ROW>(vtlo + off), 1);
    wgmma_tf32(pv, ph[ks], vt_desc<ROW>(vt + off), 1);
  }
  wgmma_commit();
  wgmma_wait0();
  reg_fence(pv);
  reg_fence(ph);
  reg_fence(pl);
#pragma unroll
  for (int j = 0; j < DW / 8; ++j) {
    if constexpr (kStatic) {
      st.o[4 * j] += pv[4 * j];
      st.o[4 * j + 1] += pv[4 * j + 1];
      st.o[4 * j + 2] += pv[4 * j + 2];
      st.o[4 * j + 3] += pv[4 * j + 3];
    } else {
      st.o[4 * j] = fmaf(st.o[4 * j], al0, pv[4 * j]);
      st.o[4 * j + 1] = fmaf(st.o[4 * j + 1], al0, pv[4 * j + 1]);
      st.o[4 * j + 2] = fmaf(st.o[4 * j + 2], al1, pv[4 * j + 2]);
      st.o[4 * j + 3] = fmaf(st.o[4 * j + 3], al1, pv[4 * j + 3]);
    }
  }
}

// The split warps' work on one arrived stage: K_lo beside the raw K (the
// swizzle only moves 16-byte chunks, so chunk i of K_lo is the rest of chunk
// i of K), and V^T, (V^T)_lo from the raw V: warp item (box cb, key group
// grp) takes column 32 cb + lane of keys 8 grp .. 8 grp + 7 (one 128-byte
// row of the raw tile a load) and writes them as two 16-byte runs of row d
// of V^T, keys in the order 0,2,4,6,1,3,5,7.
template <int D>
__device__ __forceinline__ void split_stage(unsigned char* stage, int sp, int warp, int lane) {
  using C = Cfg<D>;
  constexpr int BK = C::kBK, ROW = C::kVTRow;
  const float4* kr = reinterpret_cast<const float4*>(stage);
  float4* kl = reinterpret_cast<float4*>(stage + 2 * C::kKVBytes);
  for (int i = sp; i < C::kKVBytes / 16; i += 32 * C::kSplitWarps) {
    const float4 x = kr[i];
    kl[i] = make_float4(tf32_rest(x.x), tf32_rest(x.y), tf32_rest(x.z), tf32_rest(x.w));
  }
  const unsigned char* vr = stage + C::kKVBytes;
  unsigned char* vt = stage + 3 * C::kKVBytes;
  for (int item = warp; item < C::kChunks * (BK / 8); item += C::kSplitWarps) {
    const int cb = item % C::kChunks, grp = item / C::kChunks, d = 32 * cb + lane;
    if (d >= D) continue;
    float v[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      v[w] = *reinterpret_cast<const float*>(vr + cb * (BK * 128) + swz((8 * grp + w) * 128 + lane * 4));
    }
    const uint32_t row = (grp / C::kVTGroups) * (D * ROW) + d * ROW + (grp % C::kVTGroups) * 32;
    float4* even = reinterpret_cast<float4*>(vt + vt_swz<ROW>(row));
    float4* odd = reinterpret_cast<float4*>(vt + vt_swz<ROW>(row + 16));
    *even = make_float4(v[0], v[2], v[4], v[6]);
    *odd = make_float4(v[1], v[3], v[5], v[7]);
    *reinterpret_cast<float4*>(vt + C::kVTBytes + vt_swz<ROW>(row)) =
        make_float4(tf32_rest(v[0]), tf32_rest(v[2]), tf32_rest(v[4]), tf32_rest(v[6]));
    *reinterpret_cast<float4*>(vt + C::kVTBytes + vt_swz<ROW>(row + 16)) =
        make_float4(tf32_rest(v[1]), tf32_rest(v[3]), tf32_rest(v[5]), tf32_rest(v[7]));
  }
}

// HAS_OWN: the row's own K/V segment leads the stream (self and fused modes).
// NSETS: 0 = no endpoint segment (self), 1 = one cross segment (inner),
// 2 = begin and end segments blended by coef (outer).
// Maps: q, k, v, k_begin, v_begin, k_end, v_end.
template <int D, bool HAS_OWN, int NSETS>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_f32_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                     const __grid_constant__ CUtensorMap vm, const __grid_constant__ CUtensorMap kbm,
                     const __grid_constant__ CUtensorMap vbm, const __grid_constant__ CUtensorMap kem,
                     const __grid_constant__ CUtensorMap vem, const Params p) {
  using C = Cfg<D>;
  constexpr int BK = C::kBK, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte-swizzled tiles are 1024-byte aligned
  // per row group its Q / parked region, then its exchange buffer (D split only), then the ring
  const uint32_t regions = base, xchg = base + C::kRG * C::kRegionBytes, stages = xchg + C::kRG * C::kXBytes;
  const uint32_t full = stages + S * C::kStageBytes, ready = full + 8 * S, empty = ready + 8 * S, qbar = empty + 8 * S;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * C::kBQ;
  const int tid = threadIdx.x, wg = tid >> 7;
  // skip rows drop the endpoint segments; pure modes never skip (the
  // wrapper passes no skip rows), their stream has no own segment
  const bool skip = NSETS > 0 && p.skip != nullptr && p.skip[b] != 0;
  const int n_eps = NSETS > 0 && !skip ? NSETS : 0;
  const int total = (HAS_OWN ? (p.Lk + BK - 1) / BK : 0) + n_eps * ((p.Le + BK - 1) / BK);

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(ready + 8 * i, 32 * C::kSplitWarps);  // every split thread
      mbar_init(empty + 8 * i, 4 * C::kWG);           // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C::kWG) {
    // producer warpgroup: warp 0's first thread issues every copy, warps 1..3 split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect_tx(qbar, C::kRG * C::kQBytes);
        for (int w = 0; w < C::kRG; ++w) {
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load(regions + w * C::kRegionBytes + c * 8192, &qm, qbar, 32 * c, h, q0 + 64 * w, b);
          }
        }
        int it = 0;
        auto segment = [&](const CUtensorMap* kmap, const CUtensorMap* vmap, int len, int kb, int vb) {
          for (int r0 = 0; r0 < len; r0 += BK, ++it) {
            const int st = it % S;
            if (it >= S) mbar_wait(empty + 8 * st, (it / S - 1) & 1);
            const uint32_t kt = stages + st * C::kStageBytes, bar = full + 8 * st;
            mbar_expect_tx(bar, 2 * C::kKVBytes);
            for (int c = 0; c < C::kChunks; ++c) {
              tma_load(kt + c * BK * 128, kmap, bar, 32 * c, h, r0, kb);
              tma_load(kt + C::kKVBytes + c * BK * 128, vmap, bar, 32 * c, h, r0, vb);
            }
          }
        };
        if (HAS_OWN) segment(&km, &vm, p.Lk, b, b);
        if (n_eps > 0) {
          segment(&kbm, &vbm, p.Le, p.shared_eps & 1 ? 0 : b, p.shared_eps & 2 ? 0 : b);
          if (n_eps == 2) segment(&kem, &vem, p.Le, p.shared_eps & 4 ? 0 : b, p.shared_eps & 8 ? 0 : b);
        }
      }
    } else {
      for (int it = 0; it < total; ++it) {
        const int st = it % S;
        mbar_wait(full + 8 * st, (it / S) & 1);
        split_stage<D>(smem_raw + (stages + st * C::kStageBytes - raw), tid - 128 * C::kWG - 32, warp - 1, lane);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic stores -> wgmma's proxy
        mbar_arrive(ready + 8 * st);
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 rg .., columns kDW part ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int rg = wg / C::kSplit, part = wg % C::kSplit;
    unsigned char* region = smem_raw + (regions + rg * C::kRegionBytes - raw);
    float* xs = reinterpret_cast<float*>(smem_raw + (xchg + rg * C::kXBytes - raw));
    mbar_wait(qbar, 0);
    // Q's A fragments, hi (raw) and lo, for this warpgroup's k8 steps: rows
    // 16 warp + g (+ 8), columns kDW part + 8 kk + t (+ 4)
    uint32_t qhi[C::kKSteps][4], qlo[C::kKSteps][4];
#pragma unroll
    for (int kk = 0; kk < C::kKSteps; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * warp + g + 8 * (e & 1), c = C::kDW * part + 8 * kk + t + 4 * (e >> 1);
        const float x = *reinterpret_cast<const float*>(region + (c / 32) * 8192 + swz(r * 128 + (c % 32) * 4));
        qhi[kk][e] = __float_as_uint(x);
        qlo[kk][e] = __float_as_uint(tf32_rest(x));
      }
    }

    constexpr int DW = C::kDW;
    State<DW> st;
    init_state(st);
    int it = 0;
    auto segment = [&](int len) {
      for (int r0 = 0; r0 < len; r0 += BK, ++it) {
        const int s = it % S;
        mbar_wait(ready + 8 * s, (it / S) & 1);
        tile_update<D>(st, qhi, qlo, stages + s * C::kStageBytes, min(BK, len - r0), p.scale_log2, p.shift_log2,
                       p.clip_log2, part, xs, it);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    };
    if (HAS_OWN) segment(p.Lk);
    if (n_eps == 2) {
      // this thread's parked words, one column of (kSlot, 128) per thread (conflict free);
      // the region held this row group's Q tile, which every warpgroup of it
      // has in registers by now (each passed a tile's exchange, or has its own rows)
      float* park = reinterpret_cast<float*>(region) + part * C::kSlot * 128 + (tid & 127);
      const float c = p.coef[b];
      if (HAS_OWN) {  // park the own segment's state: the end segment continues it too
#pragma unroll
        for (int i = 0; i < DW / 2; ++i) park[i * 128] = st.o[i];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          park[(DW / 2 + r) * 128] = st.m[r];
          park[(DW / 2 + 2 + r) * 128] = st.l[r];
        }
      }
      segment(p.Le);  // begin
      normalise(st, 1.f - c);
      if (HAS_OWN) {  // exchange (1 - c) O_begin / l with the parked own state
#pragma unroll
        for (int i = 0; i < DW / 2; ++i) {
          const float own = park[i * 128];
          park[i * 128] = st.o[i];
          st.o[i] = own;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          st.m[r] = park[(DW / 2 + r) * 128];
          st.l[r] = park[(DW / 2 + 2 + r) * 128];
        }
      } else {
#pragma unroll
        for (int i = 0; i < DW / 2; ++i) park[i * 128] = st.o[i];
        init_state(st);
      }
      segment(p.Le);  // end
      normalise(st, c);
#pragma unroll
      for (int i = 0; i < DW / 2; ++i) st.o[i] += park[i * 128];
    } else {
      if (n_eps == 1) segment(p.Le);
      normalise(st, 1.f);
    }

    // rows g and g + 8 of this warp, columns kDW part + 8j + 2t (+ 1): float2 stores at the output's strides
    float* ob = p.out + b * p.sob + h * p.soh + DW * part;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + 64 * rg + 16 * warp + g + 8 * hf;
      if (row >= p.Sq) continue;
      float* orow = ob + (long long)row * p.sos + 2 * t;
#pragma unroll
      for (int j = 0; j < DW / 8; ++j) {
        *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(st.o[4 * j + 2 * hf], st.o[4 * j + 2 * hf + 1]);
      }
    }
  }
}

// A (D, H, S, B) map of an f32 operand at element strides (b, h, s), boxes
// of 32 columns by `rows` rows, 128-byte swizzle, zeros out of bounds, from
// the cache of maps (map_cache.cuh).
bool encode_map(CUtensorMap* map, const void* ptr, int D, int H, int S, int B, const long long* strides, int rows) {
  return encode_map_cached(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, D, H, S, B, strides, 32, rows);
}

template <int D, bool HAS_OWN, int NSETS>
int launch(const CUtensorMap (&m)[7], const Params& p, int B, int H, cudaStream_t s) {
  using C = Cfg<D>;
  constexpr int smem = C::smem_bytes();
  static bool smem_allowed = false;  // one per instance
  const cudaError_t err = allow_smem_once(reinterpret_cast<const void*>(&flash_f32_kernel<D, HAS_OWN, NSETS>), smem,
                                          smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + C::kBQ - 1) / C::kBQ, H, B);
  flash_f32_kernel<D, HAS_OWN, NSETS><<<grid, C::kThreads, smem, s>>>(m[0], m[1], m[2], m[3], m[4], m[5], m[6], p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* const (&ptrs)[8], const long long* dims, int has_own, int n_sets, float scale,
             float shift_log2, float clip_log2, const void* coef, const void* skip, cudaStream_t s) {
  const int B = (int)dims[0], H = (int)dims[1];
  Params p;
  p.out = static_cast<float*>(const_cast<void*>(ptrs[7]));
  p.sob = dims[27];
  p.soh = dims[28];
  p.sos = dims[29];
  p.coef = static_cast<const float*>(coef);
  p.skip = static_cast<const uint8_t*>(skip);
  p.Sq = (int)dims[2];
  p.Lk = (int)dims[3];
  p.Le = (int)dims[4];
  p.scale_log2 = scale * 1.4426950408889634f;
  p.shift_log2 = shift_log2;
  p.clip_log2 = clip_log2;
  // rows of each map: queries, own keys, endpoint keys x4
  const int rows[7] = {p.Sq, p.Lk, p.Lk, p.Le, p.Le, p.Le, p.Le};
  const int box[7] = {64, Cfg<D>::kBK, Cfg<D>::kBK, Cfg<D>::kBK, Cfg<D>::kBK, Cfg<D>::kBK, Cfg<D>::kBK};
  CUtensorMap m[7];
  p.shared_eps = 0;
  for (int i = 0; i < 7; ++i) {
    const long long* st = dims + 6 + 3 * i;
    const bool used = i == 0 || (i < 3 ? has_own != 0 : n_sets > 0);
    if (!used) {  // a map the instance never reads: any valid one
      m[i] = m[0];
      continue;
    }
    if (!encode_map(&m[i], ptrs[i], D, H, rows[i], B, st, box[i])) return (int)cudaErrorInvalidValue;
    if (i >= 3 && st[0] == 0) p.shared_eps |= 1 << (i - 3);
  }
  if (has_own && n_sets == 0) return launch<D, true, 0>(m, p, B, H, s);
  if (has_own && n_sets == 1) return launch<D, true, 1>(m, p, B, H, s);
  if (has_own && n_sets == 2) return launch<D, true, 2>(m, p, B, H, s);
  if (!has_own && n_sets == 1) return launch<D, false, 1>(m, p, B, H, s);
  if (!has_own && n_sets == 2) return launch<D, false, 2>(m, p, B, H, s);
  return (int)cudaErrorInvalidValue;
}

// The f32 entries' body: the operands' alignment checked, then the instance of the head dim
int entry(const void* const (&ptrs)[8], const void* coef, const void* skip, const long long* dims, float scale,
          float shift_log2, float clip_log2, int has_own, int n_sets, void* stream) {
  for (const void* ptr : ptrs) {
    if (reinterpret_cast<uintptr_t>(ptr) & 15) return (int)cudaErrorMisalignedAddress;
  }
  for (int i = 6; i < 30; ++i) {
    if (dims[i] % 4 != 0) return (int)cudaErrorMisalignedAddress;
  }
  if (dims[2] <= 0 || dims[3] <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  switch (dims[5]) {
    case 40: return launch_d<40>(ptrs, dims, has_own, n_sets, scale, shift_log2, clip_log2, coef, skip, s);
    case 64: return launch_d<64>(ptrs, dims, has_own, n_sets, scale, shift_log2, clip_log2, coef, skip, s);
    case 80: return launch_d<80>(ptrs, dims, has_own, n_sets, scale, shift_log2, clip_log2, coef, skip, s);
    case 160: return launch_d<160>(ptrs, dims, has_own, n_sets, scale, shift_log2, clip_log2, coef, skip, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#if AID_STATIC_SHIFT
}  // namespace static_shift
using static_shift::entry;
#endif
}  // namespace

#if AID_STATIC_SHIFT
// The static-shift instance: aid_flash_attn_f32's arguments with the shift C
// and the clip after the scale, both times log2(e) (p = 2^min(s * scale *
// log2(e) - shift_log2, clip_log2)), every mode at D = 40, 64, 80 or 160.
// Returns the launch's cudaError_t (0 on success).
extern "C" int aid_flash_attn_f32_static(const void* q, const void* k, const void* v, const void* kb,
                                         const void* vb, const void* ke, const void* ve, void* out, const void* coef,
                                         const void* skip, const long long* dims, float scale, float shift_log2,
                                         float clip_log2, int has_own, int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry(ptrs, coef, skip, dims, scale, shift_log2, clip_log2, has_own, n_sets, stream);
}
#else
// The C signature of aid_flash_attn_bf16 (flash_interpolated_attention.cu)
// for f32 operands. dims: [B, H, Sq, Lk, Le, D, then (b, h, s) element
// strides of q, k, v, k_begin, v_begin, k_end, v_end, out] (30 values); a b
// stride of 0 marks an endpoint shared by every row. Every operand is f32
// with its head dim contiguous, 16-byte aligned, its other strides multiples
// of 4 elements. coef: (B,) f32, read by the outer modes; skip: (B,) bool or
// null, read by the fused endpoint modes. D must be 40, 64, 80 or 160.
// Returns the launch's cudaError_t (0 on success).
extern "C" int aid_flash_attn_f32(const void* q, const void* k, const void* v, const void* kb, const void* vb,
                                  const void* ke, const void* ve, void* out, const void* coef, const void* skip,
                                  const long long* dims, float scale, int has_own, int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry(ptrs, coef, skip, dims, scale, 0.f, 0.f, has_own, n_sets, stream);
}
#endif
