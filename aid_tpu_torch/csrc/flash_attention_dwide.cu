// Flash interpolated attention at head dims 513..2048, bf16, f16 or f32, sm_90a.
//
// Replaces the wide-head contract of the Pallas TPU kernels
// aid_tpu/ops/flash_attention.py::_kernel (flash_attention.py:101) and
// ::_kernel_onepass (339): every mode (self, fused / pure x outer / inner;
// the header of flash_interpolated_attention.cu lists them) at a padded head
// dim past 512, which the JAX wrapper runs up to its block budget
// (flash_attention.py:806-816). The model that reaches it is an SD 1.x UNet
// with one head a level: D = 320 / 640 / 1280 over 64^2 / 32^2 / 16^2 tokens,
// 1280 in the mid block (the D = 320 calls take the D=512 kernels).
//
// What bounds it on the card: 4 * D flops a (query, key) pair against
// (Sq + 2 L) * D elements, so at 1024 tokens it is bound by the tensor cores
// (the bf16 bound at (7,1,1024,640) fused_outer, two skip rows, is 0.046 ms)
// and at 64 tokens by the bytes. Past D = 512 a block cannot hold a 64-row
// Q tile beside its K and V tiles, nor a 64-row f32 output in a warpgroup's
// registers, and wgmma takes 64 rows in M. So the design puts the keys in M,
// through the transposed products:
//   * S^T = K Q^T: a key tile's keys in wgmma's M (two 64-key M blocks, 128
//     keys, in bf16 and f16; one in f32), the block's BQ query rows in N, D
//     reduced a 64-column chunk at a time against Q, resident in shared
//     memory (BQ x Dp) as the K-major B operand;
//   * O^T = V^T P^T: 64 output columns in M, the query rows in N, the tile's
//     keys reduced; P^T goes to shared memory as the B operand;
//   * so K and V stream as uniform tiles of 128 (f32: 64) keys by 128
//     columns whatever D is, a 64-column chunk for each of two consumer
//     warpgroups. One producer thread issues every TMA copy (a tile's K,
//     then its V; boxes of 128 bytes a row, the 128-byte swizzle) into a
//     ring of 2-5 slots, each with a full and an empty mbarrier (a slot a
//     warpgroup, of half the size, measured slower: twice the hand-offs
//     with the same thread); the maps' bounds zero-fill
//     columns past the caller's D and keys past each segment's length, so
//     the wrapper passes D as it is. The padded head dim Dp is 640, 1024,
//     1280 or 2048 (one instance each), the block's query rows BQ 32 (Dp <=
//     1024) or 16 in bf16 and f16, 16 (Dp = 640) or 8 in f32;
//   * the two consumer warpgroups (setmaxnreg 240, the producer's 24) split
//     D by chunks, warpgroup w taking chunks w, w + 2, ...: each sums the
//     partial scores of the whole tile over its chunks. With two M blocks
//     warpgroup w finishes the softmax of block w: the two hand each other
//     their partial scores of the other's block through shared memory, so
//     each thread's exchange and softmax cover as many scores as a 64-key
//     tile's, for twice the keys; with one (f32) both add the same two sums
//     and run the same softmax. Each then computes P V over its own chunks
//     against the whole P^T. The consumers meet on three named barriers a
//     tile (the exchange, the column maxima, P^T written), the producer on
//     the ring's mbarriers alone; no __syncthreads in the key loop (measured
//     on 64-key tiles, the tile's fixed chain of hand-offs, barriers and the
//     exchange, not its products, took most of its time: PERF.md);
//   * the softmax reduces over wgmma's M: a thread holds two keys of each of
//     its query columns, shuffles take the max over its warp's 16 keys and
//     the eight warps' maxima meet in shared memory. The query columns a
//     thread holds in S^T are the ones it holds in O^T, so the rescale
//     factors stay in its registers, and each thread keeps its own part of
//     the row sums, reduced at a set's end;
//   * each chunk's P V is summed from zero into one of two accumulators (the
//     next chunk's product runs while the last is folded) and folded into O
//     with one f32 FMA a value;
//   * bf16 and f16 (elem16.cuh): both products read both operands from
//     shared memory (V through the transpose bit, never copied), P rounded
//     to T and stored by stmatrix .trans; the output leaves through the Q
//     tile's boxes (stmatrix .trans) by a TMA store clipped at Sq and D;
//   * f32, 3xTF32 (a = hi + lo with the raw value as hi, lo = a - trunc(a);
//     hi*hi + hi*lo + lo*hi, tf32_mma.cuh): TF32 wgmma takes no transposed
//     shared-memory operand, so A comes from registers in both products: K's
//     fragments, raw and lo, against Q and against lo(Q), which the
//     consumers write once beside Q; V^T's fragments, raw and lo, against
//     P^T's raw and lo rows, which the softmax writes. The small terms of
//     Q K^T sum apart from the big one. Fragments load a 32-column box (four
//     k8 steps) at a time into one of two register buffers. The output is
//     stored from the registers at the output's strides;
//   * the key stream is a list of segments (the own K/V, then begin and
//     end, or the lerped cross K/V the wrapper passes in the begin slot),
//     each of its own length and map; a shared (H, Le, D) endpoint has a map
//     of batch extent 1; a skip row (fused modes) streams its own segment
//     alone. The outer modes' two softmax sets share the own segment: its
//     state is parked in the f32 workspace, the begin segment continues it
//     (set 0, parked in turn), and the end segment continues the restored
//     own state (set 1);
//   * filling the card: where the grid of ceil(Sq / BQ) * H * B blocks is
//     under kSplitBlocks (132, the H100's SMs), each row block's key stream
//     (every segment's key tiles in order) is split across S = min(132 /
//     blocks, tiles, 32) blocks. Each writes its unnormalised state per set
//     (O, the running max m, the sum l) to the workspace, and
//     flash_dwide_combine_kernel merges them: per set O = sum_s e_s O_s /
//     sum_s e_s l_s with e_s = 2^(m_s - max m), then (1 - c) set 0 + c set 1
//     in the outer modes. A split that ends in the own segment gives both
//     sets its state; one that starts past it continues an empty one.
//     Unsplit, a block normalises, blends and writes its output itself;
//   * ragged key tails are masked with -inf scores; ragged query rows load
//     zeros and are not stored.
// What it costs: each block reads all of K and V once per BQ query rows (the
// D = 512 kernels once per 64); tools/dwide_ablation.py times the
// producer's loads, Q K^T, the exchange, the softmax, P V and the combine
// step apart, and PERF.md has its times.
//
// The static-shift softmax (`static_smax`, the static branch of `_kernel` at
// flash_attention.py:210-256) is this body built with AID_STATIC_SHIFT = 1 by
// flash_attention_dwide_static.cu, a translation unit of its own, bf16 and
// f32 (entries aid_flash_attn_bf16_dwide_static and
// aid_flash_attn_f32_dwide_static, every mode; in f16, exp(-40) is below the
// smallest subnormal). Each tile's P is 2^min(s * scale_log2 - shift_log2,
// clip_log2), the shift C and the 30-nat clip in log2 units after the scale:
// no column maxima (their shuffles, the warps' maxima in shared memory and
// the named barrier between them go: two barriers a tile, the exchange and
// P^T written), no rescale factor, and each chunk's P V is added to O with
// no factor (in bf16 the P V wgmma accumulates into O^T in place, with no
// second accumulator and no fold: as fast as the fold kept, measured, and 32
// registers fewer in flight; f32 keeps its fold, an add, as the f32 D=512
// and D=161-512 static instances do). Each softmax set's O and l just add up, so the outer modes'
// park keeps O and l and no max (the workspace's layout is the exact
// instances'; the max words go unused), the own segment's state continuing
// into both sets unchanged, as the JAX branch's w0 / w1 weights do, and the
// combine step is O = sum_s O_s / sum_s l_s per set, with no max pass and no
// weight. Each row's sum is guarded (max(l, 1e-37)) as the JAX kernels'
// denominator is.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#ifndef AID_STATIC_SHIFT
#define AID_STATIC_SHIFT 0
#endif

namespace {
#if AID_STATIC_SHIFT
namespace static_shift {  // kernel names of their own beside the exact instances' in one library
#endif

#include "elem16.cuh"
#include "tf32_mma.cuh"

constexpr bool kStatic = AID_STATIC_SHIFT != 0;
constexpr int kWG = 2;                         // consumer warpgroups, splitting D by 64-column chunks
constexpr int kThreads = 128 * (kWG + 1);      // + the producer warpgroup
constexpr int kMaxRing = 12;
constexpr int kSmemLimit = 232448;             // the 227 KB a block can use
constexpr int kSplitBlocks = 132;              // the H100's SMs: a split aims at one wave of blocks
constexpr int kMaxSplit = 32;

template <class T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

// 64-key M blocks of a key tile: two in bf16 and f16 (a 128-key tile; each
// warpgroup finishes the softmax of one), one in f32 (whose shared memory
// holds no 128-key slots beside Q and lo(Q))
template <class T>
__host__ __device__ constexpr int m_blocks() {
  return is_f32<T>() ? 1 : 2;
}

// NC 64-column chunks a consumer warpgroup (Dp = 128 NC), BQ query rows a block
template <class T, int NC, int BQ>
struct Wide {
  static constexpr bool kF32 = is_f32<T>();
  static constexpr int kMB = m_blocks<T>();
  static constexpr int kBK = 64 * kMB;                          // keys a tile
  static constexpr int kDp = 128 * NC;
  static constexpr int kBoxBytes = kBK * 128;                   // a K or V box: 128 bytes of each of the tile's keys
  static constexpr int kBoxCols = 128 / (int)sizeof(T);         // columns of a 128-byte box row: 64 or 32
  static constexpr int kChunkBoxes = 64 / kBoxCols;             // boxes of a 64-column chunk: 1 or 2
  static constexpr int kChunkBytes = kChunkBoxes * kBoxBytes;   // a warpgroup's part of a ring slot
  static constexpr int kSlotBytes = kWG * kChunkBytes;          // a ring slot: kBK keys x 128 columns
  static constexpr int kQBoxBytes = BQ * 128;                   // a Q or P^T box: BQ query rows of 128 bytes
  static constexpr int kQBytes = kDp * BQ * (int)sizeof(T);     // Q: BQ-row boxes in the order of their columns
  static constexpr int kQLoBytes = kF32 ? kQBytes : 0;          // f32: lo(Q) in Q's layout
  static constexpr int kPBoxes = kBK * (int)sizeof(T) / 128;    // P^T's boxes a copy: kBK keys of each query row
  static constexpr int kPBytes = (kF32 ? 2 : 1) * kPBoxes * kQBoxBytes;  // P^T (f32: raw, then lo)
  static constexpr int kXBytes = 2 * kWG * 128 * (BQ / 2) * 4;  // the partial scores, by tile parity
  static constexpr int kRedBytes = kStatic ? 0 : 2 * kWG * 4 * BQ * 4;  // the warps' column maxima, by tile parity
  static constexpr int kLBytes = kWG * 4 * BQ * 4;              // the warps' column sums
  static constexpr int kFixed = kQBytes + kQLoBytes + kPBytes + kXBytes + kRedBytes + kLBytes;
  static constexpr int kFit = (kSmemLimit - 1024 - kFixed - 8 * (2 * kMaxRing + 1)) / kSlotBytes;
  static constexpr int kRing = kFit < kMaxRing ? kFit : kMaxRing;
  // offsets from the 1024-byte-aligned base (128-byte-swizzled tiles first)
  static constexpr int kQLoOff = kQBytes;
  static constexpr int kRingOff = kQBytes + kQLoBytes;
  static constexpr int kPOff = kRingOff + kRing * kSlotBytes;
  static constexpr int kXOff = kPOff + kPBytes;
  static constexpr int kRedOff = kXOff + kXBytes;
  static constexpr int kLOff = kRedOff + kRedBytes;
  static constexpr int kBarOff = kLOff + kLBytes;               // Q's barrier, then full[kRing], empty[kRing]
  static constexpr int kSmem = 1024 + kBarOff + 8 * (2 * kRing + 1);
  static constexpr int kPartial = BQ * kDp + 2 * BQ;            // f32 words of a state: O (BQ x Dp), m, l
  static_assert(kRing >= 2 && kSmem <= kSmemLimit, "over the 227 KB a block can use");
  static_assert(kF32 ? BQ % 8 == 0 : BQ % 16 == 0, "query rows: n8 tiles (f32) or pairs of them (stmatrix)");
};

struct WideParams {
  const float* coef;      // (B,) f32, read by the outer modes
  const uint8_t* skip;    // (B,) bool or null, read by the fused modes
  float* work;            // the workspace: (blocks, sets, Wide::kPartial) f32, or null
  void* out;              // the output
  long long so[3];        // its (b, h, s) element strides
  int Sq, Lk, Le, D;
  int has_own, n_sets;
  int splits;             // blocks a row block's key stream is split across
  int shared_eps;         // bit i: endpoint map i (k_begin, v_begin, k_end, v_end) is one (H, Le, D) tensor
  float scale_log2;       // softmax scale * log2(e)
  float shift_log2, clip_log2;  // the static shift C and the clip, * log2(e) (kStatic instances only)
};

template <class T>
__device__ __forceinline__ float exp2_of(float x) {
  if constexpr (is_f32<T>()) {
    return exp2f(x);
  } else {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  }
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile with a leading byte offset
// (the MN-major V: the stride of 64-column groups, none past one here)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// Four 8x8 b16 matrices stored transposed: lane l's register r[i] holds
// row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of matrix i, which land in
// rows 2 (l % 4) and 2 (l % 4) + 1, column l / 4, of the stored matrix;
// lanes 8i .. 8i + 7 give the addresses of matrix i's stored rows
__device__ __forceinline__ void stmatrix_t4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r0),
               "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// One box from shared memory into a (D, H, S, B) map; parts out of bounds are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}

// D(64 x 16, f32) (+)= A(64 x 16) B(16 x 16), both in shared memory; TA: A MN-major (the transpose bit)
template <class T, int TA>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
#define AID_ASM(TY)                                                                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                                                      \
               "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY                                           \
               " {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"                                \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])  \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// D(64 x 32, f32) (+)= A(64 x 16) B(16 x 32), both in shared memory; TA: A MN-major
template <class T, int TA>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
#define AID_ASM(TY)                                                                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                                       \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY                                            \
               " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, " \
               "0;\n}\n"                                                                                          \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),         \
                 "+f"(d[15])                                                                                      \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// D(64 x 8, f32) (+)= A(64 x 8, tf32 registers) B(8 x 8, tf32, K-major in shared memory)
__device__ __forceinline__ void wgmma_tf32(float (&d)[4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The tf32 A fragment of a k8 step from a 128-byte-swizzled box of 32
// floats a row: rows r0 and r0 + 8 (r0 % 8 = g), floats 4 j + t and
// 4 (j + 1) + t of the row (j even: the step's columns t and t + 4), raw as
// hi, lo = hi - trunc(hi)
__device__ __forceinline__ void load_frag(const float* box, int r0, int j, int g, int t, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const float x[4] = {box[r0 * 32 + ((j ^ g) << 2) + t], box[(r0 + 8) * 32 + ((j ^ g) << 2) + t],
                      box[r0 * 32 + (((j + 1) ^ g) << 2) + t], box[(r0 + 8) * 32 + (((j + 1) ^ g) << 2) + t]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = __float_as_uint(x[e]);
    lo[e] = __float_as_uint(tf32_rest(x[e]));
  }
}

// Maps: q, k, v, k_begin, v_begin, k_end, v_end, out, each (D, H, S, B) with
// boxes of 128 bytes a row by BQ (q, out) or BK rows. Accumulator index i
// of a consumer thread (warp w of its warpgroup, lane 4 g + t) is key (S^T)
// or head-dim column (O^T) 16 w + g + 8 ((i >> 1) & 1) by query 8 (i >> 2)
// + 2 t + (i & 1); column index k = 2 (i >> 2) + (i & 1) numbers its queries.
template <class T, int NC, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dwide_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                       const __grid_constant__ CUtensorMap vm, const __grid_constant__ CUtensorMap kbm,
                       const __grid_constant__ CUtensorMap vbm, const __grid_constant__ CUtensorMap kem,
                       const __grid_constant__ CUtensorMap vem, const __grid_constant__ CUtensorMap om,
                       const WideParams p) {
  using W = Wide<T, NC, BQ>;
  constexpr bool F32 = W::kF32;
  constexpr int R = W::kRing, Dp = W::kDp, CB = W::kChunkBoxes, MB = W::kMB, BK = W::kBK;
  constexpr int NA = BQ / 2, NK = BQ / 4;  // accumulators and query columns of a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte-swizzled tiles are 1024-byte aligned
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t qs = base, ring = base + W::kRingOff;
  const uint32_t qbar = base + W::kBarOff, full = qbar + 8, empty = full + 8 * R;

  const int split = blockIdx.x % p.splits, qb = blockIdx.x / p.splits;
  const int h = blockIdx.y, b = blockIdx.z, q0 = qb * BQ;
  const int tid = threadIdx.x, wg = tid >> 7;
  // a skip row drops its endpoint segments; the pure modes never skip
  const bool skip = p.has_own && p.n_sets > 0 && p.skip != nullptr && p.skip[b] != 0;
  const int n_own = p.has_own ? (p.Lk + BK - 1) / BK : 0, n_ep = (p.Le + BK - 1) / BK;
  const int n_total = n_own + p.n_sets * n_ep;  // the stream of a row that does not skip
  // this split's tiles [t0, t1) of the row's stream (a skip row's may be empty)
  const int t0 = split * n_total / p.splits;
  const int t1 = min((split + 1) * n_total / p.splits, skip ? n_own : n_total);
  const bool outer = p.n_sets == 2 && !skip;
  // tile `it` of the stream: its segment (0 own, 1 begin or cross, 2 end) and its first key
  auto seg_of = [&](int it) { return it < n_own ? 0 : 1 + (it - n_own) / n_ep; };
  auto row_of = [&](int it) { return (it < n_own ? it : (it - n_own) % n_ep) * BK; };

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < R; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * kWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWG) {
    // producer warpgroup: one thread issues every copy, Q, then each tile's
    // K and V in order through the ring, 128 columns a slot
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * kWG && t0 < t1) {
      mbar_expect_tx(qbar, W::kQBytes);
      for (int c = 0; c < Dp / W::kBoxCols; ++c) {
        tma_load(qs + c * W::kQBoxBytes, &qm, qbar, W::kBoxCols * c, h, q0, b);
      }
      int slot = 0, round = 0;
      for (int it = t0; it < t1; ++it) {
        const int seg = seg_of(it), r0 = row_of(it);
        for (int kv = 0; kv < 2; ++kv) {
          const CUtensorMap* map = seg == 0 ? (kv ? &vm : &km) : seg == 1 ? (kv ? &vbm : &kbm) : (kv ? &vem : &kem);
          const int bi = seg > 0 && ((p.shared_eps >> (2 * (seg - 1) + kv)) & 1) ? 0 : b;
          for (int c2 = 0; c2 < NC; ++c2) {
            if (round > 0) mbar_wait(empty + 8 * slot, (round - 1) & 1);
            mbar_expect_tx(full + 8 * slot, W::kSlotBytes);
            for (int x = 0; x < kWG * CB; ++x) {  // warpgroup x / CB's chunk, box x % CB of it
              tma_load(ring + slot * W::kSlotBytes + x * W::kBoxBytes, map, full + 8 * slot,
                       128 * c2 + W::kBoxCols * x, h, r0, bi);
            }
            if (++slot == R) {
              slot = 0;
              ++round;
            }
          }
        }
      }
    }
  } else {
    // consumer warpgroup wg: chunks c = 2 c2 + wg of Q K^T's depth and of O^T's rows;
    // the softmax of M block mown of each tile (two blocks: its own; one: both warpgroups')
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int ct = tid & 127, warp = ct >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int mown = wg % MB, wpos = 4 * wg + warp;  // this warp among the block's eight
    const float sl2 = p.scale_log2;
    const int sets = p.n_sets == 2 ? 2 : 1;
    float* xs = reinterpret_cast<float*>(gbase + W::kXOff);
    [[maybe_unused]] float* red = reinterpret_cast<float*>(gbase + W::kRedOff);
    float* lred = reinterpret_cast<float*>(gbase + W::kLOff);
    const uint32_t pt = base + W::kPOff;
    auto generic = [&](uint32_t addr) { return reinterpret_cast<float*>(gbase + (addr - base)); };

    float o[NC][NA];        // O^T of chunk 2 c2 + wg
    float m[NK], l[NK];     // each query column's running max (raw scores) and this thread's part of its sum
#pragma unroll
    for (int c2 = 0; c2 < NC; ++c2) {
#pragma unroll
      for (int i = 0; i < NA; ++i) o[c2][i] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      m[k] = -INFINITY;
      l[k] = 0.f;
    }
    auto query = [&](int k) { return 8 * (k >> 1) + 2 * t + (k & 1); };
    auto col = [&](int c2, int i) { return 64 * (2 * c2 + wg) + 16 * warp + g + 8 * ((i >> 1) & 1); };
    // this block's state of set `set` in the workspace
    auto state = [&](int set) {
      const size_t blk = (size_t)((b * gridDim.y + h) * (gridDim.x / p.splits) + qb) * p.splits + split;
      return p.work + (blk * sets + set) * W::kPartial;
    };
    // L = every query column's sum over the tile's key rows: the eight warps'
    // parts with two M blocks, this warpgroup's four with one (both hold the same)
    auto reduce_l = [&](float (&L)[NK]) {
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        float x = l[k];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        if (g == 0) lred[wpos * BQ + query(k)] = x;
      }
      named_barrier(1, 128 * kWG);
      const float* lr = lred + (MB == 1 ? 4 * wg * BQ : 0);
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int q = query(k);
        float x = 0.f;
#pragma unroll
        for (int w = 0; w < (MB == 1 ? 4 : 4 * kWG); ++w) x += lr[w * BQ + q];
        L[k] = x;
      }
      named_barrier(1, 128 * kWG);  // lred is read before it is written again
    };
    // write O, m and L as set `set`'s state (m and L by one warp: both warpgroups hold the same)
    auto store_state = [&](int set, const float (&L)[NK]) {
      float* w = state(set);
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2) {
#pragma unroll
        for (int i = 0; i < NA; ++i) w[query(2 * (i >> 2) + (i & 1)) * Dp + col(c2, i)] = o[c2][i];
      }
      if (wg == 0 && warp == 0 && g == 0) {
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          if constexpr (!kStatic) w[BQ * Dp + query(k)] = m[k];  // the static shift keeps no max
          w[BQ * Dp + BQ + query(k)] = L[k];
        }
      }
    };

    if (t0 >= t1) {  // a skip row's split past its own segment: an empty state for the combine step
      float L[NK];
#pragma unroll
      for (int k = 0; k < NK; ++k) L[k] = 0.f;
      store_state(0, L);
      return;
    }

    int slot = 0, phase = 0, par = 0;  // the next ring slot and its parity; the tile's parity
    auto advance = [&]() {
      if (++slot == R) {
        slot = 0;
        phase ^= 1;
      }
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    };
    // O^T chunk = O^T * alpha + acc, by FMA (at the static shift, f32's: O^T + acc)
    auto fold = [&](float (&oc)[NA], const float (&acc)[NA], const float (&alpha)[NK]) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        if constexpr (kStatic) {
          oc[i] += acc[i];
        } else {
          oc[i] = fmaf(oc[i], alpha[2 * (i >> 2) + (i & 1)], acc[i]);
        }
      }
    };

    mbar_wait(qbar, 0);
    if constexpr (F32) {
      // lo(Q) of this warpgroup's chunks, in Q's layout
      constexpr int n4 = CB * BQ * 32 / 4;  // float4s of a chunk
      const float4* qv = reinterpret_cast<const float4*>(gbase);
      float4* lv = reinterpret_cast<float4*>(gbase + W::kQLoOff);
#pragma unroll 1
      for (int c2 = 0; c2 < NC; ++c2) {
        for (int i = ct; i < n4; i += 128) {
          const float4 x = qv[(2 * c2 + wg) * n4 + i];
          lv[(2 * c2 + wg) * n4 + i] = make_float4(tf32_rest(x.x), tf32_rest(x.y), tf32_rest(x.z), tf32_rest(x.w));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic stores -> wgmma's proxy
      named_barrier(2 + wg, 128);
    }

    // one tile of the stream into the running state
    auto tile = [&](int it) {
      // ---- partial scores S^T = K Q^T over this warpgroup's chunks, an
      // accumulator each M block
      float s[MB][NA];
      int prev = 0;
      if constexpr (!F32) {
#pragma unroll
        for (int c2 = 0; c2 < NC; ++c2) {
          mbar_wait(full + 8 * slot, phase);
          const uint32_t kt = ring + slot * W::kSlotBytes + wg * W::kChunkBytes;
          const uint32_t qt = qs + (2 * c2 + wg) * W::kQBoxBytes;
          wgmma_fence();
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              wgmma_ss<T, 0>(s[mb], desc_sw128(kt + 64 * 128 * mb + 32 * kk, 16), desc_sw128(qt + 32 * kk, 16),
                             c2 + kk > 0);
            }
          }
          wgmma_commit();
          if (c2 > 0) {
            wgmma_wait<1>();  // the last chunk's products are done: its slot is free
            release(prev);
          }
          prev = slot;
          advance();
        }
        wgmma_wait0();
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) reg_fence(s[mb]);
        release(prev);
      } else {
        // 3xTF32: hi*hi into s, lo(K) hi(Q) and hi(K) lo(Q) into sm; a 32-column
        // box (four k8 steps) of K's fragments at a time, in two buffers
        float sm[NA];
        uint32_t fhi[2][4][4], flo[2][4][4];
#pragma unroll
        for (int x = 0; x < 2 * NC; ++x) {
          const int c2 = x >> 1, bx = x & 1;
          if (bx == 0) mbar_wait(full + 8 * slot, phase);
          const float* kb = generic(ring + slot * W::kSlotBytes + wg * W::kChunkBytes + bx * W::kBoxBytes);
          const uint32_t qt = qs + (2 * (2 * c2 + wg) + bx) * W::kQBoxBytes;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) load_frag(kb, 16 * warp + g, 2 * kk, g, t, fhi[x & 1][kk], flo[x & 1][kk]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t qd = desc_sw128(qt + 32 * kk), qld = desc_sw128(qt + W::kQLoOff + 32 * kk);
            wgmma_tf32(s[0], fhi[x & 1][kk], qd, x + kk > 0);
            wgmma_tf32(sm, flo[x & 1][kk], qd, x + kk > 0);
            wgmma_tf32(sm, fhi[x & 1][kk], qld, 1);
          }
          wgmma_commit();
          if (x > 0) {
            wgmma_wait<1>();  // the last box's products are done: its fragments are free
            reg_fence(fhi[(x - 1) & 1]);
            reg_fence(flo[(x - 1) & 1]);
            if (bx == 0) release(prev);  // ... and with it the last chunk's slot
          }
          if (bx == 1) {
            prev = slot;
            advance();
          }
        }
        wgmma_wait0();
        reg_fence(s[0]);
        reg_fence(sm);
        release(prev);
#pragma unroll
        for (int i = 0; i < NA; ++i) s[0][i] += sm[i];
      }

      // ---- exchange: our partial scores of the other warpgroup's M block out
      // in accumulator order, meet it, add its partial scores of ours (one M
      // block: both add the same two, commutatively, so both hold the same)
      float sc[NA];  // the scores of this warpgroup's M block (selected, not indexed: registers stay registers)
      {
        float* mine = xs + ((par * kWG + wg) * NA) * 128 + ct;
        const float* theirs = xs + ((par * kWG + 1 - wg) * NA) * 128 + ct;
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          mine[i * 128] = wg ? s[0][i] : s[MB - 1][i];
          sc[i] = wg ? s[MB - 1][i] : s[0][i];
        }
        named_barrier(1, 128 * kWG);
#pragma unroll
        for (int i = 0; i < NA; ++i) sc[i] += theirs[i * 128];
      }

      // ---- online softmax down the key rows of each query column
      const int valid = min(BK, (seg_of(it) == 0 ? p.Lk : p.Le) - row_of(it));  // >= 1
      if (valid < BK) {  // the segment's last tile: keys past its length do not exist
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          if (64 * mown + 16 * warp + g + 8 * ((i >> 1) & 1) >= valid) sc[i] = -INFINITY;
        }
      }
      float alpha[NK];
      float pv[NA];  // P of keys 64 mown + 16 warp + g (+ 8) by this thread's query columns
      if constexpr (kStatic) {
        // P = 2^min(s sl2 - shift_log2, clip_log2) (a masked key stays -inf and gives 0); the sum just adds up
#pragma unroll
        for (int i = 0; i < NA; ++i) pv[i] = exp2_of<T>(fminf(fmaf(sc[i], sl2, -p.shift_log2), p.clip_log2));
#pragma unroll
        for (int j = 0; j < NK / 2; ++j) {
          l[2 * j] += pv[4 * j] + pv[4 * j + 2];
          l[2 * j + 1] += pv[4 * j + 1] + pv[4 * j + 3];
        }
      } else {
        float* rd = red + par * 4 * kWG * BQ;  // [warp of the block][query]
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int j = k >> 1, e = k & 1;
          float x = fmaxf(sc[4 * j + e], sc[4 * j + 2 + e]);
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
          if (g == 0) rd[wpos * BQ + query(k)] = x;
        }
        named_barrier(1, 128 * kWG);
        float ms[NK];
#pragma unroll
        for (int j = 0; j < NK / 2; ++j) {
          float2 x = *reinterpret_cast<const float2*>(rd + 8 * j + 2 * t);
#pragma unroll
          for (int w = 1; w < 4 * kWG; ++w) {
            const float2 y = *reinterpret_cast<const float2*>(rd + w * BQ + 8 * j + 2 * t);
            x.x = fmaxf(x.x, y.x);
            x.y = fmaxf(x.y, y.y);
          }
          // every tile holds a real key, so the new max is finite
          const float mn0 = fmaxf(m[2 * j], x.x), mn1 = fmaxf(m[2 * j + 1], x.y);
          alpha[2 * j] = exp2_of<T>((m[2 * j] - mn0) * sl2);  // 0 on a set's first tile
          alpha[2 * j + 1] = exp2_of<T>((m[2 * j + 1] - mn1) * sl2);
          m[2 * j] = mn0;
          m[2 * j + 1] = mn1;
          ms[2 * j] = mn0 * sl2;
          ms[2 * j + 1] = mn1 * sl2;
        }
#pragma unroll
        for (int i = 0; i < NA; ++i) pv[i] = exp2_of<T>(fmaf(sc[i], sl2, -ms[2 * (i >> 2) + (i & 1)]));
#pragma unroll
        for (int j = 0; j < NK / 2; ++j) {
          l[2 * j] = fmaf(l[2 * j], alpha[2 * j], pv[4 * j] + pv[4 * j + 2]);
          l[2 * j + 1] = fmaf(l[2 * j + 1], alpha[2 * j + 1], pv[4 * j + 1] + pv[4 * j + 3]);
        }
      }
      if constexpr (!F32) {
        // P^T rounded to T (query rows of 64 keys a box, 128-byte swizzle):
        // this warp's 16 keys of each row in its M block's box, two n8 tiles
        // a stmatrix
#pragma unroll
        for (int j = 0; j < BQ / 8; j += 2) {
          const int r = lane & 7, jr = j + (lane >> 4), hh = (lane >> 3) & 1;
          stmatrix_t4(pt + mown * W::kQBoxBytes + (8 * jr + r) * 128 + (((2 * warp + hh) ^ r) << 4),
                      Elem<T>::pack(pv[4 * j], pv[4 * j + 1]), Elem<T>::pack(pv[4 * j + 2], pv[4 * j + 3]),
                      Elem<T>::pack(pv[4 * j + 4], pv[4 * j + 5]), Elem<T>::pack(pv[4 * j + 6], pv[4 * j + 7]));
        }
      } else if ((warp >> 1) == wg) {
        // P^T raw, then lo (query rows of 32 keys a box, 128-byte swizzle):
        // warpgroup wg writes the keys of box wg (both hold every key)
        float* ph = generic(pt);
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          const int key = 16 * warp + g + 8 * ((i >> 1) & 1), q = query(2 * (i >> 2) + (i & 1)), kc = key & 31;
          const int off = (key >> 5) * (BQ * 32) + q * 32 + (((kc >> 2) ^ (q & 7)) << 2) + (kc & 3);
          ph[off] = pv[i];
          ph[W::kPBoxes * BQ * 32 + off] = tf32_rest(pv[i]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // P^T's stores -> wgmma's proxy
      named_barrier(1, 128 * kWG);

      // ---- O^T = O^T * alpha + V^T P^T over this warpgroup's chunks, each
      // chunk's product summed from zero and folded by FMA (bf16 at the static
      // shift: accumulated into O^T in place, with no factor to fold by)
      [[maybe_unused]] float acc[2][NA];
      if constexpr (!F32) {
#pragma unroll
        for (int c2 = 0; c2 < NC; ++c2) {
          mbar_wait(full + 8 * slot, phase);
          const uint32_t vt = ring + slot * W::kSlotBytes + wg * W::kChunkBytes;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4 * MB; ++kk) {  // 16 keys a step: V's rows, P^T's box kk / 4
            const uint64_t dv = desc_sw128(vt + 2048 * kk, W::kBoxBytes);
            const uint64_t dp = desc_sw128(pt + (kk >> 2) * W::kQBoxBytes + 32 * (kk & 3), 16);
            if constexpr (kStatic) {
              wgmma_ss<T, 1>(o[c2], dv, dp, 1);
            } else {
              wgmma_ss<T, 1>(acc[c2 & 1], dv, dp, kk > 0);
            }
          }
          wgmma_commit();
          if (c2 > 0) {
            wgmma_wait<1>();  // the last chunk's product is done: fold it, free its slot
            if constexpr (kStatic) {
              reg_fence(o[c2 - 1]);
            } else {
              reg_fence(acc[(c2 - 1) & 1]);
              fold(o[c2 - 1], acc[(c2 - 1) & 1], alpha);
            }
            release(prev);
          }
          prev = slot;
          advance();
        }
      } else {
        // 3xTF32: V^T's fragments raw and lo against P^T's rows raw and lo,
        // 32 keys (four k8 steps) at a time in two buffers
        uint32_t fhi[2][4][4], flo[2][4][4];
        const int cb = 16 * (warp & 1) + g;  // row 16 warp + g of O^T's chunk: column cb of V box warp / 2
#pragma unroll
        for (int x = 0; x < 2 * NC; ++x) {
          const int c2 = x >> 1, kh = x & 1;
          if (kh == 0) mbar_wait(full + 8 * slot, phase);
          const float* vb = generic(ring + slot * W::kSlotBytes + wg * W::kChunkBytes + (warp >> 1) * W::kBoxBytes);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k0 = 32 * kh + 8 * kk + t, k1 = k0 + 4;  // the step's keys t and t + 4
            const float xv[4] = {vb[k0 * 32 + (((cb >> 2) ^ (k0 & 7)) << 2) + (cb & 3)],
                                 vb[k0 * 32 + ((((cb + 8) >> 2) ^ (k0 & 7)) << 2) + (cb & 3)],
                                 vb[k1 * 32 + (((cb >> 2) ^ (k1 & 7)) << 2) + (cb & 3)],
                                 vb[k1 * 32 + ((((cb + 8) >> 2) ^ (k1 & 7)) << 2) + (cb & 3)]};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              fhi[x & 1][kk][e] = __float_as_uint(xv[e]);
              flo[x & 1][kk][e] = __float_as_uint(tf32_rest(xv[e]));
            }
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t pd = pt + kh * W::kQBoxBytes + 32 * kk;  // P^T's box kh, k8 step kk
            wgmma_tf32(acc[c2 & 1], flo[x & 1][kk], desc_sw128(pd), kh + kk > 0);
            wgmma_tf32(acc[c2 & 1], fhi[x & 1][kk], desc_sw128(pd + W::kPBoxes * W::kQBoxBytes), 1);
            wgmma_tf32(acc[c2 & 1], fhi[x & 1][kk], desc_sw128(pd), 1);
          }
          wgmma_commit();
          if (x > 0) {
            wgmma_wait<1>();  // the last half's products are done: its fragments are free
            reg_fence(fhi[(x - 1) & 1]);
            reg_fence(flo[(x - 1) & 1]);
            if (kh == 0) {  // ... and the last chunk: fold it, free its slot
              reg_fence(acc[(c2 - 1) & 1]);
              fold(o[c2 - 1], acc[(c2 - 1) & 1], alpha);
              release(prev);
            }
          }
          if (kh == 1) {
            prev = slot;
            advance();
          }
        }
      }
      wgmma_wait0();
      if constexpr (kStatic && !F32) {
        reg_fence(o[NC - 1]);
      } else {
        reg_fence(acc[(NC - 1) & 1]);
        fold(o[NC - 1], acc[(NC - 1) & 1], alpha);
      }
      release(prev);
      par ^= 1;
    };

    // runs r = 0 (the own segment), 1 (begin), 2 (end) in the outer modes,
    // the whole range as run 2 otherwise; one call site, so a tile's code
    // is compiled once
#pragma unroll 1
    for (int r = outer ? (p.has_own ? 0 : 1) : 2; r < 3; ++r) {
      const int a = outer && r > 0 ? n_own + (r - 1) * n_ep : 0;
      const int z = outer && r < 2 ? n_own + r * n_ep : n_total;
#pragma unroll 1
      for (int it = max(a, t0); it < min(z, t1); ++it) tile(it);
      if (r == 2) break;
      float L[NK];
      reduce_l(L);
      store_state(r == 0 ? 1 : 0, L);  // park the own state as set 1's start, or set 0's end
      named_barrier(1, 128 * kWG);       // ... m and L are written for every thread
      if (r == 1) {  // set 1 continues the own state (fused) or starts afresh (pure)
        const float* w = state(1);
#pragma unroll
        for (int c2 = 0; c2 < NC; ++c2) {
#pragma unroll
          for (int i = 0; i < NA; ++i) o[c2][i] = p.has_own ? w[query(2 * (i >> 2) + (i & 1)) * Dp + col(c2, i)] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          if constexpr (!kStatic) m[k] = p.has_own ? w[BQ * Dp + query(k)] : -INFINITY;
          // the parked sum is whole: one thread of each column's warp-0 quad carries
          // it (of warpgroup 0 where the two warpgroups' parts add up)
          l[k] = p.has_own && warp == 0 && g == 0 && (MB == 1 || wg == 0) ? w[BQ * Dp + BQ + query(k)] : 0.f;
        }
      }
    }

    float L[NK];
    reduce_l(L);
    if (p.splits > 1) {  // the combine step normalises, blends and writes
      store_state(outer ? 1 : 0, L);
      return;
    }
    // O = O / l, or in the outer modes c O_end / l + (1 - c) O_begin / l_begin
    float inv[NK], inv0[NK];
    const float cb = outer ? p.coef[b] : 1.f;
    const float* w0 = outer ? state(0) : nullptr;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      if constexpr (kStatic) {  // each set's sum guarded, as the JAX kernels' denominator
        inv[k] = cb / fmaxf(L[k], 1e-37f);
        inv0[k] = outer ? (1.f - cb) / fmaxf(w0[BQ * Dp + BQ + query(k)], 1e-37f) : 0.f;
      } else {
        inv[k] = cb / L[k];
        inv0[k] = outer ? (1.f - cb) / w0[BQ * Dp + BQ + query(k)] : 0.f;
      }
    }
#pragma unroll
    for (int c2 = 0; c2 < NC; ++c2) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int k = 2 * (i >> 2) + (i & 1);
        o[c2][i] *= inv[k];
        if (outer) o[c2][i] = fmaf(w0[query(k) * Dp + col(c2, i)], inv0[k], o[c2][i]);
      }
    }
    if constexpr (F32) {
      // from the registers at the output's strides: rows past Sq and columns past D are not stored
      float* ob = static_cast<float*>(p.out) + b * p.so[0] + h * p.so[1];
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2) {
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          const int q = q0 + query(2 * (i >> 2) + (i & 1)), c = col(c2, i);
          if (q < p.Sq && c < p.D) ob[(long long)q * p.so[2] + c] = o[c2][i];
        }
      }
    } else {
      // T output through this warpgroup's boxes of the Q tile (its products
      // are done): rows of 64 columns, 16-byte chunk j of row r at j ^ (r % 8)
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2) {
        const uint32_t box = qs + (2 * c2 + wg) * W::kQBoxBytes;
#pragma unroll
        for (int j = 0; j < BQ / 8; j += 2) {
          const int r = lane & 7, jr = j + (lane >> 4), hh = (lane >> 3) & 1;
          stmatrix_t4(box + (8 * jr + r) * 128 + (((2 * warp + hh) ^ r) << 4),
                      Elem<T>::pack(o[c2][4 * j], o[c2][4 * j + 1]), Elem<T>::pack(o[c2][4 * j + 2], o[c2][4 * j + 3]),
                      Elem<T>::pack(o[c2][4 * j + 4], o[c2][4 * j + 5]),
                      Elem<T>::pack(o[c2][4 * j + 6], o[c2][4 * j + 7]));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic stores -> the TMA store's proxy
      named_barrier(2 + wg, 128);
      if (ct == 0) {
        for (int c2 = 0; c2 < NC; ++c2) {
          tma_store(&om, qs + (2 * c2 + wg) * W::kQBoxBytes, 64 * (2 * c2 + wg), h, q0, b);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // smem stays until read
      }
    }
  }
}

// The combine step of a split launch: one thread a query row and pair of
// head-dim columns (blocks of 128 pairs, by query row, by (b, h)). Per set,
// the splits' states weighted by 2^(m_s - max m): O = sum e_s O_s / sum e_s
// l_s (at the static shift unweighted, O = sum O_s / sum l_s, the sum
// guarded); the outer modes blend (1 - c) set 0 + c set 1; rounded once to T.
template <class T>
__global__ void __launch_bounds__(128) flash_dwide_combine_kernel(const WideParams p, int H, int Dp, int BQ) {
  const int cp = blockIdx.x * blockDim.x + threadIdx.x, row = blockIdx.y;
  const int h = blockIdx.z % H, b = blockIdx.z / H, q = row % BQ;
  if (2 * cp >= p.D) return;
  const bool skip = p.has_own && p.n_sets > 0 && p.skip != nullptr && p.skip[b] != 0;
  const bool outer = p.n_sets == 2 && !skip;
  const int sets = p.n_sets == 2 ? 2 : 1, per = BQ * Dp + 2 * BQ, nq = (p.Sq + BQ - 1) / BQ;
  const float* part = p.work + (size_t)((b * H + h) * nq + row / BQ) * p.splits * sets * per;
  float rx = 0.f, ry = 0.f;
  for (int set = 0; set < (outer ? 2 : 1); ++set) {
    if constexpr (kStatic) {  // an empty state (a skip row's split past its own segment) is zeros
      float L = 0.f, ox = 0.f, oy = 0.f;
      for (int s = 0; s < p.splits; ++s) {
        const float* w = part + (s * sets + set) * per;
        const float2 v = *reinterpret_cast<const float2*>(w + q * Dp + 2 * cp);
        L += w[BQ * Dp + BQ + q];
        ox += v.x;
        oy += v.y;
      }
      const float wt = (outer ? (set ? p.coef[b] : 1.f - p.coef[b]) : 1.f) / fmaxf(L, 1e-37f);
      rx = fmaf(ox, wt, rx);
      ry = fmaf(oy, wt, ry);
      continue;
    }
    float mx = -INFINITY;
    for (int s = 0; s < p.splits; ++s) mx = fmaxf(mx, part[(s * sets + set) * per + BQ * Dp + q]);
    float L = 0.f, ox = 0.f, oy = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const float* w = part + (s * sets + set) * per;
      const float e = exp2f((w[BQ * Dp + q] - mx) * p.scale_log2);  // 0 for an empty state
      const float2 v = *reinterpret_cast<const float2*>(w + q * Dp + 2 * cp);
      L = fmaf(w[BQ * Dp + BQ + q], e, L);
      ox = fmaf(v.x, e, ox);
      oy = fmaf(v.y, e, oy);
    }
    const float wt = (outer ? (set ? p.coef[b] : 1.f - p.coef[b]) : 1.f) / L;
    rx = fmaf(ox, wt, rx);
    ry = fmaf(oy, wt, ry);
  }
  T* out = static_cast<T*>(p.out) + b * p.so[0] + h * p.so[1] + (long long)row * p.so[2] + 2 * cp;
  if constexpr (is_f32<T>()) {
    *reinterpret_cast<float2*>(out) = make_float2(rx, ry);
  } else {
    *reinterpret_cast<uint32_t*>(out) = Elem<T>::pack(rx, ry);
  }
}

// The padded head dim of the instances at head dim D, their query rows a
// block, and the split of a grid of `blocks` blocks over a stream of `tiles`
// key tiles (ops/flash_attention.py::dwide_tiles and dwide_split mirror them)
int wide_dp(int D) { return D <= 640 ? 640 : D <= 1024 ? 1024 : D <= 1280 ? 1280 : 2048; }
int wide_rows(int Dp, bool f32) { return f32 ? (Dp <= 640 ? 16 : 8) : (Dp <= 1024 ? 32 : 16); }
int wide_splits(int blocks, int tiles) {
  if (blocks >= kSplitBlocks) return 1;
  int s = kSplitBlocks / blocks;
  if (s > tiles) s = tiles;
  if (s > kMaxSplit) s = kMaxSplit;
  return s < 1 ? 1 : s;
}

template <class T>
constexpr CUtensorMapDataType map_type() {
  if constexpr (is_f32<T>()) {
    return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  } else {
    return Elem<T>::kMapType;
  }
}

// A (D, H, S, B) map of a T operand at element strides (b, h, s), boxes of
// 128 bytes a row by `rows` rows, 128-byte swizzle, zeros out of bounds (past
// D and past S). A batch stride of 0 (one tensor shared by every row) becomes
// a batch extent of 1.
template <class T>
bool encode_wide_map(CUtensorMap* map, const void* ptr, int D, int H, int S, int B, const long long* strides,
                     int rows) {
  const long long sb = strides[0], sh = strides[1], ss = strides[2], e = (long long)sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, sb == 0 ? 1u : (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)(sh * e), (cuuint64_t)(ss * e),
                               (cuuint64_t)((sb == 0 ? ss * S + sh * H : sb) * e)};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / e), 1, (cuuint32_t)rows, 1}, unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, map_type<T>(), 4, const_cast<void*>(ptr), dims, bytes, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class T, int NC, int BQ>
int launch(const CUtensorMap (&m)[8], const WideParams& p, int nq, int H, int B, cudaStream_t s) {
  using W = Wide<T, NC, BQ>;
  static bool smem_allowed = false;  // once per instance and process
  cudaError_t err = allow_smem_once(reinterpret_cast<const void*>(&flash_dwide_kernel<T, NC, BQ>), W::kSmem,
                                    smem_allowed);
  if (err != cudaSuccess) return (int)err;
  flash_dwide_kernel<T, NC, BQ><<<dim3((unsigned)(nq * p.splits), (unsigned)H, (unsigned)B), kThreads, W::kSmem, s>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const dim3 grid((unsigned)((p.D / 2 + 127) / 128), (unsigned)p.Sq, (unsigned)(B * H));
  flash_dwide_combine_kernel<T><<<grid, 128, 0, s>>>(p, H, W::kDp, BQ);
  return (int)cudaGetLastError();
}

template <class T>
int entry(const void* const (&ptrs)[8], const void* coef, const void* skip, void* work, const long long* dims,
          float scale, float shift_log2, float clip_log2, int has_own, int n_sets, void* stream) {
  constexpr int per16 = 16 / (int)sizeof(T);  // elements in 16 bytes
  const int B = (int)dims[0], H = (int)dims[1];
  WideParams p;
  p.Sq = (int)dims[2];
  p.Lk = (int)dims[3];
  p.Le = (int)dims[4];
  p.D = (int)dims[5];
  if (B <= 0 || H <= 0 || p.Sq <= 0 || p.Lk <= 0 || p.Le <= 0) return (int)cudaErrorInvalidValue;
  if (p.D <= 0 || p.D > 2048 || p.D % per16 != 0) return (int)cudaErrorInvalidValue;
  if (n_sets < 0 || n_sets > 2 || (!has_own && n_sets == 0)) return (int)cudaErrorInvalidValue;
  if (n_sets == 2 && coef == nullptr) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 8; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) return (int)cudaErrorMisalignedAddress;
    for (int j = 0; j < 3; ++j) {
      if (dims[6 + 3 * i + j] % per16 != 0) return (int)cudaErrorMisalignedAddress;
    }
  }
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  const int Dp = wide_dp(p.D), BQ = wide_rows(Dp, is_f32<T>()), nq = (p.Sq + BQ - 1) / BQ;
  constexpr int BK = 64 * m_blocks<T>();
  const int tiles = (has_own ? (p.Lk + BK - 1) / BK : 0) + n_sets * ((p.Le + BK - 1) / BK);
  p.splits = wide_splits(nq * H * B, tiles);
  if ((n_sets == 2 || p.splits > 1) && work == nullptr) return (int)cudaErrorInvalidValue;
  p.coef = static_cast<const float*>(coef);
  p.skip = static_cast<const uint8_t*>(skip);
  p.work = static_cast<float*>(work);
  p.out = const_cast<void*>(ptrs[7]);
  for (int j = 0; j < 3; ++j) p.so[j] = dims[27 + j];
  p.has_own = has_own != 0;
  p.n_sets = n_sets;
  p.shared_eps = 0;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.shift_log2 = shift_log2;
  p.clip_log2 = clip_log2;
  // rows of each map: queries, own keys, endpoint keys x4, queries out
  const int rows[8] = {p.Sq, p.Lk, p.Lk, p.Le, p.Le, p.Le, p.Le, p.Sq};
  CUtensorMap m[8];
  for (int i = 0; i < 8; ++i) {
    const long long* st = dims + 6 + 3 * i;
    if (!has_own && (i == 1 || i == 2)) {  // a map the launch never reads: any valid one
      m[i] = m[0];
      continue;
    }
    if (!encode_wide_map<T>(&m[i], ptrs[i], p.D, H, rows[i], B, st, i == 0 || i == 7 ? BQ : BK)) {
      return (int)cudaErrorInvalidValue;
    }
    if (i >= 3 && i < 7 && st[0] == 0) p.shared_eps |= 1 << (i - 3);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool f32 = is_f32<T>();
  switch (Dp) {
    case 640:
      return launch<T, 5, f32 ? 16 : 32>(m, p, nq, H, B, s);
    case 1024:
      return launch<T, 8, f32 ? 8 : 32>(m, p, nq, H, B, s);
    case 1280:
      return launch<T, 10, f32 ? 8 : 16>(m, p, nq, H, B, s);
    default:
      return launch<T, 16, f32 ? 8 : 16>(m, p, nq, H, B, s);
  }
}

#if AID_STATIC_SHIFT
}  // namespace static_shift
using static_shift::entry;
#endif
}  // namespace

#if AID_STATIC_SHIFT
// The static-shift instance over bf16 operands: aid_flash_attn_bf16_dwide's
// arguments with the shift C and the clip after the scale, both times
// log2(e) (p = 2^min(s * scale * log2(e) - shift_log2, clip_log2)), every
// mode, the same workspace (its max words unused). Returns the launch's
// cudaError_t.
extern "C" int aid_flash_attn_bf16_dwide_static(const void* q, const void* k, const void* v, const void* kb,
                                                const void* vb, const void* ke, const void* ve, void* out,
                                                const void* coef, const void* skip, void* work, const long long* dims,
                                                float scale, float shift_log2, float clip_log2, int has_own,
                                                int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__nv_bfloat16>(ptrs, coef, skip, work, dims, scale, shift_log2, clip_log2, has_own, n_sets, stream);
}

// The same over f32 operands (3xTF32).
extern "C" int aid_flash_attn_f32_dwide_static(const void* q, const void* k, const void* v, const void* kb,
                                               const void* vb, const void* ke, const void* ve, void* out,
                                               const void* coef, const void* skip, void* work, const long long* dims,
                                               float scale, float shift_log2, float clip_log2, int has_own,
                                               int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<float>(ptrs, coef, skip, work, dims, scale, shift_log2, clip_log2, has_own, n_sets, stream);
}
#else
// The C signature of aid_flash_attn_bf16_dmid: dims are [B, H, Sq,
// Lk, Le, D, then (b, h, s) element strides of q, k, v, k_begin, v_begin,
// k_end, v_end, out] (30 values; a b stride of 0 marks an endpoint shared by
// every row), D the operands' head dim, 513..2048 on the model's path (any
// D up to 2048 whose rows are 16-byte multiples); coef (B,) f32; skip (B,)
// bool or null; has_own 1 in self and the fused modes, 0 in the pure ones;
// n_sets 0 in self mode (own K/V alone), 2 in the outer modes, 1 in the
// inner ones (their lerped K/V in the begin slot); work the f32 workspace,
// B * H * ceil(Sq / BQ) * S * sets * (BQ * Dp + 2 BQ) floats with Dp = 640,
// 1024, 1280 or 2048 (the first at or above D), BQ (wide_rows) 32 where Dp
// <= 1024 else 16 in bf16 and f16, 16 where Dp = 640 else 8 in f32, S the
// split (wide_splits: 1 where the grid fills the card) and sets 2 in the
// outer modes, else 1 (null where S is 1 outside the outer modes). Every
// operand has its head dim contiguous and 16-byte aligned rows, its other
// strides multiples of 16 bytes. Returns the launch's cudaError_t (0 on
// success).
extern "C" int aid_flash_attn_bf16_dwide(const void* q, const void* k, const void* v, const void* kb, const void* vb,
                                         const void* ke, const void* ve, void* out, const void* coef,
                                         const void* skip, void* work, const long long* dims, float scale,
                                         int has_own, int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__nv_bfloat16>(ptrs, coef, skip, work, dims, scale, 0.f, 0.f, has_own, n_sets, stream);
}

// The same over f16 operands.
extern "C" int aid_flash_attn_f16_dwide(const void* q, const void* k, const void* v, const void* kb, const void* vb,
                                        const void* ke, const void* ve, void* out, const void* coef,
                                        const void* skip, void* work, const long long* dims, float scale,
                                        int has_own, int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__half>(ptrs, coef, skip, work, dims, scale, 0.f, 0.f, has_own, n_sets, stream);
}

// The same over f32 operands (3xTF32).
extern "C" int aid_flash_attn_f32_dwide(const void* q, const void* k, const void* v, const void* kb, const void* vb,
                                        const void* ke, const void* ve, void* out, const void* coef,
                                        const void* skip, void* work, const long long* dims, float scale,
                                        int has_own, int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<float>(ptrs, coef, skip, work, dims, scale, 0.f, 0.f, has_own, n_sets, stream);
}
#endif
