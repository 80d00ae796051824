// Flash self-attention, f32 in and out, head dim 512, sm_90a.
//
// Replaces the D=512 f32 contract of the Pallas TPU kernel
// aid_tpu/ops/flash_attention.py::_kernel (flash_attention.py:101), which the
// JAX package reaches from the VAE mid-block attention (vae.py:57-65): one
// head, self mode, softmax(q k^T * scale) v with an f32 softmax and an f32
// output. 16384 tokens per 1024px frame, 4096 per 512px frame or tile (4000
// at the tiled decode's ragged tile); the plain version materialises the
// S x S f32 logits (1 GiB a 1024px frame), this kernel keeps them on chip.
//
// What bounds it on the card: 4*S*S*D = 550 GFLOP per frame at S = 16384
// against ~134 MB of q/k/v/out, so the products bind. Plain TF32 keeps only
// ~4e-4 of max |out| (tests/test_torch_ops.py), which would break the f32
// decode's 1e-4 promise, and f32 outside the tensor cores runs at 67
// TFLOP/s (8.2 ms a frame at best). So each product runs as three
// tensor-core passes, TF32 and bf16 (below): 1.5 TF32 and 1.5 bf16 passes
// a product on average, whose times add on the tensor cores (495 and 989
// TFLOP/s), 2.50 ms a frame, are this kernel's bound
// (chip_smoke.F32_D512_PASSES); three TF32 passes would take 3.33. The
// split (a = hi + lo):
//   * hi is the raw f32 operand (the tensor cores read a tf32 operand's top
//     19 bits), lo = a - trunc(a), exact in f32, read truncated in turn;
//   * Q K^T = hi(Q) hi(K) + lo(Q) hi(K) in tf32 + bf16(Q) bf16(lo(K)): K's
//     lo is stored in bf16 (half the bytes of a tf32 copy) and its pass is
//     a bf16 wgmma;
//   * P V = hi(P) hi(V) in tf32 + one packed bf16 pass, lo(V) P + V lo(P)
//     (each k16 step holds 8 keys twice: bf16(lo(V)) against bf16(P), then
//     bf16(V) against bf16(lo(P))).
//   Modelled at D = 512 in this kernel's tile order (tests/test_torch_ops.py
//   ::_d512_tiled_attention): 1.6e-6 of max |out| over 4096 keys, 2.3e-6
//   over 16384; with K's lo dropped 6e-4 and 9e-4, over the 1e-4 promise.
//
// The design: wgmma for both products, every tile by TMA, a producer
// warpgroup and two consumer warpgroups.
//   * A block owns 64 query rows. Their Q tile (64 x 512 f32, 128 KB) stays
//     in shared memory for the whole key loop, as TMA landed it: 16 boxes of
//     32 columns (128-byte rows, the 128-byte swizzle). Each key tile, the
//     consumers read it a 32-column chunk at a time into A fragments: the
//     raw words (hi), their lo and their bf16 (a 64 x 512 Q in registers
//     would not fit beside the output; read through a descriptor instead,
//     the hi pass measured slower: every m64 A operand from shared memory
//     is 2 KB a k8 step against the K tile's 0.5 KB).
//   * D is split between the two consumer warpgroups (256 columns each,
//     flash_attention_bf16_d512.cu's scheme): each computes the partial
//     scores of the 16-key tile over its 256 columns (S = Q K^T, wgmma
//     m64n16, K through K-major descriptors), writes them to shared memory
//     in accumulator order, meets the other at a named barrier and adds
//     theirs; both then hold the same f32 scores (one addition,
//     commutative) and run the same online softmax.
//   * Each consumer warpgroup makes its own half of K's lo in bf16 from the
//     raw K tile while its first chunk's tf32 products run (8-column halves
//     in the K-major layout of the bf16 pass's B operand, each 16 columns
//     in the order the bf16 fragments hold them: t, t + 4, t + 8, t + 12 at
//     k = 2t .. 2t + 9), then a warpgroup barrier. Made by the producer's
//     warps instead, it measured slower: the consumers waited for it after
//     the K tile landed.
//   * P V runs transposed, O^T = V^T P^T: tf32 wgmma takes only K-major
//     shared-memory operands, and V's natural tile (keys by D) is K-major
//     for V^T as the A operand in registers. So each warpgroup's 256 rows of
//     O^T are four m64n64 accumulators (128 registers a thread), V^T's
//     fragments are read from the raw V tile per 64 rows, and P^T's hi
//     (tf32, keys permuted within each 8-key step: k = t holds key 2t, k =
//     t + 4 key 2t + 1, as V^T's fragments, free of bank conflicts) and its
//     packed bf16 row (64 queries by 16 keys, 4 KB each, the 64-byte
//     swizzle) are the B operands, written once a tile by the softmax, each
//     warpgroup the rows of its half. No transposed copy of V and no V lo
//     are stored.
//   * Each 64-row block of O^T sums a tile's P V from zero on the tensor
//     cores and folds it into O by an f32 FMA with the factor of each query
//     column (from shared memory): summed in place, the tensor cores'
//     truncating accumulation drifted 1.3e-4 of max |out| over 16384 keys
//     (the mma.sync design this replaces).
//   * The producer warpgroup (setmaxnreg 24, the consumers 240): one thread
//     issues every TMA copy.
//   * Shared memory: Q 128 KB + K 32 + K's lo 16 + V 32 + P^T 8 + the score
//     exchange 8 + the rows' factors 0.5 = 224.5 KB, of the 227 KB a block
//     can use. So one slot each for K and V: K(j + 1) loads while tile j's
//     exchange, softmax and P V run, V(j + 1) while tile j + 1's Q K^T
//     runs; 32-key tiles or a second slot do not fit beside the resident Q.
//   * Ragged key tails are masked with -inf scores on zero-filled rows;
//     ragged query tails load zeros and are not stored. The output leaves
//     from the O^T registers, normalised, at the output's own strides.
// What holds it back: the 16-key tiles. Q K^T then runs as wgmma m64n16,
// 80 of them a warpgroup a tile, and an m64n16 costs far more than its
// share of the tensor-core rate (tools/f32_d512_ablation.py, PERF.md §6,
// times the kernel with Q K^T's small passes, P V, K's lo or the exchange
// taken out). Packing Q K^T's two small passes into one bf16 product a k8
// step (64 instructions, K's packed terms in 32 KB with the exchange and
// P^T moved into them) measured slower; so did 64-column chunks (their
// fragments spill).
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled, taken
// through cudaGetDriverEntryPoint (no -lcuda at link time; tma_sm90.cuh),
// and passed as __grid_constant__ parameters.
//
// The static-shift softmax (`static_smax`, the static branch of `_kernel` at
// flash_attention.py:210-256) is this body built with AID_STATIC_SHIFT = 1 by
// flash_attention_f32_d512_static.cu, a translation unit of its own (entry
// aid_flash_attn_f32_d512_static). Each tile's P is exp2f(min(s * sl2 -
// shift_log2, clip_log2)), the shift C and the 30-nat clip in log2 units after
// the scale: no row max and no quad max, no rows' factors in shared memory
// (the stat block holds 1 / l alone), and each 64-row block of O^T's tile
// product is added to O with no factor. The product is still summed from zero
// and added in f32, not accumulated in place on the tensor cores: their
// truncating accumulation is the drift the fold avoids (above), and the
// decode's 1e-4 promise holds it. P's hi/lo split is unchanged (P ~ e^-40
// stays well inside f32's, tf32's and bf16's exponent range), and each row's
// sum is guarded (max(l, 1e-37)) as the JAX kernels' denominator is.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef AID_STATIC_SHIFT
#define AID_STATIC_SHIFT 0
#endif

namespace {
#if AID_STATIC_SHIFT
namespace static_shift {  // kernel names of their own beside the exact instance's in one library
#endif

#include "tf32_mma.cuh"

constexpr bool kStatic = AID_STATIC_SHIFT != 0;

constexpr int kD = 512;                     // head dim
constexpr int kBQ = 64;                     // query rows per block
constexpr int kBK = 16;                     // keys per K/V tile
constexpr int kWG = 2;                      // consumer warpgroups, D / kWG columns each
constexpr int kThreads = 128 * (kWG + 1);   // + the producer warpgroup
constexpr int kCols = kD / kWG;             // 256 columns of Q K^T's depth and of O per warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 * 24 + 256 * 240 = 384 * 168
constexpr int kBoxes = kD / 32;             // 32-column (128-byte) boxes of an f32 row: 16
constexpr int kQBytes = kBQ * 128 * kBoxes;        // 131072
constexpr int kKVBytes = kBK * 128 * kBoxes;       // one K or V tile: 32768
constexpr int kKLoBytes = kBK * 128 * (kD / 64);   // K's lo in bf16, boxes of 64 columns: 16384
constexpr int kPBytes = kBQ * kBK * 4;             // P^T's hi (tf32), or its packed bf16 terms: 4096
constexpr int kXBytes = kWG * (kBK / 2) * 128 * 4; // the score exchange: 8192
// offsets from the 1024-byte-aligned base
constexpr int kQOff = 0;
constexpr int kKOff = kQOff + kQBytes;
constexpr int kKLoOff = kKOff + kKVBytes;
constexpr int kVOff = kKLoOff + kKLoBytes;
constexpr int kPHiOff = kVOff + kKVBytes;
constexpr int kPBfOff = kPHiOff + kPBytes;
constexpr int kXOff = kPBfOff + kPBytes;
constexpr int kStatOff = kXOff + kXBytes;          // alpha[64] (exact instance only), then 1 / l [64]
constexpr int kBarOff = kStatOff + (kStatic ? 1 : 2) * kBQ * 4;    // qbar, kfull, kempty, vfull, vempty
constexpr int kSmemBytes = 1024 + kBarOff + 5 * 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block can use");
static_assert(128 * kProducerRegs + 128 * kWG * kConsumerRegs <= kThreads * 168, "setmaxnreg budget");

struct Params {
  float* out;
  long long sob, soh, sos;  // the output's (b, h, s) element strides
  int Sq, Lk;
  float scale_log2;         // softmax scale * log2(e)
  float shift_log2, clip_log2;  // the static shift C and the clip, * log2(e) (kStatic instance only)
};

// The 64-byte swizzle (P^T's 64-byte rows): chunk j of row r at j ^ (r / 2 % 4)
__device__ __forceinline__ uint32_t swz64(uint32_t off) { return off ^ (((off >> 7) & 3) << 4); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S(64 x 16, f32) += A(64 x 16, bf16 registers) B(16 x 16, bf16, K-major in 128-byte-swizzled shared memory)
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O^T(64 x 64, f32) += A(64 x 16, bf16 registers) B(16 x 64, bf16, K-major in 64-byte-swizzled shared memory)
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// This warpgroup's half of K's lo in bf16 from the raw K tile (thread ct
// of 128): item (key r, 8-column half hf of 16-column group cg) reads two
// 16-byte chunks of box cg / 2 and writes one 16-byte chunk of box cg / 4
// of K_lo: words i = 0..3 holding columns 8 hf + i and 8 hf + i + 4, the k
// order of the bf16 fragments (k = 2t, 2t + 1 from columns t, t + 4; k =
// 2t + 8, 2t + 9 from t + 8, t + 12).
__device__ __forceinline__ void make_klo(const unsigned char* kt, unsigned char* kl, int wg, int ct) {
#pragma unroll
  for (int it = 0; it < kBK * (kCols / 8) / 128; ++it) {
    const int item = ct + 128 * it, r = item % kBK, half = (kCols / 8) * wg + item / kBK;
    const int cg = half / 2, hf = half % 2;
    const unsigned char* src = kt + (cg / 2) * (kBK * 128) + r * 128;
    const float4 a = *reinterpret_cast<const float4*>(src + (((cg % 2) * 4 + 2 * hf) ^ (r % 8)) * 16);
    const float4 c = *reinterpret_cast<const float4*>(src + (((cg % 2) * 4 + 2 * hf + 1) ^ (r % 8)) * 16);
    unsigned char* dst = kl + (cg / 4) * (kBK * 128) + r * 128 + (((cg % 4) * 2 + hf) ^ (r % 8)) * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        pack_bf16(tf32_rest(a.x), tf32_rest(c.x)), pack_bf16(tf32_rest(a.y), tf32_rest(c.y)),
        pack_bf16(tf32_rest(a.z), tf32_rest(c.z)), pack_bf16(tf32_rest(a.w), tf32_rest(c.w)));
  }
}

// A row's sum: the thread's partial sums reduced over the quad; at the
// static shift guarded, so a row whose every key underflowed gives 0
__device__ __forceinline__ float row_sum(float l) {
  if constexpr (kStatic) return fmaxf(quad_sum(l), 1e-37f);
  return quad_sum(l);
}

// Maps: q, k, v, each (D, H, S, B) with boxes of 32 columns by kBQ (q) or kBK (k, v) rows.
__global__ void __launch_bounds__(kThreads, 1)
    flash_f32_d512_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                          const __grid_constant__ CUtensorMap vm, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte-swizzled tiles are 1024-byte aligned
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t qs = base + kQOff, ks = base + kKOff, kls = base + kKLoOff, vs = base + kVOff;
  const uint32_t phs = base + kPHiOff, pbs = base + kPBfOff;
  const uint32_t qbar = base + kBarOff, kfull = qbar + 8, kempty = qbar + 16, vfull = qbar + 24, vempty = qbar + 32;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int ntiles = (p.Lk + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(qbar, 1);
    mbar_init(kfull, 1);
    mbar_init(vfull, 1);
    mbar_init(kempty, 4 * kWG);  // one arrival per consumer warp
    mbar_init(vempty, 4 * kWG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWG) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 128 * kWG) {
      mbar_expect_tx(qbar, kQBytes);
      for (int c = 0; c < kBoxes; ++c) tma_load(qs + c * (kBQ * 128), &qm, qbar, 32 * c, h, q0, b);
      // K(j) once tile j - 1's Q K^T is done, V(j) once its P V is
      for (int j = 0; j < ntiles; ++j) {
        if (j > 0) mbar_wait(kempty, (j - 1) & 1);
        mbar_expect_tx(kfull, kKVBytes);
        for (int c = 0; c < kBoxes; ++c) tma_load(ks + c * (kBK * 128), &km, kfull, 32 * c, h, j * kBK, b);
        if (j > 0) mbar_wait(vempty, (j - 1) & 1);
        mbar_expect_tx(vfull, kKVBytes);
        for (int c = 0; c < kBoxes; ++c) tma_load(vs + c * (kBK * 128), &vm, vfull, 32 * c, h, j * kBK, b);
      }
    }
  } else {
    // consumer warpgroup wg: columns kCols * wg .. of Q K^T's depth, rows kCols * wg .. of O^T
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ct = tid & 127, warp = ct >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const float* qf = reinterpret_cast<const float*>(gbase + kQOff);
    const float* vf = reinterpret_cast<const float*>(gbase + kVOff);
    float* xs = reinterpret_cast<float*>(gbase + kXOff);
    float* alpha = reinterpret_cast<float*>(gbase + kStatOff);
    float* linv = alpha + (kStatic ? 0 : kBQ);  // the static instance keeps no factors
    unsigned char* ph = gbase + kPHiOff;
    unsigned char* pb = gbase + kPBfOff;
    const float sl2 = p.scale_log2;
    // this warpgroup writes P^T's and the factors' rows of its half (warps 2 wg, 2 wg + 1 hold them)
    const bool writer = (warp >> 1) == wg;
    mbar_wait(qbar, 0);

    float o[4][32];  // O^T rows kCols * wg + 64 mi .., in the m64n64 accumulator layout
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[mi][i] = 0.f;
    }
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows 16 warp + g, + 8

    // Q's fragments of 32-column chunk c (box 8 wg + c), rows 16 warp + g
    // (+ 8), columns 8 kk + t (+ 4): hi (the raw words) and lo (tf32, k8
    // steps kk), and bf16 (k16 steps i: columns t, t + 4 at k = 2t, 2t + 1
    // and t + 8, t + 12 at 2t + 8, 2t + 9). Rows r and r + 8 share r % 8 =
    // g, so the swizzle is g's.
    auto load_q = [&](int c, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4], uint32_t (&bf)[2][4]) {
      const float* box = qf + ((kBoxes / kWG) * wg + c) * (kBQ * 32) + (16 * warp + g) * 32 + t;
      float x[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[kk][e] = box[(e & 1) * 8 * 32 + (((2 * kk + (e >> 1)) ^ g) << 2)];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[kk][e] = __float_as_uint(x[kk][e]);
          lo[kk][e] = __float_as_uint(tf32_rest(x[kk][e]));
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bf[i][0] = pack_bf16(x[2 * i][0], x[2 * i][2]);
        bf[i][1] = pack_bf16(x[2 * i][1], x[2 * i][3]);
        bf[i][2] = pack_bf16(x[2 * i + 1][0], x[2 * i + 1][2]);
        bf[i][3] = pack_bf16(x[2 * i + 1][1], x[2 * i + 1][3]);
      }
    };
    // V^T's fragments of O^T's 64-row block mi for the tile's two k8
    // steps: rows (head-dim columns) kCols wg + 64 mi + 16 warp + g (+ 8),
    // keys 2t and 2t + 1 of each step; hi (the raw words, tf32: k = t and t +
    // 4) and the packed bf16 terms (k16: lo(V) at k = 2t, 2t + 1, V at 2t +
    // 8, 2t + 9, against P at keys 0..7 and lo(P) at 8..15 of P^T's packed row)
    auto load_v = [&](int mi, uint32_t (&hi)[2][4], uint32_t (&pk)[2][4]) {
      const int box = (kBoxes / kWG) * wg + 2 * mi + (warp >> 1);
      const float* vb = vf + box * (kBK * 32) + (g & 3);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * kk + 2 * t + (e >> 1), chunk = 4 * (warp & 1) + (g >> 2) + 2 * (e & 1);
          x[e] = vb[key * 32 + ((chunk ^ (key & 7)) << 2)];
          hi[kk][e] = __float_as_uint(x[e]);
        }
        pk[kk][0] = pack_bf16(tf32_rest(x[0]), tf32_rest(x[2]));
        pk[kk][1] = pack_bf16(tf32_rest(x[1]), tf32_rest(x[3]));
        pk[kk][2] = pack_bf16(x[0], x[2]);
        pk[kk][3] = pack_bf16(x[1], x[3]);
      }
    };

    for (int j = 0; j < ntiles; ++j) {
      // ---- partial scores over this warpgroup's 256 columns: hi*hi into s,
      // lo(Q) hi(K) and bf16(Q) bf16(lo(K)) into sm, a 32-column chunk at a time
      float s[8], sm[8];
      uint32_t qhi[4][4], qlo[4][4], qbf[2][4];
      mbar_wait(kfull, j & 1);
      load_q(0, qhi, qlo, qbf);
#pragma unroll
      for (int c = 0; c < kCols / 32; ++c) {
        const int box = (kBoxes / kWG) * wg + c;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t kd = desc_sw128(ks + box * (kBK * 128) + kk * 32);
          wgmma_tf32(s, qhi[kk], kd, c + kk > 0);
          wgmma_tf32(sm, qlo[kk], kd, c + kk > 0);
        }
        if (c == 0) {
          // this warpgroup's half of K's lo while the first tf32 products run
          wgmma_commit();
          make_klo(gbase + kKOff, gbase + kKLoOff, wg, ct);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic stores -> wgmma's proxy
          asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
          wgmma_fence();
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wgmma_bf16_rs(sm, qbf[i], desc_sw128(kls + (box / 2) * (kBK * 128) + (box % 2) * 64 + i * 32));
        }
        wgmma_commit();
        if (c + 1 < kCols / 32) {
          wgmma_wait0();  // the chunk's products are done: its fragments' registers are free
          reg_fence(qhi);
          reg_fence(qlo);
          reg_fence(qbf);
          load_q(c + 1, qhi, qlo, qbf);
        }
      }
      wgmma_wait0();
      reg_fence(s);
      reg_fence(sm);
      reg_fence(qhi);
      reg_fence(qlo);
      reg_fence(qbf);
      __syncwarp();
      if (lane == 0) mbar_arrive(kempty);  // K is free

      // ---- exchange: our partial scores out in accumulator order, meet the
      // other warpgroup, add theirs
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] += sm[i];
      {
        float* mine = xs + wg * 8 * 128 + ct;
        const float* theirs = xs + (1 - wg) * 8 * 128 + ct;
#pragma unroll
        for (int i = 0; i < 8; ++i) mine[i * 128] = s[i];
        asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] += theirs[i * 128];
      }

      // ---- online softmax of rows 16 warp + g (s[4n], s[4n + 1]) and + 8
      // (s[4n + 2], s[4n + 3]), keys 8n + 2t and 8n + 2t + 1
      const int valid = min(kBK, p.Lk - j * kBK);
      if (valid < kBK) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if ((i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
        }
      }
      // the exact softmax's running max (al: the factors that take O to the new
      // max); the static shift's P has a fixed offset and clip instead, no factors
      float al0 = 1.f, al1 = 1.f;
      float pv[8];
      if constexpr (kStatic) {
        // P = 2^min(s sl2 - shift_log2, clip_log2) (a masked key stays -inf and gives 0)
#pragma unroll
        for (int i = 0; i < 8; ++i) pv[i] = exp2f(fminf(fmaf(s[i], sl2, -p.shift_log2), p.clip_log2));
        l0 += pv[0] + pv[1] + pv[4] + pv[5];
        l1 += pv[2] + pv[3] + pv[6] + pv[7];
      } else {
        const float mx0 = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[4], s[5]));
        const float mx1 = fmaxf(fmaxf(s[2], s[3]), fmaxf(s[6], s[7]));
        // every tile holds at least one real key, so the new max is finite
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        al0 = exp2f((m0 - mn0) * sl2);  // 0 on the first tile
        al1 = exp2f((m1 - mn1) * sl2);
        m0 = mn0;
        m1 = mn1;
        const float ms0 = mn0 * sl2, ms1 = mn1 * sl2;
#pragma unroll
        for (int i = 0; i < 8; ++i) pv[i] = exp2f(fmaf(s[i], sl2, (i & 2) ? -ms1 : -ms0));
        l0 = l0 * al0 + (pv[0] + pv[1] + pv[4] + pv[5]);
        l1 = l1 * al1 + (pv[2] + pv[3] + pv[6] + pv[7]);
      }
      if (writer) {
        // P^T row r (a query), k8 step n. hi: keys 2t and 2t + 1 at k = t and
        // t + 4; packed bf16: P of keys 2t, 2t + 1 at k = 2t, 2t + 1, lo(P)
        // at k = 2t + 8, 2t + 9
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
          *reinterpret_cast<float*>(ph + swz64(r * 64 + (i / 4) * 32 + (t + 4 * (i & 1)) * 4)) = pv[i];
        }
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
          const uint32_t off = r * 64 + (i / 4) * 32 + 4 * t;
          *reinterpret_cast<uint32_t*>(pb + swz64(off)) = pack_bf16(pv[i], pv[i + 1]);
          *reinterpret_cast<uint32_t*>(pb + swz64(off + 16)) = pack_bf16(tf32_rest(pv[i]), tf32_rest(pv[i + 1]));
        }
        if (!kStatic && t == 0) {
          alpha[16 * warp + g] = al0;
          alpha[16 * warp + g + 8] = al1;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // P^T's stores -> wgmma's proxy
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");

      // ---- O^T = O^T * alpha + V^T P^T, a 64-row block at a time, each
      // block's product summed from zero and folded by FMA: hi*hi in tf32,
      // lo(V) P + V lo(P) in one packed bf16 product per k8 step (the static
      // instance adds each block's product, with no factor)
      float2 a[8];  // the factors of this thread's query columns 8n + 2t, 8n + 2t + 1
      if constexpr (!kStatic) {
#pragma unroll
        for (int n = 0; n < 8; ++n) a[n] = *reinterpret_cast<const float2*>(alpha + 8 * n + 2 * t);
      }
      uint32_t vhi[2][2][4], vpk[2][2][4];
      mbar_wait(vfull, j & 1);
      load_v(0, vhi[0], vpk[0]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        float acc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) wgmma_tf32(acc, vhi[mi & 1][kk], desc_sw64(phs + kk * 32), kk > 0);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) wgmma_bf16_rs(acc, vpk[mi & 1][kk], desc_sw64(pbs + kk * 32));
        wgmma_commit();
        if (mi + 1 < 4) load_v(mi + 1, vhi[(mi + 1) & 1], vpk[(mi + 1) & 1]);
        wgmma_wait0();
        reg_fence(acc);
        reg_fence(vhi[mi & 1]);
        reg_fence(vpk[mi & 1]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if constexpr (kStatic) {
            o[mi][4 * n] += acc[4 * n];
            o[mi][4 * n + 1] += acc[4 * n + 1];
            o[mi][4 * n + 2] += acc[4 * n + 2];
            o[mi][4 * n + 3] += acc[4 * n + 3];
          } else {
            o[mi][4 * n] = fmaf(o[mi][4 * n], a[n].x, acc[4 * n]);
            o[mi][4 * n + 1] = fmaf(o[mi][4 * n + 1], a[n].y, acc[4 * n + 1]);
            o[mi][4 * n + 2] = fmaf(o[mi][4 * n + 2], a[n].x, acc[4 * n + 2]);
            o[mi][4 * n + 3] = fmaf(o[mi][4 * n + 3], a[n].y, acc[4 * n + 3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(vempty);  // V is free
    }

    // ---- 1 / l of every query row, then O = (O^T)^T / l at the output's strides
    const float i0 = 1.f / row_sum(l0), i1 = 1.f / row_sum(l1);
    if (writer && t == 0) {
      linv[16 * warp + g] = i0;
      linv[16 * warp + g + 8] = i1;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");
    float* ob = p.out + b * p.sob + h * p.soh + kCols * wg + 16 * warp + g;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * n + 2 * t + e;
        if (q0 + q >= p.Sq) continue;
        const float inv = linv[q];
        float* orow = ob + (long long)(q0 + q) * p.sos;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          orow[64 * mi] = o[mi][4 * n + e] * inv;
          orow[64 * mi + 8] = o[mi][4 * n + 2 + e] * inv;
        }
      }
    }
  }
}

// A (D, H, S, B) map of an f32 operand at element strides (b, h, s), boxes
// of 32 columns by `rows` rows, 128-byte swizzle, zeros out of bounds. A
// batch stride of 0 (one tensor shared by every row) becomes a batch extent of 1.
bool encode_map(CUtensorMap* map, const void* ptr, int H, int S, int B, const long long* strides, int rows) {
  const long long sb = strides[0], sh = strides[1], ss = strides[2];
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)H, (cuuint64_t)S, sb == 0 ? 1u : (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)sh * 4, (cuuint64_t)ss * 4, (cuuint64_t)(sb == 0 ? ss * S + sh * H : sb) * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1}, unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, bytes, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The entries' body: the operands' alignment checked, the maps encoded, the kernel launched
int entry(const void* q, const void* k, const void* v, void* out, const long long* dims, float scale,
          float shift_log2, float clip_log2, void* stream) {
  if (dims[2] <= 0 || dims[3] <= 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) return (int)cudaErrorMisalignedAddress;
    for (int j = 0; j < 3; ++j) {
      if (dims[4 + 3 * i + j] % 4 != 0) return (int)cudaErrorMisalignedAddress;
    }
  }
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  const int B = (int)dims[0], H = (int)dims[1];
  Params p;
  p.out = static_cast<float*>(out);
  p.sob = dims[13];
  p.soh = dims[14];
  p.sos = dims[15];
  p.Sq = (int)dims[2];
  p.Lk = (int)dims[3];
  p.scale_log2 = scale * 1.4426950408889634f;
  p.shift_log2 = shift_log2;
  p.clip_log2 = clip_log2;
  CUtensorMap m[3];
  const int rows[3] = {p.Sq, p.Lk, p.Lk}, box[3] = {kBQ, kBK, kBK};
  for (int i = 0; i < 3; ++i) {
    if (!encode_map(&m[i], ptrs[i], H, rows[i], B, dims + 4 + 3 * i, box[i])) return (int)cudaErrorInvalidValue;
  }
  static bool smem_allowed = false;  // the kernel's shared memory does not change
  const cudaError_t err = allow_smem_once(reinterpret_cast<const void*>(&flash_f32_d512_kernel), kSmemBytes,
                                          smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.Sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_f32_d512_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(m[0], m[1], m[2], p);
  return (int)cudaGetLastError();
}

#if AID_STATIC_SHIFT
}  // namespace static_shift
using static_shift::entry;
#endif
}  // namespace

#if AID_STATIC_SHIFT
// The static-shift instance: aid_flash_attn_f32_d512's arguments with the
// shift C and the clip after the scale, both times log2(e) (p = 2^min(s *
// scale * log2(e) - shift_log2, clip_log2)). Returns the launch's cudaError_t.
extern "C" int aid_flash_attn_f32_d512_static(const void* q, const void* k, const void* v, void* out,
                                              const long long* dims, float scale, float shift_log2, float clip_log2,
                                              void* stream) {
  return entry(q, k, v, out, dims, scale, shift_log2, clip_log2, stream);
}
#else
// dims: [B, H, Sq, Lk, then (b, h, s) element strides of q, k, v, out]
// (16 values). q, k and v are f32 with the head dim contiguous, 16-byte
// aligned, their other strides multiples of 4 elements; the output is
// written at its own strides. Returns the launch's cudaError_t (0 on
// success).
extern "C" int aid_flash_attn_f32_d512(const void* q, const void* k, const void* v, void* out,
                                       const long long* dims, float scale, void* stream) {
  return entry(q, k, v, out, dims, scale, 0.f, 0.f, stream);
}
#endif
