// Flash interpolated attention, f32 in and out, head dims 161-512 in the four endpoint modes and in self
// mode, sm_90a.
//
// Replaces the f32 endpoint-mode and self-mode contracts of the Pallas TPU
// kernels behind aid_tpu/ops/flash_attention.py::flash_interpolated_attention
// at head dims 161-512 (self mode at D = 512 exactly stays on the VAE's
// flash_attention_f32_d512.cu): `_kernel` (flash_attention.py:101) and
// `_kernel_onepass` (flash_attention.py:339), reached from an f32 SD 1.x UNet
// whose heads are 161-512 wide. The modes, the segments, the skip rows, the
// outer modes' two softmax sets and self mode's instance with no endpoint set
// (NSETS = 0: the own segment alone) are flash_attention_dmid.cu's (see there).
//
// What bounds it on the card: the products. Plain TF32 keeps ~4e-4 of max
// |out|, over the f32 promise, and f32 outside the tensor cores runs at 67
// TFLOP/s, so each product runs as three tensor-core passes with the split
// of flash_attention_f32_d512.cu (its self kernel's skeleton): a = hi + lo with hi the
// raw f32 word (read as tf32) and lo = a - trunc(a);
//   Q K^T = hi(Q) hi(K) + lo(Q) hi(K) in tf32 + bf16(Q) bf16(lo(K)),
//   P V   = hi(P) hi(V) in tf32 + one packed bf16 pass, lo(V) P + V lo(P):
// 1.5 TF32 and 1.5 bf16 passes a product on average (chip_smoke.F32_D512_PASSES),
// the numerics of the D = 512 design. What that design lost at 161-512 was
// the padding (every call computed 512 columns) and the 16-key tile (an
// m64n16 wgmma costs far more than its share of the tensor-core rate). The
// design here:
//   * the caller's D in 32-column chunks (C = ceil(D / 32)): the tensor maps
//     run over the caller's tensors with dim 0 of extent D, the chunks' columns
//     past D come in as zeros, and no padded copy is made. The shared memory
//     is laid out at run time for C, so the smaller Q tile leaves room for
//     32-key tiles where C <= 10 (D <= 320: m64n32 Q K^T, half the tiles and
//     their fixed costs), 16-key tiles above;
//   * a block owns 64 query rows; their Q tile stays in shared memory as TMA
//     landed it (boxes of 32 columns, 128-byte rows, the 128-byte swizzle) and
//     the consumers read it a chunk at a time into A fragments (hi, lo, bf16);
//   * two consumer warpgroups split the work of a tile: P V runs transposed,
//     O^T = V^T P^T (tf32 wgmma takes only K-major shared-memory operands,
//     and V's natural tile is K-major for V^T in registers), in 64-row M
//     blocks of D (MB = ceil(C / 2)); each warpgroup takes MBW = ceil(MB / 2)
//     of them, warpgroup 1 the last MBW, so where MB is odd both compute the
//     middle one and warpgroup 0 stores it (a branch around a wgmma would
//     serialise every product, ptxas C7520), and half of the Q K^T chunks.
//     Each computes the partial scores over its chunks, makes its chunks' K
//     lo in bf16 while its first chunk's tf32 products run, exchanges the
//     partial scores with the other at a named barrier, and both run the
//     same online softmax; each writes half the rows of P^T (hi, and the
//     packed bf16 row) and of the rows' factors;
//   * each M block of O^T sums a tile's P V from zero on the tensor cores and
//     is folded into O by an f32 FMA with the factor of each query column
//     (summed in place, the tensor cores' truncating accumulation drifts);
//   * one slot each for K and V beside the resident Q tile (a producer
//     warpgroup, one thread issuing every TMA copy): K(j + 1) loads while tile
//     j's exchange, softmax and P V run, V(j + 1) while tile j + 1's Q K^T
//     runs;
//   * the outer modes park the own segment's state in a global f32 workspace
//     the wrapper allocates per call (O^T's 32 MBW accumulators, m[2], l[2]
//     for each of the 256 consumer threads), as flash_attention_dmid.cu does;
//   * ragged key tails are masked with -inf scores on zero-filled rows; the
//     output leaves from the O^T registers, normalised, at the output's
//     strides, rows past Sq and head-dim rows past D not stored.
// Templates: MBW (the most M blocks a warpgroup holds: 2 at D <= 256, 3 at D
// <= 384, 4 above) and BK (32 where C <= 10, else 16). The tensor maps are
// encoded on the host with cuTensorMapEncodeTiled (tma_sm90.cuh) and kept in
// a small cache keyed by everything they encode (map_cache.cuh). Measured
// times, bounds and the ablation are in PERF.md.
//
// The static-shift softmax (`static_smax`, the static branch of `_kernel` at
// flash_attention.py:210-256) is this body built with AID_STATIC_SHIFT = 1 by
// flash_attention_dmid_f32_static.cu, a translation unit of its own (entry
// aid_flash_attn_f32_dmid_static, every mode and self mode). As in
// flash_attention_f32_d512.cu's static instance, each tile's P is
// exp2f(min(s * sl2 - shift_log2, clip_log2)), the shift C and the 30-nat
// clip in log2 units after the scale: no row max, no quad max, no rows'
// factors written to shared memory, and each M block's tile product (still
// summed from zero on the tensor cores) is added to O with no factor. The
// outer modes' park keeps O and l and no max (the workspace's layout is the
// exact instances'; the max words go unused), the own segment's state added
// to both sets unchanged, as the JAX branch's w0 / w1 weights do. Each row's
// sum is guarded (max(l, 1e-37)) as the JAX kernels' denominator is.

#include <cuda.h>
#include <cuda_bf16.h>
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

constexpr int kWG = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (kWG + 1);   // + the producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 * 24 + 256 * 240 = 384 * 168
constexpr int kSmemLimit = 232448;          // the 227 KB a block can use
constexpr int kWideTileChunks = 10;         // 32-key tiles up to this many 32-column chunks (tests read it)
static_assert(128 * kProducerRegs + 128 * kWG * kConsumerRegs <= kThreads * 168, "setmaxnreg budget");

// The shared memory of a block at C chunks and BK keys a tile, offsets from
// the 1024-byte-aligned base (tests/test_torch_dmid.py mirrors it)
struct Layout {
  int q, k, klo, v, phi, pbf, x, stat, bar, bytes;
  __host__ __device__ Layout(int C, int BK) {
    const int mb = (C + 1) / 2;
    q = 0;
    k = q + C * 64 * 128;                  // Q: C boxes of 32 f32 columns by 64 rows
    klo = k + C * BK * 128;                // K: C boxes of BK rows
    v = klo + ((C + 1) / 2) * BK * 128;    // K's lo in bf16: boxes of 64 columns
    phi = v + 2 * mb * BK * 128;           // V: 2 MB boxes (the last past D zero-filled where C is odd)
    pbf = phi + 64 * BK * 4;               // P^T's hi: 64 query rows of BK tf32
    x = pbf + 64 * BK * 4;                 // P^T's packed bf16 terms: 64 rows of 2 BK bf16
    stat = x + kWG * (BK / 2) * 128 * 4;   // the score exchange
    bar = stat + 2 * 64 * 4;               // alpha[64], then 1 / l [64]
    bytes = 1024 + bar + 5 * 8;            // qbar, kfull, kempty, vfull, vempty
  }
};

struct Params {
  float* out;
  long long sob, soh, sos;  // the output's (b, h, s) element strides
  const float* coef;        // (B,) f32, read by the outer modes
  const uint8_t* skip;      // (B,) bool or null, read by the fused modes
  float* work;              // the outer modes' parked states: (blocks, 32 MBW + 4, 256) f32
  int Sq, Lk, Le, D;
  int C;                    // 32-column chunks of D
  int cq0;                  // warpgroup 0's Q K^T chunks (warpgroup 1 the rest)
  int shared_eps;           // bit i: endpoint map i (k_begin, v_begin, k_end, v_end) is one (H, Le, D) tensor
  float scale_log2;         // softmax scale * log2(e)
  float shift_log2, clip_log2;  // the static shift C and the clip, * log2(e) (kStatic instances only)
};

// A row's sum: the thread's partial sums reduced over the quad; at the
// static shift guarded, so a row whose every key underflowed gives 0
__device__ __forceinline__ float row_sum(float l) {
  if constexpr (kStatic) return fmaxf(quad_sum(l), 1e-37f);
  return quad_sum(l);
}

// P^T's rows under the swizzle of their width: 64 bytes (16 keys; chunk j of
// row r at j ^ (r / 2 % 4)) or 128 bytes (32 keys; j ^ (r % 8))
template <int BK>
__device__ __forceinline__ uint32_t swz_p(uint32_t off) {
  if constexpr (BK == 16) {
    return off ^ (((off >> 7) & 3) << 4);
  } else {
    return off ^ (((off >> 7) & 7) << 4);
  }
}
template <int BK>
__device__ __forceinline__ uint64_t desc_p(uint32_t addr) {
  if constexpr (BK == 16) {
    return desc_sw64(addr);
  } else {
    return desc_sw128(addr);
  }
}

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

// S(64 x 32, f32) += A(64 x 16, bf16 registers) B(16 x 32, bf16, K-major in 128-byte-swizzled shared memory)
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O^T(64 x 64, f32) += A(64 x 16, bf16 registers) B(16 x 64, bf16, K-major in swizzled shared memory)
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

// This warpgroup's chunks cs .. cs + n - 1 of K's lo in bf16 from the raw K
// tile (thread ct of 128): item (key r, 8-column half hf of 16-column group
// cg) reads two 16-byte chunks of box cg / 2 and writes one 16-byte chunk of
// box cg / 4 of K_lo: words i = 0..3 holding columns 8 hf + i and 8 hf + i +
// 4, the k order of the bf16 fragments (k = 2t, 2t + 1 from columns t, t + 4;
// k = 2t + 8, 2t + 9 from t + 8, t + 12).
template <int BK>
__device__ __forceinline__ void make_klo(const unsigned char* kt, unsigned char* kl, int cs, int n, int ct) {
  for (int item = ct; item < BK * 4 * n; item += 128) {
    const int r = item % BK, half = 4 * cs + item / BK;
    const int cg = half / 2, hf = half % 2;
    const unsigned char* src = kt + (cg / 2) * (BK * 128) + r * 128;
    const float4 a = *reinterpret_cast<const float4*>(src + (((cg % 2) * 4 + 2 * hf) ^ (r % 8)) * 16);
    const float4 c = *reinterpret_cast<const float4*>(src + (((cg % 2) * 4 + 2 * hf + 1) ^ (r % 8)) * 16);
    unsigned char* dst = kl + (cg / 4) * (BK * 128) + r * 128 + (((cg % 4) * 2 + hf) ^ (r % 8)) * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        pack_bf16(tf32_rest(a.x), tf32_rest(c.x)), pack_bf16(tf32_rest(a.y), tf32_rest(c.y)),
        pack_bf16(tf32_rest(a.z), tf32_rest(c.z)), pack_bf16(tf32_rest(a.w), tf32_rest(c.w)));
  }
}

// HAS_OWN: the row's own K/V segment leads the stream (fused modes, self).
// NSETS: 0 = none (self: the own segment alone), 1 = one cross segment
// (inner), 2 = begin and end blended by coef (outer).
// Maps: q, k, v, k_begin, v_begin, k_end, v_end, each (D, H, S, B) with
// boxes of 32 columns by 64 (q) or BK rows.
template <int MBW, int BK, bool HAS_OWN, int NSETS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_f32_dmid_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                          const __grid_constant__ CUtensorMap vm, const __grid_constant__ CUtensorMap kbm,
                          const __grid_constant__ CUtensorMap vbm, const __grid_constant__ CUtensorMap kem,
                          const __grid_constant__ CUtensorMap vem, const Params p) {
  constexpr int NK = BK / 2;          // score registers a thread
  constexpr int KS = BK / 8;          // k8 steps of a tile's keys
  constexpr int kParkWords = 32 * MBW + 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte-swizzled tiles are 1024-byte aligned
  unsigned char* gbase = smem_raw + (base - raw);
  const Layout ly(p.C, BK);
  const uint32_t qs = base + ly.q, ks = base + ly.k, kls = base + ly.klo, vs = base + ly.v;
  const uint32_t phs = base + ly.phi, pbs = base + ly.pbf;
  const uint32_t qbar = base + ly.bar, kfull = qbar + 8, kempty = qbar + 16, vfull = qbar + 24, vempty = qbar + 32;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 64;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int mb = (p.C + 1) / 2;
  // a skip row drops its endpoint segments; the pure modes never skip
  const bool skip = HAS_OWN && p.skip != nullptr && p.skip[b] != 0;
  const int n_own = HAS_OWN ? (p.Lk + BK - 1) / BK : 0, n_ep = (p.Le + BK - 1) / BK;
  const int ntiles = n_own + (skip ? 0 : NSETS * n_ep);
  // tile j of the stream: its segment (0 own, 1 begin or cross, 2 end) and its first key
  auto seg_of = [&](int j) { return j < n_own ? 0 : 1 + (j - n_own) / n_ep; };
  auto row_of = [&](int j) { return j < n_own ? j * BK : ((j - n_own) % n_ep) * BK; };

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
      mbar_expect_tx(qbar, p.C * 64 * 128);
      for (int c = 0; c < p.C; ++c) tma_load(qs + c * (64 * 128), &qm, qbar, 32 * c, h, q0, b);
      // K(j) once tile j - 1's Q K^T is done, V(j) once its P V is
      for (int j = 0; j < ntiles; ++j) {
        const int seg = seg_of(j), r0 = row_of(j);
        const CUtensorMap* kmap = seg == 0 ? &km : seg == 1 ? &kbm : &kem;
        const CUtensorMap* vmap = seg == 0 ? &vm : seg == 1 ? &vbm : &vem;
        const int kb = seg > 0 && ((p.shared_eps >> (2 * (seg - 1))) & 1) ? 0 : b;
        const int vb = seg > 0 && ((p.shared_eps >> (2 * (seg - 1) + 1)) & 1) ? 0 : b;
        if (j > 0) mbar_wait(kempty, (j - 1) & 1);
        mbar_expect_tx(kfull, p.C * BK * 128);
        for (int c = 0; c < p.C; ++c) tma_load(ks + c * (BK * 128), kmap, kfull, 32 * c, h, r0, kb);
        if (j > 0) mbar_wait(vempty, (j - 1) & 1);
        mbar_expect_tx(vfull, 2 * mb * BK * 128);
        for (int c = 0; c < 2 * mb; ++c) tma_load(vs + c * (BK * 128), vmap, vfull, 32 * c, h, r0, vb);
      }
    }
    return;
  }

  // consumer warpgroup wg: Q K^T's chunks cs .. cs + nc - 1, O^T's M blocks ms .. ms + MBW - 1
  // (warpgroup 1's first one also warpgroup 0's last where MB is odd: only warpgroup 0 stores it)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int ct = tid & 127, warp = ct >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int cs = wg == 0 ? 0 : p.cq0, nc = wg == 0 ? p.cq0 : p.C - p.cq0;
  const int ms = wg == 0 ? 0 : mb - MBW;
  const float* qf = reinterpret_cast<const float*>(gbase + ly.q);
  const float* vf = reinterpret_cast<const float*>(gbase + ly.v);
  float* xs = reinterpret_cast<float*>(gbase + ly.x);
  float* alpha = reinterpret_cast<float*>(gbase + ly.stat);
  float* linv = alpha + 64;
  unsigned char* ph = gbase + ly.phi;
  unsigned char* pb = gbase + ly.pbf;
  const float sl2 = p.scale_log2;
  // this warpgroup writes P^T's and the factors' rows of its half (warps 2 wg, 2 wg + 1 hold them)
  const bool writer = (warp >> 1) == wg;
  mbar_wait(qbar, 0);

  float o[MBW][32];  // O^T rows 64 (ms + mi) .., in the m64n64 accumulator layout
#pragma unroll
  for (int mi = 0; mi < MBW; ++mi) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[mi][i] = 0.f;
  }
  [[maybe_unused]] float m0 = -INFINITY, m1 = -INFINITY;  // rows 16 warp + g, + 8 (the static instances keep no max)
  float l0 = 0.f, l1 = 0.f;

  // Q's fragments of chunk c (box c), rows 16 warp + g (+ 8), columns 8 kk
  // + t (+ 4): hi (the raw words) and lo (tf32, k8 steps kk), and bf16 (k16
  // steps i: columns t, t + 4 at k = 2t, 2t + 1 and t + 8, t + 12 at 2t + 8,
  // 2t + 9). Rows r and r + 8 share r % 8 = g, so the swizzle is g's.
  auto load_q = [&](int c, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4], uint32_t (&bf)[2][4]) {
    const float* box = qf + c * (64 * 32) + (16 * warp + g) * 32 + t;
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
  // V^T's fragments of O^T's M block gm for the tile's k8 steps: rows
  // (head-dim columns) 64 gm + 16 warp + g (+ 8), keys 2t and 2t + 1 of each
  // step; hi (the raw words, tf32: k = t and t + 4) and the packed bf16 terms
  // (k16: lo(V) at k = 2t, 2t + 1, V at 2t + 8, 2t + 9, against P at keys
  // 0..7 and lo(P) at 8..15 of each 8-key step of P^T's packed row)
  auto load_v = [&](int gm, uint32_t (&hi)[KS][4], uint32_t (&pk)[KS][4]) {
    const float* vb = vf + (2 * gm + (warp >> 1)) * (BK * 32) + (g & 3);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
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

  // tiles t0 .. t1 - 1 into the running state
  auto run = [&](int t0, int t1) {
    for (int j = t0; j < t1; ++j) {
      // ---- partial scores over this warpgroup's chunks: hi*hi into s, lo(Q)
      // hi(K) and bf16(Q) bf16(lo(K)) into sm, a 32-column chunk at a time
      float s[NK], sm[NK];
      uint32_t qhi[4][4], qlo[4][4], qbf[2][4];
      mbar_wait(kfull, j & 1);
      load_q(cs, qhi, qlo, qbf);
      // the first chunk, with this warpgroup's chunks of K's lo made while its tf32 products run
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t kd = desc_sw128(ks + cs * (BK * 128) + kk * 32);
        wgmma_tf32(s, qhi[kk], kd, kk > 0);
        wgmma_tf32(sm, qlo[kk], kd, kk > 0);
      }
      wgmma_commit();
      make_klo<BK>(gbase + ly.k, gbase + ly.klo, cs, nc, ct);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic stores -> wgmma's proxy
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wgmma_bf16_rs(sm, qbf[i], desc_sw128(kls + (cs / 2) * (BK * 128) + (cs % 2) * 64 + i * 32));
      }
      wgmma_commit();
      wgmma_wait0();  // the chunk's products are done: its fragments' registers are free
      reg_fence(qhi);
      reg_fence(qlo);
      reg_fence(qbf);
      // the rest of this warpgroup's chunks
#pragma unroll 1
      for (int c = cs + 1; c < cs + nc; ++c) {
        load_q(c, qhi, qlo, qbf);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t kd = desc_sw128(ks + c * (BK * 128) + kk * 32);
          wgmma_tf32(s, qhi[kk], kd, 1);
          wgmma_tf32(sm, qlo[kk], kd, 1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wgmma_bf16_rs(sm, qbf[i], desc_sw128(kls + (c / 2) * (BK * 128) + (c % 2) * 64 + i * 32));
        }
        wgmma_commit();
        wgmma_wait0();
        reg_fence(qhi);
        reg_fence(qlo);
        reg_fence(qbf);
      }
      reg_fence(s);
      reg_fence(sm);
      __syncwarp();
      if (lane == 0) mbar_arrive(kempty);  // K is free

      // ---- exchange: our partial scores out in accumulator order, meet the
      // other warpgroup, add theirs
#pragma unroll
      for (int i = 0; i < NK; ++i) s[i] += sm[i];
      {
        float* mine = xs + wg * NK * 128 + ct;
        const float* theirs = xs + (1 - wg) * NK * 128 + ct;
#pragma unroll
        for (int i = 0; i < NK; ++i) mine[i * 128] = s[i];
        asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");
#pragma unroll
        for (int i = 0; i < NK; ++i) s[i] += theirs[i * 128];
      }

      // ---- online softmax of rows 16 warp + g (s[4n], s[4n + 1]) and + 8
      // (s[4n + 2], s[4n + 3]), keys 8n + 2t and 8n + 2t + 1
      const int valid = min(BK, (seg_of(j) == 0 ? p.Lk : p.Le) - row_of(j));
      if (valid < BK) {  // the segment's last tile: keys past its length do not exist
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          if ((i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
        }
      }
      // the exact softmax's running max (al: the factors that take O to the new
      // max); the static shift's P has a fixed offset and clip instead, no factors
      float al0 = 1.f, al1 = 1.f;
      float pv[NK];
      if constexpr (kStatic) {
        // P = 2^min(s sl2 - shift_log2, clip_log2) (a masked key stays -inf and gives 0)
#pragma unroll
        for (int i = 0; i < NK; ++i) pv[i] = exp2f(fminf(fmaf(s[i], sl2, -p.shift_log2), p.clip_log2));
      } else {
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
        // every tile holds at least one real key, so the new max is finite
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        al0 = exp2f((m0 - mn0) * sl2);  // 0 on a set's first tile
        al1 = exp2f((m1 - mn1) * sl2);
        m0 = mn0;
        m1 = mn1;
        const float ms0 = mn0 * sl2, ms1 = mn1 * sl2;
#pragma unroll
        for (int i = 0; i < NK; ++i) pv[i] = exp2f(fmaf(s[i], sl2, (i & 2) ? -ms1 : -ms0));
      }
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        ls0 += pv[4 * n] + pv[4 * n + 1];
        ls1 += pv[4 * n + 2] + pv[4 * n + 3];
      }
      if constexpr (kStatic) {
        l0 += ls0;
        l1 += ls1;
      } else {
        l0 = l0 * al0 + ls0;
        l1 = l1 * al1 + ls1;
      }
      if (writer) {
        // P^T row r (a query), k8 step n. hi: keys 2t and 2t + 1 at k = t and
        // t + 4; packed bf16: P of keys 2t, 2t + 1 at k = 2t, 2t + 1, lo(P)
        // at k = 2t + 8, 2t + 9
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
          *reinterpret_cast<float*>(ph + swz_p<BK>(r * (BK * 4) + (i / 4) * 32 + (t + 4 * (i & 1)) * 4)) = pv[i];
        }
#pragma unroll
        for (int i = 0; i < NK; i += 2) {
          const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
          const uint32_t off = r * (BK * 4) + (i / 4) * 32 + 4 * t;
          *reinterpret_cast<uint32_t*>(pb + swz_p<BK>(off)) = pack_bf16(pv[i], pv[i + 1]);
          *reinterpret_cast<uint32_t*>(pb + swz_p<BK>(off + 16)) =
              pack_bf16(tf32_rest(pv[i]), tf32_rest(pv[i + 1]));
        }
        if (!kStatic && t == 0) {
          alpha[16 * warp + g] = al0;
          alpha[16 * warp + g + 8] = al1;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // P^T's stores -> wgmma's proxy
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");

      // ---- O^T = O^T * alpha + V^T P^T, an M block at a time, each block's
      // product summed from zero and folded by FMA: hi*hi in tf32, lo(V) P +
      // V lo(P) in one packed bf16 product per k8 step
      uint32_t vhi[2][KS][4], vpk[2][KS][4];
      mbar_wait(vfull, j & 1);
      load_v(ms, vhi[0], vpk[0]);
#pragma unroll
      for (int mi = 0; mi < MBW; ++mi) {
        float acc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) wgmma_tf32(acc, vhi[mi & 1][kk], desc_p<BK>(phs + kk * 32), kk > 0);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) wgmma_bf16_rs(acc, vpk[mi & 1][kk], desc_p<BK>(pbs + kk * 32));
        wgmma_commit();
        if (mi + 1 < MBW) load_v(ms + mi + 1, vhi[(mi + 1) & 1], vpk[(mi + 1) & 1]);
        wgmma_wait0();
        reg_fence(acc);
        reg_fence(vhi[mi & 1]);
        reg_fence(vpk[mi & 1]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {  // the factors of this thread's query columns 8n + 2t, 8n + 2t + 1
          if constexpr (kStatic) {  // the static shift's product adds with no factor
            o[mi][4 * n] += acc[4 * n];
            o[mi][4 * n + 1] += acc[4 * n + 1];
            o[mi][4 * n + 2] += acc[4 * n + 2];
            o[mi][4 * n + 3] += acc[4 * n + 3];
          } else {
            const float2 a = *reinterpret_cast<const float2*>(alpha + 8 * n + 2 * t);
            o[mi][4 * n] = fmaf(o[mi][4 * n], a.x, acc[4 * n]);
            o[mi][4 * n + 1] = fmaf(o[mi][4 * n + 1], a.y, acc[4 * n + 1]);
            o[mi][4 * n + 2] = fmaf(o[mi][4 * n + 2], a.x, acc[4 * n + 2]);
            o[mi][4 * n + 3] = fmaf(o[mi][4 * n + 3], a.y, acc[4 * n + 3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(vempty);  // V is free
    }
  };
  // O^T = w O^T / l: each row's 1 / l through shared memory to the threads
  // that hold its query column
  auto normalise = [&](float w) {
    const float i0 = w / row_sum(l0), i1 = w / row_sum(l1);
    if (writer && t == 0) {
      linv[16 * warp + g] = i0;
      linv[16 * warp + g + 8] = i1;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float inv = linv[8 * n + 2 * t + e];
#pragma unroll
        for (int mi = 0; mi < MBW; ++mi) {
          o[mi][4 * n + e] *= inv;
          o[mi][4 * n + 2 + e] *= inv;
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");  // linv is read before it is rewritten
  };

  if (NSETS == 2 && !skip) {
    // this thread's parked words in the block's workspace, 256 apart: made
    // again where they are used, so that no pointer holds a register through the runs
    auto parked = [&]() {
      return p.work + (size_t)((b * gridDim.y + h) * gridDim.x + blockIdx.x) * (kParkWords * 256) + tid;
    };
    // run 0 the own segment (fused), 1 begin, 2 end; one call site, so a
    // tile's code is compiled once
#pragma unroll 1
    for (int r = HAS_OWN ? 0 : 1; r < 3; ++r) {
      run(r == 0 ? 0 : n_own + (r - 1) * n_ep, r == 0 ? n_own : n_own + r * n_ep);
      float* park = parked();
      if (r == 0) {  // park the own segment's state: the end segment continues it too
#pragma unroll
        for (int i = 0; i < 32 * MBW; ++i) park[i * 256] = o[i / 32][i % 32];
        if constexpr (!kStatic) {  // the static shift keeps no max
          park[(32 * MBW) * 256] = m0;
          park[(32 * MBW + 1) * 256] = m1;
        }
        park[(32 * MBW + 2) * 256] = l0;
        park[(32 * MBW + 3) * 256] = l1;
      } else if (r == 1) {
        normalise(1.f - p.coef[b]);
        if (HAS_OWN) {  // swap (1 - c) O_begin / l with the parked own state
#pragma unroll
          for (int i = 0; i < 32 * MBW; ++i) {
            const float own = park[i * 256];
            park[i * 256] = o[i / 32][i % 32];
            o[i / 32][i % 32] = own;
          }
          if constexpr (!kStatic) {
            m0 = park[(32 * MBW) * 256];
            m1 = park[(32 * MBW + 1) * 256];
          }
          l0 = park[(32 * MBW + 2) * 256];
          l1 = park[(32 * MBW + 3) * 256];
        } else {  // park it, and start the end set afresh
#pragma unroll
          for (int i = 0; i < 32 * MBW; ++i) {
            park[i * 256] = o[i / 32][i % 32];
            o[i / 32][i % 32] = 0.f;
          }
          if constexpr (!kStatic) m0 = m1 = -INFINITY;
          l0 = l1 = 0.f;
        }
      }
    }
    normalise(p.coef[b]);
    const float* park = parked();
#pragma unroll
    for (int i = 0; i < 32 * MBW; ++i) o[i / 32][i % 32] += park[i * 256];
  } else {
    run(0, ntiles);
    normalise(1.f);
  }

  // O = (O^T)^T at the output's strides: head-dim rows past D and query rows past Sq are not stored
  float* ob = p.out + b * p.sob + h * p.soh;
#pragma unroll
  for (int mi = 0; mi < MBW; ++mi) {
    if (wg == 1 && ms + mi < MBW) continue;  // warpgroup 0's
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = 64 * (ms + mi) + 16 * warp + g + 8 * half;
      if (d >= p.D) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 8 * n + 2 * t + e;
          if (q0 + q < p.Sq) ob[(long long)(q0 + q) * p.sos + d] = o[mi][4 * n + 2 * half + e];
        }
      }
    }
  }
}

// A (D, H, S, B) map of an f32 operand at element strides (b, h, s), boxes
// of 32 columns by `rows` rows, 128-byte swizzle, zeros out of bounds (past D
// and past S), from the cache of maps (map_cache.cuh).
bool encode_map(CUtensorMap* map, const void* ptr, int D, int H, int S, int B, const long long* strides, int rows) {
  return encode_map_cached(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, D, H, S, B, strides, 32, rows);
}

template <int MBW, int BK, bool HAS_OWN, int NSETS>
int launch(const CUtensorMap (&m)[7], const Params& p, int H, int B, cudaStream_t s) {
  static bool smem_allowed = false;  // once per instance and process: the most any C of the instance takes
  const cudaError_t err = allow_smem_once(reinterpret_cast<const void*>(&flash_f32_dmid_kernel<MBW, BK, HAS_OWN, NSETS>),
                                          kSmemLimit, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.Sq + 63) / 64), (unsigned)H, (unsigned)B);
  flash_f32_dmid_kernel<MBW, BK, HAS_OWN, NSETS><<<grid, kThreads, Layout(p.C, BK).bytes, s>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], p);
  return (int)cudaGetLastError();
}

template <int MBW, int BK>
int launch_modes(const CUtensorMap (&m)[7], const Params& p, int H, int B, int has_own, int n_sets, cudaStream_t s) {
  if (n_sets == 0) return launch<MBW, BK, true, 0>(m, p, H, B, s);
  if (has_own && n_sets == 1) return launch<MBW, BK, true, 1>(m, p, H, B, s);
  if (has_own && n_sets == 2) return launch<MBW, BK, true, 2>(m, p, H, B, s);
  if (!has_own && n_sets == 1) return launch<MBW, BK, false, 1>(m, p, H, B, s);
  return launch<MBW, BK, false, 2>(m, p, H, B, s);
}

// The f32 entries' body: the operands checked, the maps encoded, the instance launched
int entry(const void* q, const void* k, const void* v, const void* kb, const void* vb, const void* ke,
          const void* ve, void* out, const void* coef, const void* skip, void* work, const long long* dims,
          float scale, float shift_log2, float clip_log2, int has_own, int n_sets, void* stream) {
  const int B = (int)dims[0], H = (int)dims[1], D = (int)dims[5];
  if (B <= 0 || H <= 0 || dims[2] <= 0 || dims[3] <= 0 || (n_sets > 0 && dims[4] <= 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (D <= 160 || D > 512 || D % 4 != 0) return (int)cudaErrorInvalidValue;
  // self mode (n_sets 0) streams the own segment: it needs has_own and reads no endpoint
  if (n_sets < 0 || n_sets > 2 || (n_sets == 0 && !has_own) || (n_sets == 2 && (coef == nullptr || work == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[7] = {q, k, v, kb, vb, ke, ve};
  for (int i = 0; i < 7; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) return (int)cudaErrorMisalignedAddress;
    for (int j = 0; j < 3; ++j) {
      if (dims[6 + 3 * i + j] % 4 != 0) return (int)cudaErrorMisalignedAddress;
    }
  }
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  Params p;
  p.out = static_cast<float*>(out);
  p.sob = dims[27];
  p.soh = dims[28];
  p.sos = dims[29];
  p.coef = static_cast<const float*>(coef);
  p.skip = static_cast<const uint8_t*>(skip);
  p.work = static_cast<float*>(work);
  p.Sq = (int)dims[2];
  p.Lk = (int)dims[3];
  p.Le = (int)dims[4];
  p.D = D;
  p.C = (D + 31) / 32;
  const int mb = (p.C + 1) / 2, mbw = (mb + 1) / 2, bk = p.C <= kWideTileChunks ? 32 : 16;
  p.cq0 = p.C / 2;  // each warpgroup half the chunks of Q K^T and MBW M blocks of P V
  p.shared_eps = 0;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.shift_log2 = shift_log2;
  p.clip_log2 = clip_log2;
  // rows of each map: queries, own keys, endpoint keys x4
  const int rows[7] = {p.Sq, p.Lk, p.Lk, p.Le, p.Le, p.Le, p.Le};
  CUtensorMap m[7];
  for (int i = 0; i < 7; ++i) {
    const long long* st = dims + 6 + 3 * i;
    if ((!has_own && (i == 1 || i == 2)) || (n_sets == 0 && i >= 3)) {  // never read: any valid map
      m[i] = m[0];
      continue;
    }
    if (!encode_map(&m[i], ptrs[i], D, H, rows[i], B, st, i == 0 ? 64 : bk)) return (int)cudaErrorInvalidValue;
    if (i >= 3 && st[0] == 0) p.shared_eps |= 1 << (i - 3);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mbw == 2) return launch_modes<2, 32>(m, p, H, B, has_own, n_sets, s);
  if (mbw == 3 && bk == 32) return launch_modes<3, 32>(m, p, H, B, has_own, n_sets, s);
  if (mbw == 3) return launch_modes<3, 16>(m, p, H, B, has_own, n_sets, s);
  return launch_modes<4, 16>(m, p, H, B, has_own, n_sets, s);
}

#if AID_STATIC_SHIFT
}  // namespace static_shift
using static_shift::entry;
#endif
}  // namespace

#if AID_STATIC_SHIFT
// The static-shift instance: aid_flash_attn_f32_dmid's arguments with the
// shift C and the clip after the scale, both times log2(e) (p = 2^min(s *
// scale * log2(e) - shift_log2, clip_log2)), every mode and self mode, the
// same workspace. Returns the launch's cudaError_t.
extern "C" int aid_flash_attn_f32_dmid_static(const void* q, const void* k, const void* v, const void* kb,
                                              const void* vb, const void* ke, const void* ve, void* out,
                                              const void* coef, const void* skip, void* work, const long long* dims,
                                              float scale, float shift_log2, float clip_log2, int has_own,
                                              int n_sets, void* stream) {
  return entry(q, k, v, kb, vb, ke, ve, out, coef, skip, work, dims, scale, shift_log2, clip_log2, has_own, n_sets,
               stream);
}
#else
// The endpoint modes at head dims 161-512 in f32: the C signature of
// aid_flash_attn_bf16_dmid (flash_attention_dmid.cu). dims are [B, H, Sq,
// Lk, Le, D, then (b, h, s) element strides of q, k, v, k_begin, v_begin,
// k_end, v_end, out] (30 values; a b stride of 0 marks an endpoint shared by
// every row), D the operands' head dim (161..512, a multiple of 4: 16-byte
// rows); has_own 1 in the fused modes and self mode; n_sets 2 in the outer
// modes, 1 in the inner ones (their lerped K/V in the begin slot), 0 in self
// mode (has_own 1: the own K/V alone; coef, skip and work null, the endpoint
// pointers and Le not read); work the outer modes' f32
// workspace, B * H * ceil(Sq / 64) * (32 MBW + 4) * 256 floats with MBW =
// ceil(ceil(ceil(D / 32) / 2) / 2) (null in the inner modes and self). The inputs are
// f32 with the head dim contiguous, 16-byte aligned, their other strides
// multiples of 4 elements; the output is written at its own strides. Returns
// the launch's cudaError_t (0 on success).
extern "C" int aid_flash_attn_f32_dmid(const void* q, const void* k, const void* v, const void* kb, const void* vb,
                                       const void* ke, const void* ve, void* out, const void* coef, const void* skip,
                                       void* work, const long long* dims, float scale, int has_own, int n_sets,
                                       void* stream) {
  return entry(q, k, v, kb, vb, ke, ve, out, coef, skip, work, dims, scale, 0.f, 0.f, has_own, n_sets, stream);
}
#endif
