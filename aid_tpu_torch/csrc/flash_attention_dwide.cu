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
// and at 64 tokens by the bytes. What stands between a design and that rate at D > 512 is the
// on-chip room: the D = 512 kernels keep a 64-row Q tile resident (64 KB in
// bf16, 128 KB in f32) beside their K and V tiles and use all but 2 KB of
// the 227 KB a block can have, and a 64-row x D f32 output is 2D registers a
// thread for one warpgroup. The design:
//   * a block owns BQ query rows, 32 where the head dim padded to a multiple
//     of 128 (Dp) is at most 1024, else 16 (a template parameter, MT = BQ /
//     16), so that the Q tile (BQ x Dp, 64 KB in bf16, 128 KB in f32) stays
//     resident over the whole key loop and BQ x Dp f32 outputs are 128
//     registers for each of 256 threads (slot i: row block i / (32 / MT),
//     n8 tile i % (32 / MT) of the warp's columns);
//   * each of the block's eight warps owns Dp / 8 columns, for both
//     products: it computes the partial scores of its columns (Q K^T over
//     its slice of D) and the output of its columns (P V with V's columns of
//     its slice). The partial scores go to shared memory, and the softmax
//     sums the eight in warp order: the only exchange, once a key tile, and
//     no product is computed twice (a grid over output slices would compute
//     Q K^T once a slice; a cluster would move the exchange into distributed
//     shared memory);
//   * mma.sync on the tensor cores (wgmma takes 64 rows a warpgroup, and the
//     rows a block can hold at this D are 16 or 32): m16n8k16 in bf16 and
//     f16, P rounded to the input type, f32 accumulation; in f32 m16n8k8 in
//     3xTF32 (a = hi + lo, hi = tf32(a) rounded, lo = a - hi; hi*hi + hi*lo +
//     lo*hi); fragments of Q, K and V by ldmatrix (.trans for V) in bf16
//     and f16; key tiles of 32 keys in bf16 / f16 and 16 in f32 where Q and
//     one K and one V tile fit beside them, else 16 and 8;
//   * K and V tiles (all Dp columns, 16-byte cp.async copies that zero-fill
//     past the caller's D and past a segment's length, with no division in
//     the issuing loop) have one buffer each: K of tile j + 1 loads while
//     tile j's softmax and P V run, V of tile j + 1 while tile j + 1's Q K^T
//     runs. Where Q and both do not fit (f32 past Dp = 1792), K and V share
//     one buffer and each copy waits. (Deeper rings fit only beside 16-key
//     tiles, which lost to the 32-key ones: PERF.md §6.);
//   * each tile's P V is summed from zero and folded into O with one f32 FMA
//     a value (the tensor cores' f32 accumulation truncates);
//   * the key stream is a list of segments (the own K/V, then begin and end,
//     or the lerped cross K/V the wrapper passes in the begin slot), each of
//     its own length; a shared (H, Le, D) endpoint has a batch stride of 0; a
//     skip row (fused modes) streams its own segment alone. The outer modes'
//     first softmax set is parked in a global f32 workspace (word i of every
//     thread side by side, then the rows' max and sum) at the set boundary,
//     as the D=512 endpoint entries park theirs: the own segment's state
//     after its last tile, swapped with (1 - c) O_begin / l after the begin
//     segment, so the end segment continues the own state;
//   * ragged key tails are masked with -inf scores; ragged query tails load
//     zeros and are not stored; the output is written at the caller's D.
// What it costs: each block reads all of K and V once per 16 or 32 query
// rows, where the D = 512 kernels read them once per 64 (a factor of 2 to 4
// in L2 traffic), and mma.sync runs below wgmma's rate. With 8 warps a
// block and one block an SM (255 registers a thread), the four block-wide
// barriers of a key tile put the latencies of its phases (loads, Q K^T,
// softmax, P V) end to end: tools/dwide_ablation.py times each part. PERF.md
// has its times.
//
// One design, three element types: T = __nv_bfloat16 is aid_flash_attn_
// bf16_dwide, T = __half aid_flash_attn_f16_dwide, T = float
// aid_flash_attn_f32_dwide.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

#include "elem16.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = 8;
constexpr int kSlots = 32;                       // n8 tiles of O a thread holds: (BQ / 16) * (Dp / 64)
constexpr int kRowsMax = 32;                     // query rows of a block at most
constexpr int kParkWords = 4 * kSlots;           // a thread's parked O
constexpr int kParkBlock = kParkWords * kThreads + 2 * kRowsMax;  // + the rows' max and sum
constexpr int kMaxD = 2048;
constexpr int kSmemMax = 232448;

template <class T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}
// the key tile of an instance: 16 or 32 keys in bf16 and f16 (one or two
// k16 steps of P V), 8 or 16 in f32 (k8 steps); the host takes the larger
// where Q and one K and one V tile fit beside it
template <class T>
__host__ __device__ constexpr int small_key_tile() {
  return is_f32<T>() ? 8 : 16;
}
// elements in 16 bytes: rows are padded by one such chunk, so that a warp's
// fragment loads are free of bank conflicts
template <class T>
__host__ __device__ constexpr int row_pad() {
  return 16 / (int)sizeof(T);
}
__host__ __device__ constexpr int score_ld(int bk) {
  return bk + 8;
}

struct Params {
  const void* ptr[8];      // q, k, v, k_begin, v_begin, k_end, v_end, out
  long long st[8][3];      // their (b, h, s) element strides; b 0 for a shared endpoint
  const float* coef;       // (B,) f32, read by the outer modes
  const uint8_t* skip;     // (B,) bool or null, read by the fused modes
  float* work;             // the outer modes' parked states: (blocks, kParkBlock) f32
  int Sq, Lk, Le, D, Dp, mt;
  int has_own, n_sets;
  int kv_shared;           // K and V share one tile's buffer
  float scale_log2;        // softmax scale * log2(e)
};

// Shared-memory bytes of a launch with `bk`-key tiles, K and V in one
// buffer each or (kv_shared) in one together; the kernel lays them out the same way
template <class T>
int smem_bytes(int Dp, int mt, int bk, bool kv_shared) {
  const int ld = Dp + row_pad<T>(), bq = 16 * mt;
  return (int)sizeof(T) * ld * (bq + (kv_shared ? 1 : 2) * bk) +
         4 * (kWarps * bq * score_ld(bk) + bq * score_ld(bk) + 3 * kRowsMax);
}

// 16-byte async copy global -> shared; zeros when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + rows) of one (b, h) sequence into rows of ld elements,
// columns [0, Dp): zeros past len and past the caller's D (a multiple of
// 16 bytes)
template <class T>
__device__ __forceinline__ void load_rows(T* dst, const T* base, long long stride, int row0, int rows, int len,
                                          int D, int Dp, int ld) {
  constexpr int E = 16 / (int)sizeof(T);
  const int per_row = Dp / E;  // 16-byte chunks a row
  // chunk threadIdx.x + 256 i is (r, c), stepped with no division in the loop
  const int dr = kThreads / per_row, dc = kThreads - dr * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  while (r < rows) {
    const int row = row0 + r, col = c * E;
    const bool ok = row < len && col < D;
    cp_async16(dst + r * ld + col, ok ? base + (long long)row * stride + col : base, ok);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// Four 8x8 b16 matrices from shared memory, lanes 8m .. 8m + 7 giving the
// rows of matrix m (16 bytes each); lane l holds row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 of matrix m in r[m], or with .trans those of
// its transpose (the stored matrix's rows 2 (l % 4), 2 (l % 4) + 1 at
// column l / 4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c(16x8, f32) += a(16x16, T, row) * b(16x8, T, col)
template <class T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
#define AID_ASM(TY)                                                                                    \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY                                      \
               ".f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"                           \
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])                                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// c(16x8, f32) += a(16x8, tf32, row) * b(8x8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a = hi + lo: hi = tf32(a) rounded to nearest, lo = a - hi exactly
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(a));
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// The tf32 A fragment (rows g, g + 8) of the 8 columns at p, row pitch ld,
// split. The k order inside a k8 step is free as long as A and B agree:
// fragment k = t and t + 4 are columns 2t and 2t + 1, one 8-byte load each.
__device__ __forceinline__ void load_a_split(const float* p, int ld, int g, int t, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const float2 r0 = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
  const float2 r1 = *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * t);
  split_tf32(r0.x, hi[0], lo[0]);
  split_tf32(r1.x, hi[1], lo[1]);
  split_tf32(r0.y, hi[2], lo[2]);
  split_tf32(r1.y, hi[3], lo[3]);
}

// N consecutive floats (N = 1, 2 or 4, 4N-byte aligned) in one load or store
template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BK keys a tile, MT m16 row blocks (BQ = 16 MT query rows) a block
template <class T, int BK, int MT>
__global__ void __launch_bounds__(kThreads, 1) flash_dwide_kernel(const Params p) {
  constexpr int SLD = score_ld(BK), BQ = 16 * MT;
  constexpr int NJ = kSlots / MT;  // slot i holds row block i / NJ, n8 tile i % NJ of the warp's columns
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = p.Dp, LD = Dp + row_pad<T>();
  const bool kv_shared = p.kv_shared;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * LD;
  T* Vs = kv_shared ? Ks : Ks + BK * LD;
  float* Ss = reinterpret_cast<float*>(Vs + BK * LD);  // [warp][BQ][SLD]: the partial scores
  float* Ps = Ss + kWarps * BQ * SLD;                  // [BQ][SLD]: the tile's probabilities
  float* row_m = Ps + BQ * SLD;                        // running max (log2 domain)
  float* row_l = row_m + kRowsMax;                     // running sum
  float* row_a = row_l + kRowsMax;                     // the tile's rescale factor

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int Dw = Dp / kWarps, c0 = warp * Dw, njc = Dw / 8;  // this warp's columns, in n8 tiles (<= NJ)
  // a skip row drops its endpoint segments; the pure modes never skip
  const bool skip = p.has_own && p.n_sets > 0 && p.skip != nullptr && p.skip[b] != 0;
  const int n_own = p.has_own ? (p.Lk + BK - 1) / BK : 0, n_ep = (p.Le + BK - 1) / BK;
  const int ntiles = n_own + (skip ? 0 : p.n_sets * n_ep);
  const bool outer = p.n_sets == 2 && !skip;
  // tile `it` of the stream: its segment (0 own, 1 begin or cross, 2 end) and its first key
  auto seg_of = [&](int it) { return it < n_own ? 0 : 1 + (it - n_own) / n_ep; };
  auto row_of = [&](int it) { return (it < n_own ? it : (it - n_own) % n_ep) * BK; };
  auto seq = [&](int i) {  // operand i's (b, h) sequence
    return static_cast<const T*>(p.ptr[i]) + b * p.st[i][0] + h * p.st[i][1];
  };
  // K (kv 0) or V (kv 1) of tile `it` into its buffer; nothing past the stream
  auto load_kv = [&](int it, int kv) {
    if (it >= ntiles) return;
    const int seg = seg_of(it), i = 1 + 2 * seg + kv;
    load_rows<T>(kv ? Vs : Ks, seq(i), p.st[i][2], row_of(it), BK, seg == 0 ? p.Lk : p.Le, p.D, Dp, LD);
  };
  // One commit group a copy, in the order K(0) (with Q), V(0), K(1), V(1),
  // ...: before Q K^T of tile it only V(it) is newer than K(it), before its
  // P V only K(it + 1) is newer than V(it) (empty groups past the stream's
  // end included). With a shared buffer each copy waits for the last.
  auto wait_tile = [&]() {
    if (kv_shared) {
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();
    }
  };

  load_rows<T>(Qs, seq(0), p.st[0][2], q0, BQ, p.Sq, p.D, Dp, LD);
  load_kv(0, 0);
  cp_async_commit();
  if (!kv_shared) load_kv(0, 1);
  cp_async_commit();
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float o[kSlots][4];  // slot i: rows 16 (i / NJ) .., columns c0 + 8 (i % NJ) .., used where i % NJ < njc
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  }

  // O *= w / l, row by row
  auto normalise = [&](float w) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (i % NJ < njc) {
        const int r = 16 * (i / NJ) + g;
        const float i0 = w / row_l[r], i1 = w / row_l[r + 8];
        o[i][0] *= i0;
        o[i][1] *= i0;
        o[i][2] *= i1;
        o[i][3] *= i1;
      }
    }
  };
  // this block's parked words: word (4 i + e) of thread tid at (4 i + e) * kThreads + tid
  auto parked = [&]() {
    return p.work + (size_t)((b * gridDim.y + h) * gridDim.x + blockIdx.x) * kParkBlock;
  };

  for (int it = 0; it < ntiles; ++it) {
    const T* Kt = Ks;
    const T* Vt = Vs;
    wait_tile();      // Q and K(it) have landed (V(it) may be in flight) ...
    __syncthreads();  // ... for every thread

    {  // partial scores of this warp's columns: BQ rows x BK keys
      float acc[2][BK / 8][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int nj = 0; nj < BK / 8; ++nj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
        }
      }
      const T* qw = Qs + c0;
      const T* kw = Kt + c0;
      if constexpr (is_f32<T>()) {
        // 3xTF32: big (hi*hi) and small (hi*lo + lo*hi) terms in separate accumulators
        float small[2][BK / 8][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int nj = 0; nj < BK / 8; ++nj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) small[mi][nj][e] = 0.f;
          }
        }
#pragma unroll 2
        for (int d = 0; d < Dw; d += 8) {
          uint32_t ahi[2][4], alo[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (mi < MT) load_a_split(qw + mi * 16 * LD + d, LD, g, t, ahi[mi], alo[mi]);
          }
#pragma unroll
          for (int nj = 0; nj < BK / 8; ++nj) {
            uint32_t bhi[2], blo[2];
            const float2 kv = *reinterpret_cast<const float2*>(kw + (8 * nj + g) * LD + d + 2 * t);
            split_tf32(kv.x, bhi[0], blo[0]);
            split_tf32(kv.y, bhi[1], blo[1]);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              if (mi < MT) {
                mma_tf32(small[mi][nj], alo[mi], bhi[0], bhi[1]);
                mma_tf32(small[mi][nj], ahi[mi], blo[0], blo[1]);
                mma_tf32(acc[mi][nj], ahi[mi], bhi[0], bhi[1]);
              }
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int nj = 0; nj < BK / 8; ++nj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][nj][e] += small[mi][nj][e];
          }
        }
      } else {
        // ldmatrix: A's four 8x8 blocks (rows 0-7 / 8-15 by columns 0-7 /
        // 8-15), and K's (keys 0-7 / 8-15 of each 16 by columns 0-7 / 8-15)
        // as the B fragments of two n8 tiles
        const uint32_t qa = smem_u32(qw) + 2 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4));
        const uint32_t kb = smem_u32(kw) + 2 * (((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1));
#pragma unroll 2
        for (int d = 0; d < Dw; d += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (mi < MT) ldsm_x4(a[mi], qa + 2 * (16 * mi * LD + d));
          }
#pragma unroll
          for (int kh = 0; kh < BK / 16; ++kh) {
            uint32_t bk[4];
            ldsm_x4(bk, kb + 2 * (16 * kh * LD + d));
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              if (mi < MT) {
                mma16<T>(acc[mi][2 * kh], a[mi], bk[0], bk[1]);
                mma16<T>(acc[mi][2 * kh + 1], a[mi], bk[2], bk[3]);
              }
            }
          }
        }
      }
      float* sw = Ss + warp * BQ * SLD;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (mi < MT) {
#pragma unroll
          for (int nj = 0; nj < BK / 8; ++nj) {
            float* sp = sw + (16 * mi + g) * SLD + 8 * nj + 2 * t;
            *reinterpret_cast<float2*>(sp) = make_float2(acc[mi][nj][0], acc[mi][nj][1]);
            *reinterpret_cast<float2*>(sp + 8 * SLD) = make_float2(acc[mi][nj][2], acc[mi][nj][3]);
          }
        }
      }
    }
    __syncthreads();  // the partial scores are complete and K(it)'s buffer is free
    load_kv(kv_shared ? it : it + 1, kv_shared ? 1 : 0);
    cp_async_commit();  // possibly empty: keeps the group count in step

    {  // online softmax: tpr threads a row (whole warps), kpt consecutive keys each
      constexpr int tpr = kThreads / BQ < BK ? kThreads / BQ : BK, kpt = BK / tpr;
      if (tid < BQ * tpr) {
        const int r = tid / tpr, kq = (tid % tpr) * kpt;
        const int valid = min(BK, (seg_of(it) == 0 ? p.Lk : p.Le) - row_of(it));  // >= 1
        const float m_old = row_m[r];  // read before the shuffles below, which every lane reaches
        float x[kpt];
#pragma unroll
        for (int i = 0; i < kpt; ++i) x[i] = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {  // the eight partial scores, summed in warp order
          float v[kpt];
          load_vec(v, Ss + (w * BQ + r) * SLD + kq);
#pragma unroll
          for (int i = 0; i < kpt; ++i) x[i] += v[i];
        }
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < kpt; ++i) {
          x[i] = kq + i < valid ? x[i] * p.scale_log2 : -INFINITY;
          mx = fmaxf(mx, x[i]);
        }
#pragma unroll
        for (int off = 1; off < tpr; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_old, mx);  // finite: every tile holds a real key
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kpt; ++i) {
          x[i] = exp2f(x[i] - m_new);  // masked keys: exp2(-inf) = 0
          sum += x[i];
        }
        store_vec(Ps + r * SLD + kq, x);
#pragma unroll
        for (int off = 1; off < tpr; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (tid % tpr == 0) {
          const float a = exp2f(m_old - m_new);  // 0 on a set's first tile
          row_a[r] = a;
          row_l[r] = row_l[r] * a + sum;
          row_m[r] = m_new;
        }
      }
    }
    wait_tile();      // V(it) has landed (K(it + 1) may be in flight) ...
    __syncthreads();  // ... everywhere; P and the rescale factors are visible

    {  // O = O * alpha + P V over this warp's columns, each tile's product summed from zero
      float al[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) al[mi][hf] = mi < MT ? row_a[16 * mi + g + 8 * hf] : 0.f;
      }
      if constexpr (is_f32<T>()) {
        // P's A fragments of each k8 step ks: keys 8 ks + 2t and 8 ks + 2t + 1 at k = t and t + 4
        uint32_t phi[2][BK / 8][4], plo[2][BK / 8][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int ks = 0; ks < BK / 8; ++ks) {
            if (mi < MT) load_a_split(Ps + 16 * mi * SLD + 8 * ks, SLD, g, t, phi[mi][ks], plo[mi][ks]);
          }
        }
        const float* vc = Vt + (2 * t) * LD + c0 + g;
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          const int mi = i / NJ, nj = i % NJ;
          if (nj < njc) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int ks = 0; ks < BK / 8; ++ks) {
              uint32_t bhi[2], blo[2];
              split_tf32(vc[8 * ks * LD + 8 * nj], bhi[0], blo[0]);
              split_tf32(vc[(8 * ks + 1) * LD + 8 * nj], bhi[1], blo[1]);
              mma_tf32(part, plo[mi][ks], bhi[0], bhi[1]);
              mma_tf32(part, phi[mi][ks], blo[0], blo[1]);
              mma_tf32(part, phi[mi][ks], bhi[0], bhi[1]);
            }
            const float s0 = al[mi][0], s1 = al[mi][1];
            o[i][0] = fmaf(o[i][0], s0, part[0]);
            o[i][1] = fmaf(o[i][1], s0, part[1]);
            o[i][2] = fmaf(o[i][2], s1, part[2]);
            o[i][3] = fmaf(o[i][3], s1, part[3]);
          }
        }
      } else {
        uint32_t pa[2][BK / 16][4];  // P rounded to T: the A fragments of rows 16 mi .., keys 16 ks ..
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks) {
            if (mi < MT) {
              const float* pr = Ps + (16 * mi + g) * SLD + 16 * ks + 2 * t;
              pa[mi][ks][0] = Elem<T>::pack(pr[0], pr[1]);
              pa[mi][ks][1] = Elem<T>::pack(pr[8 * SLD], pr[8 * SLD + 1]);
              pa[mi][ks][2] = Elem<T>::pack(pr[8], pr[9]);
              pa[mi][ks][3] = Elem<T>::pack(pr[8 * SLD + 8], pr[8 * SLD + 9]);
            }
          }
        }
        // V's B fragments of two n8 tiles (slots i, i + 1: njc is even) by
        // ldmatrix.trans: keys 0-7 / 8-15 by columns c0 + 8 nj + 0-7 / 8-15
        const uint32_t vb = smem_u32(Vt) + 2 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + c0 + 8 * (lane >> 4));
#pragma unroll
        for (int i = 0; i < kSlots; i += 2) {
          const int mi = i / NJ, nj = i % NJ;  // njc is even: slots i and i + 1 are used together
          if (nj < njc) {
            float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int ks = 0; ks < BK / 16; ++ks) {
              uint32_t b[4];
              ldsm_x4_t(b, vb + 2 * (16 * ks * LD + 8 * nj));
              mma16<T>(p0, pa[mi][ks], b[0], b[1]);
              mma16<T>(p1, pa[mi][ks], b[2], b[3]);
            }
            const float s0 = al[mi][0], s1 = al[mi][1];
            o[i][0] = fmaf(o[i][0], s0, p0[0]);
            o[i][1] = fmaf(o[i][1], s0, p0[1]);
            o[i][2] = fmaf(o[i][2], s1, p0[2]);
            o[i][3] = fmaf(o[i][3], s1, p0[3]);
            o[i + 1][0] = fmaf(o[i + 1][0], s0, p1[0]);
            o[i + 1][1] = fmaf(o[i + 1][1], s0, p1[1]);
            o[i + 1][2] = fmaf(o[i + 1][2], s1, p1[2]);
            o[i + 1][3] = fmaf(o[i + 1][3], s1, p1[3]);
          }
        }
      }
    }

    // the outer modes' set boundaries: park the own segment's state after
    // its last tile; after the begin segment's last, swap (1 - c) O / l with
    // it (fused), or park that and start the end set afresh (pure)
    if (outer && ((p.has_own && it == n_own - 1) || it == n_own + n_ep - 1)) {
      float* park = parked();
      if (p.has_own && it == n_own - 1) {
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (i % NJ < njc) {
#pragma unroll
            for (int e = 0; e < 4; ++e) park[(4 * i + e) * kThreads + tid] = o[i][e];
          }
        }
        if (tid < BQ) {
          park[kParkWords * kThreads + tid] = row_m[tid];
          park[kParkWords * kThreads + kRowsMax + tid] = row_l[tid];
        }
      } else {
        normalise(1.f - p.coef[b]);
        __syncthreads();  // every thread has read the begin set's sums
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (i % NJ < njc) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float* w = park + (4 * i + e) * kThreads + tid;
              const float own = p.has_own ? *w : 0.f;
              *w = o[i][e];
              o[i][e] = own;
            }
          }
        }
        if (tid < BQ) {
          row_m[tid] = p.has_own ? park[kParkWords * kThreads + tid] : -INFINITY;
          row_l[tid] = p.has_own ? park[kParkWords * kThreads + kRowsMax + tid] : 0.f;
        }
      }
    }
    __syncthreads();  // V(it)'s buffer and P are consumed, the row statistics settled
    load_kv(it + 1, kv_shared ? 0 : 1);
    cp_async_commit();
  }

  if (outer) {  // O = c O_end / l + the parked (1 - c) O_begin / l
    normalise(p.coef[b]);
    const float* park = parked();
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (i % NJ < njc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] += park[(4 * i + e) * kThreads + tid];
      }
    }
  } else {
    normalise(1.f);
  }

  T* ob = static_cast<T*>(const_cast<void*>(p.ptr[7])) + b * p.st[7][0] + h * p.st[7][1];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int mi = i / NJ, nj = i % NJ, col = c0 + 8 * nj + 2 * t;
    if (nj < njc) {
      if (col < p.D) {  // D is even: the pair is in or out together
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = q0 + 16 * mi + g + 8 * hf;
          if (row < p.Sq) {
            T* dst = ob + (long long)row * p.st[7][2] + col;
            if constexpr (is_f32<T>()) {
              *reinterpret_cast<float2*>(dst) = make_float2(o[i][2 * hf], o[i][2 * hf + 1]);
            } else {
              *reinterpret_cast<uint32_t*>(dst) = Elem<T>::pack(o[i][2 * hf], o[i][2 * hf + 1]);
            }
          }
        }
      }
    }
  }
}

// One launch of the instance with `BK`-key tiles and `MT` row blocks
template <class T, int BK, int MT>
int launch(const Params& p, int bytes, int B, int H, void* stream) {
  static bool attribute_set = false;  // once per instance and process: the most any launch takes
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&flash_dwide_kernel<T, BK, MT>),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const dim3 grid((unsigned)((p.Sq + 16 * MT - 1) / (16 * MT)), (unsigned)H, (unsigned)B);
  flash_dwide_kernel<T, BK, MT><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

template <class T>
int entry(const void* const (&ptrs)[8], const void* coef, const void* skip, void* work, const long long* dims,
          float scale, int has_own, int n_sets, void* stream) {
  Params p;
  const int B = (int)dims[0], H = (int)dims[1];
  p.Sq = (int)dims[2];
  p.Lk = (int)dims[3];
  p.Le = (int)dims[4];
  p.D = (int)dims[5];
  if (B <= 0 || H <= 0 || p.Sq <= 0 || p.Lk <= 0 || p.Le <= 0) return (int)cudaErrorInvalidValue;
  if (p.D <= 0 || p.D > kMaxD || (p.D * (int)sizeof(T)) % 16 != 0) return (int)cudaErrorInvalidValue;
  if (n_sets < 0 || n_sets > 2 || (!has_own && n_sets == 0)) return (int)cudaErrorInvalidValue;
  if (n_sets == 2 && (coef == nullptr || work == nullptr)) return (int)cudaErrorInvalidValue;
  p.Dp = (p.D + 127) / 128 * 128;
  p.mt = p.Dp <= 1024 ? 2 : 1;
  // the larger key tile where Q and one K and one V buffer fit, else the
  // smaller, with K and V sharing a buffer where even that does not fit
  constexpr int bk0 = small_key_tile<T>();
  const int bk = smem_bytes<T>(p.Dp, p.mt, 2 * bk0, false) <= kSmemMax ? 2 * bk0 : bk0;
  p.kv_shared = smem_bytes<T>(p.Dp, p.mt, bk, false) > kSmemMax;
  const int bytes = smem_bytes<T>(p.Dp, p.mt, bk, p.kv_shared);
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 8; ++i) {
    p.ptr[i] = ptrs[i];
    for (int j = 0; j < 3; ++j) p.st[i][j] = dims[6 + 3 * i + j];
  }
  p.coef = static_cast<const float*>(coef);
  p.skip = static_cast<const uint8_t*>(skip);
  p.work = static_cast<float*>(work);
  p.has_own = has_own != 0;
  p.n_sets = n_sets;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (p.mt == 2) {
    return bk == bk0 ? launch<T, bk0, 2>(p, bytes, B, H, stream) : launch<T, 2 * bk0, 2>(p, bytes, B, H, stream);
  }
  return bk == bk0 ? launch<T, bk0, 1>(p, bytes, B, H, stream) : launch<T, 2 * bk0, 1>(p, bytes, B, H, stream);
}

}  // namespace

// The C signature of aid_flash_attn_bf16_d512_interp: dims are [B, H, Sq,
// Lk, Le, D, then (b, h, s) element strides of q, k, v, k_begin, v_begin,
// k_end, v_end, out] (30 values; a b stride of 0 marks an endpoint shared by
// every row), D the operands' head dim, 513..2048 on the model's path (any
// D up to 2048 whose rows are 16-byte multiples); coef (B,) f32; skip (B,)
// bool or null; has_own 1 in self and the fused modes, 0 in the pure ones;
// n_sets 0 in self mode (own K/V alone), 2 in the outer modes, 1 in the
// inner ones (their lerped K/V in the begin slot); work the outer modes' f32
// workspace, B * H * ceil(Sq / BQ) * (128 * 256 + 64) floats, BQ 32 where D
// rounded up to a multiple of 128 is at most 1024, else 16 (null otherwise).
// Every operand has its head dim contiguous and 16-byte aligned rows. Returns
// the launch's cudaError_t (0 on success).
extern "C" int aid_flash_attn_bf16_dwide(const void* q, const void* k, const void* v, const void* kb, const void* vb,
                                         const void* ke, const void* ve, void* out, const void* coef,
                                         const void* skip, void* work, const long long* dims, float scale,
                                         int has_own, int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__nv_bfloat16>(ptrs, coef, skip, work, dims, scale, has_own, n_sets, stream);
}

// The same over f16 operands.
extern "C" int aid_flash_attn_f16_dwide(const void* q, const void* k, const void* v, const void* kb, const void* vb,
                                        const void* ke, const void* ve, void* out, const void* coef,
                                        const void* skip, void* work, const long long* dims, float scale,
                                        int has_own, int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<__half>(ptrs, coef, skip, work, dims, scale, has_own, n_sets, stream);
}

// The same over f32 operands (3xTF32).
extern "C" int aid_flash_attn_f32_dwide(const void* q, const void* k, const void* v, const void* kb, const void* vb,
                                        const void* ke, const void* ve, void* out, const void* coef,
                                        const void* skip, void* work, const long long* dims, float scale,
                                        int has_own, int n_sets, void* stream) {
  const void* const ptrs[8] = {q, k, v, kb, vb, ke, ve, out};
  return entry<float>(ptrs, coef, skip, work, dims, scale, has_own, n_sets, stream);
}
