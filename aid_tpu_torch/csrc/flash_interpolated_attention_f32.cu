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
// Head dims 40, 64 and 80: wgmma, TMA and a split/transpose warpgroup.
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
//     endpoints get a map of batch extent 1. Each block's 128 query rows
//     arrive the same way, once;
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
//     registers;
//   * the producer warpgroup (40 registers a thread after setmaxnreg): one
//     thread keeps the TMA ring full across the segment loop (own, begin,
//     end), three warps split and transpose each arrived stage and arrive
//     on its "ready" mbarrier. Two or three consumer warpgroups (the rest of
//     the registers) of 64 query rows each run the products and the online
//     softmax in f32 (exp2f, log2(e) folded into the scale) and release the
//     stage;
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
// The tile table (Tiles below): shared memory per 64 rows of Q or parked
// state (the larger), per stage raw K, raw V and K_lo (BK x 128 bytes per
// 32-column box) and V^T, (V^T)_lo (D x 128 bytes per 32 keys); ptxas
// (CUDA 12.8) reports the launch bound's registers (128 at 512 threads, 168
// at 384) and no spill for every instance; setmaxnreg gives the consumers:
//   D   rows keys stages  stage bytes   shared memory   consumer registers
//   40   192   32    4      34816           189,544         152
//   64   128   64    2      81920           201,784         232
//   80   128   32    3      57344           222,288         232
// A third stage does not fit at D = 64 beside the Q / parked regions, nor
// 64-key tiles at D = 80 (139 KB a stage). At D = 40, three warpgroups and
// 32-key tiles beat two and 64 (fused_outer (7,8,4096,40) 4.16 against 4.50
// ms, self 1.88 against 1.90-1.98; H100, tools/attention_bench.py); at
// D = 64, 32-key tiles in four stages won at the 77- and 144-key calls
// (0.128 against 0.152 ms at 4096 x 77 keys) and lost at 9216 tokens (7.56
// against 7.33 ms), so 64 stays.
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled, taken
// through cudaGetDriverEntryPoint (no -lcuda), kept in a small cache keyed by
// everything they encode (pointer, extents, strides, box), and passed as
// __grid_constant__ parameters.
//
// Head dim 160 keeps the mma.sync design (namespace mma below). Its per-
// stage bytes at 32 keys (raw K, K_lo, raw V, V^T, (V^T)_lo: 100 KB) leave
// no room for a second stage, Q cannot live in registers (160 a thread for
// hi and lo) nor in shared memory (80 KB), and its SD 1.5 shapes (256 and 64
// tokens) are latency-bound calls of 28-224 blocks. There each warp splits
// its fragments in registers from one f32 copy of each tile
// (mma.sync.m16n8k8.tf32): 64 query rows a block, 4 warps of 16, 16-key
// tiles (32 in the outer modes) in two cp.async stages, row pitches that
// make every fragment load free of bank conflicts, the same per-tile fold
// and parked outer state.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

#include "tf32_mma.cuh"

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// D = 40, 64, 80: wgmma 3xTF32, TMA, a split/transpose warpgroup
// ---------------------------------------------------------------------------

// The tile table (tests/test_torch_ops.py reads it): query rows per block,
// keys per K/V tile, stages in the ring.
template <int D> struct Tiles;
template <> struct Tiles<40> { static constexpr int kBQ = 192, kBK = 32, kStages = 4; };
template <> struct Tiles<64> { static constexpr int kBQ = 128, kBK = 64, kStages = 2; };
template <> struct Tiles<80> { static constexpr int kBQ = 128, kBK = 32, kStages = 3; };

template <int D>
struct Cfg {
  static constexpr int kBQ = Tiles<D>::kBQ, kBK = Tiles<D>::kBK, kStages = Tiles<D>::kStages;
  static constexpr int kWG = kBQ / 64;                  // consumer warpgroups, 64 query rows each
  static constexpr int kThreads = 128 * (kWG + 1);      // + the producer warpgroup
  static constexpr int kProducerRegs = 40;
  // what is left of the SM's 65536 registers, per consumer thread, a multiple of 8, at most 240
  static constexpr int kConsumerRegs = (65536 - 128 * kProducerRegs) / (128 * kWG) / 8 * 8 > 240
                                          ? 240 : (65536 - 128 * kProducerRegs) / (128 * kWG) / 8 * 8;
  static constexpr int kSplitWarps = 3;                 // the producer's warps 1..3
  static constexpr int kChunks = (D + 31) / 32;         // 32-float boxes of a row
  static constexpr int kKSteps = D / 8;                 // k8 steps of Q K^T
  static constexpr int kQBytes = 64 * 128 * kChunks;    // one warpgroup's Q tile
  static constexpr int kKVBytes = kBK * 128 * kChunks;  // one raw K or V tile, or K_lo
  static constexpr int kVTBytes = (kBK / 32) * D * 128; // V^T or (V^T)_lo: D rows per 32 keys
  static constexpr int kStageBytes = 3 * kKVBytes + 2 * kVTBytes;  // K, V, K_lo, V^T, (V^T)_lo
  static constexpr int kSlot = D / 2 + 4;               // parked words a thread: O, m[2], l[2]
  static constexpr int kRegionBytes = ((kQBytes > 128 * kSlot * 4 ? kQBytes : 128 * kSlot * 4) + 1023) / 1024 * 1024;
  static constexpr int smem_bytes() { return 1024 + kWG * kRegionBytes + kStages * kStageBytes + (3 * kStages + 1) * 8; }
  static_assert(D % 8 == 0 && kBK % 32 == 0, "k8 steps, 32-key boxes of V^T");
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

// The 128-byte swizzle of a byte offset in a 1024-byte-aligned tile of
// 128-byte rows: 16-byte chunk j of row r lies at chunk j ^ (r % 8)
__device__ __forceinline__ uint32_t swz(uint32_t off) { return off ^ (((off >> 7) & 7) << 4); }

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

// (w / l) O: the row sums reduced over the quad
template <int D>
__device__ __forceinline__ void normalise(State<D>& st, float w) {
  const float i0 = w / quad_sum(st.l[0]), i1 = w / quad_sum(st.l[1]);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    st.o[4 * j] *= i0;
    st.o[4 * j + 1] *= i0;
    st.o[4 * j + 2] *= i1;
    st.o[4 * j + 3] *= i1;
  }
}

// One stage of online softmax for this warpgroup's 64 query rows: raw K,
// K_lo, V^T and (V^T)_lo at their offsets from `stage`; `valid` keys of the
// tile are real (the rest are zero rows past the segment).
template <int D>
__device__ __forceinline__ void tile_update(State<D>& st, const uint32_t (&qhi)[D / 8][4],
                                            const uint32_t (&qlo)[D / 8][4], uint32_t stage, int valid,
                                            float sl2) {
  using C = Cfg<D>;
  constexpr int BK = C::kBK;
  const int t = threadIdx.x & 3;
  const uint32_t kt = stage, klo = stage + 2 * C::kKVBytes, vt = stage + 3 * C::kKVBytes, vtlo = vt + C::kVTBytes;
  // S = Q K^T: hi*hi into s, hi*lo + lo*hi into sm; k8 step kk is box kk / 4, 32 bytes in per step
  float s[BK / 2], sm[BK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kKSteps; ++kk) {
    const uint32_t off = (kk / 4) * (BK * 128) + (kk % 4) * 32;
    wgmma_tf32(sm, qlo[kk], desc_sw128(kt + off), kk > 0);
    wgmma_tf32(sm, qhi[kk], desc_sw128(klo + off), 1);
    wgmma_tf32(s, qhi[kk], desc_sw128(kt + off), kk > 0);
  }
  wgmma_commit();
  wgmma_wait0();
  reg_fence(s);
  reg_fence(sm);

#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] += sm[i];
    if (valid < BK && (i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;  // keys past the segment
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  // every tile holds at least one real key, so the new max is finite
  const float mn0 = fmaxf(st.m[0], quad_max(mx0)), mn1 = fmaxf(st.m[1], quad_max(mx1));
  const float al0 = exp2f((st.m[0] - mn0) * sl2), al1 = exp2f((st.m[1] - mn1) * sl2);  // 0 on the first tile
  st.m[0] = mn0;
  st.m[1] = mn1;
  const float ms0 = mn0 * sl2, ms1 = mn1 * sl2;
  float ls0 = 0.f, ls1 = 0.f;
  // P's A fragment of k8 step j is S's n8 tile j: V^T holds key 2t at k = t
  // and key 2t + 1 at k = t + 4, so a0..a3 = P(g, 2t), P(g+8, 2t), P(g, 2t+1), P(g+8, 2t+1)
  uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float p0 = exp2f(fmaf(s[4 * j], sl2, -ms0)), p1 = exp2f(fmaf(s[4 * j + 1], sl2, -ms0));
    const float p2 = exp2f(fmaf(s[4 * j + 2], sl2, -ms1)), p3 = exp2f(fmaf(s[4 * j + 3], sl2, -ms1));
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

  // this tile's P V from zero (hi*lo and lo*hi first), folded into O by FMA
  float part[D / 2];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    const uint32_t off = (ks / 4) * (D * 128) + (ks % 4) * 32;
    wgmma_tf32(part, pl[ks], desc_sw128(vt + off), ks > 0);
    wgmma_tf32(part, ph[ks], desc_sw128(vtlo + off), 1);
    wgmma_tf32(part, ph[ks], desc_sw128(vt + off), 1);
  }
  wgmma_commit();
  wgmma_wait0();
  reg_fence(part);
  reg_fence(ph);
  reg_fence(pl);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    st.o[4 * j] = fmaf(st.o[4 * j], al0, part[4 * j]);
    st.o[4 * j + 1] = fmaf(st.o[4 * j + 1], al0, part[4 * j + 1]);
    st.o[4 * j + 2] = fmaf(st.o[4 * j + 2], al1, part[4 * j + 2]);
    st.o[4 * j + 3] = fmaf(st.o[4 * j + 3], al1, part[4 * j + 3]);
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
  constexpr int BK = C::kBK;
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
    const uint32_t row = (grp / 4) * (D * 128) + d * 128 + (grp % 4) * 32;
    float4* even = reinterpret_cast<float4*>(vt + swz(row));
    float4* odd = reinterpret_cast<float4*>(vt + swz(row + 16));
    *even = make_float4(v[0], v[2], v[4], v[6]);
    *odd = make_float4(v[1], v[3], v[5], v[7]);
    *reinterpret_cast<float4*>(vt + C::kVTBytes + swz(row)) =
        make_float4(tf32_rest(v[0]), tf32_rest(v[2]), tf32_rest(v[4]), tf32_rest(v[6]));
    *reinterpret_cast<float4*>(vt + C::kVTBytes + swz(row + 16)) =
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
  const uint32_t regions = base, stages = base + C::kWG * C::kRegionBytes;
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
        mbar_expect_tx(qbar, C::kWG * C::kQBytes);
        for (int w = 0; w < C::kWG; ++w) {
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
    // consumer warpgroup wg: query rows q0 + 64 wg ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
    unsigned char* region = smem_raw + (regions + wg * C::kRegionBytes - raw);
    mbar_wait(qbar, 0);
    // Q's A fragments, hi (raw) and lo, for every k8 step: rows 16 warp + g (+ 8), columns 8 kk + t (+ 4)
    uint32_t qhi[D / 8][4], qlo[D / 8][4];
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * warp + g + 8 * (e & 1), c = 8 * kk + t + 4 * (e >> 1);
        const float x = *reinterpret_cast<const float*>(region + (c / 32) * 8192 + swz(r * 128 + (c % 32) * 4));
        qhi[kk][e] = __float_as_uint(x);
        qlo[kk][e] = __float_as_uint(tf32_rest(x));
      }
    }

    State<D> st;
    init_state(st);
    int it = 0;
    auto segment = [&](int len) {
      for (int r0 = 0; r0 < len; r0 += BK, ++it) {
        const int s = it % S;
        mbar_wait(ready + 8 * s, (it / S) & 1);
        tile_update<D>(st, qhi, qlo, stages + s * C::kStageBytes, min(BK, len - r0), p.scale_log2);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    };
    if (HAS_OWN) segment(p.Lk);
    if (n_eps == 2) {
      // this thread's parked words, one column of (kSlot, 128) per thread (conflict free);
      // the region held this warpgroup's Q tile, which is in registers now
      float* park = reinterpret_cast<float*>(region) + (tid & 127);
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
      if (n_eps == 1) segment(p.Le);
      normalise(st, 1.f);
    }

    // rows g and g + 8 of this warp, columns 8j + 2t, 8j + 2t + 1: float2 stores at the output's strides
    float* ob = p.out + b * p.sob + h * p.soh;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + 64 * wg + 16 * warp + g + 8 * hf;
      if (row >= p.Sq) continue;
      float* orow = ob + (long long)row * p.sos + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(st.o[4 * j + 2 * hf], st.o[4 * j + 2 * hf + 1]);
      }
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

// Everything a map encodes: a map is a pure function of these, so one made
// for the same key (a tensor at the same address, extents, strides and box)
// is the same map.
struct MapKey {
  const void* ptr;
  long long dims[4], bytes[3];
  int rows;
};

// A direct-mapped cache of encoded maps: calls at the same shapes on the
// same buffers (every step of a denoise loop, through the caching
// allocator) skip the encoding.
constexpr int kMapCacheSlots = 1024;
struct MapCache {
  std::mutex mu;
  MapKey key[kMapCacheSlots];
  CUtensorMap map[kMapCacheSlots];
  bool used[kMapCacheSlots];
};
MapCache map_cache;

// A (D, H, S, B) map of an f32 operand at element strides (b, h, s), boxes
// of 32 columns by `rows` rows, 128-byte swizzle, zeros out of bounds. A
// batch stride of 0 (one tensor shared by every row) becomes a batch extent of 1.
bool encode_map(CUtensorMap* map, const void* ptr, int D, int H, int S, int B, const long long* strides, int rows) {
  const long long sb = strides[0], sh = strides[1], ss = strides[2];
  MapKey k;
  memset(&k, 0, sizeof(k));  // padding too: keys compare as bytes
  k.ptr = ptr;
  k.dims[0] = D;
  k.dims[1] = H;
  k.dims[2] = S;
  k.dims[3] = sb == 0 ? 1 : B;
  k.bytes[0] = sh * 4;
  k.bytes[1] = ss * 4;
  k.bytes[2] = (sb == 0 ? ss * S + sh * H : sb) * 4;
  k.rows = rows;
  uint64_t hash = 1469598103934665603ull;  // FNV-1a over the key's bytes
  for (size_t i = 0; i < sizeof(k); ++i) hash = (hash ^ reinterpret_cast<const unsigned char*>(&k)[i]) * 1099511628211ull;
  const int slot = (int)(hash % kMapCacheSlots);
  std::lock_guard<std::mutex> lock(map_cache.mu);
  if (map_cache.used[slot] && memcmp(&map_cache.key[slot], &k, sizeof(k)) == 0) {
    *map = map_cache.map[slot];
    return true;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)k.dims[0], (cuuint64_t)k.dims[1], (cuuint64_t)k.dims[2], (cuuint64_t)k.dims[3]};
  const cuuint64_t bytes[3] = {(cuuint64_t)k.bytes[0], (cuuint64_t)k.bytes[1], (cuuint64_t)k.bytes[2]};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1}, unit[4] = {1, 1, 1, 1};
  if (encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, bytes, box, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  map_cache.key[slot] = k;
  map_cache.map[slot] = *map;
  map_cache.used[slot] = true;
  return true;
}

template <int D, bool HAS_OWN, int NSETS>
int launch(const CUtensorMap (&m)[7], const Params& p, int B, int H, cudaStream_t s) {
  using C = Cfg<D>;
  constexpr int smem = C::smem_bytes();
  static bool attribute_set = false;  // once per instance and process
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&flash_f32_kernel<D, HAS_OWN, NSETS>),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const dim3 grid((p.Sq + C::kBQ - 1) / C::kBQ, H, B);
  flash_f32_kernel<D, HAS_OWN, NSETS><<<grid, C::kThreads, smem, s>>>(m[0], m[1], m[2], m[3], m[4], m[5], m[6], p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* const (&ptrs)[8], const long long* dims, int has_own, int n_sets, float scale,
             const void* coef, const void* skip, cudaStream_t s) {
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

// ---------------------------------------------------------------------------
// D = 160: mma.sync.m16n8k8.tf32, fragments split in registers
// ---------------------------------------------------------------------------
namespace mma {

// The tile table (tests/test_torch_ops.py reads it): keys per K/V tile, keys
// per K/V tile in the outer modes, the row pitch of Q and K, the row pitch of
// V (floats). 16-key tiles keep a block at 85.5 KB, two to an SM (self
// (7,8,256,160): 0.082 against 0.107 ms with 32-key tiles); the outer
// modes' parked state (43 KB) leaves one block an SM either way, and there
// 32-key tiles win (fused_outer: 0.296 against 0.356 ms; H100,
// tools/attention_bench.py).
template <int D> struct MmaTiles;
template <> struct MmaTiles<160> { static constexpr int kBK = 16, kBKOuter = 32, kLdQK = 168, kLdV = 164; };

constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 128;  // 4 warps of 16 query rows

template <int D, bool OUTER>
struct Cfg {
  static constexpr int kBK = OUTER ? MmaTiles<D>::kBKOuter : MmaTiles<D>::kBK;
  static constexpr int kLdQK = MmaTiles<D>::kLdQK, kLdV = MmaTiles<D>::kLdV;
  static constexpr int kNT = D / 8;                     // n8 tiles of O, k8 steps of Q K^T
  static constexpr int kNC = kNT % 5 == 0 ? 5 : 4;      // O's n8 tiles per P V pass
  static constexpr int kSlot = D / 2 + 4;               // parked words a thread: O, m[2], l[2]
  static constexpr int kKOff = kBQ * kLdQK;
  static constexpr int kVOff = kKOff + 2 * kBK * kLdQK;
  static constexpr int kParkOff = kVOff + 2 * kBK * kLdV;
  static constexpr int kSmemBytes = 4 * (kParkOff + (OUTER ? kThreads * kSlot : 0));
  static_assert(D % 8 == 0 && kBK % 8 == 0 && kNT % kNC == 0, "m16n8k8 steps");
  static_assert(kLdQK % 32 == 8 || kLdQK % 32 == 24, "Q/K fragment loads conflict free");
  static_assert(kLdV % 16 == 4 || kLdV % 16 == 12, "V fragment loads conflict free");
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block can use");
};

struct Strides {
  long long b, h, s;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* kb;
  const float* vb;
  const float* ke;
  const float* ve;
  float* out;
  const float* coef;    // (B,) f32, read by the outer modes only
  const uint8_t* skip;  // (B,) bool or null, read by the fused endpoint modes only
  int Sq, Lk, Le;
  Strides sq, sk, sv, skb, svb, ske, sve, so;
  float scale_log2;     // softmax scale * log2(e)
};

// One key segment of a (b, h) stream: K and V rows and their count.
struct Seg {
  const float* k;
  const float* v;
  long long sk, sv;
  int len;
};

// Stage rows [row0, row0 + ROWS) of one sequence into rows of LD floats;
// rows at or past len are zero-filled.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* base, long long stride, int row0, int len) {
  constexpr int kC = D / 4;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < ROWS * kC; i += kThreads) {
    const int r = i / kC, c = (i - r * kC) * 4;
    const int row = row0 + r;
    const bool ok = row < len;
    cp_async16(dst + r * LD + c, ok ? base + (long long)row * stride + c : base, ok);
  }
}

// The running softmax state of this thread's two query rows (g and g + 8 of
// its warp's 16): O in the m16n8 accumulator layout, the running max m of
// the raw scores and this thread's partial row sums l.
template <int D>
struct State {
  float o[D / 8][4];
  float m[2], l[2];
};

template <int D>
__device__ __forceinline__ void init_state(State<D>& st) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] = 0.f;
  }
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// (w / l) O, the row sums reduced over the quad
template <int D>
__device__ __forceinline__ void normalise(State<D>& st, float w) {
  const float i0 = w / quad_sum(st.l[0]), i1 = w / quad_sum(st.l[1]);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    st.o[j][0] *= i0;
    st.o[j][1] *= i0;
    st.o[j][2] *= i1;
    st.o[j][3] *= i1;
  }
}

// One K/V tile of online softmax for this warp's 16 query rows; `valid`
// keys of the tile are real. The S accumulator of m16n8k8 is P's A
// fragment once the k order inside an 8-wide step is permuted (fragment
// k = t and t + 4 taken from columns 2t and 2t + 1, the same order for both
// operands), and each thread's pair of Q or K values is one 8-byte load.
template <int D, bool OUTER>
__device__ __forceinline__ void tile_update(State<D>& st, const float* qa, const float* kt, const float* vt,
                                            int valid, float sl2, int g, int t) {
  using C = Cfg<D, OUTER>;
  constexpr int BK = C::kBK, NT = C::kNT, NC = C::kNC;
  // S = Q K^T in 3xTF32: big and small terms in separate accumulators
  float s[BK / 8][4], sm[BK / 8][4];
#pragma unroll
  for (int nj = 0; nj < BK / 8; ++nj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nj][e] = sm[nj][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t ahi[4], alo[4];
    load_a_split(qa + kk * 8, C::kLdQK, g, t, ahi, alo);
#pragma unroll
    for (int nj = 0; nj < BK / 8; ++nj) {
      const float2 kv = *reinterpret_cast<const float2*>(kt + (nj * 8 + g) * C::kLdQK + kk * 8 + 2 * t);
      uint32_t bhi0, blo0, bhi1, blo1;
      split_tf32(kv.x, bhi0, blo0);
      split_tf32(kv.y, bhi1, blo1);
      mma_tf32(sm[nj], alo, bhi0, bhi1);
      mma_tf32(sm[nj], ahi, blo0, blo1);
      mma_tf32(s[nj], ahi, bhi0, bhi1);
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nj = 0; nj < BK / 8; ++nj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nj][e] += sm[nj][e];
      if (nj * 8 + 2 * t + (e & 1) >= valid) s[nj][e] = -INFINITY;  // keys past the segment
    }
    mx0 = fmaxf(mx0, fmaxf(s[nj][0], s[nj][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nj][2], s[nj][3]));
  }
  // every tile holds at least one real key, so the new max is finite
  const float mn0 = fmaxf(st.m[0], quad_max(mx0)), mn1 = fmaxf(st.m[1], quad_max(mx1));
  const float al0 = exp2f((st.m[0] - mn0) * sl2), al1 = exp2f((st.m[1] - mn1) * sl2);  // 0 on the first tile
  st.m[0] = mn0;
  st.m[1] = mn1;
  const float ms0 = mn0 * sl2, ms1 = mn1 * sl2;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int nj = 0; nj < BK / 8; ++nj) {
    s[nj][0] = exp2f(fmaf(s[nj][0], sl2, -ms0));  // masked keys: exp2(-inf) = 0
    s[nj][1] = exp2f(fmaf(s[nj][1], sl2, -ms0));
    s[nj][2] = exp2f(fmaf(s[nj][2], sl2, -ms1));
    s[nj][3] = exp2f(fmaf(s[nj][3], sl2, -ms1));
    ls0 += s[nj][0] + s[nj][1];
    ls1 += s[nj][2] + s[nj][3];
  }
  st.l[0] = st.l[0] * al0 + ls0;
  st.l[1] = st.l[1] * al1 + ls1;

  // O = O * alpha + P V: P's A fragment of k-step ks is S's n-tile ks (keys
  // 2t and 2t + 1 as fragment k = t and t + 4); V's B fragment is rows 2t and
  // 2t + 1 of the step, column g. Summed per tile from zero, folded by FMA.
#pragma unroll
  for (int nc = 0; nc < NT; nc += NC) {
    float part[NC][4];
#pragma unroll
    for (int nj = 0; nj < NC; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nj][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      uint32_t ahi[4], alo[4];
      split_tf32(s[ks][0], ahi[0], alo[0]);  // (row g, key 2t)
      split_tf32(s[ks][2], ahi[1], alo[1]);  // (row g + 8, key 2t)
      split_tf32(s[ks][1], ahi[2], alo[2]);  // (row g, key 2t + 1)
      split_tf32(s[ks][3], ahi[3], alo[3]);  // (row g + 8, key 2t + 1)
      const float* vp = vt + (ks * 8 + 2 * t) * C::kLdV + nc * 8 + g;
#pragma unroll
      for (int nj = 0; nj < NC; ++nj) {
        uint32_t bhi0, blo0, bhi1, blo1;
        split_tf32(vp[nj * 8], bhi0, blo0);
        split_tf32(vp[C::kLdV + nj * 8], bhi1, blo1);
        mma_tf32(part[nj], alo, bhi0, bhi1);
        mma_tf32(part[nj], ahi, blo0, blo1);
        mma_tf32(part[nj], ahi, bhi0, bhi1);
      }
    }
#pragma unroll
    for (int nj = 0; nj < NC; ++nj) {
      float* oo = st.o[nc + nj];
      oo[0] = fmaf(oo[0], al0, part[nj][0]);
      oo[1] = fmaf(oo[1], al0, part[nj][1]);
      oo[2] = fmaf(oo[2], al1, part[nj][2]);
      oo[3] = fmaf(oo[3], al1, part[nj][3]);
    }
  }
}

// HAS_OWN / NSETS as for the wgmma design above.
template <int D, bool HAS_OWN, int NSETS>
__global__ void __launch_bounds__(kThreads) flash_f32_mma_kernel(const Params p) {
  using C = Cfg<D, NSETS == 2>;
  constexpr int BK = C::kBK;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = smem + C::kKOff;
  float* Vs = smem + C::kVOff;
  float* park = smem + C::kParkOff + threadIdx.x;  // one column of (kSlot, 128) per thread: conflict free

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool skip = NSETS > 0 && p.skip != nullptr && p.skip[b] != 0;
  const bool blend = NSETS == 2 && !skip;

  // the stream's segments in order: own, begin, end (a shared endpoint has a
  // batch stride of 0)
  const Seg own{p.k + b * p.sk.b + h * p.sk.h, p.v + b * p.sv.b + h * p.sv.h, p.sk.s, p.sv.s, p.Lk};
  const Seg beg{p.kb + b * p.skb.b + h * p.skb.h, p.vb + b * p.svb.b + h * p.svb.h, p.skb.s, p.svb.s, p.Le};
  const Seg end{p.ke + b * p.ske.b + h * p.ske.h, p.ve + b * p.sve.b + h * p.sve.h, p.ske.s, p.sve.s, p.Le};
  const int n_own = HAS_OWN ? (p.Lk + BK - 1) / BK : 0;
  const int n_beg = NSETS > 0 && !skip ? (p.Le + BK - 1) / BK : 0;
  const int n_end = NSETS == 2 ? n_beg : 0;
  const int total = n_own + n_beg + n_end;

  auto locate = [&](int it, int& r0) -> Seg {  // tile `it` of the stream: its segment and first key
    if (it < n_own) {
      r0 = it * BK;
      return own;
    }
    it -= n_own;
    if (it < n_beg) {
      r0 = it * BK;
      return beg;
    }
    r0 = (it - n_beg) * BK;
    return end;
  };
  auto load_tile = [&](int it) {
    int r0;
    const Seg s = locate(it, r0);
    load_rows<D, C::kLdQK, BK>(Ks + (it & 1) * BK * C::kLdQK, s.k, s.sk, r0, s.len);
    load_rows<D, C::kLdV, BK>(Vs + (it & 1) * BK * C::kLdV, s.v, s.sv, r0, s.len);
  };

  load_rows<D, C::kLdQK, kBQ>(Qs, p.q + b * p.sq.b + h * p.sq.h, p.sq.s, q0, p.Sq);
  if (total > 0) load_tile(0);
  cp_async_commit();

  State<D> st;
  init_state(st);
  const float c = NSETS == 2 ? p.coef[b] : 0.f;
  const float* qa = Qs + warp * 16 * C::kLdQK;
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) load_tile(it + 1);  // into the stage tile it - 1 left
    cp_async_commit();                      // possibly empty: keeps the group count in step
    cp_async_wait<1>();                     // tile it (and Q) has landed for this thread ...
    __syncthreads();                        // ... and for every thread
    int r0;
    const Seg s = locate(it, r0);
    tile_update<D, NSETS == 2>(st, qa, Ks + (it & 1) * BK * C::kLdQK, Vs + (it & 1) * BK * C::kLdV,
                               min(BK, s.len - r0), p.scale_log2, g, t);
    if (blend) {
      if (HAS_OWN && it == n_own - 1) {  // park the own segment's state: the end segment continues it too
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) park[(4 * j + e) * kThreads] = st.o[j][e];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          park[(D / 2 + r) * kThreads] = st.m[r];
          park[(D / 2 + 2 + r) * kThreads] = st.l[r];
        }
      }
      if (it == n_own + n_beg - 1) {  // the begin segment is done
        normalise(st, 1.f - c);
        if (HAS_OWN) {  // exchange (1 - c) O_begin / l with the parked own state
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float parked = park[(4 * j + e) * kThreads];
              park[(4 * j + e) * kThreads] = st.o[j][e];
              st.o[j][e] = parked;
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            st.m[r] = park[(D / 2 + r) * kThreads];
            st.l[r] = park[(D / 2 + 2 + r) * kThreads];
          }
        } else {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) park[(4 * j + e) * kThreads] = st.o[j][e];
          }
          init_state(st);
        }
      }
    }
    __syncthreads();  // this stage's K and V are consumed
  }
  if (blend) {
    normalise(st, c);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st.o[j][e] += park[(4 * j + e) * kThreads];
    }
  } else {
    normalise(st, 1.f);
  }

  float* ob = p.out + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + warp * 16 + g + 8 * hf;
    if (row >= p.Sq) continue;
    float* orow = ob + (long long)row * p.so.s + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(st.o[j][2 * hf], st.o[j][2 * hf + 1]);
    }
  }
}

template <int D, bool HAS_OWN, int NSETS>
int launch(const Params& p, int B, int H, cudaStream_t s) {
  constexpr int smem = Cfg<D, NSETS == 2>::kSmemBytes;
  static bool attribute_set = false;  // once per instance and process
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&flash_f32_mma_kernel<D, HAS_OWN, NSETS>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, H, B);
  flash_f32_mma_kernel<D, HAS_OWN, NSETS><<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* const (&ptrs)[8], const long long* dims, int has_own, int n_sets, float scale,
             const void* coef, const void* skip, cudaStream_t s) {
  Params p;
  p.q = static_cast<const float*>(ptrs[0]);
  p.k = static_cast<const float*>(ptrs[1]);
  p.v = static_cast<const float*>(ptrs[2]);
  p.kb = static_cast<const float*>(ptrs[3]);
  p.vb = static_cast<const float*>(ptrs[4]);
  p.ke = static_cast<const float*>(ptrs[5]);
  p.ve = static_cast<const float*>(ptrs[6]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[7]));
  p.coef = static_cast<const float*>(coef);
  p.skip = static_cast<const uint8_t*>(skip);
  p.Sq = (int)dims[2];
  p.Lk = (int)dims[3];
  p.Le = (int)dims[4];
  Strides* st[8] = {&p.sq, &p.sk, &p.sv, &p.skb, &p.svb, &p.ske, &p.sve, &p.so};
  for (int i = 0; i < 8; ++i) {
    st[i]->b = dims[6 + 3 * i];
    st[i]->h = dims[7 + 3 * i];
    st[i]->s = dims[8 + 3 * i];
  }
  p.scale_log2 = scale * 1.4426950408889634f;
  const int B = (int)dims[0], H = (int)dims[1];
  if (has_own && n_sets == 0) return launch<D, true, 0>(p, B, H, s);
  if (has_own && n_sets == 1) return launch<D, true, 1>(p, B, H, s);
  if (has_own && n_sets == 2) return launch<D, true, 2>(p, B, H, s);
  if (!has_own && n_sets == 1) return launch<D, false, 1>(p, B, H, s);
  if (!has_own && n_sets == 2) return launch<D, false, 2>(p, B, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mma

}  // namespace

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
  for (const void* ptr : ptrs) {
    if (reinterpret_cast<uintptr_t>(ptr) & 15) return (int)cudaErrorMisalignedAddress;
  }
  for (int i = 6; i < 30; ++i) {
    if (dims[i] % 4 != 0) return (int)cudaErrorMisalignedAddress;
  }
  if (dims[2] <= 0 || dims[3] <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dims[5] != 160 && encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  switch (dims[5]) {
    case 40: return launch_d<40>(ptrs, dims, has_own, n_sets, scale, coef, skip, s);
    case 64: return launch_d<64>(ptrs, dims, has_own, n_sets, scale, coef, skip, s);
    case 80: return launch_d<80>(ptrs, dims, has_own, n_sets, scale, coef, skip, s);
    case 160: return mma::launch_d<160>(ptrs, dims, has_own, n_sets, scale, coef, skip, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
