// Flash self-attention, bf16 or f16 in and out, head dim 512, sm_90a.
//
// Replaces the bf16 D=512 self contract of the Pallas TPU kernel
// aid_tpu/ops/flash_attention.py::_kernel (flash_attention.py:101; the short
// key case is _kernel_onepass, 339), which the JAX package reaches from the
// VAE mid-block attention (vae.py:57-65) when the VAE runs in bf16
// (InterpolationPipeline.enable_bf16_vae_decode, and the loader's choice for
// every VAE with force_upcast False). One head, softmax(q k^T * scale) v
// with an f32 online softmax and f32 accumulation; the probabilities are
// rounded to bf16 for P V, as _kernel casts P to V's dtype
// (flash_attention.py:205, 223). 16384 tokens per 1024px frame, 4096 per
// 512px frame or tile (4000 at the tiled decode's ragged tile).
//
// What bounds it on the card: 4*S*S*D = 550 GFLOP per frame at S=16384
// against ~67 MB of q/k/v/out, so it is compute-bound: 0.556 ms at the
// 989 TFLOP/s bf16 tensor-core rate. What stands between a design and that
// rate at D = 512 is the registers: a 64-row x 512 f32 output accumulator
// is 256 registers a thread for one warpgroup, and 64 rows is the least a
// wgmma takes. So a block holds 64 query rows and splits D between two
// consumer warpgroups, 64 x 256 (128 registers) each. The mma.sync design
// this replaces (ldmatrix-fed, 16 flops per byte of shared memory in Q K^T)
// reached 18-19% of the bound. The design, on wgmma fed by TMA
// (flash_interpolated_attention.cu's machinery, V MN-major through the
// transpose bit):
//   * every operand arrives by TMA through a tensor map over its (B, H, S,
//     D) strides viewed as (D, H, S, B): boxes of 64 columns (128 bytes, the
//     128-byte swizzle) by 64 query rows or 32 keys; rows past Sq or Lk come
//     in as zeros;
//   * a producer warpgroup (one thread issues the copies; 24 registers after
//     setmaxnreg) keeps two rings of two slots full, K's and V's, each slot
//     with its full and empty mbarriers: a K slot frees once its tile's
//     Q K^T is done, a V slot once its P V is, so the next tiles load while
//     this one computes;
//   * the score tile S = Q K^T (64 x 32 keys) needs all of D. Each consumer
//     warpgroup (240 registers) computes the partial scores over its 256
//     columns (16 wgmma m64n32k16, Q and K K-major), writes them to shared
//     memory in its accumulator order, one named barrier of the two
//     warpgroups, and adds the other's: both then hold the same f32 scores
//     (one addition, commutative) and run the same online softmax, so P is
//     already each warpgroup's A fragment for P V and never goes through
//     shared memory. The exchange is double-buffered by tile parity;
//   * O += P V: two wgmma m64n256k16 a tile per warpgroup over its 256
//     columns (four boxes of the V tile, LBO = one box);
//   * software-pipelined as FlashAttention-3 does within a warpgroup: tile
//     j + 1's Q K^T is issued before tile j's P V, the exchange and softmax
//     of tile j + 1 run while that P V does, and nothing is in flight across
//     the loop's back edge. Reading a product's accumulator while it is in
//     flight (an earlier schedule did) makes ptxas serialise the products
//     (C7514): 3.9 against 2.6 ms unpipelined, both in the clusters below;
//   * shared memory: Q 64 KB + two slots each of K and V (32 KB a slot) +
//     the exchange 2 x 16 KB = 230,472 bytes with barriers and alignment, of
//     the 227 KB a block can use; 64-key tiles (128 KB of K and V a slot
//     pair) would leave one;
//   * the output leaves through each warpgroup's half of the Q tile (its
//     own columns, 128-byte swizzled) and a TMA store clipped at Sq.
// L2 traffic: each block of 64 rows reads all of K and V, 8.6 GB at
// S = 16384. A cluster of two blocks that multicast each K/V tile (TMA
// .multicast::cluster, a slot refilled once both blocks released it) halves
// it, but measured slower: 3.41-3.43 ms against 2.30 for the same code in
// clusters of one, and 1.29 without cluster launch and cluster-scope
// barriers (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md). Filling the card at
// ~4000 tokens: 63 row tiles run on 132 SMs. Neither option that fills it
// was taken: a D split across a cluster would move the score exchange into
// distributed shared memory every tile, and a split of the key range needs
// a scratch buffer for the partial outputs and a combine pass, which this
// entry's contract does not have; the per-block rate already puts that
// shape at half of SDPA efficient's time (PERF.md).
// Ragged key tails are masked with -inf scores on the zero-filled rows;
// ragged query tails load zeros and are not stored. The tensor maps are
// encoded on the host with cuTensorMapEncodeTiled, taken through
// cudaGetDriverEntryPoint (no -lcuda at link time), and passed as
// __grid_constant__ parameters. ptxas (sm_90a): 168 registers at the
// launch bound in both instances (setmaxnreg moves them to the consumers),
// no spills.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (tools/attention_bench.py
// --d512, in turns with the mma.sync design this replaces), launched alone:
// 1.29-1.30 ms at (1,1,16384,512), 43% of the bound (was 2.97); 0.68-0.71
// at (7,1,4096,512) (1.53), where 448 blocks make 3.4 waves of 132; 0.17-
// 0.18 at (1,1,4000,512) (0.38), against SDPA efficient's 0.33-0.37.
//
// One design, two element types (elem16.cuh): T = __nv_bfloat16 is
// aid_flash_attn_bf16_d512, T = __half is aid_flash_attn_f16_d512 (the
// mid block of a VAE loaded in f16). They differ in the wgmma type suffix,
// the tensor maps' data type and the rounding of P and of the output; the
// masks stay on the f32 scores.
//
// The static-shift softmax (`static_smax`, the static branch of `_kernel` at
// flash_attention.py:210-256) is this body built with AID_STATIC_SHIFT = 1 by
// flash_attention_bf16_d512_static.cu, a translation unit of its own, bf16 only
// (entry aid_flash_attn_bf16_d512_static; in f16, exp(-40) is below the
// smallest subnormal). Each tile's P is ex2(min(s * scale_log2 - shift_log2,
// clip_log2)), the shift C and the 30-nat clip in log2 units after the scale:
// no row max, no quad max, no rescale of l, and no o *= alpha over each
// warpgroup's 256 columns before its P V; each row's sum is guarded (max(l,
// 1e-37)) as the JAX kernels' denominator is. The softmax leaves P in f32
// and it is packed into P V's A registers once the previous P V is done,
// before the next tile's Q K^T is issued (take_p): packed in the softmax,
// beside that P V in flight, P took its A registers and ptxas serialised
// every wgmma (C7513), 4-7% slower than the exact instance.

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

constexpr int kD = 512;                     // head dim
constexpr int kBQ = 64;                     // query rows per block
constexpr int kBK = 32;                     // keys per K/V tile
constexpr int kStages = 2;                  // slots in each of the K and V rings
constexpr int kWG = 2;                      // consumer warpgroups, D / kWG columns each
constexpr int kThreads = 128 * (kWG + 1);   // + the producer warpgroup
constexpr int kCols = kD / kWG;             // 256 output columns per warpgroup
constexpr int kBoxes = kD / 64;             // 64-column boxes of a row: 8
constexpr int kQBytes = kBQ * 128 * kBoxes;        // 65536
constexpr int kKVBytes = kBK * 128 * kBoxes;       // one K (or V) tile: 32768
constexpr int kStageBytes = 2 * kKVBytes;          // a K slot, then its V slot
constexpr int kXBytes = 2 * kWG * 16 * 128 * 4;    // the score exchange, double-buffered: 32768
constexpr int kSmemBytes = 1024 + kQBytes + kStages * kStageBytes + kXBytes + (4 * kStages + 1) * 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block can use");

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

// One box of a (D, H, S, B) map into this block's shared memory
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

// O(64 x 256, f32) += P(64 x 16, registers) V(16 x 256): V MN-major in shared memory (transpose bit)
template <class T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"  \
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
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),  \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}


struct Params {
  int Sq, Lk;
  float scale_log2;  // softmax scale * log2(e)
  float shift_log2, clip_log2;  // the static shift C and the clip, * log2(e) (kStatic instance only)
};

// A row's sum: the thread's partial sums reduced over the quad; at the
// static shift guarded, so a row whose every key underflowed gives 0
__device__ __forceinline__ float row_sum(float l) {
  if constexpr (kStatic) return fmaxf(quad_sum(l), 1e-37f);
  return quad_sum(l);
}

// Maps: q, k, v, out, each (D, H, S, B) with boxes of 64 columns by kBQ
// (q, out) or kBK (k, v) rows.
template <class T>
__global__ void __launch_bounds__(kThreads, 1)
    flash16_d512_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                        const __grid_constant__ CUtensorMap vm, const __grid_constant__ CUtensorMap om,
                        const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte-swizzled tiles are 1024-byte aligned
  const uint32_t qs = base, kvs = qs + kQBytes, xs_at = kvs + kStages * kStageBytes;
  float* xs = reinterpret_cast<float*>(smem_raw + (xs_at - raw));  // [tile parity][warpgroup][16][128]
  // full and empty barriers of the K ring, then of the V ring (8 * kStages bytes each), then Q's
  const uint32_t kfull = xs_at + kXBytes, kempty = kfull + 8 * kStages, vfull = kempty + 8 * kStages;
  const uint32_t vempty = vfull + 8 * kStages, qbar = vempty + 8 * kStages;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int ntiles = (p.Lk + kBK - 1) / kBK;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(kfull + 8 * i, 1);
      mbar_init(vfull + 8 * i, 1);
      mbar_init(kempty + 8 * i, 4 * kWG);  // one arrival per consumer warp
      mbar_init(vempty + 8 * i, 4 * kWG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWG) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kWG * 128) {
      mbar_expect_tx(qbar, kQBytes);
      for (int c = 0; c < kBoxes; ++c) tma_load(qs + c * (kBQ * 128), &qm, qbar, 64 * c, h, q0, b);
      // K and V of a tile ride separate rings: K's slot frees once the
      // tile's Q K^T is done, V's once its P V is, so the next K can load
      // while this P V runs
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % kStages;
        for (int kv = 0; kv < 2; ++kv) {
          const uint32_t bar = (kv ? vfull : kfull) + 8 * st;
          const uint32_t dst = kvs + st * kStageBytes + kv * kKVBytes;
          const CUtensorMap* map = kv ? &vm : &km;
          if (it >= kStages) mbar_wait((kv ? vempty : kempty) + 8 * st, (it / kStages - 1) & 1);
          mbar_expect_tx(bar, kKVBytes);
          for (int c = 0; c < kBoxes; ++c) tma_load(dst + c * (kBK * 128), map, bar, 64 * c, h, it * kBK, b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: output columns kCols * wg ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int ct = tid & 127, warp = ct >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const uint32_t q = qs + wg * (kBoxes / kWG) * (kBQ * 128);  // this warpgroup's boxes of Q
    mbar_wait(qbar, 0);

    float o[kCols / 2];
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float s[16];               // a tile's (partial, then whole) scores
    uint32_t pa[kBK / 16][4];  // P in T: the A fragments of the P V in flight

    // partial scores of tile `it` over this warpgroup's 256 columns, issued
    // (not waited for): box kk / 4 of Q and K, 32 bytes in per k16 step
    auto issue_qk = [&](float (&acc)[16], int it) {
      const uint32_t kt = kvs + (it % kStages) * kStageBytes + wg * (kBoxes / kWG) * (kBK * 128);
      mbar_wait(kfull + 8 * (it % kStages), (it / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<T>(acc, desc_sw128(q + (kk / 4) * (kBQ * 128) + off, 16),
                 desc_sw128(kt + (kk / 4) * (kBK * 128) + off, 16), kk > 0);
      }
      wgmma_commit();
    };
    // tile `it`'s slot of a ring (kempty or vempty) is free
    auto release = [&](uint32_t empty, int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (it % kStages));
    };
    // write our partial scores, meet the other warpgroup, add theirs
    auto exchange = [&](int it) {
      float* mine = xs + (((it & 1) * kWG + wg) * 16) * 128 + ct;
      float* theirs = xs + (((it & 1) * kWG + (1 - wg)) * 16) * 128 + ct;
#pragma unroll
      for (int i = 0; i < 16; ++i) mine[i * 128] = s[i];
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kWG) : "memory");
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] += theirs[i * 128];
    };
    // online softmax of tile `it` (scores in s) into P (pn) and the
    // rescale factors of O (al0, al1); O itself is rescaled by pv. The
    // static instance takes P at the static shift: no max, no factors
    float al0 = 0.f, al1 = 0.f;
    uint32_t pn[kBK / 16][4];
    [[maybe_unused]] float pf[kBK / 2];  // the static instance's P in f32, packed into pa by take_p
    auto softmax = [&](int it) {
      const int valid = min(kBK, p.Lk - it * kBK);
      if (valid < kBK) {  // the last tile: keys past Lk do not exist
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if ((i / 4) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
        }
      }
      if constexpr (kStatic) {
        // P = 2^min(s scale_log2 - shift_log2, clip_log2) (a masked key stays -inf and gives 0)
        float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p0 = ex2(fminf(fmaf(s[4 * j], p.scale_log2, -p.shift_log2), p.clip_log2));
          const float p1 = ex2(fminf(fmaf(s[4 * j + 1], p.scale_log2, -p.shift_log2), p.clip_log2));
          const float p2 = ex2(fminf(fmaf(s[4 * j + 2], p.scale_log2, -p.shift_log2), p.clip_log2));
          const float p3 = ex2(fminf(fmaf(s[4 * j + 3], p.scale_log2, -p.shift_log2), p.clip_log2));
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
      // every tile holds at least one real key, so the new max is finite
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
        // keys 16 kk .. 16 kk + 15 are n-tiles 2 kk and 2 kk + 1: P's A fragment for k-step kk
        pn[j / 2][2 * (j & 1)] = Elem<T>::pack(p0, p1);
        pn[j / 2][2 * (j & 1) + 1] = Elem<T>::pack(p2, p3);
      }
      l0 = l0 * al0 + ls0;
      l1 = l1 * al1 + ls1;
    };
    // O = O * alpha + P V of tile `it` (P taken from pn; the static instance's by take_p), issued (not waited for)
    auto pv = [&](int it) {
      if constexpr (!kStatic) {
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
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
      // 16 keys (2048 bytes) a step over this warpgroup's 256 columns, the next box LBO away
      const uint32_t vt = kvs + (it % kStages) * kStageBytes + kKVBytes + wg * (kBoxes / kWG) * (kBK * 128);
      mbar_wait(vfull + 8 * (it % kStages), (it / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs<T>(o, pa[kk], desc_sw128(vt + kk * 2048, kBK * 128));
      wgmma_commit();
    };

    // Software-pipelined over tiles, so the tensor cores have work while
    // the warpgroup exchanges and exponentiates: tile it + 1's Q K^T runs
    // beside tile it's rescale, tile it's P V beside tile it + 1's exchange
    // and softmax. Nothing is in flight across the loop's back edge, and no
    // instruction reads the accumulator of a product in flight (which would
    // make ptxas serialise the products).
    // The static instance's softmax leaves P in f32 (pf) and packs it into
    // P V's A registers here, once the previous P V is done and before the
    // next Q K^T is issued. Packed in the softmax, beside P V in flight, P
    // took that product's A registers and ptxas serialised every wgmma
    // (C7513); the exact instance's compiled code packs after the wait
    auto take_p = [&]() {
      if constexpr (kStatic) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          pa[j / 2][2 * (j & 1)] = Elem<T>::pack(pf[4 * j], pf[4 * j + 1]);
          pa[j / 2][2 * (j & 1) + 1] = Elem<T>::pack(pf[4 * j + 2], pf[4 * j + 3]);
        }
        reg_fence(pa);
      }
    };
    issue_qk(s, 0);
    wgmma_wait0();
    reg_fence(s);
    release(kempty, 0);
    exchange(0);
    softmax(0);
    int it = 0;
    for (; it + 1 < ntiles; ++it) {
      take_p();
      issue_qk(s, it + 1);
      pv(it);
      wgmma_wait<1>();  // Q K^T of tile it + 1 is done (P V of tile it may run): its K is free
      reg_fence(s);
      release(kempty, it + 1);
      exchange(it + 1);
      softmax(it + 1);
      wgmma_wait0();  // P V of tile it is done: O and P are free, and its V
      reg_fence(o);
      reg_fence(pa);
      release(vempty, it);
    }
    take_p();
    pv(it);  // the last tile
    wgmma_wait0();
    reg_fence(o);
    reg_fence(pa);
    release(vempty, it);

    // T output through this warpgroup's boxes of the Q tile (its products
    // are done), in the TMA box layout: 128-byte rows, 16-byte chunk j of
    // row r at j ^ (r % 8)
    const float i0 = 1.f / row_sum(l0), i1 = 1.f / row_sum(l1);
    unsigned char* tile = smem_raw + (q - raw);
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int box = j / 8, chunk = j % 8;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + g + 8 * half;
        const float inv = half ? i1 : i0;
        *reinterpret_cast<uint32_t*>(tile + box * (kBQ * 128) + r * 128 + ((chunk ^ (r & 7)) * 16) + 4 * t) =
            Elem<T>::pack(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic stores -> the TMA store's proxy
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    if (ct == 0) {
      for (int c = 0; c < kBoxes / kWG; ++c) {
        tma_store(&om, q + c * (kBQ * 128), kCols * wg + 64 * c, h, q0, b);
      }
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
bool encode_map(CUtensorMap* map, const void* ptr, int H, int S, int B, const long long* strides, int rows) {
  const long long sb = strides[0], sh = strides[1], ss = strides[2];
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)H, (cuuint64_t)S, sb == 0 ? 1u : (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)(sb == 0 ? ss * S + sh * H : sb) * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1}, unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, Elem<T>::kMapType, 4, const_cast<void*>(ptr), dims, bytes, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class T>
int entry(const void* const (&ptrs)[4], const long long* dims, float scale, float shift_log2, float clip_log2,
          void* stream) {
  if (dims[2] <= 0 || dims[3] <= 0) return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  const int B = (int)dims[0], H = (int)dims[1];
  Params p;
  p.Sq = (int)dims[2];
  p.Lk = (int)dims[3];
  p.scale_log2 = scale * 1.4426950408889634f;
  p.shift_log2 = shift_log2;
  p.clip_log2 = clip_log2;
  CUtensorMap m[4];
  const int rows[4] = {p.Sq, p.Lk, p.Lk, p.Sq}, box[4] = {kBQ, kBK, kBK, kBQ};
  for (int i = 0; i < 4; ++i) {
    if (!encode_map<T>(&m[i], ptrs[i], H, rows[i], B, dims + 4 + 3 * i, box[i])) return (int)cudaErrorInvalidValue;
  }
  static bool attribute_set = false;  // once per instance and process: its shared memory does not change
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&flash16_d512_kernel<T>),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const int tiles = (p.Sq + kBQ - 1) / kBQ;
  const dim3 grid((unsigned)tiles, (unsigned)H, (unsigned)B);
  flash16_d512_kernel<T><<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(m[0], m[1], m[2], m[3], p);
  return (int)cudaGetLastError();
}

#if AID_STATIC_SHIFT
}  // namespace static_shift
using static_shift::entry;
#endif
}  // namespace

#if AID_STATIC_SHIFT
// The static-shift instance over bf16 operands: aid_flash_attn_bf16_d512's
// arguments with the shift C and the clip after the scale, both times
// log2(e) (p = 2^min(s * scale * log2(e) - shift_log2, clip_log2)). Returns
// the launch's cudaError_t.
extern "C" int aid_flash_attn_bf16_d512_static(const void* q, const void* k, const void* v, void* out,
                                               const long long* dims, float scale, float shift_log2,
                                               float clip_log2, void* stream) {
  const void* const ptrs[4] = {q, k, v, out};
  return entry<__nv_bfloat16>(ptrs, dims, scale, shift_log2, clip_log2, stream);
}
#else
// dims: [B, H, Sq, Lk, then (b, h, s) element strides of q, k, v, out]
// (16 values). Every operand is bf16 with its head dim contiguous, 16-byte
// aligned, its other strides multiples of 8 elements. Returns the launch's
// cudaError_t (0 on success).
extern "C" int aid_flash_attn_bf16_d512(const void* q, const void* k, const void* v, void* out,
                                        const long long* dims, float scale, void* stream) {
  const void* const ptrs[4] = {q, k, v, out};
  return entry<__nv_bfloat16>(ptrs, dims, scale, 0.f, 0.f, stream);
}

// The same over f16 operands.
extern "C" int aid_flash_attn_f16_d512(const void* q, const void* k, const void* v, void* out,
                                       const long long* dims, float scale, void* stream) {
  const void* const ptrs[4] = {q, k, v, out};
  return entry<__half>(ptrs, dims, scale, 0.f, 0.f, stream);
}
#endif
