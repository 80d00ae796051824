// 3x3 stride-1 SAME convolution + bias, bf16 or f16 in, f32 accumulate, bf16 or f16 out, sm_90a.
//
// Replaces the Pallas TPU kernel aid_tpu/ops/conv.py::_kernel (conv.py:30-44),
// reached through conv3x3_same(packed=False) -> _call_9dot (conv.py:124-169,
// 226-243): the conv as nine shifted (pixels, Cin) @ (Cin, Cout) products
// accumulated in f32, with no im2col tensor in device memory.
//
// What bounds it on the card: at the SDXL up-block shapes (B=7, 128x128,
// Cin 640..960, Cout 320..640) a call is 0.42-0.85 TFLOP of bf16 products
// against 0.2-0.3 GB of operands, about 2000 flop per byte, far above the
// ~295 flop/byte ridge: the tensor cores bound it (960->320: 634 GFLOP,
// 0.641 ms at 989 TFLOP/s). The earlier design (mma.sync, 32 channels of
// one tap per K step, every input element fetched once per tap) reached 16%
// of that. This one is an implicit GEMM built from Hopper's own parts:
//   * M = output pixels, N = Cout, K = (tap, cin). A block owns a tile of
//     4 image rows x 64 columns (M = 256) and N = 160 output channels, which
//     divides the SDXL widths exactly (two tiles at Cout = 320, four at 640);
//     a ragged Cout, H or W is zero-filled on the way in and masked at the
//     store, so there is one code path for every shape;
//   * one staged input window serves all nine taps. Per K chunk of 16
//     channels, one TMA box brings the tile's (4 + 2) x (64 + 2) pixel
//     window (SAME halo and channels past Cin come back zero-filled by the
//     hardware) in the no-swizzle core-matrix layout: per group of 8
//     channels, consecutive pixels at 16 bytes each. A wgmma operand of 64
//     pixels of one output row is then 8 core matrices at a 128-byte stride,
//     and tap (dy, dx) is the same descriptor started (dy * 66 + dx) * 16
//     bytes further on: nine views of one copy, no per-tap gather, and each
//     input element leaves L2 once per N tile instead of 27 times;
//   * x comes with its channels in blocks of 8, (B, Cin/8, H, W, 8), and
//     the box reads it as 8-byte elements, so a window row is one 1056-byte
//     box row. A layout pass of this file (blocked_kernel) writes that
//     layout from x's own strides, NCHW or channels-last, at one read and
//     one write of x: 0.16 ms at (7,960,128,128), where torch's permuting
//     copy took 0.27. Over
//     channels-last x a box row
//     is one pixel's 16 bytes: with those 800 small rows a stage (and the
//     weights' 2880, boxed out of a (Cout, 3, 3, Cin) layout) the first
//     version of this kernel took 14.9 ms at 960->320;
//   * the weights come tiled as (N tile, K chunk, tap, 2, 160, 8), so one
//     chunk's 9 x 160 x 16 operand is one contiguous 46 KB bulk copy that
//     lands in the layout the descriptors read; the wrapper tiles each
//     weight once and keeps the tiling (ops/conv.py::tiled_weight);
//   * wgmma m64n160k16 (bf16 in, f32 accumulate, both operands in shared
//     memory): two warpgroups own two output rows each (2 x 80 accumulator
//     registers a thread). A 3-stage ring (58.75 KB a stage) is guarded by
//     full/empty mbarriers; one thread refills a stage as soon as every
//     thread has released it (wgmma.wait_group 1 after the next chunk's
//     products are issued), so each copy overlaps two chunks of products.
//     With 256 threads at one block per SM the consumers keep up to 255
//     registers; a separate producer warp (288 threads) capped them at 168
//     and spilled the accumulators;
//   * the barrier wait is one asm loop: with the loop in C++, ptxas
//     serialised the wgmmas (C7520) and the call was 28% slower.
// The no-swizzle layout was kept over a 128-byte swizzle: a one-pixel
// shift is then a plain +16 bytes, which a swizzled tile could only
// express through the descriptor's base-offset field. Measured on an H100
// (chip_smoke.py phase 3): 960->320 at 128^2, B=7, 0.82 ms launched alone,
// 78% of the bound; 0.98 ms through the wrapper, the layout pass included.
//
// The tensor map is encoded on the host with cuTensorMapEncodeTiled, taken
// through cudaGetDriverEntryPoint (no -lcuda at link time), and passed as a
// __grid_constant__ parameter.
//
// One template flag, kGnSilu, gives the kernel's two instances:
//   * without the prologue it also stands for aid_tpu/ops/conv.py::
//     _kernel_packed (conv.py:47-75, conv3x3_same(packed=True)). Packing the
//     three dx shifts into one K = 3*Cin dot per dy is what the TPU's
//     128-lane MXU tiles needed; this K loop already runs over all 9*Cin
//     (tap, cin) pairs, so both wrapper flags launch this one instance;
//   * with it, it replaces aid_tpu/ops/conv.py::_kernel_packed_gnsilu
//     (conv.py:78-121, conv3x3_gnsilu): y = conv(silu(x * sc + sh)) + bias
//     with per-(batch, Cin) f32 factors sc/sh that fold the GroupNorm
//     statistics and affine (computed outside, as the JAX package computes
//     them in XLA). It reads the RAW bf16 activation, so the normalised
//     tensor never exists in device memory. After a stage's TMA lands, the
//     256 consumer threads transform the window in place, once per element
//     (not once per tap): f32 silu(x * sc + sh), rounded once to bf16 as
//     conv.py:105-109 does. Out-of-image pixels and channels past Cin are
//     skipped and stay zero: conv pads AFTER norm and activation, and
//     silu(sh) != 0. A fence.proxy.async and a barrier of the two
//     warpgroups then make those generic-proxy stores visible to wgmma.
// ptxas (CUDA 12.8, sm_90a): 190 registers (prologue instance 208; the
// f16 instances 190 and 198), no spills, 172 KB of dynamic shared memory;
// chip_smoke.py's build phase prints these lines from every build.
//
// Both instances come in two element types (elem16.cuh): T = __nv_bfloat16
// (aid_conv3x3_bf16, aid_conv3x3_gnsilu_bf16) and T = __half
// (aid_conv3x3_f16, aid_conv3x3_gnsilu_f16, an f16 UNet's convs). They
// differ in the wgmma type suffix, the prologue's unpacking and rounding
// (f32 silu rounded once to T) and the output's rounding; the window's TMA
// map reads 8-byte elements whatever T is, and the layout pass moves 16-bit
// values without reading them, so aid_conv3x3_blocked_f16 is the same pass.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "elem16.cuh"

constexpr int kTR = 4;                        // output rows per tile
constexpr int kTW = 64;                       // output columns per tile (one wgmma M of 64)
constexpr int kWinR = kTR + 2, kWinC = kTW + 2;
constexpr int kWinPx = kWinR * kWinC;         // 396 window pixels
constexpr int kKc = 16;                       // input channels per K chunk (one k16 step)
constexpr int kBN = 160;                      // output channels per block
constexpr int kStages = 3;
constexpr int kThreads = 256;                 // two warpgroups
constexpr int kPlaneBytes = kWinPx * 16;      // one 8-channel group of the window: 6336 B
constexpr int kWinBytes = 2 * kPlaneBytes;
constexpr int kTapBytes = 2 * kBN * 16;       // one tap's (k16, N) weight operand: 5120 B
constexpr int kWtsBytes = 9 * kTapBytes;      // one chunk's weights, contiguous in the tiled layout
constexpr int kStageBytes = kWinBytes + kWtsBytes;  // 58752 B, a multiple of 128
constexpr int kBarBytes = 2 * kStages * 8;
constexpr int kSmemBytes = kStages * kStageBytes + kBarBytes + 128;  // + alignment slack

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

// Wait until the barrier's phase of parity `parity` has completed. The spin
// is one asm loop: around a C++ loop ptxas serialises the wgmmas behind a
// warpgroup arrive in a divergent path (C7520), 28% slower at 960->320.
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

// 4D TMA tile load global -> shared, completion counted on `bar` in bytes
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// 1D bulk copy global -> shared of `bytes` (a multiple of 16), completion counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// wgmma shared-memory descriptor, no swizzle (K-major core matrices of
// 8 rows x 16 bytes): lbo = byte stride between the two core matrices along
// K, sbo = byte stride between 8-row groups along M / N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across the wgmma waits
__device__ __forceinline__ void fence_operands(float (&d)[80]) {
#pragma unroll
  for (int i = 0; i < 80; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x 160, f32) += A(64 x 16, bf16) * B(16 x 160, bf16), both from shared memory, K-major
template <class T>
__device__ __forceinline__ void wgmma_m64n160k16(float (&d)[80], uint64_t desc_a, uint64_t desc_b) {
#define AID_ASM(TY)  \
  asm volatile(  \
      "{\n"  \
      ".reg .pred p;\n"  \
      "setp.ne.b32 p, %82, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n160k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, "  \
      "%8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, "  \
      "%24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, "  \
      "%40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, "  \
      "%56, %57, %58, %59, %60, %61, %62, %63, "  \
      "%64, %65, %66, %67, %68, %69, %70, %71, "  \
      "%72, %73, %74, %75, %76, %77, %78, %79 "  \
      "}, %80, %81, p, 1, 1, 0, 0;\n"  \
      "}\n"  \
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
      : "l"(desc_a), "l"(desc_b), "r"(1))
  AID_WGMMA_16(T, AID_ASM);
#undef AID_ASM
}

// silu(a) = a * sigmoid(a) = h + h * tanh(h) with h = a / 2: one MUFU
// tanh.approx (relative error ~2^-11, below the bf16 rounding that follows)
__device__ __forceinline__ float silu_fast(float a) {
  const float h = 0.5f * a;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

// silu(x * sc + sh) of 8 T channels in place, in f32, rounded to T
template <class T>
__device__ __forceinline__ void gn_silu8(T* p, const float* sc, const float* sh) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  uint32_t* v = reinterpret_cast<uint32_t*>(&raw);
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(sc)), s1 = __ldg(reinterpret_cast<const float4*>(sc + 4));
  const float4 h0 = __ldg(reinterpret_cast<const float4*>(sh)), h1 = __ldg(reinterpret_cast<const float4*>(sh + 4));
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = Elem<T>::unpack(v[j]);
    v[j] = Elem<T>::pack(silu_fast(fmaf(f.x, s[2 * j], h[2 * j])), silu_fast(fmaf(f.y, s[2 * j + 1], h[2 * j + 1])));
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

// + bias in f32, round once to T, NHWC store of one 64-pixel output row
// segment (the warpgroup's accumulator rows: warp w holds pixels 16w..16w+15)
template <class T>
__device__ __forceinline__ void store_row(const float (&acc)[80], const float* __restrict__ bias,
                                          T* __restrict__ out, int b, int y, int x0, int n0, int H,
                                          int W, int Cout, int warp, int lane) {
  if (y >= H) return;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int x = x0 + warp * 16 + g + half * 8;
    if (x >= W) continue;
    T* o = out + (((long long)b * H + y) * W + x) * Cout;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int co = n0 + j * 8 + 2 * t;
      if (co < Cout) {  // Cout is even, so co + 1 < Cout too
        *reinterpret_cast<uint32_t*>(o + co) =
            Elem<T>::pack(acc[4 * j + 2 * half] + bias[co], acc[4 * j + 2 * half + 1] + bias[co + 1]);
      }
    }
  }
}

template <class T, bool kGnSilu>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ wt,
                   const float* __restrict__ bias, const float* __restrict__ gn_scale,
                   const float* __restrict__ gn_shift, T* __restrict__ out, int H, int W, int Cin,
                   int Cout, int tiles_x) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;  // TMA destinations are 128-byte aligned
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t full = base + kStages * kStageBytes, empty = full + kStages * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  const int x0 = (blockIdx.x % tiles_x) * kTW, y0 = (blockIdx.x / tiles_x) * kTR;
  const int n0 = blockIdx.y * kBN, b = blockIdx.z;
  const int nk = (Cin + kKc - 1) / kKc;
  // this N tile's weights: nk chunks of kWtsBytes, one after the other
  const unsigned char* wtile = reinterpret_cast<const unsigned char*>(wt) + (size_t)blockIdx.y * nk * kWtsBytes;

  // Stage chunk kt: the window (channels [16 kt, 16 kt + 16) of pixels from
  // (y0 - 1, x0 - 1) in two 8-channel planes; out-of-range parts come back
  // zero) and the chunk's weights, both counted on the stage's full barrier.
  auto load_stage = [&](int kt) {
    const int s = kt % kStages;
    const uint32_t bar = full + 8 * s, win = base + s * kStageBytes;
    mbar_expect_tx(bar, kStageBytes);
    tma_load_4d(win, &xmap, bar, 2 * (x0 - 1), y0 - 1, 2 * kt, b);
    bulk_load(win + kWinBytes, wtile + (size_t)kt * kWtsBytes, kWtsBytes, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kt = 0; kt < kStages - 1 && kt < nk; ++kt) load_stage(kt);
  }
  __syncthreads();

  // warpgroup wg computes output rows 2 wg and 2 wg + 1 of the tile
  float acc0[80], acc1[80];
#pragma unroll
  for (int i = 0; i < 80; ++i) acc0[i] = acc1[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const uint32_t win = base + s * kStageBytes, wts = win + kWinBytes;
    if (kGnSilu) {
      unsigned char* wp = sbase + s * kStageBytes;
      for (int i = tid; i < 2 * kWinPx; i += kThreads) {
        const int kg = i / kWinPx, px = i - kg * kWinPx;
        const int wr = px / kWinC, wc = px - wr * kWinC;
        const int c = kt * kKc + kg * 8, iy = y0 - 1 + wr, ix = x0 - 1 + wc;
        if (c < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W) {
          const long long f = (long long)b * Cin + c;
          gn_silu8(reinterpret_cast<T*>(wp + kg * kPlaneBytes + px * 16), gn_scale + f, gn_shift + f);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic stores -> wgmma's proxy
      __syncthreads();
    }
    wgmma_fence();
    // the nine taps: one weight operand each, and the window seen from
    // (dy, dx), i.e. its descriptor's start address (in 16-byte units)
    // moved on by dy * kWinC + dx pixels. Not unrolled: unrolled, the
    // eighteen descriptors stay live beside the 160 accumulators.
    const uint64_t da = make_desc(win + 2 * wg * kWinC * 16, kPlaneBytes, 128);
    const uint64_t db = make_desc(wts, kBN * 16, 128);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const uint64_t dat = da + (uint64_t)(dy * kWinC + dx), dbt = db + (uint64_t)(tap * (kTapBytes >> 4));
      wgmma_m64n160k16<T>(acc0, dat, dbt);
      wgmma_m64n160k16<T>(acc1, dat + kWinC, dbt);
    }
    wgmma_commit();
    wgmma_wait<1>();  // chunk kt - 1's products are done: release its stage ...
    if (kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
    // ... and refill it with chunk kt + kStages - 1 once every thread has
    // released it; the copies then overlap chunks kt and kt + 1
    const int next = kt + kStages - 1;
    if (tid == 0 && next < nk) {
      if (next >= kStages) mbar_wait(empty + 8 * (next % kStages), (next / kStages - 1) & 1);
      load_stage(next);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc0);
  fence_operands(acc1);

  store_row(acc0, bias, out, b, y0 + 2 * wg, x0, n0, H, W, Cout, warp & 3, lane);
  store_row(acc1, bias, out, b, y0 + 2 * wg + 1, x0, n0, H, W, Cout, warp & 3, lane);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found at run time (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <class T, bool kGnSilu>
int launch(const void* x, const void* w, const void* bias, const void* gn_scale, const void* gn_shift, void* out,
           int B, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) return (int)cudaErrorMisalignedAddress;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // x: (B, Cin / 8, H, W, 8) T read as 8-byte elements, so that one window
  // row of 66 pixels x 16 bytes is one box row of 132 elements; a box is
  // (2 channel groups, kWinR rows, kWinC pixels) of one image
  const cuuint64_t G = Cin / 8, row = (cuuint64_t)W * 16;
  const cuuint64_t dims[4] = {2 * (cuuint64_t)W, (cuuint64_t)H, G, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, row * H, row * H * G};
  const cuuint32_t box[4] = {2 * kWinC, kWinR, 2, 1}, unit[4] = {1, 1, 1, 1};
  CUtensorMap xmap;
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT64, 4, const_cast<void*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  const void* fn = reinterpret_cast<const void*>(&conv3x3_kernel<T, kGnSilu>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kTR - 1) / kTR;
  const dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)((Cout + kBN - 1) / kBN), (unsigned)B);
  conv3x3_kernel<T, kGnSilu><<<grid, kThreads, kSmemBytes, stream>>>(
      xmap, static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(gn_scale), static_cast<const float*>(gn_shift), static_cast<T*>(out),
      H, W, Cin, Cout, tiles_x);
  return (int)cudaGetLastError();
}

// xb[b][g][y][x][0..8) = x[b][8g .. 8g + 8)[y][x] for x (B, C, H, W) at any
// element strides: one thread per 16-byte chunk of xb. With the channels
// contiguous (kVec) a thread loads its 16 bytes at once and the group index
// runs fastest, so a warp reads whole pixels; otherwise the column runs
// fastest, so each of a thread's eight 2-byte loads is one coalesced row
// segment across the warp (NCHW), and the warp's stores are one run.
template <bool kVec>
__global__ void __launch_bounds__(256)
    blocked_kernel(const uint16_t* __restrict__ x, uint4* __restrict__ xb, int G, int H, int W, long long sb,
                   long long sc, long long sh, long long sw, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long r;
  int g, y, px;
  if (kVec) {
    g = (int)(i % G);
    r = i / G;
    px = (int)(r % W);
    r /= W;
    y = (int)(r % H);
    r /= H;
  } else {
    px = (int)(i % W);
    r = i / W;
    y = (int)(r % H);
    r /= H;
    g = (int)(r % G);
    r /= G;
  }
  const uint16_t* p = x + r * sb + 8LL * g * sc + y * sh + px * sw;
  uint4 v;
  if (kVec) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = (uint32_t)__ldg(p + 2 * j * sc) | ((uint32_t)__ldg(p + (2 * j + 1) * sc) << 16);
    v = make_uint4(u[0], u[1], u[2], u[3]);
  }
  xb[((r * G + g) * H + y) * W + px] = v;
}

// xb[b][g][y][x][0..8) = x[b][8g .. 8g + 8)[y][x] for 16-bit elements of
// any type: one read and one write of x, in blocked_kernel
int blocked(const void* x, void* xb, int B, int C, int H, int W, const long long* strides, void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(xb) & 15) return (int)cudaErrorMisalignedAddress;
  const long long n = (long long)B * (C / 8) * H * W;
  if (n == 0) return 0;
  const long long sb = strides[0], sc = strides[1], sh = strides[2], sw = strides[3];
  const bool vec = sc == 1 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 && sb % 8 == 0 && sh % 8 == 0 && sw % 8 == 0;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  const uint16_t* src = static_cast<const uint16_t*>(x);
  uint4* dst = static_cast<uint4*>(xb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    blocked_kernel<true><<<blocks, 256, 0, st>>>(src, dst, C / 8, H, W, sb, sc, sh, sw, n);
  } else {
    blocked_kernel<false><<<blocks, 256, 0, st>>>(src, dst, C / 8, H, W, sb, sc, sh, sw, n);
  }
  return (int)cudaGetLastError();
}

template <class T>
int conv(const void* x, const void* w, const void* bias, void* out, const void* scale, const void* shift, int B,
         int H, int W, int Cin, int Cout, void* stream) {
  if (Cin % 8 != 0 || Cout % 2 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale == nullptr) return launch<T, false>(x, w, bias, nullptr, nullptr, out, B, H, W, Cin, Cout, st);
  return launch<T, true>(x, w, bias, scale, shift, out, B, H, W, Cin, Cout, st);
}

}  // namespace

// x (B, C, H, W) bf16 at element strides {b, c, h, w} -> xb (B, C / 8, H, W,
// 8) bf16, contiguous and 16-byte aligned; C % 8 == 0. The layout the conv
// entry points below take. Returns the launch's cudaError_t (0 on success).
extern "C" int aid_conv3x3_blocked_bf16(const void* x, void* xb, int B, int C, int H, int W,
                                        const long long* strides, void* stream) {
  return blocked(x, xb, B, C, H, W, strides, stream);
}

// The same of an f16 x (the pass moves 16-bit values; it is the same kernel).
extern "C" int aid_conv3x3_blocked_f16(const void* x, void* xb, int B, int C, int H, int W,
                                       const long long* strides, void* stream) {
  return blocked(x, xb, B, C, H, W, strides, stream);
}

// x: (B, Cin / 8, H, W, 8) bf16 (channels in blocks of 8), w: the
// (Cout, Cin, 3, 3) weight tiled as (ceil(Cout / 160), ceil(Cin / 16), 3, 3,
// 2, 160, 8) bf16 with zeros past Cout and Cin (one contiguous operand per
// N tile and K chunk), bias: (Cout,) f32, out: (B, H, W, Cout) bf16; all
// contiguous and 16-byte aligned, Cin % 8 == 0, Cout % 2 == 0. Returns the
// launch's cudaError_t (0 on success).
extern "C" int aid_conv3x3_bf16(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                                int Cin, int Cout, void* stream) {
  return conv<__nv_bfloat16>(x, w, bias, out, nullptr, nullptr, B, H, W, Cin, Cout, stream);
}

// y = conv(silu(x * scale + shift)) + bias with SAME zero padding applied
// after the prologue. scale, shift: (B, Cin) f32, 16-byte aligned; the rest
// as aid_conv3x3_bf16. Returns the launch's cudaError_t (0 on success).
extern "C" int aid_conv3x3_gnsilu_bf16(const void* x, const void* w, const void* bias, void* out,
                                       const void* scale, const void* shift, int B, int H, int W, int Cin, int Cout,
                                       void* stream) {
  if (scale == nullptr || shift == nullptr) return (int)cudaErrorInvalidValue;
  return conv<__nv_bfloat16>(x, w, bias, out, scale, shift, B, H, W, Cin, Cout, stream);
}

// aid_conv3x3_bf16 and aid_conv3x3_gnsilu_bf16 over f16 x, w and out (bias,
// scale and shift stay f32).
extern "C" int aid_conv3x3_f16(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                               int Cin, int Cout, void* stream) {
  return conv<__half>(x, w, bias, out, nullptr, nullptr, B, H, W, Cin, Cout, stream);
}

extern "C" int aid_conv3x3_gnsilu_f16(const void* x, const void* w, const void* bias, void* out,
                                      const void* scale, const void* shift, int B, int H, int W, int Cin, int Cout,
                                      void* stream) {
  if (scale == nullptr || shift == nullptr) return (int)cudaErrorInvalidValue;
  return conv<__half>(x, w, bias, out, scale, shift, B, H, W, Cin, Cout, stream);
}

// Message for a cudaError_t returned by an entry point of this library.
extern "C" const char* aid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
