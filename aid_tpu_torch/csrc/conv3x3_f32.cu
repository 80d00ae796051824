// 3x3 stride-1 SAME convolution + bias, f32 in and out, 3xTF32 products, sm_90a.
//
// The f32 instance of the Pallas TPU kernel aid_tpu/ops/conv.py::_kernel
// (conv.py:30-44, conv3x3_same(packed=False) through _call_9dot), which takes
// any dtype (conv.py:145 casts w to x's dtype); it also stands for
// _kernel_packed (conv.py:47-75, packed=True), as conv3x3.cu does in bf16.
// An f32 UNet sends its wide high-resolution convs here (the SDXL up-block
// convs at 128^2 and SD 2.1's at 96^2: cin >= 512 at hw > 4096).
//
// What bounds it on the card: at (7, 960, 128, 128) -> 320 a call is 634
// GFLOP against 0.2-0.3 GB of operands, so the products bind. f32 outside
// the tensor cores is 67 TFLOP/s (9.46 ms at best, cuDNN with TF32 off);
// plain TF32 keeps ~4e-4 of max |out| at K = 9 * 960 (tests/test_torch_ops.py),
// too coarse for an f32 conv. So every product runs in 3xTF32, hi*hi + hi*lo
// + lo*hi: three passes at the 495 TFLOP/s TF32 rate, 3.84 ms, are the bound.
// The design is conv3x3.cu's (one TMA window for all nine taps, wgmma with
// both operands in shared memory) carried into 3xTF32 the way
// flash_interpolated_attention_f32.cu carried the attention:
//   * hi is the raw f32 value: the tensor cores read a tf32 operand's top 19
//     bits, so hi = trunc(a) needs no copy, and lo = a - trunc(a) (exact in
//     f32) is the only second operand. The weights are constant, so the
//     wrapper tiles raw and lo once (ops/conv.py::tiled_weight) as (N tile,
//     K chunk, [raw, lo], tap, 2, 160, 4): one chunk's 2 x 46 KB is one bulk
//     copy that lands as the two wgmma B operands;
//   * the window's lo comes from the layout pass (blocked_f32_kernel), which
//     writes x's 4-channel blocked copy (B, Cin/4, H, W, 4) and, right after
//     it, its lo part: x arrives as (2, B, Cin/4, H, W, 4). That costs one
//     more write of x (440 MB at (7, 960, 128, 128), ~0.13 ms at 3.35 TB/s)
//     and one more 8.4 KB box per stage (per N tile, ~1.8 GB over a 960->320
//     call, against the weights' 20 GB of L2 traffic). The other way, split
//     warps making lo from each arrived window in shared memory, moves no
//     extra byte but puts a block-wide barrier and a proxy fence into every
//     K chunk between the two consumer warpgroups, which the attention can
//     afford and this loop (27 products a chunk, no softmax to hide them
//     behind) cannot;
//   * M = output pixels, N = Cout, K = (tap, cin). A block owns 2 image rows
//     x 64 columns (M = 128, one row per consumer warpgroup) and N = 160
//     output channels. Per K chunk of 8 channels (one tf32 k8 step), one TMA
//     box per part (raw, lo) brings the (2 + 2) x (64 + 2) pixel window of
//     both 4-channel groups from the blocked layout, read as 8-byte elements;
//     the SAME halo and a group past Cin (Cin % 8 == 4) come in as the
//     hardware's zeros. A 4-channel pixel is 16 bytes, a core-matrix row of
//     the no-swizzle K-major layout, so a wgmma A operand of 64 pixels is 8
//     core matrices 128 bytes apart (SBO), its k8 step is the two groups one
//     window plane apart (LBO), and tap (dy, dx) is the same descriptor
//     started (dy * 66 + dx) * 16 bytes on: nine views of one copy;
//   * wgmma m64n160k8 tf32, 27 a chunk per warpgroup (9 taps x 3 passes),
//     summed from zero into a partial accumulator and folded into the f32
//     accumulators once the chunk's products are done: summed in place over
//     K = 8640, the tensor cores' truncating accumulation would drift by
//     ~1e-4 of max |out| (the D=512 attention measured 1.3e-4 over 6144
//     accumulations). While one warpgroup folds, the other's products run;
//   * shared memory: a stage is 2 x 8448 bytes of window and 2 x 46080 of
//     weights, 109,056 bytes; two stages, 218,272 bytes with the barriers and
//     alignment, fit the 227 KB a block can use. A 4-row tile (M = 256)
//     would take 117,504 bytes a stage, so one stage and no overlap of copy
//     and products; the 2-row tile keeps two. Thread 0 refills the stage of
//     chunk kt - 1 with chunk kt + 1 while chunk kt's products run;
//   * W = 96 (SD 2.1) fills one 64-column tile and half of a second: 25% of
//     the products there are on zero columns.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (tools/conv_bench.py, in
// turns with the mma.sync design this replaces): launched alone 6.39-6.49
// ms at (7, 960, 128, 128) -> 320, 59-60% of the bound (was 10.46), 4.26-
// 4.30 at 640 -> 320 and 8.40-8.45 at 640 -> 640 (60-61%); at 96^2 4.66-
// 4.71 (960 -> 320) and 5.98-5.99 (640 -> 640), 46-48%, the half-empty
// tile's share. Through the wrapper 0.48-0.60x cuDNN's f32 time (TF32 off).
// ptxas (sm_90a): 172 registers, no spills; chip_smoke.py's build phase
// prints the registers and spills of every build. Turning M and N around
// (output channels as M, a row's 96 pixels as one wgmma N) would fill the
// 96-pixel rows; that is later work.
// The output is channels-last (B, H, W, Cout) f32, as conv3x3.cu writes bf16.
// The tensor map is encoded on the host with cuTensorMapEncodeTiled, taken
// through cudaGetDriverEntryPoint (no -lcuda at link time), and passed as a
// __grid_constant__ parameter.
//
// The GroupNorm+SiLU prologue in f32: the f32 instance of
// aid_tpu/ops/conv.py::_kernel_packed_gnsilu (conv.py:78-121), y =
// conv(silu(x * scale + shift)) + b with per-(batch, channel) f32 factors
// folded from the one-pass GN statistics (ops/conv.py::gn_scale_shift). It
// is applied in the layout pass, aid_conv3x3_gnsilu_f32 (blocked_f32_kernel
// <.., true>), which already reads x once and writes the blocked copy (and
// its lo part) once: it writes silu(x * scale + shift), and the conv kernel
// above runs unchanged on it. Its zero-filled SAME halo is then the zero the
// reference pads with AFTER the prologue (a halo that took silu(shift) would
// be the fault the parity tests plant). The cost is ~6 f32 operations an
// element on the CUDA cores and the (B, Cin) factors.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTR = 2;                        // output rows per tile: one per consumer warpgroup
constexpr int kTW = 64;                       // output columns per tile (one wgmma M of 64)
constexpr int kWinR = kTR + 2, kWinC = kTW + 2;
constexpr int kWinPx = kWinR * kWinC;         // 264 window pixels
constexpr int kKc = 8;                        // input channels per K chunk (one k8 step a tap)
constexpr int kBN = 160;                      // output channels per block
constexpr int kStages = 2;
constexpr int kThreads = 256;                 // two warpgroups
constexpr int kPlaneBytes = kWinPx * 16;      // one 4-channel group of the window: 4224 B
constexpr int kWinBytes = 2 * kPlaneBytes;    // one part (raw or lo) of a chunk's window: 8448 B
constexpr int kTapBytes = 2 * kBN * 16;       // one tap's (k8, N) weight operand: 5120 B
constexpr int kWtsBytes = 9 * kTapBytes;      // one part of a chunk's weights: 46080 B
constexpr int kStageBytes = 2 * kWinBytes + 2 * kWtsBytes;  // 109056 B, a multiple of 128
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 128;  // + barriers, alignment slack
static_assert(kSmemBytes <= 232448, "over the 227 KB a block can use");
static_assert(kStageBytes % 128 == 0 && kWinBytes % 128 == 0, "TMA destinations are 128-byte aligned");

#include "tf32_mma.cuh"

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
// 8 rows x 16 bytes, 4 tf32): lbo = byte stride between the two core
// matrices of a k8 step, sbo = byte stride between 8-row groups along M / N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// D(64 x 160, f32) (+)= A(64 x 8, tf32) * B(8 x 160, tf32), both K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[80], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, %80, %81, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(scale_d));
}


__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_f32_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ wt,
                       const float* __restrict__ bias, float* __restrict__ out, int B, int H, int W, int Cin,
                       int Cout, int tiles_x) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;  // TMA destinations are 128-byte aligned
  const uint32_t full = base + kStages * kStageBytes, empty = full + kStages * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  const int x0 = (blockIdx.x % tiles_x) * kTW, y0 = (blockIdx.x / tiles_x) * kTR;
  const int n0 = blockIdx.y * kBN, b = blockIdx.z;
  const int nk = (Cin + kKc - 1) / kKc;
  // this N tile's weights: nk chunks of raw then lo, one after the other
  const unsigned char* wtile = reinterpret_cast<const unsigned char*>(wt) + (size_t)blockIdx.y * nk * 2 * kWtsBytes;

  // Stage chunk kt: the window (4-channel groups 2 kt and 2 kt + 1 of the
  // pixels from (y0 - 1, x0 - 1); out-of-range parts come back zero) of x's
  // raw part (image b) and of its lo part (image B + b of the map), then the
  // chunk's raw and lo weights, all counted on the stage's full barrier.
  auto load_stage = [&](int kt) {
    const int s = kt % kStages;
    const uint32_t bar = full + 8 * s, win = base + s * kStageBytes;
    mbar_expect_tx(bar, kStageBytes);
    tma_load_4d(win, &xmap, bar, 2 * (x0 - 1), y0 - 1, 2 * kt, b);
    tma_load_4d(win + kWinBytes, &xmap, bar, 2 * (x0 - 1), y0 - 1, 2 * kt, B + b);
    bulk_load(win + 2 * kWinBytes, wtile + (size_t)kt * 2 * kWtsBytes, 2 * kWtsBytes, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kt = 0; kt < kStages && kt < nk; ++kt) load_stage(kt);
  }
  __syncthreads();

  // warpgroup wg computes output row y0 + wg of the tile
  float acc[80], part[80];
#pragma unroll
  for (int i = 0; i < 80; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const uint32_t win = base + s * kStageBytes;
    // the window seen from output row wg (raw part; lo one part further),
    // the chunk's weights (raw; lo one part further)
    const uint64_t da = make_desc(win + wg * kWinC * 16, kPlaneBytes, 128), dal = da + (kWinBytes >> 4);
    const uint64_t db = make_desc(win + 2 * kWinBytes, kBN * 16, 128), dbl = db + (kWtsBytes >> 4);
    wgmma_fence();
    // the nine taps: tap (dy, dx) moves the window's start by dy * kWinC + dx
    // pixels (16-byte units of the descriptor's address field)
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const uint64_t off = (uint64_t)(dy * kWinC + dx), toff = (uint64_t)(tap * (kTapBytes >> 4));
      wgmma_tf32_ss(part, da + off, db + toff, tap > 0);  // hi * hi (the first sums from zero)
      wgmma_tf32_ss(part, da + off, dbl + toff, 1);       // hi * lo
      wgmma_tf32_ss(part, dal + off, db + toff, 1);       // lo * hi
    }
    wgmma_commit();
    // refill the stage chunk kt - 1 used with chunk kt + 1 once every warp
    // has released it; the copy overlaps chunk kt's products
    if (tid == 0 && kt >= 1 && kt + 1 < nk) {
      const int next = kt + 1;
      mbar_wait(empty + 8 * (next % kStages), ((kt - 1) / kStages) & 1);
      load_stage(next);
    }
    wgmma_wait0();
    reg_fence(part);
#pragma unroll
    for (int i = 0; i < 80; ++i) acc[i] += part[i];  // the chunk's sum, folded in f32
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // + bias, NHWC store: warp w of the warpgroup holds pixels 16 w .. 16 w + 15
  // (accumulator rows g and g + 8), n8 tile j channels 8 j + 2 t, + 1
  const int y = y0 + wg;
  if (y >= H) return;
  const int g = lane >> 2, t = lane & 3, wq = warp & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int x = x0 + wq * 16 + g + half * 8;
    if (x >= W) continue;
    float* o = out + (((size_t)b * H + y) * W + x) * Cout;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int co = n0 + j * 8 + 2 * t;
      if (co < Cout) {  // Cout is even, so co + 1 < Cout too
        *reinterpret_cast<float2*>(o + co) =
            make_float2(acc[4 * j + 2 * half] + bias[co], acc[4 * j + 2 * half + 1] + bias[co + 1]);
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

__device__ __forceinline__ float silu_affine(float v, float s, float h) {
  const float a = v * s + h;
  return a / (1.f + expf(-a));
}

// xb[0][b][g][y][x][0..4) = x[b][4g .. 4g + 4)[y][x] for x (B, C, H, W) at
// any element strides, and xb[1] = its lo part (a - trunc(a), what the tensor
// cores drop when they read xb[0] as tf32): one thread per 16-byte block of
// xb[0], n of them. With the channels contiguous (kVec) a thread loads its 16
// bytes at once and the block index runs fastest; otherwise the column runs
// fastest, so each of a thread's four loads is one coalesced row segment
// across the warp (NCHW). With kPro each element becomes silu(x * scale +
// shift), scale and shift (B, C) f32, before the split.
template <bool kVec, bool kPro>
__global__ void __launch_bounds__(256)
    blocked_f32_kernel(const float* __restrict__ x, float4* __restrict__ xb, const float4* __restrict__ scale,
                       const float4* __restrict__ shift, int G, int H, int W, long long sb, long long sc,
                       long long sh, long long sw, long long n) {
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
  const float* p = x + r * sb + 4LL * g * sc + y * sh + px * sw;
  float4 v = kVec ? __ldg(reinterpret_cast<const float4*>(p))
                  : make_float4(__ldg(p), __ldg(p + sc), __ldg(p + 2 * sc), __ldg(p + 3 * sc));
  if (kPro) {
    const float4 s = __ldg(scale + r * G + g), h = __ldg(shift + r * G + g);
    v = make_float4(silu_affine(v.x, s.x, h.x), silu_affine(v.y, s.y, h.y), silu_affine(v.z, s.z, h.z),
                    silu_affine(v.w, s.w, h.w));
  }
  const long long o = ((r * G + g) * H + y) * W + px;
  xb[o] = v;
  xb[n + o] = make_float4(tf32_rest(v.x), tf32_rest(v.y), tf32_rest(v.z), tf32_rest(v.w));
}

template <bool kPro>
int launch_blocked(const void* x, void* xb, const void* scale, const void* shift, int B, int C, int H, int W,
                   const long long* strides, void* stream) {
  if (C % 4 != 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(xb) | reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(shift)) &
      15) {
    return (int)cudaErrorMisalignedAddress;
  }
  const long long n = (long long)B * (C / 4) * H * W;
  if (n == 0) return 0;
  const long long sb = strides[0], sc = strides[1], sh = strides[2], sw = strides[3];
  const bool vec = sc == 1 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 && sb % 4 == 0 && sh % 4 == 0 && sw % 4 == 0;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  const float* src = static_cast<const float*>(x);
  float4* dst = static_cast<float4*>(xb);
  const float4* s4 = static_cast<const float4*>(scale);
  const float4* h4 = static_cast<const float4*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    blocked_f32_kernel<true, kPro><<<blocks, 256, 0, st>>>(src, dst, s4, h4, C / 4, H, W, sb, sc, sh, sw, n);
  } else {
    blocked_f32_kernel<false, kPro><<<blocks, 256, 0, st>>>(src, dst, s4, h4, C / 4, H, W, sb, sc, sh, sw, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, C, H, W) f32 at element strides {b, c, h, w} -> xb (2, B, C / 4, H, W,
// 4) f32, contiguous and 16-byte aligned; C % 4 == 0. xb[0] is x with its
// channels in blocks of 4, xb[1] its lo part (x - trunc(x) to tf32): the
// layout aid_conv3x3_f32 takes. Returns the launch's cudaError_t (0 on success).
extern "C" int aid_conv3x3_blocked_f32(const void* x, void* xb, int B, int C, int H, int W,
                                       const long long* strides, void* stream) {
  return launch_blocked<false>(x, xb, nullptr, nullptr, B, C, H, W, strides, stream);
}

// The f32 GN+SiLU conv's prologue: as aid_conv3x3_blocked_f32, each element
// written as silu(x * scale + shift) (and its lo part), scale and shift
// (B, C) f32, contiguous and 16-byte aligned. aid_conv3x3_f32 on its output
// is the whole GN+SiLU conv. Returns the launch's cudaError_t (0 on success).
extern "C" int aid_conv3x3_gnsilu_f32(const void* x, void* xb, const void* scale, const void* shift, int B, int C,
                                      int H, int W, const long long* strides, void* stream) {
  return launch_blocked<true>(x, xb, scale, shift, B, C, H, W, strides, stream);
}

// x: (2, B, Cin / 4, H, W, 4) f32 (channels in blocks of 4; [1] the lo part
// of [0]), w: the (Cout, Cin, 3, 3) weight tiled as (ceil(Cout / 160),
// ceil(Cin / 8), 2, 3, 3, 2, 160, 4) f32 ([raw, lo] of each K chunk) with
// zeros past Cout and Cin, bias: (Cout,) f32, out: (B, H, W, Cout) f32; all
// contiguous and 16-byte aligned, Cin % 4 == 0, Cout % 2 == 0. Returns the
// launch's cudaError_t (0 on success).
extern "C" int aid_conv3x3_f32(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                               int Cin, int Cout, void* stream) {
  if (Cin % 4 != 0 || Cout % 2 != 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) return (int)cudaErrorMisalignedAddress;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // x read as 8-byte elements, so one window row of 66 pixels x 16 bytes is
  // one box row of 132 elements; a box is (2 channel groups, kWinR rows,
  // kWinC pixels) of one image. Dim 3 runs over the raw images (0 .. B - 1)
  // and then their lo parts (B .. 2B - 1).
  const cuuint64_t G = Cin / 4, row = (cuuint64_t)W * 16;
  const cuuint64_t dims[4] = {2 * (cuuint64_t)W, (cuuint64_t)H, G, 2 * (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, row * H, row * H * G};
  const cuuint32_t box[4] = {2 * kWinC, kWinR, 2, 1}, unit[4] = {1, 1, 1, 1};
  CUtensorMap xmap;
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT64, 4, const_cast<void*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  static bool attribute_set = false;  // once per process
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&conv3x3_f32_kernel),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kTR - 1) / kTR;
  const dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)((Cout + kBN - 1) / kBN), (unsigned)B);
  conv3x3_f32_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      xmap, static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, Cin,
      Cout, tiles_x);
  return (int)cudaGetLastError();
}
