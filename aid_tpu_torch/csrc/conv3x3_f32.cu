// 3x3 stride-1 SAME convolution + bias, f32 in and out, 3xTF32 products, sm_90a.
//
// The f32 instance of the Pallas TPU kernel aid_tpu/ops/conv.py::_kernel
// (conv.py:30-44, conv3x3_same(packed=False) through _call_9dot), which takes
// any dtype (conv.py:145 casts w to x's dtype); it also stands for
// _kernel_packed (conv.py:47-75, packed=True), as conv3x3.cu does in bf16.
// An f32 UNet sends its wide high-resolution convs here (the SDXL up-block
// convs at 128^2: cin >= 512 at hw > 4096).
//
// What bounds it on the card: at (7, 960, 128, 128) -> 320 a call is 634
// GFLOP against 0.2-0.3 GB of operands, so the products bind. f32 outside
// the tensor cores is 67 TFLOP/s (9.46 ms at best, cuDNN with TF32 off);
// plain TF32 keeps ~4e-4 of max |out| at K = 9 * 960 (tests/test_torch_ops.py),
// too coarse for an f32 conv. So every product runs in 3xTF32 (hi*hi + hi*lo +
// lo*hi, hi = tf32(a) by cvt.rna, lo = a - hi): three passes at the 495
// TFLOP/s TF32 rate, 3.84 ms, are the bound. tf32 wgmma takes only K-major
// operands from shared memory, which would need hi and lo copies of the
// staged window and weights; this first design uses mma.sync.m16n8k8.tf32
// and splits in registers from one f32 copy, as
// flash_attention_f32_d512.cu does. An implicit GEMM, simple first:
//   * M = output pixels, N = Cout, K = (tap, cin). A block owns 2 image rows
//     x 64 columns (M = 128) and N = 160 output channels (the bf16 kernel's N
//     tile, which divides the SDXL widths); 8 warps of 32 pixels x 80
//     channels. A ragged Cout, H or W is zero-filled on the way in and
//     masked at the store;
//   * per K chunk of 8 channels, one staged input window of (2 + 2) x (64 + 2)
//     pixels serves all nine taps: tap (dy, dx) reads the window from pixel
//     (dy * 66 + dx) on, so no per-tap gather. x comes with its channels in
//     blocks of 4, (B, Cin/4, H, W, 4) (one pixel's block is one 16-byte
//     cp.async), written from x's own strides by this file's layout pass
//     (blocked_f32_kernel); the SAME halo and channels past Cin come in as
//     zeros (cp.async's zero fill);
//   * the weights come tiled as (N tile, K chunk, tap, 160, 8), so a chunk's
//     9 x 160 x 8 operand is one contiguous 46 KB run; the wrapper tiles each
//     weight once (ops/conv.py::tiled_weight);
//   * in shared memory a window pixel and a weight row are 8 floats (32
//     bytes), so each thread's A or B pair (rows g, channels 2t and 2t + 1,
//     the k order inside the 8-wide step permuted alike for both operands)
//     is one 8-byte load and a warp's loads are free of bank conflicts;
//   * a 3-stage cp.async ring (54.5 KB a stage), refilled once every thread
//     is past the stage;
//   * each K chunk's 27 products per output are summed from zero on the
//     tensor cores and added to the f32 accumulators, 5 n8 tiles at a time:
//     summed in place over K = 8640, the tensor cores' truncating
//     accumulation would drift by ~1e-4 of max |out| (the D=512 attention
//     measured 1.3e-4 over 6144 accumulations).
// The output is channels-last (B, H, W, Cout) f32, as conv3x3.cu writes bf16.
//
// The GroupNorm+SiLU prologue in f32: the f32 instance of
// aid_tpu/ops/conv.py::_kernel_packed_gnsilu (conv.py:78-121), y =
// conv(silu(x * scale + shift)) + b with per-(batch, channel) f32 factors
// folded from the one-pass GN statistics (ops/conv.py::gn_scale_shift). The
// bf16 kernel applies the prologue to each staged window chunk (conv3x3.cu);
// here it is applied in the layout pass instead, aid_conv3x3_gnsilu_f32
// (blocked_f32_kernel<.., true>), which already reads x once and writes the
// blocked copy once: it writes silu(x * scale + shift), and the conv kernel
// above runs unchanged on it. Its zero-filled SAME halo is then the zero the
// reference pads with AFTER the prologue (a halo that took silu(shift) would
// be the fault the parity tests plant), and the 3xTF32 main loop, already at
// 255 registers, takes no extra work. The cost is nothing in bytes (the
// pass moves the same 2 x 4 bytes an element, plus the (B, Cin) factors)
// and ~6 f32 operations an element on the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTR = 2;                        // output rows per tile
constexpr int kTW = 64;                       // output columns per tile
constexpr int kWinR = kTR + 2, kWinC = kTW + 2;
constexpr int kWinPx = kWinR * kWinC;         // 264 window pixels
constexpr int kKc = 8;                        // input channels per K chunk (one k8 step a tap)
constexpr int kBN = 160;                      // output channels per block
constexpr int kStages = 3;
constexpr int kThreads = 256;                 // 8 warps: 4 along M (32 pixels) x 2 along N (80 channels)
constexpr int kWarpN = kBN / 2;               // a warp's output channels
constexpr int kNG = 5;                        // n8 tiles summed from zero per pass over the taps
constexpr int kWinFloats = kWinPx * kKc;      // 2112
constexpr int kWtsFloats = 9 * kBN * kKc;     // 11520: one chunk's weights, contiguous in the tiled layout
constexpr int kStageFloats = kWinFloats + kWtsFloats;
constexpr int kSmemBytes = kStages * kStageFloats * 4;  // 163584
static_assert(kSmemBytes <= 232448, "over the 227 KB a block can use");
static_assert((kWarpN / 8) % kNG == 0, "whole passes");

#include "tf32_mma.cuh"

__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_f32_kernel(const float* __restrict__ xb, const float* __restrict__ wt, const float* __restrict__ bias,
                       float* __restrict__ out, int H, int W, int Cin, int Cout, int tiles_x) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int x0 = (blockIdx.x % tiles_x) * kTW, y0 = (blockIdx.x / tiles_x) * kTR;
  const int n0 = blockIdx.y * kBN, b = blockIdx.z;
  const int G = Cin / 4, nk = (Cin + kKc - 1) / kKc;
  const float* wtile = wt + (size_t)blockIdx.y * nk * kWtsFloats;  // this N tile's nk chunks
  const float* xbb = xb + (size_t)b * G * H * W * 4;

  // Stage chunk kt: the window (channel blocks 2 kt, 2 kt + 1 of the pixels
  // from (y0 - 1, x0 - 1); zeros outside the image and past Cin) and the
  // chunk's weights.
  auto load_stage = [&](int kt) {
    float* win = smem + (kt % kStages) * kStageFloats;
    for (int i = tid; i < 2 * kWinPx; i += kThreads) {
      const int px = i >> 1, j = i & 1;
      const int wr = px / kWinC, wc = px - wr * kWinC;
      const int cg = 2 * kt + j, iy = y0 - 1 + wr, ix = x0 - 1 + wc;
      const bool ok = cg < G && iy >= 0 && iy < H && ix >= 0 && ix < W;
      cp_async16(win + px * kKc + 4 * j, ok ? xbb + (((size_t)cg * H + iy) * W + ix) * 4 : xb, ok);
    }
    const float* wsrc = wtile + (size_t)kt * kWtsFloats;
    float* wts = win + kWinFloats;
    for (int i = tid; i < kWtsFloats / 4; i += kThreads) cp_async16(wts + 4 * i, wsrc + 4 * i, true);
  };

  const int wm = warp & 3, wn = warp >> 2;
  const int r = wm >> 1, xw = (wm & 1) * 32;  // this warp's tile row and first column
  float acc[2][kWarpN / 8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nj = 0; nj < kWarpN / 8; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    }
  }

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();  // possibly empty: keeps the group count in step
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // chunk kt has landed for this thread ...
    __syncthreads();               // ... and for every thread, which are all past chunk kt - 1
    if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1);  // into chunk kt - 1's stage
    cp_async_commit();
    const float* win = smem + (kt % kStages) * kStageFloats;
    const float* wts = win + kWinFloats;
#pragma unroll
    for (int ng = 0; ng < kWarpN / 8 / kNG; ++ng) {
      float part[2][kNG][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int nj = 0; nj < kNG; ++nj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][nj][e] = 0.f;
        }
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          load_a_split(win + ((r + dy) * kWinC + xw + 16 * mi + dx) * kKc, kKc, g, t, ahi[mi], alo[mi]);
        }
        const float* pb = wts + (tap * kBN + wn * kWarpN + ng * kNG * 8 + g) * kKc + 2 * t;
#pragma unroll
        for (int nj = 0; nj < kNG; ++nj) {
          const float2 wv = *reinterpret_cast<const float2*>(pb + nj * 8 * kKc);
          uint32_t bhi0, blo0, bhi1, blo1;
          split_tf32(wv.x, bhi0, blo0);
          split_tf32(wv.y, bhi1, blo1);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_tf32(part[mi][nj], alo[mi], bhi0, bhi1);
            mma_tf32(part[mi][nj], ahi[mi], blo0, blo1);
            mma_tf32(part[mi][nj], ahi[mi], bhi0, bhi1);
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int nj = 0; nj < kNG; ++nj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ng * kNG + nj][e] += part[mi][nj][e];
        }
      }
    }
  }

  // + bias, NHWC store: accumulator rows g and g + 8 are pixels, columns 2t
  // and 2t + 1 channels
  const int y = y0 + r;
  if (y >= H) return;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int x = x0 + xw + 16 * mi + g + 8 * hf;
      if (x >= W) continue;
      float* o = out + (((size_t)b * H + y) * W + x) * Cout;
#pragma unroll
      for (int nj = 0; nj < kWarpN / 8; ++nj) {
        const int co = n0 + wn * kWarpN + nj * 8 + 2 * t;
        if (co < Cout) {  // Cout is even, so co + 1 < Cout too
          *reinterpret_cast<float2*>(o + co) =
              make_float2(acc[mi][nj][2 * hf] + bias[co], acc[mi][nj][2 * hf + 1] + bias[co + 1]);
        }
      }
    }
  }
}

__device__ __forceinline__ float silu_affine(float v, float s, float h) {
  const float a = v * s + h;
  return a / (1.f + expf(-a));
}

// xb[b][g][y][x][0..4) = x[b][4g .. 4g + 4)[y][x] for x (B, C, H, W) at any
// element strides: one thread per 16-byte block of xb. With the channels
// contiguous (kVec) a thread loads its 16 bytes at once and the block index
// runs fastest; otherwise the column runs fastest, so each of a thread's four
// loads is one coalesced row segment across the warp (NCHW). With kPro each
// element becomes silu(x * scale + shift), scale and shift (B, C) f32.
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
  xb[((r * G + g) * H + y) * W + px] = v;
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

// x (B, C, H, W) f32 at element strides {b, c, h, w} -> xb (B, C / 4, H, W,
// 4) f32, contiguous and 16-byte aligned; C % 4 == 0. The layout
// aid_conv3x3_f32 takes. Returns the launch's cudaError_t (0 on success).
extern "C" int aid_conv3x3_blocked_f32(const void* x, void* xb, int B, int C, int H, int W,
                                       const long long* strides, void* stream) {
  return launch_blocked<false>(x, xb, nullptr, nullptr, B, C, H, W, strides, stream);
}

// The f32 GN+SiLU conv's prologue: as aid_conv3x3_blocked_f32, each element
// written as silu(x * scale + shift), scale and shift (B, C) f32,
// contiguous and 16-byte aligned. aid_conv3x3_f32 on its output is the
// whole GN+SiLU conv. Returns the launch's cudaError_t (0 on success).
extern "C" int aid_conv3x3_gnsilu_f32(const void* x, void* xb, const void* scale, const void* shift, int B, int C,
                                      int H, int W, const long long* strides, void* stream) {
  return launch_blocked<true>(x, xb, scale, shift, B, C, H, W, strides, stream);
}

// x: (B, Cin / 4, H, W, 4) f32 (channels in blocks of 4), w: the (Cout, Cin,
// 3, 3) weight tiled as (ceil(Cout / 160), ceil(Cin / 8), 3, 3, 160, 8) f32
// with zeros past Cout and Cin, bias: (Cout,) f32, out: (B, H, W, Cout) f32;
// all contiguous and 16-byte aligned, Cin % 4 == 0, Cout % 2 == 0. Returns
// the launch's cudaError_t (0 on success).
extern "C" int aid_conv3x3_f32(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                               int Cin, int Cout, void* stream) {
  if (Cin % 4 != 0 || Cout % 2 != 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) return (int)cudaErrorMisalignedAddress;
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
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), H, W, Cin, Cout, tiles_x);
  return (int)cudaGetLastError();
}
