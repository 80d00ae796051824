// 3x3 stride-1 SAME convolution + bias, bf16 in, f32 accumulate, bf16 out, sm_90a.
//
// Replaces the Pallas TPU kernel aid_tpu/ops/conv.py::_kernel (conv.py:30-44),
// reached through conv3x3_same(packed=False) -> _call_9dot (conv.py:124-169,
// 226-243): the conv as nine shifted (pixels, Cin) @ (Cin, Cout) products
// accumulated in f32, with no im2col tensor in device memory.
//
// Here it is an implicit GEMM: M = B*H*W output pixels, N = Cout,
// K = 9*Cin ordered (tap, cin). Activations are channels-last (NHWC), so a
// K slice of one tap is contiguous in memory; weights are (Cout, 3, 3, Cin),
// so a B fragment's pair along K is contiguous too. The SAME halo is never
// materialized: a pixel whose shifted source lies outside the image loads
// zeros (cp.async with a zero source size), exactly what the zero padding
// would give.
//
// What bounds it on the card: at the SDXL up-block shapes (B=7, 128x128,
// Cin 640..960, Cout 320..640) a call is ~0.3-0.6 TFLOP against ~0.3-0.5 GB
// of traffic, far above the ~295 flop/byte bf16 ridge: compute-bound, so the
// design keeps the tensor cores fed:
//   * 128-pixel x 128-channel output tiles on 8 warps, each warp 32 x 64,
//     mma.sync m16n8k16 (bf16 in, f32 accumulate); a tail tile (Cout = 320:
//     the third of three) leaves the warps past Cout idle;
//   * K steps of 32 channels of one tap, staged through a 3-stage cp.async
//     ring so the loads of step k+2 overlap the products of step k;
//   * fragments loaded with ldmatrix.x4 from rows padded to 80 bytes, which
//     keeps the eight 16-byte row reads of each 8x8 matrix in distinct banks.
// Not yet done (later work): wgmma and TMA.
//
// One template flag, kGnSilu, gives the kernel's two instances:
//   * without the prologue it also stands for aid_tpu/ops/conv.py::
//     _kernel_packed (conv.py:47-75, conv3x3_same(packed=True)). Packing the
//     three dx shifts into one K = 3*Cin dot per dy is what the TPU's
//     128-lane MXU tiles needed; this K loop already runs over all 9*Cin
//     (tap, cin) pairs in 32-channel steps, so the packed contract is the
//     same kernel, and both wrapper flags launch this one instance;
//   * with it, it replaces aid_tpu/ops/conv.py::_kernel_packed_gnsilu
//     (conv.py:78-121, conv3x3_gnsilu): y = conv(silu(x * sc + sh)) + bias
//     with per-(batch, Cin) f32 factors sc/sh that fold the GroupNorm
//     statistics and affine (computed outside, as the JAX package computes
//     them in XLA). It reads the RAW bf16 activation, so the normalised
//     tensor never exists in device memory.
//
// The SAME halo under the prologue: conv pads AFTER norm and activation, so
// the halo must stay zero, but silu(sh) != 0. The halo comes from cp.async
// copies with a zero source size; each thread transforms, in shared memory
// and after its own copies of a stage have landed, exactly the 16-byte
// chunks it staged whose source pixel lies inside the image, and leaves the
// zero-filled ones alone. The transform is f32 silu(x * sc + sh), rounded
// once to bf16 before the MMA, as conv.py:105-109 does.
// ptxas (CUDA 12.8, sm_90a): 128 registers for both instances; the
// prologue instance spills 4 bytes, the other none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output pixels per block
constexpr int kBN = 128;       // output channels per block
constexpr int kBK = 32;        // input channels per K step (one tap)
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kLd = kBK + 8;   // padded smem row: 40 bf16 = 80 bytes
constexpr int kThreads = 256;  // 4 warps along M x 2 along N
constexpr int kARows = kBM * 4 / kThreads;  // A rows (16-byte chunks) staged per thread
constexpr int kBRows = kBN * 4 / kThreads;  // B rows staged per thread
constexpr int kSmemBytes = kStages * (kBM + kBN) * kLd * 2;

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16-byte async copy global -> shared; copies zeros when !pred.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// silu(a) = a * sigmoid(a) = h + h * tanh(h) with h = a / 2: one MUFU
// tanh.approx (relative error ~2^-11, below the bf16 rounding that follows)
__device__ __forceinline__ float silu_fast(float a) {
  const float h = 0.5f * a;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

// silu(x * sc + sh) of 8 bf16 channels in place, in f32, rounded to bf16
__device__ __forceinline__ void gn_silu8(__nv_bfloat16* p, const float* sc, const float* sh) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
  const float4 s0 = *reinterpret_cast<const float4*>(sc), s1 = *reinterpret_cast<const float4*>(sc + 4);
  const float4 h0 = *reinterpret_cast<const float4*>(sh), h1 = *reinterpret_cast<const float4*>(sh + 4);
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(v[j]);
    v[j] = __floats2bfloat162_rn(silu_fast(fmaf(f.x, s[2 * j], h[2 * j])),
                                 silu_fast(fmaf(f.y, s[2 * j + 1], h[2 * j + 1])));
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

template <bool kGnSilu>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ gn_scale,
                   const float* __restrict__ gn_shift, __nv_bfloat16* __restrict__ out, int B, int H, int W, int Cin,
                   int Cout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16(*As)[kBM][kLd] = reinterpret_cast<__nv_bfloat16(*)[kBM][kLd]>(smem_raw);
  __nv_bfloat16(*Bs)[kBN][kLd] =
      reinterpret_cast<__nv_bfloat16(*)[kBN][kLd]>(smem_raw + kStages * kBM * kLd * sizeof(__nv_bfloat16));

  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int chunk = tid & 3;  // which 8-channel chunk of the 32-channel K step this thread stages
  // a warp whose 64 channels all lie past Cout (the tail tile when Cout is not
  // a multiple of 128) still stages tiles but issues no products
  const bool warp_active = n0 + warp_n * 64 < Cout;

  // The A rows (output pixels) this thread stages, decoded once.
  int pb[kARows], py[kARows], px[kARows];
  bool pv[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const long long p = m0 + ((tid + i * kThreads) >> 2);
    pv[i] = p < M;
    const long long pp = pv[i] ? p : 0;
    const long long hw = (long long)H * W;
    pb[i] = (int)(pp / hw);
    const int rem = (int)(pp % hw);
    py[i] = rem / W;
    px[i] = rem % W;
  }

  // The prologue's per-(batch, Cin) factors of the (at most two) images this
  // block's pixels lie in, staged once in shared memory after the tiles;
  // blocks that span more images (images under 128 pixels) read them from
  // global memory instead.
  float* aff = reinterpret_cast<float*>(smem_raw + kSmemBytes);  // [image][scale, shift][Cin]
  int b_lo = 0;
  bool aff_staged = false;
  if (kGnSilu) {
    const long long hw = (long long)H * W;
    b_lo = (int)(m0 / hw);
    const int n_img = (int)((min(m0 + kBM, M) - 1) / hw) - b_lo + 1;
    aff_staged = n_img <= 2;
    if (aff_staged) {
      for (int i = tid; i < n_img * Cin; i += kThreads) {
        const int bb = i / Cin, c = i - bb * Cin;
        aff[(2 * bb) * Cin + c] = gn_scale[(long long)(b_lo + bb) * Cin + c];
        aff[(2 * bb + 1) * Cin + c] = gn_shift[(long long)(b_lo + bb) * Cin + c];
      }
    }
    __syncthreads();  // the first prologue runs before the main loop's first barrier
  }

  const int kc = (Cin + kBK - 1) / kBK;  // K steps per tap
  const int kt_total = 9 * kc;

  auto load_stage = [&](int stage, int kt) {
    const int tap = kt / kc, c0 = (kt - tap * kc) * kBK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int cin = c0 + chunk * 8;
    const bool cin_ok = cin < Cin;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int r = (tid + i * kThreads) >> 2;
      const int iy = py[i] + dy, ix = px[i] + dx;
      const bool ok = pv[i] && cin_ok && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const __nv_bfloat16* src = ok ? x + (((long long)pb[i] * H + iy) * W + ix) * Cin + cin : x;
      cp_async16(&As[stage][r][chunk * 8], src, ok);
    }
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      const int n = (tid + i * kThreads) >> 2;
      const int co = n0 + n;
      const bool ok = co < Cout && cin_ok;
      const __nv_bfloat16* src = ok ? w + ((long long)co * 9 + tap) * Cin + cin : w;
      cp_async16(&Bs[stage][n][chunk * 8], src, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_total) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < kt_total; ++kt) {
    cp_async_wait<kStages - 2>();  // step kt has landed (for this thread's copies)
    if (kGnSilu) {
      // the prologue on this thread's own in-image chunks of step kt; the
      // zero-filled halo (and pixels past M, channels past Cin) stay zero
      const int tap = kt / kc, cin = (kt - tap * kc) * kBK + chunk * 8;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      if (cin < Cin) {
#pragma unroll
        for (int i = 0; i < kARows; ++i) {
          const int iy = py[i] + dy, ix = px[i] + dx;
          if (pv[i] && iy >= 0 && iy < H && ix >= 0 && ix < W) {
            const float* sc = aff_staged ? aff + 2 * (pb[i] - b_lo) * Cin + cin : gn_scale + (long long)pb[i] * Cin + cin;
            const float* sh = aff_staged ? sc + Cin : gn_shift + (long long)pb[i] * Cin + cin;
            gn_silu8(&As[kt % kStages][(tid + i * kThreads) >> 2][chunk * 8], sc, sh);
          }
        }
      }
    }
    __syncthreads();               // ... for every thread's, and step kt-1's stage is free
    const int nk = kt + kStages - 1;
    if (nk < kt_total) load_stage(nk % kStages, nk);
    cp_async_commit();  // possibly empty: keeps the group count in step

    const int st = kt % kStages;
    if (!warp_active) continue;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldsm_x4(a[mt], &As[st][warp_m * 32 + mt * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];  // b0, b1 of n-tile 2*np, then of 2*np+1
        ldsm_x4(b, &Bs[st][warp_n * 64 + np * 16 + (lane & 7) + ((lane >> 4) << 3)][ks * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: + bias in f32, round once to bf16, NHWC store (Cout is even)
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int co = n0 + warp_n * 64 + nt * 8 + t * 2;
    if (co >= Cout) continue;
    const float b0 = bias[co], b1 = bias[co + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const long long p = m0 + warp_m * 32 + mt * 16 + g;
      if (p < M) {
        *reinterpret_cast<uint32_t*>(out + p * Cout + co) = pack_bf16(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      }
      if (p + 8 < M) {
        *reinterpret_cast<uint32_t*>(out + (p + 8) * Cout + co) = pack_bf16(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
      }
    }
  }
}

template <bool kGnSilu>
int launch(const void* x, const void* w, const void* bias, const void* gn_scale, const void* gn_shift, void* out,
           int B, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  // the prologue instance also stages two images' scale and shift rows
  const int smem = kSmemBytes + (kGnSilu ? 2 * 2 * Cin * (int)sizeof(float) : 0);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&conv3x3_kernel<kGnSilu>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((Cout + kBN - 1) / kBN));
  conv3x3_kernel<kGnSilu><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(gn_scale), static_cast<const float*>(gn_shift), static_cast<__nv_bfloat16*>(out), B,
      H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, Cin) bf16, w: (Cout, 3, 3, Cin) bf16, bias: (Cout,) f32,
// out: (B, H, W, Cout) bf16; all contiguous, Cin % 8 == 0, Cout % 2 == 0.
// Returns the launch's cudaError_t (0 on success).
extern "C" int aid_conv3x3_bf16(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                                int Cin, int Cout, void* stream) {
  if (Cin % 8 != 0 || Cout % 2 != 0) return (int)cudaErrorInvalidValue;
  return launch<false>(x, w, bias, nullptr, nullptr, out, B, H, W, Cin, Cout, static_cast<cudaStream_t>(stream));
}

// y = conv(silu(x * scale + shift)) + bias with SAME zero padding applied
// after the prologue. scale, shift: (B, Cin) f32, 16-byte aligned; the rest
// as aid_conv3x3_bf16. Returns the launch's cudaError_t (0 on success).
extern "C" int aid_conv3x3_gnsilu_bf16(const void* x, const void* w, const void* bias, void* out,
                                       const void* scale, const void* shift, int B, int H, int W, int Cin, int Cout,
                                       void* stream) {
  if (Cin % 8 != 0 || Cout % 2 != 0) return (int)cudaErrorInvalidValue;
  return launch<true>(x, w, bias, scale, shift, out, B, H, W, Cin, Cout, static_cast<cudaStream_t>(stream));
}

// Message for a cudaError_t returned by an entry point of this library.
extern "C" const char* aid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
