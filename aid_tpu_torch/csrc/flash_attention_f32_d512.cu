// Flash self-attention, f32 in and out, head dim 512, sm_90a.
//
// Replaces the D=512 f32 contract of the Pallas TPU kernel
// aid_tpu/ops/flash_attention.py::_kernel (flash_attention.py:101), which the
// JAX package reaches from the VAE mid-block attention (vae.py:57-65): one
// head, self mode, softmax(q k^T * scale) v with an f32 softmax and an f32
// output. At 1024px that is 16384 tokens per frame; the plain version
// materialises a 16384^2 f32 logit matrix (1 GiB) per frame, this kernel
// keeps the logits on chip.
//
// What bounds it on the card: 4*S*S*D = 550 GFLOP per frame at S=16384
// against ~100 MB of q/k/v/out, so it is compute-bound. The arithmetic is
// plain f32 FMA (no TF32, no split-bf16): that keeps the result within
// summation-order distance of the full-f32 plain version, which is what the
// f32 VAE decode promises, at the price of the 67 TFLOP/s f32 rate instead
// of the tensor cores'.
//
// The accumulator is the hard part. A 64-row q tile's output is 64x512 f32
// = 128 KB, too much for the registers of one block. The split chosen here:
//   * 32 query rows per block, 256 threads; each thread owns 16 rows x 4
//     contiguous output columns = 64 f32 accumulator registers;
//   * K and V tiles of 32 keys; Q, K and V tiles live in shared memory
//     (3 x 32 x 516 f32, rows padded by 4 floats so that the 16 distinct
//     K rows a warp reads with float4 loads hit distinct banks), plus the
//     32x32 score tile: 203 KB, one block per SM;
//   * S = Q K^T: each thread computes a 2x2 patch of the score tile from
//     float4 shared loads along d;
//   * online softmax in f32 (exp2 with log2(e) folded into the scale), one
//     warp per 4 rows, one lane per key, row max / sum / rescale factors
//     kept in shared memory;
//   * O = O * alpha + P V: P is read as float4 (4 keys) broadcast to the
//     warp, V as float4 (4 columns) per lane;
//   * ragged key tails are masked with -inf scores on zero-filled tiles,
//     ragged query tails load zeros and are not stored.
// ptxas (CUDA 12.8, sm_90a): 186 registers, no spills, 203 KB dynamic
// shared memory; chip_smoke.py prints these lines from every build.
// Not yet done (later work): the tensor cores (3xTF32 would keep f32
// accuracy), double-buffered K/V tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 512;         // head dim
constexpr int kBQ = 32;         // query rows per block
constexpr int kBK = 32;         // keys per tile
constexpr int kThreads = 256;
constexpr int kLd = kD + 4;     // padded q/k/v row: 516 floats
constexpr int kSld = kBK + 4;   // padded score row, a multiple of 4 for float4 reads
constexpr int kSmemFloats = (kBQ + 2 * kBK) * kLd + kBQ * kSld + 3 * kBQ;
constexpr size_t kSmemBytes = (size_t)kSmemFloats * sizeof(float);

struct Strides {
  long long b, h, s;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int B, H, Sq, Lk;
  Strides sq, sk, sv, so;
  float scale_log2;  // softmax scale * log2(e)
};

// 16-byte async copy global -> shared; copies zeros when !pred.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage rows [row0, row0 + 32) of one (b, h) sequence; rows at or past len
// are zero-filled. 128 threads cover one 2 KB row (coalesced).
__device__ __forceinline__ void load_rows(float (*dst)[kLd], const float* base, long long stride, int row0,
                                          int len) {
#pragma unroll
  for (int i = 0; i < (32 * kD / 4) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 7, c = (idx & 127) * 4;
    const int row = row0 + r;
    const bool ok = row < len;
    cp_async16(&dst[r][c], ok ? base + (long long)row * stride + c : base, ok);
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4 v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

__global__ void __launch_bounds__(kThreads, 1) flash_f32_d512_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float(*Qs)[kLd] = reinterpret_cast<float(*)[kLd]>(smem);
  float(*Ks)[kLd] = reinterpret_cast<float(*)[kLd]>(smem + kBQ * kLd);
  float(*Vs)[kLd] = reinterpret_cast<float(*)[kLd]>(smem + (kBQ + kBK) * kLd);
  float(*Ss)[kSld] = reinterpret_cast<float(*)[kSld]>(smem + (kBQ + 2 * kBK) * kLd);
  float* row_m = smem + (kBQ + 2 * kBK) * kLd + kBQ * kSld;  // running max (log2 domain)
  float* row_l = row_m + kBQ;                                // running sum
  float* row_a = row_l + kBQ;                                // this tile's rescale factor

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* qb = p.q + b * p.sq.b + h * p.sq.h;
  const float* kb = p.k + b * p.sk.b + h * p.sk.h;
  const float* vb = p.v + b * p.sv.b + h * p.sv.h;

  load_rows(Qs, qb, p.sq.s, q0, p.Sq);
  if (tid < kBQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  // score patch of this thread: rows ty, ty + 16; keys tx, tx + 16
  const int tx = tid & 15, ty = tid >> 4;
  // output of this thread: rows rg, rg + 2, ..., rg + 30; columns 4*d4 .. 4*d4 + 3
  const int d4 = tid & 127, rg = tid >> 7;
  float4 acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int ntiles = (p.Lk + kBK - 1) / kBK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers of Ks, Vs and Ss are done
    load_rows(Ks, kb, p.sk.s, k0, p.Lk);
    load_rows(Vs, vb, p.sv.s, k0, p.Lk);
    cp_async_commit_wait_all();  // this thread's copies (Q's too, on the first tile)
    __syncthreads();             // ... and every thread's

    float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[ty][d]);
      const float4 qc = *reinterpret_cast<const float4*>(&Qs[ty + 16][d]);
      const float4 ka = *reinterpret_cast<const float4*>(&Ks[tx][d]);
      const float4 kc = *reinterpret_cast<const float4*>(&Ks[tx + 16][d]);
      s00 += dot4(qa, ka);
      s01 += dot4(qa, kc);
      s10 += dot4(qc, ka);
      s11 += dot4(qc, kc);
    }
    const int valid = min(kBK, p.Lk - k0);  // >= 1
    Ss[ty][tx] = tx < valid ? s00 * p.scale_log2 : -INFINITY;
    Ss[ty][tx + 16] = tx + 16 < valid ? s01 * p.scale_log2 : -INFINITY;
    Ss[ty + 16][tx] = tx < valid ? s10 * p.scale_log2 : -INFINITY;
    Ss[ty + 16][tx + 16] = tx + 16 < valid ? s11 * p.scale_log2 : -INFINITY;
    __syncthreads();

    // online softmax: warp w takes rows 4w .. 4w+3, lane j takes key j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
      const float m_old = row_m[r];  // read before the shuffles below, which every lane must reach
      const float x = Ss[r][lane];
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_old, mx);  // finite: every tile holds a valid key
      const float e = exp2f(x - m_new);      // masked keys: exp2(-inf) = 0
      float sum = e;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      Ss[r][lane] = e;
      if (lane == 0) {
        const float a = exp2f(m_old - m_new);  // 0 on the first tile
        row_a[r] = a;
        row_l[r] = row_l[r] * a + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float a = row_a[rg + 2 * i];
      acc[i].x *= a;
      acc[i].y *= a;
      acc[i].z *= a;
      acc[i].w *= a;
    }
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      const float4 v0 = *reinterpret_cast<const float4*>(&Vs[j][4 * d4]);
      const float4 v1 = *reinterpret_cast<const float4*>(&Vs[j + 1][4 * d4]);
      const float4 v2 = *reinterpret_cast<const float4*>(&Vs[j + 2][4 * d4]);
      const float4 v3 = *reinterpret_cast<const float4*>(&Vs[j + 3][4 * d4]);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 pr = *reinterpret_cast<const float4*>(&Ss[rg + 2 * i][j]);
        fma4(acc[i], pr.x, v0);
        fma4(acc[i], pr.y, v1);
        fma4(acc[i], pr.z, v2);
        fma4(acc[i], pr.w, v3);
      }
    }
  }

  float* ob = p.out + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = rg + 2 * i, row = q0 + r;
    if (row < p.Sq) {
      const float inv = 1.f / row_l[r];
      *reinterpret_cast<float4*>(ob + (long long)row * p.so.s + 4 * d4) =
          make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv);
    }
  }
}

}  // namespace

// dims: [B, H, Sq, Lk, then (b, h, s) element strides of q, k, v, out]
// (16 values). Every row start must be 16-byte aligned and the head dim
// contiguous. Returns the launch's cudaError_t (0 on success).
extern "C" int aid_flash_attn_f32_d512(const void* q, const void* k, const void* v, void* out,
                                       const long long* dims, float scale, void* stream) {
  if (dims[2] <= 0 || dims[3] <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.B = (int)dims[0];
  p.H = (int)dims[1];
  p.Sq = (int)dims[2];
  p.Lk = (int)dims[3];
  Strides* st[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int i = 0; i < 4; ++i) {
    st[i]->b = dims[4 + 3 * i];
    st[i]->h = dims[5 + 3 * i];
    st[i]->s = dims[6 + 3 * i];
  }
  p.scale_log2 = scale * 1.4426950408889634f;

  cudaError_t err =
      cudaFuncSetAttribute(reinterpret_cast<const void*>(&flash_f32_d512_kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_f32_d512_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
