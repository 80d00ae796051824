// Flash self-attention, bf16 in and out, head dim 512, sm_90a.
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
// 512px frame or tile.
//
// What bounds it on the card: 4*S*S*D = 550 GFLOP per frame at S=16384
// against ~67 MB of q/k/v/out, so it is compute-bound: 0.556 ms at the
// 989 TFLOP/s bf16 tensor-core rate.
//
// Shared memory and registers bind the design, not the arithmetic. It is
// csrc/flash_attention_f32_d512.cu's structure in bf16, on
// mma.sync.m16n8k16 with ldmatrix, one pass per product:
//   * 64 query rows per block, 256 threads (8 warps), one block per SM. The
//     64 x 512 f32 output accumulator is 128 registers a thread: warp w
//     owns output columns 64w .. 64w + 63 of all 64 rows (4 x 8 m16n8
//     tiles);
//   * 32-key K and V tiles, each with its own buffer, each refilled as soon
//     as its use ends: K(j+1) loads during the softmax and P V of tile j,
//     V(j+1) during Q K^T of tile j+1 (cp.async). Q 65 KB + K 32.5 KB +
//     V 32.5 KB + partial scores 40 KB + P 5 KB = 176 KB;
//   * Q K^T: warp w computes a 32-row x 32-key patch over one quarter of d
//     (rows 32 (w % 2), d quarter w / 2), 32 f32 accumulators; the four
//     quarters' partial scores meet in shared memory and the softmax sums
//     them. Splitting d keeps each warp's shared-memory reads at 16 KB a
//     tile (a full-d 16 x 32 patch would read 48 KB);
//   * online softmax in f32, four threads per row (keys interleaved so a
//     warp's reads hit at most two ways of a bank), exp2 with log2(e)
//     folded into the scale; the row sum adds the unrounded f32
//     probabilities, P goes to shared memory rounded to bf16;
//   * O = O * alpha + P V summed in place on the tensor cores (P and V are
//     bf16, so the f32 accumulation's rounding is far below the bf16
//     output's);
//   * rows are padded (q, k, v: 520 bf16 = 1040 bytes, P: 40 bf16, scores:
//     40 floats) so every ldmatrix and every score store of a warp is free
//     of bank conflicts;
//   * ragged key tails are masked with -inf scores on zero-filled tiles,
//     ragged query tails load zeros and are not stored.
// What holds it back (H100, chip_smoke.py phase 3): 2.96-3.03 ms at
// (1,1,16384,512), 18-19% of the bound and 0.67x SDPA's efficient backend;
// 1.52 ms at (7,1,4096,512). ptxas: 226 registers, no spills. Operands
// reach mma.sync through ldmatrix: Q K^T reads 16 KB of shared memory per
// warp and tile for 0.26 MFLOP (16 flops a byte, P V 32), under the ~33
// flops a byte at which an SM's shared memory keeps its tensor cores busy. A wgmma design would have to split D across
// warpgroups (one warpgroup cannot hold a 64 x 512 f32 accumulator) and
// stage P per warpgroup; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 512;                     // head dim
constexpr int kBQ = 64;                     // query rows per block
constexpr int kBK = 32;                     // keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = kD / kWarps;          // P V output columns per warp: 64
constexpr int kNJ = kCols / 8;              // ... in n8 tiles
constexpr int kDParts = 4;                  // Q K^T splits d into quarters
constexpr int kDPart = kD / kDParts;        // 128
constexpr int kRowGroups = kWarps / kDParts;  // 2
constexpr int kQKM = kBQ / kRowGroups / 16;   // m16 tiles per warp in Q K^T: 2
constexpr int kQKN = kBK / 8;                 // n8 tiles per warp in Q K^T: 4
constexpr int kTPR = kThreads / kBQ;        // softmax threads per row: 4
constexpr int kKPT = kBK / kTPR;            // keys per softmax thread: 8
constexpr int kLd = kD + 8;                 // q / k / v rows: 520 bf16
constexpr int kSld = kBK + 8;               // score rows: 40 floats
constexpr int kPld = kBK + 8;               // P rows: 40 bf16
constexpr int kQOff = 0;                                   // byte offsets
constexpr int kKOff = kQOff + kBQ * kLd * 2;
constexpr int kVOff = kKOff + kBK * kLd * 2;
constexpr int kSOff = kVOff + kBK * kLd * 2;               // partial scores, one tile per d quarter
constexpr int kPOff = kSOff + kDParts * kBQ * kSld * 4;
constexpr int kStatOff = kPOff + kBQ * kPld * 2;
constexpr int kSmemBytes = kStatOff + 3 * kBQ * 4;

struct Strides {
  long long b, h, s;
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  int B, H, Sq, Lk;
  Strides sq, sk, sv, so;
  float scale_log2;  // softmax scale * log2(e)
};

// 16-byte async copy global -> shared; copies zeros when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [row0, row0 + ROWS) of one (b, h) sequence into rows of kLd
// bf16; rows at or past len are zero-filled. 64 threads cover one 1 KB row.
template <int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* base, long long stride,
                                          int row0, int len) {
#pragma unroll
  for (int i = 0; i < (ROWS * kD / 8) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 6, c = (idx & 63) * 8;
    const int row = row0 + r;
    const bool ok = row < len;
    cp_async16(dst + r * kLd + c, ok ? base + (long long)row * stride + c : base, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c(16x8, f32) += a(16x16, bf16, row) * b(16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 1) flash_bf16_d512_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + kQOff);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + kKOff);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + kVOff);
  float* Ss = reinterpret_cast<float*>(smem + kSOff);  // [d quarter][row][key]
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + kPOff);
  float* row_m = reinterpret_cast<float*>(smem + kStatOff);  // running max (log2 domain)
  float* row_l = row_m + kBQ;                                // running sum
  float* row_a = row_l + kBQ;                                // this tile's rescale factor

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = p.q + b * p.sq.b + h * p.sq.h;
  const __nv_bfloat16* kb = p.k + b * p.sk.b + h * p.sk.h;
  const __nv_bfloat16* vb = p.v + b * p.sv.b + h * p.sv.h;

  load_rows<kBQ>(Qs, qb, p.sq.s, q0, p.Sq);
  cp_async_commit();
  load_rows<kBK>(Ks, kb, p.sk.s, 0, p.Lk);
  cp_async_commit();
  load_rows<kBK>(Vs, vb, p.sv.s, 0, p.Lk);
  cp_async_commit();
  if (tid < kBQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float o[4][kNJ][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int nj = 0; nj < kNJ; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][nj][e] = 0.f;
    }
  }

  // this warp's Q K^T patch: 32 rows x 32 keys over one quarter of d
  const int s_rows = (warp % kRowGroups) * 16 * kQKM, s_part = warp / kRowGroups;
  // ldmatrix row addresses: A (16 x 16 from row-major rows), B (K rows as
  // the columns of K^T), B transposed (V rows, key-major)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int kt_row = (lane & 7) + ((lane >> 4) << 3), kt_col = ((lane >> 3) & 1) * 8;
  const int vt_row = (lane & 7) + (((lane >> 3) & 1) << 3), vt_col = (lane >> 4) * 8;
  const int ntiles = (p.Lk + kBK - 1) / kBK;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * kBK;
    cp_async_wait<1>();  // Q (first tile) and K(tile) have landed for this thread ...
    __syncthreads();     // ... and for every thread

    {  // partial scores over one d quarter
      float acc[kQKM][kQKN][4] = {};
      const __nv_bfloat16* qa = Qs + (s_rows + a_row) * kLd + s_part * kDPart + a_col;
      const __nv_bfloat16* ka = Ks + kt_row * kLd + s_part * kDPart + kt_col;
#pragma unroll 2
      for (int d = 0; d < kDPart; d += 16) {
        uint32_t a[kQKM][4];
#pragma unroll
        for (int mi = 0; mi < kQKM; ++mi) ldmatrix_x4(a[mi], qa + mi * 16 * kLd + d);
#pragma unroll
        for (int np = 0; np < kQKN / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ka + np * 16 * kLd + d);
#pragma unroll
          for (int mi = 0; mi < kQKM; ++mi) {
            mma_bf16(acc[mi][2 * np], a[mi], bk[0], bk[1]);
            mma_bf16(acc[mi][2 * np + 1], a[mi], bk[2], bk[3]);
          }
        }
      }
      float* sp = Ss + s_part * kBQ * kSld + (s_rows + g) * kSld + 2 * t;
#pragma unroll
      for (int mi = 0; mi < kQKM; ++mi) {
#pragma unroll
        for (int nj = 0; nj < kQKN; ++nj) {
          *reinterpret_cast<float2*>(sp + mi * 16 * kSld + nj * 8) = make_float2(acc[mi][nj][0], acc[mi][nj][1]);
          *reinterpret_cast<float2*>(sp + (mi * 16 + 8) * kSld + nj * 8) =
              make_float2(acc[mi][nj][2], acc[mi][nj][3]);
        }
      }
    }
    __syncthreads();  // the scores are complete and K is free
    if (tile + 1 < ntiles) load_rows<kBK>(Ks, kb, p.sk.s, k0 + kBK, p.Lk);
    cp_async_commit();  // possibly empty: keeps the group count in step

    {  // online softmax: kTPR threads per row, keys sub, sub + kTPR, ...
      const int r = tid / kTPR, sub = tid % kTPR;
      const int valid = min(kBK, p.Lk - k0);  // >= 1
      const float m_old = row_m[r];  // read before the shuffles below, which every lane reaches
      float x[kKPT];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kKPT; ++i) {
        const int key = sub + i * kTPR;
        float s = 0.f;
#pragma unroll
        for (int part = 0; part < kDParts; ++part) s += Ss[part * kBQ * kSld + r * kSld + key];
        x[i] = key < valid ? s * p.scale_log2 : -INFINITY;
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int o_ = 1; o_ < kTPR; o_ <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_new = fmaxf(m_old, mx);  // finite: every tile holds a valid key
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kKPT; ++i) {
        const float e = exp2f(x[i] - m_new);  // masked keys: exp2(-inf) = 0
        Ps[r * kPld + sub + i * kTPR] = __float2bfloat16_rn(e);
        sum += e;
      }
#pragma unroll
      for (int o_ = 1; o_ < kTPR; o_ <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o_);
      if (sub == 0) {
        const float a = exp2f(m_old - m_new);  // 0 on the first tile
        row_a[r] = a;
        row_l[r] = row_l[r] * a + sum;
        row_m[r] = m_new;
      }
    }
    cp_async_wait<1>();  // V(tile) has landed (K(tile + 1) may still be in flight)
    __syncthreads();     // ... everywhere; P and the rescale factors are visible

    // O = O * alpha + P V over this warp's 64 output columns
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const float a0 = row_a[mi * 16 + g], a1 = row_a[mi * 16 + g + 8];
#pragma unroll
      for (int nj = 0; nj < kNJ; ++nj) {
        o[mi][nj][0] *= a0;
        o[mi][nj][1] *= a0;
        o[mi][nj][2] *= a1;
        o[mi][nj][3] *= a1;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldmatrix_x4(a[mi], Ps + (mi * 16 + a_row) * kPld + ks * 16 + a_col);
#pragma unroll
      for (int np = 0; np < kNJ / 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vs + (ks * 16 + vt_row) * kLd + warp * kCols + np * 16 + vt_col);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(o[mi][2 * np], a[mi], bv[0], bv[1]);
          mma_bf16(o[mi][2 * np + 1], a[mi], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // V and P are consumed
    if (tile + 1 < ntiles) load_rows<kBK>(Vs, vb, p.sv.s, k0 + kBK, p.Lk);
    cp_async_commit();
  }

  __nv_bfloat16* ob = p.out + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mi * 16 + g + hf * 8, row = q0 + r;
      if (row >= p.Sq) continue;
      const float inv = 1.f / row_l[r];
      __nv_bfloat16* orow = ob + (long long)row * p.so.s + warp * kCols + 2 * t;
#pragma unroll
      for (int nj = 0; nj < kNJ; ++nj) {
        *reinterpret_cast<__nv_bfloat162*>(orow + nj * 8) =
            __floats2bfloat162_rn(o[mi][nj][2 * hf] * inv, o[mi][nj][2 * hf + 1] * inv);
      }
    }
  }
}

}  // namespace

// dims: [B, H, Sq, Lk, then (b, h, s) element strides of q, k, v, out]
// (16 values). Every row start must be 16-byte aligned and the head dim
// contiguous. Returns the launch's cudaError_t (0 on success).
extern "C" int aid_flash_attn_bf16_d512(const void* q, const void* k, const void* v, void* out,
                                        const long long* dims, float scale, void* stream) {
  if (dims[2] <= 0 || dims[3] <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
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

  static bool attribute_set = false;  // once per process: the kernel's shared memory does not change
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&flash_bf16_d512_kernel),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_bf16_d512_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
