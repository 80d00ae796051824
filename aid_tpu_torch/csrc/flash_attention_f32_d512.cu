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
// against ~134 MB of q/k/v/out, so it is compute-bound. Plain f32 FMA runs
// at the 67 TFLOP/s CUDA-core rate (8.2 ms at best; the earlier SIMT
// design of this file took 29.2 ms). Plain TF32 on the tensor cores keeps
// ~4e-4 of max |out| (tests/test_torch_ops.py), which would break the f32
// decode's 1e-4 promise. So both products run in 3xTF32: each operand is
// split as a = hi + lo with hi = tf32(a) (cvt.rna) and lo = a - hi (exact
// in f32; the tensor cores read its tf32 part, dropping the low 13 bits,
// which a second cvt would only round: measured the same error, 11%
// faster without it), and hi*hi + hi*lo + lo*hi accumulate in f32 (lo*lo,
// ~2^-22 relative, is dropped). That keeps the result ~1e-6 from full f32
// at three tensor-core passes: 3.33 ms at the 495 TFLOP/s TF32 rate is this
// kernel's bound.
//
// The instruction is mma.sync.m16n8k8.tf32, not wgmma: tf32 wgmma takes
// only K-major operands from shared memory, so hi and lo of Q and K and a
// transposed hi and lo of V would all have to sit there, and a 64 x 512 f32
// tile alone is 128 KB; mma.sync takes fragments split in registers from
// one f32 copy of each tile.
//
// Shared memory binds the design:
//   * 64 query rows per block (each K/V element is then read from L2 once
//     per 64 queries: 16 GB of L2 reads at S=16384, half of what 32-row
//     blocks would need), 256 threads, one block per SM;
//   * 16-key K and V tiles, each with its own buffer, each refilled as soon
//     as its use ends: K(j+1) loads during the softmax and P V of tile j,
//     V(j+1) during Q K^T of tile j+1 (cp.async). Q 130 KB + K 32.5 KB + V
//     32 KB + scores 24 KB = 219.5 KB;
//   * Q K^T: warp w computes a 32-row x 16-key patch over one quarter of d
//     (rows 32 (w % 2), d quarter w / 2); the four quarters' partial scores
//     are summed by the softmax. Big (hi*hi) and small (hi*lo + lo*hi)
//     terms go to separate accumulators, the small ones of even and odd k
//     steps apart too: twelve independent mma chains a warp;
//   * the k order inside an 8-wide step is permuted (fragment k = t and
//     t + 4 from columns 2t and 2t + 1), so each thread's pair of Q, K or P
//     values is one 8-byte shared load;
//   * online softmax in f32 (exp2 with log2(e) folded into the scale), four
//     threads per row; row max / sum / rescale factors in shared memory;
//   * O = O * alpha + P V: warp w owns output columns 64w .. 64w + 63 of all
//     64 rows, 4 x 8 m16n8 tiles = 128 f32 accumulator registers a thread;
//     P comes through shared memory to every warp. Each tile's P V is summed
//     from zero on the tensor cores and folded into O by an f32 FMA: summed
//     in place, the tensor cores' truncating accumulation drifted by 1.3e-4
//     of max |out| over 16384 keys;
//   * rows are padded (q, k: 520 floats, v: 516, scores: 24) so that every
//     fragment load of a warp is free of bank conflicts;
//   * ragged key tails are masked with -inf scores on zero-filled tiles,
//     ragged query tails load zeros and are not stored.
// What holds it back (H100, chip_smoke.py phase 3 and variants of this
// file): 12.4 ms at (1,1,16384,512), 27% of the bound. Dropping the small
// passes of Q K^T and of P V (1xTF32) took it to 7.3 ms, so each pass of
// mma.sync TF32 costs ~3 ms here (~180 TFLOP/s), and splits, softmax and
// the four barriers a 16-key tile ~3-4 ms more. 16 warps at 128 registers
// were 15% slower.
// At SD 1.5's batched decode, (7,1,4096,512), it is 6.06 ms: slower than
// its plain version (5.65) and than SDPA's efficient backend (5.88).
// ptxas (CUDA 12.8, sm_90a): 255 registers, 60 bytes of spill stores, 220 KB
// dynamic shared memory; chip_smoke.py's build phase prints these lines
// from every build. tools/f32_attention_spill_probe.py reads the SASS: 5
// local stores and 5 loads sit in the key-tile loop, the other 15 run once
// a block. Its variant with one accumulator chain fewer for Q K^T's small
// terms spills more (144 bytes; 12 + 12 in the loop) and is 2.2% slower
// (11.87 -> 12.13 ms at (1,1,16384,512)): at that rate the shipped
// kernel's spills cost under 2%.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 512;          // head dim
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 16;          // keys per tile
constexpr int kWarps = 8;        // 16 warps (128 registers a thread) measured 15% slower
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = kD / kWarps;       // P V output columns per warp: 64
constexpr int kNJ = kCols / 8;           // ... in n8 tiles
constexpr int kQKM = 2;                  // m16 tiles per warp in Q K^T
constexpr int kRowGroups = 4 / kQKM;     // warps per d part in Q K^T
constexpr int kTPR = kThreads / kBQ;     // softmax threads per row: 4
constexpr int kKPT = kBK / kTPR;         // keys per softmax thread: 4
constexpr int kLdQK = kD + 8;    // q / k rows: 520 floats
constexpr int kLdV = kD + 4;     // v rows: 516 floats
constexpr int kSld = kBK + 8;    // score rows: 24 floats
constexpr int kDParts = 4;       // Q K^T splits d into quarters
constexpr int kQOff = 0;
constexpr int kKOff = kQOff + kBQ * kLdQK;
constexpr int kVOff = kKOff + kBK * kLdQK;
constexpr int kSOff = kVOff + kBK * kLdV;     // partial score tiles, one per d quarter
constexpr int kStatOff = kSOff + kDParts * kBQ * kSld;
constexpr int kSmemFloats = kStatOff + 3 * kBQ;
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

#include "tf32_mma.cuh"

// Stage rows [row0, row0 + ROWS) of one (b, h) sequence into rows of LD
// floats; rows at or past len are zero-filled. 128 threads cover one 2 KB
// row (coalesced).
template <int ROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* base, long long stride, int row0, int len) {
#pragma unroll
  for (int i = 0; i < (ROWS * kD / 4) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 7, c = (idx & 127) * 4;
    const int row = row0 + r;
    const bool ok = row < len;
    cp_async16(dst + r * LD + c, ok ? base + (long long)row * stride + c : base, ok);
  }
}

__global__ void __launch_bounds__(kThreads, 1) flash_f32_d512_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + kQOff;
  float* Ks = smem + kKOff;
  float* Vs = smem + kVOff;
  float* Ss = smem + kSOff;  // [d half][row][key]; half 0 then holds P
  float* row_m = smem + kStatOff;  // running max (log2 domain)
  float* row_l = row_m + kBQ;      // running sum
  float* row_a = row_l + kBQ;      // this tile's rescale factor

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float* qb = p.q + b * p.sq.b + h * p.sq.h;
  const float* kb = p.k + b * p.sk.b + h * p.sk.h;
  const float* vb = p.v + b * p.sv.b + h * p.sv.h;

  load_rows<kBQ, kLdQK>(Qs, qb, p.sq.s, q0, p.Sq);
  cp_async_commit();
  load_rows<kBK, kLdQK>(Ks, kb, p.sk.s, 0, p.Lk);
  cp_async_commit();
  load_rows<kBK, kLdV>(Vs, vb, p.sv.s, 0, p.Lk);
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

  // this warp's Q K^T patch: 16 kQKM rows x 16 keys over one quarter of d
  const int s_rows = (warp % kRowGroups) * 16 * kQKM, s_part = warp / kRowGroups;
  const int ntiles = (p.Lk + kBK - 1) / kBK;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * kBK;
    cp_async_wait<1>();  // Q (first tile) and K(tile) have landed for this thread ...
    __syncthreads();     // ... and for every thread

    {  // partial scores over one d quarter, 3xTF32; big (hi*hi) and small
       // (hi*lo + lo*hi) terms in separate accumulators, the small ones of
       // even and odd k steps apart too: 12 independent mma chains a warp
      float big[kQKM][2][4] = {}, small[2][kQKM][2][4] = {};  // [m16][n8], small: [k parity][m16][n8]
      const float* qa = Qs + s_rows * kLdQK + s_part * (kD / kDParts);
      const float* ka = Ks + g * kLdQK + s_part * (kD / kDParts) + 2 * t;
#pragma unroll 1
      for (int d = 0; d < kD / kDParts; d += 16) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t ahi[kQKM][4], alo[kQKM][4], bhi[2][2], blo[2][2];
#pragma unroll
          for (int mi = 0; mi < kQKM; ++mi) load_a_split(qa + mi * 16 * kLdQK + d + 8 * e, kLdQK, g, t, ahi[mi], alo[mi]);
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            const float2 kv = *reinterpret_cast<const float2*>(ka + nj * 8 * kLdQK + d + 8 * e);
            split_tf32(kv.x, bhi[nj][0], blo[nj][0]);
            split_tf32(kv.y, bhi[nj][1], blo[nj][1]);
          }
#pragma unroll
          for (int mi = 0; mi < kQKM; ++mi) {
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
              mma_tf32(small[e][mi][nj], alo[mi], bhi[nj][0], bhi[nj][1]);
              mma_tf32(small[e][mi][nj], ahi[mi], blo[nj][0], blo[nj][1]);
              mma_tf32(big[mi][nj], ahi[mi], bhi[nj][0], bhi[nj][1]);
            }
          }
        }
      }
      float* sp = Ss + s_part * kBQ * kSld + (s_rows + g) * kSld + 2 * t;
#pragma unroll
      for (int mi = 0; mi < kQKM; ++mi) {
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = big[mi][nj][i] + (small[0][mi][nj][i] + small[1][mi][nj][i]);
          }
          *reinterpret_cast<float2*>(sp + mi * 16 * kSld + nj * 8) = make_float2(v[0], v[1]);
          *reinterpret_cast<float2*>(sp + (mi * 16 + 8) * kSld + nj * 8) = make_float2(v[2], v[3]);
        }
      }
    }
    __syncthreads();  // the scores are complete and K is free
    if (tile + 1 < ntiles) load_rows<kBK, kLdQK>(Ks, kb, p.sk.s, k0 + kBK, p.Lk);
    cp_async_commit();  // possibly empty: keeps the group count in step

    {  // online softmax: kTPR threads per row, kKPT keys each
      const int r = tid / kTPR, kq = (tid % kTPR) * kKPT;
      const int valid = min(kBK, p.Lk - k0);  // >= 1
      const float m_old = row_m[r];  // read before the shuffles below, which every lane reaches
      float x[kKPT];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kKPT; ++i) {
        float s = 0.f;
#pragma unroll
        for (int part = 0; part < kDParts; ++part) s += Ss[part * kBQ * kSld + r * kSld + kq + i];
        x[i] = kq + i < valid ? s * p.scale_log2 : -INFINITY;
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int o = 1; o < kTPR; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_old, mx);  // finite: every tile holds a valid key
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kKPT; ++i) {
        const float e = exp2f(x[i] - m_new);  // masked keys: exp2(-inf) = 0
        Ss[r * kSld + kq + i] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 1; o < kTPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (tid % kTPR == 0) {
        const float a = exp2f(m_old - m_new);  // 0 on the first tile
        row_a[r] = a;
        row_l[r] = row_l[r] * a + sum;
        row_m[r] = m_new;
      }
    }
    cp_async_wait<1>();  // V(tile) has landed (K(tile + 1) may still be in flight)
    __syncthreads();     // ... everywhere; P and the rescale factors are visible

    // O = O * alpha + P V. The tensor cores' f32 accumulation is not
    // rounded to nearest, and its bias would grow with 16384 keys summed in
    // place (1.3e-4 of max |out| measured at S = 16384); so each tile's
    // product is summed from zero and folded into O with one f32 FMA per
    // element, which rounds to nearest.
#pragma unroll
    for (int nh = 0; nh < kNJ / 4; ++nh) {  // the warp's output columns 32 nh .. 32 nh + 31
      uint32_t bhi[kBK / 8][4][2], blo[kBK / 8][4][2];
#pragma unroll
      for (int ks = 0; ks < kBK / 8; ++ks) {
        const float* vp = Vs + (ks * 8 + 2 * t) * kLdV + warp * kCols + nh * 32 + g;  // keys 2t, 2t + 1
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          split_tf32(vp[nj * 8], bhi[ks][nj][0], blo[ks][nj][0]);
          split_tf32(vp[kLdV + nj * 8], bhi[ks][nj][1], blo[ks][nj][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        float part[4][4] = {};
#pragma unroll
        for (int ks = 0; ks < kBK / 8; ++ks) {
          uint32_t ahi[4], alo[4];
          load_a_split(Ss + mi * 16 * kSld + ks * 8, kSld, g, t, ahi, alo);
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) {
            mma_tf32(part[nj], alo, bhi[ks][nj][0], bhi[ks][nj][1]);
            mma_tf32(part[nj], ahi, blo[ks][nj][0], blo[ks][nj][1]);
            mma_tf32(part[nj], ahi, bhi[ks][nj][0], bhi[ks][nj][1]);
          }
        }
        const float a0 = row_a[mi * 16 + g], a1 = row_a[mi * 16 + g + 8];
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          float* oo = o[mi][nh * 4 + nj];
          oo[0] = fmaf(oo[0], a0, part[nj][0]);
          oo[1] = fmaf(oo[1], a0, part[nj][1]);
          oo[2] = fmaf(oo[2], a1, part[nj][2]);
          oo[3] = fmaf(oo[3], a1, part[nj][3]);
        }
      }
    }
    __syncthreads();  // V and P are consumed
    if (tile + 1 < ntiles) load_rows<kBK, kLdV>(Vs, vb, p.sv.s, k0 + kBK, p.Lk);
    cp_async_commit();
  }

  float* ob = p.out + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mi * 16 + g + hf * 8, row = q0 + r;
      if (row >= p.Sq) continue;
      const float inv = 1.f / row_l[r];
      float* orow = ob + (long long)row * p.so.s + warp * kCols + 2 * t;
#pragma unroll
      for (int nj = 0; nj < kNJ; ++nj) {
        *reinterpret_cast<float2*>(orow + nj * 8) =
            make_float2(o[mi][nj][2 * hf] * inv, o[mi][nj][2 * hf + 1] * inv);
      }
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
