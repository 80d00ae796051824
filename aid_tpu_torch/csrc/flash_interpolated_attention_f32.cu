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
// 0, and fused-mode skip rows dropping their endpoint segments.
//
// What bounds it on the card: 4*S*L*D flops against (S+L)*D*8 bytes is far
// over the ridge at the self-attention shapes (S = 1024..4096), so the
// products bind. f32 outside the tensor cores runs at 67 TFLOP/s; plain TF32
// on them keeps only ~4e-4 of max |out| (tests/test_torch_ops.py), which
// breaks the f32 promise of 1e-4. So both products run in 3xTF32, as in
// flash_attention_f32_d512.cu: a = hi + lo with hi = tf32(a) (cvt.rna) and
// lo = a - hi, and hi*hi + hi*lo + lo*hi accumulate in f32: three passes at
// the 495 TFLOP/s TF32 rate are the bound. tf32 wgmma takes only K-major
// operands from shared memory (hi and lo copies of Q, K and a transposed V),
// so this kernel uses mma.sync.m16n8k8.tf32 and splits in registers from one
// f32 copy of each tile. The design, simple first (FlashAttention-2's):
//   * a block owns 64 query rows of one (b, h): 4 warps of 16 rows each, the
//     whole head dim, so the online softmax and P never leave a warp: the
//     S accumulator of m16n8k8 is P's A fragment once the k order inside an
//     8-wide step is permuted (fragment k = t and t + 4 taken from columns
//     2t and 2t + 1, the same order for both operands), and each thread's
//     pair of Q or K values is one 8-byte shared load;
//   * K/V tiles of kBK keys (64 at D <= 80, 32 at D = 160) run through two
//     cp.async stages across the segment loop (own, begin, end), so the next
//     tile, of this segment or the next, loads while this one computes;
//     rows past a segment's length come in as zeros and score -inf;
//   * Q K^T keeps its big (hi*hi) and small (hi*lo + lo*hi) terms in
//     separate accumulators; the tile's P V is summed from zero on the
//     tensor cores, kNC n8 tiles of O at a time, and folded into O by an f32
//     FMA: summed in place, the tensor cores' truncating accumulation
//     drifted 1.3e-4 of max |out| over 16384 keys (the D=512 kernel);
//   * the outer modes keep one accumulator set: the own segment's state is
//     parked in this thread's private words of shared memory, the begin
//     segment continues it to (1-c) O / l, which is exchanged with the parked
//     state, and the end segment continues that (flash_interpolated_attention.cu's
//     scheme), so D = 160 holds 80 accumulators a thread, not 160;
//   * row pitches in shared memory (Tiles below) make every fragment load
//     free of bank conflicts: Q and K rows at 8 or 24 floats mod 32 (8-byte
//     loads of rows g, columns 2t), V rows at 4 or 12 mod 16 (4-byte loads of
//     rows 2t, columns g);
//   * the output is written at its own strides: the wrapper passes a
//     (B, Sq, H, D) buffer viewed as (B, H, Sq, D), so heads merge with no copy.
// Online softmax in f32 (exp2f, log2(e) folded into the scale).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The tile table (tests/test_torch_ops.py reads it): keys per K/V tile, the
// row pitch of Q and K, the row pitch of V (floats).
template <int D> struct Tiles;
template <> struct Tiles<40> { static constexpr int kBK = 64, kLdQK = 40, kLdV = 44; };
template <> struct Tiles<64> { static constexpr int kBK = 64, kLdQK = 72, kLdV = 68; };
template <> struct Tiles<80> { static constexpr int kBK = 64, kLdQK = 88, kLdV = 84; };
template <> struct Tiles<160> { static constexpr int kBK = 32, kLdQK = 168, kLdV = 164; };

constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 128;  // 4 warps of 16 query rows

template <int D>
struct Cfg {
  static constexpr int kBK = Tiles<D>::kBK, kLdQK = Tiles<D>::kLdQK, kLdV = Tiles<D>::kLdV;
  static constexpr int kNT = D / 8;                     // n8 tiles of O, k8 steps of Q K^T
  static constexpr int kNC = kNT % 5 == 0 ? 5 : 4;      // O's n8 tiles per P V pass
  static constexpr int kSlot = D / 2 + 4;               // parked words a thread: O, m[2], l[2]
  static constexpr int kKOff = kBQ * kLdQK;
  static constexpr int kVOff = kKOff + 2 * kBK * kLdQK;
  static constexpr int kParkOff = kVOff + 2 * kBK * kLdV;
  static constexpr int smem_bytes(bool outer) { return 4 * (kParkOff + (outer ? kThreads * kSlot : 0)); }
  static_assert(D % 8 == 0 && kBK % 8 == 0 && kNT % kNC == 0, "m16n8k8 steps");
  static_assert(kLdQK % 32 == 8 || kLdQK % 32 == 24, "Q/K fragment loads conflict free");
  static_assert(kLdV % 16 == 4 || kLdV % 16 == 12, "V fragment loads conflict free");
  static_assert(smem_bytes(true) <= 232448, "over the 227 KB a block can use");
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

#include "tf32_mma.cuh"

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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
// keys of the tile are real.
template <int D>
__device__ __forceinline__ void tile_update(State<D>& st, const float* qa, const float* kt, const float* vt,
                                            int valid, float sl2, int g, int t) {
  using C = Cfg<D>;
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

// HAS_OWN: the row's own K/V segment leads the stream (self and fused modes).
// NSETS: 0 = no endpoint segment (self), 1 = one cross segment (inner),
// 2 = begin and end segments blended by coef (outer).
template <int D, bool HAS_OWN, int NSETS>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int BK = C::kBK;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = smem + C::kKOff;
  float* Vs = smem + C::kVOff;
  float* park = smem + C::kParkOff + threadIdx.x;  // one column of (kSlot, 128) per thread: conflict free

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // skip rows drop the endpoint segments; pure modes never skip (the
  // wrapper passes no skip rows), their stream has no own segment
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
    tile_update<D>(st, qa, Ks + (it & 1) * BK * C::kLdQK, Vs + (it & 1) * BK * C::kLdV, min(BK, s.len - r0),
                   p.scale_log2, g, t);
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
  constexpr int smem = Cfg<D>::smem_bytes(NSETS == 2);
  static bool attribute_set = false;  // once per instance and process
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&flash_f32_kernel<D, HAS_OWN, NSETS>),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, H, B);
  flash_f32_kernel<D, HAS_OWN, NSETS><<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const Params& p, int B, int H, int has_own, int n_sets, cudaStream_t s) {
  if (has_own && n_sets == 0) return launch<D, true, 0>(p, B, H, s);
  if (has_own && n_sets == 1) return launch<D, true, 1>(p, B, H, s);
  if (has_own && n_sets == 2) return launch<D, true, 2>(p, B, H, s);
  if (!has_own && n_sets == 1) return launch<D, false, 1>(p, B, H, s);
  if (!has_own && n_sets == 2) return launch<D, false, 2>(p, B, H, s);
  return (int)cudaErrorInvalidValue;
}

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
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.kb = static_cast<const float*>(kb);
  p.vb = static_cast<const float*>(vb);
  p.ke = static_cast<const float*>(ke);
  p.ve = static_cast<const float*>(ve);
  p.out = static_cast<float*>(out);
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
  if (p.Sq <= 0 || p.Lk <= 0) return (int)cudaErrorInvalidValue;
  const int B = (int)dims[0], H = (int)dims[1];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims[5]) {
    case 40: return launch_d<40>(p, B, H, has_own, n_sets, s);
    case 64: return launch_d<64>(p, B, H, has_own, n_sets, s);
    case 80: return launch_d<80>(p, B, H, has_own, n_sets, s);
    case 160: return launch_d<160>(p, B, H, has_own, n_sets, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
